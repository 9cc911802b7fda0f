// Dense flash prefill in fp32 for Hopper (sm_90a), on the CUDA cores:
// causal or non-causal GQA attention over a whole prompt, q [B, S, H, hd]
// against k, v [B, S, Hkv, hd], with Hkv dividing H. bf16 inputs go to the
// tensor-core kernel of flash_prefill_sm90.cu instead; this one serves
// fp32, whose tolerance (1e-5) bf16 tensor-core products cannot meet.
//
// Replaces the TPU kernel repro/kernels/flash_prefill/flash_prefill.py
// (flash_prefill :144, body _flash_kernel :88) and computes what it does:
//   * an online softmax with fp32 (m, l, acc) across key tiles; q is
//     scaled by 1/sqrt(hd) in fp32 before the dot products;
//   * a causal mask on positions (key <= query), or none;
//   * keys at or past true_len are never attended, rows at or past
//     true_len are written as exact zeros;
//   * the epilogue divides by max(l, 1e-30).
// With a non-null lse pointer it also writes each row's log-sum-exp for the
// backward (flash_prefill_bwd.cu): fp32 [B, H, S], m + log(max(l, 1e-30))
// in the natural log (the base of this kernel's expf) of the scaled
// scores, 0 for rows at or past true_len. A null pointer (every serve-path
// call) leaves the output's bits as they were.
// The Pallas kernel walks the kv axis as a sequential grid axis and skips
// blocks above the diagonal with pl.when. Here one CTA owns a tile of
// query positions of one (batch, KV head) and loops over key tiles up to
// the tile's causal horizon, so a key tile above the diagonal is never
// loaded; the grid is (q tiles, KV heads, batch), heaviest (last) q tiles
// first so the long loops start early.
//
// GQA-native: a CTA's 64 rows are floor(64 / group) query positions times
// the group's query heads (row r: position q0 + r / group, head
// h * group + r % group), so each K/V tile is staged in shared memory once
// for the whole group and K/V are never repeated per query head.
//
// What bounds it on this card: the fp32 FMA rate (67 TFLOP/s) at long S;
// 4 hd operations per (row, visible key). Design: CUDA-core fp32 FMAs from
// shared memory, in register tiles: for Q K^T each of the 256 threads
// holds 4 rows x 4 keys of the 64 x 64 score tile, for P V 4 rows x hd/16
// output columns, every operand read as a float4 (K rows padded by 4
// words so the 16 key rows a warp reads fall in distinct bank groups).
// Head_dim 32, 64, 128 and 256, each its own instantiation; at 256 the
// tile takes 214,272 bytes of shared memory (one CTA per SM) and a thread
// holds 4 rows x 16 columns of O.
#include <cuda_runtime.h>

#include "launch_check.cuh"

namespace {

constexpr int kThreads = 256;       // 16 x 16: ty picks rows, tx keys/columns
constexpr int kRows = 64;           // query rows (positions x heads) per CTA
constexpr int kKeys = 64;           // keys per shared-memory tile
constexpr int kPStride = kKeys + 1;
constexpr float kNegInf = -1e30f;   // the TPU kernel's NEG_INF
constexpr int kMaxSmem = 232448;    // what a block may take on the H100

__device__ __forceinline__ void load16(const float* p, float* out) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  out[0] = v.x;
  out[1] = v.y;
  out[2] = v.z;
  out[3] = v.w;
}

// Shared memory, fp32 throughout: Q [kRows][HD], K [kKeys][HD + 4],
// V [kKeys][HD], P [kRows][kKeys + 1].
template <int HD>
struct Layout {
  static constexpr int kKStride = HD + 4;
  static constexpr int k_off = kRows * HD;
  static constexpr int v_off = k_off + kKeys * kKStride;
  static constexpr int p_off = v_off + kKeys * HD;
  static constexpr int bytes = (p_off + kRows * kPStride) * 4;
};

// Stores 4 fp32 values at dst (16-byte aligned) as a float4.
__device__ __forceinline__ void put(float* dst, const float* f) {
  *reinterpret_cast<float4*>(dst) = make_float4(f[0], f[1], f[2], f[3]);
}

template <int HD>
__global__ void __launch_bounds__(kThreads) flash_prefill_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, float* __restrict__ out,
    float* __restrict__ lse, int seqlen, int q_heads, int kv_heads,
    int true_len, int block_q, int causal, float scale) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  using L = Layout<HD>;
  float* sq = smem;
  float* sk = smem + L::k_off;
  float* sv = smem + L::v_off;
  float* sp = smem + L::p_off;
  constexpr int kVec = 4;                       // floats per 16-byte load
  constexpr int kVecs = HD / kVec;              // 16-byte loads per row
  constexpr int kCols = HD / 16;                // output columns per thread
  constexpr int kColVec = kCols < 4 ? kCols : 4;
  static_assert(HD % 32 == 0 && HD <= 256, "head_dim 32, 64, 128 or 256");

  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int h = blockIdx.y, b = blockIdx.z;
  const int group = q_heads / kv_heads;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * block_q;
  const int nq = min(block_q, seqlen - q0);
  const int rows = nq * group;

  // the Q tile, scaled in fp32; rows past `rows` are zeros
  for (int i = tid; i < kRows * kVecs; i += kThreads) {
    const int r = i / kVecs, c = (i % kVecs) * kVec;
    float f[kVec];
    if (r < rows) {
      const size_t src = (((size_t)b * seqlen + q0 + r / group) * q_heads +
                          (size_t)h * group + r % group) * HD + c;
      load16(q + src, f);
#pragma unroll
      for (int e = 0; e < kVec; ++e) f[e] *= scale;
    } else {
#pragma unroll
      for (int e = 0; e < kVec; ++e) f[e] = 0.f;
    }
    put(sq + r * HD + c, f);
  }

  // this thread's rows are ty + 16 i; row i sees keys < lim[i]
  int lim[4];
  float m[4], l[4], acc[4][kCols];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i, pos = q0 + r / group;
    const bool valid = r < rows && pos < true_len;
    lim[i] = !valid ? 0 : (causal ? min(pos + 1, true_len) : true_len);
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[i][c] = 0.f;
  }
  // the tile's horizon: no key at or past it is loaded
  const int last = min(q0 + nq, true_len);
  const int kv_end = last <= q0 ? 0 : (causal ? last : true_len);
  const size_t kv_stride = (size_t)kv_heads * HD;           // per position
  const float* k_head = k + (size_t)b * seqlen * kv_stride + (size_t)h * HD;
  const float* v_head = v + (size_t)b * seqlen * kv_stride + (size_t)h * HD;

  for (int k0 = 0; k0 < kv_end; k0 += kKeys) {
    const int nk = min(kKeys, kv_end - k0);
    __syncthreads();  // the previous tile is consumed (and Q is staged)
    for (int i = tid; i < kKeys * kVecs; i += kThreads) {
      const int j = i / kVecs, c = (i % kVecs) * kVec;
      float fk[kVec], fv[kVec];
      if (j < nk) {
        const size_t off = (size_t)(k0 + j) * kv_stride + c;
        load16(k_head + off, fk);
        load16(v_head + off, fv);
      } else {
#pragma unroll
        for (int e = 0; e < kVec; ++e) fk[e] = fv[e] = 0.f;
      }
      put(sk + j * L::kKStride + c, fk);
      put(sv + j * HD + c, fv);
    }
    __syncthreads();

    // scores: rows ty + 16 i against keys tx + 16 jj
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) s[i][jj] = 0.f;
#pragma unroll 4
    for (int c = 0; c < HD; c += 4) {
      float4 qf[4], kf[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        qf[i] = *reinterpret_cast<const float4*>(sq + (ty + 16 * i) * HD + c);
#pragma unroll
      for (int jj = 0; jj < 4; ++jj)
        kf[jj] = *reinterpret_cast<const float4*>(
            sk + (tx + 16 * jj) * L::kKStride + c);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          float a = s[i][jj];
          a = fmaf(qf[i].x, kf[jj].x, a);
          a = fmaf(qf[i].y, kf[jj].y, a);
          a = fmaf(qf[i].z, kf[jj].z, a);
          a = fmaf(qf[i].w, kf[jj].w, a);
          s[i][jj] = a;
        }
    }

    // online softmax; a row's 16 threads are 16 consecutive lanes
    float alpha[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = kNegInf;
#pragma unroll
      for (int jj = 0; jj < 4; ++jj)
        if (k0 + tx + 16 * jj < lim[i]) mx = fmaxf(mx, s[i][jj]);
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      float sum = 0.f;
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int j = tx + 16 * jj;
        // a masked key weighs exactly 0, never exp(-1e30 - m_new)
        const float p = k0 + j < lim[i] ? expf(s[i][jj] - m_new) : 0.f;
        sp[(ty + 16 * i) * kPStride + j] = p;
        sum += p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      alpha[i] = expf(m[i] - m_new);
      l[i] = l[i] * alpha[i] + sum;
      m[i] = m_new;
    }
    __syncthreads();

    // acc = acc * alpha + P V over the tile's nk keys; columns
    // u * 16 * kColVec + tx * kColVec + e, so a warp's float4 reads of one
    // V row are contiguous
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < kCols; ++c) acc[i][c] *= alpha[i];
    for (int j = 0; j < nk; ++j) {
      float pr[4], vv[kCols];
#pragma unroll
      for (int i = 0; i < 4; ++i) pr[i] = sp[(ty + 16 * i) * kPStride + j];
#pragma unroll
      for (int u = 0; u < kCols / kColVec; ++u) {
        const float* src = sv + j * HD + u * 16 * kColVec + tx * kColVec;
        if constexpr (kColVec == 4) {
          const float4 t = *reinterpret_cast<const float4*>(src);
          vv[4 * u] = t.x;
          vv[4 * u + 1] = t.y;
          vv[4 * u + 2] = t.z;
          vv[4 * u + 3] = t.w;
        } else {
          const float2 t = *reinterpret_cast<const float2*>(src);
          vv[2 * u] = t.x;
          vv[2 * u + 1] = t.y;
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < kCols; ++c)
          acc[i][c] = fmaf(pr[i], vv[c], acc[i][c]);
    }
  }

  // epilogue: divide, or exact zeros for rows at or past true_len
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    if (r >= rows) continue;
    const int pos = q0 + r / group;
    const bool valid = pos < true_len;
    const float denom = fmaxf(l[i], 1e-30f);
    if (lse != nullptr && tx == 0)
      lse[((size_t)b * q_heads + (size_t)h * group + r % group) * seqlen +
          pos] = valid ? m[i] + logf(denom) : 0.f;
    float* dst = out + (((size_t)b * seqlen + pos) * q_heads +
                        (size_t)h * group + r % group) * HD;
#pragma unroll
    for (int u = 0; u < kCols / kColVec; ++u)
#pragma unroll
      for (int e = 0; e < kColVec; ++e) {
        const int c = u * kColVec + e;
        dst[u * 16 * kColVec + tx * kColVec + e] =
            valid ? acc[i][c] / denom : 0.f;
      }
  }
}

template <int HD>
int launch(const void* q, const void* k, const void* v, void* out,
           float* lse, int batch, int seqlen, int q_heads, int kv_heads,
           int true_len, int block_q, int causal, float scale,
           cudaStream_t stream) {
  constexpr int smem = Layout<HD>::bytes;
  static_assert(smem <= kMaxSmem, "K5 tile exceeds shared memory");
  static bool opted_in = false;       // once per instantiation
  if (!opted_in) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_prefill_kernel<HD>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    opted_in = true;
  }
  const dim3 grid((seqlen + block_q - 1) / block_q, kv_heads, batch);
  flash_prefill_kernel<HD><<<grid, kThreads, smem, stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (float*)out, lse,
      seqlen, q_heads, kv_heads, true_len, block_q, causal, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// Returns the cudaError_t of the launch (0 on success). q, k, v and out
// are fp32 (bf16 is flash_prefill_sm90.cu's). q and out
// [batch, seqlen, q_heads, head_dim], k and v [batch, seqlen, kv_heads,
// head_dim], contiguous and 16-byte aligned; block_q * (q_heads /
// kv_heads) <= 64; 0 < true_len <= seqlen; lse null or fp32 [batch,
// q_heads, seqlen]. grids (n_grids x 3 ints) is the wrapper's
// flash_prefill_grid; a grid that is not this launch's is refused before
// anything launches. The caller has checked shapes, dtypes and alignment.
extern "C" int flash_prefill_launch(int head_dim, const void* q,
                                    const void* k, const void* v, void* out,
                                    float* lse, int batch, int seqlen,
                                    int q_heads, int kv_heads, int true_len,
                                    int block_q, int causal, float scale,
                                    const int* grids, int n_grids,
                                    void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (kv_heads < 1 || q_heads % kv_heads || block_q < 1 ||
      block_q * (q_heads / kv_heads) > kRows || true_len < 1 ||
      true_len > seqlen)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((seqlen + block_q - 1) / block_q, kv_heads, batch);
  if (!grids_match(grids, n_grids, &grid, 1))
    return (int)cudaErrorInvalidValue;
  switch (head_dim) {
    case 256:
      return launch<256>(q, k, v, out, lse, batch, seqlen, q_heads, kv_heads,
                         true_len, block_q, causal, scale, s);
    case 128:
      return launch<128>(q, k, v, out, lse, batch, seqlen, q_heads, kv_heads,
                         true_len, block_q, causal, scale, s);
    case 64:
      return launch<64>(q, k, v, out, lse, batch, seqlen, q_heads, kv_heads,
                        true_len, block_q, causal, scale, s);
    case 32:
      return launch<32>(q, k, v, out, lse, batch, seqlen, q_heads, kv_heads,
                        true_len, block_q, causal, scale, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
