// Dense flash prefill in bf16 on Hopper's tensor cores (sm_90a): causal or
// non-causal GQA attention over a whole prompt, q [B, S, H, hd] against
// k, v [B, S, Hkv, hd], with Hkv dividing H. fp32 inputs go to the
// CUDA-core kernel of flash_prefill.cu instead: tensor-core products of
// bf16 operands cannot meet fp32's tolerance.
//
// Replaces the TPU kernel repro/kernels/flash_prefill/flash_prefill.py
// (flash_prefill :144, body _flash_kernel :88) and computes what it does:
// an online softmax with fp32 (m, l, acc) across key tiles, fp32
// probabilities in the P V product, a causal mask on positions (key <=
// query) or none, keys at or past true_len never attended, rows at or past
// true_len written as exact zeros, and an epilogue dividing by
// max(l, 1e-30).
//
// What bounds it on this card: at r1-distill-14b's shapes (40/8 heads, hd
// 128), bytes at S = 272 (6.7 MB, 0.0020 ms at 3.35 TB/s) and operations
// at S = 4096 (172 GFLOP, 0.174 ms at 989 TFLOP/s of bf16 tensor cores).
//
// Design:
//   * One CTA per (q tile, KV head, batch), heaviest causal tiles first.
//     Its rows pack floor(rows / group) positions times the group's query
//     heads (row r: position q0 + r / group, head h * group + r % group),
//     so each K/V tile serves the whole GQA group and K/V are never
//     repeated. A CTA is one or two consumer warpgroups of 64 rows each
//     plus one producer warp; the caller picks 128 rows where that still
//     gives the grid a CTA per SM, 64 otherwise.
//   * The producer warp loads Q once and streams 64-key K and V tiles
//     through a ring of shared-memory stages with TMA
//     (cp.async.bulk.tensor onto mbarriers), up to the tile's causal
//     horizon: no key tile above the diagonal is loaded. Consumers wait on
//     a stage, compute, and release it.
//   * S = Q K^T is wgmma m64n64k16 with Q and K from shared memory (128 B
//     swizzle, 64 B at head_dim 32); the scale 1/sqrt(hd) is applied to
//     the fp32 scores, inside each exponent. O += P V is wgmma m64nNk16, N
//     = head_dim, with P from registers and V from shared memory read
//     transposed (keys x hd as stored); at head_dim 128 one product spans
//     both 64-column swizzle parts, at 256 two N = 128 products span two
//     parts each.
//   * Head_dim 256 (gemma-7b) is its own instantiation with one consumer
//     warpgroup (64 rows) and two stages: its O accumulator is 128 fp32
//     registers a thread, and Q (32 KB) plus two stages of K and V (128
//     KB) is what fits beside it; three stages of two warpgroups would
//     take 256 KB.
//   * P stays fp32 as in the TPU kernel: it is split into hi = bf16(P) and
//     lo = bf16(P - hi) and both are multiplied into the same fp32
//     accumulator, 1.5x the function's tensor operations. Rounding P to
//     bf16 alone would change what the kernel computes.
//   * The NaN trap: a tensor core computes 0 * NaN = NaN, so a K/V row past
//     true_len that reached shared memory would poison P V even at P = 0.
//     The K/V tensor maps have a sequence extent of true_len, so the TMA
//     unit fills every row past it with zeros. Masked scores are the
//     finite NEG_INF and masked probabilities are exactly 0.
#include <cuda.h>

#include "hopper_ptx.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kKeys = 64;           // keys per K/V tile
constexpr int kWgRows = 64;         // query rows per consumer warpgroup
constexpr float kNegInf = -1e30f;   // the TPU kernel's NEG_INF
constexpr int kMaxSmem = 232448;    // what a block may take on the H100

// Shared-memory tiling of one head_dim: rows of kBlk bf16 values (one
// swizzle span), head_dim / kBlk column parts stored one after the other.
template <int HD>
struct Geo {
  static constexpr int kBlk = HD < 64 ? HD : 64;
  static constexpr int kRowBytes = kBlk * 2;              // 64 or 128
  static constexpr int kParts = HD / kBlk;                // 1 or 2
  static constexpr int kSwizzle = kRowBytes == 128 ? 1 : 2;
  static constexpr int kSbo = 8 * kRowBytes;              // 8-row group
  static constexpr int kKvPart = kKeys * kRowBytes;       // one tile part
  static constexpr int kKvBytes = kKeys * HD * 2;         // one K or V tile
};

template <int HD, int NWG, int STAGES>
struct Smem {
  using G = Geo<HD>;
  static constexpr int kQPart = NWG * kWgRows * G::kRowBytes;
  static constexpr int q_off = 0;
  static constexpr int k_off = q_off + G::kParts * kQPart;
  static constexpr int v_off = k_off + STAGES * G::kKvBytes;
  static constexpr int bar_off = v_off + STAGES * G::kKvBytes;
  // q_full, k_full[STAGES], v_full[STAGES], empty[STAGES]
  static constexpr int bytes = bar_off + 8 * (1 + 3 * STAGES) + 1024;
};

template <int HD, int NWG, int STAGES>
__global__ void __launch_bounds__(NWG * 128 + 32, 1) flash_prefill_wgmma(
    const __grid_constant__ CUtensorMap tm_q,
    const __grid_constant__ CUtensorMap tm_k,
    const __grid_constant__ CUtensorMap tm_v, bf16* __restrict__ out,
    int seqlen, int q_heads, int kv_heads, int true_len, int block_q,
    int causal, float scale_log2) {
  using G = Geo<HD>;
  using L = Smem<HD, NWG, STAGES>;
  extern __shared__ uint8_t smem_raw[];
  // swizzled tiles want 1024-byte alignment
  uint8_t* smem = smem_raw + ((1024 - (ptx::smem_addr(smem_raw) & 1023)) &
                              1023);
  uint8_t* sq = smem + L::q_off;
  uint8_t* sk = smem + L::k_off;
  uint8_t* sv = smem + L::v_off;
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + L::bar_off);
  uint64_t* q_full = bars;
  uint64_t* k_full = bars + 1;
  uint64_t* v_full = bars + 1 + STAGES;
  uint64_t* empty = bars + 1 + 2 * STAGES;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int h = blockIdx.y, b = blockIdx.z;
  const int group = q_heads / kv_heads;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * block_q;
  const int nq = min(block_q, seqlen - q0);
  const int rows = nq * group;
  // the tile's horizon: no key at or past it is loaded
  const int last = min(q0 + nq, true_len);
  const int kv_end = last <= q0 ? 0 : (causal ? last : true_len);
  const int n_tiles = (kv_end + kKeys - 1) / kKeys;

  if (tid == 0) {
    ptx::mbar_init(q_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      ptx::mbar_init(k_full + s, 1);
      ptx::mbar_init(v_full + s, 1);
      ptx::mbar_init(empty + s, NWG * 4);   // one arrival per consumer warp
    }
    ptx::fence_barrier_init();
  }
  __syncthreads();

  if (warp == NWG * 4) {
    // ---- producer: one thread issues every TMA load
    if (lane == 0 && n_tiles > 0) {
      ptx::mbar_expect_tx(q_full, G::kParts * block_q * group * G::kRowBytes);
      for (int p = 0; p < G::kParts; ++p)
        ptx::tma_load_4d(sq + p * L::kQPart, &tm_q, q_full, p * G::kBlk,
                         h * group, q0, b);
      for (int t = 0; t < n_tiles; ++t) {
        const int s = t % STAGES;
        if (t >= STAGES) ptx::mbar_wait(empty + s, (t / STAGES - 1) & 1);
        ptx::mbar_expect_tx(k_full + s, G::kKvBytes);
        for (int p = 0; p < G::kParts; ++p)
          ptx::tma_load_4d(sk + s * G::kKvBytes + p * G::kKvPart, &tm_k,
                           k_full + s, p * G::kBlk, h, t * kKeys, b);
        ptx::mbar_expect_tx(v_full + s, G::kKvBytes);
        for (int p = 0; p < G::kParts; ++p)
          ptx::tma_load_4d(sv + s * G::kKvBytes + p * G::kKvPart, &tm_v,
                           v_full + s, p * G::kBlk, h, t * kKeys, b);
      }
    }
    return;
  }

  // ---- consumers: warpgroup wg owns rows wg * 64 .. wg * 64 + 63; this
  // thread holds rows r[0] and r[1] = r[0] + 8 of the accumulators
  const int wg = warp / 4;
  int lim[2];
  int r[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    r[i] = wg * kWgRows + (warp % 4) * 16 + lane / 4 + 8 * i;
    const int pos = q0 + r[i] / group;
    const bool valid = r[i] < rows && pos < true_len;
    lim[i] = !valid ? 0 : (causal ? min(pos + 1, true_len) : true_len);
  }
  constexpr int kO = G::kBlk / 2;   // accumulator floats per column part
  float o[G::kParts][kO];
#pragma unroll
  for (int p = 0; p < G::kParts; ++p)
#pragma unroll
    for (int i = 0; i < kO; ++i) o[p][i] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};

  if (n_tiles > 0) ptx::mbar_wait(q_full, 0);
  const uint8_t* sq_wg = sq + wg * kWgRows * G::kRowBytes;
  for (int t = 0; t < n_tiles; ++t) {
    const int s = t % STAGES;
    const uint32_t parity = (t / STAGES) & 1;
    const uint8_t* k_tile = sk + s * G::kKvBytes;
    const uint8_t* v_tile = sv + s * G::kKvBytes;

    // S = Q K^T over head_dim in steps of 16
    float sc[kKeys / 2];
#pragma unroll
    for (int i = 0; i < kKeys / 2; ++i) sc[i] = 0.f;
    ptx::fence_operands<kKeys / 2>(sc);
    ptx::mbar_wait(k_full + s, parity);
    ptx::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      const int part = kk * 16 / G::kBlk;
      const int off = (kk * 16 % G::kBlk) * 2;
      ptx::wgmma_m64n64k16_ss(
          sc,
          ptx::wgmma_desc(sq_wg + part * L::kQPart + off, 0, G::kSbo,
                          G::kSwizzle),
          ptx::wgmma_desc(k_tile + part * G::kKvPart + off, 0, G::kSbo,
                          G::kSwizzle),
          kk > 0);
    }
    ptx::wgmma_commit();
    ptx::wgmma_wait_all();
    ptx::fence_operands<kKeys / 2>(sc);

    // online softmax; m holds the raw (unscaled) row max and the scale
    // (1/sqrt(hd) in log2 units) goes into each exponent. sc[4j + 2i + e]
    // is row r[i], key t * 64 + 8j + 2 (lane % 4) + e; a row's 64 keys sit
    // in one quad
    const int k0 = t * kKeys + 2 * (lane % 4);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float mx = kNegInf;
      // the keys of this tile that row r[i] sees, from this lane's first
      const int vis = lim[i] - k0;
      if (vis >= kKeys) {
#pragma unroll
        for (int j = 0; j < kKeys / 8; ++j)
          mx = fmaxf(mx, fmaxf(sc[4 * j + 2 * i], sc[4 * j + 2 * i + 1]));
      } else {
#pragma unroll
        for (int j = 0; j < kKeys / 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            float& x = sc[4 * j + 2 * i + e];
            x = 8 * j + e < vis ? x : kNegInf;
            mx = fmaxf(mx, x);
          }
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[i], mx);
      const float m_scaled = m_new * scale_log2;
      // (m - m_new) first: with both at NEG_INF this is exp2(0) = 1, where
      // a fused m * scale - m_scaled could round to +-1e22
      const float alpha = exp2f((m[i] - m_new) * scale_log2);
      float sum = 0.f;
      if (vis >= kKeys) {
#pragma unroll
        for (int j = 0; j < kKeys / 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            float& x = sc[4 * j + 2 * i + e];
            x = exp2f(fmaf(x, scale_log2, -m_scaled));
            sum += x;
          }
      } else {
#pragma unroll
        for (int j = 0; j < kKeys / 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            float& x = sc[4 * j + 2 * i + e];
            // a masked key weighs exactly 0, never exp(-1e30 - m_new)
            x = 8 * j + e < vis ? exp2f(fmaf(x, scale_log2, -m_scaled))
                                : 0.f;
            sum += x;
          }
      }
      l[i] = l[i] * alpha + sum;
      m[i] = m_new;
#pragma unroll
      for (int p = 0; p < G::kParts; ++p)
#pragma unroll
        for (int j = 0; j < kO / 4; ++j) {
          o[p][4 * j + 2 * i] *= alpha;
          o[p][4 * j + 2 * i + 1] *= alpha;
        }
    }

    // P as bf16 hi and lo A fragments, 16 keys per step
    uint32_t p_hi[kKeys / 16][4], p_lo[kKeys / 16][4];
#pragma unroll
    for (int kk = 0; kk < kKeys / 16; ++kk)
#pragma unroll
      for (int x = 0; x < 4; ++x)
        ptx::split_bf16(sc[8 * kk + 2 * x], sc[8 * kk + 2 * x + 1],
                        p_hi[kk][x], p_lo[kk][x]);

    // O += P V, V read transposed: 16 keys of rows kRowBytes apart
    ptx::mbar_wait(v_full + s, parity);
#pragma unroll
    for (int p = 0; p < G::kParts; ++p) ptx::fence_operands<kO>(o[p]);
    ptx::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kKeys / 16; ++kk) {
      // N = head_dim: at 128 the descriptor's leading byte offset steps
      // from one 64-column part to the other
      const uint64_t dv =
          ptx::wgmma_desc(v_tile + kk * 16 * G::kRowBytes, G::kKvPart,
                          G::kSbo, G::kSwizzle);
      if constexpr (HD == 256) {
        // two N = 128 halves: columns 0-127 (parts 0-1), then 128-255
        // (parts 2-3), each with the same leading byte offset
        const uint64_t dv2 = ptx::wgmma_desc(
            v_tile + 2 * G::kKvPart + kk * 16 * G::kRowBytes, G::kKvPart,
            G::kSbo, G::kSwizzle);
        ptx::wgmma_m64n128k16_rs_tb(&o[0][0], p_hi[kk], dv);
        ptx::wgmma_m64n128k16_rs_tb(&o[0][0], p_lo[kk], dv);
        ptx::wgmma_m64n128k16_rs_tb(&o[2][0], p_hi[kk], dv2);
        ptx::wgmma_m64n128k16_rs_tb(&o[2][0], p_lo[kk], dv2);
      } else if constexpr (HD == 128) {
        ptx::wgmma_m64n128k16_rs_tb(&o[0][0], p_hi[kk], dv);
        ptx::wgmma_m64n128k16_rs_tb(&o[0][0], p_lo[kk], dv);
      } else if constexpr (HD == 64) {
        ptx::wgmma_m64n64k16_rs_tb(o[0], p_hi[kk], dv);
        ptx::wgmma_m64n64k16_rs_tb(o[0], p_lo[kk], dv);
      } else {
        ptx::wgmma_m64n32k16_rs_tb(o[0], p_hi[kk], dv);
        ptx::wgmma_m64n32k16_rs_tb(o[0], p_lo[kk], dv);
      }
    }
    ptx::wgmma_commit();
    ptx::wgmma_wait_all();
#pragma unroll
    for (int p = 0; p < G::kParts; ++p) ptx::fence_operands<kO>(o[p]);
    // the A fragments stay live until the products that read them are done
    ptx::fence_regs<kKeys / 4>(&p_hi[0][0]);
    ptx::fence_regs<kKeys / 4>(&p_lo[0][0]);
    __syncwarp();
    if (lane == 0) ptx::mbar_arrive(empty + s);   // this warp is done
  }

  // epilogue: divide, or exact zeros for rows at or past true_len
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float lt = l[i];
    lt += __shfl_xor_sync(0xffffffffu, lt, 1);
    lt += __shfl_xor_sync(0xffffffffu, lt, 2);
    if (r[i] >= rows) continue;
    const int pos = q0 + r[i] / group;
    const float inv = pos < true_len ? 1.f / fmaxf(lt, 1e-30f) : 0.f;
    bf16* dst = out + (((size_t)blockIdx.z * seqlen + pos) * q_heads +
                       (size_t)h * group + r[i] % group) * HD +
                2 * (lane % 4);
#pragma unroll
    for (int p = 0; p < G::kParts; ++p)
#pragma unroll
      for (int j = 0; j < kO / 4; ++j)
        *reinterpret_cast<__nv_bfloat162*>(dst + p * G::kBlk + 8 * j) =
            __floats2bfloat162_rn(o[p][4 * j + 2 * i] * inv,
                                  o[p][4 * j + 2 * i + 1] * inv);
  }
}

// ------------------------------------------------------------------ host

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from libcuda, looked up through the runtime so
// that the library needs no -lcuda.
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A bf16 [batch, len (of seqlen rows), heads, head_dim] view as a 4-D
// tensor map with boxes of box_heads x box_rows rows of kBlk values.
template <int HD>
bool make_map(CUtensorMap* map, const void* base, int batch, int seqlen,
              int len, int heads, int box_heads, int box_rows) {
  using G = Geo<HD>;
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)HD, (cuuint64_t)heads,
                              (cuuint64_t)len, (cuuint64_t)batch};
  const cuuint64_t strides[3] = {(cuuint64_t)HD * 2,
                                 (cuuint64_t)heads * HD * 2,
                                 (cuuint64_t)seqlen * heads * HD * 2};
  const cuuint32_t box[4] = {(cuuint32_t)G::kBlk, (cuuint32_t)box_heads,
                             (cuuint32_t)box_rows, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                const_cast<void*>(base), dims, strides, box, elem,
                CU_TENSOR_MAP_INTERLEAVE_NONE,
                G::kSwizzle == 1 ? CU_TENSOR_MAP_SWIZZLE_128B
                                 : CU_TENSOR_MAP_SWIZZLE_64B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int HD, int NWG>
int launch(const void* q, const void* k, const void* v, void* out, int batch,
           int seqlen, int q_heads, int kv_heads, int true_len, int block_q,
           int causal, float scale, cudaStream_t stream) {
  constexpr int kStages = NWG == 2 ? 3 : 2;
  constexpr int smem = Smem<HD, NWG, kStages>::bytes;
  static_assert(smem <= kMaxSmem, "K5 tiles exceed shared memory");
  const int group = q_heads / kv_heads;
  CUtensorMap tm_q, tm_k, tm_v;
  // K and V end at true_len: the TMA unit zero-fills every row past it
  if (!make_map<HD>(&tm_q, q, batch, seqlen, seqlen, q_heads, group,
                    block_q) ||
      !make_map<HD>(&tm_k, k, batch, seqlen, true_len, kv_heads, 1, kKeys) ||
      !make_map<HD>(&tm_v, v, batch, seqlen, true_len, kv_heads, 1, kKeys))
    return (int)cudaErrorInvalidValue;
  auto kernel = flash_prefill_wgmma<HD, NWG, kStages>;
  static bool opted_in = false;       // once per instantiation
  if (!opted_in) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    opted_in = true;
  }
  const dim3 grid((seqlen + block_q - 1) / block_q, kv_heads, batch);
  kernel<<<grid, NWG * 128 + 32, smem, stream>>>(
      tm_q, tm_k, tm_v, (bf16*)out, seqlen, q_heads, kv_heads, true_len,
      block_q, causal, scale * 1.4426950408889634f);
  return (int)cudaGetLastError();
}

// One consumer warpgroup (rows = 64) or two (128); head_dim 256 takes one
// only: its O accumulator is 128 registers a thread, and two warpgroups
// under one producer warp leave a thread 224.
template <int HD>
int launch_rows(int rows, const void* q, const void* k, const void* v,
                void* out, int batch, int seqlen, int q_heads, int kv_heads,
                int true_len, int block_q, int causal, float scale,
                cudaStream_t s) {
  if constexpr (HD == 256) {
    if (rows != kWgRows) return (int)cudaErrorInvalidValue;
  } else if (rows == 128)
    return launch<HD, 2>(q, k, v, out, batch, seqlen, q_heads, kv_heads,
                         true_len, block_q, causal, scale, s);
  return launch<HD, 1>(q, k, v, out, batch, seqlen, q_heads, kv_heads,
                       true_len, block_q, causal, scale, s);
}

}  // namespace

// Returns the cudaError_t of the launch (0 on success). q, k, v and out
// are bf16, q and out [batch, seqlen, q_heads, head_dim], k and v [batch,
// seqlen, kv_heads, head_dim], contiguous and 16-byte aligned; rows is 64
// or 128 (one or two consumer warpgroups per CTA; 64 at head_dim 256) and
// block_q * (q_heads / kv_heads) <= rows; 0 < true_len <= seqlen. The
// caller has checked shapes, dtypes and alignment.
extern "C" int flash_prefill_sm90_launch(int head_dim, const void* q,
                                         const void* k, const void* v,
                                         void* out, int batch, int seqlen,
                                         int q_heads, int kv_heads,
                                         int true_len, int rows, int block_q,
                                         int causal, float scale,
                                         void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (kv_heads < 1 || q_heads % kv_heads || (rows != 64 && rows != 128) ||
      block_q < 1 || block_q * (q_heads / kv_heads) > rows ||
      block_q > 256 || true_len < 1 || true_len > seqlen)
    return (int)cudaErrorInvalidValue;
  switch (head_dim) {
    case 256:
      return launch_rows<256>(rows, q, k, v, out, batch, seqlen, q_heads,
                              kv_heads, true_len, block_q, causal, scale, s);
    case 128:
      return launch_rows<128>(rows, q, k, v, out, batch, seqlen, q_heads,
                              kv_heads, true_len, block_q, causal, scale, s);
    case 64:
      return launch_rows<64>(rows, q, k, v, out, batch, seqlen, q_heads,
                             kv_heads, true_len, block_q, causal, scale, s);
    case 32:
      return launch_rows<32>(rows, q, k, v, out, batch, seqlen, q_heads,
                             kv_heads, true_len, block_q, causal, scale, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
