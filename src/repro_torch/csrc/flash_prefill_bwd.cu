// The gradient of the dense flash prefill (kernel K5) for Hopper (sm_90a):
// dQ, dK and dV of causal or non-causal GQA attention over a whole
// sequence, q [B, S, H, hd] against k, v [B, S, Hkv, hd], Hkv dividing H,
// from the forward's output O, its log-sum-exp and the output's gradient
// dO. bf16 runs on the tensor cores (mma.sync m16n8k16, fp32
// accumulators), fp32 on the CUDA cores.
//
// What it replaces: the JAX package has no Pallas backward. Its training
// path takes XLA's autodiff of the plain attention (_attend,
// repro/models/attention.py:70) where the port's forward is K5, so this is
// the gradient of what K5 computes (repro/kernels/flash_prefill/
// flash_prefill.py:144): scale = 1/sqrt(hd), a causal mask on positions
// (key <= query) or none, keys at or past true_len never attended, rows at
// or past true_len exact zeros. With LSE_i the forward's natural log-sum-
// exp of row i's scaled scores:
//   P_ij  = exp(scale q_i.k_j - LSE_i)      (0 where key j is masked)
//   D_i   = sum_d dO_id O_id
//   dS_ij = P_ij (dO_i.v_j - D_i)
//   dV_j  = sum_i P_ij dO_i,   dK_j = scale sum_i dS_ij q_i,
//   dQ_i  = scale sum_j dS_ij k_j.
// Rows at or past true_len get dQ = 0 and give nothing to dK and dV; keys
// at or past true_len get dK = dV = 0.
//
// Three kernels, launched in order on one stream by one call:
//   * bwd_dot: D = rowsum(dO * O) in fp32, one warp per (position, head);
//   * dK/dV: one CTA per (key tile, KV head, batch). It loops over the GQA
//     group's query heads and the query tiles that can see its key tile
//     (from the tile's first key on when causal), recomputes S, P, dP and
//     dS, and accumulates dV and dK for its keys. The group's heads are
//     summed inside the CTA, so nothing is accumulated with atomics and
//     the gradients are the same bits from run to run;
//   * dQ: one CTA per (query tile, query head, batch) over the keys its
//     rows see.
// Operand staging: tiles are copied into shared memory with cp.async
// (bf16; the next query or key tile in flight while this one computes),
// rows padded by 16 bytes so ldmatrix's row reads fall in distinct bank
// groups. Rows and keys past true_len (and past S) are stored as zeros,
// never read: a tensor core computes 0 * NaN = NaN.
//
// bf16 numerics: S = Q K^T and dP = dO V^T take the bf16 inputs with fp32
// accumulators; P (fp32, from exp2 with the scale folded into the
// exponent) and dS (fp32) are rounded to bf16 where they become the A
// operand of dV += P^T dO, dK += dS^T Q and dQ += dS K, as FlashAttention
// does; dQ, dK and dV are accumulated in fp32 and rounded to bf16 once.
// fp32 runs every product in fp32 FMAs.
//
// What bounds it on this card: operations. Five products of 2 hd
// operations per (row, visible key): S is computed in both kernels, so
// the kernels do 7 of them (2.5x the forward's count for the function,
// 3.5x as executed). A simple first design: no wgmma or TMA, each warp
// its own m16 tiles; at head_dim 256 two warps share an m-tile, each
// owning 128 of the accumulated columns (both compute its S and dP), so a
// thread holds at most 2 x 64 accumulator registers.
#include "hopper_ptx.cuh"

namespace {

using bf16 = __nv_bfloat16;
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kMaxSmem = 232448;    // what a block may take on the H100

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }

// ------------------------------------------------------------- D pass

template <typename T>
__global__ void __launch_bounds__(256) bwd_dot_kernel(
    const T* __restrict__ out, const T* __restrict__ dout,
    float* __restrict__ delta, int batch, int seqlen, int q_heads,
    int head_dim, int true_len) {
  const long row = (long)blockIdx.x * 8 + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= (long)batch * seqlen * q_heads) return;
  const int head = (int)(row % q_heads);
  const int pos = (int)((row / q_heads) % seqlen);
  const int b = (int)(row / ((long)q_heads * seqlen));
  const T* o = out + row * head_dim;
  const T* g = dout + row * head_dim;
  float sum = 0.f;
  for (int c = lane; c < head_dim; c += 32)
    sum = fmaf(to_f(o[c]), to_f(g[c]), sum);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    sum += __shfl_xor_sync(0xffffffffu, sum, off);
  if (lane == 0)
    delta[((size_t)b * q_heads + head) * seqlen + pos] =
        pos < true_len ? sum : 0.f;
}

// ------------------------------------------------------------ bf16 (mma)

// Shared-memory rows of HD bf16, padded by 8 (16 bytes).
template <int HD>
struct Mma {
  static constexpr int kST = HD + 8;
  static constexpr int kNCol = HD <= 128 ? HD : 128;   // columns a warp owns
  static constexpr int kWPK = HD / kNCol;              // warps per m-tile
  static constexpr int kWarps = 4 * kWPK;              // four m16 tiles
  static constexpr int kThreads = 32 * kWarps;
  static constexpr int kRows = 64;                     // the CTA's own rows
  static constexpr int kStep = 32;                     // rows streamed
  static constexpr int kRowTile = kRows * kST * 2;     // bytes
  static constexpr int kStepTile = kStep * kST * 2;
  // [own 0][own 1][2 stages x (step 0, step 1)][2 stages x 2 x kStep fp32]
  static constexpr int bytes = 2 * kRowTile + 4 * kStepTile +
                               2 * 2 * kStep * 4;
};

// Copies `rows` rows of HD bf16 (row r from src + r * src_stride) into
// shared memory at dst (rows kST apart) with cp.async; rows at or past
// `valid` are zeros.
template <int HD>
__device__ __forceinline__ void stage_rows(bf16* dst, const bf16* src,
                                           size_t src_stride, int rows,
                                           int valid, int tid,
                                           int threads) {
  constexpr int kVecs = HD / 8;
  for (int i = tid; i < rows * kVecs; i += threads) {
    const int r = i / kVecs, c = (i % kVecs) * 8;
    bf16* d = dst + r * Mma<HD>::kST + c;
    if (r < valid)
      ptx::cp_async_16(d, src + r * src_stride + c);
    else
      *reinterpret_cast<uint4*>(d) = make_uint4(0u, 0u, 0u, 0u);
  }
}

// acc[nb] (+)= A B over HD, for n-blocks of 8 rows of `b` (shared memory,
// rows kST apart, HD contiguous): A is the 16 rows of shared memory at a.
// acc[nb][2 i + e] is row lane / 4 + 8 i, column 8 nb + 2 (lane % 4) + e.
template <int HD, int NB>
__device__ __forceinline__ void mma_rows(float (&acc)[NB][4], const bf16* a,
                                         const bf16* b, int lane) {
  constexpr int kST = Mma<HD>::kST;
#pragma unroll
  for (int nb = 0; nb < NB; ++nb)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nb][e] = 0.f;
  const bf16* ap = a + (lane % 8 + 8 * ((lane / 8) % 2)) * kST +
                   8 * (lane / 16);
  const bf16* bp = b + (lane % 8) * kST + 8 * (lane / 8);
#pragma unroll
  for (int c32 = 0; c32 < HD / 32; ++c32) {
    uint32_t fa[2][4];
    ptx::ldmatrix_x4(fa[0], ap + 32 * c32);
    ptx::ldmatrix_x4(fa[1], ap + 32 * c32 + 16);
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) {
      uint32_t fb[4];
      ptx::ldmatrix_x4(fb, bp + 8 * nb * kST + 32 * c32);
      ptx::mma_m16n8k16(acc[nb], fa[0], fb[0], fb[1]);
      ptx::mma_m16n8k16(acc[nb], fa[1], fb[2], fb[3]);
    }
  }
}

// out[16 x kNCol] += A[16 x 8 NB] B, A given as NB / 2 k16 steps of
// fp32 fragments in the accumulator layout of mma_rows (rounded to bf16
// here), B the 8 NB rows of shared memory at b (kST apart), columns c0 ..
// c0 + kNCol - 1, read transposed.
template <int HD, int NB>
__device__ __forceinline__ void mma_acc(
    float (&out)[Mma<HD>::kNCol / 8][4], const float (&a)[NB][4],
    const bf16* b, int c0, int lane) {
  constexpr int kST = Mma<HD>::kST;
  const bf16* bp = b + (lane % 8 + 8 * ((lane / 8) % 2)) * kST + c0 +
                   8 * (lane / 16);
#pragma unroll
  for (int kk = 0; kk < NB / 2; ++kk) {
    uint32_t fa[4];
    fa[0] = ptx::pack_bf16(a[2 * kk][0], a[2 * kk][1]);
    fa[1] = ptx::pack_bf16(a[2 * kk][2], a[2 * kk][3]);
    fa[2] = ptx::pack_bf16(a[2 * kk + 1][0], a[2 * kk + 1][1]);
    fa[3] = ptx::pack_bf16(a[2 * kk + 1][2], a[2 * kk + 1][3]);
#pragma unroll
    for (int np = 0; np < Mma<HD>::kNCol / 16; ++np) {
      uint32_t fb[4];
      ptx::ldmatrix_x4_trans(fb, bp + 16 * kk * kST + 16 * np);
      ptx::mma_m16n8k16(out[2 * np], fa, fb[0], fb[1]);
      ptx::mma_m16n8k16(out[2 * np + 1], fa, fb[2], fb[3]);
    }
  }
}

// Writes a warp's [16 x kNCol] fp32 accumulator times `mul` as bf16 rows
// row0 + lane / 4 (+ 8) of dst (rows `stride` elements apart), columns
// c0 + ..., rows at or past `rows_end` skipped.
template <int HD>
__device__ __forceinline__ void store_rows(
    bf16* dst, size_t stride, const float (&acc)[Mma<HD>::kNCol / 8][4],
    float mul, int row0, int rows_end, int c0, int lane) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = row0 + lane / 4 + 8 * i;
    if (r >= rows_end) continue;
    bf16* d = dst + r * stride + c0 + 2 * (lane % 4);
#pragma unroll
    for (int nn = 0; nn < Mma<HD>::kNCol / 8; ++nn)
      *reinterpret_cast<__nv_bfloat162*>(d + 8 * nn) =
          __floats2bfloat162_rn(acc[nn][2 * i] * mul,
                                acc[nn][2 * i + 1] * mul);
  }
}

// dK and dV of 64 keys of one (KV head, batch): four m16 key tiles, each
// warp one (and at head_dim 256 one half of its columns); query heads of
// the group x 32-row query tiles streamed through two stages.
template <int HD>
__global__ void __launch_bounds__(Mma<HD>::kThreads) dkdv_mma_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, const bf16* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    bf16* __restrict__ dk, bf16* __restrict__ dv, int seqlen, int q_heads,
    int kv_heads, int true_len, int causal, float scale) {
  using M = Mma<HD>;
  constexpr int kST = M::kST;
  extern __shared__ uint4 smem4[];
  bf16* sk = reinterpret_cast<bf16*>(smem4);
  bf16* sv = sk + M::kRows * kST;
  bf16* sq = sv + M::kRows * kST;                 // [stage][kStep][kST]
  bf16* sdo = sq + 2 * M::kStep * kST;
  float* sl = reinterpret_cast<float*>(sdo + 2 * M::kStep * kST);
  float* sd = sl + 2 * M::kStep;                  // [stage][kStep]

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int h = blockIdx.y, b = blockIdx.z;
  const int group = q_heads / kv_heads;
  const int k0 = blockIdx.x * M::kRows;           // key tile 0 first
  const int n = true_len;
  const int mt = warp / M::kWPK, c0 = (warp % M::kWPK) * M::kNCol;
  const size_t kv_row = (size_t)kv_heads * HD;
  const size_t q_row = (size_t)q_heads * HD;
  const size_t kv_base = ((size_t)b * seqlen * kv_heads + h) * HD;

  float acc_v[M::kNCol / 8][4], acc_k[M::kNCol / 8][4];
#pragma unroll
  for (int nn = 0; nn < M::kNCol / 8; ++nn)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc_v[nn][e] = acc_k[nn][e] = 0.f;

  const int q_begin = causal ? k0 : 0;
  const int n_qt = k0 < n ? (n - q_begin + M::kStep - 1) / M::kStep : 0;
  const int n_steps = group * n_qt;
  if (n_steps > 0) {
    stage_rows<HD>(sk, k + kv_base + (size_t)k0 * kv_row, kv_row, M::kRows,
                   n - k0, tid, M::kThreads);
    stage_rows<HD>(sv, v + kv_base + (size_t)k0 * kv_row, kv_row, M::kRows,
                   n - k0, tid, M::kThreads);
  }
  // one query tile of one head of the group into stage st
  auto stage = [&](int t, int st) {
    const int head = h * group + t / n_qt;
    const int qs = q_begin + (t % n_qt) * M::kStep;
    const size_t base = ((size_t)b * seqlen + qs) * q_row +
                        (size_t)head * HD;
    stage_rows<HD>(sq + st * M::kStep * kST, q + base, q_row, M::kStep,
                   n - qs, tid, M::kThreads);
    stage_rows<HD>(sdo + st * M::kStep * kST, dout + base, q_row, M::kStep,
                   n - qs, tid, M::kThreads);
    if (tid < M::kStep) {
      const size_t row = ((size_t)b * q_heads + head) * seqlen + qs + tid;
      if (qs + tid < n) {
        ptx::cp_async_4(sl + st * M::kStep + tid, lse + row);
        ptx::cp_async_4(sd + st * M::kStep + tid, delta + row);
      } else {
        sl[st * M::kStep + tid] = 0.f;
        sd[st * M::kStep + tid] = 0.f;
      }
    }
  };
  const float scale_log2 = scale * kLog2e;
  if (n_steps > 0) stage(0, 0);
  ptx::cp_async_commit();
  for (int t = 0; t < n_steps; ++t) {
    if (t + 1 < n_steps) {
      stage(t + 1, (t + 1) & 1);
      ptx::cp_async_commit();
      ptx::cp_async_wait<1>();
    } else {
      ptx::cp_async_wait<0>();
    }
    __syncthreads();
    const int st = t & 1;
    const int qs = q_begin + (t % n_qt) * M::kStep;
    const bf16* tq = sq + st * M::kStep * kST;
    const bf16* tdo = sdo + st * M::kStep * kST;
    const float* tl = sl + st * M::kStep;
    const float* td = sd + st * M::kStep;

    // S^T = K Q^T and dP^T = V dO^T: this warp's 16 keys x 32 queries
    float s[M::kStep / 8][4], dp[M::kStep / 8][4];
    mma_rows<HD>(s, sk + 16 * mt * kST, tq, lane);
    mma_rows<HD>(dp, sv + 16 * mt * kST, tdo, lane);
#pragma unroll
    for (int nb = 0; nb < M::kStep / 8; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = k0 + 16 * mt + lane / 4 + 8 * (e / 2);
        const int qc = 8 * nb + 2 * (lane % 4) + e % 2;
        const int qi = qs + qc;
        const bool vis = qi < n && key < n && (!causal || key <= qi);
        const float p =
            vis ? exp2f(fmaf(s[nb][e], scale_log2, -tl[qc] * kLog2e)) : 0.f;
        s[nb][e] = p;
        dp[nb][e] = p * (dp[nb][e] - td[qc]);
      }
    // dV += P^T dO, dK += dS^T Q (the scale applied at the end)
    mma_acc<HD>(acc_v, s, tdo, c0, lane);
    mma_acc<HD>(acc_k, dp, tq, c0, lane);
    __syncthreads();   // this stage is consumed
  }
  const int keys_end = min(seqlen, k0 + M::kRows);
  bf16* dk_base = dk + kv_base + (size_t)k0 * kv_row;
  bf16* dv_base = dv + kv_base + (size_t)k0 * kv_row;
  store_rows<HD>(dk_base, kv_row, acc_k, scale, 16 * mt, keys_end - k0, c0,
                 lane);
  store_rows<HD>(dv_base, kv_row, acc_v, 1.f, 16 * mt, keys_end - k0, c0,
                 lane);
}

// dQ of 64 query rows of one (query head, batch): four m16 row tiles,
// each warp one (and at head_dim 256 one half of its columns); 32-key
// K/V tiles streamed through two stages up to the rows' horizon.
template <int HD>
__global__ void __launch_bounds__(Mma<HD>::kThreads) dq_mma_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, const bf16* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    bf16* __restrict__ dq, int seqlen, int q_heads, int kv_heads,
    int true_len, int causal, float scale) {
  using M = Mma<HD>;
  constexpr int kST = M::kST;
  extern __shared__ uint4 smem4[];
  bf16* sq = reinterpret_cast<bf16*>(smem4);
  bf16* sdo = sq + M::kRows * kST;
  bf16* sk = sdo + M::kRows * kST;                // [stage][kStep][kST]
  bf16* sv = sk + 2 * M::kStep * kST;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int head = blockIdx.y, b = blockIdx.z;
  const int group = q_heads / kv_heads;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * M::kRows;  // longest first
  const int n = true_len;
  const int mt = warp / M::kWPK, c0 = (warp % M::kWPK) * M::kNCol;
  const size_t kv_row = (size_t)kv_heads * HD;
  const size_t q_row = (size_t)q_heads * HD;
  const size_t kv_base =
      ((size_t)b * seqlen * kv_heads + head / group) * HD;
  const size_t q_base = ((size_t)b * seqlen + q0) * q_row + (size_t)head * HD;

  float acc[M::kNCol / 8][4];
#pragma unroll
  for (int nn = 0; nn < M::kNCol / 8; ++nn)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nn][e] = 0.f;

  const int kv_end = q0 >= n ? 0 : (causal ? min(q0 + M::kRows, n) : n);
  const int n_steps = (kv_end + M::kStep - 1) / M::kStep;
  // this thread's two rows: LSE in log2 units, and D
  float l2[2], dd[2];
  int row[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    row[i] = q0 + 16 * mt + lane / 4 + 8 * i;
    const bool ok = row[i] < n;
    const size_t at = ((size_t)b * q_heads + head) * seqlen + row[i];
    l2[i] = ok ? lse[at] * kLog2e : 0.f;
    dd[i] = ok ? delta[at] : 0.f;
  }
  if (n_steps > 0) {
    stage_rows<HD>(sq, q + q_base, q_row, M::kRows, n - q0, tid,
                   M::kThreads);
    stage_rows<HD>(sdo, dout + q_base, q_row, M::kRows, n - q0, tid,
                   M::kThreads);
  }
  auto stage = [&](int t, int st) {
    const int ks = t * M::kStep;
    const size_t base = kv_base + (size_t)ks * kv_row;
    stage_rows<HD>(sk + st * M::kStep * kST, k + base, kv_row, M::kStep,
                   n - ks, tid, M::kThreads);
    stage_rows<HD>(sv + st * M::kStep * kST, v + base, kv_row, M::kStep,
                   n - ks, tid, M::kThreads);
  };
  const float scale_log2 = scale * kLog2e;
  if (n_steps > 0) stage(0, 0);
  ptx::cp_async_commit();
  for (int t = 0; t < n_steps; ++t) {
    if (t + 1 < n_steps) {
      stage(t + 1, (t + 1) & 1);
      ptx::cp_async_commit();
      ptx::cp_async_wait<1>();
    } else {
      ptx::cp_async_wait<0>();
    }
    __syncthreads();
    const int st = t & 1;
    const int ks = t * M::kStep;
    const bf16* tk = sk + st * M::kStep * kST;
    const bf16* tv = sv + st * M::kStep * kST;

    // S = Q K^T and dP = dO V^T: this warp's 16 rows x 32 keys
    float s[M::kStep / 8][4], dp[M::kStep / 8][4];
    mma_rows<HD>(s, sq + 16 * mt * kST, tk, lane);
    mma_rows<HD>(dp, sdo + 16 * mt * kST, tv, lane);
#pragma unroll
    for (int nb = 0; nb < M::kStep / 8; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e / 2;
        const int key = ks + 8 * nb + 2 * (lane % 4) + e % 2;
        const bool vis = row[i] < n && key < n && (!causal || key <= row[i]);
        const float p =
            vis ? exp2f(fmaf(s[nb][e], scale_log2, -l2[i])) : 0.f;
        dp[nb][e] = p * (dp[nb][e] - dd[i]);
      }
    // dQ += dS K (the scale applied at the end)
    mma_acc<HD>(acc, dp, tk, c0, lane);
    __syncthreads();   // this stage is consumed
  }
  store_rows<HD>(dq + q_base, q_row, acc, scale, 16 * mt,
                 min(seqlen, q0 + M::kRows) - q0, c0, lane);
}

// ------------------------------------------------------- fp32 (CUDA cores)

// 256 threads as 16 x 16 (ty, tx); tiles of 32 rows and 32 keys; rows of
// HD fp32 padded by 4 words in shared memory.
template <int HD>
struct F32 {
  static constexpr int kThreads = 256;
  static constexpr int kTile = 32;
  static constexpr int kST = HD + 4;
  static constexpr int kPS = kTile + 1;       // P / dS tile rows
  static constexpr int kCols = HD / 16;       // accumulated columns a thread
  static constexpr int kColVec = kCols < 4 ? kCols : 4;
  // four row tiles, two [32][33] tiles, LSE and D
  static constexpr int bytes =
      (4 * kTile * kST + 2 * kTile * kPS + 2 * kTile) * 4;
};

// Loads `rows` rows of HD fp32 (row r at src + r * stride) into shared
// memory (rows kST apart); rows at or past `valid` are zeros.
template <int HD>
__device__ __forceinline__ void load_rows_f32(float* dst, const float* src,
                                              size_t stride, int valid,
                                              int tid) {
  constexpr int kVecs = HD / 4;
  for (int i = tid; i < F32<HD>::kTile * kVecs; i += F32<HD>::kThreads) {
    const int r = i / kVecs, c = (i % kVecs) * 4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r < valid) x = *reinterpret_cast<const float4*>(src + r * stride + c);
    *reinterpret_cast<float4*>(dst + r * F32<HD>::kST + c) = x;
  }
}

// s[i][j] = a_row(ty + 16 i) . b_row(tx + 16 j) over HD, for i, j < 2.
template <int HD>
__device__ __forceinline__ void dots_f32(float (&s)[2][2], const float* a,
                                         const float* b, int ty, int tx) {
  constexpr int kST = F32<HD>::kST;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) s[i][j] = 0.f;
#pragma unroll 4
  for (int c = 0; c < HD; c += 4) {
    float4 af[2], bf[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      af[i] = *reinterpret_cast<const float4*>(a + (ty + 16 * i) * kST + c);
      bf[i] = *reinterpret_cast<const float4*>(b + (tx + 16 * i) * kST + c);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        float x = s[i][j];
        x = fmaf(af[i].x, bf[j].x, x);
        x = fmaf(af[i].y, bf[j].y, x);
        x = fmaf(af[i].z, bf[j].z, x);
        x = fmaf(af[i].w, bf[j].w, x);
        s[i][j] = x;
      }
  }
}

// acc[i][c] += sum_j w[ty + 16 i][j] b[j][col(c)] over the 32 rows of b;
// column col(c) = u * 16 * kColVec + tx * kColVec + e for c = u kColVec + e.
template <int HD>
__device__ __forceinline__ void accum_f32(float (&acc)[2][F32<HD>::kCols],
                                          const float* w, const float* b,
                                          int ty, int tx) {
  using F = F32<HD>;
  for (int j = 0; j < F::kTile; ++j) {
    const float w0 = w[ty * F::kPS + j], w1 = w[(ty + 16) * F::kPS + j];
#pragma unroll
    for (int u = 0; u < F::kCols / F::kColVec; ++u)
#pragma unroll
      for (int e = 0; e < F::kColVec; ++e) {
        const float x =
            b[j * F::kST + u * 16 * F::kColVec + tx * F::kColVec + e];
        acc[0][u * F::kColVec + e] = fmaf(w0, x, acc[0][u * F::kColVec + e]);
        acc[1][u * F::kColVec + e] = fmaf(w1, x, acc[1][u * F::kColVec + e]);
      }
  }
}

template <int HD>
__device__ __forceinline__ void store_f32(float* dst, size_t stride,
                                          const float (&acc)[2][F32<HD>::kCols],
                                          float mul, int rows_end, int ty,
                                          int tx) {
  using F = F32<HD>;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = ty + 16 * i;
    if (r >= rows_end) continue;
#pragma unroll
    for (int u = 0; u < F::kCols / F::kColVec; ++u)
#pragma unroll
      for (int e = 0; e < F::kColVec; ++e)
        dst[r * stride + u * 16 * F::kColVec + tx * F::kColVec + e] =
            acc[i][u * F::kColVec + e] * mul;
  }
}

// dK and dV of 32 keys of one (KV head, batch) over the group's heads and
// the 32-row query tiles that see them.
template <int HD>
__global__ void __launch_bounds__(256) dkdv_f32_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const float* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    float* __restrict__ dk, float* __restrict__ dv, int seqlen, int q_heads,
    int kv_heads, int true_len, int causal, float scale) {
  using F = F32<HD>;
  extern __shared__ uint4 smem4[];
  float* sk = reinterpret_cast<float*>(smem4);
  float* sv = sk + F::kTile * F::kST;
  float* sq = sv + F::kTile * F::kST;
  float* sdo = sq + F::kTile * F::kST;
  float* sp = sdo + F::kTile * F::kST;     // P^T [key][query]
  float* sds = sp + F::kTile * F::kPS;     // dS^T
  float* sl = sds + F::kTile * F::kPS;
  float* sd = sl + F::kTile;

  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int h = blockIdx.y, b = blockIdx.z;
  const int group = q_heads / kv_heads;
  const int k0 = blockIdx.x * F::kTile;
  const int n = true_len;
  const size_t kv_row = (size_t)kv_heads * HD;
  const size_t q_row = (size_t)q_heads * HD;
  const size_t kv_base = ((size_t)b * seqlen * kv_heads + h) * HD +
                         (size_t)k0 * kv_row;

  float acc_k[2][F::kCols], acc_v[2][F::kCols];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int c = 0; c < F::kCols; ++c) acc_k[i][c] = acc_v[i][c] = 0.f;

  const int q_begin = causal ? k0 : 0;
  const int n_qt = k0 < n ? (n - q_begin + F::kTile - 1) / F::kTile : 0;
  if (n_qt > 0) {
    load_rows_f32<HD>(sk, k + kv_base, kv_row, n - k0, tid);
    load_rows_f32<HD>(sv, v + kv_base, kv_row, n - k0, tid);
  }
  for (int t = 0; t < group * n_qt; ++t) {
    const int head = h * group + t / n_qt;
    const int qs = q_begin + (t % n_qt) * F::kTile;
    const size_t base = ((size_t)b * seqlen + qs) * q_row + (size_t)head * HD;
    load_rows_f32<HD>(sq, q + base, q_row, n - qs, tid);
    load_rows_f32<HD>(sdo, dout + base, q_row, n - qs, tid);
    if (tid < F::kTile) {
      const size_t row = ((size_t)b * q_heads + head) * seqlen + qs + tid;
      sl[tid] = qs + tid < n ? lse[row] : 0.f;
      sd[tid] = qs + tid < n ? delta[row] : 0.f;
    }
    __syncthreads();
    float s[2][2], dp[2][2];
    dots_f32<HD>(s, sk, sq, ty, tx);     // rows: keys, columns: queries
    dots_f32<HD>(dp, sv, sdo, ty, tx);
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int kr = ty + 16 * i, qc = tx + 16 * j;
        const int key = k0 + kr, qi = qs + qc;
        const bool vis = qi < n && key < n && (!causal || key <= qi);
        const float p = vis ? expf(s[i][j] * scale - sl[qc]) : 0.f;
        sp[kr * F::kPS + qc] = p;
        sds[kr * F::kPS + qc] = p * (dp[i][j] - sd[qc]);
      }
    __syncthreads();
    accum_f32<HD>(acc_v, sp, sdo, ty, tx);
    accum_f32<HD>(acc_k, sds, sq, ty, tx);
    __syncthreads();   // the tiles are consumed
  }
  const int rows_end = min(seqlen - k0, F::kTile);
  store_f32<HD>(dk + kv_base, kv_row, acc_k, scale, rows_end, ty, tx);
  store_f32<HD>(dv + kv_base, kv_row, acc_v, 1.f, rows_end, ty, tx);
}

// dQ of 32 query rows of one (query head, batch) over the 32-key tiles
// its rows see.
template <int HD>
__global__ void __launch_bounds__(256) dq_f32_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const float* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    float* __restrict__ dq, int seqlen, int q_heads, int kv_heads,
    int true_len, int causal, float scale) {
  using F = F32<HD>;
  extern __shared__ uint4 smem4[];
  float* sq = reinterpret_cast<float*>(smem4);
  float* sdo = sq + F::kTile * F::kST;
  float* sk = sdo + F::kTile * F::kST;
  float* sv = sk + F::kTile * F::kST;
  float* sds = sv + F::kTile * F::kST;     // dS [query][key]
  float* sl = sds + 2 * F::kTile * F::kPS;
  float* sd = sl + F::kTile;

  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int head = blockIdx.y, b = blockIdx.z;
  const int group = q_heads / kv_heads;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * F::kTile;  // longest first
  const int n = true_len;
  const size_t kv_row = (size_t)kv_heads * HD;
  const size_t q_row = (size_t)q_heads * HD;
  const size_t kv_base = ((size_t)b * seqlen * kv_heads + head / group) * HD;
  const size_t q_base = ((size_t)b * seqlen + q0) * q_row + (size_t)head * HD;

  float acc[2][F::kCols];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int c = 0; c < F::kCols; ++c) acc[i][c] = 0.f;

  const int kv_end = q0 >= n ? 0 : (causal ? min(q0 + F::kTile, n) : n);
  if (kv_end > 0) {
    load_rows_f32<HD>(sq, q + q_base, q_row, n - q0, tid);
    load_rows_f32<HD>(sdo, dout + q_base, q_row, n - q0, tid);
    if (tid < F::kTile) {
      const size_t row = ((size_t)b * q_heads + head) * seqlen + q0 + tid;
      sl[tid] = q0 + tid < n ? lse[row] : 0.f;
      sd[tid] = q0 + tid < n ? delta[row] : 0.f;
    }
  }
  for (int ks = 0; ks < kv_end; ks += F::kTile) {
    load_rows_f32<HD>(sk, k + kv_base + (size_t)ks * kv_row, kv_row, n - ks,
                      tid);
    load_rows_f32<HD>(sv, v + kv_base + (size_t)ks * kv_row, kv_row, n - ks,
                      tid);
    __syncthreads();
    float s[2][2], dp[2][2];
    dots_f32<HD>(s, sq, sk, ty, tx);     // rows: queries, columns: keys
    dots_f32<HD>(dp, sdo, sv, ty, tx);
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int qr = ty + 16 * i, kc = tx + 16 * j;
        const int qi = q0 + qr, key = ks + kc;
        const bool vis = qi < n && key < n && (!causal || key <= qi);
        const float p = vis ? expf(s[i][j] * scale - sl[qr]) : 0.f;
        sds[qr * F::kPS + kc] = p * (dp[i][j] - sd[qr]);
      }
    __syncthreads();
    accum_f32<HD>(acc, sds, sk, ty, tx);
    __syncthreads();   // the tiles are consumed
  }
  store_f32<HD>(dq + q_base, q_row, acc, scale,
                min(seqlen - q0, F::kTile), ty, tx);
}

// ------------------------------------------------------------------ host

template <typename Kernel>
int opt_in(Kernel kernel, int smem, bool& done) {
  if (done) return 0;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  done = true;
  return 0;
}

template <int HD>
int launch_bf16(const bf16* q, const bf16* k, const bf16* v,
                const bf16* dout, const float* lse, const float* delta,
                bf16* dq, bf16* dk, bf16* dv, int batch, int seqlen,
                int q_heads, int kv_heads, int true_len, int causal,
                float scale, cudaStream_t stream) {
  using M = Mma<HD>;
  static_assert(M::bytes <= kMaxSmem, "K5 backward tiles exceed shared "
                "memory");
  static bool dkdv_in = false, dq_in = false;   // once per instantiation
  int err = opt_in(dkdv_mma_kernel<HD>, M::bytes, dkdv_in);
  if (err == 0) err = opt_in(dq_mma_kernel<HD>, M::bytes, dq_in);
  if (err != 0) return err;
  const int tiles = (seqlen + M::kRows - 1) / M::kRows;
  dkdv_mma_kernel<HD><<<dim3(tiles, kv_heads, batch), M::kThreads, M::bytes,
                        stream>>>(q, k, v, dout, lse, delta, dk, dv, seqlen,
                                  q_heads, kv_heads, true_len, causal,
                                  scale);
  err = (int)cudaGetLastError();
  if (err != 0) return err;
  dq_mma_kernel<HD><<<dim3(tiles, q_heads, batch), M::kThreads, M::bytes,
                      stream>>>(q, k, v, dout, lse, delta, dq, seqlen,
                                q_heads, kv_heads, true_len, causal, scale);
  return (int)cudaGetLastError();
}

template <int HD>
int launch_f32(const float* q, const float* k, const float* v,
               const float* dout, const float* lse, const float* delta,
               float* dq, float* dk, float* dv, int batch, int seqlen,
               int q_heads, int kv_heads, int true_len, int causal,
               float scale, cudaStream_t stream) {
  using F = F32<HD>;
  static_assert(F::bytes <= kMaxSmem, "K5 backward tiles exceed shared "
                "memory");
  static bool dkdv_in = false, dq_in = false;   // once per instantiation
  int err = opt_in(dkdv_f32_kernel<HD>, F::bytes, dkdv_in);
  if (err == 0) err = opt_in(dq_f32_kernel<HD>, F::bytes, dq_in);
  if (err != 0) return err;
  const int tiles = (seqlen + F::kTile - 1) / F::kTile;
  dkdv_f32_kernel<HD><<<dim3(tiles, kv_heads, batch), F::kThreads, F::bytes,
                        stream>>>(q, k, v, dout, lse, delta, dk, dv, seqlen,
                                  q_heads, kv_heads, true_len, causal,
                                  scale);
  err = (int)cudaGetLastError();
  if (err != 0) return err;
  dq_f32_kernel<HD><<<dim3(tiles, q_heads, batch), F::kThreads, F::bytes,
                      stream>>>(q, k, v, dout, lse, delta, dq, seqlen,
                                q_heads, kv_heads, true_len, causal, scale);
  return (int)cudaGetLastError();
}

template <int HD>
int launch_hd(int dtype, const void* q, const void* k, const void* v,
              const void* dout, const float* lse, const float* delta,
              void* dq, void* dk, void* dv, int batch, int seqlen,
              int q_heads, int kv_heads, int true_len, int causal,
              float scale, cudaStream_t s) {
  if (dtype == 1)
    return launch_bf16<HD>((const bf16*)q, (const bf16*)k, (const bf16*)v,
                           (const bf16*)dout, lse, delta, (bf16*)dq,
                           (bf16*)dk, (bf16*)dv, batch, seqlen, q_heads,
                           kv_heads, true_len, causal, scale, s);
  return launch_f32<HD>((const float*)q, (const float*)k, (const float*)v,
                        (const float*)dout, lse, delta, (float*)dq,
                        (float*)dk, (float*)dv, batch, seqlen, q_heads,
                        kv_heads, true_len, causal, scale, s);
}

}  // namespace

// Returns the cudaError_t of the first launch that failed (0 on success).
// dtype 0 = fp32, 1 = bf16 for q, k, v, out, dout, dq, dk and dv; q, out,
// dout and dq [batch, seqlen, q_heads, head_dim], k, v, dk and dv [batch,
// seqlen, kv_heads, head_dim], contiguous and 16-byte aligned; lse (the
// forward's, natural log) and delta (scratch, written here) fp32 [batch,
// q_heads, seqlen]; 0 < true_len <= seqlen. Every element of dq, dk and dv
// is written. The caller has checked shapes, dtypes and alignment.
extern "C" int flash_prefill_bwd_launch(
    int dtype, int head_dim, const void* q, const void* k, const void* v,
    const void* out, const void* dout, const float* lse, float* delta,
    void* dq, void* dk, void* dv, int batch, int seqlen, int q_heads,
    int kv_heads, int true_len, int causal, float scale, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (kv_heads < 1 || q_heads % kv_heads || true_len < 1 ||
      true_len > seqlen || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  const long rows = (long)batch * seqlen * q_heads;
  const unsigned blocks = (unsigned)((rows + 7) / 8);
  if (dtype == 1)
    bwd_dot_kernel<bf16><<<blocks, 256, 0, s>>>(
        (const bf16*)out, (const bf16*)dout, delta, batch, seqlen, q_heads,
        head_dim, true_len);
  else
    bwd_dot_kernel<float><<<blocks, 256, 0, s>>>(
        (const float*)out, (const float*)dout, delta, batch, seqlen,
        q_heads, head_dim, true_len);
  const int err = (int)cudaGetLastError();
  if (err != 0) return err;
  switch (head_dim) {
    case 256:
      return launch_hd<256>(dtype, q, k, v, dout, lse, delta, dq, dk, dv,
                            batch, seqlen, q_heads, kv_heads, true_len,
                            causal, scale, s);
    case 128:
      return launch_hd<128>(dtype, q, k, v, dout, lse, delta, dq, dk, dv,
                            batch, seqlen, q_heads, kv_heads, true_len,
                            causal, scale, s);
    case 64:
      return launch_hd<64>(dtype, q, k, v, dout, lse, delta, dq, dk, dv,
                           batch, seqlen, q_heads, kv_heads, true_len,
                           causal, scale, s);
    case 32:
      return launch_hd<32>(dtype, q, k, v, dout, lse, delta, dq, dk, dv,
                           batch, seqlen, q_heads, kv_heads, true_len,
                           causal, scale, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
