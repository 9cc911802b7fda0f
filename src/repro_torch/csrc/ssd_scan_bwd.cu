// The gradient of the Mamba-2 SSD chunked scan (kernel K4) for Hopper
// (sm_90a): dX, dB, dC, d dt, da and d(initial state) of csrc/ssd_scan.cu
// from the output's gradient dY and the final state's gradient dS_fin,
// given the fp32 state before each chunk that the forward wrote.
//
// What it replaces: the JAX package has no Pallas backward. Its training
// path takes XLA's autodiff of the chunked scan (ssd_chunked,
// repro/models/mamba2.py:42), the function its Pallas kernel
// (repro/kernels/ssd_scan/ssd_scan.py:117) computes. Per (batch row,
// head) and chunk of qn rows, with cs the cumulative sum of dt·a inside
// the chunk, L[i,j] = exp(cs_i - cs_j) for j <= i, G = (C Bᵀ) ∘ L ∘ dt,
// W = (dY Xᵀ) ∘ L ∘ dt (both zero above the diagonal), w_j = dt_j
// exp(cs_last - cs_j), S_prev the state before the chunk and dS_end the
// gradient reaching the state at its end:
//   dS_prev = exp(cs_last) dS_end + Σ_i exp(cs_i) dy_i C_iᵀ
//   dX      = Gᵀ dY + w ∘ (B dS_endᵀ)
//   dC      = W B + exp(cs) ∘ (dY S_prev)
//   dB      = Wᵀ C + w ∘ (X dS_end)
// and on cs, with E = W ∘ (C Bᵀ) (= dG ∘ G):
//   dcs_i  = Σ_j E_ij - Σ_k E_ki + exp(cs_i) dy_i·(S_prev C_i)
//            - w_i r_i,   r_i = x_iᵀ dS_end B_i,
//   dcs_last += Σ_j w_j r_j + exp(cs_last) <dS_end, S_prev>,
// whose reverse cumulative sum is d(dt·a): d dt_j = Σ_i (dY Xᵀ ∘ C Bᵀ ∘
// L)_ij + exp(cs_last - cs_j) r_j + a d(dt·a)_j and da = Σ dt d(dt·a).
// Only differences cs_i - cs_j with i >= j and cs_last - cs_j are
// exponentiated, so nothing overflows however large dt is, and the
// gradient on cs is taken as row sums minus column sums of E in fp32.
// Masked positions arrive with dt = 0; the partial last chunk's missing
// rows count as zeros, as in the forward.
//
// The kernels, launched in order on one stream by one call. bf16 (three
// launches):
//   (a+b) dstate_chain: per (32 columns of P, head, row), the chunks from
//       the last to the first: each chunk's state gradient U = Σ_i
//       exp(cs_i) dy_i C_iᵀ [32, N] on mma.sync, the reverse recurrence
//       carried in registers (dS_end of a chunk is the carry as it
//       arrives; carry = exp(cs_last) carry + U), each chunk's dS_end
//       written once to the workspace; d(initial state) is what reaches
//       chunk 0. The next chunk's dY slice and C land (16-byte cp.async)
//       while this one computes;
//   (c) chunk_grad: per (chunk, head, row), every other gradient of the
//       chunk from its inputs, S_prev and dS_end. One CTA owns all of P
//       and N, so the sums over P (dB, dC, d dt) stay inside it;
//   (d) da_reduce: da per head over (row, chunk) partials in a fixed order.
// fp32 (four launches, the CUDA-core route): (a) dstate per (chunk, head,
// row) into the workspace, (b) state_pass, the reverse recurrence
// elementwise over [P, N] and parallel over (row, head), then (c) and (d).
// No atomics: every sum is taken in a fixed order, and the gradients are
// the same bits from run to run.
//
// bf16: the products run on tensor cores (mma.sync m16n8k16, fp32
// accumulators). C Bᵀ and dY Xᵀ take the stored bf16 inputs as they are;
// G, W, exp(cs) ∘ dY, S_prev and dS_end are rounded to bf16 where they
// become operands, as K5's backward rounds P and dS. E and the other
// scalar sums are taken in fp32 from the fp32 accumulators. fp32 runs
// every product in fp32 FMAs on the CUDA cores, its [Q, Q] matrices (C Bᵀ,
// dY Xᵀ, L) in shared memory and its operands read from device memory.
//
// What bounds it on this card: bytes. At mamba2-130m's training shape
// (B=2, S=2048, 24 heads of P=64, N=128, chunk 128) it reads x, b, c, dY
// and the fp32 chunk states and writes dx, db and dc: ~165 MB, 0.05 ms at
// 3.35 TB/s, against ~13 GFLOP of products (0.013 ms at the bf16 peak).
// The kernels also write and read back the fp32 dS_end workspace (25 MB
// each way). The design against latency, at that shape:
//   * (c) stages the whole chunk in shared memory (~218 KB: one CTA of
//     sixteen warps per SM, 768 CTAs) with every copy in flight at once:
//     16-byte cp.async for C and B (group 0) and X and dY (group 1), then
//     the fp32 states with 16-byte loads, rounded to bf16 while the copies
//     land. The C Bᵀ tiles run as soon as group 0 is in, while X and dY
//     still land; dC and dB run in 16 x 64 output tiles whose A fragment
//     serves four B fragments and leave as 16-byte stores (a transpose
//     across each quad of lanes), dX as 4-byte pairs. Sixteen warps a CTA.
//   * (a+b) replaces a per-chunk pass and a serial pass over the fp32
//     workspace (PR 23: 0.075 and 0.139 ms, a chain of 16 dependent
//     loads per thread) by one walk per 32 columns of P, 96 CTAs.
// Chunk widths of 16-byte copies need P and N multiples of 8 and aligned
// operands; other shapes stage element by element in the same kernels.
#include "ssd_common.cuh"

namespace {

using namespace ssd;
constexpr int kThreads = 256;       // eight warps
// the bf16 chunk-gradient kernel's threads: sixteen warps hide more of
// its mma.sync and ldmatrix latency than eight (one CTA per SM either way)
constexpr int kGradThreads = 512;

struct BwdArgs {
  const void* x;            // [batch, seqlen, heads, p_dim]
  const float* dt;          // [batch, seqlen, heads]
  const float* a;           // [heads]
  const void* b;            // [batch, seqlen, heads, n_dim]
  const void* c;
  const float* states;      // [batch, n_chunks, heads, p_dim, n_dim]
  const void* dy;           // [batch, seqlen, heads, p_dim]
  float* ds;                // workspace like states: U, then dS_end
  float* cs_last;           // [batch, heads, n_chunks]
  float* da_part;           // [batch, heads, n_chunks]
  void* dx;
  void* db;
  void* dc;
  float* ddt;               // [batch, seqlen, heads]
  int seqlen, heads, p_dim, n_dim, chunk, n_chunks;
  // bf16 rows may be copied 16 bytes at a time and dB, dC stored so: P
  // and N multiples of 8, every operand 16-byte aligned
  int vec;
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) v += __shfl_xor_sync(kFull, v, d);
  return v;   // the same bits in every lane (each pair adds commutatively)
}

// Warp 0 of a chunk's CTA: the gradient on cs from the per-row sums, its
// reverse cumulative sum d(dt·a), then d dt for the chunk's qn rows (into
// ddt, a stride of `heads` apart) and the chunk's share of da. rowE: Σ_j
// E_ij; colF: Σ_k (dY Xᵀ ∘ C Bᵀ ∘ L)_ki, so Σ_k E_ki = dt_i colF_i; offv:
// exp(cs_i) dy_i·(S_prev C_i); rv: r_i; dot: <dS_end, S_prev>.
__device__ void chunk_scalars(const float* dts, const float* cum,
                              const float* wts, const float* rowE,
                              const float* colF, const float* offv,
                              const float* rv, int qn, float a_h, float dot,
                              float* ddt, int heads, float* da_part,
                              int lane) {
  const float cs_last = cum[qn - 1];
  float v[4], wr = 0.f;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int i = 4 * lane + e;
    v[e] = 0.f;
    if (i < qn) {
      v[e] = rowE[i] - dts[i] * colF[i] + offv[i] - wts[i] * rv[i];
      wr += wts[i] * rv[i];
    }
  }
  wr = warp_sum(wr);
#pragma unroll
  for (int e = 0; e < 4; ++e)
    if (4 * lane + e == qn - 1) v[e] += wr + expf(cs_last) * dot;
  // reverse inclusive scan: suffix sums inside the lane, then over lanes
  float suf[4], run = 0.f;
#pragma unroll
  for (int e = 3; e >= 0; --e) {
    run += v[e];
    suf[e] = run;
  }
  float incl = run;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const float down = __shfl_down_sync(kFull, incl, d);
    if (lane + d < 32) incl += down;
  }
  float excl = __shfl_down_sync(kFull, incl, 1);
  if (lane == 31) excl = 0.f;
  float dap = 0.f;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int j = 4 * lane + e;
    if (j < qn) {
      const float dda = excl + suf[e];
      ddt[(size_t)j * heads] =
          colF[j] + expf(cs_last - cum[j]) * rv[j] + a_h * dda;
      dap += dts[j] * dda;
    }
  }
  dap = warp_sum(dap);
  if (lane == 0) *da_part = dap;
}

// NT 16 x 16 tile products D += A B on mma.sync sharing one A fragment
// (a 16 x 16 NT output tile), A and B bf16 in shared memory (row strides
// in elements). ATrans: A is stored [k][m], else [m][k]. BKN: B is stored
// [k][n], else [n][k]. The accumulator's element e of n-block nb is row
// lane / 4 + 8 (e / 2), column 8 nb + 2 (lane % 4) + e % 2.
template <bool ATrans, bool BKN, int NT = 1>
__device__ __forceinline__ void mma_tile(float (&acc)[2 * NT][4],
                                         const bf16* a, int sa, int m0,
                                         int k0, const bf16* b, int sb,
                                         int n0, int lane) {
  uint32_t af[4];
  if (ATrans)
    ptx::ldmatrix_x4_trans(af, a + (k0 + 8 * (lane / 16) + lane % 8) * sa +
                                   m0 + 8 * ((lane / 8) % 2));
  else
    ptx::ldmatrix_x4(af, a + (m0 + lane % 8 + 8 * ((lane / 8) % 2)) * sa +
                             k0 + 8 * (lane / 16));
#pragma unroll
  for (int t = 0; t < NT; ++t) {
    uint32_t bf[4];
    const int n = n0 + 16 * t;
    if (BKN)
      ptx::ldmatrix_x4_trans(bf, b + (k0 + lane % 8 + 8 * ((lane / 8) % 2)) *
                                         sb +
                                     n + 8 * (lane / 16));
    else
      ptx::ldmatrix_x4(bf, b + (n + 8 * (lane / 16) + lane % 8) * sb + k0 +
                               8 * ((lane / 8) % 2));
    ptx::mma_m16n8k16(acc[2 * t], af, bf[0], bf[1]);
    ptx::mma_m16n8k16(acc[2 * t + 1], af, bf[2], bf[3]);
  }
}

// Stores x at p[0] and y at p[1] (bf16): one 4-byte store where both are
// in range (second) and p is 4-byte aligned (even offset, `pair`), else
// what is in range.
__device__ __forceinline__ void store_pair(bf16* p, float x, float y,
                                           bool second, bool pair) {
  if (second && pair)
    *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x, y);
  else {
    *p = __float2bfloat16_rn(x);
    if (second) p[1] = __float2bfloat16_rn(y);
  }
}

// Copies rows [0, qcap) x columns [0, cols_pad) of a bf16 matrix into
// shared memory (rows ld elements apart), source row i at src + i *
// stride, zeros at rows >= rows and columns >= cols: 16-byte cp.async
// where `vec` (the caller waits for them), else element by element; by
// the CTA's Threads threads.
template <int Threads = kThreads>
__device__ __forceinline__ void stage_bf16(bf16* dst, int ld,
                                           const bf16* src, size_t stride,
                                           int rows, int cols, int qcap,
                                           int cols_pad, int vec, int tid) {
  const bf16 zero = __float2bfloat16_rn(0.f);
  const int cv = cols_pad / 8;   // 16-byte chunks a row
  for (int e = tid; e < qcap * cv; e += Threads) {
    const int i = e / cv, c = (e % cv) * 8;
    bf16* d = dst + i * ld + c;
    if (vec && i < rows && c < cols) {
      ptx::cp_async_16(d, src + i * stride + c);
    } else {
#pragma unroll
      for (int k = 0; k < 8; ++k)
        d[k] = i < rows && c + k < cols ? src[i * stride + c + k] : zero;
    }
  }
}

// The 4 x 4 transpose of 32-bit words across a quad (the four lanes with
// one lane / 4): lane q gives w_k, its word of chunk k, and gets v = the
// words of chunk q from lanes 0-3 in order. Two exchanges, at lane
// distance 1 and 2, each moving the words whose chunk and lane differ in
// that bit.
__device__ __forceinline__ void quad_transpose(uint4& v, uint32_t w0,
                                               uint32_t w1, uint32_t w2,
                                               uint32_t w3, int q) {
  uint32_t m[4] = {w0, w1, w2, w3};
#pragma unroll
  for (int d = 1; d <= 2; d <<= 1) {
    uint32_t a[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const uint32_t other = __shfl_xor_sync(kFull, m[k ^ d], d);
      a[k] = ((k ^ q) & d) ? other : m[k];
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) m[k] = a[k];
  }
  v = make_uint4(m[0], m[1], m[2], m[3]);
}

// A row's sum over the four lanes that hold it (lane % 4).
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(kFull, v, 1);
  return v + __shfl_xor_sync(kFull, v, 2);
}

// ------------------------------------------------- (a) dstate

constexpr int kSlice = 32;          // columns of P a chain CTA owns
constexpr int kSliceTiles = kSlice / 16;

// Shared memory of the bf16 chain (a+b): two stages of the chunk's dY
// slice [qcap][kSlice + 8] and C [qcap][np + 8] (bf16), two stages of dt
// [qcap], then cs and exp(cs) [qcap] (fp32).
__host__ __device__ inline size_t chain_smem(int qcap, int np) {
  return 2 * (size_t)qcap * ((kSlice + 8) + (np + 8)) * 2 +
         4 * (size_t)qcap * 4;
}

// A = (exp(cs) ∘ dY)ᵀ [16 p x 16 rows] of columns m0 .. m0 + 15 and rows
// k0 .. k0 + 15 as an mma.sync A fragment: dY stored [row][p] (rows ys
// apart), each element scaled by its row's exp(cs) and rounded to bf16
// once.
__device__ __forceinline__ void scaled_dy_frag(uint32_t (&af)[4],
                                               const bf16* y, int ys,
                                               const float* ecs, int m0,
                                               int k0, int lane) {
  ptx::ldmatrix_x4_trans(af, y + (k0 + 8 * (lane / 16) + lane % 8) * ys +
                                 m0 + 8 * ((lane / 8) % 2));
  // register x holds rows k0 + 2 (lane % 4) + {0, 1} (+ 8 for x >= 2)
  const float2 lo = *reinterpret_cast<const float2*>(ecs + k0 +
                                                     2 * (lane % 4));
  const float2 hi = *reinterpret_cast<const float2*>(ecs + k0 + 8 +
                                                     2 * (lane % 4));
#pragma unroll
  for (int x = 0; x < 4; ++x) {
    const float2 v = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&af[x]));
    const float2 e = x < 2 ? lo : hi;
    af[x] = ptx::pack_bf16(v.x * e.x, v.y * e.y);
  }
}

// (a+b) for bf16: per (kSlice columns of P, head, row), the chunks from
// the last to the first. The carry dS [kSlice, N] stays in the warps'
// fp32 accumulators (warp w owns N columns 16 w .. 16 w + 15): each
// chunk's dS_end is the carry as it arrives (written to the workspace),
// then carry = exp(cs_last) carry + U with U = Σ_i exp(cs_i) dy_i C_iᵀ on
// mma.sync. The next chunk's dY slice, C and dt land (cp.async) while
// this one computes. d(initial state) is the carry past chunk 0. C is
// read once per slice: wider slices read it fewer times, narrower ones
// give more CTAs.
template <int NP>
__global__ void __launch_bounds__(kThreads) dstate_chain_kernel(
    const BwdArgs g, const float* __restrict__ dfinal,
    float* __restrict__ dinit) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int p0 = blockIdx.x * kSlice, h = blockIdx.y, row = blockIdx.z;
  const int S = g.seqlen, H = g.heads, P = g.p_dim, N = g.n_dim;
  const int qcap = round16(imin(g.chunk, S));
  constexpr int KS = NP + 8, YS = kSlice + 8;
  bf16* ybuf = reinterpret_cast<bf16*>(smem);     // [2][qcap][YS]
  bf16* cbuf = ybuf + 2 * qcap * YS;              // [2][qcap][KS]
  float* dts = reinterpret_cast<float*>(cbuf + 2 * qcap * KS);  // [2][qcap]
  float* cum = dts + 2 * qcap;
  float* ecs = cum + qcap;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const bf16* dy = static_cast<const bf16*>(g.dy);
  const bf16* c = static_cast<const bf16*>(g.c);
  const int pcols = imin(kSlice, P - p0);
  const size_t hr = (size_t)row * H + h;
  const bool owner = warp < NP / 16;
  const int n0 = 16 * warp;
  // carry[mt][nb][e]: P row p0 + 16 mt + lane / 4 + 8 (e / 2), N column
  // n0 + 8 nb + 2 (lane % 4) + e % 2
  float carry[kSliceTiles][2][4];
#pragma unroll
  for (int mt = 0; mt < kSliceTiles; ++mt)
#pragma unroll
    for (int nb = 0; nb < 2; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int p = p0 + 16 * mt + lane / 4 + 8 * (e / 2);
        const int n = n0 + 8 * nb + 2 * (lane % 4) + e % 2;
        carry[mt][nb][e] = owner && dfinal && p < P && n < N
                               ? dfinal[(hr * P + p) * N + n]
                               : 0.f;
      }
  auto stage = [&](int z, int st) {
    const int c0 = z * g.chunk, qn = imin(g.chunk, S - c0);
    const size_t tok0 = (size_t)row * S + c0;
    stage_bf16(ybuf + st * qcap * YS, YS, dy + (tok0 * H + h) * P + p0,
               (size_t)H * P, qn, pcols, qcap, kSlice, g.vec, tid);
    stage_bf16(cbuf + st * qcap * KS, KS, c + (tok0 * H + h) * N,
               (size_t)H * N, qn, N, qcap, NP, g.vec, tid);
    for (int i = tid; i < qcap; i += kThreads) {
      if (i < qn)
        ptx::cp_async_4(dts + st * qcap + i, g.dt + (tok0 + i) * H + h);
      else
        dts[st * qcap + i] = 0.f;
    }
  };
  stage(g.n_chunks - 1, (g.n_chunks - 1) & 1);
  ptx::cp_async_commit();
  for (int z = g.n_chunks - 1; z >= 0; --z) {
    const int st = z & 1;
    if (z > 0) {
      stage(z - 1, st ^ 1);
      ptx::cp_async_commit();
      ptx::cp_async_wait<1>();
    } else {
      ptx::cp_async_wait<0>();
    }
    __syncthreads();
    const int qn = imin(g.chunk, S - z * g.chunk);
    if (warp == 0) {
      chunk_cumsum(dts + st * qcap, g.a[h], cum, qcap, lane);
      __syncwarp();
      for (int i = lane; i < qcap; i += 32) ecs[i] = expf(cum[i]);
    }
    __syncthreads();
    const float decay = expf(cum[qn - 1]);
    if (owner) {
      // U = (exp(cs) ∘ dY)ᵀ C over the chunk's rows in steps of 16, one B
      // fragment of C serving every m-tile of the slice
      const bf16* yt = ybuf + st * qcap * YS;
      const bf16* ct = cbuf + st * qcap * KS;
      float u[kSliceTiles][2][4] = {};
      for (int kb = 0; kb < qcap / 16; ++kb) {
        uint32_t bf[4];
        ptx::ldmatrix_x4_trans(bf, ct + (16 * kb + lane % 8 +
                                         8 * ((lane / 8) % 2)) * KS +
                                       n0 + 8 * (lane / 16));
#pragma unroll
        for (int mt = 0; mt < kSliceTiles; ++mt) {
          uint32_t af[4];
          scaled_dy_frag(af, yt, YS, ecs, 16 * mt, 16 * kb, lane);
          ptx::mma_m16n8k16(u[mt][0], af, bf[0], bf[1]);
          ptx::mma_m16n8k16(u[mt][1], af, bf[2], bf[3]);
        }
      }
      float* out = g.ds + ((row * (size_t)g.n_chunks + z) * H + h) * P * N;
#pragma unroll
      for (int mt = 0; mt < kSliceTiles; ++mt)
#pragma unroll
        for (int nb = 0; nb < 2; ++nb)
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const int p = p0 + 16 * mt + lane / 4 + 8 * r;
            const int n = n0 + 8 * nb + 2 * (lane % 4);
            float* o = out + (size_t)p * N + n;
            if (p < P && n + 1 < N)
              *reinterpret_cast<float2*>(o) = make_float2(
                  carry[mt][nb][2 * r], carry[mt][nb][2 * r + 1]);
            else if (p < P && n < N)
              *o = carry[mt][nb][2 * r];
#pragma unroll
            for (int e = 0; e < 2; ++e)
              carry[mt][nb][2 * r + e] =
                  decay * carry[mt][nb][2 * r + e] + u[mt][nb][2 * r + e];
          }
    }
    __syncthreads();   // this stage is consumed before it is refilled
  }
  if (dinit && owner) {
#pragma unroll
    for (int mt = 0; mt < kSliceTiles; ++mt)
#pragma unroll
      for (int nb = 0; nb < 2; ++nb)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int p = p0 + 16 * mt + lane / 4 + 8 * (e / 2);
          const int n = n0 + 8 * nb + 2 * (lane % 4) + e % 2;
          if (p < P && n < N)
            dinit[(hr * P + p) * N + n] = carry[mt][nb][e];
        }
  }
}

__global__ void __launch_bounds__(kThreads) dstate_f32_kernel(
    const BwdArgs g) {
  __shared__ float dts[kMaxDim], cum[kMaxDim], ecs[kMaxDim];
  const int z = blockIdx.x, h = blockIdx.y, row = blockIdx.z;
  const int S = g.seqlen, H = g.heads, P = g.p_dim, N = g.n_dim;
  const int c0 = z * g.chunk, qn = imin(g.chunk, S - c0);
  const int tid = threadIdx.x;
  const size_t tok0 = (size_t)row * S + c0;
  const float* dy = static_cast<const float*>(g.dy);
  const float* c = static_cast<const float*>(g.c);
  for (int i = tid; i < qn; i += kThreads) dts[i] = g.dt[(tok0 + i) * H + h];
  __syncthreads();
  if (tid < 32) {
    chunk_cumsum(dts, g.a[h], cum, qn, tid);
    __syncwarp();
    for (int i = tid; i < qn; i += 32) ecs[i] = expf(cum[i]);
    if (tid == 0)
      g.cs_last[((size_t)row * H + h) * g.n_chunks + z] = cum[qn - 1];
  }
  __syncthreads();
  float* out = g.ds + (((size_t)row * g.n_chunks + z) * H + h) * P * N;
  for (int e = tid; e < P * N; e += kThreads) {
    const int p = e / N, n = e % N;
    float acc = 0.f;
    for (int i = 0; i < qn; ++i)
      acc = fmaf(ecs[i] * dy[((tok0 + i) * H + h) * P + p],
                 c[((tok0 + i) * H + h) * N + n], acc);
    out[e] = acc;
  }
}

// ------------------------------------------------- (b) state pass

// carry = dS_fin; for each chunk from the last: U := carry (its dS_end),
// carry = exp(cs_last) carry + U. What reaches chunk 0 is d(initial).
__global__ void __launch_bounds__(kThreads) state_pass_kernel(
    float* ds, const float* cs_last, const float* dfinal, float* dinit,
    int n_chunks, int heads, int pn) {
  const int e = blockIdx.x * kThreads + threadIdx.x;
  const int h = blockIdx.y, row = blockIdx.z;
  if (e >= pn) return;
  const size_t hr = (size_t)row * heads + h;
  float carry = dfinal ? dfinal[hr * pn + e] : 0.f;
  for (int z = n_chunks - 1; z >= 0; --z) {
    float* p = ds + (((size_t)row * n_chunks + z) * heads + h) * pn + e;
    const float u = *p;
    *p = carry;
    carry = expf(cs_last[hr * n_chunks + z]) * carry + u;
  }
  if (dinit) dinit[hr * pn + e] = carry;
}

// ------------------------------------------------- (c) chunk grad, bf16

// Shared memory of the bf16 kernel (c), bytes: X and dY [qcap][pp+8], B
// and C [qcap][np+8], S_prev and dS_end [pp][np+8], G and W [qcap][qcap+8]
// (bf16, rows padded by 16 bytes so that ldmatrix's eight rows hit eight
// bank groups); then eight fp32 vectors [qcap] (dt, cs, w, exp(cs), the
// row sums of E, the column sums of F, exp(cs) dy·(S_prev C), r), the
// row partials of two reductions [2][qcap][max(qcap, np) / 16] and the
// sixteen warps' shares of <dS_end, S_prev>.
struct BwdLayout {
  int qcap, pp, np;
  __host__ __device__ int xs() const { return pp + 8; }
  __host__ __device__ int ks() const { return np + 8; }
  __host__ __device__ int gs() const { return qcap + 8; }
  __host__ __device__ size_t dy_off() const { return (size_t)qcap * xs() * 2; }
  __host__ __device__ size_t b_off() const { return 2 * dy_off(); }
  __host__ __device__ size_t c_off() const {
    return b_off() + (size_t)qcap * ks() * 2;
  }
  __host__ __device__ size_t sp_off() const {
    return c_off() + (size_t)qcap * ks() * 2;
  }
  __host__ __device__ size_t ds_off() const {
    return sp_off() + (size_t)pp * ks() * 2;
  }
  __host__ __device__ size_t g_off() const {
    return ds_off() + (size_t)pp * ks() * 2;
  }
  __host__ __device__ size_t w_off() const {
    return g_off() + (size_t)qcap * gs() * 2;
  }
  __host__ __device__ size_t vec_off() const {
    return w_off() + (size_t)qcap * gs() * 2;
  }
  __host__ __device__ int part_cols() const {
    return (qcap > np ? qcap : np) / 16;
  }
  __host__ __device__ size_t part_off() const {
    return vec_off() + 8 * (size_t)qcap * 4;
  }
  __host__ __device__ size_t red_off() const {
    return part_off() + 2 * (size_t)qcap * part_cols() * 4;
  }
  __host__ __device__ size_t bytes() const {
    return red_off() + (kGradThreads / 32) * 4;
  }
};

__host__ __device__ inline BwdLayout bwd_layout(const BwdArgs& g) {
  return {round16(imin(g.chunk, g.seqlen)), round16(g.p_dim),
          padded_n(g.n_dim)};
}

// The most causal [Q, Q] tiles a warp computes (nT (nT + 1) / 2 tiles of
// 16 x 16 over sixteen warps, nT = qcap / 16 <= 8).
constexpr int kMaxQQ =
    (8 * 9 / 2 + kGradThreads / 32 - 1) / (kGradThreads / 32);

// (one block per SM, which its shared memory allows anyway, so ptxas may
// give a thread 128 registers)
template <int NP>
__global__ void __launch_bounds__(kGradThreads, 1) chunk_grad_mma_kernel(
    const BwdArgs g) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int z = blockIdx.x, h = blockIdx.y, row = blockIdx.z;
  const int S = g.seqlen, H = g.heads, P = g.p_dim, N = g.n_dim;
  const int c0 = z * g.chunk, qn = imin(g.chunk, S - c0);
  const BwdLayout lay = bwd_layout(g);
  const int qcap = lay.qcap, pp = lay.pp;
  const int XS = lay.xs(), KS = lay.ks(), GS = lay.gs();
  bf16* xs = reinterpret_cast<bf16*>(smem);
  bf16* dys = reinterpret_cast<bf16*>(smem + lay.dy_off());
  bf16* bs = reinterpret_cast<bf16*>(smem + lay.b_off());
  bf16* cs = reinterpret_cast<bf16*>(smem + lay.c_off());
  bf16* sps = reinterpret_cast<bf16*>(smem + lay.sp_off());
  bf16* dss = reinterpret_cast<bf16*>(smem + lay.ds_off());
  bf16* gm = reinterpret_cast<bf16*>(smem + lay.g_off());
  bf16* wm = reinterpret_cast<bf16*>(smem + lay.w_off());
  float* dts = reinterpret_cast<float*>(smem + lay.vec_off());
  float *cum = dts + qcap, *wts = dts + 2 * qcap, *ecs = dts + 3 * qcap;
  float *rowE = dts + 4 * qcap, *colF = dts + 5 * qcap;
  float *offv = dts + 6 * qcap, *rv = dts + 7 * qcap;
  float* part = reinterpret_cast<float*>(smem + lay.part_off());
  float* red = reinterpret_cast<float*>(smem + lay.red_off());
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  constexpr int kWarps = kGradThreads / 32;
  const size_t tok0 = (size_t)row * S + c0;
  const size_t sbase = (((size_t)row * g.n_chunks + z) * H + h) * P * N;
  const bf16* x = static_cast<const bf16*>(g.x);
  const bf16* dy = static_cast<const bf16*>(g.dy);
  const bf16* b = static_cast<const bf16*>(g.b);
  const bf16* c = static_cast<const bf16*>(g.c);

  // ---- the chunk into shared memory (zeros past qn, P and N), all in
  // flight at once: C and B (group 0, all the C Bᵀ tiles read), X and dY
  // (group 1) as 16-byte cp.async; then S_prev and dS_end in fp32 with
  // 16-byte loads, rounded to bf16 here while the copies land
  stage_bf16<kGradThreads>(cs, KS, c + (tok0 * H + h) * N, (size_t)H * N,
                           qn, N, qcap, NP, g.vec, tid);
  stage_bf16<kGradThreads>(bs, KS, b + (tok0 * H + h) * N, (size_t)H * N,
                           qn, N, qcap, NP, g.vec, tid);
  for (int i = tid; i < qcap; i += kGradThreads) {
    if (i < qn)
      ptx::cp_async_4(dts + i, g.dt + (tok0 + i) * H + h);
    else
      dts[i] = 0.f;
  }
  ptx::cp_async_commit();
  stage_bf16<kGradThreads>(xs, XS, x + (tok0 * H + h) * P, (size_t)H * P,
                           qn, P, qcap, pp, g.vec, tid);
  stage_bf16<kGradThreads>(dys, XS, dy + (tok0 * H + h) * P, (size_t)H * P,
                           qn, P, qcap, pp, g.vec, tid);
  ptx::cp_async_commit();
  // kBatch vectors of each in flight a thread, then their conversions
  constexpr int kBatch = 4;
  float dot = 0.f;   // <dS_end, S_prev> in fp32
  for (int e0 = 4 * tid; e0 < pp * NP; e0 += 4 * kGradThreads * kBatch) {
    float4 s4[kBatch], d4[kBatch];
#pragma unroll
    for (int r = 0; r < kBatch; ++r) {
      const int e = e0 + 4 * kGradThreads * r;
      const int p = e / NP, n = e % NP;
      if (g.vec && e < pp * NP && p < P && n < N) {
        s4[r] = *reinterpret_cast<const float4*>(g.states + sbase +
                                                 (size_t)p * N + n);
        d4[r] = *reinterpret_cast<const float4*>(g.ds + sbase +
                                                 (size_t)p * N + n);
      } else {
        float sv[4], dv[4];
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const bool ok = e < pp * NP && p < P && n + k < N;
          sv[k] = ok ? g.states[sbase + (size_t)p * N + n + k] : 0.f;
          dv[k] = ok ? g.ds[sbase + (size_t)p * N + n + k] : 0.f;
        }
        s4[r] = make_float4(sv[0], sv[1], sv[2], sv[3]);
        d4[r] = make_float4(dv[0], dv[1], dv[2], dv[3]);
      }
    }
#pragma unroll
    for (int r = 0; r < kBatch; ++r) {
      const int e = e0 + 4 * kGradThreads * r;
      if (e >= pp * NP) break;
      const int p = e / NP, n = e % NP;
      const float4 sv = s4[r], dv = d4[r];
      dot = fmaf(sv.x, dv.x, dot);
      dot = fmaf(sv.y, dv.y, dot);
      dot = fmaf(sv.z, dv.z, dot);
      dot = fmaf(sv.w, dv.w, dot);
      __nv_bfloat162* sp2 =
          reinterpret_cast<__nv_bfloat162*>(sps + p * KS + n);
      __nv_bfloat162* ds2 =
          reinterpret_cast<__nv_bfloat162*>(dss + p * KS + n);
      sp2[0] = __floats2bfloat162_rn(sv.x, sv.y);
      sp2[1] = __floats2bfloat162_rn(sv.z, sv.w);
      ds2[0] = __floats2bfloat162_rn(dv.x, dv.y);
      ds2[1] = __floats2bfloat162_rn(dv.z, dv.w);
    }
  }
  dot = warp_sum(dot);
  if (lane == 0) red[warp] = dot;
  ptx::cp_async_wait<1>();   // C and B
  __syncthreads();

  // ---- C Bᵀ of this warp's causal [Q, Q] tiles, while X and dY land;
  // warp 0 first takes cs, w = dt ∘ exp(cs_last - cs) and exp(cs)
  if (warp == 0) {
    chunk_cumsum(dts, g.a[h], cum, qcap, lane);
    __syncwarp();
    const float last = cum[qn - 1];
    for (int j = lane; j < qcap; j += 32) {
      wts[j] = dts[j] * expf(last - cum[j]);
      ecs[j] = expf(cum[j]);
    }
  }
  const int nT = qcap / 16;
  const int n_qq = nT * (nT + 1) / 2;
  float cbr[kMaxQQ][2][4];
#pragma unroll
  for (int u = 0; u < kMaxQQ; ++u) {
    const int t = warp + u * kWarps;
#pragma unroll
    for (int nb = 0; nb < 2; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) cbr[u][nb][e] = 0.f;
    if (t >= n_qq) continue;
    int mi = 0, kj = t;                   // the t-th tile with kj <= mi
    while (kj > mi) kj -= ++mi;
#pragma unroll
    for (int kk = 0; kk < NP / 16; ++kk)
      mma_tile<false, false>(cbr[u], cs, KS, 16 * mi, 16 * kk, bs, KS,
                             16 * kj, lane);
  }
  ptx::cp_async_wait<0>();   // X and dY
  __syncthreads();

  // ---- dY Xᵀ of the same tiles, then G and W (bf16, for the products
  // below) and E's row sums and F's column sums per tile
  float* part_row = part;                 // [qcap][nT]: Σ_j E_ij per tile
  float* part_col = part + qcap * nT;     // [qcap][nT]: Σ_i F_ij per tile
#pragma unroll
  for (int u = 0; u < kMaxQQ; ++u) {
    const int t = warp + u * kWarps;
    if (t >= n_qq) continue;
    int mi = 0, kj = t;
    while (kj > mi) kj -= ++mi;
    const float(&cb)[2][4] = cbr[u];
    float mm[2][4] = {};
    for (int kk = 0; kk < pp / 16; ++kk)
      mma_tile<false, false>(mm, dys, XS, 16 * mi, 16 * kk, xs, XS, 16 * kj,
                             lane);
    const int i0 = 16 * mi + lane / 4;
    float rsum[2] = {0.f, 0.f}, csum[2][2] = {};
    float gv[2][4], wv[2][4];
#pragma unroll
    for (int nb = 0; nb < 2; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = i0 + 8 * (e / 2);
        const int j = 16 * kj + 8 * nb + 2 * (lane % 4) + e % 2;
        gv[nb][e] = wv[nb][e] = 0.f;
        if (j <= i) {
          const float l = expf(cum[i] - cum[j]);
          gv[nb][e] = cb[nb][e] * l * dts[j];
          wv[nb][e] = mm[nb][e] * l * dts[j];
          rsum[e / 2] += wv[nb][e] * cb[nb][e];
          csum[nb][e % 2] += mm[nb][e] * cb[nb][e] * l;
        }
      }
#pragma unroll
    for (int nb = 0; nb < 2; ++nb)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int off = (i0 + 8 * r) * GS + 16 * kj + 8 * nb + 2 * (lane % 4);
        *reinterpret_cast<__nv_bfloat162*>(gm + off) =
            __floats2bfloat162_rn(gv[nb][2 * r], gv[nb][2 * r + 1]);
        *reinterpret_cast<__nv_bfloat162*>(wm + off) =
            __floats2bfloat162_rn(wv[nb][2 * r], wv[nb][2 * r + 1]);
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float v = quad_sum(rsum[r]);
      if (lane % 4 == 0) part_row[(i0 + 8 * r) * nT + kj] = v;
    }
#pragma unroll
    for (int nb = 0; nb < 2; ++nb)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float v = csum[nb][e];
        v += __shfl_xor_sync(kFull, v, 4);
        v += __shfl_xor_sync(kFull, v, 8);
        v += __shfl_xor_sync(kFull, v, 16);
        if (lane < 4) part_col[(16 * kj + 8 * nb + 2 * lane + e) * nT + mi] = v;
      }
  }
  __syncthreads();
  for (int i = tid; i < qcap; i += kGradThreads) {   // the tiles in order
    float r = 0.f, f = 0.f;
    for (int k = 0; k <= i / 16; ++k) r += part_row[i * nT + k];
    for (int k = i / 16; k < nT; ++k) f += part_col[i * nT + k];
    rowE[i] = r;
    colF[i] = f;
  }
  __syncthreads();

  // ---- dX [Q, P] in 16 x 16 tiles; dC and dB [Q, N] in 16 x (16 kNT)
  // tiles (16 x 64 at N = 128), each A fragment serving kNT B fragments
  constexpr int kNT = NP >= 64 ? 4 : (NP >= 32 ? 2 : 1);
  const int nPT = pp / 16, nNT = NP / 16, nWT = nNT / kNT;
  float* part_off = part;                 // [qcap][nNT]: exp(cs) dy·(S C)
  float* part_r = part + qcap * nNT;      // [qcap][nNT]: r
  const int t_dx = nT * nPT, t_dc = nT * nWT;
  const bool pair_p = P % 2 == 0, pair_n = N % 2 == 0;
  for (int t = warp; t < t_dx + 2 * t_dc; t += kWarps) {
    if (t < t_dx) {
      // dX = Gᵀ dY + w ∘ (B dS_endᵀ)
      float acc[2][4] = {};
      const int mj = t / nPT, pt = t % nPT;
      for (int kb = mj; kb < nT; ++kb)
        mma_tile<true, true>(acc, gm, GS, 16 * mj, 16 * kb, dys, XS, 16 * pt,
                             lane);
      float st[2][4] = {};
#pragma unroll
      for (int kk = 0; kk < NP / 16; ++kk)
        mma_tile<false, false>(st, bs, KS, 16 * mj, 16 * kk, dss, KS,
                               16 * pt, lane);
      bf16* dx = static_cast<bf16*>(g.dx);
#pragma unroll
      for (int nb = 0; nb < 2; ++nb)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int j = 16 * mj + lane / 4 + 8 * r;
          const int p = 16 * pt + 8 * nb + 2 * (lane % 4);
          if (j < qn && p < P)
            store_pair(dx + ((tok0 + j) * H + h) * P + p,
                       acc[nb][2 * r] + wts[j] * st[nb][2 * r],
                       acc[nb][2 * r + 1] + wts[j] * st[nb][2 * r + 1],
                       p + 1 < P, pair_p);
        }
      continue;
    }
    // dC = exp(cs) ∘ (dY S_prev) + W B;  dB = w ∘ (X dS_end) + Wᵀ C. The
    // state term first: its row dot with C (dC) or B (dB) gives the
    // row's share of exp(cs) dy·(S_prev C) or of r.
    float acc[2 * kNT][4] = {};
    const bool is_dc = t < t_dx + t_dc;
    const int u = t - t_dx - (is_dc ? 0 : t_dc);
    const int mi = u / nWT, n0 = 16 * kNT * (u % nWT);
    for (int kk = 0; kk < nPT; ++kk)
      mma_tile<false, true, kNT>(acc, is_dc ? dys : xs, XS, 16 * mi, 16 * kk,
                                 is_dc ? sps : dss, KS, n0, lane);
    const bf16* dotm = is_dc ? cs : bs;
    float rs[2] = {0.f, 0.f};
#pragma unroll
    for (int nb = 0; nb < 2 * kNT; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = 16 * mi + lane / 4 + 8 * (e / 2);
        const int n = n0 + 8 * nb + 2 * (lane % 4) + e % 2;
        const float v = is_dc ? acc[nb][e] * ecs[i] : acc[nb][e];
        rs[e / 2] += v * __bfloat162float(dotm[i * KS + n]);
        acc[nb][e] = is_dc ? v : v * wts[i];
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float v = quad_sum(rs[r]);
      if (lane % 4 == 0)
        (is_dc ? part_off : part_r)[(16 * mi + lane / 4 + 8 * r) * nWT +
                                    u % nWT] = v;
    }
    if (is_dc) {
      for (int kb = 0; kb <= mi; ++kb)
        mma_tile<false, true, kNT>(acc, wm, GS, 16 * mi, 16 * kb, bs, KS, n0,
                                   lane);
    } else {
      for (int kb = mi; kb < nT; ++kb)
        mma_tile<true, true, kNT>(acc, wm, GS, 16 * mi, 16 * kb, cs, KS, n0,
                                  lane);
    }
    bf16* out = static_cast<bf16*>(is_dc ? g.dc : g.db);
    if constexpr (kNT >= 2) {
      if (g.vec) {
        // 16-byte stores: a quad holds a row's 8 columns of each n-block,
        // 4 bytes a lane; four n-blocks transposed across the quad give
        // each lane one n-block's 16 bytes
        const int q = lane % 4;
#pragma unroll
        for (int nb0 = 0; nb0 < 2 * kNT; nb0 += 4)
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const int i = 16 * mi + lane / 4 + 8 * r;
            uint4 v;
            quad_transpose(v, ptx::pack_bf16(acc[nb0][2 * r],
                                             acc[nb0][2 * r + 1]),
                           ptx::pack_bf16(acc[nb0 + 1][2 * r],
                                          acc[nb0 + 1][2 * r + 1]),
                           ptx::pack_bf16(acc[nb0 + 2][2 * r],
                                          acc[nb0 + 2][2 * r + 1]),
                           ptx::pack_bf16(acc[nb0 + 3][2 * r],
                                          acc[nb0 + 3][2 * r + 1]),
                           q);
            const int n = n0 + 8 * (nb0 + q);
            if (i < qn && n < N)
              *reinterpret_cast<uint4*>(out + ((tok0 + i) * H + h) * N + n) =
                  v;
          }
        continue;
      }
    }
#pragma unroll
    for (int nb = 0; nb < 2 * kNT; ++nb)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int i = 16 * mi + lane / 4 + 8 * r;
        const int n = n0 + 8 * nb + 2 * (lane % 4);
        if (i < qn && n < N)
          store_pair(out + ((tok0 + i) * H + h) * N + n, acc[nb][2 * r],
                     acc[nb][2 * r + 1], n + 1 < N, pair_n);
      }
  }
  __syncthreads();
  for (int i = tid; i < qcap; i += kGradThreads) {
    float o = 0.f, r = 0.f;
    for (int k = 0; k < nWT; ++k) {
      o += part_off[i * nWT + k];
      r += part_r[i * nWT + k];
    }
    offv[i] = o;
    rv[i] = r;
  }
  __syncthreads();
  if (warp == 0) {
    float d = 0.f;
    for (int w = 0; w < kWarps; ++w) d += red[w];
    chunk_scalars(dts, cum, wts, rowE, colF, offv, rv, qn, g.a[h], d,
                  g.ddt + tok0 * H + h, H,
                  g.da_part + ((size_t)row * H + h) * g.n_chunks + z, lane);
  }
}

// ------------------------------------------------- (c) chunk grad, fp32

// Shared memory of the fp32 kernel (c), floats: C Bᵀ, dY Xᵀ and L
// [q][q+1] (q = min(chunk, seqlen)), eight vectors [q] as in the bf16
// kernel, and the eight warps' shares of <dS_end, S_prev>.
__host__ __device__ inline size_t f32_grad_smem(int q) {
  return (3 * (size_t)q * (q + 1) + 8 * (size_t)q + 8) * 4;
}

__global__ void __launch_bounds__(kThreads) chunk_grad_f32_kernel(
    const BwdArgs g) {
  extern __shared__ float fsm[];
  const int z = blockIdx.x, h = blockIdx.y, row = blockIdx.z;
  const int S = g.seqlen, H = g.heads, P = g.p_dim, N = g.n_dim;
  const int c0 = z * g.chunk, qn = imin(g.chunk, S - c0);
  const int q = imin(g.chunk, S), QS = q + 1;
  float *cbm = fsm, *mm = fsm + q * QS, *lm = fsm + 2 * q * QS;
  float* dts = fsm + 3 * q * QS;
  float *cum = dts + q, *wts = dts + 2 * q, *ecs = dts + 3 * q;
  float *rowE = dts + 4 * q, *colF = dts + 5 * q, *offv = dts + 6 * q;
  float *rv = dts + 7 * q, *red = dts + 8 * q;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  constexpr int kWarps = kThreads / 32;
  const size_t tok0 = (size_t)row * S + c0;
  const size_t sbase = (((size_t)row * g.n_chunks + z) * H + h) * P * N;
  const float* x = static_cast<const float*>(g.x) + tok0 * H * P + h * P;
  const float* dy = static_cast<const float*>(g.dy) + tok0 * H * P + h * P;
  const float* b = static_cast<const float*>(g.b) + tok0 * H * N + h * N;
  const float* c = static_cast<const float*>(g.c) + tok0 * H * N + h * N;
  const float* sp = g.states + sbase;
  const float* dse = g.ds + sbase;
  const int XR = H * P, BR = H * N;   // strides of a position
  float dot = 0.f;
  for (int e = tid; e < P * N; e += kThreads) dot = fmaf(sp[e], dse[e], dot);
  dot = warp_sum(dot);
  if (lane == 0) red[warp] = dot;
  for (int i = tid; i < q; i += kThreads)
    dts[i] = i < qn ? g.dt[(tok0 + i) * H + h] : 0.f;
  __syncthreads();
  if (warp == 0) {
    chunk_cumsum(dts, g.a[h], cum, q, lane);
    __syncwarp();
    const float last = cum[qn - 1];
    for (int j = lane; j < q; j += 32) {
      wts[j] = dts[j] * expf(last - cum[j]);
      ecs[j] = expf(cum[j]);
    }
  }
  __syncthreads();
  for (int e = tid; e < qn * qn; e += kThreads) {
    const int i = e / qn, j = e % qn;
    float cb = 0.f, m = 0.f, l = 0.f;
    if (j <= i) {
      for (int n = 0; n < N; ++n) cb = fmaf(c[i * BR + n], b[j * BR + n], cb);
      for (int p = 0; p < P; ++p) m = fmaf(dy[i * XR + p], x[j * XR + p], m);
      l = expf(cum[i] - cum[j]);
    }
    cbm[i * QS + j] = cb;
    mm[i * QS + j] = m;
    lm[i * QS + j] = l;
  }
  __syncthreads();
  for (int i = tid; i < qn; i += kThreads) {
    float r = 0.f, f = 0.f, o = 0.f, rr = 0.f;
    for (int j = 0; j <= i; ++j)
      r += mm[i * QS + j] * lm[i * QS + j] * dts[j] * cbm[i * QS + j];
    for (int k = i; k < qn; ++k)
      f += mm[k * QS + i] * cbm[k * QS + i] * lm[k * QS + i];
    for (int p = 0; p < P; ++p) {
      float sc = 0.f, sb = 0.f;
      for (int n = 0; n < N; ++n) {
        sc = fmaf(sp[p * N + n], c[i * BR + n], sc);
        sb = fmaf(dse[p * N + n], b[i * BR + n], sb);
      }
      o = fmaf(dy[i * XR + p], sc, o);
      rr = fmaf(x[i * XR + p], sb, rr);
    }
    rowE[i] = r;
    colF[i] = f;
    offv[i] = ecs[i] * o;
    rv[i] = rr;
  }
  float* dx = static_cast<float*>(g.dx) + tok0 * H * P + h * P;
  for (int e = tid; e < qn * P; e += kThreads) {
    const int j = e / P, p = e % P;
    float a1 = 0.f, a2 = 0.f;
    for (int i = j; i < qn; ++i)
      a1 = fmaf(cbm[i * QS + j] * lm[i * QS + j] * dts[j], dy[i * XR + p], a1);
    for (int n = 0; n < N; ++n) a2 = fmaf(b[j * BR + n], dse[p * N + n], a2);
    dx[j * XR + p] = a1 + wts[j] * a2;
  }
  float* dc = static_cast<float*>(g.dc) + tok0 * H * N + h * N;
  float* db = static_cast<float*>(g.db) + tok0 * H * N + h * N;
  for (int e = tid; e < qn * N; e += kThreads) {
    const int i = e / N, n = e % N;
    float c1 = 0.f, c2 = 0.f, b1 = 0.f, b2 = 0.f;
    for (int j = 0; j <= i; ++j)
      c1 = fmaf(mm[i * QS + j] * lm[i * QS + j] * dts[j], b[j * BR + n], c1);
    for (int k = i; k < qn; ++k)
      b1 = fmaf(mm[k * QS + i] * lm[k * QS + i] * dts[i], c[k * BR + n], b1);
    for (int p = 0; p < P; ++p) {
      c2 = fmaf(dy[i * XR + p], sp[p * N + n], c2);
      b2 = fmaf(x[i * XR + p], dse[p * N + n], b2);
    }
    dc[i * BR + n] = c1 + ecs[i] * c2;
    db[i * BR + n] = b1 + wts[i] * b2;
  }
  __syncthreads();
  if (warp == 0) {
    float d = 0.f;
    for (int w = 0; w < kWarps; ++w) d += red[w];
    chunk_scalars(dts, cum, wts, rowE, colF, offv, rv, qn, g.a[h], d,
                  g.ddt + tok0 * H + h, H,
                  g.da_part + ((size_t)row * H + h) * g.n_chunks + z, lane);
  }
}

// ------------------------------------------------- (d) da

__global__ void __launch_bounds__(kThreads) da_reduce_kernel(
    const float* part, float* da, int batch, int heads, int n_chunks) {
  const int h = blockIdx.x * kThreads + threadIdx.x;
  if (h >= heads) return;
  float s = 0.f;
  for (int row = 0; row < batch; ++row)
    for (int z = 0; z < n_chunks; ++z)
      s += part[((size_t)row * heads + h) * n_chunks + z];
  da[h] = s;
}

// Whether this library has raised each kernel's dynamic shared memory
// limit (internal linkage: one flag per library).
template <int NP>
bool mma_raised = false;
bool f32_raised = false;

// The grids of one call's launches, in launch order, as the wrapper's
// ssd_scan_bwd_grid describes them; returns their count. bf16: the chain,
// chunk_grad, da_reduce; fp32: dstate, state_pass, chunk_grad, da_reduce.
int grids_of(int dtype, int batch, int heads, int p_dim, int n_dim,
             int n_chunks, dim3* g) {
  const dim3 chunks(n_chunks, heads, batch);
  const dim3 da((heads + kThreads - 1) / kThreads);
  if (dtype == 1) {
    g[0] = dim3((p_dim + kSlice - 1) / kSlice, heads, batch);
    g[1] = chunks;
    g[2] = da;
    return 3;
  }
  g[0] = chunks;
  g[1] = dim3((p_dim * n_dim + kThreads - 1) / kThreads, heads, batch);
  g[2] = chunks;
  g[3] = da;
  return 4;
}

template <int NP>
int launch_mma(const BwdArgs& g, const dim3* grids, const float* dfinal,
               float* dinit, cudaStream_t s) {
  const BwdLayout lay = bwd_layout(g);
  if (!mma_raised<NP>) {
    cudaError_t err = cudaFuncSetAttribute(
        dstate_chain_kernel<NP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kMaxSmem);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(chunk_grad_mma_kernel<NP>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 kMaxSmem);
    if (err != cudaSuccess) return (int)err;
    mma_raised<NP> = true;
  }
  dstate_chain_kernel<NP><<<grids[0], kThreads, chain_smem(lay.qcap, NP),
                            s>>>(g, dfinal, dinit);
  int rc = (int)cudaGetLastError();
  if (rc) return rc;
  chunk_grad_mma_kernel<NP><<<grids[1], kGradThreads, lay.bytes(), s>>>(g);
  return (int)cudaGetLastError();
}

int launch_f32(const BwdArgs& g, const dim3* grids, const float* dfinal,
               float* dinit, cudaStream_t s) {
  if (!f32_raised) {
    const cudaError_t err = cudaFuncSetAttribute(
        chunk_grad_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kMaxSmem);
    if (err != cudaSuccess) return (int)err;
    f32_raised = true;
  }
  dstate_f32_kernel<<<grids[0], kThreads, 0, s>>>(g);
  int rc = (int)cudaGetLastError();
  if (rc) return rc;
  state_pass_kernel<<<grids[1], kThreads, 0, s>>>(
      g.ds, g.cs_last, dfinal, dinit, g.n_chunks, g.heads,
      g.p_dim * g.n_dim);
  if ((rc = (int)cudaGetLastError())) return rc;
  chunk_grad_f32_kernel<<<grids[2], kThreads,
                          f32_grad_smem(imin(g.chunk, g.seqlen)), s>>>(g);
  return (int)cudaGetLastError();
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

}  // namespace

// The shared memory the bf16 chunk-gradient kernel takes (the wrapper
// refuses shapes over the card's limit before it launches; the chain
// kernel takes less).
extern "C" size_t ssd_scan_bwd_smem(int seqlen, int p_dim, int n_dim,
                                    int chunk, int dtype) {
  if (dtype == 0) return f32_grad_smem(imin(chunk, seqlen));
  return BwdLayout{round16(imin(chunk, seqlen)), round16(p_dim),
                   padded_n(n_dim)}.bytes();
}

// Returns the first cudaError_t of the launches (0 on success). dtype: 0
// = fp32, 1 = bf16 for x, b, c, dy, dx, db and dc; dt, a, the chunk
// states, dfinal, ddt, da, dinit and the workspace are fp32. x, dy, dx
// [batch, seqlen, heads, p_dim]; dt, ddt [batch, seqlen, heads]; a, da
// [heads]; b, c, db, dc [batch, seqlen, heads, n_dim]; states [batch,
// n_chunks, heads, p_dim, n_dim] with n_chunks = ceil(seqlen / chunk);
// dfinal and dinit [batch, heads, p_dim, n_dim], each may be null (a zero
// gradient in; not written); ws one workspace of batch n_chunks heads
// (p_dim n_dim + 2) floats, 16-byte aligned: dS_end like the states, then
// cs_last and the da partials [batch, heads, n_chunks] each. grids
// (n_grids x 3 ints) is the wrapper's ssd_scan_bwd_grid; any other grids
// are refused before anything launches. The caller has checked shapes,
// dtypes and contiguity.
extern "C" int ssd_scan_bwd_launch(
    int dtype, const void* x, const void* dt, const void* a, const void* b,
    const void* c, const void* states, const void* dy, const void* dfinal,
    void* dx, void* ddt, void* da, void* db, void* dc, void* dinit, void* ws,
    int batch, int seqlen, int heads, int p_dim, int n_dim, int chunk,
    const int* grids, int n_grids, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (chunk < 1 || chunk > kMaxDim || p_dim < 1 || p_dim > kMaxDim ||
      n_dim < 1 || n_dim > kMaxDim || seqlen < 1 || batch < 1 ||
      batch > 65535 || heads < 1 || heads > 65535 || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  const int n_chunks = (seqlen + chunk - 1) / chunk;
  dim3 want[4];
  const int n_want = grids_of(dtype, batch, heads, p_dim, n_dim, n_chunks,
                              want);
  if (!grids_match(grids, n_grids, want, n_want))
    return (int)cudaErrorInvalidValue;
  const size_t pn = (size_t)batch * n_chunks * heads * p_dim * n_dim;
  const size_t bhc = (size_t)batch * heads * n_chunks;
  float* wsf = static_cast<float*>(ws);
  const int vec = p_dim % 8 == 0 && n_dim % 8 == 0 && aligned16(x) &&
                  aligned16(b) && aligned16(c) && aligned16(dy) &&
                  aligned16(states) && aligned16(ws) && aligned16(db) &&
                  aligned16(dc);
  BwdArgs g{x, (const float*)dt, (const float*)a, b, c,
            (const float*)states, dy, wsf, wsf + pn, wsf + pn + bhc, dx, db,
            dc, (float*)ddt, seqlen, heads, p_dim, n_dim, chunk, n_chunks,
            vec};
  if (ssd_scan_bwd_smem(seqlen, p_dim, n_dim, chunk, dtype) >
      (size_t)kMaxSmem)
    return (int)cudaErrorInvalidValue;
  int rc;
  if (dtype == 1) {
    switch (padded_n(n_dim)) {
      case 16: rc = launch_mma<16>(g, want, (const float*)dfinal,
                                   (float*)dinit, s); break;
      case 32: rc = launch_mma<32>(g, want, (const float*)dfinal,
                                   (float*)dinit, s); break;
      case 64: rc = launch_mma<64>(g, want, (const float*)dfinal,
                                   (float*)dinit, s); break;
      default: rc = launch_mma<128>(g, want, (const float*)dfinal,
                                    (float*)dinit, s); break;
    }
  } else {
    rc = launch_f32(g, want, (const float*)dfinal, (float*)dinit, s);
  }
  if (rc) return rc;
  da_reduce_kernel<<<want[n_want - 1], kThreads, 0, s>>>(
      g.da_part, (float*)da, batch, heads, n_chunks);
  return (int)cudaGetLastError();
}
