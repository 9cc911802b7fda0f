// Mamba-2 SSD chunked scan for Hopper (sm_90a), with state in and out.
//
// Replaces the TPU kernel repro/kernels/ssd_scan/ssd_scan.py (ssd_scan,
// body _ssd_kernel) and, with its initial and final state, the chunked
// scan repro/models/mamba2.py:ssd_chunked that the serving mixer runs.
// For one (batch row, head) and each chunk of qn <= Q positions:
//
//   intra-chunk:  Y   = (C·Bᵀ ∘ L ∘ dt) · X,  L[i,j] = exp(cs[i] - cs[j]), j <= i
//   inter-chunk:  Y  += exp(cs) ∘ (C · S_prevᵀ)
//   state:        S   = exp(cs[qn-1]) · S_prev + Xᵀ · (B ∘ dt ∘ exp(cs[qn-1] - cs))
//
// with cs the cumulative sum of dt·a inside the chunk. The [P, N] state is
// carried from chunk to chunk in fp32 in a fixed order; only the initial
// state (read) and the final state (written) are in the storage type.
// Masked positions arrive with dt = 0 (the wrapper zeroes them, as the TPU
// wrapper does): an exact identity transition. S need not be a multiple of
// Q: the last chunk is partial, and its missing rows count as dt = 0 and
// x = b = c = 0, the padding of the plain version.
//
// What bounds it on this card: the latency of one CTA's dependent chain.
// At phase 8's lane (mamba2-130m: 24 heads of P = 64, N = 128; one row of
// 32 positions, 17 valid) the scan moves ~0.1 MB and does ~3.5 MFLOP:
// 0.03 us at 3.35 TB/s, under the ~5 us of an empty launch. The design:
//   * Work bounded by the rows present. Every per-chunk loop runs over qn
//     (padded to 16 for the tensor-core tiles), never over the chunk:
//     the loads, the cumsum (a warp-shuffle scan in a fixed order), the
//     gate's rows and columns (the causal half of [qn, qn] only) and the
//     state update.
//   * Split over P. The grid is (16-column slice of P, head, row). y[:, p]
//     and S[p, :] read only x[:, p], so each CTA recomputes the [qn, qn]
//     gate C·Bᵀ ∘ L ∘ dt for itself and needs nothing from another CTA: no
//     workspace, no atomics. A row's result does not depend on the other
//     rows of the launch or on the slice count (each column's sums are the
//     same code in the same order).
//   * bf16 products on tensor cores (mma.sync m16n8k16, fp32
//     accumulators). C·Bᵀ takes the stored bf16 C and B as they are; the
//     three products with an fp32 operand split that operand into bf16 hi
//     and lo, as K5 splits P: gate·X (the gate), C·S_prevᵀ (the state) and
//     (X ∘ w)ᵀ·B with w = dt ∘ exp(cs_last - cs) (X ∘ w).
//   * Two roles at once. Warps 0-3 compute Y: a warp owns one 16-row
//     m-tile at a time, building the gate 16 columns at a time in
//     registers (the tiles of a causal triangle dealt so that the four
//     warps get equal shares). Warps 4-7 update the state meanwhile: each
//     owns 16-column pieces of N of the [16, N] slice, which stays in its
//     registers from chunk to chunk; its bf16 hi and lo copies in shared
//     memory feed the next chunk's C·S_prevᵀ.
//   * Shared memory sized by the rows present and one slice of X (28 KB
//     at phase 8's lane, 162 KB at a full chunk of 128 with two stages),
//     and cp.async bringing the next chunk's B, C, X slice and dt while
//     this chunk computes.
// fp32 stays on the CUDA cores (bf16 tensor-core products cannot meet
// 1e-4), bounded by qn and split over P the same way.
//
// Measured (chip_smoke.py phase 3, bf16, mamba2-130m's widths, device time
// with the launches queued; NVIDIA H100 80GB HBM3, 700.00 W): phase 8's
// lane (32 rows, 17 valid; 96 CTAs), 0.0091 ms (the one-CTA-per-head
// fp32 kernel this replaces: 0.0590 in the same run); one row of 2,048
// positions (16 chunks in series), 0.149-0.151 ms (PERF.md section 6).
#include "hopper_ptx.cuh"

namespace {

using bf16 = __nv_bfloat16;
constexpr int kSlice = 16;          // columns of P one CTA owns
constexpr int kMaxDim = 128;        // chunk, N and P up to 128
constexpr int kMaxSmem = 232448;    // the card's per-block limit
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(bf16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(bf16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

__host__ __device__ inline int round16(int v) { return (v + 15) / 16 * 16; }
__host__ __device__ inline int imin(int a, int b) { return a < b ? a : b; }

// N padded for the bf16 kernel's tiles: 16, 32, 64 or 128
__host__ __device__ inline int padded_n(int n) {
  return n <= 16 ? 16 : n <= 32 ? 32 : n <= 64 ? 64 : 128;
}

struct Args {
  const void* x;            // [batch, seqlen, heads, p_dim]
  const float* dt;          // [batch, seqlen, heads]
  const float* a;           // [heads]
  const void* b;            // [batch, seqlen, heads, n_dim]
  const void* c;
  const void* init_state;   // [batch, heads, p_dim, n_dim] or null
  void* y;
  void* final_state;
  int seqlen, heads, p_dim, n_dim, chunk;
  int vec;                  // bf16 rows of B, C and X copy in 16-byte pieces
};

// cum[i] = sum of dts[k] * a_h over k <= i, for i < rows (<= 128), by one
// warp in a fixed order: each lane runs 4 consecutive rows, then an
// inclusive scan of the lanes' totals.
__device__ __forceinline__ void chunk_cumsum(const float* dts, float a_h,
                                             float* cum, int rows,
                                             int lane) {
  float v[4], run = 0.f;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int i = 4 * lane + e;
    run += i < rows ? dts[i] * a_h : 0.f;
    v[e] = run;
  }
  float incl = run;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const float up = __shfl_up_sync(kFull, incl, d);
    if (lane >= d) incl += up;
  }
  float excl = __shfl_up_sync(kFull, incl, 1);
  if (lane == 0) excl = 0.f;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int i = 4 * lane + e;
    if (i < rows) cum[i] = excl + v[e];
  }
}

// ------------------------------------------------- bf16: tensor cores

// One 16-byte piece of a row: copied where it exists, zeros where not.
__device__ __forceinline__ void stage16(bf16* dst, const bf16* src,
                                        bool ok) {
  if (ok)
    ptx::cp_async_16(dst, src);
  else
    *reinterpret_cast<uint4*>(dst) = make_uint4(0u, 0u, 0u, 0u);
}

// Shared memory of the bf16 kernel (bytes): per stage B and C [qcap][np+8]
// and the X slice [qcap][24] in bf16 and dt [qcap] fp32; then the state's
// hi and lo [16][np+8] bf16, cs and w [qcap] fp32. Rows padded by 16 bytes
// so that ldmatrix's eight rows hit eight bank groups.
struct MmaLayout {
  int qcap, np, stages;
  static constexpr int kXStride = kSlice + 8;
  __host__ __device__ int stride() const { return np + 8; }
  __host__ __device__ size_t bc() const {
    return (size_t)qcap * stride() * 2;
  }
  __host__ __device__ size_t xs() const { return (size_t)qcap * kXStride * 2; }
  __host__ __device__ size_t stage() const { return 2 * bc() + xs() + qcap * 4; }
  __host__ __device__ size_t s_off() const { return stages * stage(); }
  __host__ __device__ size_t cum_off() const {
    return s_off() + 2 * (size_t)kSlice * stride() * 2;
  }
  __host__ __device__ size_t w_off() const { return cum_off() + qcap * 4; }
  __host__ __device__ size_t bytes() const { return w_off() + qcap * 4; }
};

__host__ __device__ inline MmaLayout mma_layout(const Args& g) {
  return {round16(imin(g.chunk, g.seqlen)), padded_n(g.n_dim),
          g.seqlen > g.chunk ? 2 : 1};
}

// Eight warps: warps 0-3 compute Y, warps 4-7 the state update, at the
// same time (both read only this chunk's tiles and the previous state).
constexpr int kMmaThreads = 256;

template <int NP>
__global__ void __launch_bounds__(kMmaThreads) ssd_mma_kernel(const Args g) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int kPairs = NP / 16;   // 16-column pieces of the state
  const MmaLayout lay = mma_layout(g);
  const int KS = lay.stride();
  constexpr int XS = MmaLayout::kXStride;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const bool y_warp = warp < 4;   // else a state warp
  const int wr = warp % 4;        // the warp's rank within its role
  const int p0 = blockIdx.x * kSlice, h = blockIdx.y, row = blockIdx.z;
  const int S = g.seqlen, H = g.heads, P = g.p_dim, N = g.n_dim;
  const bf16* x = static_cast<const bf16*>(g.x);
  const bf16* b = static_cast<const bf16*>(g.b);
  const bf16* c = static_cast<const bf16*>(g.c);
  bf16* s_hi = reinterpret_cast<bf16*>(smem + lay.s_off());
  bf16* s_lo = s_hi + kSlice * KS;
  float* cum = reinterpret_cast<float*>(smem + lay.cum_off());
  float* wts = reinterpret_cast<float*>(smem + lay.w_off());
  const float a_h = g.a[h];
  const size_t state_base = ((size_t)row * H + h) * P * N;
  const auto b_at = [&](int s) {
    return reinterpret_cast<bf16*>(smem + s * lay.stage());
  };
  const auto c_at = [&](int s) { return b_at(s) + lay.bc() / 2; };
  const auto x_at = [&](int s) { return b_at(s) + lay.bc(); };
  const auto dt_at = [&](int s) {
    return reinterpret_cast<float*>(smem + s * lay.stage() + 2 * lay.bc() +
                                    lay.xs());
  };

  // the chunk from position c0 into stage s: rows past qn and columns past
  // N or P are zeros
  const auto load = [&](int c0, int s) {
    const int qn = min(g.chunk, S - c0), qp = round16(qn);
    const size_t tok0 = (size_t)row * S + c0;
    bf16 *bd = b_at(s), *cd = c_at(s), *xd = x_at(s);
    float* dd = dt_at(s);
    for (int i = tid; i < qp; i += kMmaThreads) {
      if (i < qn)
        ptx::cp_async_4(dd + i, g.dt + (tok0 + i) * H + h);
      else
        dd[i] = 0.f;
    }
    if (g.vec) {
      constexpr int kPieces = NP / 8;
      for (int e = tid; e < qp * kPieces; e += kMmaThreads) {
        const int i = e / kPieces, n = (e % kPieces) * 8;
        const bool ok = i < qn && n < N;
        const size_t src = ((tok0 + i) * H + h) * N + n;
        stage16(bd + i * KS + n, b + src, ok);
        stage16(cd + i * KS + n, c + src, ok);
      }
      for (int e = tid; e < qp * 2; e += kMmaThreads) {
        const int i = e / 2, pc = (e % 2) * 8;
        stage16(xd + i * XS + pc, x + ((tok0 + i) * H + h) * P + p0 + pc,
                i < qn && p0 + pc < P);
      }
    } else {
      const bf16 zero = __float2bfloat16_rn(0.f);
      for (int e = tid; e < qp * NP; e += kMmaThreads) {
        const int i = e / NP, n = e % NP;
        const bool ok = i < qn && n < N;
        const size_t src = ((tok0 + i) * H + h) * N + n;
        bd[i * KS + n] = ok ? b[src] : zero;
        cd[i * KS + n] = ok ? c[src] : zero;
      }
      for (int e = tid; e < qp * kSlice; e += kMmaThreads) {
        const int i = e / kSlice, pl = e % kSlice;
        xd[i * XS + pl] = i < qn && p0 + pl < P
                              ? x[((tok0 + i) * H + h) * P + p0 + pl]
                              : zero;
      }
    }
    ptx::cp_async_commit();
  };
  load(0, 0);

  // The state slice [16 x NP] in the state warps' fp32 registers: state
  // warp wr owns the 16-column pieces pr = wr + 4 k; element e of n-block
  // nb is row lane / 4 + 8 (e / 2), column 16 pr + 8 nb + 2 (lane % 4) +
  // e % 2.
  float st[2][2][4];
  // its bf16 hi and lo copies, the B operand of the next C·S_prevᵀ
  const auto publish = [&] {
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const int pr = wr + 4 * k;
      if (pr >= kPairs) continue;
#pragma unroll
      for (int nb = 0; nb < 2; ++nb)
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int off = (lane / 4 + 8 * i) * KS + 16 * pr + 8 * nb +
                          2 * (lane % 4);
          uint32_t hi, lo;
          ptx::split_bf16(st[k][nb][2 * i], st[k][nb][2 * i + 1], hi, lo);
          *reinterpret_cast<uint32_t*>(s_hi + off) = hi;
          *reinterpret_cast<uint32_t*>(s_lo + off) = lo;
        }
    }
  };
  const bf16* init = static_cast<const bf16*>(g.init_state);
#pragma unroll
  for (int k = 0; k < 2; ++k)
#pragma unroll
    for (int nb = 0; nb < 2; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int p = p0 + lane / 4 + 8 * (e / 2);
        const int n = 16 * (wr + 4 * k) + 8 * nb + 2 * (lane % 4) + e % 2;
        st[k][nb][e] = init && p < P && n < N
                           ? to_f32(init[state_base + (size_t)p * N + n])
                           : 0.f;
      }
  if (!y_warp) publish();

  const int n_chunks = (S + g.chunk - 1) / g.chunk;
  for (int ci = 0; ci < n_chunks; ++ci) {
    const int c0 = ci * g.chunk;
    const int qn = min(g.chunk, S - c0), qp = round16(qn);
    const int s = ci % lay.stages;
    ptx::cp_async_wait<0>();
    __syncthreads();   // chunk ci is in; chunk ci - 1 is done, S published
    if (ci + 1 < n_chunks) load(c0 + g.chunk, (ci + 1) % lay.stages);
    const bf16 *bd = b_at(s), *cd = c_at(s), *xd = x_at(s);
    const float* dd = dt_at(s);
    if (warp == 0) {   // cs, then w = dt ∘ exp(cs_last - cs)
      chunk_cumsum(dd, a_h, cum, qp, lane);
      __syncwarp();
      const float last = cum[qn - 1];
      for (int j = lane; j < qp; j += 32)
        wts[j] = dd[j] * expf(last - cum[j]);
    }
    __syncthreads();
    const float cs_last = cum[qn - 1];

    // ---- Y on warps 0-3, one 16-row m-tile at a time; the causal
    // triangle's tiles dealt in a snake (warp w takes w, 7 - w, 8 + w, ...)
    const size_t tok0 = (size_t)row * S + c0;
    const int n_mt = y_warp ? qp / 16 : 0;
    for (int k = 0; 4 * k < n_mt; ++k) {
      const int mi = 4 * k + (k % 2 == 0 ? wr : 3 - wr);
      if (mi >= n_mt) continue;
      uint32_t ca[NP / 16][4];   // C rows 16 mi .. as A fragments over N
#pragma unroll
      for (int kk = 0; kk < NP / 16; ++kk)
        ptx::ldmatrix_x4(ca[kk], cd + (16 * mi + lane % 8 +
                                       8 * ((lane / 8) % 2)) * KS +
                                     16 * kk + 8 * (lane / 16));
      const int i0 = 16 * mi + lane / 4;   // this thread's rows i0, i0 + 8
      const float cum_i[2] = {cum[i0], cum[i0 + 8]};
      float yd[2][4] = {}, yo[2][4] = {};
      for (int kb = 0; kb <= mi; ++kb) {
        // the gate's columns 16 kb .. 16 kb + 15: C·Bᵀ ...
        float gt[2][4] = {};
#pragma unroll
        for (int kk = 0; kk < NP / 16; ++kk) {
          uint32_t bb[4];
          ptx::ldmatrix_x4(bb, bd + (16 * kb + 8 * (lane / 16) + lane % 8) *
                                        KS +
                                    16 * kk + 8 * ((lane / 8) % 2));
          ptx::mma_m16n8k16(gt[0], ca[kk], bb[0], bb[1]);
          ptx::mma_m16n8k16(gt[1], ca[kk], bb[2], bb[3]);
        }
        // ... ∘ L ∘ dt, zero above the diagonal (L by the hardware's
        // exp2: its ~1e-6 relative error is under what the gate's bf16
        // hi/lo split keeps, and exp(0) stays exactly 1)
#pragma unroll
        for (int nb = 0; nb < 2; ++nb)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int i = i0 + 8 * (e / 2);
            const int j = 16 * kb + 8 * nb + 2 * (lane % 4) + e % 2;
            gt[nb][e] = j <= i ? gt[nb][e] *
                                     __expf(cum_i[e / 2] - cum[j]) * dd[j]
                               : 0.f;
          }
        uint32_t gh[4], gl[4];
        ptx::split_bf16(gt[0][0], gt[0][1], gh[0], gl[0]);
        ptx::split_bf16(gt[0][2], gt[0][3], gh[1], gl[1]);
        ptx::split_bf16(gt[1][0], gt[1][1], gh[2], gl[2]);
        ptx::split_bf16(gt[1][2], gt[1][3], gh[3], gl[3]);
        // gate · X over these 16 rows of X's slice (read transposed)
        uint32_t xb[4];
        ptx::ldmatrix_x4_trans(xb, xd + (16 * kb + lane % 8 +
                                         8 * ((lane / 8) % 2)) * XS +
                                       8 * (lane / 16));
        ptx::mma_m16n8k16(yd[0], gh, xb[0], xb[1]);
        ptx::mma_m16n8k16(yd[0], gl, xb[0], xb[1]);
        ptx::mma_m16n8k16(yd[1], gh, xb[2], xb[3]);
        ptx::mma_m16n8k16(yd[1], gl, xb[2], xb[3]);
      }
      // C · S_prevᵀ over the state's hi and lo
#pragma unroll
      for (int kk = 0; kk < NP / 16; ++kk) {
        const int off = (8 * (lane / 16) + lane % 8) * KS + 16 * kk +
                        8 * ((lane / 8) % 2);
        uint32_t sh[4], sl[4];
        ptx::ldmatrix_x4(sh, s_hi + off);
        ptx::ldmatrix_x4(sl, s_lo + off);
        ptx::mma_m16n8k16(yo[0], ca[kk], sh[0], sh[1]);
        ptx::mma_m16n8k16(yo[0], ca[kk], sl[0], sl[1]);
        ptx::mma_m16n8k16(yo[1], ca[kk], sh[2], sh[3]);
        ptx::mma_m16n8k16(yo[1], ca[kk], sl[2], sl[3]);
      }
      bf16* y = static_cast<bf16*>(g.y);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int i = i0 + 8 * r;
        if (i >= qn) continue;
        const float in_decay = expf(cum_i[r]);
#pragma unroll
        for (int nb = 0; nb < 2; ++nb)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int p = p0 + 8 * nb + 2 * (lane % 4) + e;
            if (p < P)
              store(y + ((tok0 + i) * H + h) * P + p,
                    yd[nb][2 * r + e] + yo[nb][2 * r + e] * in_decay);
          }
      }
    }
    // ---- state on warps 4-7: S = exp(cs_last) · S_prev + (X ∘ w)ᵀ · B,
    // in registers (S_prev's hi and lo in shared memory stay for Y)
    const float decay = expf(cs_last);
#pragma unroll
    for (int k = 0; k < 2; ++k)
#pragma unroll
      for (int nb = 0; nb < 2; ++nb)
#pragma unroll
        for (int e = 0; e < 4; ++e) st[k][nb][e] *= decay;
    if (!y_warp && wr < kPairs) {
      for (int kb = 0; kb < qp / 16; ++kb) {
        // A = (X ∘ w)ᵀ: rows p of the slice, k = positions 16 kb ..
        uint32_t xa[4], ah[4], al[4];
        ptx::ldmatrix_x4_trans(xa, xd + (16 * kb + 8 * (lane / 16) +
                                         lane % 8) * XS +
                                       8 * ((lane / 8) % 2));
        const int j0 = 16 * kb + 2 * (lane % 4);
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int j = j0 + 8 * (r / 2);
          const float2 f = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(&xa[r]));
          ptx::split_bf16(f.x * wts[j], f.y * wts[j + 1], ah[r], al[r]);
        }
#pragma unroll
        for (int k = 0; k < 2; ++k) {
          const int pr = wr + 4 * k;
          if (pr >= kPairs) continue;
          uint32_t vb[4];
          ptx::ldmatrix_x4_trans(vb, bd + (16 * kb + lane % 8 +
                                           8 * ((lane / 8) % 2)) * KS +
                                         16 * pr + 8 * (lane / 16));
          ptx::mma_m16n8k16(st[k][0], ah, vb[0], vb[1]);
          ptx::mma_m16n8k16(st[k][0], al, vb[0], vb[1]);
          ptx::mma_m16n8k16(st[k][1], ah, vb[2], vb[3]);
          ptx::mma_m16n8k16(st[k][1], al, vb[2], vb[3]);
        }
      }
    }
    __syncthreads();   // warps 0-3 have read S_prev's hi and lo
    if (!y_warp && ci + 1 < n_chunks) publish();
  }

  bf16* fin = static_cast<bf16*>(g.final_state);
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const int pr = wr + 4 * k;
    if (y_warp || pr >= kPairs) continue;
#pragma unroll
    for (int nb = 0; nb < 2; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int p = p0 + lane / 4 + 8 * (e / 2);
        const int n = 16 * pr + 8 * nb + 2 * (lane % 4) + e % 2;
        if (p < P && n < N)
          store(fin + state_base + (size_t)p * N + n, st[k][nb][e]);
      }
  }
}

// ------------------------------------------------- fp32: the CUDA cores

constexpr int kF32Threads = 256;
constexpr int kGateRows = 32;   // gate rows built at once

// Shared memory of the fp32 kernel (floats): B [q][n+1] and the state
// slice [16][n+1] padded so that a warp walking a column hits 32 banks, C
// [q][n], the X slice [q][16], a [32][q] gate tile, dt, cs and w [q];
// q = min(chunk, seqlen).
struct F32Layout {
  int q, n;
  __host__ __device__ int b_off() const { return 0; }
  __host__ __device__ int c_off() const { return q * (n + 1); }
  __host__ __device__ int x_off() const { return c_off() + q * n; }
  __host__ __device__ int s_off() const { return x_off() + q * kSlice; }
  __host__ __device__ int g_off() const { return s_off() + kSlice * (n + 1); }
  __host__ __device__ int dt_off() const { return g_off() + kGateRows * q; }
  __host__ __device__ int cs_off() const { return dt_off() + q; }
  __host__ __device__ int w_off() const { return cs_off() + q; }
  __host__ __device__ size_t bytes() const { return (w_off() + q) * 4; }
};

__global__ void __launch_bounds__(kF32Threads) ssd_f32_kernel(const Args g) {
  extern __shared__ float fsm[];
  const F32Layout lay{min(g.chunk, g.seqlen), g.n_dim};
  const int N = g.n_dim, P = g.p_dim, H = g.heads, S = g.seqlen;
  const int NS = N + 1;
  float* bs = fsm + lay.b_off();     // [q][N+1]
  float* cs = fsm + lay.c_off();     // [q][N]
  float* xs = fsm + lay.x_off();     // [q][16]
  float* st = fsm + lay.s_off();     // [16][N+1]
  float* gate = fsm + lay.g_off();   // [32][q]
  float* dts = fsm + lay.dt_off();
  float* cum = fsm + lay.cs_off();
  float* wts = fsm + lay.w_off();
  const float* x = static_cast<const float*>(g.x);
  const float* b = static_cast<const float*>(g.b);
  const float* c = static_cast<const float*>(g.c);
  const float* init = static_cast<const float*>(g.init_state);
  float* y = static_cast<float*>(g.y);
  const int tid = threadIdx.x;
  const int p0 = blockIdx.x * kSlice, h = blockIdx.y, row = blockIdx.z;
  const float a_h = g.a[h];
  const size_t state_base = ((size_t)row * H + h) * P * N;

  for (int e = tid; e < kSlice * N; e += kF32Threads) {
    const int pl = e / N, n = e % N, p = p0 + pl;
    st[pl * NS + n] = init && p < P ? init[state_base + (size_t)p * N + n]
                                    : 0.f;
  }
  for (int c0 = 0; c0 < S; c0 += g.chunk) {
    const int qn = min(g.chunk, S - c0);   // rows of this chunk
    const size_t tok0 = (size_t)row * S + c0;
    __syncthreads();   // the previous chunk is done with shared memory
    for (int i = tid; i < qn; i += kF32Threads)
      dts[i] = g.dt[(tok0 + i) * H + h];
    for (int e = tid; e < qn * N; e += kF32Threads) {
      const int i = e / N, n = e % N;
      const size_t src = ((tok0 + i) * H + h) * N + n;
      bs[i * NS + n] = b[src];
      cs[e] = c[src];
    }
    for (int e = tid; e < qn * kSlice; e += kF32Threads) {
      const int i = e / kSlice, pl = e % kSlice;
      xs[e] = p0 + pl < P ? x[((tok0 + i) * H + h) * P + p0 + pl] : 0.f;
    }
    __syncthreads();
    if (tid < 32) chunk_cumsum(dts, a_h, cum, qn, tid);
    __syncthreads();
    const float cs_last = cum[qn - 1];
    for (int i = tid; i < qn; i += kF32Threads)
      wts[i] = dts[i] * expf(cs_last - cum[i]);

    for (int i0 = 0; i0 < qn; i0 += kGateRows) {
      const int rows = min(kGateRows, qn - i0);
      const int cols = min(i0 + kGateRows, qn);   // the gate is 0 past i
      // gate rows: (C·Bᵀ)[i, j] · exp(cs[i] - cs[j]) · dt[j], j <= i
      for (int e = tid; e < rows * cols; e += kF32Threads) {
        const int r = e / cols, j = e % cols, i = i0 + r;
        float gv = 0.f;
        if (j <= i) {
          float acc = 0.f;
          for (int n = 0; n < N; ++n)
            acc = fmaf(cs[i * N + n], bs[j * NS + n], acc);
          gv = acc * expf(cum[i] - cum[j]) * dts[j];
        }
        gate[r * lay.q + j] = gv;
      }
      __syncthreads();
      // outputs of these rows: gate · X + exp(cs) ∘ (C · S_prevᵀ)
      for (int e = tid; e < rows * kSlice; e += kF32Threads) {
        const int r = e / kSlice, pl = e % kSlice, i = i0 + r;
        float yd = 0.f, yo = 0.f;
        for (int j = 0; j <= i; ++j)
          yd = fmaf(gate[r * lay.q + j], xs[j * kSlice + pl], yd);
        for (int n = 0; n < N; ++n)
          yo = fmaf(cs[i * N + n], st[pl * NS + n], yo);
        if (p0 + pl < P)
          y[((tok0 + i) * H + h) * P + p0 + pl] = yd + yo * expf(cum[i]);
      }
      __syncthreads();   // the gate tile and S_prev are free again
    }

    // state: S = exp(cs_last) · S_prev + Xᵀ · (B ∘ w)
    const float decay = expf(cs_last);
    for (int e = tid; e < kSlice * N; e += kF32Threads) {
      const int pl = e / N, n = e % N;
      float acc = 0.f;
      for (int j = 0; j < qn; ++j)
        acc = fmaf(xs[j * kSlice + pl], bs[j * NS + n] * wts[j], acc);
      float* sp = st + pl * NS + n;
      *sp = *sp * decay + acc;
    }
  }
  __syncthreads();
  float* fin = static_cast<float*>(g.final_state);
  for (int e = tid; e < kSlice * N; e += kF32Threads) {
    const int pl = e / N, n = e % N, p = p0 + pl;
    if (p < P) fin[state_base + (size_t)p * N + n] = st[pl * NS + n];
  }
}

// Whether this library has raised each kernel's dynamic shared memory
// limit (internal linkage: one flag per library).
template <int NP>
bool mma_raised = false;
bool f32_raised = false;

template <int NP>
int launch_mma(const Args& g, dim3 grid, cudaStream_t s) {
  const auto kernel = ssd_mma_kernel<NP>;
  if (!mma_raised<NP>) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
    if (err != cudaSuccess) return (int)err;
    mma_raised<NP> = true;
  }
  kernel<<<grid, kMmaThreads, mma_layout(g).bytes(), s>>>(g);
  return (int)cudaGetLastError();
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

}  // namespace

// Returns the cudaError_t of the launch (0 on success). dtype: 0 = fp32,
// 1 = bf16 for x, b, c, y and both states; dt and a are fp32.
// init_state may be null (a zero start); final_state is always written.
// x [batch, seqlen, heads, p_dim]; dt [batch, seqlen, heads]; a [heads];
// b, c [batch, seqlen, heads, n_dim]; states [batch, heads, p_dim, n_dim].
// The grid is (ceil(p_dim / 16), heads, batch). The caller has checked
// shapes, dtypes and contiguity.
extern "C" int ssd_scan_launch(int dtype, const void* x, const void* dt,
                               const void* a, const void* b, const void* c,
                               const void* init_state, void* y,
                               void* final_state, int batch, int seqlen,
                               int heads, int p_dim, int n_dim, int chunk,
                               void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (chunk < 1 || chunk > kMaxDim || p_dim < 1 || p_dim > kMaxDim ||
      n_dim < 1 || n_dim > kMaxDim || seqlen < 0 || batch < 1 ||
      batch > 65535 || heads < 1 || heads > 65535)
    return (int)cudaErrorInvalidValue;
  Args g{x, (const float*)dt, (const float*)a, b, c, init_state, y,
         final_state, seqlen, heads, p_dim, n_dim, chunk, 0};
  const dim3 grid((p_dim + kSlice - 1) / kSlice, heads, batch);
  if (dtype == 1) {
    g.vec = n_dim % 8 == 0 && p_dim % 8 == 0 && aligned16(x) &&
            aligned16(b) && aligned16(c);
    if (mma_layout(g).bytes() > (size_t)kMaxSmem)
      return (int)cudaErrorInvalidValue;
    switch (padded_n(n_dim)) {
      case 16: return launch_mma<16>(g, grid, s);
      case 32: return launch_mma<32>(g, grid, s);
      case 64: return launch_mma<64>(g, grid, s);
      default: return launch_mma<128>(g, grid, s);
    }
  }
  if (dtype != 0) return (int)cudaErrorInvalidValue;
  const F32Layout lay{imin(chunk, seqlen), n_dim};
  if (lay.bytes() > (size_t)kMaxSmem) return (int)cudaErrorInvalidValue;
  if (!f32_raised) {
    const cudaError_t err = cudaFuncSetAttribute(
        ssd_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kMaxSmem);
    if (err != cudaSuccess) return (int)err;
    f32_raised = true;
  }
  ssd_f32_kernel<<<grid, kF32Threads, lay.bytes(), s>>>(g);
  return (int)cudaGetLastError();
}
