// The gradient of the dense flash prefill (kernel K5) for Hopper (sm_90a):
// dQ, dK and dV of causal or non-causal GQA attention over a whole
// sequence, q [B, S, H, hd] against k, v [B, S, Hkv, hd], Hkv dividing H,
// from the forward's output O, its log-sum-exp and the output's gradient
// dO. bf16 runs on the tensor cores (wgmma fed by TMA, fp32
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
//   * bwd_dot: D = rowsum(dO * O) in fp32 with 16-byte loads, several rows
//     a warp; for bf16 it also copies the LSE in log2 units beside D into
//     a [2][B][H][S padded to 64] scratch, the rows the bf16 kernels
//     bulk-load with their query tiles;
//   * dK/dV: one CTA per (key tile, KV head, batch), the tiles of the
//     first keys (the longest causal walks) launched first. It loops over
//     the GQA group's query heads and the query tiles that can see its
//     keys and accumulates dV and dK for them. The group's heads are
//     summed inside the CTA in a fixed order, so nothing is accumulated
//     with atomics and the gradients are the same bits from run to run;
//   * dQ: one CTA per (query tile, query head, batch), the tiles of the
//     last rows (the longest causal walks) launched first, over the keys
//     its rows see. dQ is summed here and not in the dK/dV kernel: there
//     a query tile's dQ would gather the shares of every key tile's CTA,
//     which takes float atomics (an order that changes from run to run)
//     or a fixed-order hand-off between CTAs. This kernel recomputes S
//     and dP instead and is deterministic by construction.
//
// bf16 design (dkdv_wgmma_kernel, dq_wgmma_kernel), after the forward
// (flash_prefill_sm90.cu): thread 0 issues every TMA load
// (cp.async.bulk.tensor onto mbarriers), warpgroups of 64 rows run wgmma
// on what has landed and release each stage of the ring; thread 0 refills
// the stage of the step before the one just finished. There is no
// producer warp: a ninth warp puts three warps on one of the SM's four
// register quarters and caps a thread at 168 registers, where dK and dV
// of 128 columns alone take 128; eight warps leave 255.
//   * dK/dV: a CTA holds its keys' K and V, loaded once, and streams
//     query tiles of Q and dO (64 rows; 32 at head_dim 256) with their
//     LSE and D rows (bulk copies) through a ring of 3-4 stages. Each
//     warpgroup owns 64 keys: S^T = K Q^T and dP^T = V dO^T are wgmma
//     with both operands in shared memory; P^T and dS^T = P^T (dP^T - D)
//     stay in registers as the A operand of dV += P^T dO and dK += dS^T Q,
//     whose B operands are the stage's dO and Q read transposed. At
//     head_dim <= 128 two warpgroups own 64 keys each (128 keys a CTA);
//     at 256 both own the same 64 keys and split dK's and dV's columns,
//     each computing S^T and dP^T (dK and dV of 256 columns would be 256
//     accumulator registers a thread). A warpgroup that no query of a
//     tile sees (causal) waits for the tile and releases it untouched.
//   * dQ: a CTA holds 128 rows of one query head (two warpgroups; 64 rows
//     and one at head_dim 256) with their dO, loaded once, and streams
//     64-key K and V tiles up to its causal horizon: S = Q K^T and dP =
//     dO V^T (shared operands), dS in registers, dQ += dS K with K read
//     transposed. (Issuing the next tile's S and dP right behind this
//     tile's dQ product, a two-deep software pipeline, was slower: 0.416
//     against 0.352 ms at r1-distill-14b's shape, PERF.md.)
//   * Every head_dim (32, 64, 128, 256) takes these kernels: no shape
//     keeps a warp-level mma.sync kernel. Head_dim 32 reads 64-byte
//     swizzled rows, the others 128-byte ones.
//   * No stale value reaches a tensor core (0 * NaN = NaN): the tensor
//     maps of Q, dO, K and V end at true_len, so the TMA unit fills every
//     row past it with zeros, and masked P and dS are exact zeros.
//
// bf16 numerics: S and dP take the bf16 inputs with fp32 accumulators; P
// (fp32, from exp2 with the scale folded into the exponent) and dS (fp32)
// are rounded to bf16 only where they become the A operand of dV, dK and
// dQ, as FlashAttention does; dQ, dK and dV are accumulated in fp32 and
// rounded to bf16 once. fp32 runs every product in fp32 FMAs.
//
// What bounds it on this card: operations. The function needs five
// products of 2 hd operations per (row, visible key); the kernels run 7
// (S and dP in both the dK/dV and the dQ kernel), 9 at head_dim 256
// (both warpgroups of a dK/dV CTA compute them). At r1-distill-14b's
// training shape (B=2, S=2048, 40/8 heads of 128, causal) that is 215
// GFLOP for the function, 0.217 ms at 989 TFLOP/s.
#include "flash_sm90.cuh"
#include "hopper_ptx.cuh"
#include "launch_check.cuh"

namespace {

using bf16 = __nv_bfloat16;
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kMaxSmem = 232448;    // what a block may take on the H100
constexpr int kPad = 64;            // bf16's LSE and D rows: S padded to it

// ------------------------------------------------------------- D pass

// The dot product of two 16-byte vectors of T, in fp32.
template <typename T>
__device__ __forceinline__ float dot16(const uint4& a, const uint4& b);
template <>
__device__ __forceinline__ float dot16<bf16>(const uint4& a, const uint4& b) {
  const __nv_bfloat162* x = reinterpret_cast<const __nv_bfloat162*>(&a);
  const __nv_bfloat162* y = reinterpret_cast<const __nv_bfloat162*>(&b);
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 u = __bfloat1622float2(x[i]), w = __bfloat1622float2(y[i]);
    s = fmaf(u.x, w.x, s);
    s = fmaf(u.y, w.y, s);
  }
  return s;
}
template <>
__device__ __forceinline__ float dot16<float>(const uint4& a,
                                              const uint4& b) {
  const float4 u = *reinterpret_cast<const float4*>(&a);
  const float4 w = *reinterpret_cast<const float4*>(&b);
  return fmaf(u.x, w.x, fmaf(u.y, w.y, fmaf(u.z, w.z, u.w * w.w)));
}

// kTpr threads a row, each kVecs / kTpr 16-byte vectors of O and dO; a
// block takes kPasses groups of 256 / kTpr rows, all its loads in flight
// before the first sum.
template <typename T, int HD>
struct Dot {
  static constexpr int kVecs = HD * (int)sizeof(T) / 16;
  static constexpr int kTpr = kVecs < 32 ? kVecs : 32;
  static constexpr int kPer = kVecs / kTpr;
  static constexpr int kPasses = 2;
  static constexpr int kRowsPerPass = 256 / kTpr;
  static constexpr int kRowsPerBlock = kRowsPerPass * kPasses;
};

// Grid row r is (b, head, pos) = (r / (H rows_pos), (r / rows_pos) % H,
// r % rows_pos), the layout of delta (and lse2), [batch, q_heads,
// rows_pos], so that a warp's writes are contiguous (each row of O and dO
// is whole 128-byte lines either way): rows_pos = seqlen for fp32, S
// padded to kPad for bf16, which also writes LSE * log2(e) into lse2.
// Positions at or past true_len get 0 in both.
// (two blocks an SM at least: without a minimum ptxas caps the kernel at
// 64 registers, and its fp32 instantiations spill)
template <typename T, int HD>
__global__ void __launch_bounds__(256, 2) bwd_dot_kernel(
    const T* __restrict__ out, const T* __restrict__ dout,
    const float* __restrict__ lse, float* __restrict__ delta,
    float* __restrict__ lse2, int batch, int seqlen, int rows_pos,
    int q_heads, int true_len) {
  using D = Dot<T, HD>;
  // 32-bit row arithmetic (the launcher refuses more rows): a 64-bit
  // division is a subroutine with a stack frame
  const int total = batch * rows_pos * q_heads;
  const int sub = threadIdx.x % D::kTpr;
  int row[D::kPasses];
  uint4 o[D::kPasses][D::kPer], g[D::kPasses][D::kPer];
#pragma unroll
  for (int r = 0; r < D::kPasses; ++r) {
    row[r] = blockIdx.x * D::kRowsPerBlock + r * D::kRowsPerPass +
             threadIdx.x / D::kTpr;
    const int pos = row[r] % rows_pos;
    const int head = (row[r] / rows_pos) % q_heads;
    const int b = row[r] / (q_heads * rows_pos);
    const bool live = row[r] < total && pos < true_len;
    const size_t at = (((size_t)b * seqlen + pos) * q_heads + head) * HD;
    const uint4* op = reinterpret_cast<const uint4*>(out + at);
    const uint4* gp = reinterpret_cast<const uint4*>(dout + at);
#pragma unroll
    for (int i = 0; i < D::kPer; ++i) {
      o[r][i] = live ? op[sub + i * D::kTpr] : make_uint4(0u, 0u, 0u, 0u);
      g[r][i] = live ? gp[sub + i * D::kTpr] : make_uint4(0u, 0u, 0u, 0u);
    }
  }
#pragma unroll
  for (int r = 0; r < D::kPasses; ++r) {
    float sum = 0.f;
#pragma unroll
    for (int i = 0; i < D::kPer; ++i) sum += dot16<T>(o[r][i], g[r][i]);
#pragma unroll
    for (int off = D::kTpr / 2; off > 0; off >>= 1)
      sum += __shfl_xor_sync(0xffffffffu, sum, off);
    if (row[r] < total && sub == 0) {
      const int pos = row[r] % rows_pos;
      const int hr = row[r] / rows_pos;   // b q_heads + head
      delta[row[r]] = pos < true_len ? sum : 0.f;
      if (lse2 != nullptr)
        lse2[row[r]] =
            pos < true_len ? lse[(size_t)hr * seqlen + pos] * kLog2e : 0.f;
    }
  }
}

// ------------------------------------------------------- bf16 (wgmma)

// The dK/dV kernel's tiling (see the header): kCols columns of dK and dV
// a warpgroup, kKeys keys a CTA, query tiles of kQT rows through kStages.
template <int HD>
struct KvCfg {
  using G = Geo<HD>;
  static constexpr int kCols = HD <= 128 ? HD : 128;
  static constexpr int kColWgs = HD / kCols;          // warpgroups a key
  static constexpr int kKeys = 64 * (2 / kColWgs);    // 128, or 64 at 256
  static constexpr int kQT = HD == 256 ? 32 : 64;
  static constexpr int kStages = HD <= 64 ? 4 : 3;
  static constexpr int kKPart = kKeys * G::kRowBytes;
  static constexpr int kKBytes = kKeys * HD * 2;
  static constexpr int kQPart = kQT * G::kRowBytes;
  static constexpr int kQBytes = kQT * HD * 2;
  static constexpr int k_off = 0;
  static constexpr int v_off = kKBytes;
  static constexpr int q_off = 2 * kKBytes;
  static constexpr int do_off = q_off + kStages * kQBytes;
  // per stage the tile's LSE * log2(e), then its D: [kStages][2][kQT]
  static constexpr int vec_off = do_off + kStages * kQBytes;
  static constexpr int bar_off = vec_off + kStages * 2 * kQT * 4;
  // kv_full, full[kStages], empty[kStages]
  static constexpr int bytes = bar_off + 8 * (1 + 2 * kStages) + 1024;
};

template <int HD>
__global__ void __launch_bounds__(256, 1) dkdv_wgmma_kernel(
    const __grid_constant__ CUtensorMap tm_q,
    const __grid_constant__ CUtensorMap tm_k,
    const __grid_constant__ CUtensorMap tm_v,
    const __grid_constant__ CUtensorMap tm_do, const float* __restrict__ dl,
    bf16* __restrict__ dk, bf16* __restrict__ dv, int seqlen, int s_pad,
    int q_heads, int kv_heads, int true_len, int causal, float scale) {
  using G = Geo<HD>;
  using C = KvCfg<HD>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align_1024(smem_raw);
  uint8_t* sk = smem + C::k_off;
  uint8_t* sv = smem + C::v_off;
  uint8_t* sq = smem + C::q_off;
  uint8_t* sdo = smem + C::do_off;
  float* svec = reinterpret_cast<float*>(smem + C::vec_off);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + C::bar_off);
  uint64_t* kv_full = bars;
  uint64_t* full = bars + 1;
  uint64_t* empty = bars + 1 + C::kStages;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int h = blockIdx.x, b = blockIdx.y;
  const int k0 = blockIdx.z * C::kKeys;
  const int group = q_heads / kv_heads;
  const int n = true_len;
  // the query tiles that can see a key of this CTA, for each of the
  // group's heads
  const int qt0 = causal ? k0 / C::kQT : 0;
  const int n_qt = k0 < n ? (n + C::kQT - 1) / C::kQT - qt0 : 0;
  const int n_steps = group * n_qt;
  const size_t plane = (size_t)gridDim.y * q_heads * s_pad;   // D's offset

  if (tid == 0) {
    ptx::mbar_init(kv_full, 1);
    for (int s = 0; s < C::kStages; ++s) {
      ptx::mbar_init(full + s, 1);
      ptx::mbar_init(empty + s, 8);   // one arrival per warp
    }
    ptx::fence_barrier_init();
  }
  __syncthreads();

  // Thread 0 issues every load: step t's query tile of Q and dO, with
  // its LSE and D rows, into stage t % kStages
  auto issue = [&](int t) {
    const int s = t % C::kStages;
    const int head = h * group + t / n_qt;
    const int q0 = (qt0 + t % n_qt) * C::kQT;
    ptx::mbar_expect_tx(full + s, 2 * C::kQBytes + 2 * C::kQT * 4);
    for (int p = 0; p < G::kParts; ++p) {
      ptx::tma_load_4d(sq + s * C::kQBytes + p * C::kQPart, &tm_q, full + s,
                       p * G::kBlk, head, q0, b);
      ptx::tma_load_4d(sdo + s * C::kQBytes + p * C::kQPart, &tm_do,
                       full + s, p * G::kBlk, head, q0, b);
    }
    const float* src = dl + ((size_t)b * q_heads + head) * s_pad + q0;
    float* dst = svec + s * 2 * C::kQT;
    ptx::bulk_load(dst, src, C::kQT * 4, full + s);
    ptx::bulk_load(dst + C::kQT, src + plane, C::kQT * 4, full + s);
  };
  if (tid == 0 && n_steps > 0) {
    ptx::mbar_expect_tx(kv_full, 2 * C::kKBytes);
    for (int p = 0; p < G::kParts; ++p) {
      ptx::tma_load_4d(sk + p * C::kKPart, &tm_k, kv_full, p * G::kBlk, h,
                       k0, b);
      ptx::tma_load_4d(sv + p * C::kKPart, &tm_v, kv_full, p * G::kBlk, h,
                       k0, b);
    }
    for (int t = 0; t < min(C::kStages, n_steps); ++t) issue(t);
  }

  // ---- warpgroup wg owns keys kfirst .. kfirst + 63 and dK/dV columns
  // c0 .. c0 + kCols - 1; this thread holds keys key[0] and key[1] =
  // key[0] + 8 of the accumulators
  const int wg = warp / 4;
  const int kfirst = k0 + 64 * (wg / C::kColWgs);
  const int c0 = (wg % C::kColWgs) * C::kCols;
  int key[2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
    key[i] = kfirst + (warp % 4) * 16 + lane / 4 + 8 * i;
  constexpr int kAcc = C::kCols / 2;
  constexpr int kS = C::kQT / 2;
  float acc_v[kAcc], acc_k[kAcc];
#pragma unroll
  for (int i = 0; i < kAcc; ++i) acc_v[i] = acc_k[i] = 0.f;
  const float scale_log2 = scale * kLog2e;
  const uint8_t* sk_wg = sk + (kfirst - k0) * G::kRowBytes;
  const uint8_t* sv_wg = sv + (kfirst - k0) * G::kRowBytes;

  if (n_steps > 0) ptx::mbar_wait(kv_full, 0);
  for (int t = 0; t < n_steps; ++t) {
    const int s = t % C::kStages;
    const int q0 = (qt0 + t % n_qt) * C::kQT;
    ptx::mbar_wait(full + s, (t / C::kStages) & 1);
    // no query of the tile sees a key of this warpgroup: release it
    const bool idle = kfirst >= n || (causal && q0 + C::kQT <= kfirst);
    if (!idle) {
      const uint8_t* q_t = sq + s * C::kQBytes;
      const uint8_t* do_t = sdo + s * C::kQBytes;
      const float* l2 = svec + s * 2 * C::kQT;
      const float* dd = l2 + C::kQT;

      // S^T = K Q^T and dP^T = V dO^T over head_dim in steps of 16
      float st[kS], dpt[kS];
#pragma unroll
      for (int i = 0; i < kS; ++i) st[i] = dpt[i] = 0.f;
      ptx::fence_operands<kS>(st);
      ptx::fence_operands<kS>(dpt);
      ptx::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        const int at = kk * 16 / G::kBlk, off = (kk * 16 % G::kBlk) * 2;
        ptx::wgmma_ss<C::kQT>(
            st,
            ptx::wgmma_desc(sk_wg + at * C::kKPart + off, 0, G::kSbo,
                            G::kSwizzle),
            ptx::wgmma_desc(q_t + at * C::kQPart + off, 0, G::kSbo,
                            G::kSwizzle),
            kk > 0);
      }
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        const int at = kk * 16 / G::kBlk, off = (kk * 16 % G::kBlk) * 2;
        ptx::wgmma_ss<C::kQT>(
            dpt,
            ptx::wgmma_desc(sv_wg + at * C::kKPart + off, 0, G::kSbo,
                            G::kSwizzle),
            ptx::wgmma_desc(do_t + at * C::kQPart + off, 0, G::kSbo,
                            G::kSwizzle),
            kk > 0);
      }
      ptx::wgmma_commit();
      ptx::wgmma_wait_all();
      ptx::fence_operands<kS>(st);
      ptx::fence_operands<kS>(dpt);

      // P^T and dS^T: element 4j + 2i + e is key key[i], query q0 + 8j +
      // 2 (lane % 4) + e. Masks only on tiles that cross the diagonal or
      // true_len.
      const bool edge = (causal && q0 < kfirst + 63) || q0 + C::kQT > n ||
                        kfirst + 64 > n;
#pragma unroll
      for (int j = 0; j < C::kQT / 8; ++j) {
        const int qc = 8 * j + 2 * (lane % 4);
        const float2 lv = *reinterpret_cast<const float2*>(l2 + qc);
        const float2 dv2 = *reinterpret_cast<const float2*>(dd + qc);
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int x = 4 * j + 2 * i + e;
            float p = exp2f(fmaf(st[x], scale_log2, -(e ? lv.y : lv.x)));
            if (edge) {
              const int qi = q0 + qc + e;
              const bool vis =
                  qi < n && key[i] < n && (!causal || key[i] <= qi);
              p = vis ? p : 0.f;
            }
            st[x] = p;
            dpt[x] = p * (dpt[x] - (e ? dv2.y : dv2.x));
          }
      }
      // P^T and dS^T as bf16 A fragments, 16 queries per step
      uint32_t pf[C::kQT / 16][4], sf[C::kQT / 16][4];
#pragma unroll
      for (int kk = 0; kk < C::kQT / 16; ++kk)
#pragma unroll
        for (int x = 0; x < 4; ++x) {
          pf[kk][x] = ptx::pack_bf16(st[8 * kk + 2 * x],
                                     st[8 * kk + 2 * x + 1]);
          sf[kk][x] = ptx::pack_bf16(dpt[8 * kk + 2 * x],
                                     dpt[8 * kk + 2 * x + 1]);
        }

      // dV += P^T dO and dK += dS^T Q, dO and Q read transposed: 16
      // queries of rows kRowBytes apart, column parts kQPart apart
      ptx::fence_operands<kAcc>(acc_v);
      ptx::fence_operands<kAcc>(acc_k);
      ptx::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < C::kQT / 16; ++kk) {
        const int at = (c0 / G::kBlk) * C::kQPart + kk * 16 * G::kRowBytes;
        ptx::wgmma_rs_tb<C::kCols>(
            acc_v, pf[kk],
            ptx::wgmma_desc(do_t + at, C::kQPart, G::kSbo, G::kSwizzle));
        ptx::wgmma_rs_tb<C::kCols>(
            acc_k, sf[kk],
            ptx::wgmma_desc(q_t + at, C::kQPart, G::kSbo, G::kSwizzle));
      }
      ptx::wgmma_commit();
      ptx::wgmma_wait_all();
      ptx::fence_operands<kAcc>(acc_v);
      ptx::fence_operands<kAcc>(acc_k);
      // the A fragments stay live until the products that read them end
      ptx::fence_regs<C::kQT / 4>(&pf[0][0]);
      ptx::fence_regs<C::kQT / 4>(&sf[0][0]);
    }
    __syncwarp();
    if (lane == 0) ptx::mbar_arrive(empty + s);   // this warp is done
    // refill the stage of step t - 1, which both warpgroups have most
    // likely released by now, with step t - 1 + kStages
    const int r = t - 1 + C::kStages;
    if (tid == 0 && t >= 1 && r < n_steps) {
      ptx::mbar_wait(empty + (t - 1) % C::kStages,
                     ((t - 1) / C::kStages) & 1);
      issue(r);
    }
    __syncwarp();
  }

  // epilogue: every key below seqlen is written (zeros where no query
  // sees it)
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (key[i] >= seqlen) continue;
    const size_t at = (((size_t)b * seqlen + key[i]) * kv_heads + h) * HD +
                      c0 + 2 * (lane % 4);
#pragma unroll
    for (int j = 0; j < C::kCols / 8; ++j) {
      *reinterpret_cast<__nv_bfloat162*>(dk + at + 8 * j) =
          __floats2bfloat162_rn(acc_k[4 * j + 2 * i] * scale,
                                acc_k[4 * j + 2 * i + 1] * scale);
      *reinterpret_cast<__nv_bfloat162*>(dv + at + 8 * j) =
          __floats2bfloat162_rn(acc_v[4 * j + 2 * i],
                                acc_v[4 * j + 2 * i + 1]);
    }
  }
}

// The dQ kernel's tiling: kNwg warpgroups of 64 rows of one query head,
// 64-key K and V tiles through kStages.
template <int HD>
struct QCfg {
  using G = Geo<HD>;
  static constexpr int kNwg = HD == 256 ? 1 : 2;
  static constexpr int kRows = 64 * kNwg;
  static constexpr int kStages = HD == 256 ? 2 : (HD == 128 ? 3 : 4);
  static constexpr int kQPart = kRows * G::kRowBytes;
  static constexpr int kQBytes = kRows * HD * 2;
  static constexpr int q_off = 0;
  static constexpr int do_off = kQBytes;
  static constexpr int k_off = 2 * kQBytes;
  static constexpr int v_off = k_off + kStages * G::kKvBytes;
  static constexpr int bar_off = v_off + kStages * G::kKvBytes;
  // q_full, full[kStages], empty[kStages]
  static constexpr int bytes = bar_off + 8 * (1 + 2 * kStages) + 1024;
};

template <int HD>
__global__ void __launch_bounds__(QCfg<HD>::kNwg * 128, 1)
    dq_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                    const __grid_constant__ CUtensorMap tm_k,
                    const __grid_constant__ CUtensorMap tm_v,
                    const __grid_constant__ CUtensorMap tm_do,
                    const float* __restrict__ dl, bf16* __restrict__ dq,
                    int seqlen, int s_pad, int q_heads, int kv_heads,
                    int true_len, int causal, float scale) {
  using G = Geo<HD>;
  using C = QCfg<HD>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align_1024(smem_raw);
  uint8_t* sq = smem + C::q_off;
  uint8_t* sdo = smem + C::do_off;
  uint8_t* sk = smem + C::k_off;
  uint8_t* sv = smem + C::v_off;
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + C::bar_off);
  uint64_t* q_full = bars;
  uint64_t* full = bars + 1;
  uint64_t* empty = bars + 1 + C::kStages;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int head = blockIdx.x, b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * C::kRows;
  const int group = q_heads / kv_heads;
  const int n = true_len;
  const int kv_end = q0 >= n ? 0 : (causal ? min(q0 + C::kRows, n) : n);
  const int n_tiles = (kv_end + 63) / 64;

  if (tid == 0) {
    ptx::mbar_init(q_full, 1);
    for (int s = 0; s < C::kStages; ++s) {
      ptx::mbar_init(full + s, 1);
      ptx::mbar_init(empty + s, C::kNwg * 4);   // one arrival per warp
    }
    ptx::fence_barrier_init();
  }
  __syncthreads();

  // Thread 0 issues every load: key tile t of K and V into stage t %
  // kStages
  auto issue = [&](int t) {
    const int s = t % C::kStages;
    ptx::mbar_expect_tx(full + s, 2 * G::kKvBytes);
    for (int p = 0; p < G::kParts; ++p) {
      ptx::tma_load_4d(sk + s * G::kKvBytes + p * G::kKvPart, &tm_k,
                       full + s, p * G::kBlk, head / group, t * 64, b);
      ptx::tma_load_4d(sv + s * G::kKvBytes + p * G::kKvPart, &tm_v,
                       full + s, p * G::kBlk, head / group, t * 64, b);
    }
  };
  if (tid == 0 && n_tiles > 0) {
    ptx::mbar_expect_tx(q_full, 2 * C::kQBytes);
    for (int p = 0; p < G::kParts; ++p) {
      ptx::tma_load_4d(sq + p * C::kQPart, &tm_q, q_full, p * G::kBlk,
                       head, q0, b);
      ptx::tma_load_4d(sdo + p * C::kQPart, &tm_do, q_full, p * G::kBlk,
                       head, q0, b);
    }
    for (int t = 0; t < min(C::kStages, n_tiles); ++t) issue(t);
  }

  // ---- warpgroup wg owns rows rfirst .. rfirst + 63; this thread holds
  // rows row[0] and row[1] = row[0] + 8
  const int wg = warp / 4;
  const int rfirst = q0 + wg * 64;
  int row[2];
  float l2[2], dd[2];
  const size_t hr = (size_t)b * q_heads + head;
  const size_t plane = (size_t)gridDim.y * q_heads * s_pad;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    row[i] = rfirst + (warp % 4) * 16 + lane / 4 + 8 * i;
    l2[i] = row[i] < n ? dl[hr * s_pad + row[i]] : 0.f;
    dd[i] = row[i] < n ? dl[plane + hr * s_pad + row[i]] : 0.f;
  }
  constexpr int kAcc = HD / 2;
  float acc[kAcc];
#pragma unroll
  for (int i = 0; i < kAcc; ++i) acc[i] = 0.f;
  const float scale_log2 = scale * kLog2e;
  const uint8_t* sq_wg = sq + wg * 64 * G::kRowBytes;
  const uint8_t* sdo_wg = sdo + wg * 64 * G::kRowBytes;

  if (n_tiles > 0) ptx::mbar_wait(q_full, 0);
  for (int t = 0; t < n_tiles; ++t) {
    const int s = t % C::kStages;
    const int kt0 = t * 64;
    ptx::mbar_wait(full + s, (t / C::kStages) & 1);
    // no row of this warpgroup sees a key of the tile: release it
    const bool idle = rfirst >= n || (causal && kt0 > rfirst + 63);
    if (!idle) {
      const uint8_t* k_t = sk + s * G::kKvBytes;
      const uint8_t* v_t = sv + s * G::kKvBytes;
      float sc[32], dp[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) sc[i] = dp[i] = 0.f;
      ptx::fence_operands<32>(sc);
      ptx::fence_operands<32>(dp);
      ptx::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        const int at = kk * 16 / G::kBlk, off = (kk * 16 % G::kBlk) * 2;
        ptx::wgmma_m64n64k16_ss(
            sc,
            ptx::wgmma_desc(sq_wg + at * C::kQPart + off, 0, G::kSbo,
                            G::kSwizzle),
            ptx::wgmma_desc(k_t + at * G::kKvPart + off, 0, G::kSbo,
                            G::kSwizzle),
            kk > 0);
      }
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        const int at = kk * 16 / G::kBlk, off = (kk * 16 % G::kBlk) * 2;
        ptx::wgmma_m64n64k16_ss(
            dp,
            ptx::wgmma_desc(sdo_wg + at * C::kQPart + off, 0, G::kSbo,
                            G::kSwizzle),
            ptx::wgmma_desc(v_t + at * G::kKvPart + off, 0, G::kSbo,
                            G::kSwizzle),
            kk > 0);
      }
      ptx::wgmma_commit();
      ptx::wgmma_wait_all();
      ptx::fence_operands<32>(sc);
      ptx::fence_operands<32>(dp);

      // dS: element 4j + 2i + e is row row[i], key kt0 + 8j + 2 (lane %
      // 4) + e
      const bool edge = (causal && kt0 + 63 > rfirst) || kt0 + 64 > n ||
                        rfirst + 64 > n;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int x = 4 * j + 2 * i + e;
            float p = exp2f(fmaf(sc[x], scale_log2, -l2[i]));
            if (edge) {
              const int key = kt0 + 8 * j + 2 * (lane % 4) + e;
              const bool vis =
                  row[i] < n && key < n && (!causal || key <= row[i]);
              p = vis ? p : 0.f;
            }
            dp[x] = p * (dp[x] - dd[i]);
          }
      uint32_t sf[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int x = 0; x < 4; ++x)
          sf[kk][x] = ptx::pack_bf16(dp[8 * kk + 2 * x],
                                     dp[8 * kk + 2 * x + 1]);

      // dQ += dS K, K read transposed: 16 keys of rows kRowBytes apart
      ptx::fence_operands<kAcc>(acc);
      ptx::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const uint8_t* kb = k_t + kk * 16 * G::kRowBytes;
        if constexpr (HD == 256) {
          // two N = 128 halves: columns 0-127 (parts 0-1), then 128-255
          ptx::wgmma_rs_tb<128>(
              acc, sf[kk],
              ptx::wgmma_desc(kb, G::kKvPart, G::kSbo, G::kSwizzle));
          ptx::wgmma_rs_tb<128>(
              acc + 64, sf[kk],
              ptx::wgmma_desc(kb + 2 * G::kKvPart, G::kKvPart, G::kSbo,
                              G::kSwizzle));
        } else {
          ptx::wgmma_rs_tb<HD>(
              acc, sf[kk],
              ptx::wgmma_desc(kb, G::kKvPart, G::kSbo, G::kSwizzle));
        }
      }
      ptx::wgmma_commit();
      ptx::wgmma_wait_all();
      ptx::fence_operands<kAcc>(acc);
      ptx::fence_regs<16>(&sf[0][0]);
    }
    __syncwarp();
    if (lane == 0) ptx::mbar_arrive(empty + s);
    // refill the stage of tile t - 1 with tile t - 1 + kStages
    const int r = t - 1 + C::kStages;
    if (tid == 0 && t >= 1 && r < n_tiles) {
      ptx::mbar_wait(empty + (t - 1) % C::kStages,
                     ((t - 1) / C::kStages) & 1);
      issue(r);
    }
    __syncwarp();
  }

  // epilogue: every row below seqlen is written (zeros past true_len)
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (row[i] >= seqlen) continue;
    bf16* dst = dq + (((size_t)b * seqlen + row[i]) * q_heads + head) * HD +
                2 * (lane % 4);
#pragma unroll
    for (int j = 0; j < HD / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(dst + 8 * j) =
          __floats2bfloat162_rn(acc[4 * j + 2 * i] * scale,
                                acc[4 * j + 2 * i + 1] * scale);
  }
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

// The grids of one call's three launches (D pass, dK/dV, dQ), as the
// wrapper's flash_prefill_bwd_grid describes them.
template <int HD>
void grids_of(int dtype, int batch, int seqlen, int q_heads, int kv_heads,
              dim3* g) {
  if (dtype == 1) {
    const int rows = batch * ((seqlen + kPad - 1) / kPad * kPad) * q_heads;
    constexpr int per = Dot<bf16, HD>::kRowsPerBlock;
    g[0] = dim3((rows + per - 1) / per);
    g[1] = dim3(kv_heads, batch,
                (seqlen + KvCfg<HD>::kKeys - 1) / KvCfg<HD>::kKeys);
    g[2] = dim3(q_heads, batch,
                (seqlen + QCfg<HD>::kRows - 1) / QCfg<HD>::kRows);
  } else {
    const int rows = batch * seqlen * q_heads;
    constexpr int per = Dot<float, HD>::kRowsPerBlock;
    const int tiles = (seqlen + F32<HD>::kTile - 1) / F32<HD>::kTile;
    g[0] = dim3((rows + per - 1) / per);
    g[1] = dim3(tiles, kv_heads, batch);
    g[2] = dim3(tiles, q_heads, batch);
  }
}

template <int HD>
int launch_bf16(const bf16* q, const bf16* k, const bf16* v,
                const bf16* out, const bf16* dout, const float* lse,
                float* dl, bf16* dq, bf16* dk, bf16* dv, int batch,
                int seqlen, int q_heads, int kv_heads, int true_len,
                int causal, float scale, const dim3* g,
                cudaStream_t stream) {
  using KC = KvCfg<HD>;
  using QC = QCfg<HD>;
  static_assert(KC::bytes <= kMaxSmem && QC::bytes <= kMaxSmem,
                "K5 backward tiles exceed shared memory");
  const int s_pad = (seqlen + kPad - 1) / kPad * kPad;
  // Q, dO, K and V end at true_len: the TMA unit zero-fills every row past
  // it. The dK/dV kernel's Q and dO boxes are its query tiles, its K and
  // V boxes its keys; the dQ kernel's the reverse.
  CUtensorMap kv_q, kv_do, kv_k, kv_v, q_q, q_do, q_k, q_v;
  if (!make_map<HD>(&kv_q, q, batch, seqlen, true_len, q_heads, 1,
                    KC::kQT) ||
      !make_map<HD>(&kv_do, dout, batch, seqlen, true_len, q_heads, 1,
                    KC::kQT) ||
      !make_map<HD>(&kv_k, k, batch, seqlen, true_len, kv_heads, 1,
                    KC::kKeys) ||
      !make_map<HD>(&kv_v, v, batch, seqlen, true_len, kv_heads, 1,
                    KC::kKeys) ||
      !make_map<HD>(&q_q, q, batch, seqlen, true_len, q_heads, 1,
                    QC::kRows) ||
      !make_map<HD>(&q_do, dout, batch, seqlen, true_len, q_heads, 1,
                    QC::kRows) ||
      !make_map<HD>(&q_k, k, batch, seqlen, true_len, kv_heads, 1, 64) ||
      !make_map<HD>(&q_v, v, batch, seqlen, true_len, kv_heads, 1, 64))
    return (int)cudaErrorInvalidValue;
  static bool dkdv_in = false, dq_in = false;   // once per instantiation
  int err = opt_in(dkdv_wgmma_kernel<HD>, KC::bytes, dkdv_in);
  if (err == 0) err = opt_in(dq_wgmma_kernel<HD>, QC::bytes, dq_in);
  if (err != 0) return err;
  const size_t plane = (size_t)batch * q_heads * s_pad;
  bwd_dot_kernel<bf16, HD><<<g[0], 256, 0, stream>>>(
      out, dout, lse, dl + plane, dl, batch, seqlen, s_pad, q_heads,
      true_len);
  if ((err = (int)cudaGetLastError())) return err;
  dkdv_wgmma_kernel<HD><<<g[1], 256, KC::bytes, stream>>>(
      kv_q, kv_k, kv_v, kv_do, dl, dk, dv, seqlen, s_pad, q_heads, kv_heads,
      true_len, causal, scale);
  if ((err = (int)cudaGetLastError())) return err;
  dq_wgmma_kernel<HD><<<g[2], QC::kNwg * 128, QC::bytes, stream>>>(
      q_q, q_k, q_v, q_do, dl, dq, seqlen, s_pad, q_heads, kv_heads,
      true_len, causal, scale);
  return (int)cudaGetLastError();
}

template <int HD>
int launch_f32(const float* q, const float* k, const float* v,
               const float* out, const float* dout, const float* lse,
               float* delta, float* dq, float* dk, float* dv, int batch,
               int seqlen, int q_heads, int kv_heads, int true_len,
               int causal, float scale, const dim3* g, cudaStream_t stream) {
  using F = F32<HD>;
  static_assert(F::bytes <= kMaxSmem, "K5 backward tiles exceed shared "
                "memory");
  static bool dkdv_in = false, dq_in = false;   // once per instantiation
  int err = opt_in(dkdv_f32_kernel<HD>, F::bytes, dkdv_in);
  if (err == 0) err = opt_in(dq_f32_kernel<HD>, F::bytes, dq_in);
  if (err != 0) return err;
  bwd_dot_kernel<float, HD><<<g[0], 256, 0, stream>>>(
      out, dout, lse, delta, nullptr, batch, seqlen, seqlen, q_heads,
      true_len);
  if ((err = (int)cudaGetLastError())) return err;
  dkdv_f32_kernel<HD><<<g[1], F::kThreads, F::bytes, stream>>>(
      q, k, v, dout, lse, delta, dk, dv, seqlen, q_heads, kv_heads, true_len,
      causal, scale);
  if ((err = (int)cudaGetLastError())) return err;
  dq_f32_kernel<HD><<<g[2], F::kThreads, F::bytes, stream>>>(
      q, k, v, dout, lse, delta, dq, seqlen, q_heads, kv_heads, true_len,
      causal, scale);
  return (int)cudaGetLastError();
}

template <int HD>
int launch_hd(int dtype, const void* q, const void* k, const void* v,
              const void* out, const void* dout, const float* lse,
              float* scratch, void* dq, void* dk, void* dv, int batch,
              int seqlen, int q_heads, int kv_heads, int true_len,
              int causal, float scale, const int* grids, int n_grids,
              cudaStream_t s) {
  dim3 g[3];
  grids_of<HD>(dtype, batch, seqlen, q_heads, kv_heads, g);
  if (!grids_match(grids, n_grids, g, 3)) return (int)cudaErrorInvalidValue;
  if (dtype == 1)
    return launch_bf16<HD>((const bf16*)q, (const bf16*)k, (const bf16*)v,
                           (const bf16*)out, (const bf16*)dout, lse, scratch,
                           (bf16*)dq, (bf16*)dk, (bf16*)dv, batch, seqlen,
                           q_heads, kv_heads, true_len, causal, scale, g, s);
  return launch_f32<HD>((const float*)q, (const float*)k, (const float*)v,
                        (const float*)out, (const float*)dout, lse, scratch,
                        (float*)dq, (float*)dk, (float*)dv, batch, seqlen,
                        q_heads, kv_heads, true_len, causal, scale, g, s);
}

}  // namespace

// Returns the cudaError_t of the first launch that failed (0 on success).
// dtype 0 = fp32, 1 = bf16 for q, k, v, out, dout, dq, dk and dv; q, out,
// dout and dq [batch, seqlen, q_heads, head_dim], k, v, dk and dv [batch,
// seqlen, kv_heads, head_dim], contiguous and 16-byte aligned; lse (the
// forward's, natural log) fp32 [batch, q_heads, seqlen]; scratch fp32 of
// 2 batch q_heads ceil(seqlen / 64) 64 floats, 16-byte aligned (D, and
// for bf16 the LSE in log2 units; written here); 0 < true_len <= seqlen.
// Every element of dq, dk and dv is written. grids (n_grids x 3 ints) is
// the wrapper's flash_prefill_bwd_grid: the D pass, dK/dV and dQ; any
// other grids are refused before anything launches. The caller has
// checked shapes, dtypes and alignment.
extern "C" int flash_prefill_bwd_launch(
    int dtype, int head_dim, const void* q, const void* k, const void* v,
    const void* out, const void* dout, const float* lse, float* scratch,
    void* dq, void* dk, void* dv, int batch, int seqlen, int q_heads,
    int kv_heads, int true_len, int causal, float scale, const int* grids,
    int n_grids, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (kv_heads < 1 || q_heads % kv_heads || true_len < 1 ||
      true_len > seqlen || batch < 1 || batch > 65535 ||
      (dtype != 0 && dtype != 1) ||
      (long)batch * ((seqlen + kPad - 1) / kPad * kPad) * q_heads >=
          (1L << 31))
    return (int)cudaErrorInvalidValue;
  switch (head_dim) {
    case 256:
      return launch_hd<256>(dtype, q, k, v, out, dout, lse, scratch, dq, dk,
                            dv, batch, seqlen, q_heads, kv_heads, true_len,
                            causal, scale, grids, n_grids, s);
    case 128:
      return launch_hd<128>(dtype, q, k, v, out, dout, lse, scratch, dq, dk,
                            dv, batch, seqlen, q_heads, kv_heads, true_len,
                            causal, scale, grids, n_grids, s);
    case 64:
      return launch_hd<64>(dtype, q, k, v, out, dout, lse, scratch, dq, dk,
                           dv, batch, seqlen, q_heads, kv_heads, true_len,
                           causal, scale, grids, n_grids, s);
    case 32:
      return launch_hd<32>(dtype, q, k, v, out, dout, lse, scratch, dq, dk,
                           dv, batch, seqlen, q_heads, kv_heads, true_len,
                           causal, scale, grids, n_grids, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
