// Temperature and top-p sampling, one CTA a row, for Hopper (sm_90a).
//
// What it replaces: no TPU kernel. The JAX package samples with jnp ops
// inside its jitted step (repro/serving/sampling.py). The port's eager
// version (serving/sampling.py: apply_top_p, sample) sorts every row of
// the step's logits ([320, ~152K]) with torch.sort, then runs a softmax, a
// cumsum, a second softmax, an exponential draw and an argmax, each a pass
// over a [rows, V] fp32 tensor. This kernel reads the unembedding's logits
// (bf16 or fp32) and writes one int32 token a row, with no sort and no
// [rows, V] temporary.
//
// Arithmetic: the plain version's (kernels/sampling/ref.py), one rounded
// operation for each of its torch ops, with no contraction into an FMA and
// sums of fixed-point integers, so thresholds and tokens are bit-equal to
// it on the same logits and keys, and from run to run:
//   y = x / T + 0            fp32, true division (the + 0 folds -0 into +0)
//   e = exp_det(y - max y)   an exp from fp32 multiplies and adds alone
//   m = trunc(e * 2^43)      the token's mass, an integer: u64 sums of it
//                            are exact whatever order the atomics add in
//   kept = {key(y) >= thr}   thr the largest key whose mass at or above it
//                            reaches ceil(p Z) (Z the row's mass): the set
//                            apply_top_p keeps; key: an order-preserving
//                            uint32 of y
//   token = argmax over kept of e / E, E = -log(u) from Philox4x32-10 keyed
//           by the row's int64 key, counter (i >> 2, row, 0, 0), word i & 3,
//           the first index on a tie (the race that torch.multinomial's
//           draw is)
//
// The threshold is a radix select on mass over the key, 12, 12 and 8 bits:
// a shared-memory histogram of mass over the key's top 12 bits, a
// descending prefix over the bins to the one where the mass reaches the
// target, then the same inside that bin on the next digit. The tokens of
// the chosen bin go to a list in shared memory (up to kCap indices), so the
// later digits read the list, not the row; a bin that does not fit is read
// from the row again. Tokens above the chosen bin are kept, and race in
// the same pass that fills the list.
//
// What bounds it on this card: the work a token costs (a division, the
// exp, the key, a shared atomic; for kept tokens Philox, the log and a
// second division), not bytes: the logits are read in three passes (the
// max; the masses and the first histogram; the race and the list), 16
// bytes a thread a load, and a bf16 row of 152K tokens (304 KB) mostly
// stays in the 50 MB L2 between passes. So each row is split over a
// cluster of CTAs (2, or 8 for at most 32 rows: a spawn's one row), each
// over a slice of it, that add their histograms through distributed shared
// memory: 320 rows fill the 132 SMs in more, shorter waves, and one row
// runs on 8 SMs. Mass histograms add with native 32-bit shared
// atomics and a carry (hist_add), not the 64-bit compare-and-swap loop;
// a kept token that cannot beat its thread's best skips its log. One
// launch covers every row: grid (rows x cluster, 1, 1).
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "launch_check.cuh"

namespace cg = cooperative_groups;

namespace {

typedef __nv_bfloat16 bf16;
typedef unsigned long long u64;

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kBins = 4096;        // the 12-bit digits' histogram
constexpr int kCap = 2048;         // indices a CTA's candidate list holds
constexpr int kMaxVocab = 1 << 20; // sums of trunc(e 2^43) stay below 2^63
constexpr unsigned kFull = 0xffffffffu;

// fp32 constants, the values of kernels/sampling/ref.py
constexpr float kExpMin = -80.0f;
constexpr float kMassScale = 0x1p43f;
constexpr float kLog2e = 0x1.715476p+0f;
constexpr float kLn2Hi = 0x1.62e4p-1f;
constexpr float kLn2Lo = 0x1.7f7d1cp-20f;
constexpr float kSqrt2 = 0x1.6a09e6p+0f;
constexpr float kExpC7 = 0x1.a01a02p-13f;   // 1/7!
constexpr float kExpC6 = 0x1.6c16c2p-10f;   // 1/6!
constexpr float kExpC5 = 0x1.111112p-7f;    // 1/5!
constexpr float kExpC4 = 0x1.555556p-5f;    // 1/4!
constexpr float kExpC3 = 0x1.555556p-3f;    // 1/3!
constexpr float kLogC9 = 0x1.c71c72p-4f;    // 1/9
constexpr float kLogC7 = 0x1.24924ap-3f;    // 1/7
constexpr float kLogC5 = 0x1.99999ap-3f;    // 1/5
constexpr float kLogC3 = 0x1.555556p-2f;    // 1/3
constexpr float kRaceSlack = 1.0f + 0x1p-18f;

struct Smem {
  u64 hist[kBins];    // this CTA's histogram of its slice
  u64 total[kBins];   // the cluster's, summed over its CTAs
  int list[2][kCap];
  u64 wsum[kWarps];
  float wmax[kWarps];
  float cta_max;
  float wbest[kWarps];
  int wbest_i[kWarps];
  int n_list[2];
  int sel_bin;
  u64 sel_above;
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }

// 8 consecutive elements through 16-byte loads (the address 16-byte
// aligned)
__device__ __forceinline__ void load8(const float* src, float (&v)[8]) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(src));
  const float4 b = __ldg(reinterpret_cast<const float4*>(src) + 1);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

__device__ __forceinline__ void load8(const bf16* src, float (&v)[8]) {
  const uint4 u = __ldg(reinterpret_cast<const uint4*>(src));
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

// e^d for d <= 0 (ref.exp_det): Cody-Waite reduction by ln 2, a degree-7
// Horner on |r| <= ln2 / 2, an exact power of two; 0 below kExpMin.
__device__ __forceinline__ float exp_det(float d) {
  if (!(d >= kExpMin)) return 0.0f;
  const float k = floorf(__fadd_rn(__fmul_rn(d, kLog2e), 0.5f));
  float r = __fsub_rn(d, __fmul_rn(k, kLn2Hi));
  r = __fsub_rn(r, __fmul_rn(k, kLn2Lo));
  float p = kExpC7;
  p = __fadd_rn(__fmul_rn(p, r), kExpC6);
  p = __fadd_rn(__fmul_rn(p, r), kExpC5);
  p = __fadd_rn(__fmul_rn(p, r), kExpC4);
  p = __fadd_rn(__fmul_rn(p, r), kExpC3);
  p = __fadd_rn(__fmul_rn(p, r), 0.5f);
  p = __fadd_rn(__fmul_rn(p, r), 1.0f);
  p = __fadd_rn(__fmul_rn(p, r), 1.0f);
  return __fmul_rn(p, __int_as_float(((int)k + 127) << 23));
}

// -log(u), u = (2 (bits >> 9) + 1) / 2^24 (ref.race_noise): never 0.
__device__ __forceinline__ float race_noise(uint32_t bits) {
  const float n = __uint2float_rn((bits >> 9) * 2u + 1u);
  const int b = __float_as_int(n);
  int ex = (b >> 23) - 127;
  float m = __int_as_float((b & 0x7FFFFF) | 0x3F800000);
  if (m > kSqrt2) {
    m = __fmul_rn(m, 0.5f);
    ex += 1;
  }
  const float s = __fdiv_rn(__fsub_rn(m, 1.0f), __fadd_rn(m, 1.0f));
  const float z = __fmul_rn(s, s);
  float q = kLogC9;
  q = __fadd_rn(__fmul_rn(q, z), kLogC7);
  q = __fadd_rn(__fmul_rn(q, z), kLogC5);
  q = __fadd_rn(__fmul_rn(q, z), kLogC3);
  q = __fadd_rn(__fmul_rn(q, z), 1.0f);
  const float log_m = __fmul_rn(__fmul_rn(s, 2.0f), q);
  const float f = (float)(24 - ex);
  return __fsub_rn(__fadd_rn(__fmul_rn(f, kLn2Hi), __fmul_rn(f, kLn2Lo)),
                   log_m);
}

// Philox4x32-10 of counter (c0, c1, 0, 0) under key (k0, k1).
__device__ __forceinline__ uint4 philox(uint32_t c0, uint32_t c1,
                                        uint32_t k0, uint32_t k1) {
  uint32_t c2 = 0, c3 = 0;
#pragma unroll
  for (int i = 0; i < 10; ++i) {
    if (i) {
      k0 += 0x9E3779B9u;
      k1 += 0xBB67AE85u;
    }
    const uint32_t lo0 = 0xD2511F53u * c0, hi0 = __umulhi(0xD2511F53u, c0);
    const uint32_t lo1 = 0xCD9E8D57u * c2, hi1 = __umulhi(0xCD9E8D57u, c2);
    const uint32_t n0 = hi1 ^ c1 ^ k0, n2 = hi0 ^ c3 ^ k1;
    c0 = n0;
    c1 = lo1;
    c2 = n2;
    c3 = lo0;
  }
  return make_uint4(c0, c1, c2, c3);
}

__device__ __forceinline__ uint32_t word(const uint4& w, int j) {
  return j == 0 ? w.x : j == 1 ? w.y : j == 2 ? w.z : w.w;
}

// hist += m for a u64 bin in shared memory, by native 32-bit atomics on
// its two words: the carry out of the low word goes to the high one, so
// the sum stays exact and independent of order (a 64-bit shared atomic
// add is a compare-and-swap loop, slow where lanes hit one bin).
__device__ __forceinline__ void hist_add(u64* bin, u64 m) {
  unsigned* w = reinterpret_cast<unsigned*>(bin);
  const unsigned lo = (unsigned)m, hi = (unsigned)(m >> 32);
  const unsigned old = atomicAdd(w, lo);
  const unsigned up = hi + (old + lo < old ? 1u : 0u);
  if (up) atomicAdd(w + 1, up);
}

// The uint32 key whose order is y's (ref.order_key).
__device__ __forceinline__ uint32_t order_key(float y) {
  const uint32_t b = __float_as_uint(y);
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}

// What a CTA's passes share: its row's logits, temperature, max and noise
// key, its slice of the row, and this thread's best (value, index) of the
// race so far.
template <typename T>
struct Row {
  const T* x;
  int vocab, row;
  int g_lo, g_hi;   // the slice's 8-token groups (16-byte loads)
  int t_lo, t_hi;   // the slice's tokens past the last whole group
  float temp, ymax;
  uint32_t k0, k1;
  float best, inv_best;
  int best_i;

  __device__ __forceinline__ float y_of(float xv) const {
    return __fadd_rn(__fdiv_rn(xv, temp), 0.0f);
  }
  __device__ __forceinline__ float e_of(float y) const {
    return exp_det(__fsub_rn(y, ymax));
  }
  __device__ __forceinline__ u64 mass_of(float y) const {
    return (u64)__fmul_rn(e_of(y), kMassScale);
  }
  // token i races with noise word `bits`. Once this thread holds a
  // positive best, a token whose 1 - u exceeds e / best (with a margin far
  // above the rounding of either side) is passed over without its log:
  // -log u >= 1 - u, so its e / E is below the best, and could not win.
  __device__ __forceinline__ void race(int i, float y, uint32_t bits) {
    const float e = e_of(y);
    if (best > 0.0f) {
      const float gap = __uint2float_rn((0x7FFFFFu - (bits >> 9)) * 2u + 1u);
      if (gap * 0x1p-24f > e * inv_best * kRaceSlack) return;
    }
    const float v = __fdiv_rn(e, race_noise(bits));
    if (v > best || (v == best && i < best_i)) {
      best = v;
      best_i = i;
      inv_best = 1.0f / v;
    }
  }
  __device__ __forceinline__ void race1(int i, float y) {
    race(i, y, word(philox((uint32_t)i >> 2, (uint32_t)row, k0, k1), i & 3));
  }
  __device__ __forceinline__ float at(int i) const { return to_f(x[i]); }

  // f(base, v, count, ok) over the slice, warp-uniformly (every lane of a
  // warp calls f the same number of times, ok false past the slice's
  // end): 8-token groups by 16-byte loads, then one token a call
  template <typename F>
  __device__ __forceinline__ void visit(F&& f) const {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    for (int g0 = g_lo + warp * 32; g0 < g_hi; g0 += kThreads) {
      const int g = g0 + lane;
      float v[8];
      const bool ok = g < g_hi;
      if (ok) load8(x + 8 * (size_t)g, v);
      f(8 * g, v, 8, ok);
    }
    for (int i0 = t_lo + warp * 32; i0 < t_hi; i0 += kThreads) {
      const int i = i0 + lane;
      float v[8];
      const bool ok = i < t_hi;
      if (ok) v[0] = at(i);
      f(i, v, 1, ok);
    }
  }
};

// Append index i to list `dst` where `want` (warp-aggregated: one shared
// atomic a warp); slots at or past kCap are counted, not written.
__device__ __forceinline__ void append(Smem& s, int dst, bool want, int i) {
  const unsigned mask = __ballot_sync(kFull, want);
  if (!mask) return;
  const int lane = threadIdx.x & 31;
  int base = 0;
  if (lane == __ffs(mask) - 1) base = atomicAdd(&s.n_list[dst], __popc(mask));
  base = __shfl_sync(kFull, base, __ffs(mask) - 1);
  if (want) {
    const int slot = base + __popc(mask & ((1u << lane) - 1u));
    if (slot < kCap) s.list[dst][slot] = i;
  }
}

// The block's sum of v (every thread gets it).
__device__ __forceinline__ u64 block_sum(Smem& s, u64 v) {
  for (int d = 16; d; d >>= 1) v += __shfl_xor_sync(kFull, v, d);
  if ((threadIdx.x & 31) == 0) s.wsum[threadIdx.x >> 5] = v;
  __syncthreads();
  u64 t = 0;
  for (int w = 0; w < kWarps; ++w) t += s.wsum[w];
  __syncthreads();
  return t;
}

// s.total[0, nb) = the sum of every CTA's s.hist[0, nb) over the cluster
// (distributed shared memory). The cluster barrier before makes every
// histogram whole; the one after keeps each until all have read it.
__device__ __forceinline__ void merge(Smem& s, const cg::cluster_group& cl,
                                      int nb) {
  cl.sync();
  const int n = (int)cl.num_blocks();
  for (int b = threadIdx.x; b < nb; b += kThreads) {
    u64 t = 0;
    for (int c = 0; c < n; ++c) t += cl.map_shared_rank(s.hist, c)[b];
    s.total[b] = t;
  }
  cl.sync();
}

// The one bin b of s.total[0, nb) where the mass from the top down
// reaches `target`: cs(b) >= target > cs(b + 1), cs(b) = above + the bins
// >= b. Sets s.sel_bin and s.sel_above = cs(b + 1).
__device__ __forceinline__ void select_bin(Smem& s, int nb, u64 above,
                                           u64 target) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int per = (nb + kThreads - 1) / kThreads;
  const int lo = min(tid * per, nb), hi = min(lo + per, nb);
  u64 mine = 0;
  for (int b = lo; b < hi; ++b) mine += s.total[b];
  u64 incl = mine;   // inclusive suffix sum over the warp's lanes
  for (int d = 1; d < 32; d <<= 1) {
    const u64 o = __shfl_down_sync(kFull, incl, d);
    if (lane + d < 32) incl += o;
  }
  if (lane == 0) s.wsum[warp] = incl;
  __syncthreads();
  u64 run = above + (incl - mine);
  for (int w = warp + 1; w < kWarps; ++w) run += s.wsum[w];
  for (int b = hi - 1; b >= lo; --b) {
    const u64 next = run;
    run += s.total[b];
    if (run >= target && next < target) {
      s.sel_bin = b;
      s.sel_above = next;
    }
  }
  __syncthreads();
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
    sample_top_p_kernel(const T* __restrict__ logits, int vocab,
                        const long long* __restrict__ keys, float temp,
                        double top_p, int* __restrict__ tokens,
                        int* __restrict__ thresholds) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem& s = *reinterpret_cast<Smem*>(smem_raw);
  const cg::cluster_group cl = cg::this_cluster();
  const int n_cta = (int)cl.num_blocks(), rank = (int)cl.block_rank();
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  Row<T> r;
  r.row = blockIdx.x / n_cta;
  r.x = logits + (size_t)r.row * vocab;
  r.vocab = vocab;
  // the row in n_cta slices: whole 8-token groups where the row is
  // 16-byte aligned, then the tokens left
  const int groups =
      (reinterpret_cast<uintptr_t>(r.x) % 16 == 0) ? vocab / 8 : 0;
  const int rest = vocab - 8 * groups;
  r.g_lo = (int)((long long)groups * rank / n_cta);
  r.g_hi = (int)((long long)groups * (rank + 1) / n_cta);
  r.t_lo = 8 * groups + rest * rank / n_cta;
  r.t_hi = 8 * groups + rest * (rank + 1) / n_cta;
  r.temp = temp;
  const u64 key = (u64)keys[r.row];
  r.k0 = (uint32_t)key;
  r.k1 = (uint32_t)(key >> 32);
  r.best = -1.0f;
  r.inv_best = 0.0f;
  r.best_i = 0x7fffffff;

  // pass 1: the row's max (y is monotone in x, so max y = y(max x))
  float mx = -INFINITY;
  r.visit([&](int, const float (&v)[8], int n, bool ok) {
    if (ok)
      for (int j = 0; j < n; ++j) mx = fmaxf(mx, v[j]);
  });
  for (int d = 16; d; d >>= 1) mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, d));
  if (lane == 0) s.wmax[warp] = mx;
  for (int b = tid; b < kBins; b += kThreads) s.hist[b] = 0;
  __syncthreads();
  if (tid == 0) {
    for (int w = 1; w < kWarps; ++w) mx = fmaxf(mx, s.wmax[w]);
    s.cta_max = mx;
  }
  cl.sync();
  mx = -INFINITY;
  for (int c = 0; c < n_cta; ++c)
    mx = fmaxf(mx, *cl.map_shared_rank(&s.cta_max, c));
  r.ymax = r.y_of(mx);

  // the race over every token of the slice whose key passes `pred`
  auto race_all = [&](auto&& pred) {
    r.visit([&](int base, const float (&v)[8], int n, bool ok) {
      if (!ok) return;
      if (n == 8) {
        float y[8];
        unsigned in = 0;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          y[j] = r.y_of(v[j]);
          if (pred(order_key(y[j]))) in |= 1u << j;
        }
        if (!in) return;
        const uint4 w0 = philox((uint32_t)base >> 2, (uint32_t)r.row, r.k0,
                                r.k1);
        const uint4 w1 = philox(((uint32_t)base >> 2) + 1, (uint32_t)r.row,
                                r.k0, r.k1);
#pragma unroll
        for (int j = 0; j < 8; ++j)
          if (in >> j & 1u)
            r.race(base + j, y[j], word(j < 4 ? w0 : w1, j & 3));
      } else {
        const float y = r.y_of(v[0]);
        if (pred(order_key(y))) r.race1(base, y);
      }
    });
  };

  uint32_t thr = 0;
  bool all = !(top_p < 1.0);
  u64 target = 0;
  if (!all) {
    // pass 2: the mass histogram over the key's top 12 bits
    r.visit([&](int, const float (&v)[8], int n, bool ok) {
      if (!ok) return;
      for (int j = 0; j < n; ++j) {
        const float y = r.y_of(v[j]);
        const u64 m = r.mass_of(y);
        if (m) hist_add(&s.hist[order_key(y) >> 20], m);
      }
    });
    merge(s, cl, kBins);
    u64 mine = 0;
    for (int b = tid; b < kBins; b += kThreads) mine += s.total[b];
    const u64 z = block_sum(s, mine);   // the row's mass, in every CTA
    if (z == 0) {
      all = true;
    } else {
      u64 t = (u64)ceil(top_p * (double)z);
      target = t < 1 ? 1 : t > z ? z : t;
    }
  }
  if (all) {
    race_all([](uint32_t) { return true; });
  } else {
    // the radix select: 12, 12 and 8 bits of the key
    u64 above = 0;
    uint32_t prefix = 0;
    bool listed = false;   // the list `cur` holds every token of the prefix
    int cur = 0;           // in this CTA's slice
    for (int lev = 0; lev < 3; ++lev) {
      const int shift = lev == 0 ? 20 : lev == 1 ? 8 : 0;
      const int nb = lev == 2 ? 256 : kBins;
      const int top = shift + (lev == 2 ? 8 : 12);   // bits above the digit
      const uint32_t want = lev ? prefix >> top : 0;
      auto in_prefix = [&](uint32_t k) { return !lev || (k >> top) == want; };
      if (lev) {   // this digit's histogram over the prefix's tokens
        for (int b = tid; b < nb; b += kThreads) s.hist[b] = 0;
        __syncthreads();
        if (listed) {
          for (int k = tid; k < s.n_list[cur]; k += kThreads) {
            const float y = r.y_of(r.at(s.list[cur][k]));
            const u64 m = r.mass_of(y);
            if (m) hist_add(&s.hist[(order_key(y) >> shift) & (nb - 1)], m);
          }
        } else {
          r.visit([&](int, const float (&v)[8], int n, bool ok) {
            if (!ok) return;
            for (int j = 0; j < n; ++j) {
              const float y = r.y_of(v[j]);
              const uint32_t k = order_key(y);
              if (!in_prefix(k)) continue;
              const u64 m = r.mass_of(y);
              if (m) hist_add(&s.hist[(k >> shift) & (nb - 1)], m);
            }
          });
        }
        merge(s, cl, nb);
      }
      select_bin(s, nb, above, target);
      const uint32_t b = (uint32_t)s.sel_bin;
      above = s.sel_above;
      const int nxt = cur ^ 1;
      if (tid == 0) s.n_list[nxt] = 0;
      __syncthreads();
      // the prefix's tokens above bin b are kept and race; those in b
      // make the next list
      if (listed) {
        const int n = s.n_list[cur];
        for (int k0 = warp * 32; k0 < n; k0 += kThreads) {
          const int k = k0 + lane;
          int i = 0;
          float y = 0.0f;
          uint32_t d = 0;
          if (k < n) {
            i = s.list[cur][k];
            y = r.y_of(r.at(i));
            d = (order_key(y) >> shift) & (nb - 1);
            if (d > b) r.race1(i, y);
          }
          append(s, nxt, k < n && d == b, i);
        }
      } else {
        r.visit([&](int base, const float (&v)[8], int n, bool ok) {
          uint4 w0 = make_uint4(0, 0, 0, 0), w1 = w0;
          bool drawn = false;
          for (int j = 0; j < n; ++j) {
            float y = 0.0f;
            uint32_t k = 0, d = 0;
            bool mine = false;
            if (ok) {
              y = r.y_of(v[j]);
              k = order_key(y);
              mine = in_prefix(k);
              d = (k >> shift) & (nb - 1);
            }
            if (mine && d > b) {
              if (n == 1) {
                r.race1(base, y);
              } else {
                if (!drawn) {
                  w0 = philox((uint32_t)base >> 2, (uint32_t)r.row, r.k0,
                              r.k1);
                  w1 = philox(((uint32_t)base >> 2) + 1, (uint32_t)r.row,
                              r.k0, r.k1);
                  drawn = true;
                }
                r.race(base + j, y, word(j < 4 ? w0 : w1, j & 3));
              }
            }
            append(s, nxt, mine && d == b, base + j);
          }
        });
      }
      __syncthreads();
      listed = s.n_list[nxt] <= kCap;
      cur = nxt;
      prefix |= b << shift;
    }
    thr = prefix;
    // the tokens at the threshold are kept too
    if (listed) {
      for (int k = tid; k < s.n_list[cur]; k += kThreads) {
        const int i = s.list[cur][k];
        r.race1(i, r.y_of(r.at(i)));
      }
    } else {
      race_all([thr](uint32_t k) { return k == thr; });
    }
  }

  // the race's winner: the largest value, the first index on a tie, over
  // the block, then over the cluster by CTA 0
  float best = r.best;
  int best_i = r.best_i;
  for (int d = 16; d; d >>= 1) {
    const float ob = __shfl_xor_sync(kFull, best, d);
    const int oi = __shfl_xor_sync(kFull, best_i, d);
    if (ob > best || (ob == best && oi < best_i)) {
      best = ob;
      best_i = oi;
    }
  }
  if (lane == 0) {
    s.wbest[warp] = best;
    s.wbest_i[warp] = best_i;
  }
  __syncthreads();
  if (tid == 0) {
    for (int w = 1; w < kWarps; ++w)
      if (s.wbest[w] > best || (s.wbest[w] == best && s.wbest_i[w] < best_i)) {
        best = s.wbest[w];
        best_i = s.wbest_i[w];
      }
    s.wbest[0] = best;
    s.wbest_i[0] = best_i;
  }
  cl.sync();
  if (rank == 0 && tid == 0) {
    for (int c = 1; c < n_cta; ++c) {
      const float ob = *cl.map_shared_rank(&s.wbest[0], c);
      const int oi = *cl.map_shared_rank(&s.wbest_i[0], c);
      if (ob > best || (ob == best && oi < best_i)) {
        best = ob;
        best_i = oi;
      }
    }
    tokens[r.row] = best_i;
    thresholds[r.row] = (int)thr;
  }
  cl.sync();   // CTA 0 has read every CTA's winner
}

// CTAs of the cluster that shares a row (kernels/sampling/sample_top_p.py:
// cluster_ctas is the same rule): 8 where few rows would leave SMs idle (a
// spawn's one row: 0.081 ms against 0.286 on one CTA), else 2 (320 rows:
// 0.62 ms against 0.70 on one CTA a row, 0.77 on 4, 1.13 on 8, where the
// histogram merges' distributed-shared-memory reads grow with the CTAs)
__host__ __device__ constexpr int cluster_ctas(int rows) {
  return rows <= 32 ? 8 : 2;
}

template <typename T>
int launch(const void* logits, const void* keys, void* tokens,
           void* thresholds, int rows, int vocab, float temp, double top_p,
           cudaStream_t stream) {
  static bool sized = false;   // one instantiation's attribute, set once
  const int smem = (int)sizeof(Smem);
  const auto kernel = sample_top_p_kernel<T>;
  if (!sized) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    sized = true;
  }
  const int n_cta = cluster_ctas(rows);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(rows * n_cta, 1, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = n_cta;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(
      &cfg, kernel, (const T*)logits, vocab, (const long long*)keys, temp,
      top_p, (int*)tokens, (int*)thresholds);
  return (int)(e != cudaSuccess ? e : cudaGetLastError());
}

}  // namespace

// One launch over `rows` rows of `vocab` logits (dtype 0 = fp32, 1 =
// bf16; rows contiguous), each with its int64 Philox key; writes one int32
// token and the int32 bits of the uint32 threshold key a row. The grid is
// (rows, 1, 1), checked against `grids` (launch_check.cuh) before the
// launch. Returns cudaGetLastError() after it, or cudaErrorInvalidValue for
// arguments it refuses.
extern "C" int sample_top_p_launch(int dtype, const void* logits,
                                   const void* keys, void* tokens,
                                   void* thresholds, int rows, int vocab,
                                   float temperature, double top_p,
                                   const int* grids, int n_grids,
                                   void* stream) {
  if ((dtype != 0 && dtype != 1) || rows < 1 || vocab < 1 ||
      vocab >= kMaxVocab || !(temperature > 0.0f) ||
      (long long)rows * cluster_ctas(rows) > 0x7FFFFFFFLL)
    return (int)cudaErrorInvalidValue;
  const dim3 grid(rows * cluster_ctas(rows), 1, 1);
  if (!grids_match(grids, n_grids, &grid, 1))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0)
    return launch<float>(logits, keys, tokens, thresholds, rows, vocab,
                         temperature, top_p, st);
  return launch<bf16>(logits, keys, tokens, thresholds, rows, vocab,
                      temperature, top_p, st);
}
