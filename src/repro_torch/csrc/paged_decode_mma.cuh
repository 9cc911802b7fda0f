// The split-key tensor-core decode core for Hopper (sm_90a), bf16, and the
// 32-key mma.sync tile pieces it shares with K3's shared pass
// (paged_tree_decode.cu, tree_shared_mma_kernel) and K2's bf16 kernel
// (paged_prefill.cu, prefill_mma_kernel).
//
// One kernel template, decode_mma_kernel<HD, kBranch>, instantiated twice:
//   * kBranch = false: K1, the paged flash-decode (paged_decode.cu,
//     paged_decode_launch), replacing _decode_kernel of
//     repro/kernels/paged_attention/paged_attention.py;
//   * kBranch = true: K3's branch pass (paged_tree_decode.cu,
//     tree_branch_launch), replacing _tree_branch_kernel and the jnp merge
//     of repro/kernels/paged_attention/tree_decode.py.
// The branch pass is K1 over each row's suffix table followed by a merge
// with the shared pass's split partials, so the walk, the warps' merge and
// the CTAs' merge are one code, and the branch pass only adds the shared
// splits in front of the merge. It lives in a header because two libraries
// (one per .cu, each with its own extern "C" launchers) instantiate it.
//
// What bounds it: bytes in principle (a row reads its K/V once and does
// 4 x group x head_dim flops per key), but at the serving shapes (16 rows
// of 17-112 tokens, 3.7 MB of K/V, ~1.1 us at 3.35 TB/s) the time is the
// depth of the dependent chain a CTA walks. The design shortens it:
//   * Rows on tensor cores. A CTA holds up to 16 query heads of one (row,
//     KV head): the GQA group (5 for r1-distill-14b, 7 for qwen2, 2 for
//     the 32-wide fallback trunks) padded to the 16 rows of an m16n8k16
//     tile; a group of 17-32 heads takes two CTAs, one per 16-head slice.
//     S = Q K^T takes the raw bf16 q and is scaled by 1/sqrt(head_dim) in
//     fp32 after the product (rounding q * scale to bf16 would add an
//     error the Pallas kernel's fp32 q * scale does not have); O += P V
//     takes P split into bf16 hi and lo, so P keeps fp32's precision; m, l
//     and acc are fp32.
//   * The context split over warps. A CTA's keys are cut into 32-key
//     tiles; warp w takes tiles w, w + 4, w + 8, ... Each warp gathers its
//     tiles through the table with cp.async into its own buffers (K and V
//     in separate groups, so Q K^T and the softmax run while V lands; a
//     warp with more than one tile double-buffers the next one where the
//     split is long enough to give it one), keeps its own (m, l, acc), and
//     waits for no other warp until its tiles are done. The softmax
//     reduces a row's max and sum over the four lanes of a quad with
//     __shfl_xor_sync on the mma fragment layout. The CTA then merges its
//     warps' partials in shared memory, in warp order.
//   * The context split over CTAs. Key split z of a row (split_keys keys,
//     a multiple of 32) is CTA z of a thread-block cluster of n_split CTAs
//     (at most 8). Where a row's keys reach past the first split, every
//     CTA leaves its merged partials in its shared memory, and after one
//     cluster barrier CTA 0 reads them over distributed shared memory and
//     merges them in split order; a second barrier keeps them alive until
//     it has. No workspace, no atomics, no second launch: the merge order
//     is fixed, so a result does not change from run to run. The split
//     layout is the wrapper's rule (ref.py: decode_splits) over the shapes
//     only (pages_per_seq, page_size, dtype), never the step's lengths, so
//     no host int changes from step to step. A CTA whose keys start past
//     its row's end exits at once where the row's keys fit the first
//     split; otherwise (the row spans several CTAs) it only joins the two
//     barriers.
//   * The branch pass prefetches the used shared splits' (m, l) into
//     shared memory with cp.async at its start, and CTA 0 merges in order:
//     the shared splits 0 .. n - 1, then the suffix's CTAs in split order,
//     then divides by max(l, 1e-30). Splits at or past the row's visible
//     end of the span hold (NEG_INF, 0, 0) and are not read.
//   * Head_dim 256 (gemma-7b) is its own instantiation: a warp's o is then
//     128 fp32 registers, so Q's A fragments are read from shared memory
//     in each product (tile::QOperand) instead of held beside them, and
//     each warp has one tile buffer (two would take 280 KB).
// The contracts of paged_common.cuh hold: GQA-native (a K/V tile serves
// every query head of its KV head); table entries are clamped into the
// pool before any address is formed; keys past a row's end are
// zero-filled in shared memory, never loaded (a tensor core computes
// 0 x NaN = NaN, so a stale page must not reach a tile); a row with no
// key is exact zeros.
#pragma once

#include "hopper_ptx.cuh"
#include "paged_common.cuh"

namespace paged {
namespace tile {

using bf16 = __nv_bfloat16;
constexpr int kKeys = 32;   // keys per shared-memory tile

__device__ __forceinline__ int clamp_page(int page, int num_pages) {
  return page < 0 ? 0 : (page >= num_pages ? num_pages - 1 : page);
}

// One 16-byte chunk of a tile row: copied where the key is visible, zeros
// where it is not (never stale bytes: 0 * NaN would poison P V).
__device__ __forceinline__ void stage(bf16* dst, const bf16* src,
                                      bool visible) {
  if (visible)
    ptx::cp_async_16(dst, src);
  else
    *reinterpret_cast<uint4*>(dst) = make_uint4(0u, 0u, 0u, 0u);
}

// Rows of HD bf16 are padded by 16 bytes in shared memory, so ldmatrix's
// eight row reads hit eight bank groups.
template <int HD>
__host__ __device__ constexpr int stride() {
  return HD + 8;
}

// A warp's Q fragments (the A operand, 16 rows x HD) from 16 rows of
// shared memory starting at q.
template <int HD>
__device__ __forceinline__ void load_q(uint32_t (&qa)[HD / 16][4],
                                       const bf16* q, int lane) {
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk)
    ptx::ldmatrix_x4(qa[kk], q + (lane % 8 + 8 * ((lane / 8) % 2)) *
                                     stride<HD>() +
                                 16 * kk + 8 * (lane / 16));
}

// S = Q K^T over one tile k [kKeys][stride]: sc[nb] holds keys
// 8 nb .. 8 nb + 7; sc[nb][2 i + e] is row lane / 4 + 8 i, key
// 8 nb + 2 (lane % 4) + e, so a row's keys sit in one quad.
template <int HD>
__device__ __forceinline__ void qk(float (&sc)[kKeys / 8][4],
                                   const uint32_t (&qa)[HD / 16][4],
                                   const bf16* k, int lane) {
#pragma unroll
  for (int nb = 0; nb < kKeys / 8; ++nb) {
#pragma unroll
    for (int e = 0; e < 4; ++e) sc[nb][e] = 0.f;
#pragma unroll
    for (int c32 = 0; c32 < HD / 32; ++c32) {
      uint32_t kb[4];
      ptx::ldmatrix_x4(kb, k + (8 * nb + lane % 8) * stride<HD>() +
                               32 * c32 + 8 * (lane / 8));
      ptx::mma_m16n8k16(sc[nb], qa[2 * c32], kb[0], kb[1]);
      ptx::mma_m16n8k16(sc[nb], qa[2 * c32 + 1], kb[2], kb[3]);
    }
  }
}

// S = Q K^T as qk, with Q's fragments read from 16 rows of shared memory
// at q, 32 columns at a time, instead of held: at head_dim 256 the 64
// words of held fragments beside o's 128 accumulators would spill. Every
// address is one opaque base plus a constant (ptx::opaque), so none is
// kept across tiles.
template <int HD>
__device__ __forceinline__ void qk_smem(float (&sc)[kKeys / 8][4],
                                        const bf16* q, const bf16* k,
                                        int lane) {
  constexpr uint32_t kRow = stride<HD>() * 2;   // bytes
  const uint32_t qb = ptx::opaque(ptx::smem_addr(
      q + (lane % 8 + 8 * ((lane / 8) % 2)) * stride<HD>() +
      8 * (lane / 16)));
  const uint32_t kb0 = ptx::opaque(
      ptx::smem_addr(k + (lane % 8) * stride<HD>() + 8 * (lane / 8)));
#pragma unroll
  for (int nb = 0; nb < kKeys / 8; ++nb)
#pragma unroll
    for (int e = 0; e < 4; ++e) sc[nb][e] = 0.f;
#pragma unroll
  for (int c32 = 0; c32 < HD / 32; ++c32) {
    uint32_t qa[2][4];
#pragma unroll
    for (int h = 0; h < 2; ++h)
      ptx::ldmatrix_x4_s(qa[h], qb + (32 * c32 + 16 * h) * 2);
#pragma unroll
    for (int nb = 0; nb < kKeys / 8; ++nb) {
      uint32_t kb[4];
      ptx::ldmatrix_x4_s(kb, kb0 + 8 * nb * kRow + 32 * c32 * 2);
      ptx::mma_m16n8k16(sc[nb], qa[0], kb[0], kb[1]);
      ptx::mma_m16n8k16(sc[nb], qa[1], kb[2], kb[3]);
    }
  }
}

// O += P V as pv over the first NC columns of a tile v of head_dim HD's
// rows, each V address an opaque base plus a constant (see qk_smem):
// head_dim 256's, whole (NC = 256) or one 128-column half.
template <int NC, int HD>
__device__ __forceinline__ void pv_cols(float (&o)[NC / 8][4],
                                        const float (&sc)[kKeys / 8][4],
                                        const bf16* v, int lane) {
  constexpr uint32_t kRow = stride<HD>() * 2;   // bytes
  const uint32_t vb0 = ptx::opaque(ptx::smem_addr(
      v + (lane % 8 + 8 * ((lane / 8) % 2)) * stride<HD>() +
      8 * (lane / 16)));
#pragma unroll
  for (int kk = 0; kk < kKeys / 16; ++kk) {
    uint32_t ph[4], pl[4];
    ptx::split_bf16(sc[2 * kk][0], sc[2 * kk][1], ph[0], pl[0]);
    ptx::split_bf16(sc[2 * kk][2], sc[2 * kk][3], ph[1], pl[1]);
    ptx::split_bf16(sc[2 * kk + 1][0], sc[2 * kk + 1][1], ph[2], pl[2]);
    ptx::split_bf16(sc[2 * kk + 1][2], sc[2 * kk + 1][3], ph[3], pl[3]);
#pragma unroll
    for (int np = 0; np < NC / 16; ++np) {
      uint32_t vb[4];
      ptx::ldmatrix_x4_trans_s(vb, vb0 + 16 * kk * kRow + 16 * np * 2);
      ptx::mma_m16n8k16(o[2 * np], ph, vb[0], vb[1]);
      ptx::mma_m16n8k16(o[2 * np], pl, vb[0], vb[1]);
      ptx::mma_m16n8k16(o[2 * np + 1], ph, vb[2], vb[3]);
      ptx::mma_m16n8k16(o[2 * np + 1], pl, vb[2], vb[3]);
    }
  }
}

// A warp's Q operand of S = Q K^T over its walk: up to head_dim 128 the A
// fragments, loaded once and held in registers; at 256 the address of the
// 16 staged rows, read again in every product (qk_smem).
template <int HD, bool kHeld = (HD <= 128)>
struct QOperand {
  uint32_t a[HD / 16][4];
  __device__ __forceinline__ void load(const bf16* q, int lane) {
    load_q<HD>(a, q, lane);
  }
  __device__ __forceinline__ void qk(float (&sc)[kKeys / 8][4],
                                     const bf16* k, int lane) const {
    tile::qk<HD>(sc, a, k, lane);
  }
};

template <int HD>
struct QOperand<HD, false> {
  const bf16* q;
  __device__ __forceinline__ void load(const bf16* rows, int) { q = rows; }
  __device__ __forceinline__ void qk(float (&sc)[kKeys / 8][4],
                                     const bf16* k, int lane) const {
    qk_smem<HD>(sc, q, k, lane);
  }
};

// The online softmax of one tile: key kc + 8 nb + e (kc = the tile's
// first key + 2 (lane % 4)) counts for row i of this thread while it is
// < lim[i]; scores are scaled in fp32, m and l updated, o rescaled, and
// sc left holding P (exact zeros where a key does not count).
template <int HD>
__device__ __forceinline__ void softmax(float (&sc)[kKeys / 8][4],
                                        float (&m)[2], float (&l)[2],
                                        float (&o)[HD / 8][4], int kc,
                                        const int (&lim)[2], float scale) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float mx = kNegInf;
#pragma unroll
    for (int nb = 0; nb < kKeys / 8; ++nb)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float& x = sc[nb][2 * i + e];
        x = kc + 8 * nb + e < lim[i] ? x * scale : kNegInf;
        mx = fmaxf(mx, x);
      }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(m[i], mx);
    const float alpha = expf(m[i] - m_new);
    float sum = 0.f;
#pragma unroll
    for (int nb = 0; nb < kKeys / 8; ++nb)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float& x = sc[nb][2 * i + e];
        x = kc + 8 * nb + e < lim[i] ? expf(x - m_new) : 0.f;
        sum += x;
      }
    l[i] = l[i] * alpha + sum;
    m[i] = m_new;
#pragma unroll
    for (int n = 0; n < HD / 8; ++n) {
      o[n][2 * i] *= alpha;
      o[n][2 * i + 1] *= alpha;
    }
  }
}

// O += P V over one tile v [kKeys][stride] in 16-key steps, P split into
// bf16 hi and lo (V read transposed by ldmatrix); head_dim 256 takes
// pv_cols.
template <int HD>
__device__ __forceinline__ void pv(float (&o)[HD / 8][4],
                                   const float (&sc)[kKeys / 8][4],
                                   const bf16* v, int lane) {
  if constexpr (HD > 128) {
    pv_cols<HD, HD>(o, sc, v, lane);
    return;
  }
#pragma unroll
  for (int kk = 0; kk < kKeys / 16; ++kk) {
    uint32_t ph[4], pl[4];
    ptx::split_bf16(sc[2 * kk][0], sc[2 * kk][1], ph[0], pl[0]);
    ptx::split_bf16(sc[2 * kk][2], sc[2 * kk][3], ph[1], pl[1]);
    ptx::split_bf16(sc[2 * kk + 1][0], sc[2 * kk + 1][1], ph[2], pl[2]);
    ptx::split_bf16(sc[2 * kk + 1][2], sc[2 * kk + 1][3], ph[3], pl[3]);
#pragma unroll
    for (int np = 0; np < HD / 16; ++np) {
      uint32_t vb[4];
      ptx::ldmatrix_x4_trans(vb, v + (16 * kk + lane % 8 +
                                      8 * ((lane / 8) % 2)) * stride<HD>() +
                                     16 * np + 8 * (lane / 16));
      ptx::mma_m16n8k16(o[2 * np], ph, vb[0], vb[1]);
      ptx::mma_m16n8k16(o[2 * np], pl, vb[0], vb[1]);
      ptx::mma_m16n8k16(o[2 * np + 1], ph, vb[2], vb[3]);
      ptx::mma_m16n8k16(o[2 * np + 1], pl, vb[2], vb[3]);
    }
  }
}

}  // namespace tile

namespace decode {

constexpr int kWarps = kThreads / 32;   // 4
constexpr int kRows = 16;               // query heads one CTA holds
constexpr int kMaxCluster = 8;          // CTAs (key splits) of one row
constexpr int kMaxShared = 16;          // shared-pass splits merged

struct Args {
  const __nv_bfloat16* q;         // [batch, q_heads, HD]
  const __nv_bfloat16* k_pages;   // [kv_heads, num_pages, page_size, HD]
  const __nv_bfloat16* v_pages;
  const int* tables;   // [batch, pages_per_seq]: K1's block tables, the
                       // branch pass's suffix tables
  const int* lengths;  // [batch]
  __nv_bfloat16* out;  // [batch, q_heads, HD]
  // the branch pass only: the tree map and the shared pass's partials
  // [shared_n, batch, q_heads, HD + 2] (acc, m, l) of shared_keys-key
  // splits, the last one every key from its start
  const int* row_group;
  const int* shared_lens;
  const float* part;
  int num_groups, shared_keys, shared_n;
  int batch, q_heads, kv_heads, num_pages, page_size, pages_per_seq;
  int split_keys, n_split;   // this pass's key splits: the CTAs of a cluster
  float scale;
};

constexpr size_t kMaxSmem = 232448;   // what a block may take on the H100

// Dynamic shared memory: Q, the shared splits' (m, l), then each warp's
// K/V tile buffers, which the epilogue reuses for the warps' partials and
// the CTA's.
template <int HD>
struct Layout {
  static constexpr int kOStride = HD + 8;   // fp32 partial rows, padded
  static constexpr size_t kQ = (size_t)kRows * tile::stride<HD>() * 2;
  static constexpr size_t kSharedML = 2 * kMaxShared * kRows * 4;
  static constexpr size_t kTile = (size_t)tile::kKeys * tile::stride<HD>();
  static constexpr size_t kEpilogue =
      ((size_t)(kWarps + 1) * kRows * kOStride + 2 * (kWarps + 1) * kRows) *
      4;
  __host__ __device__ static constexpr size_t bytes(int stages) {
    return kQ + kSharedML +
           ((size_t)kWarps * stages * 2 * kTile * 2 > kEpilogue
                ? (size_t)kWarps * stages * 2 * kTile * 2
                : kEpilogue);
  }
};

// Tile buffers per warp: two (the next tile in flight while this one
// computes) where they fit the block's shared memory; at head_dim 256 two
// would take 280 KB, so each warp has one.
template <int HD>
__host__ __device__ constexpr int max_stages() {
  return Layout<HD>::bytes(2) <= kMaxSmem ? 2 : 1;
}

// A warp's tile buffers for a split: max_stages where a warp can have more
// than one tile of it, else one.
template <int HD>
__host__ __device__ inline int stages_for(int split_keys) {
  return split_keys > kWarps * tile::kKeys ? max_stages<HD>() : 1;
}

template <int HD, bool kBranch>
__global__ void __launch_bounds__(kThreads)
    decode_mma_kernel(const Args a) {
  using bf16 = __nv_bfloat16;
  using L = Layout<HD>;
  constexpr int kStride = tile::stride<HD>();
  constexpr int kChunks = HD / 8;   // 16-byte chunks per row
  constexpr int kQuads = HD / 4;    // float4 column groups per row
  constexpr int kOS = L::kOStride;
  // a tile's copies unrolled in full up to head_dim 128; at 256 four at a
  // time, so their shared addresses are not all kept across tiles
  constexpr int kGatherUnroll = HD > 128 ? 4 : kChunks;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sq = reinterpret_cast<bf16*>(smem);
  float* sh_m = reinterpret_cast<float*>(smem + L::kQ);   // [split][row]
  float* sh_l = sh_m + kMaxShared * kRows;
  unsigned char* work = smem + L::kQ + L::kSharedML;
  float* w_o = reinterpret_cast<float*>(work);   // [warp][row][kOS]
  float* w_m = w_o + kWarps * kRows * kOS;       // [warp][row]
  float* w_l = w_m + kWarps * kRows;
  float* c_o = w_l + kWarps * kRows;             // [row][kOS]: the CTA's
  float* c_m = c_o + kRows * kOS;
  float* c_l = c_m + kRows;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int z = blockIdx.x, b = blockIdx.z;
  const int group = a.q_heads / a.kv_heads;
  const int slices = (group + kRows - 1) / kRows;
  const int h = blockIdx.y / slices;
  const int head0 = (blockIdx.y % slices) * kRows;
  const int rows = min(kRows, group - head0);
  const int cap = a.pages_per_seq * a.page_size;
  const size_t first = (size_t)b * a.q_heads + (size_t)h * group + head0;
  const int* table = a.tables + (size_t)b * a.pages_per_seq;
  const int lo = z * a.split_keys;
  // the table entry of this lane's key in the warp's first tile, read
  // beside the length instead of after it
  const int pos0 = lo + tile::kKeys * warp + lane;
  const int page0 = table[min(pos0 / a.page_size, a.pages_per_seq - 1)];
  // Q of the slice: unscaled, zeros past its heads
  const auto stage_q = [&] {
    for (int i = tid; i < kRows * kChunks; i += kThreads) {
      const int r = i / kChunks, c = (i % kChunks) * 8;
      tile::stage(sq + r * kStride + c, a.q + (first + r) * HD + c,
                  r < rows);
    }
  };
  if (z == 0) stage_q();   // CTA 0 always has work: Q before the length
  const int len = clamp_to(a.lengths[b], cap);
  int end = len;   // keys this pass walks
  int used = 0;    // shared splits merged in front
  if (kBranch) {
    const int g = a.row_group[b];
    const bool grouped = g >= 0 && g < a.num_groups;
    const int span = grouped ? clamp_to(a.shared_lens[g], cap) : 0;
    end = max(len - span, 0);
    used = grouped ? min(a.shared_n,
                         (min(len, span) + a.shared_keys - 1) / a.shared_keys)
                   : 0;
  }
  const int n_used =
      max(1, min(a.n_split, (end + a.split_keys - 1) / a.split_keys));
  if (n_used == 1 && z > 0) return;   // the keys start past the row's end
  const bool busy = z < n_used;       // the same for the whole CTA

  if (busy) {
    const int hi = min(lo + a.split_keys, end);
    const int n_tiles =
        hi > lo ? (hi - lo + tile::kKeys - 1) / tile::kKeys : 0;
    const int mine =
        n_tiles > warp ? (n_tiles - warp + kWarps - 1) / kWarps : 0;
    const int stages = stages_for<HD>(a.split_keys);
    // the first group: Q and, for CTA 0 of the branch pass, the used
    // shared splits' (m, l)
    if (z > 0) stage_q();
    if (kBranch && z == 0) {
      for (int i = tid; i < used * rows; i += kThreads) {
        const int s = i / rows, r = i % rows;
        const float* p =
            a.part + ((size_t)s * a.batch * a.q_heads + first + r) * (HD + 2);
        ptx::cp_async_4(sh_m + s * kRows + r, p + HD);
        ptx::cp_async_4(sh_l + s * kRows + r, p + HD + 1);
      }
    }
    ptx::cp_async_commit();

    // the warp's i-th tile into stage s: K, then V, one group each; lane
    // j finds key k0 + j's row of the pool
    bf16* tiles = reinterpret_cast<bf16*>(work) +
                  (size_t)warp * stages * 2 * L::kTile;
    const size_t head = (size_t)h * a.num_pages * a.page_size * HD;
    const auto gather = [&](int i, int s) {
      const int k0 = lo + tile::kKeys * (warp + kWarps * i);
      const int pos = k0 + lane;
      const int row =
          pos < hi ? tile::clamp_page(i == 0 ? page0
                                             : table[pos / a.page_size],
                                      a.num_pages) * a.page_size +
                         pos % a.page_size
                   : 0;
#pragma unroll
      for (int kv = 0; kv < 2; ++kv) {
        bf16* dst = tiles + (size_t)(2 * s + kv) * L::kTile;
        const bf16* src = (kv ? a.v_pages : a.k_pages) + head;
#pragma unroll (kGatherUnroll)
        for (int it = 0; it < kChunks; ++it) {
          const int idx = lane + 32 * it;
          const int j = idx / kChunks, c = (idx % kChunks) * 8;
          const int rj = __shfl_sync(0xffffffffu, row, j);
          tile::stage(dst + j * kStride + c, src + (size_t)rj * HD + c,
                      k0 + j < hi);
        }
        ptx::cp_async_commit();
      }
    };
    const int pre = min(stages, mine);
    for (int i = 0; i < pre; ++i) gather(i, i);
    ptx::cp_async_wait_n(2 * pre);   // the oldest group (Q, (m, l)) is in
    __syncthreads();

    float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
    float o[HD / 8][4];
#pragma unroll
    for (int n = 0; n < HD / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
    tile::QOperand<HD> qa;
    if (mine > 0) qa.load(sq, lane);
    const int lim[2] = {hi, hi};
    for (int i = 0; i < mine; ++i) {
      const int s = i % stages;
      const bf16* kt = tiles + (size_t)(2 * s) * L::kTile;
      // tiles i .. i + ahead - 1 are in flight, two groups each
      const int ahead = min(stages, mine - i);
      ptx::cp_async_wait_n(2 * ahead - 1);
      __syncwarp();   // every lane's K chunks (and zeros) are in
      float sc[tile::kKeys / 8][4];
      qa.qk(sc, kt, lane);
      const int k0 = lo + tile::kKeys * (warp + kWarps * i);
      tile::softmax<HD>(sc, m, l, o, k0 + 2 * (lane % 4), lim, a.scale);
      ptx::cp_async_wait_n(2 * ahead - 2);
      __syncwarp();   // V is in
      tile::pv<HD>(o, sc, kt + L::kTile, lane);
      if (i + stages < mine) {
        __syncwarp();   // stage s is consumed by every lane
        gather(i + stages, s);
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {   // m is already the quad's
      l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
      l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    }
    __syncthreads();   // every warp is done with its tiles
    // each warp's partials; a warp without a tile writes (NEG_INF, 0, 0)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = lane / 4 + 8 * i;
      float* dst = w_o + (warp * kRows + r) * kOS + 2 * (lane % 4);
#pragma unroll
      for (int n = 0; n < HD / 8; ++n)
        *reinterpret_cast<float2*>(dst + 8 * n) =
            make_float2(o[n][2 * i], o[n][2 * i + 1]);
      if (lane % 4 == 0) {
        w_m[warp * kRows + r] = m[i];
        w_l[warp * kRows + r] = l[i];
      }
    }
    __syncthreads();
    // the CTA's partial, its warps' merged in warp order; a thread takes
    // a float4 of a row's columns at a time
    for (int it = tid; it < rows * kQuads; it += kThreads) {
      const int r = it / kQuads, c = (it % kQuads) * 4;
      float mw[kWarps], mx = kNegInf;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        mw[w] = w_m[w * kRows + r];
        mx = fmaxf(mx, mw[w]);
      }
      float lt = 0.f;
      float4 ot = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        const float e = expf(mw[w] - mx);
        const float4 x =
            *reinterpret_cast<const float4*>(w_o + (w * kRows + r) * kOS + c);
        lt += w_l[w * kRows + r] * e;
        ot.x += x.x * e;
        ot.y += x.y * e;
        ot.z += x.z * e;
        ot.w += x.w * e;
      }
      *reinterpret_cast<float4*>(c_o + r * kOS + c) = ot;
      if (c == 0) {
        c_m[r] = mx;
        c_l[r] = lt;
      }
    }
  }
  // every CTA's partials are in its shared memory (the cluster's, where the
  // row spans several CTAs)
  if (n_used > 1) {
    __syncwarp();
    ptx::cluster_sync();
  } else {
    __syncthreads();
  }
  if (z == 0) {
    // the merge list, in order: the shared splits (branch pass), then
    // this pass's CTAs 0 .. n_used - 1; one max, then the weighted sums
    for (int it = tid; it < rows * kQuads; it += kThreads) {
      const int r = it / kQuads, c = (it % kQuads) * 4;
      // this pass's CTAs' partials, all read before any is used: CTA 0's
      // own from its shared memory, the others' over the cluster (a rank
      // past n_used reads CTA 0's and is dropped by the selects below)
      float mk[kMaxCluster], lk[kMaxCluster];
      float4 xk[kMaxCluster];
      mk[0] = c_m[r];
      lk[0] = c_l[r];
      xk[0] = *reinterpret_cast<const float4*>(c_o + r * kOS + c);
      if (n_used > 1) {
#pragma unroll
        for (int k = 1; k < kMaxCluster; ++k) {
          const uint32_t rank = k < n_used ? k : 0;
          mk[k] = ptx::ld_cluster(ptx::cluster_addr(c_m + r, rank));
          lk[k] = ptx::ld_cluster(ptx::cluster_addr(c_l + r, rank));
          xk[k] = ptx::ld_cluster_v4(
              ptx::cluster_addr(c_o + r * kOS + c, rank));
        }
      }
      float mx = kNegInf;
#pragma unroll
      for (int s = 0; s < kMaxShared; ++s)
        if (s < used) mx = fmaxf(mx, sh_m[s * kRows + r]);
#pragma unroll
      for (int k = 0; k < kMaxCluster; ++k)
        if (k < n_used) mx = fmaxf(mx, mk[k]);
      float lt = 0.f;
      float4 ot = make_float4(0.f, 0.f, 0.f, 0.f);
      if (kBranch) {
        // every split's loads go out before any is used (behind a branch
        // per split they would wait for each other in turn); a split past
        // `used` reads split 0 of the row, always in the tensor, and is
        // dropped by the select, not weighted by zero
        float2 x[kMaxShared][2];
#pragma unroll
        for (int s = 0; s < kMaxShared; ++s) {
          // a partial row is hd + 2 floats: 8-byte aligned, not 16
          const float2* p = reinterpret_cast<const float2*>(
              a.part + ((size_t)(s < used ? s : 0) * a.batch * a.q_heads +
                        first + r) * (HD + 2) + c);
          x[s][0] = p[0];
          x[s][1] = p[1];
        }
#pragma unroll
        for (int s = 0; s < kMaxShared; ++s) {
          if (s < used) {
            const float e = expf(sh_m[s * kRows + r] - mx);
            lt += sh_l[s * kRows + r] * e;
            ot.x += x[s][0].x * e;
            ot.y += x[s][0].y * e;
            ot.z += x[s][1].x * e;
            ot.w += x[s][1].y * e;
          }
        }
      }
#pragma unroll
      for (int k = 0; k < kMaxCluster; ++k) {
        if (k < n_used) {
          const float e = expf(mk[k] - mx);
          lt += lk[k] * e;
          ot.x += xk[k].x * e;
          ot.y += xk[k].y * e;
          ot.z += xk[k].z * e;
          ot.w += xk[k].w * e;
        }
      }
      const float inv = 1.f / fmaxf(lt, 1e-30f);
      __nv_bfloat162 out2[2] = {__floats2bfloat162_rn(ot.x * inv, ot.y * inv),
                                __floats2bfloat162_rn(ot.z * inv, ot.w * inv)};
      *reinterpret_cast<uint2*>(a.out + (first + r) * HD + c) =
          *reinterpret_cast<const uint2*>(out2);
    }
  }
  if (n_used > 1) {
    __syncwarp();
    ptx::cluster_sync();   // CTA 0 has read every partial
  }
}

namespace {
// Whether this library has raised the kernel's dynamic shared memory
// limit: one flag per instantiation and per library (internal linkage; a
// static local of an inline template would be one symbol shared by every
// library that instantiates it).
template <int HD, bool kBranch>
bool smem_raised = false;
}  // namespace

// Launches decode_mma_kernel<HD, kBranch> over a grid of (n_split,
// kv_heads x 16-head slices, batch), as clusters of n_split CTAs when
// n_split > 1; returns the cudaError_t of the launch.
template <int HD, bool kBranch>
int launch(const Args& a, cudaStream_t s) {
  const int group = a.q_heads / a.kv_heads;
  if (group < 1 || group > kMaxRows || a.split_keys < tile::kKeys ||
      a.split_keys % tile::kKeys || a.n_split < 1 ||
      a.n_split > kMaxCluster ||
      (long long)a.split_keys * a.n_split <
          (long long)a.pages_per_seq * a.page_size ||
      a.batch > 65535 || (kBranch && (a.shared_n < 1 ||
                                      a.shared_n > kMaxShared ||
                                      a.shared_keys < 1)))
    return (int)cudaErrorInvalidValue;
  const auto kernel = decode_mma_kernel<HD, kBranch>;
  if (!smem_raised<HD, kBranch>) {   // once: the largest layout's
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)Layout<HD>::bytes(max_stages<HD>()));
    if (err != cudaSuccess) return (int)err;
    smem_raised<HD, kBranch> = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(a.n_split, a.kv_heads * ((group + kRows - 1) / kRows),
                     a.batch);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes =
      Layout<HD>::bytes(stages_for<HD>(a.split_keys));
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = a.n_split;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = a.n_split > 1 ? 1 : 0;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, a);
  return (int)(err != cudaSuccess ? err : cudaGetLastError());
}

// Calls f(std::integral_constant<int, HD>{}) for head_dim 32, 64, 128 or
// 256; returns false for any other.
template <typename F>
static bool dispatch_hd(int head_dim, F&& f) {
  if (head_dim == 128) f(std::integral_constant<int, 128>{});
  else if (head_dim == 256) f(std::integral_constant<int, 256>{});
  else if (head_dim == 64) f(std::integral_constant<int, 64>{});
  else if (head_dim == 32) f(std::integral_constant<int, 32>{});
  else return false;
  return true;
}

}  // namespace decode
}  // namespace paged
