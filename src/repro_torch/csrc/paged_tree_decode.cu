// Tree (cascade) decode attention for Hopper (sm_90a): the decode rows of
// one step split over a fork-group map, so the pages that the rows of a
// fork group share are streamed once for all of them.
//
// Replaces the TPU kernel pair of
// repro/kernels/paged_attention/tree_decode.py (paged_tree_attention_fwd):
//   * the shared pass <- _tree_shared_kernel (:170): each group's shared
//     pages, once for the group's member rows, as raw fp32 online-softmax
//     partials (m, l, acc) — per key split in bf16
//     (tree_shared_mma_kernel), over the whole span in fp32
//     (tree_shared_kernel) — packed in one tensor, a row of head_dim + 2
//     floats (acc, m, l) per split, row and head, so the wrapper makes one
//     allocation for them;
//   * the branch pass <- _tree_branch_kernel (:229) plus the plain jnp
//     merge (:368-382): each row's post-fork suffix pages, then the merge
//     with the row's shared partials and the division. bf16: the
//     split-key decode core of paged_decode_mma.cuh
//     (decode_mma_kernel<HD, true>), K1's kernel over the suffix tables
//     with the shared splits put in front of its merge; fp32:
//     tree_branch_kernel, PR 11's CUDA-core loop.
// Same output contract as paged_decode.cu over the full tables the map
// decomposes, including exact zeros for a row of length 0.
//
// The map (built on the host by repro_torch.kv.tree_decode_map):
// row_group[b] names row b's group, and a value outside [0, G) means the
// row is in no group; group g's shared pages are shared_bt[g] and cover
// shared_lens[g] tokens (whole pages); branch_bt[b] is row b's suffix
// table, zero-based, covering max(lengths[b] - span(b), 0) tokens.
//
// What bounds it on this card: bytes in principle (4 * group * head_dim
// flops per key read, as K1), but at the serving shapes (16 rows, a
// 256-token span, 2 MB of K/V) latency: the time is the depth of the
// dependent chain each CTA walks, not the bytes. Design:
//   * Shared pass, bf16: one CTA per (key split, KV head, group). The span
//     is cut into n_split runs of split_keys keys (whole pages, at least
//     32; the wrapper's rule), so a group's span is walked by many CTAs at
//     once instead of one CTA walking it all. A CTA finds its group's
//     members itself (a ballot over row_group), holds up to 64 rows
//     (floor(64 / group) members x group heads; a larger group is walked
//     slice by slice), gathers 32-key tiles through the table with
//     cp.async and runs both products on the mma.sync tiles of
//     paged_decode_mma.cuh (bf16 in, fp32 accumulators; P split into bf16
//     hi and lo so that the probabilities keep fp32's precision). Keys past
//     the CTA's last visible key are zero-filled in shared memory, never
//     loaded: a tensor core computes 0 * NaN = NaN, so a stale page must
//     not reach a tile. Every split of every member row is written,
//     (NEG_INF, 0, 0) where it holds no visible key, so the branch pass
//     never reads torch.empty bytes.
//   * Shared pass, fp32: the CUDA-core loop of paged_common.cuh over the
//     whole span as a single split: bf16 tensor-core products cannot meet
//     fp32's tolerance.
//   * Branch pass: merges the shared splits in split order, 0 .. n_split -
//     1, then the suffix (a fixed order: the result does not change from
//     run to run, no atomics), and divides. Partials of rows in no group
//     are never written, and the branch pass does not read them (it tests
//     row_group, it does not rely on a memset).
//   * The finite NEG_INF = -1e30 of the TPU kernels keeps the merge of two
//     empty partials at exp(0) * 0 = 0, never inf - inf.
// Table entries are clamped into the pool and loops stop at lengths (see
// paged_common.cuh), so NaN in a stale page cannot reach a sum.
// Head_dim 32, 64, 128 and 256, each its own instantiation. At 256
// (gemma-7b) the bf16 shared pass reads Q's fragments from shared memory
// in each product (tile::QOperand; o alone is 128 registers a thread), and
// every pass whose shared tile passes the 48 KB static limit (the bf16
// shared pass's ~67 KB, the fp32 loop's ~66.5 KB) takes it as dynamic
// shared memory.
#include "paged_decode_mma.cuh"

using namespace paged;

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads) tree_shared_kernel(
    const T* __restrict__ q, const T* __restrict__ k_pages,
    const T* __restrict__ v_pages, const int* __restrict__ row_group,
    const int* __restrict__ shared_bt, const int* __restrict__ shared_lens,
    const int* __restrict__ lengths, float* __restrict__ part, int batch,
    int q_heads, int kv_heads, int num_pages, int page_size,
    int pages_per_seq, int members_per_cta, float scale) {
  Shared<HD>& sm = shared_struct<Shared<HD>>();
  __shared__ int member[kMaxRows];
  __shared__ int n_members, ctx_end;
  constexpr int kStep = Dims<HD>::kStep;
  constexpr int kPer = Dims<HD>::kPer;
  constexpr int kCols = Dims<HD>::kCols;
  const int h = blockIdx.x, g = blockIdx.y, tid = threadIdx.x;
  const int group = q_heads / kv_heads;
  const int cap = pages_per_seq * page_size;
  const int span = clamp_to(shared_lens[g], cap);
  if (tid == 0) {
    // this CTA's members: the blockIdx.z-th slice of the rows of group g
    const int first = blockIdx.z * members_per_cta;
    int k = 0, n = 0, end = 0;
    for (int b = 0; b < batch && n < members_per_cta; ++b) {
      if (row_group[b] != g) continue;
      if (k++ < first) continue;
      member[n++] = b;
      end = max(end, min(clamp_to(lengths[b], cap), span));
    }
    n_members = n;
    ctx_end = end;
  }
  __syncthreads();
  const int nm = n_members;
  if (nm == 0) return;  // the same for every thread of the CTA
  const int rows = nm * group;  // row r: member r / group, head r % group

  for (int i = tid; i < rows * HD; i += kThreads) {
    const int r = i / HD, c = i % HD;
    const size_t src =
        (size_t)member[r / group] * q_heads + (size_t)h * group + r % group;
    sm.q[r][c] = to_f32(q[src * HD + c]) * scale;
  }
  init_rows(sm);
  if (tid < kMaxRows)
    sm.row_end[tid] =
        tid < rows ? min(clamp_to(lengths[member[tid / group]], cap), span)
                   : 0;
  float acc[Dims<HD>::kAcc];
#pragma unroll
  for (int i = 0; i < Dims<HD>::kAcc; ++i) acc[i] = 0.f;

  const size_t head = (size_t)h * num_pages * page_size * HD;
  stream_pages<T, HD>(sm, acc, k_pages + head, v_pages + head,
                      shared_bt + (size_t)g * pages_per_seq, pages_per_seq,
                      num_pages, page_size, ctx_end, rows);

  const int d = tid % HD;
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int r = tid / HD + i * kStep;
    if (r < rows) {
      const size_t dst =
          (size_t)member[r / group] * q_heads + (size_t)h * group + r % group;
      float* out = part + dst * (HD + 2);
#pragma unroll
      for (int c = 0; c < kCols; ++c)
        out[d + c * kThreads] = acc[i * kCols + c];
      if (d == 0) {
        out[HD] = sm.m[r];
        out[HD + 1] = sm.l[r];
      }
    }
  }
}

// The bf16 shared pass on tensor-core tiles: one CTA per (key split, KV
// head, group). It holds up to 64 member rows (floor(64 / group) members
// x group query heads; a larger group is walked slice by slice) and
// attends keys [split * split_keys, (split + 1) * split_keys) of the span
// in 32-key tiles gathered through the group's table with cp.async. Each
// warp owns 16 rows: S = Q K^T and O += P V are the mma.sync m16n8k16
// tiles of paged_decode_mma.cuh (bf16 in, fp32 accumulators, V read
// transposed, P split hi/lo), and the split's raw partials (m, l, acc) are
// written for every member row, (NEG_INF, 0, 0) where the split holds no
// visible key.
namespace split {
constexpr int kRows = 64;         // member rows of one CTA: 4 warps x 16
constexpr int kKeys = tile::kKeys;

template <int HD>
struct Tiles {
  static constexpr int kStride = tile::stride<HD>();
  __nv_bfloat16 q[kRows][kStride];
  __nv_bfloat16 k[kKeys][kStride];
  __nv_bfloat16 v[kKeys][kStride];
  int member[kRows];       // the slice's member rows, in rank order
  int member_end[kRows];   // each one's end in the span: min(length, span)
  int tile_page[kKeys];    // the split's first tile: each key's page
  int n_members, ctx_end;
};
}  // namespace split

template <int HD>
__global__ void __launch_bounds__(kThreads) tree_shared_mma_kernel(
    const __nv_bfloat16* __restrict__ q,
    const __nv_bfloat16* __restrict__ k_pages,
    const __nv_bfloat16* __restrict__ v_pages,
    const int* __restrict__ row_group, const int* __restrict__ shared_bt,
    const int* __restrict__ shared_lens, const int* __restrict__ lengths,
    float* __restrict__ part, int batch, int q_heads, int kv_heads,
    int num_pages, int page_size, int pages_per_seq, int split_keys,
    float scale) {
  split::Tiles<HD>& sm = shared_struct<split::Tiles<HD>>();
  static_assert(split::kKeys == 32, "warp 1 reads a tile's pages by lane");
  constexpr int kChunks = HD / 8;      // 16-byte chunks per row
  const int z = blockIdx.x, h = blockIdx.y, g = blockIdx.z;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int group = q_heads / kv_heads;
  const int per_cta = split::kRows / group;
  const int cap = pages_per_seq * page_size;
  const int span = clamp_to(shared_lens[g], cap);
  const int lo = z * split_keys;
  // the last split takes every key from its start
  const int hi =
      z == (int)gridDim.x - 1 ? span : min(lo + split_keys, span);
  const int* table = shared_bt + (size_t)g * pages_per_seq;
  const size_t head = (size_t)h * num_pages * page_size * HD;
  const size_t split_off = (size_t)z * batch * q_heads;

  // the first tile's pages, read while warp 0 finds the members (a tile is
  // 32 keys, one per lane; a padding group's CTA reads none)
  if (warp == 1) {
    const int pos = lo + lane;
    sm.tile_page[lane] =
        tile::clamp_page(pos < hi ? table[pos / page_size] : 0, num_pages);
  }
  // stages keys [k0, k0 + 32) of K and V; keys at or past kv_hi are zeros,
  // never stale bytes: 0 * NaN would poison P V
  const auto load_tile = [&](int k0, int kv_hi, bool first_tile) {
    for (int i = tid; i < split::kKeys * kChunks; i += kThreads) {
      const int j = i / kChunks, c = (i % kChunks) * 8;
      const int pos = k0 + j;
      const bool visible = pos < kv_hi;
      size_t off = 0;
      if (visible) {
        const int page = tile::clamp_page(
            first_tile ? sm.tile_page[j] : table[pos / page_size],
            num_pages);
        off = head + ((size_t)page * page_size + pos % page_size) * HD + c;
      }
      tile::stage(&sm.k[j][c], k_pages + off, visible);
      tile::stage(&sm.v[j][c], v_pages + off, visible);
    }
  };

  for (int first = 0;; first += per_cta) {
    __syncthreads();  // the previous slice is consumed
    if (warp == 0) {
      // the members of group g ranked first .. first + per_cta - 1, and
      // where each one's view of the span ends
      int seen = 0, end = 0;
      for (int b0 = 0; b0 < batch; b0 += 32) {
        const int bb = b0 + lane;
        const int rgb = bb < batch ? row_group[bb] : -1;
        const int len = bb < batch ? lengths[bb] : 0;
        const bool is = rgb == g;
        const unsigned mask = __ballot_sync(0xffffffffu, is);
        const int rank = seen + __popc(mask & ((1u << lane) - 1));
        if (is && rank >= first && rank < first + per_cta) {
          const int e = min(clamp_to(len, cap), span);
          sm.member[rank - first] = bb;
          sm.member_end[rank - first] = e;
          end = max(end, e);
        }
        seen += __popc(mask);
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        end = max(end, __shfl_xor_sync(0xffffffffu, end, off));
      if (lane == 0) {
        sm.n_members = min(max(seen - first, 0), per_cta);
        sm.ctx_end = end;
      }
    }
    __syncthreads();
    const int nm = sm.n_members;
    if (nm == 0) return;  // the same for every thread of the CTA
    const int rows = nm * group;  // row r: member r / group, head r % group
    const int kv_hi = min(hi, sm.ctx_end);   // no key at or past it loads

    // Q (unscaled; zeros past the member rows) and the first K/V tile in
    // one batch of copies; a split with no visible key needs neither
    for (int i = tid; lo < kv_hi && i < split::kRows * kChunks;
         i += kThreads) {
      const int r = i / kChunks, c = (i % kChunks) * 8;
      tile::stage(&sm.q[r][c],
                  q + (r < rows ? ((size_t)sm.member[r / group] * q_heads +
                                   (size_t)h * group + r % group) * HD + c
                                : 0),
                  r < rows);
    }
    if (lo < kv_hi) load_tile(lo, kv_hi, true);
    ptx::cp_async_wait_all();
    __syncthreads();

    // this thread holds rows r0 and r0 + 8 of its warp's 16; row r sees
    // keys [lo, min(its member's end, hi))
    const int r0 = warp * 16 + lane / 4;
    const bool active = warp * 16 < rows;   // the same for the whole warp
    int lim[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = r0 + 8 * i;
      lim[i] = r < rows ? min(sm.member_end[r / group], kv_hi) : 0;
    }
    tile::QOperand<HD> qa;
    if (active && lo < kv_hi) qa.load(&sm.q[warp * 16][0], lane);
    float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
    float o[HD / 8][4];
#pragma unroll
    for (int n = 0; n < HD / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[n][e] = 0.f;

    for (int k0 = lo; k0 < kv_hi; k0 += split::kKeys) {
      if (k0 != lo) {   // the first tile came with Q
        __syncthreads();  // the previous tile is consumed
        load_tile(k0, kv_hi, false);
        ptx::cp_async_wait_all();
        __syncthreads();
      }
      if (!active) continue;

      float sc[split::kKeys / 8][4];
      qa.qk(sc, &sm.k[0][0], lane);
      // row r0 + 8 i's keys count while they are < lim[i]
      tile::softmax<HD>(sc, m, l, o, k0 + 2 * (lane % 4), lim, scale);
      tile::pv<HD>(o, sc, &sm.v[0][0], lane);
    }

    // this split's raw partials of every member row
    if (active) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        float lt = l[i];
        lt += __shfl_xor_sync(0xffffffffu, lt, 1);
        lt += __shfl_xor_sync(0xffffffffu, lt, 2);
        const int r = r0 + 8 * i;
        if (r >= rows) continue;
        const size_t idx = split_off +
                           (size_t)sm.member[r / group] * q_heads +
                           (size_t)h * group + r % group;
        float* out = part + idx * (HD + 2);  // 8-byte aligned: HD + 2 even
        if (lane % 4 == 0) {
          out[HD] = m[i];
          out[HD + 1] = lt;
        }
        float* dst = out + 2 * (lane % 4);
#pragma unroll
        for (int n = 0; n < HD / 8; ++n)
          *reinterpret_cast<float2*>(dst + 8 * n) =
              make_float2(o[n][2 * i], o[n][2 * i + 1]);
      }
    }
  }
}

// The fp32 branch pass: one CTA per (row, KV head), K1's CUDA-core loop
// over the suffix table, the shared partials (one split in fp32) merged in
// the epilogue.
template <int HD>
__global__ void __launch_bounds__(kThreads) tree_branch_kernel(
    const float* __restrict__ q, const float* __restrict__ k_pages,
    const float* __restrict__ v_pages, const int* __restrict__ row_group,
    const int* __restrict__ shared_lens, const int* __restrict__ branch_bt,
    const int* __restrict__ lengths, const float* __restrict__ part,
    float* __restrict__ out, int batch, int q_heads, int kv_heads, int num_pages,
    int page_size, int pages_per_seq, int num_groups, int split_keys,
    int n_split, float scale) {
  Shared<HD>& sm = shared_struct<Shared<HD>>();
  constexpr int kStep = Dims<HD>::kStep;
  constexpr int kPer = Dims<HD>::kPer;
  constexpr int kCols = Dims<HD>::kCols;
  const int b = blockIdx.x, h = blockIdx.y, tid = threadIdx.x;
  const int group = q_heads / kv_heads;
  const int cap = pages_per_seq * page_size;
  const int len = clamp_to(lengths[b], cap);
  const int g = row_group[b];
  const bool grouped = g >= 0 && g < num_groups;
  const int span = grouped ? clamp_to(shared_lens[g], cap) : 0;
  const int suffix = max(len - span, 0);

  const size_t q_row = ((size_t)b * q_heads + (size_t)h * group) * HD;
  for (int i = tid; i < group * HD; i += kThreads)
    sm.q[i / HD][i % HD] = q[q_row + i] * scale;
  init_rows(sm);
  if (tid < kMaxRows) sm.row_end[tid] = suffix;
  float acc[Dims<HD>::kAcc];
#pragma unroll
  for (int i = 0; i < Dims<HD>::kAcc; ++i) acc[i] = 0.f;

  const size_t head = (size_t)h * num_pages * page_size * HD;
  stream_pages<float, HD>(sm, acc, k_pages + head, v_pages + head,
                      branch_bt + (size_t)b * pages_per_seq, pages_per_seq,
                      num_pages, page_size, suffix, group);

  // merge the shared pass's split partials in split order, then the
  // suffix's (disjoint key sets), then divide. Splits at or past the row's
  // visible end min(length, span) hold (NEG_INF, 0, 0), which the merge
  // leaves bit for bit unchanged, so they are not read.
  const int d = tid % HD;
  const int used =
      grouped ? min(n_split, (min(len, span) + split_keys - 1) / split_keys)
              : 0;   // (the last split holds every key past its start)
  const size_t split_stride = (size_t)batch * q_heads;
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int r = tid / HD + i * kStep;
    if (r < group) {
      float m = sm.m[r], l = sm.l[r], o[kCols];
#pragma unroll
      for (int c = 0; c < kCols; ++c) o[c] = acc[i * kCols + c];
      if (grouped) {
        const size_t idx = (size_t)b * q_heads + (size_t)h * group + r;
        float ms = kNegInf, ls = 0.f, os[kCols];
#pragma unroll
        for (int c = 0; c < kCols; ++c) os[c] = 0.f;
#pragma unroll 1
        for (int z = 0; z < used; ++z) {
          const float* pz = part + (z * split_stride + idx) * (HD + 2);
          const float mz = pz[HD];
          const float mx = fmaxf(ms, mz);
          const float a = expf(ms - mx), az = expf(mz - mx);
          ls = ls * a + pz[HD + 1] * az;
#pragma unroll
          for (int c = 0; c < kCols; ++c)
            os[c] = os[c] * a + pz[d + c * kThreads] * az;
          ms = mx;
        }
        const float mx = fmaxf(ms, m);
        const float as = expf(ms - mx), ab = expf(m - mx);
        l = ls * as + l * ab;
#pragma unroll
        for (int c = 0; c < kCols; ++c) o[c] = os[c] * as + o[c] * ab;
      }
#pragma unroll
      for (int c = 0; c < kCols; ++c)
        out[q_row + (size_t)r * HD + d + c * kThreads] =
            o[c] / fmaxf(l, 1e-30f);
    }
  }
}

namespace {
// Whether this library has raised a kernel's dynamic shared memory limit
// (the head_dim-256 instantiations; internal linkage: one flag per
// library): the bf16 shared pass's by its tile struct, the fp32 passes'
// by head_dim.
template <typename S>
bool mma_smem_raised = false;
template <int HD>
bool shared_f32_raised = false;
template <int HD>
bool branch_f32_raised = false;
}  // namespace

// Launchers: each returns the cudaError_t of its launch (0 on success).
// dtype: 0 = fp32, 1 = bf16. The caller has checked shapes, dtypes and
// contiguity; q_heads / kv_heads must not exceed 32. The shared pass
// writes fp32 partials [n_split, batch, q_heads, head_dim + 2], each row
// acc (head_dim) then m then l: bf16 splits the span into n_split runs of
// split_keys keys, the last run taking every key from its start; fp32
// runs the CUDA-core loop over the whole span (n_split = 1).
extern "C" int tree_shared_launch(
    int dtype, int head_dim, const void* q, const void* k_pages,
    const void* v_pages, const void* row_group, const void* shared_bt,
    const void* shared_lens, const void* lengths, void* part, int batch,
    int q_heads, int kv_heads, int num_pages,
    int page_size, int pages_per_seq, int num_groups, int split_keys,
    int n_split, float scale, void* stream) {
  const int group = q_heads / kv_heads;
  if (group < 1 || group > kMaxRows) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 1) {
    if (split_keys < 1 || n_split < 1) return (int)cudaErrorInvalidValue;
    // groups slowest, so the real (low-numbered) groups start first
    const dim3 grid(n_split, kv_heads, num_groups);
    using bf16 = __nv_bfloat16;
    int rc = (int)cudaErrorInvalidValue;
    decode::dispatch_hd(head_dim, [&](auto hd) {
      constexpr int HD = decltype(hd)::value;
      using S = split::Tiles<HD>;
      const auto kernel = tree_shared_mma_kernel<HD>;
      rc = (int)opt_in_smem<S>(kernel, mma_smem_raised<S>);
      if (rc != 0) return;
      kernel<<<grid, kThreads, dynamic_smem<S>(), s>>>(
          (const bf16*)q, (const bf16*)k_pages, (const bf16*)v_pages,
          (const int*)row_group, (const int*)shared_bt,
          (const int*)shared_lens, (const int*)lengths, (float*)part, batch,
          q_heads, kv_heads, num_pages, page_size, pages_per_seq,
          split_keys, scale);
      rc = (int)cudaGetLastError();
    });
    return rc;
  }
  if (dtype != 0 || n_split != 1) return (int)cudaErrorInvalidValue;
  const int per_cta = kMaxRows / group;
  const dim3 grid(kv_heads, num_groups, (batch + per_cta - 1) / per_cta);
  int rc = (int)cudaErrorInvalidValue;
  decode::dispatch_hd(head_dim, [&](auto hd) {
    constexpr int HD = decltype(hd)::value;
    const auto kernel = tree_shared_kernel<float, HD>;
    rc = (int)opt_in_smem<Shared<HD>>(kernel, shared_f32_raised<HD>);
    if (rc != 0) return;
    kernel<<<grid, kThreads, dynamic_smem<Shared<HD>>(), s>>>(
        (const float*)q, (const float*)k_pages, (const float*)v_pages,
        (const int*)row_group, (const int*)shared_bt,
        (const int*)shared_lens, (const int*)lengths, (float*)part, batch,
        q_heads, kv_heads, num_pages, page_size, pages_per_seq, per_cta,
        scale);
    rc = (int)cudaGetLastError();
  });
  return rc;
}

// The branch pass merges the shared pass's split partials (in split order,
// split z covering span keys [z * shared_keys, (z + 1) * shared_keys), the
// last every key from its start) before the row's own suffix. split_keys
// and n_split are the bf16 kernel's own key splits over the suffix tables
// (ref.py: decode_splits; fp32 takes the whole table as one split).
extern "C" int tree_branch_launch(
    int dtype, int head_dim, const void* q, const void* k_pages,
    const void* v_pages, const void* row_group, const void* shared_lens,
    const void* branch_bt, const void* lengths, const void* part,
    void* out, int batch,
    int q_heads, int kv_heads, int num_pages, int page_size,
    int pages_per_seq, int num_groups, int shared_keys, int shared_n,
    int split_keys, int n_split, float scale, void* stream) {
  const int group = q_heads / kv_heads;
  if (group < 1 || group > kMaxRows || shared_n < 1 || shared_keys < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 1) {
    decode::Args a = {};
    a.q = (const __nv_bfloat16*)q;
    a.k_pages = (const __nv_bfloat16*)k_pages;
    a.v_pages = (const __nv_bfloat16*)v_pages;
    a.tables = (const int*)branch_bt;
    a.lengths = (const int*)lengths;
    a.out = (__nv_bfloat16*)out;
    a.row_group = (const int*)row_group;
    a.shared_lens = (const int*)shared_lens;
    a.part = (const float*)part;
    a.num_groups = num_groups;
    a.shared_keys = shared_keys;
    a.shared_n = shared_n;
    a.batch = batch;
    a.q_heads = q_heads;
    a.kv_heads = kv_heads;
    a.num_pages = num_pages;
    a.page_size = page_size;
    a.pages_per_seq = pages_per_seq;
    a.split_keys = split_keys;
    a.n_split = n_split;
    a.scale = scale;
    int rc = (int)cudaErrorInvalidValue;
    decode::dispatch_hd(head_dim, [&](auto hd) {
      rc = decode::launch<decltype(hd)::value, true>(a, s);
    });
    return rc;
  }
  if (dtype != 0 || n_split != 1) return (int)cudaErrorInvalidValue;
  const dim3 grid(batch, kv_heads);
  int rc = (int)cudaErrorInvalidValue;
  decode::dispatch_hd(head_dim, [&](auto hd) {
    constexpr int HD = decltype(hd)::value;
    const auto kernel = tree_branch_kernel<HD>;
    rc = (int)opt_in_smem<Shared<HD>>(kernel, branch_f32_raised<HD>);
    if (rc != 0) return;
    kernel<<<grid, kThreads, dynamic_smem<Shared<HD>>(), s>>>(
        (const float*)q, (const float*)k_pages, (const float*)v_pages,
        (const int*)row_group, (const int*)shared_lens,
        (const int*)branch_bt, (const int*)lengths, (const float*)part,
        (float*)out, batch, q_heads, kv_heads, num_pages, page_size,
        pages_per_seq, num_groups, shared_keys, shared_n, scale);
    rc = (int)cudaGetLastError();
  });
  return rc;
}
