// Tree (cascade) decode attention for Hopper (sm_90a): the decode rows of
// one step split over a fork-group map, so the pages that the rows of a
// fork group share are streamed once for all of them.
//
// Replaces the TPU kernel pair of
// repro/kernels/paged_attention/tree_decode.py (paged_tree_attention_fwd):
//   * tree_shared_kernel  <- _tree_shared_kernel (:170): each group's
//     shared pages, once for the group's member rows, as raw fp32
//     online-softmax partials (m, l, acc);
//   * tree_branch_kernel  <- _tree_branch_kernel (:229) plus the plain jnp
//     merge (:368-382): each row's post-fork suffix pages, then, in the
//     epilogue, the merge with the row's shared partials and the division.
// Same output contract as paged_decode.cu over the full tables the map
// decomposes, including exact zeros for a row of length 0.
//
// The map (built on the host by repro_torch.kv.tree_decode_map):
// row_group[b] names row b's group, and a value outside [0, G) means the
// row is in no group; group g's shared pages are shared_bt[g] and cover
// shared_lens[g] tokens (whole pages); branch_bt[b] is row b's suffix
// table, zero-based, covering max(lengths[b] - span(b), 0) tokens.
//
// What bounds it on this card: bytes, as K1 (4 * group * head_dim flops
// per key read). Design:
//   * Shared pass: one CTA per (KV head, group, slice of members). The
//     CTA finds its group's member rows itself (a scan of row_group; the
//     Pallas grid instead computed every row and masked non-members) and
//     streams the shared pages once through shared memory for
//     floor(32 / group) members x group query heads. A group with more
//     members than that is split over several CTAs, which read the same
//     pages again, from L2 when they run together: kept over one CTA
//     holding up to 16 x 7 = 112 query rows in dynamic shared memory,
//     because the step is latency-bound and more CTAs finish sooner.
//     A member row attends keys < min(length, span).
//   * Branch pass: one CTA per (row, KV head), K1's loop over the suffix
//     table; the merge runs in its epilogue, so the step pays no eager
//     merge ops. Partials of rows in no group are never written, and the
//     epilogue does not read them (it tests row_group, it does not rely on
//     a memset).
//   * The finite NEG_INF = -1e30 of the TPU kernels keeps the merge of two
//     empty partials at exp(0) * 0 = 0, never inf - inf.
// Table entries are clamped into the pool and loops stop at lengths (see
// paged_common.cuh), so NaN in a stale page cannot reach a sum.
#include "paged_common.cuh"

using namespace paged;

__device__ __forceinline__ int clamp_to(int x, int cap) {
  return x < 0 ? 0 : (x > cap ? cap : x);
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads) tree_shared_kernel(
    const T* __restrict__ q, const T* __restrict__ k_pages,
    const T* __restrict__ v_pages, const int* __restrict__ row_group,
    const int* __restrict__ shared_bt, const int* __restrict__ shared_lens,
    const int* __restrict__ lengths, float* __restrict__ m_out,
    float* __restrict__ l_out, float* __restrict__ acc_out, int batch,
    int q_heads, int kv_heads, int num_pages, int page_size,
    int pages_per_seq, int members_per_cta, float scale) {
  __shared__ Shared<HD> sm;
  __shared__ int member[kMaxRows];
  __shared__ int n_members, ctx_end;
  constexpr int kStep = Dims<HD>::kStep;
  constexpr int kPer = Dims<HD>::kPer;
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
  float acc[kPer];
#pragma unroll
  for (int i = 0; i < kPer; ++i) acc[i] = 0.f;

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
      acc_out[dst * HD + d] = acc[i];
      if (d == 0) {
        m_out[dst] = sm.m[r];
        l_out[dst] = sm.l[r];
      }
    }
  }
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads) tree_branch_kernel(
    const T* __restrict__ q, const T* __restrict__ k_pages,
    const T* __restrict__ v_pages, const int* __restrict__ row_group,
    const int* __restrict__ shared_lens, const int* __restrict__ branch_bt,
    const int* __restrict__ lengths, const float* __restrict__ m_shared,
    const float* __restrict__ l_shared, const float* __restrict__ acc_shared,
    T* __restrict__ out, int q_heads, int kv_heads, int num_pages,
    int page_size, int pages_per_seq, int num_groups, float scale) {
  __shared__ Shared<HD> sm;
  constexpr int kStep = Dims<HD>::kStep;
  constexpr int kPer = Dims<HD>::kPer;
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
    sm.q[i / HD][i % HD] = to_f32(q[q_row + i]) * scale;
  init_rows(sm);
  if (tid < kMaxRows) sm.row_end[tid] = suffix;
  float acc[kPer];
#pragma unroll
  for (int i = 0; i < kPer; ++i) acc[i] = 0.f;

  const size_t head = (size_t)h * num_pages * page_size * HD;
  stream_pages<T, HD>(sm, acc, k_pages + head, v_pages + head,
                      branch_bt + (size_t)b * pages_per_seq, pages_per_seq,
                      num_pages, page_size, suffix, group);

  // merge with the shared pass's partials (disjoint key sets), then divide
  const int d = tid % HD;
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int r = tid / HD + i * kStep;
    if (r < group) {
      float l = sm.l[r], o = acc[i];
      if (grouped) {
        const size_t idx = (size_t)b * q_heads + (size_t)h * group + r;
        const float ms = m_shared[idx], mb = sm.m[r];
        const float mx = fmaxf(ms, mb);
        const float as = expf(ms - mx), ab = expf(mb - mx);
        l = l_shared[idx] * as + l * ab;
        o = acc_shared[idx * HD + d] * as + o * ab;
      }
      store(out + q_row + (size_t)r * HD + d, o / fmaxf(l, 1e-30f));
    }
  }
}

// Launchers: each returns the cudaError_t of its launch (0 on success).
// dtype: 0 = fp32, 1 = bf16. The caller has checked shapes, dtypes and
// contiguity; q_heads / kv_heads must not exceed 32.
extern "C" int tree_shared_launch(
    int dtype, int head_dim, const void* q, const void* k_pages,
    const void* v_pages, const void* row_group, const void* shared_bt,
    const void* shared_lens, const void* lengths, void* m_out, void* l_out,
    void* acc_out, int batch, int q_heads, int kv_heads, int num_pages,
    int page_size, int pages_per_seq, int num_groups, float scale,
    void* stream) {
  const int group = q_heads / kv_heads;
  if (group < 1 || group > kMaxRows) return (int)cudaErrorInvalidValue;
  const int per_cta = kMaxRows / group;
  const dim3 grid(kv_heads, num_groups, (batch + per_cta - 1) / per_cta);
  cudaStream_t s = (cudaStream_t)stream;
  const bool ok = dispatch(dtype, head_dim, [&](auto t, auto hd) {
    using T = decltype(t);
    constexpr int HD = decltype(hd)::value;
    tree_shared_kernel<T, HD><<<grid, kThreads, 0, s>>>(
        (const T*)q, (const T*)k_pages, (const T*)v_pages,
        (const int*)row_group, (const int*)shared_bt,
        (const int*)shared_lens, (const int*)lengths, (float*)m_out,
        (float*)l_out, (float*)acc_out, batch, q_heads, kv_heads, num_pages,
        page_size, pages_per_seq, per_cta, scale);
  });
  if (!ok) return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

extern "C" int tree_branch_launch(
    int dtype, int head_dim, const void* q, const void* k_pages,
    const void* v_pages, const void* row_group, const void* shared_lens,
    const void* branch_bt, const void* lengths, const void* m_shared,
    const void* l_shared, const void* acc_shared, void* out, int batch,
    int q_heads, int kv_heads, int num_pages, int page_size,
    int pages_per_seq, int num_groups, float scale, void* stream) {
  const int group = q_heads / kv_heads;
  if (group < 1 || group > kMaxRows) return (int)cudaErrorInvalidValue;
  const dim3 grid(batch, kv_heads);
  cudaStream_t s = (cudaStream_t)stream;
  const bool ok = dispatch(dtype, head_dim, [&](auto t, auto hd) {
    using T = decltype(t);
    constexpr int HD = decltype(hd)::value;
    tree_branch_kernel<T, HD><<<grid, kThreads, 0, s>>>(
        (const T*)q, (const T*)k_pages, (const T*)v_pages,
        (const int*)row_group, (const int*)shared_lens,
        (const int*)branch_bt, (const int*)lengths, (const float*)m_shared,
        (const float*)l_shared, (const float*)acc_shared, (T*)out, q_heads,
        kv_heads, num_pages, page_size, pages_per_seq, num_groups, scale);
  });
  if (!ok) return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
