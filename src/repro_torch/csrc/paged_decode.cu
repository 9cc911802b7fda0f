// Paged flash-decode for Hopper (sm_90a): one query token per row against
// the row's paged K/V, GQA-native.
//
// Replaces the TPU kernel repro/kernels/paged_attention/paged_attention.py
// (paged_attention_decode, body _decode_kernel); same inputs, same output
// contract, including exact zeros for a row of length 0.
//
// What bounds it on this card: bytes. A row reads each of its K/V pages
// once and does 4 * group * head_dim flops per key, far below the ~295
// flops per byte where the H100's bf16 tensor cores would be the limit.
// Design: one CTA per (row, KV head). The CTA loads only the pages below
// the row's length, stages each 16-key tile of K and V in shared memory
// once for all `group` query heads of that KV head (so a page is read
// once per KV head, not once per query head), and keeps m, l and acc in
// fp32. The dot products run on the CUDA cores from shared memory; wgmma,
// TMA loads and a split of long contexts over several CTAs are later work.
#include "paged_common.cuh"

using namespace paged;

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads) paged_decode_kernel(
    const T* __restrict__ q, const T* __restrict__ k_pages,
    const T* __restrict__ v_pages, const int* __restrict__ block_tables,
    const int* __restrict__ lengths, T* __restrict__ out, int q_heads,
    int kv_heads, int num_pages, int page_size, int pages_per_seq,
    float scale) {
  __shared__ Shared<HD> sm;
  constexpr int kStep = Dims<HD>::kStep;
  constexpr int kPer = Dims<HD>::kPer;
  const int b = blockIdx.x, h = blockIdx.y, tid = threadIdx.x;
  const int group = q_heads / kv_heads;
  const int cap = pages_per_seq * page_size;
  int len = lengths[b];
  len = len < 0 ? 0 : (len > cap ? cap : len);

  const size_t q_row = ((size_t)b * q_heads + (size_t)h * group) * HD;
  for (int i = tid; i < group * HD; i += kThreads)
    sm.q[i / HD][i % HD] = to_f32(q[q_row + i]) * scale;
  init_rows(sm);
  if (tid < kMaxRows) sm.row_end[tid] = len;
  float acc[kPer];
#pragma unroll
  for (int i = 0; i < kPer; ++i) acc[i] = 0.f;

  const size_t head = (size_t)h * num_pages * page_size * HD;
  stream_pages<T, HD>(sm, acc, k_pages + head, v_pages + head,
                      block_tables + (size_t)b * pages_per_seq, pages_per_seq,
                      num_pages, page_size, len, group);

  const int d = tid % HD;
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int r = tid / HD + i * kStep;
    if (r < group)
      store(out + q_row + (size_t)r * HD + d, acc[i] / fmaxf(sm.l[r], 1e-30f));
  }
}

// Returns the cudaError_t of the launch (0 on success). dtype: 0 = fp32,
// 1 = bf16. The caller has checked shapes, dtypes and contiguity.
extern "C" int paged_decode_launch(int dtype, int head_dim, const void* q,
                                   const void* k_pages, const void* v_pages,
                                   const void* block_tables,
                                   const void* lengths, void* out, int batch,
                                   int q_heads, int kv_heads, int num_pages,
                                   int page_size, int pages_per_seq,
                                   float scale, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (q_heads / kv_heads > kMaxRows) return (int)cudaErrorInvalidValue;
  const dim3 grid(batch, kv_heads);
  const bool ok = dispatch(dtype, head_dim, [&](auto t, auto hd) {
    using T = decltype(t);
    constexpr int HD = decltype(hd)::value;
    paged_decode_kernel<T, HD><<<grid, kThreads, 0, s>>>(
        (const T*)q, (const T*)k_pages, (const T*)v_pages,
        (const int*)block_tables, (const int*)lengths, (T*)out, q_heads,
        kv_heads, num_pages, page_size, pages_per_seq, scale);
  });
  if (!ok) return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
