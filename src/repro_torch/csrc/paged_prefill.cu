// Paged flash-prefill for Hopper (sm_90a): the query rows of one request's
// prefill chunk against that request's paged K/V, through one block table,
// causal on absolute positions, GQA-native.
//
// Replaces the TPU kernel repro/kernels/flash_prefill/paged_prefill.py
// (paged_flash_prefill_fwd, body _paged_prefill_kernel): row i sits at
// position pos0 + i and sees keys at positions <= pos0 + i (the mask of
// paged_prefill.py:155); rows >= valid_len are bucket padding and get
// exact zeros (the epilogue at :171); pages past a query block's causal
// horizon are never read.
//
// What bounds it on this card: bytes at the serving shapes (a chunk of 32
// or 64 rows against a context of a few hundred keys does ~4 * T * group *
// head_dim flops per key read, about 100 flops per byte in bf16 at T = 64,
// group = 5, under the card's ~295). Design: one CTA per (query block,
// KV head). A query block holds floor(32 / group) chunk rows, so its
// rows x group query vectors fit the 32 rows a CTA owns; the CTA streams
// each page up to the block's horizon once through shared memory for all
// of them. pos0 and valid_len are host integers (the engine builds them on
// the host), so a launch needs no device sync. Tensor-core tiles, TMA and
// one launch over all lanes of a step are later work.
#include "paged_common.cuh"

using namespace paged;

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads) paged_prefill_kernel(
    const T* __restrict__ q, const T* __restrict__ k_pages,
    const T* __restrict__ v_pages, const int* __restrict__ block_table,
    T* __restrict__ out, int t_rows, int q_heads, int kv_heads,
    int num_pages, int page_size, int pages_per_seq, int pos0, int valid_len,
    int block_q, float scale) {
  __shared__ Shared<HD> sm;
  constexpr int kStep = Dims<HD>::kStep;
  constexpr int kPer = Dims<HD>::kPer;
  const int h = blockIdx.y, tid = threadIdx.x;
  const int group = q_heads / kv_heads;
  const int q_start = blockIdx.x * block_q;
  const int nq = min(block_q, t_rows - q_start);
  const int rows = nq * group;  // row r is chunk row q_start + r / group,
                                // query head h * group + r % group

  for (int i = tid; i < rows * HD; i += kThreads) {
    const int r = i / HD, c = i % HD;
    const int t = q_start + r / group;
    const size_t src = ((size_t)t * q_heads + (size_t)h * group + r % group);
    sm.q[r][c] = to_f32(q[src * HD + c]) * scale;
  }
  init_rows(sm);
  if (tid < kMaxRows) {
    const int t = q_start + tid / group;
    sm.row_end[tid] = (tid < rows && t < valid_len) ? pos0 + t + 1 : 0;
  }
  float acc[kPer];
#pragma unroll
  for (int i = 0; i < kPer; ++i) acc[i] = 0.f;

  // the block's causal horizon: the last valid row's position
  const int last = min(q_start + nq, valid_len);
  const int ctx_end = last > q_start ? pos0 + last : 0;
  const size_t head = (size_t)h * num_pages * page_size * HD;
  stream_pages<T, HD>(sm, acc, k_pages + head, v_pages + head, block_table,
                      pages_per_seq, num_pages, page_size, ctx_end, rows);

  const int d = tid % HD;
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int r = tid / HD + i * kStep;
    if (r < rows) {
      const int t = q_start + r / group;
      const float val =
          t < valid_len ? acc[i] / fmaxf(sm.l[r], 1e-30f) : 0.f;
      const size_t dst = ((size_t)t * q_heads + (size_t)h * group + r % group);
      store(out + dst * HD + d, val);
    }
  }
}

// Returns the cudaError_t of the launch (0 on success). dtype: 0 = fp32,
// 1 = bf16. block_q * (q_heads / kv_heads) must not exceed 32.
extern "C" int paged_prefill_launch(int dtype, int head_dim, const void* q,
                                    const void* k_pages, const void* v_pages,
                                    const void* block_table, void* out,
                                    int t_rows, int q_heads, int kv_heads,
                                    int num_pages, int page_size,
                                    int pages_per_seq, int pos0,
                                    int valid_len, int block_q, float scale,
                                    void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (block_q < 1 || block_q * (q_heads / kv_heads) > kMaxRows)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((t_rows + block_q - 1) / block_q, kv_heads);
  const bool ok = dispatch(dtype, head_dim, [&](auto t, auto hd) {
    using T = decltype(t);
    constexpr int HD = decltype(hd)::value;
    paged_prefill_kernel<T, HD><<<grid, kThreads, 0, s>>>(
        (const T*)q, (const T*)k_pages, (const T*)v_pages,
        (const int*)block_table, (T*)out, t_rows, q_heads, kv_heads,
        num_pages, page_size, pages_per_seq, pos0, valid_len, block_q,
        scale);
  });
  if (!ok) return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
