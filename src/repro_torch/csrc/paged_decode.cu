// Paged flash-decode for Hopper (sm_90a): one query token per row against
// the row's paged K/V, GQA-native.
//
// Replaces the TPU kernel repro/kernels/paged_attention/paged_attention.py
// (paged_attention_decode, body _decode_kernel); same inputs, same output
// contract, including exact zeros for a row of length 0.
//
// bf16: the split-key tensor-core decode core of paged_decode_mma.cuh
// (decode_mma_kernel<HD, false>): a CTA per (key split, KV head x 16-head
// slice, row), the GQA group as the rows of mma.sync m16n8k16 tiles, each
// of the four warps walking its own 32-key tiles, the warps' partials
// merged in the CTA and, where a row spans several key splits, the
// splits' over the CTAs of a cluster, all in one launch.
// fp32: one CTA per (row, KV head) walking the context alone on the CUDA
// cores (paged_common.cuh's stream_pages): bf16 tensor-core products
// cannot meet fp32's tolerance. What bounds both on this card: bytes (4 x
// group x head_dim flops per key read), and at the serving shapes the
// dependent chain each CTA walks. Head_dim 32, 64, 128 and 256, each its
// own instantiation; at 256 the fp32 kernel's shared tile (~66.5 KB) is
// dynamic shared memory and each thread owns two output columns.
#include "paged_decode_mma.cuh"

using namespace paged;

template <int HD>
__global__ void __launch_bounds__(kThreads) paged_decode_kernel(
    const float* __restrict__ q, const float* __restrict__ k_pages,
    const float* __restrict__ v_pages, const int* __restrict__ block_tables,
    const int* __restrict__ lengths, float* __restrict__ out, int q_heads,
    int kv_heads, int num_pages, int page_size, int pages_per_seq,
    float scale) {
  Shared<HD>& sm = shared_struct<Shared<HD>>();
  constexpr int kStep = Dims<HD>::kStep;
  constexpr int kPer = Dims<HD>::kPer;
  constexpr int kCols = Dims<HD>::kCols;
  const int b = blockIdx.x, h = blockIdx.y, tid = threadIdx.x;
  const int group = q_heads / kv_heads;
  const int len = clamp_to(lengths[b], pages_per_seq * page_size);

  const size_t q_row = ((size_t)b * q_heads + (size_t)h * group) * HD;
  for (int i = tid; i < group * HD; i += kThreads)
    sm.q[i / HD][i % HD] = q[q_row + i] * scale;
  init_rows(sm);
  if (tid < kMaxRows) sm.row_end[tid] = len;
  float acc[Dims<HD>::kAcc];
#pragma unroll
  for (int i = 0; i < Dims<HD>::kAcc; ++i) acc[i] = 0.f;

  const size_t head = (size_t)h * num_pages * page_size * HD;
  stream_pages<float, HD>(sm, acc, k_pages + head, v_pages + head,
                          block_tables + (size_t)b * pages_per_seq,
                          pages_per_seq, num_pages, page_size, len, group);

  const int d = tid % HD;
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int r = tid / HD + i * kStep;
    if (r < group) {
#pragma unroll
      for (int c = 0; c < kCols; ++c)
        out[q_row + (size_t)r * HD + d + c * kThreads] =
            acc[i * kCols + c] / fmaxf(sm.l[r], 1e-30f);
    }
  }
}

namespace {
// Whether this library has raised the fp32 kernel's dynamic shared memory
// limit (head_dim 256 only; internal linkage: one flag per library).
template <int HD>
bool f32_smem_raised = false;
}  // namespace

// Returns the cudaError_t of the launch (0 on success). dtype: 0 = fp32,
// 1 = bf16. split_keys and n_split are the key splits of the bf16 kernel
// (ref.py: decode_splits; fp32 takes the whole table as one split).
// grids (n_grids x 3 ints) is the wrapper's paged_attention_grid; a grid
// that is not this launch's is refused before anything launches. The
// caller has checked shapes, dtypes, contiguity and 16-byte alignment.
extern "C" int paged_decode_launch(int dtype, int head_dim, const void* q,
                                   const void* k_pages, const void* v_pages,
                                   const void* block_tables,
                                   const void* lengths, void* out, int batch,
                                   int q_heads, int kv_heads, int num_pages,
                                   int page_size, int pages_per_seq,
                                   int split_keys, int n_split, float scale,
                                   const int* grids, int n_grids,
                                   void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (kv_heads < 1 || q_heads / kv_heads > kMaxRows)
    return (int)cudaErrorInvalidValue;
  if (dtype == 1) {
    decode::Args a = {};
    a.q = (const __nv_bfloat16*)q;
    a.k_pages = (const __nv_bfloat16*)k_pages;
    a.v_pages = (const __nv_bfloat16*)v_pages;
    a.tables = (const int*)block_tables;
    a.lengths = (const int*)lengths;
    a.out = (__nv_bfloat16*)out;
    a.batch = batch;
    a.q_heads = q_heads;
    a.kv_heads = kv_heads;
    a.num_pages = num_pages;
    a.page_size = page_size;
    a.pages_per_seq = pages_per_seq;
    a.split_keys = split_keys;
    a.n_split = n_split;
    a.scale = scale;
    const dim3 grid = decode::grid_of(a);
    if (!grids_match(grids, n_grids, &grid, 1))
      return (int)cudaErrorInvalidValue;
    int rc = (int)cudaErrorInvalidValue;
    decode::dispatch_hd(head_dim, [&](auto hd) {
      rc = decode::launch<decltype(hd)::value, false>(a, s);
    });
    return rc;
  }
  if (dtype != 0 || n_split != 1) return (int)cudaErrorInvalidValue;
  const dim3 grid(batch, kv_heads);
  if (!grids_match(grids, n_grids, &grid, 1))
    return (int)cudaErrorInvalidValue;
  int rc = (int)cudaErrorInvalidValue;
  decode::dispatch_hd(head_dim, [&](auto hd) {
    constexpr int HD = decltype(hd)::value;
    const auto kernel = paged_decode_kernel<HD>;
    rc = (int)opt_in_smem<Shared<HD>>(kernel, f32_smem_raised<HD>);
    if (rc != 0) return;
    kernel<<<grid, kThreads, dynamic_smem<Shared<HD>>(), s>>>(
        (const float*)q, (const float*)k_pages, (const float*)v_pages,
        (const int*)block_tables, (const int*)lengths, (float*)out, q_heads,
        kv_heads, num_pages, page_size, pages_per_seq, scale);
    rc = (int)cudaGetLastError();
  });
  return rc;
}
