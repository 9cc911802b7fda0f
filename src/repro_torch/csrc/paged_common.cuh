// Shared core of the paged attention kernels on CUDA cores: an
// online-softmax pass of a few query rows of one KV head over that head's
// paged K/V, one shared-memory tile of keys at a time. K1
// (paged_decode.cu), K2 (paged_prefill.cu) and both K3 passes
// (paged_tree_decode.cu) run it in fp32 only, since bf16 tensor-core
// products cannot meet fp32's tolerance (their bf16 kernels are mma.sync
// tiles built from paged_decode_mma.cuh).
//
// Layout (the JAX package's, consumed unchanged): K/V pools are
// [kv_heads, num_pages, page_size, head_dim] for one layer, contiguous;
// a block table lists a sequence's pages in order. The serving engine
// allocates one spare page past the live ones (index num_pages - 1 of the
// pool it passes) that takes every dropped write.
//
// Contracts kept from the TPU kernels:
//   * GQA-native: the group of query heads of one KV head shares every K/V
//     tile staged in shared memory; K/V are never repeated per query head.
//   * m, l and acc are fp32 whatever the storage type; q is scaled by
//     1/sqrt(head_dim) in fp32 before the dot products.
//   * Keys past a row's visible end are skipped by the loop bounds, never
//     multiplied by a zero weight: a stale page may hold any bytes, and
//     0 * NaN would poison the sum.
//   * Block-table entries are clamped into the pool before any address is
//     formed, so a sentinel entry never reaches past the pool.
//   * The epilogue divides by max(l, 1e-30): a row that saw no key gives 0.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

namespace paged {

constexpr int kThreads = 128;       // one CTA is four warps
constexpr int kTile = 16;           // keys staged in shared memory at once
constexpr int kMaxRows = 32;        // query rows (heads x chunk rows) a CTA owns
constexpr float kNegInf = -1e30f;   // the TPU kernels' NEG_INF

__device__ __forceinline__ int clamp_to(int x, int cap) {
  return x < 0 ? 0 : (x > cap ? cap : x);
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

// Thread t owns output columns d = t % HD + c * kThreads (c < kCols) of
// rows t / HD, t / HD + kStep, ...: one column up to head_dim 128, two at
// 256. Its accumulators are acc[i * kCols + c], row i, column c.
template <int HD>
struct Dims {
  static_assert(kThreads % HD == 0 || HD % kThreads == 0,
                "head_dim must divide the CTA or be a multiple of it");
  static constexpr int kCols = HD > kThreads ? HD / kThreads : 1;
  static constexpr int kStep = kThreads * kCols / HD;
  static constexpr int kPer = kMaxRows / kStep;
  static constexpr int kAcc = kPer * kCols;
};

template <int HD>
struct Shared {
  float q[kMaxRows][HD];        // query rows, pre-scaled, fp32
  float k[kTile][HD + 1];       // +1 word: a warp reading one column of
                                // 16 keys hits 16 different banks
  float v[kTile][HD];
  float p[kMaxRows][kTile];     // scores, then probabilities
  float m[kMaxRows];            // running max
  float l[kMaxRows];            // running denominator
  float alpha[kMaxRows];        // rescale of acc for the current tile
  int row_end[kMaxRows];        // row r sees key positions < row_end[r]
};

// The most shared memory a kernel may declare statically.
constexpr size_t kStaticSmem = 48 * 1024;

// The bytes of dynamic shared memory a kernel whose shared struct is S
// launches with: none where S fits the static limit (head_dim up to 128),
// all of S where it does not (Shared<256> is ~66.5 KB).
template <typename S>
__host__ __device__ constexpr size_t dynamic_smem() {
  return sizeof(S) <= kStaticSmem ? 0 : sizeof(S);
}

// A kernel's shared struct S: a static __shared__ variable where it fits,
// else the start of the dynamic shared memory (dynamic_smem<S>() bytes,
// opted into by the launcher with opt_in_smem).
template <typename S>
__device__ __forceinline__ S& shared_struct() {
  if constexpr (dynamic_smem<S>() == 0) {
    __shared__ __align__(16) S s;
    return s;
  } else {
    extern __shared__ __align__(16) unsigned char dyn_smem[];
    return *reinterpret_cast<S*>(dyn_smem);
  }
}

// Raises `kernel`'s dynamic shared memory limit to dynamic_smem<S>() the
// first time it is needed (`done` is the launcher's flag for this kernel
// in this library); returns the cudaError_t.
template <typename S, typename K>
cudaError_t opt_in_smem(K kernel, bool& done) {
  if (dynamic_smem<S>() == 0 || done) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)dynamic_smem<S>());
  done = err == cudaSuccess;
  return err;
}

// Sets m = NEG_INF, l = 0 for every row; the caller sets row_end and q.
template <int HD>
__device__ __forceinline__ void init_rows(Shared<HD>& sm) {
  const int tid = threadIdx.x;
  if (tid < kMaxRows) {
    sm.m[tid] = kNegInf;
    sm.l[tid] = 0.f;
    sm.alpha[tid] = 1.f;
  }
}

// Streams the first pages of `table` (as many as cover positions
// < ctx_end) through shared memory for `rows` query rows, updating each
// thread's accumulators `acc` (Dims<HD>::kAcc values). Positions past
// ctx_end are never loaded; within a tile, key j counts for row r only
// while its position is < row_end[r].
template <typename T, int HD>
__device__ __forceinline__ void stream_pages(
    Shared<HD>& sm, float* acc, const T* __restrict__ k_head,
    const T* __restrict__ v_head, const int* __restrict__ table,
    int table_len, int num_pages, int page_size, int ctx_end, int rows) {
  constexpr int kStep = Dims<HD>::kStep;
  constexpr int kPer = Dims<HD>::kPer;
  constexpr int kCols = Dims<HD>::kCols;
  const int tid = threadIdx.x;
  const int d = tid % HD;
  const int r0 = tid / HD;
  int n_pages = (ctx_end + page_size - 1) / page_size;
  if (n_pages > table_len) n_pages = table_len;
  for (int pi = 0; pi < n_pages; ++pi) {
    int page = table[pi];
    page = page < 0 ? 0 : (page >= num_pages ? num_pages - 1 : page);
    const size_t base = (size_t)page * page_size * HD;
    const int page_start = pi * page_size;
    const int page_n = min(page_size, ctx_end - page_start);
    for (int t0 = 0; t0 < page_n; t0 += kTile) {
      const int tn = min(kTile, page_n - t0);
      const int tile_start = page_start + t0;
      __syncthreads();  // the previous tile is consumed; q/m/l are set
      for (int i = tid; i < tn * HD; i += kThreads) {
        const int j = i / HD, c = i % HD;
        const size_t off = base + (size_t)(t0 + j) * HD + c;
        sm.k[j][c] = to_f32(k_head[off]);
        sm.v[j][c] = to_f32(v_head[off]);
      }
      __syncthreads();
      // scores: one (row, key) pair per thread and pass
      for (int i = tid; i < rows * kTile; i += kThreads) {
        const int r = i / kTile, j = i % kTile;
        if (j < min(tn, sm.row_end[r] - tile_start)) {
          float s = 0.f;
#pragma unroll 16
          for (int c = 0; c < HD; ++c) s = fmaf(sm.q[r][c], sm.k[j][c], s);
          sm.p[r][j] = s;
        }
      }
      __syncthreads();
      // online softmax: the first warp owns one row each
      if (tid < rows) {
        const int r = tid;
        const int vis = min(tn, sm.row_end[r] - tile_start);
        float a = 1.f;
        if (vis > 0) {
          float mx = sm.m[r];
          for (int j = 0; j < vis; ++j) mx = fmaxf(mx, sm.p[r][j]);
          a = expf(sm.m[r] - mx);
          float sum = 0.f;
          for (int j = 0; j < vis; ++j) {
            const float e = expf(sm.p[r][j] - mx);
            sm.p[r][j] = e;
            sum += e;
          }
          sm.l[r] = sm.l[r] * a + sum;
          sm.m[r] = mx;
        }
        sm.alpha[r] = a;
      }
      __syncthreads();
      // acc = acc * alpha + P V over the visible keys only
#pragma unroll
      for (int i = 0; i < kPer; ++i) {
        const int r = r0 + i * kStep;
        if (r < rows) {
          const int vis = min(tn, sm.row_end[r] - tile_start);
          if (vis > 0) {
#pragma unroll
            for (int c = 0; c < kCols; ++c) {
              float o = acc[i * kCols + c] * sm.alpha[r];
              for (int j = 0; j < vis; ++j)
                o = fmaf(sm.p[r][j], sm.v[j][d + c * kThreads], o);
              acc[i * kCols + c] = o;
            }
          }
        }
      }
    }
  }
  __syncthreads();  // l is final before any thread reads another row's
}

}  // namespace paged
