// Helpers shared by the SSD chunked scan (ssd_scan.cu, kernel K4) and its
// gradient (ssd_scan_bwd.cu): element conversions, the padded widths of
// the bf16 tensor-core tiles and the in-chunk cumulative sum of dt·a.
#pragma once
#include "hopper_ptx.cuh"
#include "launch_check.cuh"

namespace ssd {

using bf16 = __nv_bfloat16;
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

// N padded for the bf16 kernels' tiles: 16, 32, 64 or 128
__host__ __device__ inline int padded_n(int n) {
  return n <= 16 ? 16 : n <= 32 ? 32 : n <= 64 ? 64 : 128;
}

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

}  // namespace ssd
