// Mamba-2 SSD chunked scan for Hopper (sm_90a), with state in and out.
//
// Replaces the TPU kernel repro/kernels/ssd_scan/ssd_scan.py (ssd_scan,
// body _ssd_kernel) and, with its initial and final state, the chunked
// scan repro/models/mamba2.py:ssd_chunked that the serving mixer runs.
// For one (batch row, head) and each chunk of Q positions:
//
//   intra-chunk:  Y   = (C·Bᵀ ∘ L ∘ dt) · X,  L[i,j] = exp(cs[i] - cs[j]), j <= i
//   inter-chunk:  Y  += exp(cs) ∘ (C · S_prevᵀ)
//   state:        S   = exp(cs[Q-1]) · S_prev + Xᵀ · (B ∘ dt ∘ exp(cs[Q-1] - cs))
//
// with cs the cumulative sum of dt·a inside the chunk. The [P, N] state is
// carried from chunk to chunk in fp32 in shared memory; only the initial
// state (read) and the final state (written) are in the storage type.
// Masked positions arrive with dt = 0 (the wrapper zeroes them, as the TPU
// wrapper does): an exact identity transition. S need not be a multiple of
// Q: the last chunk is partial, and its missing rows count as dt = 0 and
// x = b = c = 0, the padding of the plain version.
//
// What bounds it on this card: at the serving shape (Q = 128, N = 128,
// P = 64, one chunk lane of 32-64 rows) each (row, head) does a few
// million fp32 multiply-adds on ~50 KB of input, so neither bytes nor the
// tensor-core rate bound it; the time goes to the shared-memory traffic of
// the three products on the CUDA cores and to the one-CTA-per-head grid
// (24 CTAs per lane on 132 SMs). Design: one CTA per (row, head) walks the
// chunks in order (the TPU's sequential grid axis becomes a loop); B, C, X
// and the state sit in shared memory as fp32 (~210 KB at the serving
// shape); the [Q, Q] gate is built 32 rows at a time, so it never needs
// more than a [32, Q] tile. Each warp owns 4 output rows and each lane up
// to 4 columns, so every shared-memory load feeds 4 multiply-adds. The
// order of every sum is fixed: no atomics, no split that depends on the
// batch, so a row's result does not depend on the other rows of the launch.
// wgmma tiles and more CTAs per head are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;                  // eight warps
constexpr int kWarps = kThreads / 32;
constexpr int kRowBlock = 32;                  // gate rows held at once
constexpr int kRowsPerWarp = kRowBlock / kWarps;
constexpr int kCols = 4;                       // columns per lane
constexpr int kMaxDim = 32 * kCols;            // Q, N and P up to 128
constexpr int kMaxSmem = 232448;               // the card's per-block limit

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

// Shared-memory layout (floats), row strides chosen so that a warp whose
// lanes walk a column of B or of the state hits 32 different banks.
struct Layout {
  int q, n, p;
  __host__ __device__ int b_stride() const { return n + 1; }
  __host__ __device__ int s_stride() const { return n + 1; }
  __host__ __device__ int b_off() const { return 0; }
  __host__ __device__ int c_off() const { return b_off() + q * b_stride(); }
  __host__ __device__ int x_off() const { return c_off() + q * n; }
  __host__ __device__ int s_off() const { return x_off() + q * p; }
  __host__ __device__ int g_off() const { return s_off() + p * s_stride(); }
  __host__ __device__ int dt_off() const { return g_off() + kRowBlock * q; }
  __host__ __device__ int cs_off() const { return dt_off() + q; }
  __host__ __device__ int w_off() const { return cs_off() + q; }
  __host__ __device__ int floats() const { return w_off() + q; }
};

template <typename T>
__global__ void __launch_bounds__(kThreads) ssd_scan_kernel(
    const T* __restrict__ x, const float* __restrict__ dt,
    const float* __restrict__ a, const T* __restrict__ b,
    const T* __restrict__ c, const T* __restrict__ init_state,
    T* __restrict__ y, T* __restrict__ final_state, int seqlen, int heads,
    int p_dim, int n_dim, int chunk) {
  extern __shared__ float smem[];
  const Layout lay{chunk, n_dim, p_dim};
  float* bs = smem + lay.b_off();     // [Q][N+1]
  float* cs_m = smem + lay.c_off();   // [Q][N]
  float* xs = smem + lay.x_off();     // [Q][P]
  float* st = smem + lay.s_off();     // [P][N+1]
  float* gate = smem + lay.g_off();   // [kRowBlock][Q]
  float* dts = smem + lay.dt_off();   // [Q]
  float* cum = smem + lay.cs_off();   // [Q]
  float* wts = smem + lay.w_off();    // [Q] dt * exp(cs[Q-1] - cs)

  const int h = blockIdx.x, row = blockIdx.y, tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const float a_h = a[h];
  const size_t state_base = ((size_t)row * heads + h) * p_dim * n_dim;

  for (int e = tid; e < p_dim * n_dim; e += kThreads) {
    const int pi = e / n_dim, ni = e % n_dim;
    st[pi * lay.s_stride() + ni] =
        init_state ? to_f32(init_state[state_base + e]) : 0.f;
  }

  for (int c0 = 0; c0 < seqlen; c0 += chunk) {
    const int qn = min(chunk, seqlen - c0);   // rows of this chunk
    __syncthreads();   // the previous chunk is done with shared memory
    const size_t tok0 = (size_t)row * seqlen + c0;
    for (int i = tid; i < chunk; i += kThreads)
      dts[i] = i < qn ? dt[(tok0 + i) * heads + h] : 0.f;
    for (int e = tid; e < chunk * n_dim; e += kThreads) {
      const int i = e / n_dim, ni = e % n_dim;
      const size_t g = ((tok0 + i) * heads + h) * n_dim + ni;
      bs[i * lay.b_stride() + ni] = i < qn ? to_f32(b[g]) : 0.f;
      cs_m[e] = i < qn ? to_f32(c[g]) : 0.f;
    }
    for (int e = tid; e < chunk * p_dim; e += kThreads) {
      const int i = e / p_dim, pi = e % p_dim;
      xs[e] = i < qn ? to_f32(x[((tok0 + i) * heads + h) * p_dim + pi]) : 0.f;
    }
    __syncthreads();
    if (tid == 0) {                   // the chunk's cumsum, in order
      float run = 0.f;
      for (int i = 0; i < chunk; ++i) {
        run += dts[i] * a_h;
        cum[i] = run;
      }
    }
    __syncthreads();
    const float cs_last = cum[chunk - 1];
    for (int i = tid; i < chunk; i += kThreads)
      wts[i] = dts[i] * expf(cs_last - cum[i]);

    for (int i0 = 0; i0 < qn; i0 += kRowBlock) {
      const int r0 = warp * kRowsPerWarp;       // this warp's gate rows
      // ---- gate rows: (C·Bᵀ)[i, j] · exp(cs[i] - cs[j]) · dt[j], j <= i
      {
        float acc[kRowsPerWarp][kCols] = {};
        for (int ni = 0; ni < n_dim; ++ni) {
          float cv[kRowsPerWarp], bv[kCols];
#pragma unroll
          for (int r = 0; r < kRowsPerWarp; ++r) {
            const int i = i0 + r0 + r;
            cv[r] = i < qn ? cs_m[i * n_dim + ni] : 0.f;
          }
#pragma unroll
          for (int t = 0; t < kCols; ++t) {
            const int j = lane + 32 * t;
            bv[t] = j < chunk ? bs[j * lay.b_stride() + ni] : 0.f;
          }
#pragma unroll
          for (int r = 0; r < kRowsPerWarp; ++r)
#pragma unroll
            for (int t = 0; t < kCols; ++t) acc[r][t] += cv[r] * bv[t];
        }
#pragma unroll
        for (int r = 0; r < kRowsPerWarp; ++r) {
          const int i = i0 + r0 + r;
#pragma unroll
          for (int t = 0; t < kCols; ++t) {
            const int j = lane + 32 * t;
            if (j < chunk)
              gate[(r0 + r) * chunk + j] =
                  (i < qn && j <= i)
                      ? acc[r][t] * expf(cum[i] - cum[j]) * dts[j]
                      : 0.f;
          }
        }
      }
      __syncthreads();
      // ---- outputs of these rows: gate · X + exp(cs) ∘ (C · S_prevᵀ)
      {
        float yd[kRowsPerWarp][kCols] = {};
        float yo[kRowsPerWarp][kCols] = {};
        const int j_end = min(i0 + kRowBlock, qn);   // gate is 0 past i
        for (int j = 0; j < j_end; ++j) {
          float g[kRowsPerWarp], xv[kCols];
#pragma unroll
          for (int r = 0; r < kRowsPerWarp; ++r)
            g[r] = gate[(r0 + r) * chunk + j];
#pragma unroll
          for (int t = 0; t < kCols; ++t) {
            const int pi = lane + 32 * t;
            xv[t] = pi < p_dim ? xs[j * p_dim + pi] : 0.f;
          }
#pragma unroll
          for (int r = 0; r < kRowsPerWarp; ++r)
#pragma unroll
            for (int t = 0; t < kCols; ++t) yd[r][t] += g[r] * xv[t];
        }
        for (int ni = 0; ni < n_dim; ++ni) {
          float cv[kRowsPerWarp], sv[kCols];
#pragma unroll
          for (int r = 0; r < kRowsPerWarp; ++r) {
            const int i = i0 + r0 + r;
            cv[r] = i < qn ? cs_m[i * n_dim + ni] : 0.f;
          }
#pragma unroll
          for (int t = 0; t < kCols; ++t) {
            const int pi = lane + 32 * t;
            sv[t] = pi < p_dim ? st[pi * lay.s_stride() + ni] : 0.f;
          }
#pragma unroll
          for (int r = 0; r < kRowsPerWarp; ++r)
#pragma unroll
            for (int t = 0; t < kCols; ++t) yo[r][t] += cv[r] * sv[t];
        }
#pragma unroll
        for (int r = 0; r < kRowsPerWarp; ++r) {
          const int i = i0 + r0 + r;
          if (i >= qn) continue;
          const float in_decay = expf(cum[i]);
#pragma unroll
          for (int t = 0; t < kCols; ++t) {
            const int pi = lane + 32 * t;
            if (pi < p_dim)
              store(y + ((tok0 + i) * heads + h) * p_dim + pi,
                    yd[r][t] + yo[r][t] * in_decay);
          }
        }
      }
      __syncthreads();   // the gate tile and S_prev are free again
    }

    // ---- state: S = exp(cs[Q-1]) · S_prev + Xᵀ · (B ∘ wts)
    const float decay = expf(cs_last);
    for (int p0 = warp * kRowsPerWarp; p0 < p_dim;
         p0 += kWarps * kRowsPerWarp) {
      float acc[kRowsPerWarp][kCols] = {};
      for (int j = 0; j < qn; ++j) {
        float xv[kRowsPerWarp], bw[kCols];
        const float wj = wts[j];
#pragma unroll
        for (int r = 0; r < kRowsPerWarp; ++r)
          xv[r] = p0 + r < p_dim ? xs[j * p_dim + p0 + r] : 0.f;
#pragma unroll
        for (int t = 0; t < kCols; ++t) {
          const int ni = lane + 32 * t;
          bw[t] = ni < n_dim ? bs[j * lay.b_stride() + ni] * wj : 0.f;
        }
#pragma unroll
        for (int r = 0; r < kRowsPerWarp; ++r)
#pragma unroll
          for (int t = 0; t < kCols; ++t) acc[r][t] += xv[r] * bw[t];
      }
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) {
        const int pi = p0 + r;
        if (pi >= p_dim) continue;
#pragma unroll
        for (int t = 0; t < kCols; ++t) {
          const int ni = lane + 32 * t;
          if (ni < n_dim) {
            float* s = st + pi * lay.s_stride() + ni;
            *s = *s * decay + acc[r][t];
          }
        }
      }
    }
  }

  __syncthreads();
  for (int e = tid; e < p_dim * n_dim; e += kThreads) {
    const int pi = e / n_dim, ni = e % n_dim;
    store(final_state + state_base + e, st[pi * lay.s_stride() + ni]);
  }
}

template <typename T>
int launch(const void* x, const void* dt, const void* a, const void* b,
           const void* c, const void* init_state, void* y, void* final_state,
           int batch, int seqlen, int heads, int p_dim, int n_dim, int chunk,
           cudaStream_t stream) {
  const size_t smem = (size_t)Layout{chunk, n_dim, p_dim}.floats() *
                      sizeof(float);
  static bool opted_in = false;       // once per instantiation
  if (!opted_in) {
    cudaError_t err = cudaFuncSetAttribute(
        ssd_scan_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kMaxSmem);
    if (err != cudaSuccess) return (int)err;
    opted_in = true;
  }
  dim3 grid(heads, batch);
  ssd_scan_kernel<T><<<grid, kThreads, smem, stream>>>(
      (const T*)x, (const float*)dt, (const float*)a, (const T*)b,
      (const T*)c, (const T*)init_state, (T*)y, (T*)final_state, seqlen,
      heads, p_dim, n_dim, chunk);
  return (int)cudaGetLastError();
}

}  // namespace

// Returns the cudaError_t of the launch (0 on success). dtype: 0 = fp32,
// 1 = bf16 for x, b, c, y and both states; dt and a are fp32.
// init_state may be null (a zero start); final_state is always written.
// x [batch, seqlen, heads, p_dim]; dt [batch, seqlen, heads]; a [heads];
// b, c [batch, seqlen, heads, n_dim]; states [batch, heads, p_dim, n_dim].
// The caller has checked shapes, dtypes and contiguity.
extern "C" int ssd_scan_launch(int dtype, const void* x, const void* dt,
                               const void* a, const void* b, const void* c,
                               const void* init_state, void* y,
                               void* final_state, int batch, int seqlen,
                               int heads, int p_dim, int n_dim, int chunk,
                               void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (chunk < 1 || chunk > kMaxDim || p_dim > kMaxDim || n_dim > kMaxDim ||
      Layout{chunk, n_dim, p_dim}.floats() * sizeof(float) > (size_t)kMaxSmem)
    return (int)cudaErrorInvalidValue;
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, dt, a, b, c, init_state, y, final_state,
                                 batch, seqlen, heads, p_dim, n_dim, chunk,
                                 s);
  if (dtype == 0)
    return launch<float>(x, dt, a, b, c, init_state, y, final_state, batch,
                         seqlen, heads, p_dim, n_dim, chunk, s);
  return (int)cudaErrorInvalidValue;
}
