// AdamW's update of one leaf in one pass, for Hopper (sm_90a).
//
// What it replaces: no TPU kernel. The JAX package's update
// (repro/training/optimizer.py:adamw_update) runs inside its jitted train
// step, where XLA fuses each leaf's elementwise ops into one loop. The
// port's eager update ran ~20 elementwise passes a leaf with fp32
// temporaries; this kernel is the fused loop: per element it reads p (bf16
// or fp32), g (bf16 or fp32), mu and nu (fp32), and writes p, mu and nu in
// place.
//
// Arithmetic: exactly the plain version's (kernels/adamw/ref.py, the loop
// body of training/optimizer.py:adamw_update), one rounded operation for
// each of torch's eager kernels, in the same order, with no contraction
// into an FMA that the eager path does not make:
//   g32   = g * scale
//   mu    = mu * b1 + g32 * (1 - b1)
//   nu    = nu * b2 + (g32 * g32) * (1 - b2)
//   delta = (mu / bc1) / (sqrt(nu / bc2) + eps)
//   delta = delta + p * wd                      (leaves of ndim >= 2 only)
//   p     = p - delta * lr                      (bf16: round to nearest even)
// The Python floats (b1, 1 - b1, b2, 1 - b2, eps, wd) arrive as the fp32
// values torch casts them to; the clip scale, lr and the bias corrections
// bc1, bc2 are fp32 device scalars that the step computes with torch ops,
// so a CUDA graph of the step reads nothing on the host. mu, nu and p come
// out bit-equal to the plain version on the card.
//
// What bounds it on this card: bytes. A bf16 leaf moves 22 bytes an
// element (p read and written, g read, mu and nu read and written in
// fp32), an fp32 leaf 28; ~15 operations an element are far below the
// 67 TFLOP/s of fp32. The design: a grid-stride loop of 16-byte loads and
// stores (8 elements a thread an iteration: two float4 of mu and of nu,
// one 16-byte vector of a bf16 p or g, two of an fp32 one) with the math
// in registers; a scalar loop takes the tail, and the whole leaf where a
// pointer is not 16-byte aligned. One launch a leaf.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 132 * 8;   // 8 blocks of 256 threads a SM
constexpr int kVec = 8;               // elements a thread an iteration

struct Consts {
  float b1, c1, b2, c2, eps, wd;
};

struct Scalars {
  const float* scale;
  const float* lr;
  const float* bc1;
  const float* bc2;
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void from_f(float& dst, float x) { dst = x; }
__device__ __forceinline__ void from_f(bf16& dst, float x) {
  dst = __float2bfloat16_rn(x);
}

// 8 consecutive elements through 16-byte accesses (the base 16-byte
// aligned)
__device__ __forceinline__ void load8(const float* src, float (&x)[kVec]) {
  const float4 a = reinterpret_cast<const float4*>(src)[0];
  const float4 b = reinterpret_cast<const float4*>(src)[1];
  x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
  x[4] = b.x; x[5] = b.y; x[6] = b.z; x[7] = b.w;
}

__device__ __forceinline__ void load8(const bf16* src, float (&x)[kVec]) {
  const uint4 u = *reinterpret_cast<const uint4*>(src);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    x[2 * i] = f.x;
    x[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void store8(float* dst, const float (&x)[kVec]) {
  reinterpret_cast<float4*>(dst)[0] = make_float4(x[0], x[1], x[2], x[3]);
  reinterpret_cast<float4*>(dst)[1] = make_float4(x[4], x[5], x[6], x[7]);
}

__device__ __forceinline__ void store8(bf16* dst, const float (&x)[kVec]) {
  uint4 u;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i)
    h[i] = __floats2bfloat162_rn(x[2 * i], x[2 * i + 1]);
  *reinterpret_cast<uint4*>(dst) = u;
}

// One element; p, m and v are updated in registers.
__device__ __forceinline__ void adamw_one(float& p, float g, float& m,
                                          float& v, float scale, float lr,
                                          float bc1, float bc2,
                                          const Consts& k, bool decay) {
  const float g32 = __fmul_rn(g, scale);
  m = __fadd_rn(__fmul_rn(m, k.b1), __fmul_rn(g32, k.c1));
  v = __fadd_rn(__fmul_rn(v, k.b2), __fmul_rn(__fmul_rn(g32, g32), k.c2));
  const float denom = __fadd_rn(__fsqrt_rn(__fdiv_rn(v, bc2)), k.eps);
  float delta = __fdiv_rn(__fdiv_rn(m, bc1), denom);
  if (decay) delta = __fadd_rn(delta, __fmul_rn(p, k.wd));
  p = __fsub_rn(p, __fmul_rn(delta, lr));
}

template <typename P, typename G, bool kVectorised>
__global__ void __launch_bounds__(kThreads)
    adamw_kernel(P* __restrict__ p, const G* __restrict__ g,
                 float* __restrict__ m, float* __restrict__ v, int64_t n,
                 Scalars s, Consts k, int decay) {
  const float scale = *s.scale, lr = *s.lr, bc1 = *s.bc1, bc2 = *s.bc2;
  const int64_t stride = (int64_t)gridDim.x * kThreads;
  const int64_t tid = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  int64_t tail = 0;
  if (kVectorised) {
    const int64_t groups = n / kVec;
    for (int64_t i = tid; i < groups; i += stride) {
      const int64_t e = i * kVec;
      float pf[kVec], gf[kVec], mf[kVec], vf[kVec];
      load8(p + e, pf);
      load8(g + e, gf);
      load8(m + e, mf);
      load8(v + e, vf);
#pragma unroll
      for (int j = 0; j < kVec; ++j)
        adamw_one(pf[j], gf[j], mf[j], vf[j], scale, lr, bc1, bc2, k,
                  decay != 0);
      store8(p + e, pf);
      store8(m + e, mf);
      store8(v + e, vf);
    }
    tail = groups * kVec;
  }
  for (int64_t e = tail + tid; e < n; e += stride) {
    float pf = to_f(p[e]), mf = m[e], vf = v[e];
    adamw_one(pf, to_f(g[e]), mf, vf, scale, lr, bc1, bc2, k, decay != 0);
    from_f(p[e], pf);
    m[e] = mf;
    v[e] = vf;
  }
}

template <typename P, typename G>
int launch(void* p, const void* g, float* m, float* v, int64_t n,
           const Scalars& s, const Consts& k, int decay, int vec,
           cudaStream_t stream) {
  const int64_t work = vec ? (n + kVec - 1) / kVec : n;
  int64_t blocks = (work + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  if (blocks < 1) blocks = 1;
  if (vec)
    adamw_kernel<P, G, true><<<(unsigned)blocks, kThreads, 0, stream>>>(
        (P*)p, (const G*)g, m, v, n, s, k, decay);
  else
    adamw_kernel<P, G, false><<<(unsigned)blocks, kThreads, 0, stream>>>(
        (P*)p, (const G*)g, m, v, n, s, k, decay);
  return (int)cudaGetLastError();
}

}  // namespace

// One leaf of n elements, in place. p_dtype and g_dtype: 0 = fp32,
// 1 = bf16; m and v fp32; scale, lr, bc1 and bc2 point at fp32 device
// scalars. decay: 1 for a leaf of ndim >= 2. vec: 1 when p, g, m and v
// are 16-byte aligned. Returns cudaGetLastError() after the launch.
extern "C" int adamw_launch(int p_dtype, int g_dtype, void* p, const void* g,
                            void* m, void* v, int64_t n, const void* scale,
                            const void* lr, const void* bc1, const void* bc2,
                            float b1, float c1, float b2, float c2,
                            float eps, float wd, int decay, int vec,
                            void* stream) {
  if (n < 1 || (p_dtype != 0 && p_dtype != 1) ||
      (g_dtype != 0 && g_dtype != 1))
    return (int)cudaErrorInvalidValue;
  const Scalars s{(const float*)scale, (const float*)lr, (const float*)bc1,
                  (const float*)bc2};
  const Consts k{b1, c1, b2, c2, eps, wd};
  cudaStream_t st = (cudaStream_t)stream;
  float* mf = (float*)m;
  float* vf = (float*)v;
  if (p_dtype == 0 && g_dtype == 0)
    return launch<float, float>(p, g, mf, vf, n, s, k, decay, vec, st);
  if (p_dtype == 0)
    return launch<float, bf16>(p, g, mf, vf, n, s, k, decay, vec, st);
  if (g_dtype == 0)
    return launch<bf16, float>(p, g, mf, vf, n, s, k, decay, vec, st);
  return launch<bf16, bf16>(p, g, mf, vf, n, s, k, decay, vec, st);
}
