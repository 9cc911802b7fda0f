// The shared-memory tiling and TMA tensor maps of the bf16 wgmma kernels
// of dense attention: the flash prefill (flash_prefill_sm90.cu, K5) and
// its gradient (flash_prefill_bwd.cu). Tiles of a [batch, seqlen, heads,
// head_dim] bf16 tensor land in shared memory as head_dim / kBlk column
// parts of rows x kBlk values, one swizzle span a row, the parts one after
// the other; the wgmma descriptors of both kernels read that layout.
// Internal linkage throughout: each library keeps its own copies.
#pragma once

#include <cuda.h>
#include <cuda_runtime.h>

#include "hopper_ptx.cuh"

namespace {

// Shared-memory tiling of one head_dim: rows of kBlk bf16 values (one
// swizzle span), head_dim / kBlk column parts stored one after the other.
template <int HD>
struct Geo {
  static constexpr int kBlk = HD < 64 ? HD : 64;
  static constexpr int kRowBytes = kBlk * 2;              // 64 or 128
  static constexpr int kParts = HD / kBlk;                // 1, 2 or 4
  static constexpr int kSwizzle = kRowBytes == 128 ? 1 : 2;
  static constexpr int kSbo = 8 * kRowBytes;              // 8-row group
  static constexpr int kKvPart = 64 * kRowBytes;          // 64-row tile part
  static constexpr int kKvBytes = 64 * HD * 2;            // a 64-row tile
};

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from libcuda, looked up through the runtime so
// that the library needs no -lcuda.
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A bf16 [batch, len (of seqlen rows), heads, head_dim] view as a 4-D
// tensor map with boxes of box_heads x box_rows rows of kBlk values.
// Rows at or past len arrive as zeros.
template <int HD>
bool make_map(CUtensorMap* map, const void* base, int batch, int seqlen,
              int len, int heads, int box_heads, int box_rows) {
  using G = Geo<HD>;
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)HD, (cuuint64_t)heads,
                              (cuuint64_t)len, (cuuint64_t)batch};
  const cuuint64_t strides[3] = {(cuuint64_t)HD * 2,
                                 (cuuint64_t)heads * HD * 2,
                                 (cuuint64_t)seqlen * heads * HD * 2};
  const cuuint32_t box[4] = {(cuuint32_t)G::kBlk, (cuuint32_t)box_heads,
                             (cuuint32_t)box_rows, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                const_cast<void*>(base), dims, strides, box, elem,
                CU_TENSOR_MAP_INTERLEAVE_NONE,
                G::kSwizzle == 1 ? CU_TENSOR_MAP_SWIZZLE_128B
                                 : CU_TENSOR_MAP_SWIZZLE_64B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// Dynamic shared memory starts 16-byte aligned; swizzled tiles want 1024.
__device__ __forceinline__ uint8_t* align_1024(uint8_t* p) {
  return p + ((1024 - (ptx::smem_addr(p) & 1023)) & 1023);
}

}  // namespace
