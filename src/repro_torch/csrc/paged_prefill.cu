// Paged flash-prefill for Hopper (sm_90a): the query rows of the prefill
// chunk lanes of one mixed step against each lane's paged K/V, through the
// lane's block table, causal on absolute positions, GQA-native. One launch
// takes every lane of a step: a grid of (query block, KV head x 16-head
// slice, lane).
//
// Replaces the TPU kernel repro/kernels/flash_prefill/paged_prefill.py
// (paged_flash_prefill_fwd, body _paged_prefill_kernel), which the
// reference calls once per lane: row i of a lane sits at position pos0 + i
// and sees keys at positions <= pos0 + i (the mask of paged_prefill.py:155);
// rows >= valid_len are bucket padding and get exact zeros (the epilogue at
// :171); pages past a query block's causal horizon are never read.
//
// Where each lane's numbers come from: its block table is row
// lane * bucket of the step's table rows, pos0 is the position of that same
// row (positions[lane * bucket], already on the device) and valid_len is
// chunk_lens[lane] (the step's one host-to-device copy carries it). So a
// launch reads no host integer that changes from step to step: the bucket
// and the lane count are shapes. The one-lane entry (the JAX signature)
// passes pos0 and valid_len as host integers instead, with null pointers.
//
// What bounds it on this card: at the serving shapes, neither bytes nor
// operations. A lane of 32 rows (17 valid) over 17 keys of r1-distill-14b
// moves ~0.6 MB (0.17 us at 3.35 TB/s); the time is the dependent chain a
// CTA walks (table, K/V tile, Q.K^T, softmax, P.V, store) above the ~5 us
// of an empty launch. The bf16 design shortens that chain:
//   * Rows on tensor cores. One 16-row m16n8k16 m-tile holds (chunk row,
//     query head) pairs of one KV head: floor(16 / group) chunk rows x the
//     GQA group (3 x 5 for r1-distill-14b, 2 x 7 for qwen2-0.5b, 8 x 2 for
//     the 32-wide fallback trunks; a group of 17-32 takes two 16-head
//     slices, one chunk row each). A CTA holds four m-tiles, one per warp.
//   * GQA-native tiles. The CTA stages each 32-key K/V tile once with
//     cp.async for all four warps, and the next tile is in flight while
//     this one's Q.K^T, softmax and P.V run (one barrier per tile).
//   * The arithmetic of the decode core (paged_decode_mma.cuh's tile
//     pieces): Q.K^T takes the raw bf16 q and is scaled by 1/sqrt(hd) in
//     fp32; m, l and acc are fp32; P.V takes P split into bf16 hi and lo.
//     A per-row causal end: key k counts for a row while k < pos0 + t + 1.
//   * Keys past the CTA's horizon (its last valid row's position) are
//     zero-filled in shared memory and never loaded: a tensor core
//     computes 0 x NaN = NaN. A warp skips a tile that starts past its own
//     rows' ends; a q-block whose rows are all padding writes its zeros
//     and exits at once.
// fp32 keeps the CUDA-core loop of paged_common.cuh (stream_pages): bf16
// tensor-core products cannot meet fp32's tolerance. It takes the same
// lanes launch. Head_dim 32, 64, 128 and 256, each its own instantiation;
// at 256 (gemma-7b) a bf16 CTA is eight warps, two per m-tile, each
// owning 128 of the output columns (both compute the m-tile's S and P;
// a whole row of o would be 128 registers a thread), Q's fragments are
// read from shared memory in each product, and the fp32 kernel's shared
// tile is dynamic shared memory.
//
// Measured (chip_smoke.py phase 3, bf16, r1-distill-14b's heads, device
// time with the launches queued; NVIDIA H100 80GB HBM3, 700.00 W): one
// lane of 32 rows at pos0 0 with 17 valid, 0.0097 ms (the per-lane
// CUDA-core kernel this replaces: 0.0373 in the same run; SDPA 0.029);
// 64 rows at pos0 192, 0.0285 ms against SDPA's 0.0298, each warp
// walking its 7-8 key tiles in series (PERF.md section 6).
#include "paged_decode_mma.cuh"

using namespace paged;

namespace {

using bf16 = __nv_bfloat16;
constexpr int kWarps = kThreads / 32;   // m-tiles of a bf16 CTA
constexpr int kTileRows = 16;           // rows of one m-tile

// The lanes of one launch. Lane i's rows are rows i * bucket .. of q and
// out; its table starts table_stride ints after lane i - 1's; its pos0 and
// valid_len come from the device arrays, or from the host ints where the
// pointers are null (the one-lane entry).
struct Lanes {
  const int* tables;
  const int* positions;    // [n_lanes * bucket] or null
  const int* chunk_lens;   // [n_lanes] or null
  int table_stride, bucket, pos0, valid_len;

  __device__ int first(int i) const {
    return positions ? positions[(size_t)i * bucket] : pos0;
  }
  __device__ int valid(int i) const {
    return chunk_lens ? chunk_lens[i] : valid_len;
  }
  __device__ const int* table(int i) const {
    return tables + (size_t)i * table_stride;
  }
};

// ------------------------------------------------------- bf16: mma tiles

// Dynamic shared memory (bytes): Q of the four m-tiles, then two stages
// of one 32-key K tile and one V tile.
template <int HD>
struct MmaLayout {
  static constexpr int kStride = tile::stride<HD>();
  static constexpr size_t kQ = (size_t)kWarps * kTileRows * kStride * 2;
  static constexpr size_t kTile = (size_t)tile::kKeys * kStride;  // elems
  static constexpr size_t kBytes = kQ + 2 * 2 * kTile * 2;
};

// The threads of a bf16 CTA: one warp per m-tile up to head_dim 128; at
// 256 two, each owning one 128-column half of the m-tile's output (o
// would otherwise be 128 registers a thread). Both warps of a pair
// compute the same S and P.
template <int HD>
struct MmaCta {
  static constexpr int kHalves = HD > 128 ? 2 : 1;
  static constexpr int kCols = HD / kHalves;   // output columns a warp owns
  static constexpr int kThreads = kWarps * 32 * kHalves;
};

// Row r of an m-tile: chunk row r / gs of the tile, query head r % gs of
// the slice (gs = the slice's head count, at most 16).
struct RowMap {
  int gs, rpt, heads;
  __device__ bool owns(int r) const { return r / gs < rpt && r % gs < heads; }
};

template <int HD>
__global__ void __launch_bounds__(MmaCta<HD>::kThreads) prefill_mma_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k_pages,
    const bf16* __restrict__ v_pages, const Lanes ln,
    bf16* __restrict__ out, int q_heads, int kv_heads, int num_pages,
    int page_size, int pages_per_seq, float scale) {
  using L = MmaLayout<HD>;
  constexpr int kStride = L::kStride;
  constexpr int kChunks = HD / 8;   // 16-byte chunks per row
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sq = reinterpret_cast<bf16*>(smem);   // [warp][16][kStride]
  bf16* tiles = reinterpret_cast<bf16*>(smem + L::kQ);   // [stage][K, V]

  constexpr int kCta = MmaCta<HD>::kThreads;
  constexpr int kCols = MmaCta<HD>::kCols;
  const int tid = threadIdx.x, lane = tid % 32;
  const int warp = (tid / 32) % kWarps;     // the m-tile
  const int half = tid / 32 / kWarps;       // its column half (256 only)
  const int li = blockIdx.z;
  const int group = q_heads / kv_heads;
  const int slices = (group + kTileRows - 1) / kTileRows;
  const int h = blockIdx.y / slices;
  const int head0 = (blockIdx.y % slices) * kTileRows;
  const int gs = min(group, kTileRows);
  const RowMap map{gs, kTileRows / gs, min(gs, group - head0)};
  const int block_q = kWarps * map.rpt;   // chunk rows of this CTA
  const int T = ln.bucket;
  const int q_start = blockIdx.x * block_q;
  const int nq = min(block_q, T - q_start);
  const size_t row0 = (size_t)li * T;     // the lane's first row
  const size_t qh0 = (size_t)h * group + head0;
  const int pos0 = max(ln.first(li), 0);
  const int valid = min(max(ln.valid(li), 0), T);

  if (q_start >= valid) {   // every row is padding: exact zeros
    for (int i = tid; i < nq * map.heads * kChunks; i += kCta) {
      const int t = q_start + i / (map.heads * kChunks);
      const int hs = (i / kChunks) % map.heads;
      *reinterpret_cast<uint4*>(
          out + ((row0 + t) * q_heads + qh0 + hs) * HD + (i % kChunks) * 8) =
          make_uint4(0u, 0u, 0u, 0u);
    }
    return;
  }
  const int cap = pages_per_seq * page_size;
  // the CTA's causal horizon: its last valid row's position + 1
  const int horizon = min(pos0 + min(q_start + block_q, valid), cap);
  const int n_tiles = (horizon + tile::kKeys - 1) / tile::kKeys;
  const int* table = ln.table(li);
  const size_t head = (size_t)h * num_pages * page_size * HD;

  // Q of the four m-tiles: unscaled, zeros at rows no chunk row or head owns
  for (int i = tid; i < kWarps * kTileRows * kChunks; i += kCta) {
    const int w = i / (kTileRows * kChunks), r = (i / kChunks) % kTileRows;
    const int c = (i % kChunks) * 8;
    const int t = q_start + w * map.rpt + r / gs;
    tile::stage(sq + (w * kTileRows + r) * kStride + c,
                q + ((row0 + t) * q_heads + qh0 + r % gs) * HD + c,
                map.owns(r) && t < valid);
  }
  ptx::cp_async_commit();

  // key tile i into stage s, K and V in one group; keys at or past the
  // horizon are zeros
  const auto gather = [&](int i, int s) {
    bf16* kd = tiles + (size_t)(2 * s) * L::kTile;
    bf16* vd = kd + L::kTile;
    for (int idx = tid; idx < tile::kKeys * kChunks; idx += kCta) {
      const int j = idx / kChunks, c = (idx % kChunks) * 8;
      const int pos = tile::kKeys * i + j;
      const bool vis = pos < horizon;
      const size_t src =
          vis ? ((size_t)tile::clamp_page(table[pos / page_size], num_pages) *
                     page_size +
                 pos % page_size) * HD + c
              : 0;
      tile::stage(kd + j * kStride + c, k_pages + head + src, vis);
      tile::stage(vd + j * kStride + c, v_pages + head + src, vis);
    }
    ptx::cp_async_commit();
  };
  gather(0, 0);

  // this thread's rows (lane / 4 and lane / 4 + 8 of the warp's m-tile)
  // and each one's key limit; the warp's last key any of its rows sees
  int lim[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = lane / 4 + 8 * i;
    const int t = q_start + warp * map.rpt + r / gs;
    lim[i] = map.owns(r) && t < valid ? min(pos0 + t + 1, horizon) : 0;
  }
  const int w_last = min(q_start + (warp + 1) * map.rpt, valid) - 1;
  const int warp_end =
      w_last >= q_start + warp * map.rpt ? min(pos0 + w_last + 1, horizon)
                                         : 0;

  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  float o[kCols / 8][4];
#pragma unroll
  for (int n = 0; n < kCols / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
  tile::QOperand<HD> qa;
  ptx::cp_async_wait<0>();   // Q and tile 0 have landed ...
  __syncthreads();           // ... for every thread
  if (warp_end > 0) qa.load(sq + warp * kTileRows * kStride, lane);
  for (int i = 0; i < n_tiles; ++i) {
    if (i > 0) {
      ptx::cp_async_wait<0>();   // tile i has landed ...
      __syncthreads();           // ... for every thread; tile i - 1 is done
    }
    if (i + 1 < n_tiles) gather(i + 1, (i + 1) & 1);
    const int k0 = tile::kKeys * i;
    if (k0 < warp_end) {
      const bf16* kt = tiles + (size_t)(2 * (i & 1)) * L::kTile;
      float sc[tile::kKeys / 8][4];
      qa.qk(sc, kt, lane);
      tile::softmax<kCols>(sc, m, l, o, k0 + 2 * (lane % 4), lim, scale);
      if constexpr (kCols == HD)
        tile::pv<HD>(o, sc, kt + L::kTile, lane);
      else
        tile::pv_cols<kCols, HD>(o, sc, kt + L::kTile + half * kCols, lane);
    }
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {   // m is already the quad's
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = lane / 4 + 8 * i;
    const int t = q_start + warp * map.rpt + r / gs;
    if (!map.owns(r) || t >= T) continue;
    const bool live = t < valid;
    const float inv = 1.f / fmaxf(l[i], 1e-30f);
    bf16* dst = out + ((row0 + t) * q_heads + qh0 + r % gs) * HD +
                half * kCols + 2 * (lane % 4);
#pragma unroll
    for (int n = 0; n < kCols / 8; ++n)
      *reinterpret_cast<__nv_bfloat162*>(dst + 8 * n) =
          __floats2bfloat162_rn(live ? o[n][2 * i] * inv : 0.f,
                                live ? o[n][2 * i + 1] * inv : 0.f);
  }
}

// Whether this library has raised the kernel's dynamic shared memory
// limit (internal linkage: one flag per library).
template <int HD>
bool mma_smem_raised = false;

// The bf16 kernel's grid: (query blocks of kWarps x floor(16 / group)
// chunk rows, KV heads x 16-head slices, lanes) (kernels/introspect.py:
// paged_prefill_grid).
dim3 mma_grid(int bucket, int n_lanes, int q_heads, int kv_heads) {
  const int group = q_heads / kv_heads;
  const int slices = (group + kTileRows - 1) / kTileRows;
  const int block_q = kWarps * (kTileRows / (group < kTileRows ? group
                                                               : kTileRows));
  return dim3((bucket + block_q - 1) / block_q, kv_heads * slices, n_lanes);
}

template <int HD>
int launch_mma(const void* q, const void* k_pages, const void* v_pages,
               const Lanes& ln, void* out, int n_lanes, int q_heads,
               int kv_heads, int num_pages, int page_size, int pages_per_seq,
               float scale, cudaStream_t s) {
  const auto kernel = prefill_mma_kernel<HD>;
  if (!mma_smem_raised<HD>) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)MmaLayout<HD>::kBytes);
    if (err != cudaSuccess) return (int)err;
    mma_smem_raised<HD> = true;
  }
  const dim3 grid = mma_grid(ln.bucket, n_lanes, q_heads, kv_heads);
  kernel<<<grid, MmaCta<HD>::kThreads, MmaLayout<HD>::kBytes, s>>>(
      (const bf16*)q, (const bf16*)k_pages, (const bf16*)v_pages, ln,
      (bf16*)out, q_heads, kv_heads, num_pages, page_size, pages_per_seq,
      scale);
  return (int)cudaGetLastError();
}

// ------------------------------------------------- fp32: the CUDA cores

// One CTA per (query block of floor(32 / group) chunk rows, KV head,
// lane): its rows x group query vectors fit the 32 rows stream_pages owns,
// and it streams each page up to the block's horizon once for all of them.
template <int HD>
__global__ void __launch_bounds__(kThreads) prefill_f32_kernel(
    const float* __restrict__ q, const float* __restrict__ k_pages,
    const float* __restrict__ v_pages, const Lanes ln,
    float* __restrict__ out, int q_heads, int kv_heads, int num_pages,
    int page_size, int pages_per_seq, int block_q, float scale) {
  Shared<HD>& sm = shared_struct<Shared<HD>>();
  constexpr int kStep = Dims<HD>::kStep;
  constexpr int kPer = Dims<HD>::kPer;
  constexpr int kCols = Dims<HD>::kCols;
  const int h = blockIdx.y, li = blockIdx.z, tid = threadIdx.x;
  const int group = q_heads / kv_heads;
  const int T = ln.bucket;
  const int q_start = blockIdx.x * block_q;
  const int nq = min(block_q, T - q_start);
  const int rows = nq * group;  // row r is chunk row q_start + r / group,
                                // query head h * group + r % group
  const size_t row0 = (size_t)li * T;
  const int pos0 = max(ln.first(li), 0);
  const int valid = min(max(ln.valid(li), 0), T);

  for (int i = tid; i < rows * HD; i += kThreads) {
    const int r = i / HD, c = i % HD;
    const size_t src = (row0 + q_start + r / group) * q_heads +
                       (size_t)h * group + r % group;
    sm.q[r][c] = q[src * HD + c] * scale;
  }
  init_rows(sm);
  if (tid < kMaxRows) {
    const int t = q_start + tid / group;
    sm.row_end[tid] = (tid < rows && t < valid) ? pos0 + t + 1 : 0;
  }
  float acc[Dims<HD>::kAcc];
#pragma unroll
  for (int i = 0; i < Dims<HD>::kAcc; ++i) acc[i] = 0.f;

  // the block's causal horizon: the last valid row's position
  const int last = min(q_start + nq, valid);
  const int ctx_end = last > q_start ? pos0 + last : 0;
  const size_t head = (size_t)h * num_pages * page_size * HD;
  stream_pages<float, HD>(sm, acc, k_pages + head, v_pages + head,
                          ln.table(li), pages_per_seq, num_pages, page_size,
                          ctx_end, rows);

  const int d = tid % HD;
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int r = tid / HD + i * kStep;
    if (r < rows) {
      const int t = q_start + r / group;
      const size_t dst = (row0 + t) * q_heads + (size_t)h * group + r % group;
#pragma unroll
      for (int c = 0; c < kCols; ++c)
        out[dst * HD + d + c * kThreads] =
            t < valid ? acc[i * kCols + c] / fmaxf(sm.l[r], 1e-30f) : 0.f;
    }
  }
}

// Whether this library has raised the fp32 kernel's dynamic shared memory
// limit (head_dim 256 only).
template <int HD>
bool f32_smem_raised = false;

}  // namespace

// Returns the cudaError_t of the launch (0 on success). dtype: 0 = fp32,
// 1 = bf16. q and out are [n_lanes * bucket, q_heads, head_dim]; lane i's
// table starts at tables + i * table_stride. positions ([n_lanes * bucket])
// and chunk_lens ([n_lanes]) are device arrays, or both null, and then
// pos0 and valid_len (host ints) describe the one lane. grids (n_grids x 3
// ints) is the wrapper's paged_prefill_grid; a grid that is not this
// launch's is refused before anything launches.
extern "C" int paged_prefill_launch(
    int dtype, int head_dim, const void* q, const void* k_pages,
    const void* v_pages, const void* tables, const void* positions,
    const void* chunk_lens, void* out, int n_lanes, int bucket, int q_heads,
    int kv_heads, int num_pages, int page_size, int pages_per_seq,
    int table_stride, int pos0, int valid_len, float scale,
    const int* grids, int n_grids, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int group = kv_heads > 0 ? q_heads / kv_heads : 0;
  if (group < 1 || group > kMaxRows || n_lanes < 1 || n_lanes > 65535 ||
      bucket < 1 || (positions == nullptr) != (chunk_lens == nullptr))
    return (int)cudaErrorInvalidValue;
  // fp32: one CTA per (floor(32 / group) chunk rows, KV head, lane)
  const int block_q = kMaxRows / group;   // group <= kMaxRows
  const dim3 grid = dtype == 1 ? mma_grid(bucket, n_lanes, q_heads, kv_heads)
                               : dim3((bucket + block_q - 1) / block_q,
                                      kv_heads, n_lanes);
  if (!grids_match(grids, n_grids, &grid, 1))
    return (int)cudaErrorInvalidValue;
  const Lanes ln{(const int*)tables, (const int*)positions,
                 (const int*)chunk_lens, table_stride, bucket, pos0,
                 valid_len};
  int rc = (int)cudaErrorInvalidValue;
  if (dtype == 1) {
    decode::dispatch_hd(head_dim, [&](auto hd) {
      rc = launch_mma<decltype(hd)::value>(
          q, k_pages, v_pages, ln, out, n_lanes, q_heads, kv_heads,
          num_pages, page_size, pages_per_seq, scale, s);
    });
  } else if (dtype == 0) {
    decode::dispatch_hd(head_dim, [&](auto hd) {
      constexpr int HD = decltype(hd)::value;
      const auto kernel = prefill_f32_kernel<HD>;
      rc = (int)opt_in_smem<Shared<HD>>(kernel, f32_smem_raised<HD>);
      if (rc != 0) return;
      kernel<<<grid, kThreads, dynamic_smem<Shared<HD>>(), s>>>(
          (const float*)q, (const float*)k_pages, (const float*)v_pages, ln,
          (float*)out, q_heads, kv_heads, num_pages, page_size,
          pages_per_seq, block_q, scale);
      rc = (int)cudaGetLastError();
    });
  }
  return rc;
}
