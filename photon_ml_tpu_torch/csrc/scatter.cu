// Feature-space scatter over a column-sorted (CSC) mirror on Hopper (sm_90a):
//   g_f = sum_{k in column f} per_row[rows_k] * vals_k      (vals_k^2 with square)
//
// Replaces the TPU kernel `_scatter_kernel` (photon_ml_tpu/ops/tiled.py:199,
// built by `_scatter_call` at :350). The TPU version accumulates one-hot
// matmuls across a sequential grid; Hopper blocks run in no order, and a
// scatter by row would need float atomics, whose order changes from run to
// run. Here every sum is taken in a fixed order over the CSC mirror, so the
// result is bit-for-bit reproducible.
//
// Bound: bytes. Per call it must read rows and vals (8 bytes per nonzero)
// and per_row, and write one float per feature. per_row (4 MB at a million
// rows) stays in the 50 MB L2, but a warp's gather of it by row touches one
// 32-byte sector per lane, so a design that gathers per_row from L2 moves 32
// bytes of L2 traffic per nonzero, four times the slot bytes.
//
// Design: rows are cut into tiles of tile_rows, and block (t, j) stages
// per_row of tile t in shared memory, so the gather reads shared memory
// instead of L2. The entries of column f with rows in tile t are one
// contiguous CSC range (rows ascend inside a column): a segment. The host
// index (ops/csr.py `scatter_tiles`) lists only the non-empty segments, tile
// by tile in feature order, each tile's list padded with empty segments to a
// multiple of 32 slots, so its size is bounded by the nonzeros and not by
// features x tiles. A group is 32 consecutive slots of one tile, lane s
// owning slot s; a work piece is a group, or, where the group holds more
// than piece_len nonzeros (hot features), one piece_len slice of it, so a hot
// feature is spread over many warps. A piece's warp sums its lanes' segments
// with the warp segment sums of segments.cuh (coalesced loads of the
// nonzeros into a shared-memory chunk of products; each lane adds its own
// segment in order; long segments use the whole warp). Each lane whose
// segment meets the piece writes its sum, a part, to its own place in a
// feature-major array: feature by feature, tiles and then pieces
// ascending. A second launch adds each feature's parts, one contiguous run,
// in that order.
//
// The tile index is tiles.cuh's. On a mirror in slot order (a CUDA batch's,
// ops/csr.py) start[s] == off[s], so each lane's positions are its own mirror
// entries and the fill's cursor walk is the identity; the fill still reads
// start, so the kernel takes either order.

#include <cuda_runtime.h>

#include "segments.cuh"
#include "tiles.cuh"

namespace photon {
namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
// per-warp segment table of the fill: 33 virtual offsets, 32 CSC starts
constexpr int kSegInts = 66;
constexpr size_t kSmemLimitBytes = 220 * 1024;
// resident blocks the compiler budgets registers for (three 512-thread
// blocks: 42 registers a thread)
constexpr int kMinBlocks = 3;

// The fill of the tiled scatter: lane s's segment covers virtual positions
// [off[s], off[s + 1]), which are CSC entries start[s] + (q - off[s]). Each
// lane keeps a cursor on the segment of its positions, which only moves
// forward within a piece.
struct TileFill {
  const int* rows;
  const float* vals;
  const float* tile_vals;  // per_row of the tile, in shared memory
  const int* off;          // [33]
  const int* start;        // [32]
  float* chunk;
  int row0;
  bool square;
  int cursor;

  __device__ __forceinline__ void operator()(int c0, int span_lo, int span_hi) {
    constexpr int kPer = kChunk / 32;
    const int lane = threadIdx.x & 31;
    int k[kPer];
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int q = c0 + lane + 32 * i;
      k[i] = -1;
      if (q >= span_lo && q < span_hi) {
        while (off[cursor + 1] <= q) ++cursor;
        k[i] = start[cursor] + (q - off[cursor]);
      }
    }
    int r[kPer];
    float v[kPer];
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      r[i] = k[i] >= 0 ? __ldg(rows + k[i]) : row0;
      v[i] = k[i] >= 0 ? __ldg(vals + k[i]) : 0.0f;
    }
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const float x = square ? v[i] * v[i] : v[i];
      chunk[lane + 32 * i] = x * tile_vals[r[i] - row0];
    }
  }
};

__global__ void __launch_bounds__(kThreads, kMinBlocks)
csc_scatter_tiled_kernel(const TileIndex ix, const int* __restrict__ rows,
                         const float* __restrict__ vals, const float* __restrict__ per_row,
                         float* __restrict__ part, int n_rows, int tile_rows, int piece_len,
                         int square) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int t = blockIdx.x;
  float* chunk = smem + warp * kChunk;
  int* seg = reinterpret_cast<int*>(smem + kWarps * kChunk) + warp * kSegInts;
  float* tile_vals = smem + kWarps * (kChunk + kSegInts);
  const int row0 = t * tile_rows;
  const int rows_here = min(tile_rows, n_rows - row0);
  for (int i = threadIdx.x; i < rows_here; i += blockDim.x) {
    tile_vals[i] = __ldg(per_row + row0 + i);
  }
  __syncthreads();

  TileFill fill{rows, vals, tile_vals, seg, seg + 33, chunk, row0, square != 0, 0};
  const int p_end = __ldg(ix.piece_ptr + __ldg(ix.tile_group + t + 1));
  for (int p = __ldg(ix.piece_ptr + __ldg(ix.tile_group + t)) + blockIdx.y * kWarps + warp;
       p < p_end; p += gridDim.y * kWarps) {
    const PieceLane pl = piece_lane(ix, p, piece_len);
    seg[lane] = pl.lo;
    seg[33 + lane] = __ldg(ix.start + pl.slot) + (pl.lo - pl.s_lo);
    if (lane == 31) seg[32] = pl.hi;
    __syncwarp();
    fill.cursor = 0;
    float acc[1] = {0.0f};
    segment_sums<1>(pl.lo, pl.hi, chunk, fill, acc);
    if (pl.lo < pl.hi) part[pl.part] = acc[0];
    __syncwarp();  // the segment table is rewritten next
  }
}

__global__ void __launch_bounds__(kFinishThreads)
finish_tiled_kernel(const int* __restrict__ feat_ptr, const float* __restrict__ part,
                    float* __restrict__ out, int n_features, int width) {
  sum_parts(feat_ptr, part, out, n_features, width);
}

}  // namespace
}  // namespace photon

// tile_index: the int32 tile index (file comment) with n_slots slots and
// n_pieces pieces, for tiles of tile_rows rows and pieces of piece_len
// nonzeros; part: scratch of one float per part (feat_ptr[F]);
// finish_width: the lanes that sum one feature's parts (a power of two, at
// most 32).
extern "C" int photon_csc_scatter(const int* rows, const float* vals, const int* tile_index,
                                  int n_slots, int n_pieces, int finish_width, int tile_rows,
                                  int piece_len, const float* per_row, float* out, float* part,
                                  int n_rows, int n_features, int square, void* stream) {
  using namespace photon;
  if (n_features <= 0) return cudaSuccess;
  if (tile_index == nullptr || tile_rows <= 0 || piece_len <= 0 || n_rows < 0 ||
      !valid_finish_width(finish_width)) {
    return cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int n_tiles = (n_rows + tile_rows - 1) / tile_rows;
  const TileIndex ix = tile_index_view(tile_index, n_slots, n_pieces, n_tiles, n_features);
  const size_t smem = static_cast<size_t>(kWarps) * (kChunk + kSegInts) * sizeof(float) +
                      static_cast<size_t>(tile_rows) * sizeof(float);
  if (smem > kSmemLimitBytes) return cudaErrorInvalidValue;
  cudaError_t err;
  if (n_pieces > 0) {
    const void* kernel = reinterpret_cast<const void*>(csc_scatter_tiled_kernel);
    int resident = 0;
    if ((err = resident_blocks(kernel, kThreads, smem, &resident)) != cudaSuccess) return err;
    // blocks per tile: one wave in all, and at least two pieces a warp
    long long per_tile = resident / n_tiles;
    const long long useful = (n_pieces / n_tiles + 2 * kWarps) / (2 * kWarps);
    if (per_tile > useful) per_tile = useful;
    if (per_tile < 1) per_tile = 1;
    if (per_tile > 65535) per_tile = 65535;
    csc_scatter_tiled_kernel<<<dim3(n_tiles, static_cast<unsigned>(per_tile)), kThreads, smem,
                               s>>>(ix, rows, vals, per_row, part, n_rows, tile_rows, piece_len,
                                    square);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  finish_tiled_kernel<<<finish_blocks(n_features, finish_width), kFinishThreads, 0, s>>>(
      ix.feat_ptr, part, out, n_features, finish_width);
  return cudaGetLastError();
}
