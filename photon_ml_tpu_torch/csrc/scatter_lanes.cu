// Feature-space scatter of G per-row vectors over one CSC mirror on Hopper
// (sm_90a), one launch of the tiled pass and one of the finish:
//   Out[g, f] = sum_{k in column f} R[g, rows_k] * vals_k     (vals_k^2 with square)
//
// Replaces the TPU kernel `_scatter_kernel` (photon_ml_tpu/ops/tiled.py:199,
// built by `_scatter_call` at :353) under `jax.vmap` over the lanes of a
// sweep or a bootstrap (photon_ml_tpu/sweep/runner.py:91-116), where
// Pallas's batching rule runs the kernel once per lane. Here the lanes are a
// written-out axis: the mirror and the tile index are read once per chunk
// of lanes rather than once per lane.
//
// Bound: bytes. Per call it must read rows and vals (8 bytes per nonzero)
// once, R (4 G bytes per row), and write G floats per feature.
//
// Design: scatter.cu's tiled pass. Block (t, j, c) stages R of row tile t
// for the lanes of chunk c in shared memory (32 KB a lane at 8192-row
// tiles, so at most kMaxScatterLanes = 6 lanes beside the warps' chunks in
// 220 KB); each warp takes work pieces of the tile as scatter.cu does,
// loads each chunk's rows and vals once (the cursor walk of TileFill) and,
// lane of the chunk by lane, writes the products to its shared-memory chunk
// and sums each segment in segment_sums's order. The parts land in a
// [G, parts] array at the single-vector kernel's places and the finish sums
// each feature's parts in the same order, so every lane is bit for bit what
// scatter.cu gives for that lane's vector, whatever the number of lanes.
// No float atomics.

#include <cuda_runtime.h>

#include "segments.cuh"
#include "tiles.cuh"

namespace photon {
namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kSegInts = 66;  // scatter.cu's per-warp segment table
constexpr size_t kSmemLimitBytes = 220 * 1024;
constexpr int kMaxScatterLanes = 6;

__global__ void __launch_bounds__(kThreads, 1)
scatter_lanes_kernel(const TileIndex ix, const int* __restrict__ rows,
                     const float* __restrict__ vals, const float* __restrict__ per_row,
                     float* __restrict__ part, int n_rows, int tile_rows, int piece_len,
                     int square, int n_lanes, int lanes_per_chunk, long long n_parts) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int t = blockIdx.x;
  const int g0 = blockIdx.z * lanes_per_chunk;
  const int gn = min(lanes_per_chunk, n_lanes - g0);
  float* chunk = smem + warp * kChunk;
  int* seg = reinterpret_cast<int*>(smem + kWarps * kChunk) + warp * kSegInts;
  float* tile_vals = smem + kWarps * (kChunk + kSegInts);
  const int row0 = t * tile_rows;
  const int rows_here = min(tile_rows, n_rows - row0);
  for (int g = 0; g < gn; ++g) {
    const float* src = per_row + static_cast<long long>(g0 + g) * n_rows + row0;
    for (int i = threadIdx.x; i < rows_here; i += blockDim.x) {
      tile_vals[g * tile_rows + i] = __ldg(src + i);
    }
  }
  __syncthreads();

  const int* off = seg;
  const int* start = seg + 33;
  const int p_end = __ldg(ix.piece_ptr + __ldg(ix.tile_group + t + 1));
  for (int q = __ldg(ix.piece_ptr + __ldg(ix.tile_group + t)) + blockIdx.y * kWarps + warp;
       q < p_end; q += gridDim.y * kWarps) {
    const PieceLane pl = piece_lane(ix, q, piece_len);
    seg[lane] = pl.lo;
    seg[33 + lane] = __ldg(ix.start + pl.slot) + (pl.lo - pl.s_lo);
    if (lane == 31) seg[32] = pl.hi;
    __syncwarp();
    float acc[kMaxScatterLanes];
#pragma unroll
    for (int g = 0; g < kMaxScatterLanes; ++g) acc[g] = 0.0f;
    // segment_sums (segments.cuh) over TileFill's positions, for gn lanes
    const int lo = pl.lo, hi = pl.hi;
    const int span_lo = __shfl_sync(kFullMask, lo, 0);
    const int span_hi = __shfl_sync(kFullMask, hi, 31);
    const bool is_long = hi - lo > kLongSegment;
    int cursor = 0;
    for (int c0 = span_lo & ~3; c0 < span_hi; c0 += kChunk) {
      constexpr int kPer = kChunk / 32;
      int r[kPer];
      float x[kPer];
#pragma unroll
      for (int i = 0; i < kPer; ++i) {
        const int pos = c0 + lane + 32 * i;
        int k = -1;
        if (pos >= span_lo && pos < span_hi) {
          while (off[cursor + 1] <= pos) ++cursor;
          k = start[cursor] + (pos - off[cursor]);
        }
        r[i] = k >= 0 ? __ldg(rows + k) : row0;
        const float v = k >= 0 ? __ldg(vals + k) : 0.0f;
        x[i] = square ? v * v : v;
      }
      const unsigned long_lanes =
          __ballot_sync(kFullMask, is_long && lo < c0 + kChunk && hi > c0);
#pragma unroll
      for (int g = 0; g < kMaxScatterLanes; ++g) {
        if (g >= gn) break;  // uniform across the block
        const float* tv = tile_vals + g * tile_rows;
#pragma unroll
        for (int i = 0; i < kPer; ++i) chunk[lane + 32 * i] = x[i] * tv[r[i] - row0];
        __syncwarp();
        if (!is_long) {
          const int a = max(lo, c0) - c0;
          const int b = min(hi, c0 + kChunk) - c0;
          for (int j = a; j < b; ++j) acc[g] += chunk[j];
        }
        for (unsigned m = long_lanes; m != 0; m &= m - 1) {
          const int src = __ffs(m) - 1;
          const int a = max(__shfl_sync(kFullMask, lo, src), c0) - c0;
          const int b = min(__shfl_sync(kFullMask, hi, src), c0 + kChunk) - c0;
          float s[1] = {0.0f};
          for (int j = a + lane; j < b; j += 32) s[0] += chunk[j];
          warp_tree<1>(s);
          if (lane == src) acc[g] += s[0];
        }
        __syncwarp();
      }
    }
    if (pl.lo < pl.hi) {
#pragma unroll
      for (int g = 0; g < kMaxScatterLanes; ++g) {
        if (g >= gn) break;
        part[(g0 + g) * n_parts + pl.part] = acc[g];
      }
    }
    __syncwarp();  // the segment table is rewritten next
  }
}

// lane blockIdx.y: out[y, f] = the sum of f's parts of lane y, as scatter.cu
__global__ void __launch_bounds__(kFinishThreads)
finish_lanes_kernel(const int* __restrict__ feat_ptr, const float* __restrict__ part,
                    float* __restrict__ out, int n_features, int width, long long n_parts) {
  sum_parts(feat_ptr, part + blockIdx.y * n_parts,
            out + static_cast<long long>(blockIdx.y) * n_features, n_features, width);
}

}  // namespace
}  // namespace photon

// per_row: [n_lanes, n_rows]; out: [n_lanes, n_features]; part: scratch of
// n_lanes * n_parts floats; the other arguments are photon_csc_scatter's.
extern "C" int photon_csc_scatter_lanes(const int* rows, const float* vals,
                                        const int* tile_index, int n_slots, int n_pieces,
                                        int finish_width, int tile_rows, int piece_len,
                                        int n_parts, const float* per_row, float* out,
                                        float* part, int n_rows, int n_features, int n_lanes,
                                        int square, void* stream) {
  using namespace photon;
  if (n_features <= 0 || n_lanes <= 0) return cudaSuccess;
  if (tile_index == nullptr || tile_rows <= 0 || piece_len <= 0 || n_rows < 0 ||
      n_parts < 0 || n_lanes > 65535 || !valid_finish_width(finish_width)) {
    return cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int n_tiles = (n_rows + tile_rows - 1) / tile_rows;
  const TileIndex ix = tile_index_view(tile_index, n_slots, n_pieces, n_tiles, n_features);
  const size_t fixed = static_cast<size_t>(kWarps) * (kChunk + kSegInts) * sizeof(float);
  const size_t per_lane = static_cast<size_t>(tile_rows) * sizeof(float);
  if (fixed + per_lane > kSmemLimitBytes) return cudaErrorInvalidValue;
  long long cap = static_cast<long long>((kSmemLimitBytes - fixed) / per_lane);
  if (cap > kMaxScatterLanes) cap = kMaxScatterLanes;
  const int n_chunks = static_cast<int>((n_lanes + cap - 1) / cap);
  const int lanes_per_chunk = (n_lanes + n_chunks - 1) / n_chunks;
  const size_t smem = fixed + lanes_per_chunk * per_lane;
  cudaError_t err;
  if (n_pieces > 0 && n_tiles > 0) {
    const void* kernel = reinterpret_cast<const void*>(scatter_lanes_kernel);
    int resident = 0;
    if ((err = resident_blocks(kernel, kThreads, smem, &resident)) != cudaSuccess) return err;
    // blocks per tile and chunk: one wave in all, and at least two pieces a warp
    long long per_tile = resident / (static_cast<long long>(n_tiles) * n_chunks);
    const long long useful = (n_pieces / n_tiles + 2 * kWarps) / (2 * kWarps);
    if (per_tile > useful) per_tile = useful;
    if (per_tile < 1) per_tile = 1;
    if (per_tile > 65535) per_tile = 65535;
    scatter_lanes_kernel<<<dim3(n_tiles, static_cast<unsigned>(per_tile),
                                static_cast<unsigned>(n_chunks)),
                           kThreads, smem, s>>>(ix, rows, vals, per_row, part, n_rows,
                                                tile_rows, piece_len, square, n_lanes,
                                                lanes_per_chunk, n_parts);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  finish_lanes_kernel<<<dim3(finish_blocks(n_features, finish_width),
                             static_cast<unsigned>(n_lanes)),
                        kFinishThreads, 0, s>>>(ix.feat_ptr, part, out, n_features,
                                                finish_width, n_parts);
  return cudaGetLastError();
}
