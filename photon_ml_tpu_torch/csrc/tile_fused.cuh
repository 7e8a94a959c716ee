// The tile-fused pass on Hopper (sm_90a): a row pass and the feature-space
// scatter of its per-row values in one launch, for the fused kernels that
// return sum_i r_i * x_i with a per-row value r_i computed from the row's
// margins (value_grad.cu: r = wgt*l'(z); hessian_vector.cu's hv:
// r = wgt*l''(z)*(x.v + s1), two tables; its hv_at: r = d2*(x.v + s)), and
// one finishing launch:
//
//   out_f = sum_i r_i * x_if,   sums = the epilogue's per-row sums (e.g. sum r)
//
// Work unit: a row tile of tile_rows rows (ops/csr.py SCATTER_TILE_ROWS,
// 8192: 32 KB of r). A thread-block cluster of kCluster blocks takes a tile;
// the grid holds as many clusters as are resident at once, and each cluster
// walks the tiles t, t + clusters, ... (persistent: each block's partial
// sums cover all its tiles).
//
//   Phase A (rows). Each block runs the CSR-stream row pass of rowpass.cuh
//   over its quarter of the tile: a warp per 32 consecutive rows, their
//   nonzeros one span swept with 16-byte loads, one thread per row. The
//   epilogue's per-row value goes to the block's shared memory, not to
//   global memory, and its sums to per-thread partials.
//
//   cluster.sync(); each block copies the three other quarters of the tile's
//   r from its peers' shared memory (distributed shared memory) into its
//   own, so the gathers of phase B stay in local shared memory; cluster.sync()
//   again, after which no block reads a peer's quarter of this tile.
//
//   Phase B (features). The mirror is in the index's slot order (start ==
//   off, ops/csr.py), so a work piece (32 slots of one tile, cut every
//   piece_len nonzeros as in scatter.cu) is one contiguous span of the
//   mirror: the cluster's warps take the tile's pieces in turn and sweep each
//   with the same 16-byte fill as the row pass, "cols" being the mirror's
//   rows and the table the tile's r in shared memory. Each lane whose segment
//   meets the piece writes its sum to the feature-major place the index gives
//   (part_at); segments over kLongSegment nonzeros go to the whole warp.
//
//   Finish (one launch of kFinishThreads-thread blocks): each feature's parts
//   added in (tile, piece) order, as scatter.cu finishes, and in one more
//   block the grid's block partials of the sums, in a fixed order.
//
// No float atomics, and the grid depends only on the card and the shapes, so
// every output is bit-identical from launch to launch; each feature's sum
// is taken over the same segments, parts and order as scatter.cu's.
//
// The tables (w, or w and v) are gathered through the read-only cache, never
// staged in shared memory: shared memory holds only the chunks and the
// tile's r, so two blocks stay resident per SM and the L1 they leave keeps
// the tables' hot lines. Staging one or both tables was slower at the
// widths the paths run (PERF.md section 6).

#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "rowpass.cuh"
#include "tiles.cuh"

namespace photon {
namespace {

namespace cg = cooperative_groups;

constexpr int kFusedThreads = kRowThreads;  // block_sums is sized for these
constexpr int kFusedWarps = kFusedThreads / 32;
// blocks of a cluster, and so quarters of a row tile
constexpr int kCluster = 4;
// resident blocks the compiler budgets registers for (two 512-thread blocks:
// 64 registers a thread); the chunks and the tile's r leave room for two
constexpr int kFusedMinBlocks = 2;
constexpr size_t kFusedSmemLimitBytes = 220 * 1024;

struct TileFusedParams {
  RowPassParams row;    // the CSR, the table(s), the per-row inputs, partials
  const int* csc_rows;  // the mirror in slot order
  const float* csc_vals;
  TileIndex ix;
  float* part;  // [feat_ptr[F]]
  int tile_rows;
  int piece_len;
  int n_tiles;
};

// Epi: kTables (1 or 2), kSums, and
//   static float row_value(const RowPassParams&, int row, float a0, float a1,
//                          float* part)
// which returns the row's r and adds its terms to part[0..kSums).
template <class Epi>
__global__ void __launch_bounds__(kFusedThreads, kFusedMinBlocks)
tile_fused_kernel(const __grid_constant__ TileFusedParams tp) {
  constexpr int K = Epi::kTables;
  const RowPassParams& p = tp.row;
  const TileIndex& ix = tp.ix;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  float* chunk = smem + warp * K * kChunk;
  float* tile_vals = smem + kFusedWarps * K * kChunk;  // [tile_rows]
  GatherFill<K, false> row_fill{p.cols, p.vals, p.table0, p.table1, chunk,
                                aligned16(p.cols, p.vals), false, 0};
  GatherFill<1, true> col_fill{tp.csc_rows, tp.csc_vals, tile_vals, nullptr, chunk,
                               aligned16(tp.csc_rows, tp.csc_vals), false, 0};
  const float shift0 = p.shift0_host + (p.shift0_dev != nullptr ? __ldg(p.shift0_dev) : 0.0f);
  const float shift1 = p.shift1_host + (p.shift1_dev != nullptr ? __ldg(p.shift1_dev) : 0.0f);
  constexpr int kParts = Epi::kSums > 0 ? Epi::kSums : 1;
  float part[kParts];
#pragma unroll
  for (int k = 0; k < kParts; ++k) part[k] = 0.0f;

  // each block's rows of a tile: a multiple of 32, so warp spans and the
  // quarters' float4 copies stay aligned
  const int quarter = (tp.tile_rows + kCluster * 32 - 1) / (kCluster * 32) * 32;
  const int n_clusters = gridDim.x / kCluster;
  // Every loop below is uniform across its warp (segment_sums shuffles) and
  // the tile loop across the cluster (cluster.sync).
  for (int t = blockIdx.x / kCluster; t < tp.n_tiles; t += n_clusters) {
    const int row0 = t * tp.tile_rows;
    const int rows_here = min(tp.tile_rows, p.n_rows - row0);
    const int mine_lo = min(rank * quarter, rows_here);
    const int mine_hi = min(mine_lo + quarter, rows_here);
    __syncthreads();  // the last tile's phase B is done

    // Phase A: this block's quarter of the rows
    const int end = row0 + mine_hi;
    for (int r0 = row0 + mine_lo + warp * 32; r0 < end; r0 += kFusedWarps * 32) {
      const int row = r0 + lane;
      const int lo = __ldg(p.row_ptr + min(row, end));
      const int hi = __ldg(p.row_ptr + min(row + 1, end));
      float acc[K];
#pragma unroll
      for (int k = 0; k < K; ++k) acc[k] = 0.0f;
      segment_sums<K>(lo, hi, chunk, row_fill, acc);
      if (row < end) {
        tile_vals[row - row0] = Epi::row_value(p, row, acc[0] + shift0, acc[K - 1] + shift1,
                                               part);
      }
    }
    cluster.sync();

    // the peers' quarters, over distributed shared memory
    for (int k = 1; k < kCluster; ++k) {
      const int peer = (rank + k) % kCluster;
      const int lo = min(peer * quarter, rows_here);
      const int hi = min(lo + quarter, rows_here);
      const float* src = cluster.map_shared_rank(tile_vals, peer);
      const int quads = (hi - lo) / 4;
      for (int i = threadIdx.x; i < quads; i += blockDim.x) {
        reinterpret_cast<float4*>(tile_vals + lo)[i] =
            reinterpret_cast<const float4*>(src + lo)[i];
      }
      for (int i = lo + 4 * quads + threadIdx.x; i < hi; i += blockDim.x) tile_vals[i] = src[i];
    }
    cluster.sync();

    // Phase B: the tile's pieces over the cluster's warps
    col_fill.base = row0;
    const int p_end = __ldg(ix.piece_ptr + __ldg(ix.tile_group + t + 1));
    for (int q = __ldg(ix.piece_ptr + __ldg(ix.tile_group + t)) + rank * kFusedWarps + warp;
         q < p_end; q += kCluster * kFusedWarps) {
      const PieceLane pl = piece_lane(ix, q, tp.piece_len);
      float acc[1] = {0.0f};
      segment_sums<1>(pl.lo, pl.hi, chunk, col_fill, acc);
      if (pl.lo < pl.hi) tp.part[pl.part] = acc[0];
    }
  }
  if constexpr (Epi::kSums > 0) block_sums<kParts>(part, p.partials + blockIdx.x * Epi::kSums);
}

// Blocks [0, gridDim.x - 1): out from the parts (tiles.cuh sum_parts); the
// last block: sums from the `blocks` block partials.
template <int K>
__global__ void __launch_bounds__(kFinishThreads)
tile_fused_finish_kernel(const int* __restrict__ feat_ptr, const float* __restrict__ part,
                         float* __restrict__ out, int n_features, int width,
                         const float* __restrict__ partials, int blocks,
                         float* __restrict__ sums) {
  if (blockIdx.x == gridDim.x - 1) {
    sum_partials<K>(partials, blocks, sums);
  } else {
    sum_parts(feat_ptr, part, out, n_features, width);
  }
}

// The tile-fused pass with epilogue Epi and its finish: out[F] and
// sums[Epi::kSums]; `partials` holds max_blocks * kSums floats of scratch.
template <class Epi>
cudaError_t run_tile_fused(const TileFusedParams& tp, int max_blocks, int finish_width,
                           float* sums, float* out, cudaStream_t stream) {
  if (tp.ix.start == nullptr || tp.tile_rows <= 0 || tp.piece_len <= 0 || tp.row.n_rows < 0 ||
      !valid_finish_width(finish_width)) {
    return cudaErrorInvalidValue;
  }
  const size_t smem = static_cast<size_t>(kFusedWarps) * Epi::kTables * kChunk * sizeof(float) +
                      static_cast<size_t>(tp.tile_rows) * sizeof(float);
  if (smem > kFusedSmemLimitBytes) return cudaErrorInvalidValue;
  auto kernel = tile_fused_kernel<Epi>;
  int clusters = 0;
  if (tp.n_tiles > 0) {
    cudaError_t err = resident_blocks(reinterpret_cast<const void*>(kernel), kFusedThreads,
                                      smem, &clusters, kCluster);
    if (err != cudaSuccess) return err;
    clusters /= kCluster;
    if (tp.n_tiles < clusters) clusters = tp.n_tiles;
    if (max_blocks / kCluster < clusters) clusters = max_blocks / kCluster;
    if (clusters < 1) return cudaErrorInvalidConfiguration;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = kCluster;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(static_cast<unsigned>(clusters * kCluster));
    cfg.blockDim = dim3(kFusedThreads);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = stream;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    err = cudaLaunchKernelEx(&cfg, kernel, tp);
    if (err != cudaSuccess) return err;
  }
  const int n_features = tp.row.n_features;
  tile_fused_finish_kernel<Epi::kSums>
      <<<finish_blocks(n_features, finish_width) + 1, kFinishThreads, 0, stream>>>(
          tp.ix.feat_ptr, tp.part, out, n_features, finish_width, tp.row.partials,
          clusters * kCluster, sums);
  return cudaGetLastError();
}

// The parameters of a tile-fused pass over the row pass's `p`, the mirror
// in slot order and its int32 tile index (tiles.cuh).
inline TileFusedParams tile_fused_params(const RowPassParams& p, const int* csc_rows,
                                         const float* csc_vals, const int* tile_index,
                                         int n_slots, int n_pieces, int tile_rows,
                                         int piece_len, float* part) {
  TileFusedParams tp{};
  tp.row = p;
  tp.csc_rows = csc_rows;
  tp.csc_vals = csc_vals;
  tp.n_tiles = tile_rows > 0 ? (p.n_rows + tile_rows - 1) / tile_rows : 0;
  tp.ix = tile_index_view(tile_index, n_slots, n_pieces, tp.n_tiles, p.n_features);
  tp.part = part;
  tp.tile_rows = tile_rows;
  tp.piece_len = piece_len;
  return tp;
}

}  // namespace
}  // namespace photon
