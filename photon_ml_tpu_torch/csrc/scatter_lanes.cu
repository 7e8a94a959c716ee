// Feature-space scatter of G per-row vectors over one CSC mirror on Hopper
// (sm_90a), one launch of the tiled pass and one of the finish:
//   Out[g, f] = sum_{k in column f} R[g, rows_k] * vals_k     (vals_k^2 with square)
//
// Replaces the TPU kernel `_scatter_kernel` (photon_ml_tpu/ops/tiled.py:199,
// built by `_scatter_call` at :353) under `jax.vmap` over the lanes of a
// sweep or a bootstrap (photon_ml_tpu/sweep/runner.py:91-116,
// diagnostics/bootstrap.py:92-104), where Pallas's batching rule runs the
// kernel once per lane.
//
// Bound: bytes. Per call it must read rows and vals (8 bytes per nonzero)
// once, R (4 G bytes per row), and write G floats per feature: 224.7 MB at
// config #1 with G = 16. This design's HBM floor adds the tile index once
// (about 12 bytes a segment, 15.1 MB at config #1) and the parts, written
// and read back once (2 * G * n_parts * 4 bytes, 161 MB there): the finish's
// fixed order over the parts is what makes each lane bit for bit the single
// kernel. The mirror and the index are read from HBM once a call for
// G <= 16 (once per 16 lanes above).
//
// Design: scatter.cu's tiles, pieces and parts, on the window walk of
// lanes.cuh. A block holds one lane group's (4 lanes') per_row of a row tile
// lane-minor in shared memory, one float4 per row (128 KB at 8192-row tiles;
// the transpose happens while staging), and the groups of a 16-lane chunk
// are one cluster of up to 4 blocks that takes the same tile and the same
// work pieces in lockstep. A piece is one contiguous span of the mirror in
// the index's slot order (start == off, ops/csr.py; `start` is not read, as
// in tile_fused.cuh), and its 32 slots' segments, clipped to it, are the items
// of the walk: each warp takes kPiecesPerWarp consecutive pieces a round,
// loads windows of up to 32 whole segments into its stage with 16-byte
// loads, and the thread that owns a segment sums it in slot order in four
// registers, one float4 gather a nonzero; segments over kLongSegment
// nonzeros go to the whole warp per kChunk chunk of the piece's grid. The parts land
// lane-minor, a segment's four lanes in one 16-byte store, at the single
// kernel's parts, and the finish sums each feature's parts of each lane in
// the single kernel's order, so every lane is bit for bit what scatter.cu
// gives for that lane's vector. No float atomics, no product chunk.

#include <cuda_runtime.h>

#include "lanes.cuh"
#include "tiles.cuh"

namespace photon {
namespace {

struct ScatterLaneParams {
  TileIndex ix;
  const int* rows;  // the mirror, in the index's slot order
  const float* vals;
  const float* per_row;  // [G, n_rows]
  float* part;           // [n_parts, lanes]: lane-minor, lanes = G rounded up to 4
  int lanes;
  int n_rows;
  int tile_rows;
  int piece_len;
  int square;
  int n_lanes;
  int per_tile;  // clusters a tile's pieces are dealt to
  int cluster;   // blocks of a cluster: the lane groups of a chunk
};

// a warp's stage, in positions
constexpr int kPieceStage = 640;
// consecutive pieces a warp takes a round: one unit of the walk
constexpr int kPiecesPerWarp = 2;

// The unit of pieces q, q + 1 (`pieces` of them, at most 2): item 32h + j
// is slot j's segment clipped to piece q + h (tiles.cuh piece_item), its
// part as the tag; the first item of a piece begins where the piece does.
__device__ __forceinline__ int piece_unit(const TileIndex& ix, int q, int pieces, int piece_len,
                                          Item (&u)[2]) {
#pragma unroll
  for (int h = 0; h < kPiecesPerWarp; ++h) {
    if (h < pieces) {
      const PieceLane pl = piece_item(ix, q + h, static_cast<int>(threadIdx.x & 31), piece_len);
      u[h] = Item{pl.lo, pl.hi, pl.part};
    } else {
      u[h] = Item{0, 0, 0};
    }
  }
  return 32 * pieces;
}

// part[the segment's part, g0 .. g0 + 3] = acc, one 16-byte store, where
// the segment meets the piece
struct PartsEmit {
  float* part;
  int lanes;
  int g0;
  int gn;
  __device__ __forceinline__ void operator()(int, const Item& it,
                                             const float (&acc)[kGroupLanes]) const {
    if (it.lo >= it.hi) return;
    *reinterpret_cast<float4*>(part + static_cast<long long>(it.tag) * lanes + g0) =
        make_float4(acc[0], acc[1], acc[2], acc[3]);
  }
};

// Block x of the grid: cluster unit x / cluster, which is tile
// unit / per_tile and its share unit % per_tile, and lane group x % cluster
// of chunk y.
__global__ void __launch_bounds__(kLaneThreads, 1)
scatter_lanes_kernel(const __grid_constant__ ScatterLaneParams p) {
  extern __shared__ float4 smem4[];
  const int warp = threadIdx.x >> 5;
  const int rank = static_cast<int>(blockIdx.x) % p.cluster;
  const int unit = static_cast<int>(blockIdx.x) / p.cluster;
  const int t = unit / p.per_tile;
  const int share = unit % p.per_tile;
  const int g0 = (static_cast<int>(blockIdx.y) * p.cluster + rank) * kGroupLanes;
  const int gn = max(0, min(kGroupLanes, p.n_lanes - g0));
  float4* tile = smem4 + Stage<kPieceStage>::kBytes / sizeof(float4);
  const int row0 = t * p.tile_rows;
  const TileIndex& ix = p.ix;
  stage_group(p.per_row + g0 * static_cast<long long>(p.n_rows) + row0, p.n_rows, gn,
              min(p.tile_rows, p.n_rows - row0), tile);
  __syncthreads();
  LaneWalk<kGroupLanes, Stage<kPieceStage>, GroupTable> walk{
      p.rows, p.vals, p.square != 0, Stage<kPieceStage>(smem4, p.rows, p.vals),
      GroupTable{tile, row0}};
  const PartsEmit emit{p.part, p.lanes, g0, gn};
  constexpr int kRound = kLaneWarps * kPiecesPerWarp;
  const int stride = p.per_tile * kRound;
  const int p_end = __ldg(ix.piece_ptr + __ldg(ix.tile_group + t + 1));
  const int q_first = __ldg(ix.piece_ptr + __ldg(ix.tile_group + t)) + share * kRound +
                      warp * kPiecesPerWarp;
  auto pieces_at = [&](int q) { return max(0, min(kPiecesPerWarp, p_end - q)); };
  Lockstep step{p.cluster > 1};
  Item u[2], nu[2];
  int n = piece_unit(ix, q_first, pieces_at(q_first), p.piece_len, u);
  // a round: warp w takes pieces q0 + w * kPiecesPerWarp, ...; uniform
  // across the cluster, whose blocks share (t, share)
  for (int q = q_first; q - warp * kPiecesPerWarp < p_end; q += stride) {
    // the next unit's bounds, loaded while this unit is summed
    const int nn = piece_unit(ix, q + stride, pieces_at(q + stride), p.piece_len, nu);
    if (n > 0 && gn > 0) walk.unit(u, n, emit);
    step.round_done();
    u[0] = nu[0];
    u[1] = nu[1];
    n = nn;
  }
  step.finish();
}

// out[g, f] = the sum of f's parts of lane g, in sum_parts's order
// (tiles.cuh): thread (f, quad, sub) takes parts sub, sub + width, ... of
// feature f for lanes 4 quad .. 4 quad + 3, and the width subs' sums meet in
// the same fixed shuffle tree.
__global__ void __launch_bounds__(kFinishThreads)
finish_lanes_kernel(const int* __restrict__ feat_ptr, const float* __restrict__ part,
                    float* __restrict__ out, int n_features, int width, int lanes,
                    int n_lanes) {
  const long long thread = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const int sub = static_cast<int>(thread % width);
  const int quads = lanes / kGroupLanes;
  const long long fq = thread / width;
  const int quad = static_cast<int>(fq % quads);
  const long long f = fq / quads;
  float s[kGroupLanes] = {0.0f, 0.0f, 0.0f, 0.0f};
  if (f < n_features) {
    const int end = __ldg(feat_ptr + f + 1);
    for (int k = __ldg(feat_ptr + f) + sub; k < end; k += width) {
      const float4 x = __ldg(reinterpret_cast<const float4*>(
          part + static_cast<long long>(k) * lanes + kGroupLanes * quad));
      s[0] += x.x;
      s[1] += x.y;
      s[2] += x.z;
      s[3] += x.w;
    }
  }
  for (int o = width / 2; o > 0; o >>= 1) {
#pragma unroll
    for (int k = 0; k < kGroupLanes; ++k) s[k] += __shfl_xor_sync(kFullMask, s[k], o);
  }
  if (f < n_features && sub == 0) {
#pragma unroll
    for (int k = 0; k < kGroupLanes; ++k) {
      const int g = kGroupLanes * quad + k;
      if (g < n_lanes) out[static_cast<long long>(g) * n_features + f] = s[k];
    }
  }
}

cudaError_t launch_scatter(ScatterLaneParams p, const LaneSplit& split, int n_tiles,
                           int n_pieces, cudaStream_t stream) {
  const size_t smem =
      Stage<kPieceStage>::kBytes + static_cast<size_t>(p.tile_rows) * sizeof(float4);
  auto kernel = scatter_lanes_kernel;
  int resident = 0;
  cudaError_t err = resident_blocks(reinterpret_cast<const void*>(kernel), kLaneThreads, smem,
                                    &resident, split.cluster);
  if (err != cudaSuccess) return err;
  // clusters per tile and chunk: one wave in all, and at least two rounds
  // of pieces each
  long long per_tile =
      resident / split.cluster / (static_cast<long long>(n_tiles) * split.chunks);
  const long long round = kLaneWarps * kPiecesPerWarp;
  const long long useful = (n_pieces / n_tiles + 2 * round) / (2 * round);
  if (per_tile > useful) per_tile = useful;
  if (per_tile < 1) per_tile = 1;
  const long long blocks = static_cast<long long>(n_tiles) * per_tile * split.cluster;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  p.per_tile = static_cast<int>(per_tile);
  err = launch_clustered(kernel,
                         dim3(static_cast<unsigned>(blocks), static_cast<unsigned>(split.chunks)),
                         split.cluster, smem, stream, p);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace
}  // namespace photon

// per_row: [n_lanes, n_rows]; out: [n_lanes, n_features]; part: scratch of
// n_parts * (n_lanes rounded up to a multiple of 4) floats; the mirror in the
// index's slot order; the other arguments are photon_csc_scatter's.
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
  // a group's per_row tile beside the warps' stages: up to 9,248 rows (the
  // batches' tiles have 8192)
  if (Stage<kPieceStage>::kBytes + static_cast<size_t>(tile_rows) * sizeof(float4) >
      kLaneSmemLimitBytes) {
    return cudaErrorInvalidValue;
  }
  const LaneSplit split = lane_split(n_lanes);
  const int lanes = (n_lanes + kGroupLanes - 1) / kGroupLanes * kGroupLanes;
  cudaError_t err;
  if (n_pieces > 0 && n_tiles > 0) {
    ScatterLaneParams p{};
    p.ix = ix;
    p.rows = rows;
    p.vals = vals;
    p.per_row = per_row;
    p.part = part;
    p.lanes = lanes;
    p.n_rows = n_rows;
    p.tile_rows = tile_rows;
    p.piece_len = piece_len;
    p.square = square;
    p.n_lanes = n_lanes;
    p.cluster = split.cluster;
    if ((err = launch_scatter(p, split, n_tiles, n_pieces, s)) != cudaSuccess) return err;
  }
  const long long threads =
      static_cast<long long>(n_features) * (lanes / kGroupLanes) * finish_width;
  finish_lanes_kernel<<<static_cast<unsigned>((threads + kFinishThreads - 1) / kFinishThreads),
                        kFinishThreads, 0, s>>>(ix.feat_ptr, part, out, n_features,
                                                finish_width, lanes, n_lanes);
  return cudaGetLastError();
}
