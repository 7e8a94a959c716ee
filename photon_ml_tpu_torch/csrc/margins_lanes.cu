// Per-row margins of one CSR matrix against G coefficient vectors on Hopper
// (sm_90a), one launch:
//   Z[g, i] = sum_{k in row i} vals_k * W[g, cols_k] + shift[g] (+ offsets)
//
// Replaces the TPU kernel `_margins_kernel` with pair=False
// (photon_ml_tpu/ops/tiled.py:170, built by `_margins_call` at :339) under
// `jax.vmap` over the lanes of a sweep or a bootstrap
// (photon_ml_tpu/sweep/runner.py:91-116, diagnostics/bootstrap.py:92-104):
// Pallas's batching rule adds a grid axis and runs the kernel once per lane.
//
// Bound: bytes. Per call it must read row_ptr, cols and vals (8 bytes per
// nonzero) once, W (4 G bytes per feature), the offsets when used, and write
// G floats per row: 228.6 MB at config #1 (1M rows x 10K features x 20
// nonzeros) with G = 16. This design's HBM floor is the bound: X is read from
// HBM once a call for G <= 16 (once per 16 lanes above), W once, Z written
// once. What it pays besides, on chip: X from L2 once per lane group of 4,
// W from L2 once per resident cluster, and per nonzero and lane group two
// stage reads and one float4 gather in shared memory, where the gathers of
// random features meet in banks.
//
// Design (lanes.cuh): lanes go in chunks of at most 16, a chunk's lanes in
// groups of 4, one block a group and the chunk's groups one cluster. Where a
// group's table fits beside the warps' stages (kStagedMaxFeatures, 10,560),
// each block stages its group's four rows of W lane-minor, one float4 per
// feature. The cluster's blocks walk the same rows in lockstep: each warp
// takes kRowsPerWarp consecutive rows a round, loads windows of up to 32
// whole rows into its stage (640 positions, the indices 16-bit) with
// 16-byte loads, and the thread that owns a row sums it in nonzero order in
// four registers, one gather per nonzero; rows over kLongSegment nonzeros
// are summed by the whole warp per kChunk chunk of their 32-row tile's
// grid, segments.cuh's tree. So every lane is bit for bit what margins.cu
// gives for its vector: the same products rounded to float, the same order,
// the same chunks for long rows, the same epilogue (acc + shift, then +
// offset). No float atomics, no product chunk.
//
// The regime is chosen by shape: past kStagedMaxFeatures (a block-diagonal
// batch's millions of columns, ops/shared_design.py BlockDiagonalLanes) no
// group's table fits, and W is gathered lane by lane through L1 and L2, the
// same walk otherwise; a row of such a batch touches one entity's K columns,
// and a block's four lanes of them stay in its L1.

#include "lanes.cuh"

namespace photon {
namespace {

struct LaneParams {
  const int* row_ptr;
  const int* cols;
  const float* vals;
  const float* w;          // [G, n_features]
  const float* shift_dev;  // [G] device shifts, or null
  float shift_host;        // added to every lane's shift
  const float* offsets;    // [G, n_rows] or [n_rows] (offsets_stride 0), or null
  long long offsets_stride;
  float* out;  // [G, n_rows]
  int n_rows;
  int n_features;
  int n_lanes;
  int cluster;  // blocks of a cluster: the lane groups of a chunk
};

// W [G, F] of a group's lanes read lane-major through L1 and L2
struct GlobalTable {
  const float* w;
  long long stride;
  int gn;
  __device__ __forceinline__ void operator()(int c, float (&out)[kGroupLanes]) const {
#pragma unroll
    for (int k = 0; k < kGroupLanes; ++k) out[k] = k < gn ? __ldg(w + k * stride + c) : 0.0f;
  }
};

// a warp's stage: 640 positions with 16-bit indices beside a group's
// table (a window takes the 32 rows of a tile at 20 nonzeros a row), 512
// with 32-bit ones where W is gathered from L2
using StagedRows = Stage<640, unsigned short>;
using WideRows = Stage<512>;
// consecutive rows a warp takes a round: one unit of the walk
constexpr int kRowsPerWarp = 64;
constexpr int kStagedMaxFeatures =
    static_cast<int>((kLaneSmemLimitBytes - StagedRows::kBytes) / sizeof(float4));

// The unit of rows [first, first + n), n <= kRowsPerWarp (0 past the end):
// lane t holds rows first + t and first + 32 + t.
__device__ __forceinline__ int row_unit(const int* row_ptr, long long first, int n_rows,
                                        Item (&u)[2]) {
  const int n = first < n_rows ? static_cast<int>(min(static_cast<long long>(kRowsPerWarp),
                                                      n_rows - first))
                               : 0;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int i = min(h * 32 + static_cast<int>(threadIdx.x & 31), n - 1);
    u[h] = i >= 0 ? Item{__ldg(row_ptr + first + i), __ldg(row_ptr + first + i + 1), 0}
                  : Item{0, 0, 0};
  }
  return n;
}

// Z[g0 + k, first + j] = acc[k] + shift (+ offset), margins.cu's epilogue
struct MarginsEmit {
  const LaneParams* p;
  int g0;
  int gn;
  long long first;
  __device__ __forceinline__ void operator()(int j, const Item&,
                                             const float (&acc)[kGroupLanes]) const {
    const long long row = first + j;
#pragma unroll
    for (int k = 0; k < kGroupLanes; ++k) {
      if (k >= gn) break;
      const long long g = g0 + k;
      const float shift =
          p->shift_host + (p->shift_dev != nullptr ? __ldg(p->shift_dev + g) : 0.0f);
      float a = acc[k] + shift;
      if (p->offsets != nullptr) a = a + __ldg(p->offsets + g * p->offsets_stride + row);
      p->out[g * p->n_rows + row] = a;
    }
  }
};

// The rows of the cluster's rounds r0, r0 + stride, ...: in round r warp w
// takes rows [(r * kLaneWarps + w) * kRowsPerWarp, ...); the loop is
// uniform across the cluster.
template <class StageT, class Gather>
__device__ __forceinline__ void margins_rows(const LaneParams& p, const Gather& gather, int g0,
                                             int gn) {
  extern __shared__ float4 smem4[];
  LaneWalk<kGroupLanes, StageT, Gather> walk{p.cols, p.vals, false,
                                             StageT(smem4, p.cols, p.vals), gather};
  const long long warp_first = static_cast<long long>(threadIdx.x >> 5) * kRowsPerWarp;
  constexpr long long kRound = static_cast<long long>(kLaneWarps) * kRowsPerWarp;
  const long long n_rounds = (p.n_rows + kRound - 1) / kRound;
  const long long stride = static_cast<int>(gridDim.x) / p.cluster;
  long long r = static_cast<int>(blockIdx.x) / p.cluster;
  Lockstep step{p.cluster > 1};
  Item u[2], nu[2];
  int n = row_unit(p.row_ptr, r * kRound + warp_first, p.n_rows, u);
  for (; r < n_rounds; r += stride) {
    // the next unit's bounds, loaded while this unit is summed
    const int nn = r + stride < n_rounds
                       ? row_unit(p.row_ptr, (r + stride) * kRound + warp_first, p.n_rows, nu)
                       : 0;
    if (n > 0 && gn > 0) walk.unit(u, n, MarginsEmit{&p, g0, gn, r * kRound + warp_first});
    step.round_done();
    u[0] = nu[0];
    u[1] = nu[1];
    n = nn;
  }
  step.finish();
}

// Block x of the grid: cluster x / cluster, lane group x % cluster of chunk
// y.
template <bool kStaged>
__global__ void __launch_bounds__(kLaneThreads, 1)
margins_lanes_kernel(const __grid_constant__ LaneParams p) {
  extern __shared__ float4 smem4[];
  const int rank = static_cast<int>(blockIdx.x) % p.cluster;
  const int g0 = (static_cast<int>(blockIdx.y) * p.cluster + rank) * kGroupLanes;
  const int gn = max(0, min(kGroupLanes, p.n_lanes - g0));
  const long long F = p.n_features;
  const float* w = p.w + g0 * F;
  if constexpr (kStaged) {
    float4* table = smem4 + StagedRows::kBytes / sizeof(float4);
    stage_group(w, F, gn, p.n_features, table);
    __syncthreads();
    margins_rows<StagedRows>(p, GroupTable{table, 0}, g0, gn);
  } else {
    margins_rows<WideRows>(p, GlobalTable{w, F, gn}, g0, gn);
  }
}

template <bool kStaged>
cudaError_t launch_margins(const LaneParams& p, const LaneSplit& split, cudaStream_t stream) {
  const size_t smem = kStaged ? StagedRows::kBytes + static_cast<size_t>(p.n_features) *
                                                        sizeof(float4)
                              : WideRows::kBytes;
  auto kernel = margins_lanes_kernel<kStaged>;  int resident = 0;
  cudaError_t err = resident_blocks(reinterpret_cast<const void*>(kernel), kLaneThreads, smem,
                                    &resident, split.cluster);
  if (err != cudaSuccess) return err;
  // clusters per chunk: one wave in all, and no more than the rounds of rows
  long long clusters = resident / split.cluster / split.chunks;
  const long long rounds = (static_cast<long long>(p.n_rows) + kLaneWarps * kRowsPerWarp - 1) /
                           (kLaneWarps * kRowsPerWarp);
  if (rounds < clusters) clusters = rounds;
  if (clusters < 1) clusters = 1;
  const dim3 grid(static_cast<unsigned>(clusters * split.cluster),
                  static_cast<unsigned>(split.chunks));
  err = launch_clustered(kernel, grid, split.cluster, smem, stream, p);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace
}  // namespace photon

// w: [n_lanes, n_features]; offsets: [n_lanes, n_rows] when offsets_per_lane,
// else [n_rows], or null; shift_dev: [n_lanes] or null; out: [n_lanes, n_rows].
extern "C" int photon_csr_margins_lanes(const int* row_ptr, const int* cols, const float* vals,
                                        const float* w, const float* offsets,
                                        int offsets_per_lane, const float* shift_dev,
                                        float shift_host, float* out, int n_rows,
                                        int n_features, int n_lanes, void* stream) {
  using namespace photon;
  if (n_rows <= 0 || n_lanes <= 0) return cudaSuccess;
  if (n_features < 0) return cudaErrorInvalidValue;
  LaneParams p{};
  p.row_ptr = row_ptr;
  p.cols = cols;
  p.vals = vals;
  p.w = w;
  p.shift_dev = shift_dev;
  p.shift_host = shift_host;
  p.offsets = offsets;
  p.offsets_stride = offsets_per_lane ? n_rows : 0;
  p.out = out;
  p.n_rows = n_rows;
  p.n_features = n_features;
  p.n_lanes = n_lanes;
  const LaneSplit split = lane_split(n_lanes);
  if (split.chunks > 65535) return cudaErrorInvalidValue;
  p.cluster = split.cluster;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return n_features <= kStagedMaxFeatures ? launch_margins<true>(p, split, s)
                                          : launch_margins<false>(p, split, s);
}
