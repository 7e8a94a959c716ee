// The lane walk shared by the lane kernels (margins_lanes.cu,
// scatter_lanes.cu) on Hopper (sm_90a): sums of products over segments for
// L lanes at once, each segment's L running sums in registers of the one
// thread that owns it, bit for bit segments.cuh's segment_sums.
//
// A warp walks a run of items (rows, or a work piece's feature segments),
// each a range [lo, hi) of positions, consecutive items adjacent. Sums are
// taken in segment_sums's order:
//   - an item of at most kLongSegment positions is summed by its owner in
//     position order, per lane acc = __fadd_rn(acc, __fmul_rn(x, t)): the
//     product rounded to float before the add, exactly as the single
//     kernels store it to their product chunk and add it back (no FMA
//     contraction);
//   - a longer item is summed by the whole warp per kChunk chunk of the grid
//     the single kernel's warp span gives it (`grid`, its span_lo & ~3):
//     lane j takes the chunk's positions a + j, a + j + 32, ..., then
//     warp_tree, and the chunk's sum is added to the item's.
// The short items go in windows: up to 32 consecutive short items whose
// positions fit a stage of S positions, one item a thread. The window's
// indices and values come into the warp's stage in shared memory once;
// then each owner walks its item: two stage reads and one gather of the L
// lanes' table values a position. A window ends before a long item, which
// the warp sums alone, reading its positions straight from global memory
// (coalesced). So no owner waits on positions of other items, and no
// product goes through shared memory. A warp takes its items a unit of 64
// at a time, their bounds in registers (two a lane), loaded a unit ahead.
//
// The lanes of a launch come in chunks of at most kChunkLanes (16), so X is
// read once per 16 lanes. A block holds kGroupLanes (4) lanes' tables
// lane-minor, one float4 per index; the blocks of a chunk's lane groups form
// one thread-block cluster whose blocks walk the same items in lockstep (a
// split cluster barrier after every round of the block's warps). So the
// cluster's blocks read each stretch of X within a round of each other
// (about 160 KB of X a round at config #1's rows, about 11 MB over the
// card's 33 clusters, well inside the 50 MB L2): X comes from HBM once a
// call, and from L2 to each block of the cluster. (A TMA multicast of each window to
// the cluster's blocks, which would cross L2 once, measured slower: without
// room for a second stage beside the tables, every window waited for all
// the blocks to release the last; PERF.md section 6.)

#pragma once

#include <cuda_runtime.h>

#include "segments.cuh"

namespace photon {
namespace {

constexpr int kLaneThreads = 512;
constexpr int kLaneWarps = kLaneThreads / 32;
// lanes a block holds in shared memory: one float4 per table entry
constexpr int kGroupLanes = 4;
// lanes a chunk reads X once for: at most four groups, one cluster
constexpr int kChunkLanes = 16;
constexpr int kMaxCluster = kChunkLanes / kGroupLanes;
// the most dynamic shared memory a block may take (227 KB on the card)
constexpr size_t kLaneSmemLimitBytes = 227 * 1024;

__device__ __forceinline__ int padded(int q) { return q + (q >> 5); }

// The table of kGroupLanes lanes in shared memory, one float4 per entry;
// entry 0 is index `base`.
struct GroupTable {
  const float4* t;
  int base;
  __device__ __forceinline__ void operator()(int c, float (&out)[kGroupLanes]) const {
    const float4 x = t[c - base];
    out[0] = x.x, out[1] = x.y, out[2] = x.z, out[3] = x.w;
  }
};

// Stage `count` entries of a group's kGroupLanes rows of a [G, stride]
// array (lanes past gn read as 0) lane-minor, one float4 an entry; four
// entries' loads a thread in flight at a time.
__device__ __forceinline__ void stage_group(const float* __restrict__ src, long long stride,
                                            int gn, int count, float4* __restrict__ dst) {
  constexpr int kUnroll = 4;
  for (int i0 = threadIdx.x; i0 < count; i0 += kUnroll * blockDim.x) {
    float x[kUnroll][kGroupLanes];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int i = i0 + u * blockDim.x;
#pragma unroll
      for (int k = 0; k < kGroupLanes; ++k) {
        x[u][k] = i < count && k < gn ? __ldg(src + k * stride + i) : 0.0f;
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int i = i0 + u * blockDim.x;
      if (i < count) dst[i] = make_float4(x[u][0], x[u][1], x[u][2], x[u][3]);
    }
  }
}

// How G lanes split: chunks of at most kChunkLanes, balanced; the lane
// groups of a chunk, one block each, form a cluster.
struct LaneSplit {
  int chunks;
  int cluster;  // blocks (lane groups) of a chunk
};

inline LaneSplit lane_split(int n_lanes) {
  const int groups = (n_lanes + kGroupLanes - 1) / kGroupLanes;
  const int chunks = (groups + kMaxCluster - 1) / kMaxCluster;
  return LaneSplit{chunks, (groups + chunks - 1) / chunks};
}

// The split cluster barrier: arrive after a round, wait before the next
// arrive, so no block of a cluster runs more than a round ahead.
struct Lockstep {
  bool on;
  bool pending = false;
  __device__ __forceinline__ void round_done() {
    if (!on) return;
    if (pending) asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
    asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
    pending = true;
  }
  __device__ __forceinline__ void finish() {
    if (pending) asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
  }
};

// ---- the windows --------------------------------------------------------

// An item of a unit: positions [lo, hi), and a tag the emit reads (a
// segment's part; unused for rows).
struct Item {
  int lo;
  int hi;
  int tag;
};

// The items of a unit, j in [0, 64): lane t holds items t (u[0]) and 32 + t
// (u[1]). Item j, fetched by every lane for its own j.
__device__ __forceinline__ Item item_at(const Item (&u)[2], int j) {
  const int src = j & 31;
  const int lo0 = __shfl_sync(kFullMask, u[0].lo, src);
  const int lo1 = __shfl_sync(kFullMask, u[1].lo, src);
  const int hi0 = __shfl_sync(kFullMask, u[0].hi, src);
  const int hi1 = __shfl_sync(kFullMask, u[1].hi, src);
  const int tag0 = __shfl_sync(kFullMask, u[0].tag, src);
  const int tag1 = __shfl_sync(kFullMask, u[1].tag, src);
  return j < 32 ? Item{lo0, hi0, tag0} : Item{lo1, hi1, tag1};
}

// A window of a unit from item w0: the calling lane's item w0 + lane; k
// items short enough to fit positions [base, end) in the stage, or k == 0
// where item w0 is long (a short one always fits).
struct Window {
  Item it;
  int k;
  int base;
  int end;
};

template <int S>
__device__ __forceinline__ Window window_at(const Item (&u)[2], int n, int w0) {
  const int j = w0 + static_cast<int>(threadIdx.x & 31);
  Window w;
  w.it = item_at(u, min(j, n - 1));
  w.base = __shfl_sync(kFullMask, w.it.lo, 0) & ~3;
  const unsigned fit = __ballot_sync(
      kFullMask, j < n && w.it.hi - w.it.lo <= kLongSegment && w.it.hi - w.base <= S);
  w.k = fit == kFullMask ? 32 : __ffs(~fit) - 1;
  w.end = __shfl_sync(kFullMask, w.it.hi, max(w.k - 1, 0));
  return w;
}

// A warp's stage of S positions (a multiple of 128) in shared memory: the
// window's indices as Idx (int, or unsigned short where every index is
// below 65536, which leaves room for a longer stage), then its values, each
// padded one entry in 32 so that owners walking runs of equal length do
// not meet in a bank. fill(idx, vals, base, end) loads positions [base,
// end) (end - base <= S, base a multiple of 4) with 16-byte loads of whole
// quads where the arrays are aligned. Uniform across the warp.
template <int S, class Idx = int>
struct Stage {
  static constexpr int kStage = S;
  static constexpr int kWords = S + S / 32;
  static constexpr size_t kIdxBytes = (kWords * sizeof(Idx) + 15) / 16 * 16;
  static constexpr size_t kWarpBytes = kIdxBytes + (kWords * sizeof(float) + 15) / 16 * 16;
  // the stages of a block's warps
  static constexpr size_t kBytes = static_cast<size_t>(kLaneWarps) * kWarpBytes;
  Idx* sidx;
  float* sval;
  bool vec;

  __device__ __forceinline__ Stage(void* smem, const int* idx, const float* vals) {
    char* mine = reinterpret_cast<char*>(smem) + (threadIdx.x >> 5) * kWarpBytes;
    sidx = reinterpret_cast<Idx*>(mine);
    sval = reinterpret_cast<float*>(mine + kIdxBytes);
    vec = aligned16(idx, vals);
  }

  __device__ __forceinline__ void fill(const int* __restrict__ idx,
                                       const float* __restrict__ vals, int base, int end) const {
    constexpr int kQuads = S / 128;
    const int lane = threadIdx.x & 31;
    int c[kQuads][4];
    float v[kQuads][4];
#pragma unroll
    for (int i = 0; i < kQuads; ++i) {
      const int q = base + 4 * (lane + 32 * i);
      if (vec && q + 4 <= end) {
        const int4 ci = __ldg(reinterpret_cast<const int4*>(idx + q));
        const float4 vi = __ldg(reinterpret_cast<const float4*>(vals + q));
        c[i][0] = ci.x, c[i][1] = ci.y, c[i][2] = ci.z, c[i][3] = ci.w;
        v[i][0] = vi.x, v[i][1] = vi.y, v[i][2] = vi.z, v[i][3] = vi.w;
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const bool in = q + j < end;
          c[i][j] = in ? __ldg(idx + q + j) : 0;
          v[i][j] = in ? __ldg(vals + q + j) : 0.0f;
        }
      }
    }
#pragma unroll
    for (int i = 0; i < kQuads; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int at = padded(4 * (lane + 32 * i) + j);
        sidx[at] = static_cast<Idx>(c[i][j]);
        sval[at] = v[i][j];
      }
    }
  }
};

// ---- the walk -----------------------------------------------------------

// A long item [lo, hi) summed by the whole warp, chunk by chunk of the grid
// at `grid`, into acc (every lane ends with the same sums).
template <int L, class Gather>
__device__ __forceinline__ void long_item_sums(int lo, int hi, int grid,
                                               const int* __restrict__ idx,
                                               const float* __restrict__ vals, bool square,
                                               const Gather& gather, float (&acc)[L]) {
  const int lane = threadIdx.x & 31;
  for (int c0 = grid + ((lo - grid) & ~(kChunk - 1)); c0 < hi; c0 += kChunk) {
    const int a = max(lo, c0);
    const int b = min(hi, c0 + kChunk);
    float part[L];
#pragma unroll
    for (int k = 0; k < L; ++k) part[k] = 0.0f;
    for (int q = a + lane; q < b; q += 32) {
      float x = __ldg(vals + q);
      if (square) x = __fmul_rn(x, x);
      float t[L];
      gather(__ldg(idx + q), t);
#pragma unroll
      for (int k = 0; k < L; ++k) part[k] = __fadd_rn(part[k], __fmul_rn(x, t[k]));
    }
    warp_tree<L>(part);
#pragma unroll
    for (int k = 0; k < L; ++k) acc[k] = __fadd_rn(acc[k], part[k]);
  }
}

// The walk of a warp over units of items, each summed for the L lanes
// `gather` returns (values squared first with `square`, rounded as the
// single kernels round v * v); emit(j, item, acc) is called once per item j
// of the unit by the thread that holds its sums. A long item's chunk grid
// is its 32-item block's first position & ~3 (rows: the single kernel's
// 32-row tile; segments: the piece). Uniform across the warp.
template <int L, class StageT, class Gather>
struct LaneWalk {
  const int* idx;
  const float* vals;
  bool square;
  StageT stage;
  Gather gather;

  template <class Emit>
  __device__ __forceinline__ void unit(const Item (&u)[2], int n, const Emit& emit) {
    const int lane = threadIdx.x & 31;
    for (int w0 = 0; w0 < n;) {
      const Window cur = window_at<StageT::kStage>(u, n, w0);
      float acc[L];
#pragma unroll
      for (int k = 0; k < L; ++k) acc[k] = 0.0f;
      if (cur.k == 0) {
        const int grid0 = __shfl_sync(kFullMask, u[0].lo, 0);
        const int grid1 = __shfl_sync(kFullMask, u[1].lo, 0);
        long_item_sums<L>(__shfl_sync(kFullMask, cur.it.lo, 0),
                          __shfl_sync(kFullMask, cur.it.hi, 0),
                          (w0 < 32 ? grid0 : grid1) & ~3, idx, vals, square, gather, acc);
        if (lane == 0) emit(w0, cur.it, acc);
        w0 += 1;
        continue;
      }
      stage.fill(idx, vals, cur.base, cur.end);
      __syncwarp();
      if (lane < cur.k) {
        const int b = cur.it.hi - cur.base;
#pragma unroll 4
        for (int q = cur.it.lo - cur.base; q < b; ++q) {
          const int at = padded(q);
          float t[L];
          gather(stage.sidx[at], t);
          float x = stage.sval[at];
          if (square) x = __fmul_rn(x, x);
#pragma unroll
          for (int k = 0; k < L; ++k) acc[k] = __fadd_rn(acc[k], __fmul_rn(x, t[k]));
        }
        emit(w0 + lane, cur.it, acc);
      }
      __syncwarp();
      w0 += cur.k;
    }
  }
};

// Launch `kernel` in clusters of `cluster` blocks along x (no cluster at 1).
template <class... Args>
cudaError_t launch_clustered(void (*kernel)(Args...), dim3 grid, int cluster, size_t smem,
                             cudaStream_t stream, Args... args) {
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(kLaneThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = cluster > 1 ? 1 : 0;
  return cudaLaunchKernelEx(&cfg, kernel, args...);
}

}  // namespace
}  // namespace photon
