// Per-row margins of one CSR matrix against G coefficient vectors on Hopper
// (sm_90a), one launch:
//   Z[g, i] = sum_{k in row i} vals_k * W[g, cols_k] + shift[g] (+ offsets)
//
// Replaces the TPU kernel `_margins_kernel` with pair=False
// (photon_ml_tpu/ops/tiled.py:170, built by `_margins_call` at :339) under
// `jax.vmap` over the lanes of a sweep or a bootstrap
// (photon_ml_tpu/sweep/runner.py:91-116): Pallas's batching rule adds a grid
// axis and runs the kernel once per lane. Here the lanes are a written-out
// axis, and X is read once per chunk of lanes rather than once per lane.
//
// Bound: bytes. Per call it must read row_ptr, cols and vals (8 bytes per
// nonzero) once, W (4 G bytes per feature), the offsets when used, and write
// G floats per row.
//
// Design: the row pass of rowpass.cuh (a warp per 32 consecutive rows, the
// warp's nonzeros swept in chunks of kChunk positions with 16-byte loads,
// one thread summing each row in nonzero order, rows over kLongSegment
// nonzeros summed by the whole warp), with the chunk's cols and vals held in
// registers while each lane of the chunk of lanes writes its products to the
// warp's shared-memory chunk and sums them. The chunk boundaries, the order
// of each row's sum and the epilogue are the single-vector kernel's
// (margins.cu), so every lane is bit for bit what margins.cu gives for that
// lane's vector, whatever the number of lanes. No float atomics.
//
// Lanes are cut into chunks of at most kMaxLanes, as many as have their
// tables fit in shared memory beside the product chunks (kRowSmemLimitBytes;
// five 40 KB tables at 10K features), chunk j on blockIdx.y. Blocks of the
// chunks with the same blockIdx.x walk the same row tiles at about the same
// time, so X is read from HBM about once and from L2 by the other chunks.
// Where not one table fits (a block-diagonal batch's millions of columns),
// W is gathered through the read-only cache and L2, kMaxLanes lanes a chunk.

#include "rowpass.cuh"

namespace photon {
namespace {

// lanes of one chunk: each thread holds one running sum per lane
constexpr int kMaxLanes = 8;

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
  int lanes_per_chunk;
};

template <bool kStaged>
__device__ __forceinline__ float table_at(const float* t, int c) {
  if constexpr (kStaged) {
    return t[c];
  } else {
    return __ldg(t + c);
  }
}

// segment_sums (segments.cuh) for `gn` tables at once: the chunk's cols and
// vals are loaded as GatherFill loads them, once, and each lane's products
// are written to `chunk` and summed in turn, in segment_sums's order.
template <bool kStaged>
__device__ __forceinline__ void lane_segment_sums(int lo, int hi, float* chunk,
                                                  const int* __restrict__ idx,
                                                  const float* __restrict__ vals, bool vec,
                                                  const float* tables, int n_features, int gn,
                                                  float (&acc)[kMaxLanes]) {
  constexpr int kQuads = kChunk / 128;
  const int lane = threadIdx.x & 31;
  const int span_lo = __shfl_sync(kFullMask, lo, 0);
  const int span_hi = __shfl_sync(kFullMask, hi, 31);
  const bool is_long = hi - lo > kLongSegment;
  for (int c0 = span_lo & ~3; c0 < span_hi; c0 += kChunk) {
    int c[kQuads][4];
    float v[kQuads][4];
#pragma unroll
    for (int i = 0; i < kQuads; ++i) {
      const int q = c0 + 4 * (lane + 32 * i);
      if (vec && q >= span_lo && q + 4 <= span_hi) {
        const int4 ci = __ldg(reinterpret_cast<const int4*>(idx + q));
        const float4 vi = __ldg(reinterpret_cast<const float4*>(vals + q));
        c[i][0] = ci.x, c[i][1] = ci.y, c[i][2] = ci.z, c[i][3] = ci.w;
        v[i][0] = vi.x, v[i][1] = vi.y, v[i][2] = vi.z, v[i][3] = vi.w;
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const bool in = q + j >= span_lo && q + j < span_hi;
          c[i][j] = in ? __ldg(idx + q + j) : 0;
          v[i][j] = in ? __ldg(vals + q + j) : 0.0f;
        }
      }
    }
    const unsigned long_lanes = __ballot_sync(kFullMask, is_long && lo < c0 + kChunk && hi > c0);
#pragma unroll
    for (int g = 0; g < kMaxLanes; ++g) {
      if (g >= gn) break;  // uniform across the block
      const float* t = tables + static_cast<size_t>(g) * n_features;
#pragma unroll
      for (int i = 0; i < kQuads; ++i) {
        float4 p;
        p.x = v[i][0] * table_at<kStaged>(t, c[i][0]);
        p.y = v[i][1] * table_at<kStaged>(t, c[i][1]);
        p.z = v[i][2] * table_at<kStaged>(t, c[i][2]);
        p.w = v[i][3] * table_at<kStaged>(t, c[i][3]);
        reinterpret_cast<float4*>(chunk)[lane + 32 * i] = p;
      }
      __syncwarp();
      if (!is_long) {
        const int a = max(lo, c0) - c0;
        const int b = min(hi, c0 + kChunk) - c0;
        for (int q = a; q < b; ++q) acc[g] += chunk[q];
      }
      for (unsigned m = long_lanes; m != 0; m &= m - 1) {
        const int src = __ffs(m) - 1;
        const int a = max(__shfl_sync(kFullMask, lo, src), c0) - c0;
        const int b = min(__shfl_sync(kFullMask, hi, src), c0 + kChunk) - c0;
        float s[1] = {0.0f};
        for (int q = a + lane; q < b; q += 32) s[0] += chunk[q];
        warp_tree<1>(s);
        if (lane == src) acc[g] += s[0];
      }
      __syncwarp();
    }
  }
}

template <bool kStaged>
__global__ void __launch_bounds__(kRowThreads, 2) margins_lanes_kernel(const LaneParams p) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g0 = blockIdx.y * p.lanes_per_chunk;
  const int gn = min(p.lanes_per_chunk, p.n_lanes - g0);
  float* chunk = smem + warp * kChunk;
  const float* tables = p.w + static_cast<size_t>(g0) * p.n_features;
  if constexpr (kStaged) {
    float* staged = smem + kRowWarps * kChunk;
    const int count = gn * p.n_features;
    for (int i = threadIdx.x; i < count; i += blockDim.x) staged[i] = __ldg(tables + i);
    __syncthreads();
    tables = staged;
  }
  const bool vec = aligned16(p.cols, p.vals);
  float shift[kMaxLanes];
#pragma unroll
  for (int g = 0; g < kMaxLanes; ++g) {
    shift[g] = g < gn ? p.shift_host + (p.shift_dev != nullptr ? __ldg(p.shift_dev + g0 + g)
                                                               : 0.0f)
                      : 0.0f;
  }
  const int n_tiles = (p.n_rows + 31) / 32;
  for (int tile = blockIdx.x * kRowWarps + warp; tile < n_tiles;
       tile += gridDim.x * kRowWarps) {
    const int row = tile * 32 + lane;
    const int lo = __ldg(p.row_ptr + min(row, p.n_rows));
    const int hi = __ldg(p.row_ptr + min(row + 1, p.n_rows));
    float acc[kMaxLanes];
#pragma unroll
    for (int g = 0; g < kMaxLanes; ++g) acc[g] = 0.0f;
    lane_segment_sums<kStaged>(lo, hi, chunk, p.cols, p.vals, vec, tables, p.n_features, gn,
                               acc);
    if (row < p.n_rows) {
#pragma unroll
      for (int g = 0; g < kMaxLanes; ++g) {
        if (g >= gn) break;
        const long long lane_g = g0 + g;
        float a = acc[g] + shift[g];
        if (p.offsets != nullptr) a = a + __ldg(p.offsets + lane_g * p.offsets_stride + row);
        p.out[lane_g * p.n_rows + row] = a;
      }
    }
  }
}

template <bool kStaged>
cudaError_t launch_lanes(const LaneParams& p, size_t smem, int n_chunks, cudaStream_t stream) {
  auto kernel = margins_lanes_kernel<kStaged>;
  int resident = 0;
  cudaError_t err =
      resident_blocks(reinterpret_cast<const void*>(kernel), kRowThreads, smem, &resident);
  if (err != cudaSuccess) return err;
  const long long needed =
      ((static_cast<long long>(p.n_rows) + 31) / 32 + kRowWarps - 1) / kRowWarps;
  long long grid = resident / n_chunks;
  if (grid < 1) grid = 1;
  if (needed < grid) grid = needed;
  kernel<<<dim3(static_cast<unsigned>(grid), static_cast<unsigned>(n_chunks)), kRowThreads,
           smem, stream>>>(p);
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
  const size_t chunks = static_cast<size_t>(kRowWarps) * kChunk * sizeof(float);
  const size_t table = static_cast<size_t>(n_features) * sizeof(float);
  const long long fit = table == 0 ? kMaxLanes
                                   : static_cast<long long>((kRowSmemLimitBytes - chunks) / table);
  const bool staged = fit >= 1;
  const int cap = staged ? static_cast<int>(fit < kMaxLanes ? fit : kMaxLanes) : kMaxLanes;
  // balanced chunks: as few as the cap allows, the lanes spread evenly
  const int n_chunks = (n_lanes + cap - 1) / cap;
  p.lanes_per_chunk = (n_lanes + n_chunks - 1) / n_chunks;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (staged) {
    return launch_lanes<true>(p, chunks + p.lanes_per_chunk * table, n_chunks, s);
  }
  return launch_lanes<false>(p, chunks, n_chunks, s);
}
