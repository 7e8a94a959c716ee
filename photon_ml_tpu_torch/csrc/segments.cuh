// Warp-level segmented sums of products on Hopper (sm_90a), shared by the
// CSR row pass (rowpass.cuh), the CSC scatter (scatter.cu) and the tile-fused
// passes (tile_fused.cuh).
//
// A warp owns 32 segments, lane i the i-th. The segments are ranges of
// positions that follow one another in lane order and together cover the
// warp's span [lo_0, hi_31). The warp sweeps the span in chunks of kChunk
// positions: a fill functor loads the chunk's nonzeros with the whole warp
// (neighbouring lanes on neighbouring positions, several loads in flight per
// lane) and writes one product per position into a per-warp chunk of shared
// memory; then each lane adds its own segment's products in position order.
// A segment longer than kLongSegment is summed by the whole warp instead, a
// strided sum over the chunk and a fixed shuffle tree, so a hot row or column
// never leaves 31 lanes waiting on one. Running sums carry from chunk to
// chunk. Chunk boundaries depend only on the span, so every sum is taken in
// the same order from launch to launch: no atomics, bit-identical results.

#pragma once

#include <cuda_runtime.h>

#include <cstdint>
#include <mutex>

namespace photon {
namespace {

constexpr unsigned kFullMask = 0xffffffffu;
// products staged per warp and table; a multiple of 128 (32 lanes x 4)
constexpr int kChunk = 256;
// segments longer than this are summed by the whole warp
constexpr int kLongSegment = 128;
// threads of a finishing block (the fixed-order sums of parts and partials)
constexpr int kFinishThreads = 256;

// The resident blocks of `kernel` on the current device at `threads` a block
// and `smem` bytes of dynamic shared memory (blocks per SM times the SMs; for
// a launch in clusters of `cluster` blocks, the resident clusters times
// `cluster`), with the kernel's dynamic shared-memory limit raised to smem
// first where it is lower (by default static and dynamic shared memory share
// 48 KB; the limit belongs to the kernel, so it is never lowered, or a size
// cached before would no longer launch). Cached per kernel, device, smem and
// cluster, so a launch makes these queries once.
inline cudaError_t resident_blocks(const void* kernel, int threads, size_t smem, int* blocks,
                                   int cluster = 1) {
  struct Entry {
    const void* kernel;
    int device;
    size_t smem;
    int cluster;
    int blocks;
  };
  static std::mutex mu;
  static Entry cache[64];
  static int used = 0;
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  std::lock_guard<std::mutex> lock(mu);
  for (int i = 0; i < used; ++i) {
    if (cache[i].kernel == kernel && cache[i].device == device && cache[i].smem == smem &&
        cache[i].cluster == cluster) {
      *blocks = cache[i].blocks;
      return cudaSuccess;
    }
  }
  cudaFuncAttributes attrs;
  err = cudaFuncGetAttributes(&attrs, kernel);
  if (err != cudaSuccess) return err;
  if (static_cast<size_t>(attrs.maxDynamicSharedSizeBytes) < smem) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  if (cluster > 1) {
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = cluster;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(cluster);
    cfg.blockDim = dim3(threads);
    cfg.dynamicSmemBytes = smem;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    int clusters = 0;
    err = cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg);
    if (err != cudaSuccess) return err;
    *blocks = (clusters > 0 ? clusters : 1) * cluster;
  } else {
    int sms = 0, per_sm = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return err;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem);
    if (err != cudaSuccess) return err;
    *blocks = (per_sm > 0 ? per_sm : 1) * sms;
  }
  if (used < 64) cache[used++] = Entry{kernel, device, smem, cluster, *blocks};
  return cudaSuccess;
}

template <int K>
__device__ __forceinline__ void warp_tree(float (&s)[K]) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
#pragma unroll
    for (int k = 0; k < K; ++k) s[k] += __shfl_xor_sync(kFullMask, s[k], o);
  }
}

__device__ __forceinline__ bool aligned16(const void* a, const void* b) {
  return ((reinterpret_cast<uintptr_t>(a) | reinterpret_cast<uintptr_t>(b)) & 15) == 0;
}

// Lane i owns positions [lo, hi). fill(c0, span_lo, span_hi) writes the
// product of table k at each position q of [c0, c0 + kChunk) inside the span
// to chunk[k * kChunk + q - c0]. Adds each lane's segment sum to acc.
template <int K, class Fill>
__device__ __forceinline__ void segment_sums(int lo, int hi, float* chunk, Fill& fill,
                                             float (&acc)[K]) {
  const int lane = threadIdx.x & 31;
  const int span_lo = __shfl_sync(kFullMask, lo, 0);
  const int span_hi = __shfl_sync(kFullMask, hi, 31);
  const bool is_long = hi - lo > kLongSegment;
  for (int c0 = span_lo & ~3; c0 < span_hi; c0 += kChunk) {
    fill(c0, span_lo, span_hi);
    __syncwarp();
    // the long segments with products in this chunk
    const unsigned long_lanes = __ballot_sync(kFullMask, is_long && lo < c0 + kChunk && hi > c0);
    if (!is_long) {
      const int a = max(lo, c0) - c0;
      const int b = min(hi, c0 + kChunk) - c0;
      for (int q = a; q < b; ++q) {
#pragma unroll
        for (int k = 0; k < K; ++k) acc[k] += chunk[k * kChunk + q];
      }
    }
    for (unsigned m = long_lanes; m != 0; m &= m - 1) {
      const int src = __ffs(m) - 1;
      const int a = max(__shfl_sync(kFullMask, lo, src), c0) - c0;
      const int b = min(__shfl_sync(kFullMask, hi, src), c0 + kChunk) - c0;
      float s[K];
#pragma unroll
      for (int k = 0; k < K; ++k) s[k] = 0.0f;
      for (int q = a + lane; q < b; q += 32) {
#pragma unroll
        for (int k = 0; k < K; ++k) s[k] += chunk[k * kChunk + q];
      }
      warp_tree<K>(s);
      if (lane == src) {
#pragma unroll
        for (int k = 0; k < K; ++k) acc[k] += s[k];
      }
    }
    __syncwarp();
  }
}

// The fill of a contiguous span: position q is nonzero q of idx/vals, and
// its product with table k is vals[q] (squared with `square`) times
// table_k[idx[q] - base]. The warp loads 16 bytes of idx and of vals per lane
// and quad (scalars at the ragged ends, or everywhere if the arrays are not
// 16-byte aligned), kChunk / 128 quads per lane in flight, then gathers.
template <int K, bool kStaged>
struct GatherFill {
  const int* idx;
  const float* vals;
  const float* table0;
  const float* table1;
  float* chunk;
  bool vec;
  bool square;
  int base;  // the index of table entry 0: a row tile's first row, or 0

  __device__ __forceinline__ float table_at(const float* t, int c) const {
    if constexpr (kStaged) {
      return t[c - base];
    } else {
      return __ldg(t + (c - base));
    }
  }

  __device__ __forceinline__ void operator()(int c0, int span_lo, int span_hi) const {
    constexpr int kQuads = kChunk / 128;
    const int lane = threadIdx.x & 31;
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
          c[i][j] = in ? __ldg(idx + q + j) : base;
          v[i][j] = in ? __ldg(vals + q + j) : 0.0f;
        }
      }
    }
#pragma unroll
    for (int i = 0; i < kQuads; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (square) v[i][j] *= v[i][j];
      }
      float4 p;
      p.x = v[i][0] * table_at(table0, c[i][0]);
      p.y = v[i][1] * table_at(table0, c[i][1]);
      p.z = v[i][2] * table_at(table0, c[i][2]);
      p.w = v[i][3] * table_at(table0, c[i][3]);
      reinterpret_cast<float4*>(chunk)[lane + 32 * i] = p;
      if constexpr (K == 2) {
        p.x = v[i][0] * table_at(table1, c[i][0]);
        p.y = v[i][1] * table_at(table1, c[i][1]);
        p.z = v[i][2] * table_at(table1, c[i][2]);
        p.w = v[i][3] * table_at(table1, c[i][3]);
        reinterpret_cast<float4*>(chunk + kChunk)[lane + 32 * i] = p;
      }
    }
  }
};

}  // namespace
}  // namespace photon
