// One templated row pass over a CSR matrix on Hopper (sm_90a), shared by the
// margins kernels (margins.cu, margins_pair.cu); tile_fused.cuh runs the
// same warp spans and fill as phase A of value_grad.cu, hv and hv_at:
//   acc0 = sum_k vals_k * table0[cols_k] + shift0
//   acc1 = sum_k vals_k * table1[cols_k] + shift1        (two-table epilogues)
//
// Design ("CSR-stream"): a warp owns 32 consecutive rows, lane i row r0 + i.
// The lanes read their row_ptr entries in one coalesced load; the warp's
// nonzeros are the one span [row_ptr[r0], row_ptr[r0 + 32]), which the warp
// sweeps in chunks with 16-byte loads of cols and vals, forming the products
// with the tables in a per-warp chunk of shared memory; each lane then adds
// its own row's products in nonzero order, and rows longer than
// kLongSegment are summed by the whole warp (segments.cuh). So no lane idles
// on short rows, a hot row is swept at full width, and one thread owns each
// row's sum and runs the epilogue: the per-row writes use every lane. An
// epilogue, chosen as a template parameter, turns (acc0, acc1) into per-row
// outputs. No float atomics anywhere: every sum is bit-identical from launch
// to launch. block_sums and sum_partials below are the fixed-order sums of
// per-thread and per-block partials that the tile-fused passes use.
//
// The tables are staged once per block in dynamic shared memory, after the
// warps' product chunks, when both fit in kRowSmemLimitBytes; otherwise they
// are read through the read-only cache. The grid is sized to the resident
// block count so each block stages its tables once and walks many rows.

#pragma once

#include <cuda_runtime.h>

#include "segments.cuh"

namespace photon {
namespace {

constexpr int kRowThreads = 512;
constexpr int kRowWarps = kRowThreads / 32;
// dynamic shared memory of one block: the product chunks, plus the tables
// when they fit (the card allows 227 KB; the rest is for block_sums)
constexpr size_t kRowSmemLimitBytes = 220 * 1024;
// resident blocks the compiler budgets registers for (three 512-thread
// blocks: 42 registers a thread)
constexpr int kRowMinBlocks = 3;

struct RowPassParams {
  const int* row_ptr;
  const int* cols;
  const float* vals;
  const float* table0;
  const float* table1;
  const float* shift0_dev;  // optional one-element device scalars, added to
  const float* shift1_dev;  // the host scalars so the caller never syncs
  float shift0_host;
  float shift1_host;
  const float* offsets;
  const float* labels;
  const float* weights;
  const float* d2;
  float* out0;
  float* out1;
  float* partials;  // [gridDim.x * Epi::kSums] (tile_fused.cuh)
  int n_rows;
  int n_features;
};

// Sum each of K per-thread values over the block in a fixed order and write
// the K totals to out[0..K).
template <int K>
__device__ void block_sums(const float (&part)[K], float* out) {
  __shared__ float warp_sums[kRowThreads / 32][K];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    float v = part[k];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    if (lane == 0) warp_sums[warp][k] = v;
  }
  __syncthreads();
  if (threadIdx.x < K) {
    float s = 0.0f;
    for (int w = 0; w < kRowThreads / 32; ++w) s += warp_sums[w][threadIdx.x];
    out[threadIdx.x] = s;
  }
}

template <bool kStaged, class Epi>
__global__ void __launch_bounds__(kRowThreads, kRowMinBlocks)
row_pass_kernel(const RowPassParams p) {
  constexpr int K = Epi::kTables;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  float* tables = smem + kRowWarps * K * kChunk;
  const float* t0 = p.table0;
  const float* t1 = p.table1;
  if constexpr (kStaged) {
    for (int f = threadIdx.x; f < p.n_features; f += blockDim.x) {
      tables[f] = __ldg(p.table0 + f);
      if constexpr (K == 2) tables[p.n_features + f] = __ldg(p.table1 + f);
    }
    __syncthreads();
    t0 = tables;
    t1 = tables + p.n_features;
  }
  GatherFill<K, kStaged> fill{p.cols, p.vals, t0, t1, smem + warp * K * kChunk,
                              aligned16(p.cols, p.vals), false};
  const float shift0 = p.shift0_host + (p.shift0_dev != nullptr ? __ldg(p.shift0_dev) : 0.0f);
  const float shift1 = p.shift1_host + (p.shift1_dev != nullptr ? __ldg(p.shift1_dev) : 0.0f);

  // Each warp walks its own tiles of 32 rows; the loop is uniform across the
  // warp, so every lane reaches the shuffles of segment_sums.
  const int n_tiles = (p.n_rows + 31) / 32;
  for (int tile = blockIdx.x * kRowWarps + warp; tile < n_tiles;
       tile += gridDim.x * kRowWarps) {
    const int row = tile * 32 + lane;
    const int lo = __ldg(p.row_ptr + min(row, p.n_rows));
    const int hi = __ldg(p.row_ptr + min(row + 1, p.n_rows));
    float acc[K];
#pragma unroll
    for (int k = 0; k < K; ++k) acc[k] = 0.0f;
    segment_sums<K>(lo, hi, fill.chunk, fill, acc);
    if (row < p.n_rows) Epi::apply(p, row, acc[0] + shift0, acc[K - 1] + shift1);
  }
}

// sums[k] = sum_b partials[b*K + k] over the `blocks` block partials, in a
// fixed order (strided per thread, then a shared-memory tree), by one block
// of kFinishThreads threads.
template <int K>
__device__ void sum_partials(const float* __restrict__ partials, int blocks,
                             float* __restrict__ sums) {
  __shared__ float s[K][kFinishThreads];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    float acc = 0.0f;
    for (int b = threadIdx.x; b < blocks; b += kFinishThreads) acc += partials[b * K + k];
    s[k][threadIdx.x] = acc;
  }
  __syncthreads();
  for (int stride = kFinishThreads / 2; stride > 0; stride >>= 1) {
    if (threadIdx.x < stride) {
#pragma unroll
      for (int k = 0; k < K; ++k) s[k][threadIdx.x] += s[k][threadIdx.x + stride];
    }
    __syncthreads();
  }
  if (threadIdx.x < K) sums[threadIdx.x] = s[threadIdx.x][0];
}

template <bool kStaged, class Epi>
cudaError_t launch_staged(const RowPassParams& p, size_t smem, int max_blocks,
                          cudaStream_t stream, int* grid_out) {
  *grid_out = 0;
  const long long needed =
      ((static_cast<long long>(p.n_rows) + 31) / 32 + kRowWarps - 1) / kRowWarps;
  if (needed == 0) return cudaSuccess;
  auto kernel = row_pass_kernel<kStaged, Epi>;
  int resident = 0;
  cudaError_t err =
      resident_blocks(reinterpret_cast<const void*>(kernel), kRowThreads, smem, &resident);
  if (err != cudaSuccess) return err;
  long long grid = resident;
  if (needed < grid) grid = needed;
  if (max_blocks < grid) grid = max_blocks;
  kernel<<<static_cast<int>(grid), kRowThreads, smem, stream>>>(p);
  *grid_out = static_cast<int>(grid);
  return cudaGetLastError();
}

// Launch the row pass with the epilogue Epi; *grid_out receives the number of
// blocks.
template <class Epi>
cudaError_t launch_row_pass(const RowPassParams& p, int max_blocks, cudaStream_t stream,
                            int* grid_out) {
  const size_t chunks = static_cast<size_t>(kRowWarps) * Epi::kTables * kChunk * sizeof(float);
  const size_t tables = static_cast<size_t>(Epi::kTables) * p.n_features * sizeof(float);
  if (chunks + tables <= kRowSmemLimitBytes) {
    return launch_staged<true, Epi>(p, chunks + tables, max_blocks, stream, grid_out);
  }
  return launch_staged<false, Epi>(p, chunks, max_blocks, stream, grid_out);
}

}  // namespace
}  // namespace photon
