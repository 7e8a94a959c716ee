// One templated row pass over a CSR matrix on Hopper (sm_90a), shared by the
// margins kernel and the fused kernels (margins.cu, margins_pair.cu,
// value_grad.cu, hessian_vector.cu).
//
// A group of G lanes (a power of two <= 32, from the mean row length) owns a
// row and gathers one or two coefficient tables over the row's nonzeros in a
// single sweep of cols/vals; consecutive lanes read consecutive nonzeros, so
// the loads coalesce:
//   acc0 = sum_k vals_k * table0[cols_k] + shift0
//   acc1 = sum_k vals_k * table1[cols_k] + shift1        (two-table epilogues)
// The lane sums are fmaf chains reduced by a fixed __shfl_xor_sync tree. An
// epilogue, chosen as a template parameter, turns (acc0, acc1)
// into per-row outputs and, where the TPU kernel returns data sums, adds its
// terms to per-thread partials. Each block reduces its partials in a fixed
// order and writes them to partials[blockIdx.x]; finish_sums_kernel then sums
// the block partials in a fixed order. No float atomics anywhere: the grid
// depends only on the card and the shapes, so every sum is bit-identical from
// launch to launch.
//
// The tables are staged once per block in dynamic shared memory when they fit
// (kRowSmemLimitBytes); otherwise they are read through the read-only cache.
// The grid is sized to the resident block count so each block stages its
// tables once and walks many rows.

#pragma once

#include <cuda_runtime.h>

// Defined in scatter.cu, linked into the same library: the deterministic
// feature-space scatter over the CSC mirror that finishes the fused passes.
extern "C" int photon_csc_scatter(const int* col_ptr, const int* rows, const float* vals,
                                  const float* per_row, float* out, int n_features,
                                  int group, int square, void* stream);

namespace photon {
namespace {

constexpr int kRowThreads = 512;
constexpr size_t kRowSmemLimitBytes = 200 * 1024;
constexpr int kFinishThreads = 256;

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
  float* partials;  // [gridDim.x * Epi::kSums]
  int n_rows;
  int n_features;
};

template <bool kStaged>
__device__ __forceinline__ float table_at(const float* table, int c) {
  if constexpr (kStaged) {
    return table[c];
  } else {
    return __ldg(table + c);
  }
}

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

template <int G, bool kStaged, class Epi>
__global__ void __launch_bounds__(kRowThreads) row_pass_kernel(const RowPassParams p) {
  extern __shared__ float tables_smem[];
  const float* t0 = p.table0;
  const float* t1 = p.table1;
  if constexpr (kStaged) {
    for (int f = threadIdx.x; f < p.n_features; f += blockDim.x) {
      tables_smem[f] = __ldg(p.table0 + f);
      if constexpr (Epi::kTables == 2) tables_smem[p.n_features + f] = __ldg(p.table1 + f);
    }
    __syncthreads();
    t0 = tables_smem;
    t1 = tables_smem + p.n_features;
  }
  const float shift0 = p.shift0_host + (p.shift0_dev != nullptr ? __ldg(p.shift0_dev) : 0.0f);
  const float shift1 = p.shift1_host + (p.shift1_dev != nullptr ? __ldg(p.shift1_dev) : 0.0f);
  const int lane = threadIdx.x % G;
  const int group = threadIdx.x / G;
  constexpr int kGroups = kRowThreads / G;
  constexpr int kParts = Epi::kSums > 0 ? Epi::kSums : 1;
  float part[kParts];
#pragma unroll
  for (int k = 0; k < kParts; ++k) part[k] = 0.0f;

  // The row loop is uniform across the block, so every lane reaches the
  // shuffles and the block reduction below.
  for (int base = blockIdx.x * kGroups; base < p.n_rows; base += gridDim.x * kGroups) {
    const int row = base + group;
    float acc0 = 0.0f;
    float acc1 = 0.0f;
    if (row < p.n_rows) {
      const int begin = __ldg(p.row_ptr + row);
      const int end = __ldg(p.row_ptr + row + 1);
      for (int k = begin + lane; k < end; k += G) {
        const int c = __ldg(p.cols + k);
        const float v = __ldg(p.vals + k);
        acc0 = fmaf(v, table_at<kStaged>(t0, c), acc0);
        if constexpr (Epi::kTables == 2) acc1 = fmaf(v, table_at<kStaged>(t1, c), acc1);
      }
    }
#pragma unroll
    for (int o = G / 2; o > 0; o >>= 1) {
      acc0 += __shfl_xor_sync(0xffffffffu, acc0, o, G);
      if constexpr (Epi::kTables == 2) acc1 += __shfl_xor_sync(0xffffffffu, acc1, o, G);
    }
    if (lane == 0 && row < p.n_rows) Epi::apply(p, row, acc0 + shift0, acc1 + shift1, part);
  }
  if constexpr (Epi::kSums > 0) block_sums<kParts>(part, p.partials + blockIdx.x * Epi::kSums);
}

// sums[k] = sum_b partials[b*K + k] over the `blocks` block partials, in a
// fixed order (strided per thread, then a shared-memory tree).
template <int K>
__global__ void __launch_bounds__(kFinishThreads)
finish_sums_kernel(const float* __restrict__ partials, int blocks, float* __restrict__ sums) {
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

template <int G, bool kStaged, class Epi>
cudaError_t launch_staged(const RowPassParams& p, int max_blocks, cudaStream_t stream,
                          int* grid_out) {
  *grid_out = 0;
  constexpr int kGroups = kRowThreads / G;
  const long long needed = (static_cast<long long>(p.n_rows) + kGroups - 1) / kGroups;
  if (needed == 0) return cudaSuccess;
  auto kernel = row_pass_kernel<G, kStaged, Epi>;
  const size_t smem =
      kStaged ? static_cast<size_t>(Epi::kTables) * p.n_features * sizeof(float) : 0;
  cudaError_t err;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  int device = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&device)) != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kRowThreads, smem);
  if (err != cudaSuccess) return err;
  long long grid = static_cast<long long>(per_sm > 0 ? per_sm : 1) * sms;
  if (needed < grid) grid = needed;
  if (max_blocks < grid) grid = max_blocks;
  kernel<<<static_cast<int>(grid), kRowThreads, smem, stream>>>(p);
  *grid_out = static_cast<int>(grid);
  return cudaGetLastError();
}

template <int G, class Epi>
cudaError_t launch_g(const RowPassParams& p, int max_blocks, cudaStream_t stream,
                     int* grid_out) {
  const size_t table_bytes = static_cast<size_t>(Epi::kTables) * p.n_features * sizeof(float);
  if (table_bytes <= kRowSmemLimitBytes) {
    return launch_staged<G, true, Epi>(p, max_blocks, stream, grid_out);
  }
  return launch_staged<G, false, Epi>(p, max_blocks, stream, grid_out);
}

// Launch the row pass with the epilogue Epi; *grid_out receives the number of
// blocks (and so of partials) it wrote.
template <class Epi>
cudaError_t launch_row_pass(const RowPassParams& p, int group, int max_blocks,
                            cudaStream_t stream, int* grid_out) {
  switch (group) {
    case 1:
      return launch_g<1, Epi>(p, max_blocks, stream, grid_out);
    case 2:
      return launch_g<2, Epi>(p, max_blocks, stream, grid_out);
    case 4:
      return launch_g<4, Epi>(p, max_blocks, stream, grid_out);
    case 8:
      return launch_g<8, Epi>(p, max_blocks, stream, grid_out);
    case 16:
      return launch_g<16, Epi>(p, max_blocks, stream, grid_out);
    case 32:
      return launch_g<32, Epi>(p, max_blocks, stream, grid_out);
    default:
      *grid_out = 0;
      return cudaErrorInvalidValue;
  }
}

template <int K>
cudaError_t launch_finish(const float* partials, int blocks, float* sums, cudaStream_t stream) {
  finish_sums_kernel<K><<<1, kFinishThreads, 0, stream>>>(partials, blocks, sums);
  return cudaGetLastError();
}

}  // namespace
}  // namespace photon
