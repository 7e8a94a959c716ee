// Feature-space scatter over a column-sorted (CSC) mirror on Hopper (sm_90a):
//   g_f = sum_{k in column f} per_row[rows_k] * vals_k      (vals_k^2 with square)
//
// Replaces the TPU kernel `_scatter_kernel` (photon_ml_tpu/ops/tiled.py:199,
// built by `_scatter_call` at :350). The TPU version accumulates one-hot
// matmuls across a sequential grid; Hopper blocks run in no order, and a
// scatter by row would need float atomics, whose order changes from run to
// run. This kernel instead owns each output feature with one group of lanes
// and walks that feature's column of the CSC mirror, so every sum is taken in
// a fixed order and the result is bit-for-bit reproducible.
//
// Bound: bytes. Per call it must read col_ptr, rows and vals (8 bytes per
// nonzero) and per_row, and write one float per feature. per_row (4 MB at a
// million rows) stays in the 50 MB L2, so its random reads are L2 hits.
//
// Design: a group of G lanes (a power of two <= 32, chosen by the caller from
// the mean column length) per feature; consecutive lanes read consecutive
// nonzeros (coalesced), sum in a fixed order with fmaf, then reduce with a
// fixed __shfl_xor_sync tree. No atomics, no shared memory.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

template <int G>
__global__ void __launch_bounds__(kThreads)
csc_scatter_kernel(const int* __restrict__ col_ptr, const int* __restrict__ rows,
                   const float* __restrict__ vals, const float* __restrict__ per_row,
                   float* __restrict__ out, int n_features, int square) {
  const int lane = threadIdx.x % G;
  const int group = threadIdx.x / G;
  const int groups_per_block = kThreads / G;
  // The feature loop is uniform across the block, so every lane reaches the
  // shuffles below.
  for (int base = blockIdx.x * groups_per_block; base < n_features;
       base += gridDim.x * groups_per_block) {
    const int f = base + group;
    float acc = 0.0f;
    if (f < n_features) {
      const int begin = __ldg(col_ptr + f);
      const int end = __ldg(col_ptr + f + 1);
      for (int k = begin + lane; k < end; k += G) {
        float v = __ldg(vals + k);
        if (square) v = v * v;
        acc = fmaf(__ldg(per_row + __ldg(rows + k)), v, acc);
      }
    }
#pragma unroll
    for (int o = G / 2; o > 0; o >>= 1) {
      acc += __shfl_xor_sync(0xffffffffu, acc, o, G);
    }
    if (lane == 0 && f < n_features) out[f] = acc;
  }
}

template <int G>
cudaError_t launch(const int* col_ptr, const int* rows, const float* vals,
                   const float* per_row, float* out, int n_features, int square,
                   cudaStream_t stream) {
  const int groups_per_block = kThreads / G;
  const long long needed = (static_cast<long long>(n_features) + groups_per_block - 1) /
                           groups_per_block;
  const int grid = static_cast<int>(needed < 1048576 ? needed : 1048576);
  csc_scatter_kernel<G><<<grid, kThreads, 0, stream>>>(col_ptr, rows, vals, per_row,
                                                       out, n_features, square);
  return cudaGetLastError();
}

}  // namespace

extern "C" int photon_csc_scatter(const int* col_ptr, const int* rows,
                                  const float* vals, const float* per_row, float* out,
                                  int n_features, int group, int square, void* stream) {
  if (n_features <= 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (group) {
    case 1:
      return launch<1>(col_ptr, rows, vals, per_row, out, n_features, square, s);
    case 2:
      return launch<2>(col_ptr, rows, vals, per_row, out, n_features, square, s);
    case 4:
      return launch<4>(col_ptr, rows, vals, per_row, out, n_features, square, s);
    case 8:
      return launch<8>(col_ptr, rows, vals, per_row, out, n_features, square, s);
    case 16:
      return launch<16>(col_ptr, rows, vals, per_row, out, n_features, square, s);
    case 32:
      return launch<32>(col_ptr, rows, vals, per_row, out, n_features, square, s);
    default:
      return cudaErrorInvalidValue;
  }
}
