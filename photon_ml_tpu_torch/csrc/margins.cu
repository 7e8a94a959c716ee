// Per-row margins of a CSR matrix on Hopper (sm_90a):
//   z_i = sum_{k in row i} vals_k * w[cols_k] + shift (+ offsets_i)
//
// Replaces the TPU kernel `_margins_kernel` with pair=False
// (photon_ml_tpu/ops/tiled.py:170, built by `_margins_call` at :330). The TPU
// version turns the gather into one-hot matmuls because the TPU has no fast
// random access; Hopper gathers from shared memory and L2 directly, so this
// kernel reads the row-sorted CSR arrays once and gathers w.
//
// Bound: bytes. Per call it must read row_ptr, cols and vals (8 bytes per
// nonzero), w, and offsets when used, and write one float per row; at 20
// nonzeros per row that is ~168 bytes per row, against 40 flops.
//
// Design:
//   - A group of G lanes (G a power of two <= 32, chosen by the caller from
//     the mean row length) owns one row; consecutive lanes read consecutive
//     nonzeros, so the cols/vals loads coalesce.
//   - When w fits (n_features * 4 <= 200 KB) it is staged once per block in
//     dynamic shared memory, and the grid is sized to the resident block
//     count so each block stages w once and walks many rows. Otherwise w is
//     read through the read-only cache.
//   - Each lane sums its nonzeros in a fixed order with fmaf, then the group
//     reduces with a fixed __shfl_xor_sync tree: results are deterministic.
//   - shift is a host scalar plus an optional one-element device tensor, so
//     the caller never syncs to read it.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr size_t kSmemLimitBytes = 200 * 1024;

template <int G, bool kStageW>
__global__ void __launch_bounds__(kThreads)
csr_margins_kernel(const int* __restrict__ row_ptr, const int* __restrict__ cols,
                   const float* __restrict__ vals, const float* __restrict__ w,
                   const float* __restrict__ offsets,
                   const float* __restrict__ shift_dev, float shift_host,
                   float* __restrict__ out, int n_rows, int n_features) {
  extern __shared__ float w_smem[];
  if (kStageW) {
    for (int f = threadIdx.x; f < n_features; f += blockDim.x) {
      w_smem[f] = __ldg(w + f);
    }
    __syncthreads();
  }
  const float shift = shift_host + (shift_dev != nullptr ? __ldg(shift_dev) : 0.0f);
  const int lane = threadIdx.x % G;
  const int group = threadIdx.x / G;
  const int groups_per_block = kThreads / G;
  // The row loop is uniform across the block, so every lane reaches the
  // shuffles below.
  for (int base = blockIdx.x * groups_per_block; base < n_rows;
       base += gridDim.x * groups_per_block) {
    const int row = base + group;
    float acc = 0.0f;
    if (row < n_rows) {
      const int begin = __ldg(row_ptr + row);
      const int end = __ldg(row_ptr + row + 1);
      for (int k = begin + lane; k < end; k += G) {
        const int c = __ldg(cols + k);
        const float wc = kStageW ? w_smem[c] : __ldg(w + c);
        acc = fmaf(__ldg(vals + k), wc, acc);
      }
    }
#pragma unroll
    for (int o = G / 2; o > 0; o >>= 1) {
      acc += __shfl_xor_sync(0xffffffffu, acc, o, G);
    }
    if (lane == 0 && row < n_rows) {
      float z = acc + shift;
      if (offsets != nullptr) z += __ldg(offsets + row);
      out[row] = z;
    }
  }
}

template <int G, bool kStageW>
cudaError_t launch(const int* row_ptr, const int* cols, const float* vals,
                   const float* w, const float* offsets, const float* shift_dev,
                   float shift_host, float* out, int n_rows, int n_features,
                   cudaStream_t stream) {
  auto kernel = csr_margins_kernel<G, kStageW>;
  const size_t smem = kStageW ? static_cast<size_t>(n_features) * sizeof(float) : 0;
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
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem);
  if (err != cudaSuccess) return err;
  const int groups_per_block = kThreads / G;
  const long long needed = (static_cast<long long>(n_rows) + groups_per_block - 1) /
                           groups_per_block;
  long long resident = static_cast<long long>(per_sm > 0 ? per_sm : 1) * sms;
  const int grid = static_cast<int>(needed < resident ? needed : resident);
  kernel<<<grid, kThreads, smem, stream>>>(row_ptr, cols, vals, w, offsets, shift_dev,
                                          shift_host, out, n_rows, n_features);
  return cudaGetLastError();
}

template <int G>
cudaError_t launch_g(const int* row_ptr, const int* cols, const float* vals,
                     const float* w, const float* offsets, const float* shift_dev,
                     float shift_host, float* out, int n_rows, int n_features,
                     cudaStream_t stream) {
  if (static_cast<size_t>(n_features) * sizeof(float) <= kSmemLimitBytes) {
    return launch<G, true>(row_ptr, cols, vals, w, offsets, shift_dev, shift_host,
                           out, n_rows, n_features, stream);
  }
  return launch<G, false>(row_ptr, cols, vals, w, offsets, shift_dev, shift_host, out,
                          n_rows, n_features, stream);
}

}  // namespace

extern "C" int photon_csr_margins(const int* row_ptr, const int* cols,
                                  const float* vals, const float* w,
                                  const float* offsets, const float* shift_dev,
                                  float shift_host, float* out, int n_rows,
                                  int n_features, int group, void* stream) {
  if (n_rows <= 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (group) {
    case 1:
      return launch_g<1>(row_ptr, cols, vals, w, offsets, shift_dev, shift_host, out,
                         n_rows, n_features, s);
    case 2:
      return launch_g<2>(row_ptr, cols, vals, w, offsets, shift_dev, shift_host, out,
                         n_rows, n_features, s);
    case 4:
      return launch_g<4>(row_ptr, cols, vals, w, offsets, shift_dev, shift_host, out,
                         n_rows, n_features, s);
    case 8:
      return launch_g<8>(row_ptr, cols, vals, w, offsets, shift_dev, shift_host, out,
                         n_rows, n_features, s);
    case 16:
      return launch_g<16>(row_ptr, cols, vals, w, offsets, shift_dev, shift_host, out,
                          n_rows, n_features, s);
    case 32:
      return launch_g<32>(row_ptr, cols, vals, w, offsets, shift_dev, shift_host, out,
                          n_rows, n_features, s);
    default:
      return cudaErrorInvalidValue;
  }
}

extern "C" const char* photon_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
