// Per-row margins of a slot-major ELL matrix on Hopper (sm_90a):
//   z_r = sum_{s < S} vals[s][r] * w[cols[s][r]] + shift (+ offsets_r)
//
// Replaces the TPU kernel `_ell_margins_kernel` (tools/probe_ell.py:26, built
// by `_ell_call` at :59). That kernel keeps the slots lane-aligned in
// [T, S, 128] tiles (slot (t, s, j) is nonzero s of row 128t + j) and turns
// the gather of w into one-hot matmuls on bf16 halves, because the TPU has no
// fast random access. Hopper gathers from shared memory directly, so the
// one-hot products, the bf16 split and the ones-matmul row sum are gone; what
// stays is the layout: slot s of every row lies in row s of vals/cols
// ([S, n_pad], n_pad a multiple of 128), with plain column ids.
//
// Bound: bytes. Per call it must read vals and cols (8 bytes per slot, padding
// included), w, and offsets when used, and write one float per row:
// 4 * (2 * S * n_pad + f + n_pad) bytes, 164 MB at 1M x 10K x 20, 0.049 ms at
// 3.35 TB/s, against 2 flops per slot.
//
// Design: one thread per row walks its S slots in a fixed order with fmaf.
// Neighbouring threads own neighbouring rows, so each slot's loads of a warp
// are 32 neighbouring words: every lane does useful work whatever the row
// length (the CSR row pass leaves lanes idle when a row is shorter than its
// lane group) and no row_ptr is read. Nothing is reduced across threads, so
// the output is bit-identical from launch to launch. w is staged once per
// block in dynamic shared memory up to 200 KB (cudaFuncSetAttribute above the
// 48 KB default) and read through the read-only cache past that; the grid is
// the resident block count, each block striding over rows, so w is staged
// once per resident block. Rows past n are not computed (ragged last block).

#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kThreads = 512;
constexpr size_t kSmemLimitBytes = 200 * 1024;

template <bool kStaged>
__global__ void __launch_bounds__(kThreads)
ell_margins_kernel(const float* __restrict__ vals, const int* __restrict__ cols,
                   const float* __restrict__ w, const float* __restrict__ offsets,
                   const float* __restrict__ shift_dev, float shift_host,
                   float* __restrict__ out, int n_rows, int n_pad, int n_slots,
                   int n_features) {
  extern __shared__ float w_smem[];
  if constexpr (kStaged) {
    for (int f = threadIdx.x; f < n_features; f += blockDim.x) w_smem[f] = __ldg(w + f);
    __syncthreads();
  }
  const float shift = shift_host + (shift_dev != nullptr ? __ldg(shift_dev) : 0.0f);
  const size_t pitch = static_cast<size_t>(n_pad);
  for (int row = blockIdx.x * blockDim.x + threadIdx.x; row < n_rows;
       row += gridDim.x * blockDim.x) {
    const float* v = vals + row;
    const int* c = cols + row;
    float acc = 0.0f;
#pragma unroll 4
    for (int s = 0; s < n_slots; ++s) {
      const size_t at = static_cast<size_t>(s) * pitch;
      const float x = __ldg(v + at);
      const int col = __ldg(c + at);
      float wv;
      if constexpr (kStaged) {
        wv = w_smem[col];
      } else {
        wv = __ldg(w + col);
      }
      acc = fmaf(x, wv, acc);
    }
    const float z = acc + shift;
    out[row] = offsets != nullptr ? z + __ldg(offsets + row) : z;
  }
}

template <bool kStaged>
cudaError_t launch(const float* vals, const int* cols, const float* w, const float* offsets,
                   const float* shift_dev, float shift_host, float* out, int n_rows,
                   int n_pad, int n_slots, int n_features, cudaStream_t stream) {
  auto kernel = ell_margins_kernel<kStaged>;
  const size_t smem = kStaged ? static_cast<size_t>(n_features) * sizeof(float) : 0;
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
  long long grid = static_cast<long long>(per_sm > 0 ? per_sm : 1) * sms;
  const long long needed = (static_cast<long long>(n_rows) + kThreads - 1) / kThreads;
  if (needed < grid) grid = needed;
  kernel<<<static_cast<int>(grid), kThreads, smem, stream>>>(
      vals, cols, w, offsets, shift_dev, shift_host, out, n_rows, n_pad, n_slots, n_features);
  return cudaGetLastError();
}

}  // namespace

extern "C" int photon_ell_margins(const float* vals, const int* cols, const float* w,
                                  const float* offsets, const float* shift_dev,
                                  float shift_host, float* out, int n_rows, int n_pad,
                                  int n_slots, int n_features, void* stream) {
  if (n_rows == 0) return cudaSuccess;
  if (n_rows > n_pad || n_pad % 128 != 0 || n_slots < 0 || n_features < 0) {
    return cudaErrorInvalidValue;
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (static_cast<size_t>(n_features) * sizeof(float) <= kSmemLimitBytes) {
    return launch<true>(vals, cols, w, offsets, shift_dev, shift_host, out, n_rows, n_pad,
                        n_slots, n_features, s);
  }
  return launch<false>(vals, cols, w, offsets, shift_dev, shift_host, out, n_rows, n_pad,
                       n_slots, n_features, s);
}
