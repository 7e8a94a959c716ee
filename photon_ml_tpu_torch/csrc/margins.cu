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
// It is the one-table row pass of rowpass.cuh (a warp per 32 rows streaming
// their nonzeros, one thread per row summing in nonzero order, w staged in
// shared memory beside the product chunks, so the margins are deterministic)
// with an epilogue that adds the offsets when there are any.
// shift is a host scalar plus an optional one-element device tensor, so the
// caller never syncs to read it.

#include "rowpass.cuh"

namespace photon {
namespace {

struct MarginsEpilogue {
  static constexpr int kTables = 1;
  static constexpr int kSums = 0;
  static __device__ __forceinline__ void apply(const RowPassParams& p, int row, float a0,
                                               float, float*) {
    p.out0[row] = p.offsets != nullptr ? a0 + __ldg(p.offsets + row) : a0;
  }
};

}  // namespace
}  // namespace photon

extern "C" int photon_csr_margins(const int* row_ptr, const int* cols,
                                  const float* vals, const float* w,
                                  const float* offsets, const float* shift_dev,
                                  float shift_host, float* out, int n_rows,
                                  int n_features, void* stream) {
  using namespace photon;
  RowPassParams p{};
  p.row_ptr = row_ptr;
  p.cols = cols;
  p.vals = vals;
  p.table0 = w;
  p.shift0_dev = shift_dev;
  p.shift0_host = shift_host;
  p.offsets = offsets;
  p.out0 = out;
  p.n_rows = n_rows;
  p.n_features = n_features;
  int grid = 0;
  return launch_row_pass<MarginsEpilogue>(p, 1 << 30, static_cast<cudaStream_t>(stream), &grid);
}

extern "C" const char* photon_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
