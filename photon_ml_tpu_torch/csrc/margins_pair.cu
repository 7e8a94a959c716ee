// Margins along a line on Hopper (sm_90a), from one read of the CSR slots:
//   z_i = x_i . w + shift0 + offsets_i,   u_i = x_i . p + shift1
//
// Replaces the TPU kernel `_margins_kernel` with pair=True
// (photon_ml_tpu/ops/tiled.py:194-196, built by `_margins_call` at :339). The
// TPU version shares its one-hot masks between the two gathers; here one warp
// gathers w and p in the same sweep over cols/vals (rowpass.cuh), which
// halves the slot traffic of two margins.cu launches. Only z carries offsets.
//
// Bound: bytes. Per call it must read row_ptr, cols and vals (8 bytes per
// nonzero), w, p and offsets, and write two floats per row: ~176 bytes per row
// at 20 nonzeros, against 80 flops. Both tables (80 KB at 10K features) are
// staged in shared memory when they fit beside the product chunks in 220 KB;
// beyond that they are read through the read-only cache.

#include "rowpass.cuh"

namespace photon {
namespace {

struct PairEpilogue {
  static constexpr int kTables = 2;
  static constexpr int kSums = 0;
  static __device__ __forceinline__ void apply(const RowPassParams& p, int row, float a0,
                                               float a1, float*) {
    p.out0[row] = a0 + __ldg(p.offsets + row);
    p.out1[row] = a1;
  }
};

}  // namespace
}  // namespace photon

extern "C" int photon_margins_pair(const int* row_ptr, const int* cols, const float* vals,
                                   const float* w, const float* p_dir, const float* offsets,
                                   const float* shift0_dev, float shift0_host,
                                   const float* shift1_dev, float shift1_host, float* z_out,
                                   float* u_out, int n_rows, int n_features, void* stream) {
  using namespace photon;
  RowPassParams p{};
  p.row_ptr = row_ptr;
  p.cols = cols;
  p.vals = vals;
  p.table0 = w;
  p.table1 = p_dir;
  p.shift0_dev = shift0_dev;
  p.shift0_host = shift0_host;
  p.shift1_dev = shift1_dev;
  p.shift1_host = shift1_host;
  p.offsets = offsets;
  p.out0 = z_out;
  p.out1 = u_out;
  p.n_rows = n_rows;
  p.n_features = n_features;
  int grid = 0;
  return launch_row_pass<PairEpilogue>(p, 1 << 30, static_cast<cudaStream_t>(stream), &grid);
}
