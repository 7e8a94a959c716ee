// Fused GLM value and gradient on Hopper (sm_90a), with z = X.w + shift + offsets:
//   (sum_i wgt_i*l(z_i, y_i),  sum_i wgt_i*l'(z_i, y_i)*x_i,  sum_i wgt_i*l'(z_i, y_i))
//
// Replaces the TPU kernel `_value_grad_kernel` (photon_ml_tpu/ops/tiled.py:219,
// built by `_value_grad_call` at :399), templated on the loss as it is. The
// TPU kernel gathers, scatters and accumulates across a sequential grid in one
// pass. Hopper blocks run in no order, and a scatter by row would need float
// atomics, whose order changes from run to run. So the function is three
// hand-written launches, every sum in a fixed order:
//   1. the row pass (rowpass.cuh) gathers w, applies the loss, writes the
//      per-row g_i = wgt_i*l'(z_i) and per-block partials of the two sums;
//   2. finish_sums_kernel adds the block partials;
//   3. scatter.cu walks the CSC mirror by row tiles, g of each tile staged in
//      shared memory, and sums g into feature space.
//
// Bound: bytes. The function must read the slots once (8 bytes per nonzero),
// row_ptr, labels, weights, offsets and w, and write the gradient: ~176 bytes
// per row at 20 nonzeros. This design also reads the CSC slots and writes and
// reads g, about twice the bound: the price of determinism without atomics.

#include "losses.cuh"
#include "rowpass.cuh"

namespace photon {
namespace {

template <class Loss>
struct ValueGradEpilogue {
  static constexpr int kTables = 1;
  static constexpr int kSums = 2;
  static __device__ __forceinline__ void apply(const RowPassParams& p, int row, float a0,
                                               float, float* part) {
    const float z = a0 + __ldg(p.offsets + row);
    const float y = __ldg(p.labels + row);
    const float wgt = __ldg(p.weights + row);
    const float g = wgt * Loss::dz(z, y);
    p.out0[row] = g;
    part[0] += wgt * Loss::loss(z, y);
    part[1] += g;
  }
};

}  // namespace
}  // namespace photon

// sums[0] = sum wgt*l, sums[1] = sum wgt*l'; grad[F]; g_row[n],
// partials[2*max_blocks] and part (the scatter's parts) are scratch the
// caller allocates; the tile index is photon_csc_scatter's.
extern "C" int photon_value_grad(const int* row_ptr, const int* cols, const float* vals,
                                 const int* csc_rows, const float* csc_vals,
                                 const float* labels, const float* weights,
                                 const float* offsets, const float* w, const float* shift_dev,
                                 float shift_host, int loss, float* g_row, float* partials,
                                 int max_blocks, float* sums, float* grad,
                                 const int* tile_index, int n_slots, int n_pieces,
                                 int finish_width, int tile_rows, int piece_len, float* part,
                                 int n_rows, int n_features, void* stream) {
  using namespace photon;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  RowPassParams p{};
  p.row_ptr = row_ptr;
  p.cols = cols;
  p.vals = vals;
  p.table0 = w;
  p.shift0_dev = shift_dev;
  p.shift0_host = shift_host;
  p.offsets = offsets;
  p.labels = labels;
  p.weights = weights;
  p.out0 = g_row;
  p.partials = partials;
  p.n_rows = n_rows;
  p.n_features = n_features;
  int grid = 0;
  cudaError_t err;
  switch (loss) {
    case kLogistic:
      err = launch_row_pass<ValueGradEpilogue<Logistic>>(p, max_blocks, s, &grid);
      break;
    case kSquared:
      err = launch_row_pass<ValueGradEpilogue<Squared>>(p, max_blocks, s, &grid);
      break;
    case kPoisson:
      err = launch_row_pass<ValueGradEpilogue<Poisson>>(p, max_blocks, s, &grid);
      break;
    case kSmoothedHinge:
      err = launch_row_pass<ValueGradEpilogue<SmoothedHinge>>(p, max_blocks, s, &grid);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return err;
  if ((err = launch_finish<2>(partials, grid, sums, s)) != cudaSuccess) return err;
  return photon_csc_scatter(csc_rows, csc_vals, tile_index, n_slots, n_pieces, finish_width,
                            tile_rows, piece_len, g_row, grad, part, n_rows, n_features, 0,
                            stream);
}
