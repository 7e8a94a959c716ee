// Fused GLM value and gradient on Hopper (sm_90a), with z = X.w + shift + offsets:
//   (sum_i wgt_i*l(z_i, y_i),  sum_i wgt_i*l'(z_i, y_i)*x_i,  sum_i wgt_i*l'(z_i, y_i))
//
// Replaces the TPU kernel `_value_grad_kernel` (photon_ml_tpu/ops/tiled.py:219,
// built by `_value_grad_call` at :399), templated on the loss as it is. The
// TPU kernel gathers, scatters and accumulates across a sequential grid in one
// pass. Hopper blocks run in no order, and a scatter by row would need float
// atomics, whose order changes from run to run. So the function is the
// tile-fused pass of tile_fused.cuh and its finish, two hand-written
// launches with every sum in a fixed order: per row tile, the row pass
// gathers w and applies the loss, keeping g_i = wgt_i*l'(z_i) in shared
// memory, and the tile's slot-ordered CSC span is summed against that g;
// the finish adds each feature's parts and the blocks' partial sums.
//
// Bound: bytes. The function must read the CSR slots once (8 bytes per
// nonzero), row_ptr, labels, weights, offsets and w, and write the gradient:
// ~176 bytes per row at 20 nonzeros. This design also reads the CSC slots
// once (8 bytes per nonzero), the tile index (off and part_at, 8 bytes a
// slot) and writes and reads one part per segment: about twice the bound,
// the price of deterministic sums without float atomics. g never leaves
// the chip.

#include "losses.cuh"
#include "tile_fused.cuh"

namespace photon {
namespace {

template <class Loss>
struct ValueGradEpilogue {
  static constexpr int kTables = 1;
  static constexpr int kSums = 2;
  static __device__ __forceinline__ float row_value(const RowPassParams& p, int row, float a0,
                                                    float, float* part) {
    const float z = a0 + __ldg(p.offsets + row);
    const float y = __ldg(p.labels + row);
    const float wgt = __ldg(p.weights + row);
    const float g = wgt * Loss::dz(z, y);
    part[0] += wgt * Loss::loss(z, y);
    part[1] += g;
    return g;
  }
};

}  // namespace
}  // namespace photon

// sums[0] = sum wgt*l, sums[1] = sum wgt*l'; grad[F]; partials[2*max_blocks]
// and part (one float per part) are scratch the caller allocates; the tile
// index is tiles.cuh's, over csc_rows/csc_vals in its slot order.
extern "C" int photon_value_grad(const int* row_ptr, const int* cols, const float* vals,
                                 const int* csc_rows, const float* csc_vals,
                                 const float* labels, const float* weights,
                                 const float* offsets, const float* w, const float* shift_dev,
                                 float shift_host, int loss, float* partials, int max_blocks,
                                 float* sums, float* grad, const int* tile_index, int n_slots,
                                 int n_pieces, int finish_width, int tile_rows, int piece_len,
                                 float* part, int n_rows, int n_features, void* stream) {
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
  p.partials = partials;
  p.n_rows = n_rows;
  p.n_features = n_features;
  const TileFusedParams tp = tile_fused_params(p, csc_rows, csc_vals, tile_index, n_slots,
                                               n_pieces, tile_rows, piece_len, part);
  switch (loss) {
    case kLogistic:
      return run_tile_fused<ValueGradEpilogue<Logistic>>(tp, max_blocks, finish_width, sums,
                                                         grad, s);
    case kSquared:
      return run_tile_fused<ValueGradEpilogue<Squared>>(tp, max_blocks, finish_width, sums, grad,
                                                        s);
    case kPoisson:
      return run_tile_fused<ValueGradEpilogue<Poisson>>(tp, max_blocks, finish_width, sums, grad,
                                                        s);
    case kSmoothedHinge:
      return run_tile_fused<ValueGradEpilogue<SmoothedHinge>>(tp, max_blocks, finish_width, sums,
                                                              grad, s);
    default:
      return cudaErrorInvalidValue;
  }
}
