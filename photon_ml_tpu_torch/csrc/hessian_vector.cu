// Hessian-vector products of the GLM objective on Hopper (sm_90a), returning
// the raw feature-space scatter sum_i q_i*x_i and sum_i q_i:
//
//   hv:     z = X.w + shift0 + offsets, u = X.v + shift1, q = wgt*l''(z, y)*u
//           (replaces `_hv_kernel`, photon_ml_tpu/ops/tiled.py:251, built by
//           `_hv_call` at :366; templated on the loss as it is)
//   hv_at:  u = X.v + shift, q = d2*u with the row curvature d2 = wgt*l''(z)
//           computed once per TRON step (replaces `_hv_at_kernel`,
//           photon_ml_tpu/ops/tiled.py:284, built by `_hv_at_call` at :382)
//
// Every sum is in a fixed order, with no float atomics. Both are the
// tile-fused pass of tile_fused.cuh and its finish, two launches: per row
// tile the row pass keeps q in shared memory (hv gathers w and v in one
// sweep of the slots) and the tile's slot-ordered CSC span is summed against
// it; q never leaves the chip.
//
// Bound: bytes. Per call the function must read the CSR slots once (8 bytes
// per nonzero), row_ptr, the tables and the per-row inputs, and write the
// result: ~176 bytes per row for hv and ~168 for hv_at at 20 nonzeros.
// This design also reads the CSC slots once, the tile index (off and
// part_at, 8 bytes a slot) and writes and reads one part per segment, about
// twice the bound.

#include "losses.cuh"
#include "tile_fused.cuh"

namespace photon {
namespace {

template <class Loss>
struct HvEpilogue {
  static constexpr int kTables = 2;
  static constexpr int kSums = 1;
  static __device__ __forceinline__ float row_value(const RowPassParams& p, int row, float a0,
                                                    float a1, float* part) {
    const float z = a0 + __ldg(p.offsets + row);
    const float q = __ldg(p.weights + row) * Loss::d2z(z, __ldg(p.labels + row)) * a1;
    part[0] += q;
    return q;
  }
};

struct HvAtEpilogue {
  static constexpr int kTables = 1;
  static constexpr int kSums = 1;
  static __device__ __forceinline__ float row_value(const RowPassParams& p, int row, float a0,
                                                    float, float* part) {
    const float q = __ldg(p.d2 + row) * a0;
    part[0] += q;
    return q;
  }
};

}  // namespace
}  // namespace photon

// sums[0] = sum q; hv[F]; partials[max_blocks] and part (one float per
// part) are scratch the caller allocates; the tile index is tiles.cuh's, over
// csc_rows/csc_vals in its slot order. The loss is logistic, squared or
// Poisson.
extern "C" int photon_hessian_vector(const int* row_ptr, const int* cols, const float* vals,
                                     const int* csc_rows, const float* csc_vals,
                                     const float* labels, const float* weights,
                                     const float* offsets, const float* w, const float* v,
                                     const float* shift0_dev, float shift0_host,
                                     const float* shift1_dev, float shift1_host, int loss,
                                     float* partials, int max_blocks, float* sums, float* hv,
                                     const int* tile_index, int n_slots, int n_pieces,
                                     int finish_width, int tile_rows, int piece_len,
                                     float* part, int n_rows, int n_features, void* stream) {
  using namespace photon;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  RowPassParams p{};
  p.row_ptr = row_ptr;
  p.cols = cols;
  p.vals = vals;
  p.table0 = w;
  p.table1 = v;
  p.shift0_dev = shift0_dev;
  p.shift0_host = shift0_host;
  p.shift1_dev = shift1_dev;
  p.shift1_host = shift1_host;
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
      return run_tile_fused<HvEpilogue<Logistic>>(tp, max_blocks, finish_width, sums, hv, s);
    case kSquared:
      return run_tile_fused<HvEpilogue<Squared>>(tp, max_blocks, finish_width, sums, hv, s);
    case kPoisson:
      return run_tile_fused<HvEpilogue<Poisson>>(tp, max_blocks, finish_width, sums, hv, s);
    default:
      return cudaErrorInvalidValue;
  }
}

// sums[0] = sum q; hv[F]; partials[max_blocks] and part (one float per
// part) are scratch the caller allocates; the tile index is tiles.cuh's, over
// csc_rows/csc_vals in its slot order.
extern "C" int photon_hv_at(const int* row_ptr, const int* cols, const float* vals,
                            const int* csc_rows, const float* csc_vals, const float* d2,
                            const float* v, const float* shift_dev, float shift_host,
                            float* partials, int max_blocks, float* sums, float* hv,
                            const int* tile_index, int n_slots, int n_pieces, int finish_width,
                            int tile_rows, int piece_len, float* part, int n_rows,
                            int n_features, void* stream) {
  using namespace photon;
  RowPassParams p{};
  p.row_ptr = row_ptr;
  p.cols = cols;
  p.vals = vals;
  p.table0 = v;
  p.shift0_dev = shift_dev;
  p.shift0_host = shift_host;
  p.d2 = d2;
  p.partials = partials;
  p.n_rows = n_rows;
  p.n_features = n_features;
  const TileFusedParams tp = tile_fused_params(p, csc_rows, csc_vals, tile_index, n_slots,
                                               n_pieces, tile_rows, piece_len, part);
  return run_tile_fused<HvAtEpilogue>(tp, max_blocks, finish_width, sums, hv,
                                      static_cast<cudaStream_t>(stream));
}
