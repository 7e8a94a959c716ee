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
// As in value_grad.cu, each is three hand-written launches with every sum in
// a fixed order and no float atomics: the row pass (rowpass.cuh) writes q and
// per-block partials of sum q, finish_sums_kernel adds the partials, and
// scatter.cu sums q over the CSC mirror.
//
// Bound: bytes. Per call the function must read the slots once (8 bytes per
// nonzero), row_ptr, the tables and the per-row inputs, and write the result:
// ~176 bytes per row for hv and ~168 for hv_at at 20 nonzeros. The CSC pass
// and the round trip of q put this design's own floor at about twice that.

#include "losses.cuh"
#include "rowpass.cuh"

namespace photon {
namespace {

template <class Loss>
struct HvEpilogue {
  static constexpr int kTables = 2;
  static constexpr int kSums = 1;
  static __device__ __forceinline__ void apply(const RowPassParams& p, int row, float a0,
                                               float a1, float* part) {
    const float z = a0 + __ldg(p.offsets + row);
    const float q = __ldg(p.weights + row) * Loss::d2z(z, __ldg(p.labels + row)) * a1;
    p.out0[row] = q;
    part[0] += q;
  }
};

struct HvAtEpilogue {
  static constexpr int kTables = 1;
  static constexpr int kSums = 1;
  static __device__ __forceinline__ void apply(const RowPassParams& p, int row, float a0,
                                               float, float* part) {
    const float q = __ldg(p.d2 + row) * a0;
    p.out0[row] = q;
    part[0] += q;
  }
};

struct ScatterArgs {
  const int* csc_rows;
  const float* csc_vals;
  const int* tile_index;
  int n_slots;
  int n_pieces;
  int finish_width;
  int tile_rows;
  int piece_len;
  float* part;
};

cudaError_t finish(const RowPassParams& p, int grid, const ScatterArgs& c, float* sums,
                   float* hv, cudaStream_t s) {
  cudaError_t err = launch_finish<1>(p.partials, grid, sums, s);
  if (err != cudaSuccess) return err;
  return static_cast<cudaError_t>(photon_csc_scatter(
      c.csc_rows, c.csc_vals, c.tile_index, c.n_slots, c.n_pieces, c.finish_width, c.tile_rows,
      c.piece_len, p.out0, hv, c.part, p.n_rows, p.n_features, 0, s));
}

}  // namespace
}  // namespace photon

// sums[0] = sum q; hv[F]; q_row[n], partials[max_blocks] and part (the
// scatter's parts) are scratch the caller allocates; the tile index is
// photon_csc_scatter's. The loss is logistic, squared or Poisson.
extern "C" int photon_hessian_vector(const int* row_ptr, const int* cols, const float* vals,
                                     const int* csc_rows, const float* csc_vals,
                                     const float* labels, const float* weights,
                                     const float* offsets, const float* w, const float* v,
                                     const float* shift0_dev, float shift0_host,
                                     const float* shift1_dev, float shift1_host, int loss,
                                     float* q_row, float* partials, int max_blocks, float* sums,
                                     float* hv, const int* tile_index, int n_slots,
                                     int n_pieces, int finish_width, int tile_rows,
                                     int piece_len, float* part, int n_rows, int n_features,
                                     void* stream) {
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
  p.out0 = q_row;
  p.partials = partials;
  p.n_rows = n_rows;
  p.n_features = n_features;
  int grid = 0;
  cudaError_t err;
  switch (loss) {
    case kLogistic:
      err = launch_row_pass<HvEpilogue<Logistic>>(p, max_blocks, s, &grid);
      break;
    case kSquared:
      err = launch_row_pass<HvEpilogue<Squared>>(p, max_blocks, s, &grid);
      break;
    case kPoisson:
      err = launch_row_pass<HvEpilogue<Poisson>>(p, max_blocks, s, &grid);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return err;
  const ScatterArgs c{csc_rows,     csc_vals,  tile_index, n_slots, n_pieces,
                      finish_width, tile_rows, piece_len,  part};
  return finish(p, grid, c, sums, hv, s);
}

extern "C" int photon_hv_at(const int* row_ptr, const int* cols, const float* vals,
                            const int* csc_rows, const float* csc_vals, const float* d2,
                            const float* v, const float* shift_dev, float shift_host,
                            float* q_row, float* partials, int max_blocks, float* sums, float* hv,
                            const int* tile_index, int n_slots, int n_pieces, int finish_width,
                            int tile_rows, int piece_len, float* part, int n_rows,
                            int n_features, void* stream) {
  using namespace photon;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  RowPassParams p{};
  p.row_ptr = row_ptr;
  p.cols = cols;
  p.vals = vals;
  p.table0 = v;
  p.shift0_dev = shift_dev;
  p.shift0_host = shift_host;
  p.d2 = d2;
  p.out0 = q_row;
  p.partials = partials;
  p.n_rows = n_rows;
  p.n_features = n_features;
  int grid = 0;
  cudaError_t err = launch_row_pass<HvAtEpilogue>(p, max_blocks, s, &grid);
  if (err != cudaSuccess) return err;
  const ScatterArgs c{csc_rows,     csc_vals,  tile_index, n_slots, n_pieces,
                      finish_width, tile_rows, piece_len,  part};
  return finish(p, grid, c, sums, hv, s);
}
