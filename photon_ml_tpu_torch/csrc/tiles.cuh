// The row-tile index of the CSC mirror (ops/csr.py `scatter_tiles`), read by
// the scatter (scatter.cu) and the tile-fused passes (tile_fused.cuh), and
// the fixed-order sum of each feature's parts that finishes both.
//
// The index is one int32 array: start [slots] (the mirror position where each
// slot's segment begins: off[s] on a mirror in slot order), off [slots + 1]
// (the prefix sum of segment lengths in slot order), tile_group [T + 1] (each
// tile's first group), piece_ptr [groups + 1] (each group's first piece),
// feat_ptr [F + 1] (each feature's first part), piece_group [pieces] (each
// piece's group) and part_at [slots] (the place of the part of each slot's
// segment in the first piece it meets; its parts in later pieces follow).

#pragma once

#include <cuda_runtime.h>

#include "segments.cuh"

namespace photon {
namespace {

struct TileIndex {
  const int* start;        // [slots]
  const int* off;          // [slots + 1]
  const int* tile_group;   // [T + 1]
  const int* piece_ptr;    // [groups + 1]
  const int* feat_ptr;     // [F + 1]
  const int* piece_group;  // [pieces]
  const int* part_at;      // [slots]
};

inline TileIndex tile_index_view(const int* index, int n_slots, int n_pieces, int n_tiles,
                                 int n_features) {
  const size_t slots = static_cast<size_t>(n_slots);
  const int* tile_group = index + 2 * slots + 1;
  const int* piece_ptr = tile_group + n_tiles + 1;
  const int* feat_ptr = piece_ptr + slots / 32 + 1;
  const int* piece_group = feat_ptr + n_features + 1;
  return TileIndex{index,    index + slots, tile_group, piece_ptr,
                   feat_ptr, piece_group,   piece_group + n_pieces};
}

// A lane's share of work piece q (a group of 32 slots, or one piece_len
// slice of it): its slot's segment clipped to the piece, positions
// [lo, hi) of the slot order, and, where that is not empty, the place of
// its part. piece_item is lane j's share; piece_lane the calling lane's.
struct PieceLane {
  int slot;
  int s_lo;  // off[slot], where the whole segment begins
  int lo;
  int hi;
  int part;
};

__device__ __forceinline__ PieceLane piece_item(const TileIndex& ix, int q, int j,
                                                int piece_len) {
  const int g = __ldg(ix.piece_group + q);
  const int slot = g * 32 + j;
  const int sub = q - __ldg(ix.piece_ptr + g);
  const int g_lo = __ldg(ix.off + g * 32);
  const int c0 = g_lo + sub * piece_len;
  const int c1 = min(c0 + piece_len, __ldg(ix.off + g * 32 + 32));
  const int s_lo = __ldg(ix.off + slot);
  const int lo = min(max(s_lo, c0), c1);
  const int hi = min(max(__ldg(ix.off + slot + 1), c0), c1);
  const int part = lo < hi ? __ldg(ix.part_at + slot) + sub - (s_lo - g_lo) / piece_len : -1;
  return PieceLane{slot, s_lo, lo, hi, part};
}

__device__ __forceinline__ PieceLane piece_lane(const TileIndex& ix, int q, int piece_len) {
  return piece_item(ix, q, static_cast<int>(threadIdx.x & 31), piece_len);
}

// finish_width is a power of two, at most 32 (the lanes of one feature)
inline bool valid_finish_width(int width) {
  return width >= 1 && width <= 32 && (width & (width - 1)) == 0;
}

// out[f] = the sum of f's parts part[feat_ptr[f]], ..., in order, by `width`
// lanes: lane i takes parts i, i + width, ..., and the lanes' sums meet in a
// fixed shuffle tree. Thread t of the grid of kFinishThreads-thread blocks
// serves feature t / width.
__device__ __forceinline__ void sum_parts(const int* __restrict__ feat_ptr,
                                          const float* __restrict__ part,
                                          float* __restrict__ out, int n_features, int width) {
  const long long thread = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const long long f = thread / width;
  const int sub = static_cast<int>(thread % width);
  float s = 0.0f;
  if (f < n_features) {
    const int end = __ldg(feat_ptr + f + 1);
    for (int k = __ldg(feat_ptr + f) + sub; k < end; k += width) s += part[k];
  }
  for (int o = width / 2; o > 0; o >>= 1) s += __shfl_xor_sync(kFullMask, s, o);
  if (f < n_features && sub == 0) out[f] = s;
}

// blocks of kFinishThreads threads that sum_parts needs for n_features
inline unsigned finish_blocks(int n_features, int width) {
  const long long threads = static_cast<long long>(n_features) * width;
  return static_cast<unsigned>((threads + kFinishThreads - 1) / kFinishThreads);
}

}  // namespace
}  // namespace photon
