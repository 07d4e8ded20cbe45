// Helpers shared by the fused iteration kernels, forward (iteration_fwd.cu)
// and backward (iteration_bwd.cu).
//
// Their work is split two ways (ops/cuda/spmm.py):
//
// - the forward's score pass: a group of 2^log_lanes lanes takes one
//   recv-sorted edge, lane c of the group covering items c, c + lanes, ...
//   of the edge's H rows (16-byte items on the vector path), and each lane
//   keeps kEdgeUnroll edges in flight, a block's worth of groups apart, so
//   that neighbouring groups read neighbouring edges;
// - walks: one warp takes one work item of IterItems (at most ITEM_EDGES
//   sorted edges of one node and direction).  In the forward walk the D
//   rows lie across the warp (lane l: items l, l + 32, ...; element pairs
//   on the vector path) and the warp loads the ids and rows of a few edges
//   before it adds any of them; in the backward's walks a group of lanes
//   takes an edge with its H and its D rows, the groups' rows added once
//   at the end of the item in a fixed order (iteration_bwd.cu).
//
// The launch arguments (which rows take the vector path, lanes a group,
// blocks of the score pass, the backward's chunks and slots) come from
// ops/cuda/spmm.py::iteration_launch; the host functions check that they
// are safe before they launch.

#pragma once

#include <type_traits>

#include "common.cuh"

namespace gnn {

constexpr int kEdgeUnroll = 4;

// Items first + i * stride (i < kI) of an f32 accumulator row: to `row`
// in T when `slot` < 0, else to row `slot` of the f32 partials.
template <int kI, typename T, int N>
__device__ __forceinline__ void store_items(const float (&src)[kI][N],
                                            Vec<T, N>* row, int slot,
                                            Vec<float, N>* partial,
                                            int n_items, int first,
                                            int stride) {
#pragma unroll
  for (int i = 0; i < kI; ++i) {
    const int c = first + i * stride;
    if (c >= n_items) continue;
    if (slot < 0) {
      row[c] = pack<T>(src[i]);
    } else {
      Vec<float, N> p;
#pragma unroll
      for (int q = 0; q < N; ++q) p.v[q] = src[i][q];
      partial[static_cast<long>(slot) * n_items + c] = p;
    }
  }
}

// Host side.

// The shapes of one fused iteration call and which rows take the vector
// path: H rows (pa, pb, w2, b1 and their gradients) as items of h_bytes
// (16 in the forward, 16 or 8 in the backward) when vec_h, D rows (h,
// g_mi, g_mo, mi, mo, dh) as element pairs when vec_d; else one element
// an item.
struct IterShape {
  long n_edge;
  int d, hdim, vec_h, vec_d, elem, h_bytes = 16;

  int nh() const { return vec_h ? h_bytes / elem : 1; }
  int row_h() const { return hdim / nh(); }
  int row_d() const { return vec_d ? d / 2 : d; }

  // 0, or cudaErrorInvalidValue for arguments the kernels do not take:
  // widths outside [1, 256], or a vector path the widths or the pointers
  // do not allow.
  int check(const void* const* h_rows, int n_h, const void* const* d_rows,
            int n_d) const {
    if (d < 1 || d > 8 * kWarp || hdim < 1 || hdim > 8 * kWarp ||
        n_edge < 0 || (vec_h && hdim % nh() != 0) || (vec_d && d % 2 != 0))
      return static_cast<int>(cudaErrorInvalidValue);
    for (int i = 0; vec_h && i < n_h; ++i)
      if (!aligned_to(h_rows[i], h_bytes))
        return static_cast<int>(cudaErrorInvalidValue);
    for (int i = 0; vec_d && i < n_d; ++i)
      if (!aligned_to(d_rows[i], 2 * elem))
        return static_cast<int>(cudaErrorInvalidValue);
    return 0;
  }

  // 0, or cudaErrorInvalidValue unless groups of 2^log_lanes lanes (at
  // most 32) hold an H row, and with `d_rows` a D row too, with at most 8
  // items a lane.
  int check_lanes(int log_lanes, bool d_rows = false) const {
    const auto fits = [&](int row) {
      return (row + (1 << log_lanes) - 1) >> log_lanes <= 8;
    };
    const bool ok = log_lanes >= 0 && log_lanes <= 5 && fits(row_h()) &&
                    (!d_rows || fits(row_d()));
    return ok ? 0 : static_cast<int>(cudaErrorInvalidValue);
  }

  // 0, or cudaErrorInvalidValue unless, as check_lanes, an edge pass of
  // 2^log_lanes lanes an edge in `blocks` blocks covers every edge.
  int check_edge_pass(int log_lanes, int blocks) const {
    if (check_lanes(log_lanes) != 0 || blocks < 0 ||
        static_cast<long>(blocks) * (kThreads >> log_lanes) * kEdgeUnroll <
            n_edge)
      return static_cast<int>(cudaErrorInvalidValue);
    return 0;
  }
};

}  // namespace gnn
