// Rows read by lane groups, one edge a group: the layout of sddmm
// (spmm_ops.cu) and gather_pair_bwd (spmm_bwd.cu).
//
// Both kernels give one warp a node's CSR segment and take its edges in
// chunks of up to 32, whose ids one coalesced load brings.  A segment of
// more than kLongSegment edges (the packed graph's pad node has 160 in
// each direction) is instead walked by the eight warps of a block of its
// own, warp w taking chunks w, w + 8, ...; those blocks come first in the
// grid, so that no long walk is left for the grid's last wave, and the
// plan lists their nodes (ops/cuda/spmm.py::EdgePlan.long_seg).
//
// A row of `width` elements of T is read as `row` items of N elements, an
// item being item_bytes = N * sizeof(T) bytes, a power of two from
// sizeof(T) to 16: the widest that divides the row's bytes and every
// table's base address (ops/cuda/spmm.py::row_launch picks it, the host
// functions check it).  A group of 2^log_lanes lanes takes one edge, lane
// c of the group holding items c, c + lanes, ... of its rows (at most
// kMaxRowItems), so neighbouring lanes read neighbouring pieces of a row
// and one warp instruction reads whole rows of several edges.  Each group
// loads the rows of edges_in_flight edges before it uses any of them: as
// many as fit kFlightBytes a lane, which keeps the kernels' registers low
// enough for many warps on each SM; at the fullevent widths that is one
// edge a group, 4 a warp (PERF.md).

#pragma once

#include "common.cuh"

namespace gnn {

constexpr int kMaxWidth = 8 * kWarp;  // elements a row, at most
constexpr int kMaxRowItems = 8;     // items a lane holds of a row, at most
constexpr int kFlightBytes = 16;    // row bytes a lane has in flight
// Segments longer than this are walked by a block (ops/cuda/spmm.py::
// LONG_SEGMENT).
constexpr int kLongSegment = 32;

// Edges a group keeps in flight when each lane holds kI items of
// kItemBytes: 1 to 8, within kFlightBytes a lane.
template <int kI, int kItemBytes>
__host__ __device__ constexpr int edges_in_flight() {
  constexpr int u = kFlightBytes / (kI * kItemBytes);
  return u < 1 ? 1 : u > 8 ? 8 : u;
}

// Where a warp's walk over a segment starts and how far apart its chunks
// of kWarp edges lie: the whole segment for a warp that owns it, else (a
// long segment's block) chunks warp, warp + 8, ...
struct Walk {
  int first, stride;

  __device__ static Walk of(int beg, bool whole) {
    const int warp = threadIdx.x / kWarp;
    return whole ? Walk{beg, kWarp}
                 : Walk{beg + warp * kWarp, kWarpsPerBlock * kWarp};
  }
};

// Host side.

// One call's rows: `width` elements of `elem` bytes as items of
// item_bytes, in groups of 2^log_lanes lanes.
struct RowItems {
  int width, elem, item_bytes, log_lanes;

  int per_item() const { return item_bytes / elem; }
  int row() const { return width / per_item(); }
  int per_lane() const {
    return (row() + (1 << log_lanes) - 1) >> log_lanes;
  }

  // 0, or cudaErrorInvalidValue unless the item is a power of two from
  // elem to 16 bytes that divides the row and every base address in
  // `ptrs`, the width is at most kMaxWidth and a group of at most 32 lanes
  // holds a row in at most kMaxRowItems items a lane.
  int check(const void* const* ptrs, int n_ptrs) const {
    const bool item_ok = (item_bytes == 2 || item_bytes == 4 ||
                          item_bytes == 8 || item_bytes == 16) &&
                         item_bytes >= elem;
    if (!item_ok || width < 0 || width > kMaxWidth ||
        width % per_item() != 0 || log_lanes < 0 || log_lanes > 5 ||
        per_lane() > kMaxRowItems)
      return static_cast<int>(cudaErrorInvalidValue);
    for (int i = 0; i < n_ptrs; ++i)
      if (!aligned_to(ptrs[i], item_bytes))
        return static_cast<int>(cudaErrorInvalidValue);
    return 0;
  }
};

template <typename T, int N, int kI>
struct Rows {
  using type = T;
  using Item = Vec<T, N>;
  static constexpr int n = N;
  static constexpr int items = kI;
};

template <typename T, int N, typename Launch>
int with_items(int per_lane, Launch launch) {
  if (per_lane <= 1) return launch(Rows<T, N, 1>{});
  if (per_lane <= 2) return launch(Rows<T, N, 2>{});
  if (per_lane <= 4) return launch(Rows<T, N, 4>{});
  if (per_lane <= 5) return launch(Rows<T, N, 5>{});
  return launch(Rows<T, N, 8>{});
}

// Calls launch(Rows<T, N, kI>{}) for dtype (0 = float32, 1 = bfloat16),
// the item of `ri` and kI in {1, 2, 4, 5, 8} items a lane (5: the 33-item
// rows of the fullevent D = 66 on 8 lanes); `ri` checked.
template <typename Launch>
int dispatch_rows(int dtype, const RowItems& ri, Launch launch) {
  const int k = ri.per_lane();
  if (dtype == 0) {
    if (ri.item_bytes == 4) return with_items<float, 1>(k, launch);
    if (ri.item_bytes == 8) return with_items<float, 2>(k, launch);
    return with_items<float, 4>(k, launch);
  }
  if (ri.item_bytes == 2) return with_items<__nv_bfloat16, 1>(k, launch);
  if (ri.item_bytes == 4) return with_items<__nv_bfloat16, 2>(k, launch);
  if (ri.item_bytes == 8) return with_items<__nv_bfloat16, 4>(k, launch);
  return with_items<__nv_bfloat16, 8>(k, launch);
}

}  // namespace gnn
