// Rows read by lane groups, one edge a group: the layout of sddmm
// (spmm_ops.cu), gather_pair_bwd and aggregate_pair_bwd (spmm_bwd.cu) and
// aggregate_pair (spmm.cu).
//
// The kernels give one warp a node's CSR segment and take its edges in
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
// kItemBytes for each of them: 1 to 8, within kFlightBytes a lane.
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

template <int kI, int N>
__device__ __forceinline__ void zero(float (&acc)[kI][N]) {
#pragma unroll
  for (int i = 0; i < kI; ++i)
#pragma unroll
    for (int q = 0; q < N; ++q) acc[i][q] = 0.f;
}

// Adds to a group's acc the rows its walk over a segment ending at `end`
// reaches: row side.oth[j] of tab for each sorted position j, times the
// weight w[side.w_idx[j]] when kWeighted.  A chunk's edge k goes to group
// k % groups, and each group adds its edges in order, the products as
// fmaf(weight, element, sum).
template <bool kWeighted, int kI, typename T, int N>
__device__ __forceinline__ void sum_rows(float (&acc)[kI][N],
                                         const Vec<T, N>* __restrict__ tab,
                                         const float* __restrict__ w,
                                         const Side& side, const Walk& walk,
                                         int end, int row, const Lanes& ln) {
  constexpr int kU = edges_in_flight<kI, sizeof(Vec<T, N>)>();
  for (int base = walk.first; base < end; base += walk.stride) {
    const int cnt = min(kWarp, end - base);
    const bool mine = ln.lane < cnt;
    const int r_l = mine ? side.oth[base + ln.lane] : 0;
    float w_l = 0.f;
    if constexpr (kWeighted) w_l = mine ? w[side.w_idx[base + ln.lane]] : 0.f;
    for (int k0 = 0; k0 < cnt; k0 += ln.groups * kU) {
      Vec<T, N> rows[kU][kI];
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        const int k = k0 + u * ln.groups + ln.group;
        // the same on every lane: whether the warp has edges left
        if (k0 + u * ln.groups < cnt) {
          const long r = __shfl_sync(kFull, r_l, k & (kWarp - 1));
          if (k < cnt) load_row_items(rows[u], tab, r, row, ln);
        }
      }
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        const int k = k0 + u * ln.groups + ln.group;
        if (k0 + u * ln.groups >= cnt) continue;  // on every lane alike
        // the weights are shuffled once the rows are on their way, so
        // that their loads do not hold the rows back
        float wk = 1.f;
        if constexpr (kWeighted)
          wk = __shfl_sync(kFull, w_l, k & (kWarp - 1));
        if (k >= cnt) continue;
#pragma unroll
        for (int i = 0; i < kI; ++i) {
          if (ln.c0 + i * ln.lanes >= row) continue;
#pragma unroll
          for (int q = 0; q < N; ++q) {
            const float x = to_f32(rows[u][i].v[q]);
            if constexpr (kWeighted)
              acc[i][q] = fmaf(wk, x, acc[i][q]);
            else
              acc[i][q] += x;
          }
        }
      }
    }
  }
}

// Group 0 of a warp stores its row (summed over the groups) to `out`.
template <int kI, typename T, int N>
__device__ __forceinline__ void store_row_items(Vec<T, N>* __restrict__ out,
                                                const float (&acc)[kI][N],
                                                int row, const Lanes& ln) {
  if (ln.group != 0) return;
#pragma unroll
  for (int i = 0; i < kI; ++i) {
    const int c = ln.c0 + i * ln.lanes;
    if (c < row) out[c] = pack<T>(acc[i]);
  }
}

// Group 0 of a warp writes its row's f32 values to `part`.
template <int kI, int N>
__device__ __forceinline__ void put_row(float* part,
                                        const float (&acc)[kI][N], int row,
                                        const Lanes& ln) {
  if (ln.group != 0) return;
#pragma unroll
  for (int i = 0; i < kI; ++i) {
    const int c = ln.c0 + i * ln.lanes;
    if (c < row)
#pragma unroll
      for (int q = 0; q < N; ++q) part[c * N + q] = acc[i][q];
  }
}

// Column `col` of the rows the block's warps put, added in warp order.
__device__ __forceinline__ float warp_order_sum(
    const float (&part)[kWarpsPerBlock][kMaxWidth], int col) {
  float sum = part[0][col];
#pragma unroll
  for (int w = 1; w < kWarpsPerBlock; ++w) sum += part[w][col];
  return sum;
}

// Each (node, direction)'s sum of the rows its segment reaches, written
// once to its row of out_recv (the recv plan's segments) or out_send:
// aggregate_pair (kWeighted: h's rows at the other endpoints times the
// edge weights) and gather_pair_bwd (g's rows in edge order, unweighted).
// Blocks [0, n_recv_long) walk the recv plan's long segments, the next
// n_send_long the send plan's; the warps of the blocks after them own one
// (node, direction) each, a node's two side by side, so that a row both
// read (an edge's row of g) is found in L2 the second time.  Each group
// sums its edges in order in f32 registers; the groups' rows are added in
// a fixed order (sum_groups) before the one store, and a long segment's
// warps' rows then in warp order.
template <typename T, int N, int kI, bool kWeighted>
__global__ void __launch_bounds__(kThreads)
segment_rows_kernel(int n_node, int row, int log_lanes,
                    const Vec<T, N>* __restrict__ tab,
                    const float* __restrict__ w, Side recv, Side send,
                    const int32_t* __restrict__ recv_long, int n_recv_long,
                    const int32_t* __restrict__ send_long, int n_send_long,
                    Vec<T, N>* __restrict__ out_recv,
                    Vec<T, N>* __restrict__ out_send) {
  const Lanes ln(log_lanes);
  const int warp = threadIdx.x / kWarp;
  const int n_long = n_recv_long + n_send_long;
  const bool whole = static_cast<int>(blockIdx.x) >= n_long;
  bool by_send;
  long n;
  if (whole) {
    const long gw =
        static_cast<long>(blockIdx.x - n_long) * kWarpsPerBlock + warp;
    if (gw >= 2L * n_node) return;
    by_send = gw & 1;
    n = gw >> 1;
  } else {
    by_send = static_cast<int>(blockIdx.x) >= n_recv_long;
    n = by_send ? send_long[blockIdx.x - n_recv_long] : recv_long[blockIdx.x];
  }
  const Side side = by_send ? send : recv;
  const int beg = side.seg_ptr[n], end = side.seg_ptr[n + 1];
  if (whole && end - beg > kLongSegment) return;   // its block takes it
  float acc[kI][N];
  zero(acc);
  sum_rows<kWeighted>(acc, tab, w, side, Walk::of(beg, whole), end, row, ln);
  sum_groups(acc, ln.lanes);
  Vec<T, N>* out = (by_send ? out_send : out_recv) + n * row;
  if (whole) {
    store_row_items(out, acc, row, ln);
    return;
  }
  __shared__ float part[kWarpsPerBlock][kMaxWidth];
  put_row(part[warp], acc, row, ln);
  __syncthreads();
  T* flat = reinterpret_cast<T*>(out);
  for (int col = threadIdx.x; col < row * N; col += kThreads)
    flat[col] = from_f32<T>(warp_order_sum(part, col));
}

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
// rows of the fullevent D = 66 on 8 lanes), after checking `ri` against
// the n_ptrs tables at `ptrs` (RowItems::check) and that n_node and the
// long-segment counts are not negative.
template <typename Launch>
int dispatch_rows(int dtype, int n_node, const RowItems& ri,
                  const void* const* ptrs, int n_ptrs, int n_recv_long,
                  int n_send_long, Launch launch) {
  if (n_node < 0 || n_recv_long < 0 || n_send_long < 0 ||
      (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const int err = ri.check(ptrs, n_ptrs);
  if (err != 0) return err;
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

// Launches segment_rows_kernel<..., kWeighted> over `tab` (the rows of
// ri, checked with the outputs) with the two plans' long-segment lists.
template <bool kWeighted>
int launch_segment_rows(int dtype, int n_node, const RowItems& ri,
                        const void* tab, const float* w, Side recv,
                        Side send, const int32_t* recv_long, int n_recv_long,
                        const int32_t* send_long, int n_send_long,
                        void* out_recv, void* out_send, void* stream) {
  const void* rows[] = {tab, out_recv, out_send};
  const unsigned blocks =
      n_recv_long + n_send_long + blocks_for_warps(2L * n_node);
  return dispatch_rows(
      dtype, n_node, ri, rows, 3, n_recv_long, n_send_long, [&](auto v) {
        using R = decltype(v);
        using Item = typename R::Item;
        if (blocks > 0)
          segment_rows_kernel<typename R::type, R::n, R::items, kWeighted>
              <<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
                  n_node, ri.row(), ri.log_lanes,
                  static_cast<const Item*>(tab), w, recv, send, recv_long,
                  n_recv_long, send_long, n_send_long,
                  static_cast<Item*>(out_recv), static_cast<Item*>(out_send));
        return static_cast<int>(cudaGetLastError());
      });
}

}  // namespace gnn
