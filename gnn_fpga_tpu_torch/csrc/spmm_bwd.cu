// Hand-written Hopper kernels for the backward of the SegmentClassifier's
// unfused message passing: the vector-Jacobian products of spmm.cu's
// aggregation and of the final edge layer's endpoint gather.  The fused
// iteration's backward is iteration_bwd.cu.
//
// Forward functions (spmm.cu, ops/cuda/spmm.py::gather_pair):
//
//     mi[n]  = sum_{r==n} w[e] h[s],  mo[n] = sum_{s==n} w[e] h[r]
//     out[e] = pa[s] + pb[r]
//
// Design, shared by the two kernels (rows.cuh).  The edges come in the
// recv-sorted and send-sorted CSR plans of the forward.  Warps own a node's
// segments and sum every contribution to the node's gradient rows in f32
// registers, a lane group an edge, and the rows are written once: no
// atomics, no zero-fill, and results are identical from run to run.  A
// value that belongs to one edge (dw) is computed on the recv side only,
// so each edge counts once.  Segments of more than kLongSegment edges go
// to blocks of their own at the front of the grid.  Tables are T = float
// or __nv_bfloat16, edge weights f32; outputs are written in T except dw
// (f32, as w).
//
// Interface: plain C functions, loaded with ctypes.  They launch on the
// given stream, allocate nothing, and return cudaGetLastError().

#include "rows.cuh"

namespace {

using gnn::dispatch_rows;
using gnn::edges_in_flight;
using gnn::from_f32;
using gnn::group_sum;
using gnn::kFull;
using gnn::kLongSegment;
using gnn::kMaxWidth;
using gnn::kThreads;
using gnn::kWarp;
using gnn::kWarpsPerBlock;
using gnn::Lanes;
using gnn::load_row_items;
using gnn::pack;
using gnn::put_row;
using gnn::RowItems;
using gnn::Side;
using gnn::sum_groups;
using gnn::sum_rows;
using gnn::to_f32;
using gnn::Vec;
using gnn::Walk;
using gnn::warp_order_sum;
using gnn::zero;

// Waits for the two warps of pair p of a block (named barrier p + 1;
// __syncthreads takes barrier 0).
__device__ __forceinline__ void pair_sync(int pair) {
  asm volatile("bar.sync %0, %1;" ::"r"(pair + 1), "r"(2 * kWarp)
               : "memory");
}

// The recv walk of node n: adds w g_mo[o] to acc for each edge received
// from o, and writes the edge's dw = <g_mi[n], h[o]> + <g_mo[o], h[n]>
// to its EDGE-order slot.  A group holds two rows an edge (h[o], g_mo[o])
// beside n's own two, so it keeps edges in flight for two rows; each lane
// sums its items' products (for each element g_mi[n] h[o], then g_mo[o]
// h[n]), and the group adds its lanes' sums in log_lanes shuffles.
template <int kI, typename T, int N>
__device__ __forceinline__ void recv_rows(
    float (&acc)[kI][N], long n, const Vec<T, N>* __restrict__ h,
    const Vec<T, N>* __restrict__ g_mi, const Vec<T, N>* __restrict__ g_mo,
    const float* __restrict__ w, const Side& recv, const Walk& walk, int end,
    int row, const Lanes& ln, float* __restrict__ dw) {
  constexpr int kU = edges_in_flight<2 * kI, sizeof(Vec<T, N>)>();
  Vec<T, N> h_n[kI], gmi_n[kI];   // as stored: bf16 pairs take half
  load_row_items(h_n, h, n, row, ln);
  load_row_items(gmi_n, g_mi, n, row, ln);
  for (int base = walk.first; base < end; base += walk.stride) {
    const int cnt = min(kWarp, end - base);
    const bool mine = ln.lane < cnt;
    const int o_l = mine ? recv.oth[base + ln.lane] : 0;
    const int e_l = mine ? recv.w_idx[base + ln.lane] : 0;
    const float w_l = mine ? w[e_l] : 0.f;
    for (int k0 = 0; k0 < cnt; k0 += ln.groups * kU) {
      Vec<T, N> ho[kU][kI], go[kU][kI];
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        const int k = k0 + u * ln.groups + ln.group;
        // the same on every lane: whether the warp has edges left
        if (k0 + u * ln.groups < cnt) {
          const long o = __shfl_sync(kFull, o_l, k & (kWarp - 1));
          if (k < cnt) {
            load_row_items(ho[u], h, o, row, ln);
            load_row_items(go[u], g_mo, o, row, ln);
          }
        }
      }
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        const int k = k0 + u * ln.groups + ln.group;
        if (k0 + u * ln.groups >= cnt) continue;  // on every lane alike
        // shuffled once the rows are on their way (as in sum_rows)
        const float wk = __shfl_sync(kFull, w_l, k & (kWarp - 1));
        float part = 0.f;
#pragma unroll
        for (int i = 0; i < kI; ++i) {
          if (k >= cnt || ln.c0 + i * ln.lanes >= row) continue;
#pragma unroll
          for (int q = 0; q < N; ++q) {
            const float gq = to_f32(go[u][i].v[q]);
            part = fmaf(to_f32(gmi_n[i].v[q]), to_f32(ho[u][i].v[q]), part);
            part = fmaf(gq, to_f32(h_n[i].v[q]), part);
            acc[i][q] = fmaf(wk, gq, acc[i][q]);
          }
        }
        part = group_sum(part, ln.lanes);
        const int e = __shfl_sync(kFull, e_l, k & (kWarp - 1));
        if (k < cnt && ln.c0 == 0) dw[e] = part;
      }
    }
  }
}

// Replaces: gnn_fpga_tpu/ops/pallas/spmm.py::_agg_bwd_kernel (and its
// prebuilt-one-hot twin _agg_bwd_kernel_pre), the VJP of aggregate_pair:
//   dh[n] = sum_{s==n} w g_mi[r] + sum_{r==n} w g_mo[s],
//   dw[e] = <g_mi[r], h[s]> + <g_mo[s], h[r]>.
// Both walks of a node feed the same row of dh.  Blocks [0, n_recv_long)
// take the nodes of the recv plan's long segments, the next n_send_long
// those of the send plan's (a node in both lists is its recv block's; the
// other returns at once): the block's eight warps walk the node's recv
// segment, then its send segment, chunks w, w + 8, ... each.  The blocks
// after them take four nodes each, warp 2k walking node n's recv segment
// and warp 2k + 1 its send segment side by side; a node with a long
// segment either way is left to its block.  The recv walk adds w g_mo[o]
// and writes each edge's dw (recv_rows); the send walk adds w g_mi[o]
// (sum_rows, as the forward).  Each walk's groups are added in a fixed
// order (sum_groups), a long node's warps in warp order, and the node's
// row is the recv walk's row plus the send walk's, added in shared memory
// before the one store.  The recv walk holds four rows a lane (the node's
// h and g_mi, an edge's h and g_mo), so the rows are read with at most 5
// elements a lane (ops/cuda/spmm.py::AGG_BWD_LANE_ELEMS): the fullevent
// D = 66 as one-element items on 16 lanes, which keeps the kernel at 64
// registers, four blocks an SM; the forward's 5 items of 4 or 8 bytes on 8
// lanes took 97, two blocks.
//
// What bounds it on this card: not bytes.  At the fullevent shapes it
// gathers three rows per edge (h[o] and g_mo[o] on the recv side, g_mi[o]
// on the send side), 3 E D 2 B ~ 72 MB in bf16, from three 2 MB tables
// that stay in L2, against a bound that counts each table once (3.4 us);
// each warp's walk is a chain of dependent loads whose latency the
// resident warps hide, and the dw stores are scattered 4-byte writes; a
// node's send warp waits for its recv warp, which reads twice the rows.
// Measured on an NVIDIA H100 80GB HBM3 at 700 W (PERF.md): 0.043 ms in
// bf16 and 0.042 ms in f32, the same with and without the pad edges,
// against 0.070 and 0.076 for the first design (a warp a node walking
// both segments, one element a lane, a 5-step warp reduction an edge) and
// 0.060 and 0.049 on the forward's row layout.
template <typename T, int N, int kI>
__global__ void __launch_bounds__(kThreads)
agg_bwd_kernel(int n_node, int row, int log_lanes,
               const Vec<T, N>* __restrict__ h, const float* __restrict__ w,
               const Vec<T, N>* __restrict__ g_mi,
               const Vec<T, N>* __restrict__ g_mo, Side recv, Side send,
               const int32_t* __restrict__ recv_long, int n_recv_long,
               const int32_t* __restrict__ send_long, int n_send_long,
               Vec<T, N>* __restrict__ dh, float* __restrict__ dw) {
  const Lanes ln(log_lanes);
  const int warp = threadIdx.x / kWarp;
  const int n_long = n_recv_long + n_send_long;
  const bool whole = static_cast<int>(blockIdx.x) >= n_long;
  long n;
  if (whole) {
    n = static_cast<long>(blockIdx.x - n_long) * (kWarpsPerBlock / 2) +
        warp / 2;
    if (n >= n_node) return;   // both warps of the pair alike
  } else {
    n = static_cast<int>(blockIdx.x) < n_recv_long
            ? recv_long[blockIdx.x]
            : send_long[blockIdx.x - n_recv_long];
  }
  const int rb = recv.seg_ptr[n], re = recv.seg_ptr[n + 1];
  const int sb = send.seg_ptr[n], se = send.seg_ptr[n + 1];
  const bool long_recv = re - rb > kLongSegment;
  if (whole ? long_recv || se - sb > kLongSegment
            : static_cast<int>(blockIdx.x) >= n_recv_long && long_recv)
    return;   // another block takes the node
  __shared__ float part[kWarpsPerBlock][kMaxWidth];
  float acc[kI][N];
  zero(acc);
  if (whole) {
    const bool by_send = warp & 1;
    if (by_send)
      sum_rows<true>(acc, g_mi, w, send, Walk::of(sb, true), se, row, ln);
    else
      recv_rows(acc, n, h, g_mi, g_mo, w, recv, Walk::of(rb, true), re, row,
                ln, dw);
    sum_groups(acc, ln.lanes);
    if (by_send) put_row(part[warp], acc, row, ln);
    pair_sync(warp / 2);
    if (by_send || ln.group != 0) return;
#pragma unroll
    for (int i = 0; i < kI; ++i) {
      const int c = ln.c0 + i * ln.lanes;
      if (c >= row) continue;
#pragma unroll
      for (int q = 0; q < N; ++q) acc[i][q] += part[warp + 1][c * N + q];
      dh[n * row + c] = pack<T>(acc[i]);
    }
    return;
  }
  // a long node: its recv walk's row, then its send walk's
  __shared__ float recv_row[kMaxWidth];
  recv_rows(acc, n, h, g_mi, g_mo, w, recv, Walk::of(rb, false), re, row,
            ln, dw);
  sum_groups(acc, ln.lanes);
  put_row(part[warp], acc, row, ln);
  __syncthreads();
  for (int col = threadIdx.x; col < row * N; col += kThreads)
    recv_row[col] = warp_order_sum(part, col);
  __syncthreads();
  zero(acc);
  sum_rows<true>(acc, g_mi, w, send, Walk::of(sb, false), se, row, ln);
  sum_groups(acc, ln.lanes);
  put_row(part[warp], acc, row, ln);
  __syncthreads();
  T* flat = reinterpret_cast<T*>(dh + n * row);
  for (int col = threadIdx.x; col < row * N; col += kThreads)
    flat[col] = from_f32<T>(recv_row[col] + warp_order_sum(part, col));
}

}  // namespace

extern "C" {

// h, g_mi, g_mo, dh: [n_node, d] in dtype (0 = float32, 1 = bfloat16); w:
// [E] f32 edge weights in EDGE order; dw: [E] f32, written in edge order;
// item_bytes, log_lanes: ops/cuda/spmm.py::row_launch (rows.cuh).  Per
// plan: CSR offsets, the other endpoint and the edge of each sorted
// position, and the nodes with more than kLongSegment edges
// (EdgePlan.long_seg).
int gnn_aggregate_pair_bwd(int dtype, int n_node, int d, int item_bytes,
                           int log_lanes, const void* h, const float* w,
                           const void* g_mi, const void* g_mo,
                           const int32_t* recv_ptr, const int32_t* recv_oth,
                           const int32_t* recv_order,
                           const int32_t* recv_long, int n_recv_long,
                           const int32_t* send_ptr, const int32_t* send_oth,
                           const int32_t* send_order,
                           const int32_t* send_long, int n_send_long,
                           void* dh, float* dw, void* stream) {
  const RowItems ri{d, dtype == 0 ? 4 : 2, item_bytes, log_lanes};
  const void* rows[] = {h, g_mi, g_mo, dh};
  const unsigned blocks = n_recv_long + n_send_long +
                          (n_node + kWarpsPerBlock / 2 - 1) /
                              (kWarpsPerBlock / 2);
  return dispatch_rows(
      dtype, n_node, ri, rows, 4, n_recv_long, n_send_long, [&](auto v) {
        using R = decltype(v);
        using Item = typename R::Item;
        if (blocks > 0)
          agg_bwd_kernel<typename R::type, R::n, R::items>
              <<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
                  n_node, ri.row(), log_lanes, static_cast<const Item*>(h),
                  w, static_cast<const Item*>(g_mi),
                  static_cast<const Item*>(g_mo),
                  Side{recv_ptr, recv_oth, recv_order},
                  Side{send_ptr, send_oth, send_order}, recv_long,
                  n_recv_long, send_long, n_send_long,
                  static_cast<Item*>(dh), dw);
        return static_cast<int>(cudaGetLastError());
      });
}

// Replaces: gnn_fpga_tpu/ops/pallas/spmm.py::_gather_bwd_kernel (and
// _gather_bwd_kernel_pre), the VJP of gather_pair:
//   dpa[n] = sum_{s==n} g[e],  dpb[n] = sum_{r==n} g[e],  g: [E, H].
// rows.cuh's segment_rows_kernel, unweighted: each warp owns one (node,
// direction), warp 2n summing node n's rows as receiver (dpb) over the
// recv plan, warp 2n + 1 as sender (dpa) over the send plan, each reading
// its edges' rows of g in place through the plan's order (g stays in edge
// order; the order is the row each sorted position reads).  8 lanes of one
// 16-byte item each hold a 128-byte bf16 row (H = 64), so one warp
// instruction reads 4 whole rows.
//
// What bounds it on this card: bytes.  At the fullevent shapes it reads
// g, E x H x 2 B ~ 23 MB in bf16 (46 MB in f32), once per direction, and
// writes dpa, dpb (4 / 8 MB); the bound counts g once (8.5 / 16.7 us).
// An edge's row is read by its receiver's warp and by its sender's; in the
// tracking graphs nodes are numbered by sector and layer and edges join
// adjacent layers, so with a node's two warps side by side the second
// read finds the row in the 50 MB L2, which an f32 g does not fit whole
// (PERF.md).  Each warp's walk is a chain of dependent loads
// (offsets, edge ids, rows) whose latency the resident warps hide; more
// edges in flight a group, which cost registers and so resident warps,
// did not shorten it.  Measured on an H100 (PERF.md): 0.017 ms in bf16
// and 0.027 ms in f32, the same with and without the pad edges; the
// first design (a warp a node and direction, one element a lane, one
// edge in flight) took 0.032 and 0.048 ms, much of it the pad node's
// 160-edge walks in the grid's last wave.
//
// g: [E, hdim] in EDGE order; dpa/dpb: [V, hdim]; dtype as above;
// item_bytes, log_lanes: ops/cuda/spmm.py::row_launch (rows.cuh);
// recv_long [n_recv_long], send_long [n_send_long]: each plan's nodes with
// more than kLongSegment edges (EdgePlan.long_seg).
int gnn_gather_pair_bwd(int dtype, int n_node, int hdim, int item_bytes,
                        int log_lanes, const void* g,
                        const int32_t* recv_ptr, const int32_t* recv_order,
                        const int32_t* recv_long, int n_recv_long,
                        const int32_t* send_ptr, const int32_t* send_order,
                        const int32_t* send_long, int n_send_long,
                        void* dpa, void* dpb, void* stream) {
  const RowItems ri{hdim, dtype == 0 ? 4 : 2, item_bytes, log_lanes};
  return gnn::launch_segment_rows<false>(
      dtype, n_node, ri, g, nullptr, Side{recv_ptr, recv_order, nullptr},
      Side{send_ptr, send_order, nullptr}, recv_long, n_recv_long,
      send_long, n_send_long, dpb, dpa, stream);
}

}  // extern "C"
