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
// Design, shared by the two kernels.  The edges come in the recv-sorted
// and send-sorted CSR plans of the forward.  One warp owns one node and
// walks its node's segments, so every contribution to the node's gradient
// rows is summed by that warp in f32 registers and written once: no
// atomics, no zero-fill, and results are identical from run to run.  A
// value that belongs to one edge (dw) is computed on the recv side only,
// so each edge counts once.  Tables are T = float or __nv_bfloat16, edge
// weights f32; outputs are written in T except dw (f32, as w).
//
// In agg_bwd_kernel lane l holds columns l, l+32, ... of a row, templated
// on kC = ceil(max width / 32) in {1, 2, 3, 4, 8} (the fullevent D = 66:
// kC = 3); gather_bwd_kernel takes an edge a group of lanes (rows.cuh).
//
// Interface: plain C functions, loaded with ctypes.  They launch on the
// given stream, allocate nothing, and return cudaGetLastError().

#include "rows.cuh"

namespace {

using gnn::dispatch;
using gnn::dispatch_rows;
using gnn::from_f32;
using gnn::kFull;
using gnn::kLongSegment;
using gnn::kMaxWidth;
using gnn::kThreads;
using gnn::kWarp;
using gnn::kWarpsPerBlock;
using gnn::load_row_items;
using gnn::load_row;
using gnn::pack;
using gnn::RowItems;
using gnn::Lanes;
using gnn::Side;
using gnn::store_row;
using gnn::sum_groups;
using gnn::to_f32;
using gnn::Vec;
using gnn::Walk;
using gnn::warp_sum;

// Replaces: gnn_fpga_tpu/ops/pallas/spmm.py::_agg_bwd_kernel (and its
// prebuilt-one-hot twin _agg_bwd_kernel_pre), the VJP of aggregate_pair:
//   dh[s] += w g_mi[r],  dh[r] += w g_mo[s],
//   dw[e]  = <g_mi[r], h[s]> + <g_mo[s], h[r]>.
// One warp per node: as receiver it adds w g_mo[o] and computes dw of the
// edge, written in EDGE order through recv.order (each edge once); as
// sender it adds w g_mi[o].  The weights arrive in edge order and are
// read through each plan's order, as in the forward.
//
// What bounds it on this card: the gathers, two rows per recv edge
// (h[o], g_mo[o]) and one per send edge (g_mi[o]), one warp reduction per
// edge, and the scattered 4-byte dw stores; no transcendentals.
template <typename T, int kC>
__global__ void __launch_bounds__(kThreads)
agg_bwd_kernel(int n_node, int d, const T* __restrict__ h,
               const float* __restrict__ w, const T* __restrict__ g_mi,
               const T* __restrict__ g_mo, Side recv, Side send,
               T* __restrict__ dh, float* __restrict__ dw) {
  const int lane = threadIdx.x & (kWarp - 1);
  const long n = static_cast<long>(blockIdx.x) * kWarpsPerBlock +
                 (threadIdx.x / kWarp);
  if (n >= n_node) return;
  float hn[kC], gown[kC], acc[kC];
  load_row<kC>(hn, h + n * d, d, lane);
  load_row<kC>(gown, g_mi + n * d, d, lane);
#pragma unroll
  for (int c = 0; c < kC; ++c) acc[c] = 0.f;
  for (int j = recv.seg_ptr[n]; j < recv.seg_ptr[n + 1]; ++j) {
    const long o = recv.oth[j];
    const int edge = recv.w_idx[j];
    const float wj = w[edge];
    float part = 0.f;
#pragma unroll
    for (int c = 0; c < kC; ++c) {
      const int k = c * kWarp + lane;
      if (k < d) {
        const float go = to_f32(g_mo[o * d + k]);
        part += gown[c] * to_f32(h[o * d + k]) + go * hn[c];
        acc[c] += wj * go;
      }
    }
    part = warp_sum(part);
    if (lane == 0) dw[edge] = part;
  }
  for (int j = send.seg_ptr[n]; j < send.seg_ptr[n + 1]; ++j) {
    const long o = send.oth[j];
    const float wj = w[send.w_idx[j]];
#pragma unroll
    for (int c = 0; c < kC; ++c) {
      const int k = c * kWarp + lane;
      if (k < d) acc[c] += wj * to_f32(g_mi[o * d + k]);
    }
  }
  store_row<kC>(dh + n * d, acc, d, lane);
}

// Replaces: gnn_fpga_tpu/ops/pallas/spmm.py::_gather_bwd_kernel (and
// _gather_bwd_kernel_pre), the VJP of gather_pair:
//   dpa[n] = sum_{s==n} g[e],  dpb[n] = sum_{r==n} g[e],  g: [E, H].
// Each warp owns one (node, direction): warp 2n sums node n's rows as
// receiver (dpb) over the recv plan, warp 2n + 1 as sender (dpa) over the
// send plan, each reading its edges' rows of g in place through the
// plan's order (g stays in edge order); long segments go to blocks of
// their own (rows.cuh).  A warp's lanes split into groups of 2^log_lanes,
// one edge a group: 8 lanes of one 16-byte item each hold a 128-byte bf16
// row (H = 64), so one warp instruction reads 4 whole rows.  Each group
// sums its edges in edge order in f32 registers; the groups' rows are
// added once, in a fixed order (sum_groups), before the node's one store,
// and a long segment's warps' rows in warp order.
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
template <typename T, int N, int kI>
__global__ void __launch_bounds__(kThreads)
gather_bwd_kernel(int n_node, int row, int log_lanes,
                  const Vec<T, N>* __restrict__ g, Side recv, Side send,
                  const int32_t* __restrict__ recv_long, int n_recv_long,
                  const int32_t* __restrict__ send_long, int n_send_long,
                  Vec<T, N>* __restrict__ dpa, Vec<T, N>* __restrict__ dpb) {
  constexpr int kU = gnn::edges_in_flight<kI, sizeof(Vec<T, N>)>();
  const Lanes ln(log_lanes);
  const int warp = threadIdx.x / kWarp;
  // blocks [0, n_recv_long) walk the recv plan's long segments, the next
  // n_send_long the send plan's; the warps of the blocks after them own
  // one (node, direction) each, a node's two side by side
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
#pragma unroll
  for (int i = 0; i < kI; ++i)
#pragma unroll
    for (int q = 0; q < N; ++q) acc[i][q] = 0.f;
  const Walk walk = Walk::of(beg, whole);
  for (int base = walk.first; base < end; base += walk.stride) {
    const int cnt = min(kWarp, end - base);
    const int e_l = ln.lane < cnt ? side.w_idx[base + ln.lane] : 0;
    for (int k0 = 0; k0 < cnt; k0 += ln.groups * kU) {
      Vec<T, N> rows[kU][kI];
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        const int k = k0 + u * ln.groups + ln.group;
        // the same on every lane: whether the warp has edges left
        if (k0 + u * ln.groups < cnt) {
          const long e = __shfl_sync(kFull, e_l, k & (kWarp - 1));
          if (k < cnt) load_row_items(rows[u], g, e, row, ln);
        }
      }
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        if (k0 + u * ln.groups + ln.group >= cnt) continue;
#pragma unroll
        for (int i = 0; i < kI; ++i) {
          if (ln.c0 + i * ln.lanes >= row) continue;
#pragma unroll
          for (int q = 0; q < N; ++q) acc[i][q] += to_f32(rows[u][i].v[q]);
        }
      }
    }
  }
  sum_groups(acc, ln.lanes);
  Vec<T, N>* out = (by_send ? dpa : dpb) + n * row;
  if (whole) {
    if (ln.group != 0) return;
#pragma unroll
    for (int i = 0; i < kI; ++i) {
      const int c = ln.c0 + i * ln.lanes;
      if (c < row) out[c] = pack<T>(acc[i]);
    }
    return;
  }
  // a long segment: the warps' rows added in warp order
  __shared__ float part[kWarpsPerBlock][kMaxWidth];
  if (ln.group == 0)
#pragma unroll
    for (int i = 0; i < kI; ++i) {
      const int c = ln.c0 + i * ln.lanes;
      if (c < row)
#pragma unroll
        for (int q = 0; q < N; ++q) part[warp][c * N + q] = acc[i][q];
    }
  __syncthreads();
  T* flat = reinterpret_cast<T*>(out);
  for (int col = threadIdx.x; col < row * N; col += kThreads) {
    float sum = part[0][col];
    for (int w = 1; w < kWarpsPerBlock; ++w) sum += part[w][col];
    flat[col] = from_f32<T>(sum);
  }
}

}  // namespace

extern "C" {

// w: [E] f32 edge weights in EDGE order; recv_order/send_order map each
// sorted position to its edge.  dw: [E] f32, written in edge order.
int gnn_aggregate_pair_bwd(int dtype, int n_node, int d, const void* h,
                           const float* w, const void* g_mi, const void* g_mo,
                           const int32_t* recv_ptr, const int32_t* recv_oth,
                           const int32_t* recv_order,
                           const int32_t* send_ptr, const int32_t* send_oth,
                           const int32_t* send_order, void* dh, float* dw,
                           void* stream) {
  const unsigned blocks = gnn::blocks_for_warps(n_node);
  return dispatch(dtype, d, [&](auto v) {
    using T = typename decltype(v)::type;
    if (blocks > 0)
      agg_bwd_kernel<T, decltype(v)::chunks>
          <<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
              n_node, d, static_cast<const T*>(h), w,
              static_cast<const T*>(g_mi), static_cast<const T*>(g_mo),
              Side{recv_ptr, recv_oth, recv_order},
              Side{send_ptr, send_oth, send_order}, static_cast<T*>(dh), dw);
    return static_cast<int>(cudaGetLastError());
  });
}

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
  if (n_node < 0 || (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const RowItems ri{hdim, dtype == 0 ? 4 : 2, item_bytes, log_lanes};
  const void* rows[] = {g, dpa, dpb};
  const int err = ri.check(rows, 3);
  if (err != 0) return err;
  if (n_recv_long < 0 || n_send_long < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const unsigned blocks =
      n_recv_long + n_send_long + gnn::blocks_for_warps(2L * n_node);
  return dispatch_rows(dtype, ri, [&](auto v) {
    using R = decltype(v);
    using Item = typename R::Item;
    if (blocks > 0)
      gather_bwd_kernel<typename R::type, R::n, R::items>
          <<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
              n_node, ri.row(), log_lanes, static_cast<const Item*>(g),
              Side{recv_ptr, nullptr, recv_order},
              Side{send_ptr, nullptr, send_order}, recv_long, n_recv_long,
              send_long, n_send_long, static_cast<Item*>(dpa),
              static_cast<Item*>(dpb));
    return static_cast<int>(cudaGetLastError());
  });
}

}  // extern "C"
