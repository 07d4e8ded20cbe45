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
// rows is summed by that warp in f32 registers (lane l holds columns l,
// l+32, ...) and written once: no atomics, no zero-fill, and results are
// identical from run to run.  A value that belongs to one edge (dw) is
// computed on the recv side only, so each edge counts once.  Tables are
// T = float or __nv_bfloat16, edge weights f32; outputs are written in T
// except dw (f32, as w).
//
// Register rows per lane are templated on kC = ceil(max width / 32) in
// {1, 2, 3, 4, 8}, chosen by the host function, so the fullevent widths
// (D = 66, H = 64: kC = 3) hold 3 columns a row.
//
// Interface: plain C functions, loaded with ctypes.  They launch on the
// given stream, allocate nothing, and return cudaGetLastError().

#include "common.cuh"

namespace {

using gnn::dispatch;
using gnn::kThreads;
using gnn::kWarp;
using gnn::kWarpsPerBlock;
using gnn::load_row;
using gnn::Side;
using gnn::store_row;
using gnn::to_f32;
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
// Warps [0, V) sum receivers' rows (dpb) over the recv plan, warps
// [V, 2V) senders' rows (dpa) over the send plan; each reads its edges'
// rows of g in place through the plan's order (g stays in edge order).
//
// What bounds it on this card: reading g, E x H x 2 B ~ 23 MB in bf16 at
// fullevent, twice (once per direction), in rows scattered by the plan's
// order; one add per element.  The first version relies on occupancy
// (2V warps) to keep enough row loads in flight.
template <typename T, int kC>
__global__ void __launch_bounds__(kThreads)
gather_bwd_kernel(int n_node, int hdim, const T* __restrict__ g,
                  Side recv, Side send, T* __restrict__ dpa,
                  T* __restrict__ dpb) {
  const int lane = threadIdx.x & (kWarp - 1);
  const long gw = static_cast<long>(blockIdx.x) * kWarpsPerBlock +
                  (threadIdx.x / kWarp);
  if (gw >= 2L * n_node) return;
  const bool by_send = gw >= n_node;
  const long n = by_send ? gw - n_node : gw;
  const Side side = by_send ? send : recv;
  float acc[kC];
#pragma unroll
  for (int c = 0; c < kC; ++c) acc[c] = 0.f;
  for (int j = side.seg_ptr[n]; j < side.seg_ptr[n + 1]; ++j) {
    const long edge = side.w_idx[j];
#pragma unroll
    for (int c = 0; c < kC; ++c) {
      const int k = c * kWarp + lane;
      if (k < hdim) acc[c] += to_f32(g[edge * hdim + k]);
    }
  }
  store_row<kC>((by_send ? dpa : dpb) + n * hdim, acc, hdim, lane);
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

// g: [E, hdim] in EDGE order; dpa/dpb: [V, hdim].
int gnn_gather_pair_bwd(int dtype, int n_node, int hdim, const void* g,
                        const int32_t* recv_ptr, const int32_t* recv_order,
                        const int32_t* send_ptr, const int32_t* send_order,
                        void* dpa, void* dpb, void* stream) {
  const unsigned blocks = gnn::blocks_for_warps(2L * n_node);
  return dispatch(dtype, hdim, [&](auto v) {
    using T = typename decltype(v)::type;
    if (blocks > 0)
      gather_bwd_kernel<T, decltype(v)::chunks>
          <<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
              n_node, hdim, static_cast<const T*>(g),
              Side{recv_ptr, nullptr, recv_order},
              Side{send_ptr, nullptr, send_order}, static_cast<T*>(dpa),
              static_cast<T*>(dpb));
    return static_cast<int>(cudaGetLastError());
  });
}

}  // extern "C"
