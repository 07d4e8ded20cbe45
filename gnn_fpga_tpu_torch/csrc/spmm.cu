// Hand-written Hopper kernel for the SegmentClassifier's edge-weighted
// neighbour aggregations with the weights given (the unfused iteration's
// aggregate_pair, and one direction of it, spmm):
//
//     mi[n] = sum_{e: recv[e]==n} w[e] * h[send[e]]
//     mo[n] = sum_{e: send[e]==n} w[e] * h[recv[e]]
//
// The fused iteration, which scores the edges itself, is iteration_fwd.cu.
//
// Design.  Edges come in two CSR orders (the recv-sorted and send-sorted
// plans of ops/cuda/spmm.py): in the recv plan the edges of receiver n are
// sorted_oth[seg_ptr[n] : seg_ptr[n+1]], gathered senders; the send plan is
// its transpose.  One warp owns one (node, direction) pair: it walks its
// node's CSR segment, accumulates w * h[oth] in f32 registers (lane l holds
// columns l, l+32, ...), and writes the node's output row once.  Every row
// is written, zero for nodes without edges, so outputs need no clearing; no
// atomics are used, so results are identical from run to run.  Launched
// with one side only (n_sides = 1), the kernel is the single-direction
// aggregation of spmm_ops.cu (gnn::aggregate_one_side).
//
// Types: T is float or __nv_bfloat16 for the tables; edge weights are f32;
// accumulation is f32; outputs are written in T.
//
// Interface: plain C functions, loaded with ctypes.  They launch on the
// given stream, allocate nothing, and return cudaGetLastError().

#include "common.cuh"

namespace {

using gnn::from_f32;
using gnn::kWarp;
using gnn::kWarpsPerBlock;
using gnn::Side;
using gnn::to_f32;

// Register-resident row chunks per lane: widths up to 8 * 32 = 256.
constexpr int kMaxChunks = 8;

// Replaces: gnn_fpga_tpu/ops/pallas/spmm.py::_agg_pair_kernel.  The TPU
// kernel turns every gather into a windowed one-hot matmul because Mosaic
// lacks a large dynamic row gather; on Hopper a row gather is native, so
// the kernel reads rows directly and keeps only the sorted edge orders.
//
// What bounds it on this card: the row gathers, one h row per edge and
// direction (2 E D 2 B ~ 48 MB in bf16 at the fullevent shapes) from
// tables that stay in L2, one edge in flight per warp, and the longest
// CSR segment (the packed graph's pad node, 160 edges) sets a tail.
template <typename T>
__global__ void __launch_bounds__(kWarpsPerBlock * kWarp)
pair_kernel(int n_node, int n_sides, int d, const T* __restrict__ h,
            const float* __restrict__ wvec, Side recv, Side send,
            T* __restrict__ mi, T* __restrict__ mo) {
  const int lane = threadIdx.x & (kWarp - 1);
  const long gw = static_cast<long>(blockIdx.x) * kWarpsPerBlock +
                  (threadIdx.x / kWarp);
  if (gw >= static_cast<long>(n_sides) * n_node) return;
  // Warps [0, V) aggregate by receiver (mi), warps [V, 2V) by sender (mo).
  const bool by_send = gw >= n_node;
  const int n = static_cast<int>(by_send ? gw - n_node : gw);
  const Side side = by_send ? send : recv;
  T* __restrict__ out = by_send ? mo : mi;

  float acc[kMaxChunks];
#pragma unroll
  for (int c = 0; c < kMaxChunks; ++c) acc[c] = 0.f;

  const int beg = side.seg_ptr[n];
  const int end = side.seg_ptr[n + 1];
  for (int j = beg; j < end; ++j) {
    const long o = side.oth[j];
    const float wj = wvec[side.w_idx[j]];
#pragma unroll
    for (int c = 0; c < kMaxChunks; ++c) {
      const int k = c * kWarp + lane;
      if (k < d) acc[c] += wj * to_f32(h[o * d + k]);
    }
  }
#pragma unroll
  for (int c = 0; c < kMaxChunks; ++c) {
    const int k = c * kWarp + lane;
    if (k < d) out[static_cast<long>(n) * d + k] = from_f32<T>(acc[c]);
  }
}

template <typename T>
int launch(int n_node, int n_sides, int d, const void* h, const float* wvec,
           Side recv, Side send, void* mi, void* mo, void* stream) {
  if (d > kMaxChunks * kWarp) return static_cast<int>(cudaErrorInvalidValue);
  if (n_node > 0) {
    const unsigned blocks =
        gnn::blocks_for_warps(static_cast<long>(n_sides) * n_node);
    pair_kernel<T><<<blocks, kWarpsPerBlock * kWarp, 0,
                     static_cast<cudaStream_t>(stream)>>>(
        n_node, n_sides, d, static_cast<const T*>(h), wvec, recv, send,
        static_cast<T*>(mi), static_cast<T*>(mo));
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

namespace gnn {

int aggregate_one_side(int dtype, int n_node, int d, const void* h,
                       const float* w, Side side, void* out, void* stream) {
  if (dtype == 0)
    return launch<float>(n_node, 1, d, h, w, side, side, out, nullptr,
                         stream);
  if (dtype == 1)
    return launch<__nv_bfloat16>(n_node, 1, d, h, w, side, side, out,
                                 nullptr, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace gnn

extern "C" {

// w: [E] f32 edge weights in EDGE order; recv_order/send_order map each
// sorted position to its edge.
int gnn_aggregate_pair_fwd(int dtype, int n_node, int d, const void* h,
                           const float* w, const int32_t* recv_ptr,
                           const int32_t* recv_oth,
                           const int32_t* recv_order,
                           const int32_t* send_ptr, const int32_t* send_oth,
                           const int32_t* send_order, void* mi, void* mo,
                           void* stream) {
  const Side recv{recv_ptr, recv_oth, recv_order};
  const Side send{send_ptr, send_oth, send_order};
  if (dtype == 0)
    return launch<float>(n_node, 2, d, h, w, recv, send, mi, mo, stream);
  if (dtype == 1)
    return launch<__nv_bfloat16>(n_node, 2, d, h, w, recv, send, mi, mo,
                                 stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
