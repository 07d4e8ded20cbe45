// Hand-written Hopper kernels for the SegmentClassifier's message passing.
//
// Both kernels compute the two edge-weighted neighbour aggregations of one
// interaction-network iteration,
//
//     mi[n] = sum_{e: recv[e]==n} w[e] * h[send[e]]
//     mo[n] = sum_{e: send[e]==n} w[e] * h[recv[e]]
//
// and the fused kernel also computes the edge weight itself from the
// per-node projections of the edge MLP's first layer:
//
//     pre[e] = (pa[send[e]] + pb[recv[e]]) * em[e]
//     z[e]   = tanh(pre[e] + b1)
//     w[e]   = sigmoid(z[e] . w2 + b2) * em[e]
//
// Design.  Edges come in two CSR orders (the recv-sorted and send-sorted
// plans of ops/cuda/spmm.py): in the recv plan the edges of receiver n are
// sorted_oth[seg_ptr[n] : seg_ptr[n+1]], gathered senders; the send plan is
// its transpose.  One warp owns one (node, direction) pair: it walks its
// node's CSR segment, recomputes each edge's score with a warp reduction
// over H, accumulates score * h[oth] in f32 registers (lane l holds columns
// l, l+32, ...), and writes the node's output row once.  Every row is
// written, zero for nodes without edges, so outputs need no clearing; no
// atomics are used, so results are identical from run to run.  A score is
// computed twice, once for each direction.  Launched with one side only
// (n_sides = 1), the unscored kernel is the single-direction aggregation
// of spmm_ops.cu (gnn::aggregate_one_side).
//
// Types: T is float or __nv_bfloat16 for the tables; edge weights are f32;
// accumulation is f32; outputs are written in T.  tanhf and expf are the
// accurate versions (no fast-math).
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
using gnn::warp_sum;

// Register-resident row chunks per lane: widths up to 8 * 32 = 256.
constexpr int kMaxChunks = 8;

// Replaces: gnn_fpga_tpu/ops/pallas/spmm.py::_iter_pair_kernel (kScore)
// and ::_agg_pair_kernel (!kScore).  The TPU kernels turn every gather
// into a windowed one-hot matmul because Mosaic lacks a large dynamic row
// gather; on Hopper a row gather is native, so the kernel reads rows
// directly and keeps only the sorted edge orders.
//
// What bounds it on this card: row gathers.  At the fullevent shapes
// (V=15,848, E=180,736, H=64, D=66) one fused call gathers about
// 2*E*(H+D)*2 B ~ 94 MB of rows in bf16 (the node's own projection row
// stays in registers), but the node tables themselves are ~6 MB and stay
// in the 50 MB L2, so the limit is gather latency and
// L2 bandwidth, not device memory.  This first version hides that latency
// only through occupancy (2V warps in flight over the card), with no
// prefetching of the next edge's rows, and the longest CSR segment sets a
// tail: the packed fullevent graph's pad node holds 160 edges against ~12
// elsewhere, ~0.085 ms of the fused kernel's 0.236 ms on an NVIDIA H100
// 80GB HBM3 at a 700 W power limit (PERF.md).
template <typename T, bool kScore>
__global__ void __launch_bounds__(kWarpsPerBlock * kWarp)
pair_kernel(int n_node, int n_sides, int d, int hdim,
            const T* __restrict__ h, const float* __restrict__ wvec,
            const T* __restrict__ pa, const T* __restrict__ pb,
            const T* __restrict__ w2, const T* __restrict__ b1,
            const T* __restrict__ b2, Side recv, Side send,
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

  // The node's own projection row (pb for a receiver, pa for a sender),
  // b1 and w2 stay in registers for the whole segment.
  float own[kMaxChunks], b1r[kMaxChunks], w2r[kMaxChunks];
  float bias2 = 0.f;
  const T* __restrict__ other = by_send ? pb : pa;
  if (kScore) {
    const T* __restrict__ own_tab = by_send ? pa : pb;
#pragma unroll
    for (int c = 0; c < kMaxChunks; ++c) {
      const int k = c * kWarp + lane;
      const bool ok = k < hdim;
      own[c] = ok ? to_f32(own_tab[static_cast<long>(n) * hdim + k]) : 0.f;
      b1r[c] = ok ? to_f32(b1[k]) : 0.f;
      w2r[c] = ok ? to_f32(w2[k]) : 0.f;
    }
    bias2 = to_f32(b2[0]);
  }

  float acc[kMaxChunks];
#pragma unroll
  for (int c = 0; c < kMaxChunks; ++c) acc[c] = 0.f;

  const int beg = side.seg_ptr[n];
  const int end = side.seg_ptr[n + 1];
  for (int j = beg; j < end; ++j) {
    const long o = side.oth[j];
    const float wj = wvec[side.w_idx ? side.w_idx[j] : j];
    float score = wj;
    if (kScore) {
      float part = 0.f;
#pragma unroll
      for (int c = 0; c < kMaxChunks; ++c) {
        const int k = c * kWarp + lane;
        if (k < hdim) {
          // (pa[send] + pb[recv]) * em, summed in the JAX kernel's order
          const float pre = by_send ? (own[c] + to_f32(other[o * hdim + k]))
                                    : (to_f32(other[o * hdim + k]) + own[c]);
          part += tanhf(pre * wj + b1r[c]) * w2r[c];
        }
      }
      const float logit = warp_sum(part) + bias2;
      score = (1.f / (1.f + expf(-logit))) * wj;
    }
#pragma unroll
    for (int c = 0; c < kMaxChunks; ++c) {
      const int k = c * kWarp + lane;
      if (k < d) acc[c] += score * to_f32(h[o * d + k]);
    }
  }
#pragma unroll
  for (int c = 0; c < kMaxChunks; ++c) {
    const int k = c * kWarp + lane;
    if (k < d) out[static_cast<long>(n) * d + k] = from_f32<T>(acc[c]);
  }
}

template <typename T, bool kScore>
int launch(int n_node, int n_sides, int d, int hdim, const void* h,
           const float* wvec, const void* pa, const void* pb, const void* w2,
           const void* b1, const void* b2, Side recv, Side send, void* mi,
           void* mo, void* stream) {
  if (d > kMaxChunks * kWarp || hdim > kMaxChunks * kWarp)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_node > 0) {
    const unsigned blocks =
        gnn::blocks_for_warps(static_cast<long>(n_sides) * n_node);
    pair_kernel<T, kScore>
        <<<blocks, kWarpsPerBlock * kWarp, 0,
           static_cast<cudaStream_t>(stream)>>>(
            n_node, n_sides, d, hdim, static_cast<const T*>(h), wvec,
            static_cast<const T*>(pa), static_cast<const T*>(pb),
            static_cast<const T*>(w2), static_cast<const T*>(b1),
            static_cast<const T*>(b2), recv, send, static_cast<T*>(mi),
            static_cast<T*>(mo));
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

namespace gnn {

int aggregate_one_side(int dtype, int n_node, int d, const void* h,
                       const float* w, Side side, void* out, void* stream) {
  if (dtype == 0)
    return launch<float, false>(n_node, 1, d, 0, h, w, nullptr, nullptr,
                                nullptr, nullptr, nullptr, side, side, out,
                                nullptr, stream);
  if (dtype == 1)
    return launch<__nv_bfloat16, false>(n_node, 1, d, 0, h, w, nullptr,
                                        nullptr, nullptr, nullptr, nullptr,
                                        side, side, out, nullptr, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace gnn

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (pa, pb, h, w2, b1, b2, mi, mo).
// em: [E] f32 edge mask in the recv plan's order; send_em_idx: [E] position
// in the recv order of each send-sorted edge.
int gnn_iteration_pair_fwd(int dtype, int n_node, int d, int hdim,
                           const void* pa, const void* pb, const void* h,
                           const float* em, const int32_t* send_em_idx,
                           const void* w2, const void* b1, const void* b2,
                           const int32_t* recv_ptr, const int32_t* recv_oth,
                           const int32_t* send_ptr, const int32_t* send_oth,
                           void* mi, void* mo, void* stream) {
  const Side recv{recv_ptr, recv_oth, nullptr};
  const Side send{send_ptr, send_oth, send_em_idx};
  if (dtype == 0)
    return launch<float, true>(n_node, 2, d, hdim, h, em, pa, pb, w2, b1, b2,
                               recv, send, mi, mo, stream);
  if (dtype == 1)
    return launch<__nv_bfloat16, true>(n_node, 2, d, hdim, h, em, pa, pb, w2,
                                       b1, b2, recv, send, mi, mo, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

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
    return launch<float, false>(n_node, 2, d, 0, h, w, nullptr, nullptr,
                                nullptr, nullptr, nullptr, recv, send, mi,
                                mo, stream);
  if (dtype == 1)
    return launch<__nv_bfloat16, false>(n_node, 2, d, 0, h, w, nullptr,
                                        nullptr, nullptr, nullptr, nullptr,
                                        recv, send, mi, mo, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
