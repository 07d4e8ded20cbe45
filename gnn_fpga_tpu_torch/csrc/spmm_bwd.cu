// Hand-written Hopper kernels for the backward of the SegmentClassifier's
// message passing: the vector-Jacobian products of the two aggregation
// kernels of spmm.cu and of the final edge layer's endpoint gather.
//
// Forward functions (spmm.cu, ops/cuda/spmm.py::gather_pair):
//
//     pre[e] = (pa[s] + pb[r]) * em[e],   z = tanh(pre + b1)
//     w[e]   = sigmoid(z . w2 + b2) * em[e]          (iteration_pair only)
//     mi[n]  = sum_{r==n} w[e] h[s],  mo[n] = sum_{s==n} w[e] h[r]
//     out[e] = pa[s] + pb[r]                          (gather_pair)
//
// Design, shared by the three kernels.  The edges come in the recv-sorted
// and send-sorted CSR plans of the forward.  One warp owns one node and
// walks its node's segments, so every contribution to the node's gradient
// rows is summed by that warp in f32 registers (lane l holds columns l,
// l+32, ...) and written once: no atomics, no zero-fill, and results are
// identical from run to run.  A value that belongs to one edge (the score
// gradient, dw) is computed on the recv side only, so each edge counts
// once.  Tables are T = float or __nv_bfloat16, edge weights and masks
// f32; outputs are written in T except dw (f32, as w).
//
// Register rows per lane are templated on kC = ceil(max width / 32) in
// {1, 2, 3, 4, 8}, chosen by the host function, so the fullevent widths
// (D = 66, H = 64: kC = 3) hold 3 columns a row and not the forward's 8.
//
// Interface: plain C functions, loaded with ctypes.  They launch on the
// given stream, allocate nothing, and return cudaGetLastError().

#include "common.cuh"

namespace {

using gnn::dispatch;
using gnn::from_f32;
using gnn::kThreads;
using gnn::kWarp;
using gnn::kWarpsPerBlock;
using gnn::load_row;
using gnn::Side;
using gnn::store_row;
using gnn::to_f32;
using gnn::warp_sum;

constexpr int kReduceThreads = 256;

// Replaces: gnn_fpga_tpu/ops/pallas/spmm.py::_iter_pair_bwd_kernel, the
// VJP of the fused iteration (dh, dpa, dpb, dw2, db1, db2), recomputing
// z and the edge score per edge from the V-sized node tables.
//
// One warp per node n walks both of its segments in turn:
//   recv segment (r = n, o = s): recompute z, sig, e; then
//     de     = <g_mi[n], h[o]> + <g_mo[o], h[n]>
//     dlogit = de * em * sig * (1 - sig),  dz = dlogit * w2,
//     dpre   = dz * (1 - z^2) * em
//     dpb[n] += dpre,  dh[n] += e * g_mo[o],
//     and the parameter sums dw2 += z dlogit, db1 += dz (1 - z^2) (no em,
//     as the JAX kernel), db2 += dlogit, taken on this side only;
//   send segment (s = n, o = r): the same recompute, then
//     de = <g_mi[o], h[n]> + <g_mo[n], h[o]>,
//     dpa[n] += dpre,  dh[n] += e * g_mi[o].
// dh[n] gets contributions from both directions and is written once.  The
// parameter sums are reduced per block in shared memory, in fixed warp
// order, into partial[col * gridDim.x + block]; column_sum_kernel then
// sums each column in fixed order, so they too are bitwise repeatable.
//
// What bounds it on this card: as the forward, the per-edge dependent
// chain (ids -> three gathered rows -> tanh -> two warp reductions ->
// expf -> FMAs), now with three rows (pa or pb, h, g_mo or g_mi) gathered
// per edge and direction instead of two, and a score recomputed on both
// sides.  The node tables (~9 MB in bf16 at fullevent) stay in L2; the
// design keeps only the current side's own rows live in registers, so
// occupancy, which hides the gather latency, stays close to the
// forward's.  The longest segment (the packed graph's pad node, 160 edges
// a direction, both walked by one warp) sets a tail.
template <typename T, int kC>
__global__ void __launch_bounds__(kThreads)
iter_bwd_kernel(int n_node, int d, int hdim, const T* __restrict__ pa,
                const T* __restrict__ pb, const T* __restrict__ h,
                const float* __restrict__ em,
                const int32_t* __restrict__ send_em_idx,
                const T* __restrict__ w2, const T* __restrict__ b1,
                const T* __restrict__ b2, const T* __restrict__ g_mi,
                const T* __restrict__ g_mo, Side recv, Side send,
                T* __restrict__ dh, T* __restrict__ dpa,
                T* __restrict__ dpb, float* __restrict__ partial) {
  __shared__ float red[kWarpsPerBlock][2 * kC * kWarp + 1];
  const int lane = threadIdx.x & (kWarp - 1);
  const int wid = threadIdx.x / kWarp;
  const long n = static_cast<long>(blockIdx.x) * kWarpsPerBlock + wid;

  float w2r[kC], b1r[kC], dw2[kC], db1[kC];
  load_row<kC>(w2r, w2, hdim, lane);
  load_row<kC>(b1r, b1, hdim, lane);
  const float bias2 = to_f32(b2[0]);
  float db2 = 0.f;
#pragma unroll
  for (int c = 0; c < kC; ++c) dw2[c] = db1[c] = 0.f;

  if (n < n_node) {
    float hn[kC], dhacc[kC], own[kC], gown[kC], dacc[kC], z[kC];
    load_row<kC>(hn, h + n * d, d, lane);
#pragma unroll
    for (int c = 0; c < kC; ++c) dhacc[c] = 0.f;

    // ---- recv side: n = receiver, o = sender; own rows pb[n], g_mi[n]
    load_row<kC>(own, pb + n * hdim, hdim, lane);
    load_row<kC>(gown, g_mi + n * d, d, lane);
#pragma unroll
    for (int c = 0; c < kC; ++c) dacc[c] = 0.f;
    for (int j = recv.seg_ptr[n]; j < recv.seg_ptr[n + 1]; ++j) {
      const long o = recv.oth[j];
      const float emj = em[j];
      float part = 0.f;
#pragma unroll
      for (int c = 0; c < kC; ++c) {
        const int k = c * kWarp + lane;
        z[c] = 0.f;
        if (k < hdim) {
          // (pa[send] + pb[recv]) * em, summed in the JAX kernel's order
          z[c] = tanhf((to_f32(pa[o * hdim + k]) + own[c]) * emj + b1r[c]);
          part += z[c] * w2r[c];
        }
      }
      const float sig = 1.f / (1.f + expf(-(warp_sum(part) + bias2)));
      float gpart = 0.f, go[kC];
#pragma unroll
      for (int c = 0; c < kC; ++c) {
        const int k = c * kWarp + lane;
        go[c] = 0.f;
        if (k < d) {
          go[c] = to_f32(g_mo[o * d + k]);
          gpart += gown[c] * to_f32(h[o * d + k]) + go[c] * hn[c];
        }
      }
      const float dlogit = warp_sum(gpart) * emj * sig * (1.f - sig);
      const float e = sig * emj;
#pragma unroll
      for (int c = 0; c < kC; ++c) {
        const float t = dlogit * w2r[c] * (1.f - z[c] * z[c]);
        dacc[c] += t * emj;
        db1[c] += t;
        dw2[c] += z[c] * dlogit;
        dhacc[c] += e * go[c];
      }
      db2 += dlogit;
    }
    store_row<kC>(dpb + n * hdim, dacc, hdim, lane);

    // ---- send side: n = sender, o = receiver; own rows pa[n], g_mo[n]
    load_row<kC>(own, pa + n * hdim, hdim, lane);
    load_row<kC>(gown, g_mo + n * d, d, lane);
#pragma unroll
    for (int c = 0; c < kC; ++c) dacc[c] = 0.f;
    for (int j = send.seg_ptr[n]; j < send.seg_ptr[n + 1]; ++j) {
      const long o = send.oth[j];
      const float emj = em[send_em_idx[j]];
      float part = 0.f;
#pragma unroll
      for (int c = 0; c < kC; ++c) {
        const int k = c * kWarp + lane;
        z[c] = 0.f;
        if (k < hdim) {
          z[c] = tanhf((own[c] + to_f32(pb[o * hdim + k])) * emj + b1r[c]);
          part += z[c] * w2r[c];
        }
      }
      const float sig = 1.f / (1.f + expf(-(warp_sum(part) + bias2)));
      float gpart = 0.f, gi[kC];
#pragma unroll
      for (int c = 0; c < kC; ++c) {
        const int k = c * kWarp + lane;
        gi[c] = 0.f;
        if (k < d) {
          gi[c] = to_f32(g_mi[o * d + k]);
          gpart += gi[c] * hn[c] + gown[c] * to_f32(h[o * d + k]);
        }
      }
      const float dlogit = warp_sum(gpart) * emj * sig * (1.f - sig);
      const float e = sig * emj;
#pragma unroll
      for (int c = 0; c < kC; ++c) {
        dacc[c] += dlogit * w2r[c] * (1.f - z[c] * z[c]) * emj;
        dhacc[c] += e * gi[c];
      }
    }
    store_row<kC>(dpa + n * hdim, dacc, hdim, lane);
    store_row<kC>(dh + n * d, dhacc, d, lane);
  }

  // ---- per-block parameter sums: [dw2 | db1 | db2], fixed order
#pragma unroll
  for (int c = 0; c < kC; ++c) {
    const int k = c * kWarp + lane;
    if (k < hdim) {
      red[wid][k] = dw2[c];
      red[wid][hdim + k] = db1[c];
    }
  }
  if (lane == 0) red[wid][2 * hdim] = db2;
  __syncthreads();
  for (int col = threadIdx.x; col < 2 * hdim + 1; col += kThreads) {
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < kWarpsPerBlock; ++w) s += red[w][col];
    partial[static_cast<long>(col) * gridDim.x + blockIdx.x] = s;
  }
}

// Second step of the parameter sums: block b sums column b of
// partial [n_cols, n_rows] with a fixed-order tree and writes it to
// out0[b] (b < hdim), out1[b - hdim] (b < 2 hdim) or out2[0].
template <typename T>
__global__ void __launch_bounds__(kReduceThreads)
column_sum_kernel(int n_rows, int hdim, const float* __restrict__ partial,
                  T* __restrict__ out0, T* __restrict__ out1,
                  T* __restrict__ out2) {
  __shared__ float buf[kReduceThreads];
  const int col = blockIdx.x;
  float s = 0.f;
  for (int i = threadIdx.x; i < n_rows; i += kReduceThreads)
    s += partial[static_cast<long>(col) * n_rows + i];
  buf[threadIdx.x] = s;
  __syncthreads();
  for (int stride = kReduceThreads / 2; stride > 0; stride >>= 1) {
    if (threadIdx.x < stride) buf[threadIdx.x] += buf[threadIdx.x + stride];
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    T* out = col < hdim ? out0 + col
             : col < 2 * hdim ? out1 + (col - hdim) : out2;
    *out = from_f32<T>(buf[0]);
  }
}

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

// Floats of f32 scratch that gnn_iteration_pair_bwd needs for the
// per-block parameter sums.
long gnn_iteration_pair_bwd_scratch(int n_node, int hdim) {
  return static_cast<long>(2 * hdim + 1) * gnn::blocks_for_warps(n_node);
}

// dtype: 0 = float32, 1 = bfloat16 (pa, pb, h, w2, b1, b2, g_mi, g_mo and
// every output).  em: [E] f32 edge mask in the recv plan's order;
// send_em_idx: [E] position in the recv order of each send-sorted edge.
// partial: f32 scratch of gnn_iteration_pair_bwd_scratch floats.
int gnn_iteration_pair_bwd(int dtype, int n_node, int d, int hdim,
                           const void* pa, const void* pb, const void* h,
                           const float* em, const int32_t* send_em_idx,
                           const void* w2, const void* b1, const void* b2,
                           const void* g_mi, const void* g_mo,
                           const int32_t* recv_ptr, const int32_t* recv_oth,
                           const int32_t* send_ptr, const int32_t* send_oth,
                           void* dh, void* dpa, void* dpb, float* partial,
                           long partial_floats, void* dw2, void* db1,
                           void* db2, void* stream) {
  if (hdim < 1 || partial_floats < gnn_iteration_pair_bwd_scratch(n_node, hdim))
    return static_cast<int>(cudaErrorInvalidValue);
  const Side recv{recv_ptr, recv_oth, nullptr};
  const Side send{send_ptr, send_oth, send_em_idx};
  const auto st = static_cast<cudaStream_t>(stream);
  const unsigned blocks = gnn::blocks_for_warps(n_node);
  return dispatch(dtype, d > hdim ? d : hdim, [&](auto v) {
    using T = typename decltype(v)::type;
    if (blocks > 0) {
      iter_bwd_kernel<T, decltype(v)::chunks><<<blocks, kThreads, 0, st>>>(
          n_node, d, hdim, static_cast<const T*>(pa),
          static_cast<const T*>(pb), static_cast<const T*>(h), em,
          send_em_idx, static_cast<const T*>(w2), static_cast<const T*>(b1),
          static_cast<const T*>(b2), static_cast<const T*>(g_mi),
          static_cast<const T*>(g_mo), recv, send, static_cast<T*>(dh),
          static_cast<T*>(dpa), static_cast<T*>(dpb), partial);
      const int err = static_cast<int>(cudaGetLastError());
      if (err != 0) return err;
    }
    column_sum_kernel<T><<<2 * hdim + 1, kReduceThreads, 0, st>>>(
        static_cast<int>(blocks), hdim, partial, static_cast<T*>(dw2),
        static_cast<T*>(db1), static_cast<T*>(db2));
    return static_cast<int>(cudaGetLastError());
  });
}

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
