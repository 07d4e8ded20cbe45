// Hand-written Hopper kernels for the single-direction sparse operations of
// ops/cuda/spmm.py and ops/cuda/segment_sum.py:
//
//     spmm:        out[n] = sum_{seg(e)==n} w[e] * h[oth(e)]          [V, D]
//     sddmm:       out[e] = <a[seg(e)], b[oth(e)]>                     [E]
//     sddmm_dual:  out[e] = <p[seg(e)], q[oth(e)]> + <u[oth(e)], v[seg(e)]>
//     sorted segment sum:
//                  out[n] = sum_{ids[e]==n} msgs[e], msgs already sorted
//
// Design.  As in spmm.cu and spmm_bwd.cu, the edges come in a CSR plan
// sorted by their seg endpoint (ops/cuda/spmm.py::EdgePlan, or the
// SortedSegments of ops/cuda/segment_sum.py), and one warp owns one seg
// node: it walks the node's contiguous segment and keeps the node's own
// rows and sums in f32 registers (lane l holds columns l, l+32, ...).
// Every output row or element has one owner and is written once: no
// atomics and no zero-fill, and results are identical from run to run.
// The TPU kernels' windowed one-hot matmuls are not carried over: they
// exist because Mosaic has no large row gather, and Hopper gathers rows
// natively.
//
// Types: T = float or __nv_bfloat16 for the tables and messages; edge
// weights are f32; accumulation is f32; spmm and the segment sum write T,
// the sddmms write f32.
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

// Replaces: gnn_fpga_tpu/ops/pallas/spmm.py::_sddmm_kernel (!kDual) and
// ::_sddmm_dual_kernel (kDual).  One warp per seg node n holds a[n] (and
// v[n]) in registers, walks n's segment, gathers b[o] (and u[o]) for each
// edge, reduces the dot products across the warp and writes the edge's
// value straight to its EDGE-order slot out[order[j]], which replaces the
// JAX kernel's sorted-order output and its take(..., inv_order).
//
// What bounds it on this card: the row gathers, one (two) rows of D
// elements per edge, and one warp reduction per edge.  At the fullevent
// shapes (V = 15,848, E = 180,736, D = 66) the tables are 2-4 MB in bf16
// and stay in the 50 MB L2, so the limit is gather latency, hidden only by
// occupancy (V warps); the 4-byte stores to out are scattered by the
// plan's order.
template <typename T, int kC, bool kDual>
__global__ void __launch_bounds__(kThreads)
sddmm_kernel(int n_node, int d, const T* __restrict__ a,
             const T* __restrict__ b, const T* __restrict__ u,
             const T* __restrict__ v, Side side, float* __restrict__ out) {
  const int lane = threadIdx.x & (kWarp - 1);
  const long n = static_cast<long>(blockIdx.x) * kWarpsPerBlock +
                 (threadIdx.x / kWarp);
  if (n >= n_node) return;
  float an[kC], vn[kC];
  load_row<kC>(an, a + n * d, d, lane);
  if (kDual) load_row<kC>(vn, v + n * d, d, lane);
  for (int j = side.seg_ptr[n]; j < side.seg_ptr[n + 1]; ++j) {
    const long o = side.oth[j];
    float part = 0.f;
#pragma unroll
    for (int c = 0; c < kC; ++c) {
      const int k = c * kWarp + lane;
      if (k < d) {
        part += an[c] * to_f32(b[o * d + k]);
        if (kDual) part += to_f32(u[o * d + k]) * vn[c];
      }
    }
    part = warp_sum(part);
    if (lane == 0) out[side.w_idx[j]] = part;
  }
}

// Replaces: gnn_fpga_tpu/ops/pallas/segment_sum.py::_segment_sum_kernel.
// The TPU kernel rank-compacts the sorted ids so that each edge tile is one
// [T, T] one-hot matmul, and scatters the compact sums to node rows with
// XLA afterwards.  Here the CSR offsets ptr[n] of the sorted ids give each
// node its contiguous rows msgs[ptr[n] : ptr[n+1]], which one warp sums;
// rows whose id is n_node lie past ptr[n_node] and are never read.
// kRound rounds each f32 message to bf16 before it is summed, as the
// one-pass bf16 MXU product of precision="default" does.
//
// What bounds it on this card: reading the messages once, E x D x
// sizeof(T) bytes (24 MB in bf16 at E = 180,736, D = 66) in contiguous
// rows, one add per element: device-memory bandwidth, with a tail set by
// the longest segment.
template <typename T, int kC, bool kRound>
__global__ void __launch_bounds__(kThreads)
segment_sum_kernel(int n_node, int d, const T* __restrict__ msgs,
                   const int32_t* __restrict__ ptr, T* __restrict__ out) {
  const int lane = threadIdx.x & (kWarp - 1);
  const long n = static_cast<long>(blockIdx.x) * kWarpsPerBlock +
                 (threadIdx.x / kWarp);
  if (n >= n_node) return;
  float acc[kC];
#pragma unroll
  for (int c = 0; c < kC; ++c) acc[c] = 0.f;
  for (long j = ptr[n]; j < ptr[n + 1]; ++j) {
#pragma unroll
    for (int c = 0; c < kC; ++c) {
      const int k = c * kWarp + lane;
      if (k < d) {
        float m = to_f32(msgs[j * d + k]);
        if (kRound) m = __bfloat162float(__float2bfloat16(m));
        acc[c] += m;
      }
    }
  }
  store_row<kC>(out + n * d, acc, d, lane);
}

}  // namespace

extern "C" {

// Replaces: gnn_fpga_tpu/ops/pallas/spmm.py::_spmm_kernel.  The kernel is
// one side of spmm.cu's pair kernel, unscored (gnn::aggregate_one_side).
// dtype: 0 = float32, 1 = bfloat16 (h, out).  w: [E] f32 edge weights in
// EDGE order; order maps each sorted position of the plan to its edge.
int gnn_spmm(int dtype, int n_node, int d, const void* h, const float* w,
             const int32_t* seg_ptr, const int32_t* oth,
             const int32_t* order, void* out, void* stream) {
  return gnn::aggregate_one_side(dtype, n_node, d, h, w,
                                 Side{seg_ptr, oth, order}, out, stream);
}

// sddmm (u and v null) or sddmm_dual; dtype as above for a, b, u, v.
// out: [E] f32 in EDGE order.
int gnn_sddmm(int dtype, int n_node, int d, const void* a, const void* b,
              const void* u, const void* v, const int32_t* seg_ptr,
              const int32_t* oth, const int32_t* order, float* out,
              void* stream) {
  const bool dual = u != nullptr;
  if (dual != (v != nullptr)) return static_cast<int>(cudaErrorInvalidValue);
  const unsigned blocks = gnn::blocks_for_warps(n_node);
  const Side side{seg_ptr, oth, order};
  return dispatch(dtype, d, [&](auto var) {
    using T = typename decltype(var)::type;
    constexpr int kC = decltype(var)::chunks;
    const auto st = static_cast<cudaStream_t>(stream);
    const T* ta = static_cast<const T*>(a);
    const T* tb = static_cast<const T*>(b);
    const T* tu = static_cast<const T*>(u);
    const T* tv = static_cast<const T*>(v);
    if (blocks > 0) {
      if (dual)
        sddmm_kernel<T, kC, true><<<blocks, kThreads, 0, st>>>(
            n_node, d, ta, tb, tu, tv, side, out);
      else
        sddmm_kernel<T, kC, false><<<blocks, kThreads, 0, st>>>(
            n_node, d, ta, tb, tu, tv, side, out);
    }
    return static_cast<int>(cudaGetLastError());
  });
}

// msgs: [E, d] in the segments' sorted order; ptr: [n_node + 1] CSR
// offsets; out: [n_node, d]; dtype as above for msgs and out.
int gnn_sorted_segment_sum(int dtype, int n_node, int d, const void* msgs,
                           const int32_t* ptr, int round_bf16, void* out,
                           void* stream) {
  const unsigned blocks = gnn::blocks_for_warps(n_node);
  return dispatch(dtype, d, [&](auto var) {
    using T = typename decltype(var)::type;
    constexpr int kC = decltype(var)::chunks;
    const auto st = static_cast<cudaStream_t>(stream);
    const T* m = static_cast<const T*>(msgs);
    T* o = static_cast<T*>(out);
    if (blocks > 0) {
      if (round_bf16)
        segment_sum_kernel<T, kC, true><<<blocks, kThreads, 0, st>>>(
            n_node, d, m, ptr, o);
      else
        segment_sum_kernel<T, kC, false><<<blocks, kThreads, 0, st>>>(
            n_node, d, m, ptr, o);
    }
    return static_cast<int>(cudaGetLastError());
  });
}

}  // extern "C"
