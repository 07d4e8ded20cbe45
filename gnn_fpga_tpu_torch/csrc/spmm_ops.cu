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
// rows and sums in f32 registers (lane l holds columns l, l+32, ...; in
// sddmm, a group of lanes takes an edge, rows.cuh).
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

#include "rows.cuh"

namespace {

using gnn::dispatch;
using gnn::dispatch_rows;
using gnn::group_sum;
using gnn::kFull;
using gnn::kLongSegment;
using gnn::kThreads;
using gnn::kWarp;
using gnn::kWarpsPerBlock;
using gnn::load_row_items;
using gnn::load_row;
using gnn::RowItems;
using gnn::Lanes;
using gnn::Side;
using gnn::store_row;
using gnn::to_f32;
using gnn::Vec;
using gnn::Walk;
using gnn::warp_sum;

// Replaces: gnn_fpga_tpu/ops/pallas/spmm.py::_spmm_kernel (reached from
// spmm), in the first design of the port's aggregation, kept for spmm's
// own redesign: one warp owns one seg node, walks its segment one
// edge at a time, and accumulates w[order[j]] * h[oth[j]] in f32
// registers, lane l holding columns l, l+32, ...; every row is written
// once, zero for nodes without edges.
//
// What bounds it on this card: the row gathers, one h row per edge (E D 2
// B ~ 24 MB in bf16 at the fullevent shapes) from a table that stays in
// L2, one edge in flight per warp, each edge's weight a scattered 4-byte
// load, and the longest segment (the packed graph's pad node, 160 edges)
// sets a tail.
template <typename T, int kC>
__global__ void __launch_bounds__(kThreads)
spmm_kernel(int n_node, int d, const T* __restrict__ h,
            const float* __restrict__ w, Side side, T* __restrict__ out) {
  const int lane = threadIdx.x & (kWarp - 1);
  const long n = static_cast<long>(blockIdx.x) * kWarpsPerBlock +
                 (threadIdx.x / kWarp);
  if (n >= n_node) return;
  float acc[kC];
#pragma unroll
  for (int c = 0; c < kC; ++c) acc[c] = 0.f;
  for (int j = side.seg_ptr[n]; j < side.seg_ptr[n + 1]; ++j) {
    const long o = side.oth[j];
    const float wj = w[side.w_idx[j]];
#pragma unroll
    for (int c = 0; c < kC; ++c) {
      const int k = c * kWarp + lane;
      if (k < d) acc[c] += wj * to_f32(h[o * d + k]);
    }
  }
  store_row<kC>(out + n * d, acc, d, lane);
}

// Replaces: gnn_fpga_tpu/ops/pallas/spmm.py::_sddmm_kernel (reached from
// sddmm).  One warp per seg node n holds a[n] in registers and walks n's
// segment (a long segment goes to a block of its own, rows.cuh); its
// lanes split into groups of 2^log_lanes, one edge a group.  Each group
// loads its edges' rows b[o], edges_in_flight at a time; per edge each
// lane sums the products of its items, the group adds its lanes' sums
// (log_lanes shuffles, 3 at 8 lanes) and one lane writes the edge's value
// straight to its EDGE-order slot out[order[j]], which replaces the JAX
// kernel's sorted-order output and its take(..., inv_order).  The
// fullevent D = 66 rows (132 bytes in bf16, 264 in f32) are 33 items of 4
// or 8 bytes, 5 a lane in groups of 8 lanes (ops/cuda/spmm.py::
// row_launch).
//
// What bounds it on this card: not bytes.  At the fullevent shapes
// (V = 15,848, E = 180,736, D = 66) the tables are 2-4 MB and stay in the
// 50 MB L2, so the kernel moves 24 MB (bf16) or 48 MB (f32) of rows from
// L2 against a bound that counts b once (1.9 / 3.1 us), and f32 runs the
// faster; each warp's walk is a chain of dependent loads whose latency
// the resident warps hide.  Measured on an H100 (PERF.md): 0.013 ms in
// bf16 and 0.011 ms in f32, the same with and without the pad edges; the
// first design (a warp a node, 2- or 4-byte loads, a five-step warp
// reduction an edge) took 0.042 and 0.041 ms, much of it the pad node's
// 160-edge walk in the grid's last wave.
template <typename T, int N, int kI>
__global__ void __launch_bounds__(kThreads)
sddmm_kernel(int n_node, int row, int log_lanes,
             const Vec<T, N>* __restrict__ a,
             const Vec<T, N>* __restrict__ b, Side side,
             const int32_t* __restrict__ long_seg, int n_long,
             float* __restrict__ out) {
  constexpr int kU = gnn::edges_in_flight<kI, sizeof(Vec<T, N>)>();
  const Lanes ln(log_lanes);
  // blocks [0, n_long) walk the plan's long segments; the warps of the
  // blocks after them own one seg node each
  const bool whole = static_cast<int>(blockIdx.x) >= n_long;
  const long n = whole ? static_cast<long>(blockIdx.x - n_long) *
                                 kWarpsPerBlock + (threadIdx.x / kWarp)
                       : long_seg[blockIdx.x];
  if (n >= n_node) return;
  const int beg = side.seg_ptr[n], end = side.seg_ptr[n + 1];
  if (whole && end - beg > kLongSegment) return;   // its block takes it
  Vec<T, N> own[kI];   // as stored: bf16 pairs take half the registers
  load_row_items(own, a, n, row, ln);
  const Walk walk = Walk::of(beg, whole);
  for (int base = walk.first; base < end; base += walk.stride) {
    const int cnt = min(kWarp, end - base);
    const bool mine = ln.lane < cnt;
    const int o_l = mine ? side.oth[base + ln.lane] : 0;
    const int dst_l = mine ? side.w_idx[base + ln.lane] : 0;
    for (int k0 = 0; k0 < cnt; k0 += ln.groups * kU) {
      Vec<T, N> rows[kU][kI];
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        const int k = k0 + u * ln.groups + ln.group;
        // the same on every lane: whether the warp has edges left
        if (k0 + u * ln.groups < cnt) {
          const long o = __shfl_sync(kFull, o_l, k & (kWarp - 1));
          if (k < cnt) load_row_items(rows[u], b, o, row, ln);
        }
      }
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        const int k = k0 + u * ln.groups + ln.group;
        if (k0 + u * ln.groups >= cnt) continue;  // on every lane alike
        float part = 0.f;
#pragma unroll
        for (int i = 0; i < kI; ++i) {
          if (k >= cnt || ln.c0 + i * ln.lanes >= row) continue;
#pragma unroll
          for (int q = 0; q < N; ++q)
            part = fmaf(to_f32(own[i].v[q]), to_f32(rows[u][i].v[q]), part);
        }
        part = group_sum(part, ln.lanes);
        const int dst = __shfl_sync(kFull, dst_l, k & (kWarp - 1));
        if (k < cnt && ln.c0 == 0) out[dst] = part;
      }
    }
  }
}

// Replaces: gnn_fpga_tpu/ops/pallas/spmm.py::_sddmm_dual_kernel (reached
// from sddmm_dual).  One warp per seg node n holds p[n] and v[n] in
// registers, walks n's segment, gathers q[o] and u[o] for each edge,
// reduces the two dot products across the warp and writes the edge's
// value straight to its EDGE-order slot out[order[j]].
//
// What bounds it on this card: the row gathers, two rows of D elements
// per edge, and one warp reduction per edge.  At the fullevent shapes the
// tables stay in L2, so the limit is gather latency, hidden only by
// occupancy (V warps).
template <typename T, int kC>
__global__ void __launch_bounds__(kThreads)
sddmm_dual_kernel(int n_node, int d, const T* __restrict__ a,
                  const T* __restrict__ b, const T* __restrict__ u,
                  const T* __restrict__ v, Side side,
                  float* __restrict__ out) {
  const int lane = threadIdx.x & (kWarp - 1);
  const long n = static_cast<long>(blockIdx.x) * kWarpsPerBlock +
                 (threadIdx.x / kWarp);
  if (n >= n_node) return;
  float an[kC], vn[kC];
  load_row<kC>(an, a + n * d, d, lane);
  load_row<kC>(vn, v + n * d, d, lane);
  for (int j = side.seg_ptr[n]; j < side.seg_ptr[n + 1]; ++j) {
    const long o = side.oth[j];
    float part = 0.f;
#pragma unroll
    for (int c = 0; c < kC; ++c) {
      const int k = c * kWarp + lane;
      if (k < d) {
        part += an[c] * to_f32(b[o * d + k]);
        part += to_f32(u[o * d + k]) * vn[c];
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

// dtype: 0 = float32, 1 = bfloat16 (h, out).  w: [E] f32 edge weights in
// EDGE order; order maps each sorted position of the plan to its edge.
int gnn_spmm(int dtype, int n_node, int d, const void* h, const float* w,
             const int32_t* seg_ptr, const int32_t* oth,
             const int32_t* order, void* out, void* stream) {
  const unsigned blocks = gnn::blocks_for_warps(n_node);
  return dispatch(dtype, d, [&](auto var) {
    using T = typename decltype(var)::type;
    if (blocks > 0)
      spmm_kernel<T, decltype(var)::chunks>
          <<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
              n_node, d, static_cast<const T*>(h), w,
              Side{seg_ptr, oth, order}, static_cast<T*>(out));
    return static_cast<int>(cudaGetLastError());
  });
}

// a, b: [n_node, d] in dtype (as above); item_bytes, log_lanes:
// ops/cuda/spmm.py::row_launch (rows.cuh); long_seg [n_long]: the plan's
// nodes with more than kLongSegment edges (EdgePlan.long_seg).  out: [E]
// f32 in EDGE order.
int gnn_sddmm(int dtype, int n_node, int d, int item_bytes, int log_lanes,
              const void* a, const void* b, const int32_t* seg_ptr,
              const int32_t* oth, const int32_t* order,
              const int32_t* long_seg, int n_long, float* out,
              void* stream) {
  const RowItems ri{d, dtype == 0 ? 4 : 2, item_bytes, log_lanes};
  const void* tables[] = {a, b};
  const unsigned blocks = n_long + gnn::blocks_for_warps(n_node);
  return dispatch_rows(dtype, n_node, ri, tables, 2, n_long, 0,
                       [&](auto var) {
    using R = decltype(var);
    using Item = typename R::Item;
    if (blocks > 0)
      sddmm_kernel<typename R::type, R::n, R::items>
          <<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
              n_node, ri.row(), log_lanes, static_cast<const Item*>(a),
              static_cast<const Item*>(b), Side{seg_ptr, oth, order},
              long_seg, n_long, out);
    return static_cast<int>(cudaGetLastError());
  });
}

// p, q, u, v: [n_node, d] in dtype (as above).  out: [E] f32 in EDGE
// order.
int gnn_sddmm_dual(int dtype, int n_node, int d, const void* p,
                   const void* q, const void* u, const void* v,
                   const int32_t* seg_ptr, const int32_t* oth,
                   const int32_t* order, float* out, void* stream) {
  const unsigned blocks = gnn::blocks_for_warps(n_node);
  const Side side{seg_ptr, oth, order};
  return dispatch(dtype, d, [&](auto var) {
    using T = typename decltype(var)::type;
    constexpr int kC = decltype(var)::chunks;
    if (blocks > 0)
      sddmm_dual_kernel<T, kC>
          <<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
              n_node, d, static_cast<const T*>(p), static_cast<const T*>(q),
              static_cast<const T*>(u), static_cast<const T*>(v), side, out);
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
