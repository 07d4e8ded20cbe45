// Hand-written Hopper kernels for the single-direction sparse operations of
// ops/cuda/spmm.py:
//
//     sddmm:       out[e] = <a[seg(e)], b[oth(e)]>                     [E]
//     sddmm_dual:  out[e] = <p[seg(e)], q[oth(e)]> + <u[oth(e)], v[seg(e)]>
//
// (spmm, one direction of aggregate_pair's sum, is spmm.cu's kernel over
// one plan; the sorted segment sum is segment_sum.cu's.)
//
// Design.  The edges come in a CSR plan sorted by their seg endpoint
// (ops/cuda/spmm.py::EdgePlan), and one warp owns one seg node: it walks
// the node's contiguous segment and keeps the node's own rows in
// registers.  The sddmms read rows as rows.cuh lays them out (a group of
// lanes an edge, the widest item the row's alignment allows, segments of
// more than kLongSegment edges on blocks of their own).  Every output
// element has one owner and is written once: no atomics and no zero-fill,
// and results are identical from run to run.  The TPU kernels' windowed
// one-hot matmuls are not carried over: they exist because Mosaic has no
// large row gather, and Hopper gathers rows natively.
//
// Types: T = float or __nv_bfloat16 for the tables; accumulation and the
// outputs are f32.
//
// Interface: plain C functions, loaded with ctypes.  They launch on the
// given stream, allocate nothing, and return cudaGetLastError().

#include "rows.cuh"

namespace {

using gnn::dispatch_rows;
using gnn::group_sum;
using gnn::kFull;
using gnn::kLongSegment;
using gnn::kThreads;
using gnn::kWarp;
using gnn::kWarpsPerBlock;
using gnn::load_row_items;
using gnn::RowItems;
using gnn::Lanes;
using gnn::Side;
using gnn::to_f32;
using gnn::Vec;
using gnn::Walk;

// Replaces: gnn_fpga_tpu/ops/pallas/spmm.py::_sddmm_kernel (reached from
// sddmm) and, with kDual, ::_sddmm_dual_kernel (reached from sddmm_dual;
// `u` and `v` are read only then): the walk of both entry points below.
// One warp per seg node n holds its own rows a[n] (and v[n]) in registers
// and walks n's segment (a long segment goes to a block of its own,
// rows.cuh); its lanes split into groups of 2^log_lanes, one edge a group.
// Each group loads its edges' rows b[o] (and u[o]), edges_in_flight at a
// time; per edge each lane sums the products of its items, element by
// element a[n] b[o] and then u[o] v[n] (the order in which
// aggregate_pair_bwd sums dw), the group adds its lanes' sums (log_lanes
// shuffles, 3 at 8 lanes) and one lane writes the edge's value straight to
// its EDGE-order slot out[order[j]], which replaces the JAX kernels'
// sorted-order output and their take(..., inv_order).  The fullevent
// D = 66 rows (132 bytes in bf16, 264 in f32) are 33 items of 4 or 8
// bytes, 5 a lane in groups of 8 lanes (ops/cuda/spmm.py::row_launch):
// sddmm_dual holds 10 items of its own rows a lane and gathers 10 an edge.
//
// What bounds it on this card: not bytes.  At the fullevent shapes
// (V = 15,848, E = 180,736, D = 66) the tables are 2-4 MB and stay in the
// 50 MB L2, so sddmm moves 24 MB (bf16) or 48 MB (f32) of rows from L2,
// sddmm_dual twice that, against a bound that counts each table once
// (sddmm 1.9 / 3.1 us, sddmm_dual 3.1 / 5.6); each warp's walk is a chain
// of dependent loads (offsets, ids, rows) whose latency the resident warps
// hide, so the design keeps few registers a lane, many warps on each SM,
// and no walk longer than kLongSegment edges on one warp.  Measured on an
// NVIDIA H100 80GB HBM3 at 700 W (PERF.md): sddmm 0.013 ms in bf16 and
// 0.011 ms in f32, sddmm_dual 0.021 and 0.016 ms, each the same with and
// without the pad edges and sddmm_dual the same on four distinct tables
// as with h as q and v; the first designs (a warp a node, 2- or 4-byte
// loads, one edge in flight, a five-step warp reduction an edge) took
// 0.042 and 0.041 ms for sddmm and 0.047 and 0.046 ms for sddmm_dual, much
// of it the pad node's 160-edge walk in the grid's last wave.
template <typename T, int N, int kI, bool kDual>
__device__ __forceinline__ void sddmm_rows(
    int n_node, int row, int log_lanes, const Vec<T, N>* __restrict__ a,
    const Vec<T, N>* __restrict__ b, const Vec<T, N>* __restrict__ u,
    const Vec<T, N>* __restrict__ v, Side side,
    const int32_t* __restrict__ long_seg, int n_long,
    float* __restrict__ out) {
  // a lane holds kI items of each row it gathers: b[o], and u[o] if kDual
  constexpr int kU =
      gnn::edges_in_flight<(kDual ? 2 : 1) * kI, sizeof(Vec<T, N>)>();
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
  // as stored: bf16 pairs take half the registers
  Vec<T, N> own_a[kI], own_v[kI];
  load_row_items(own_a, a, n, row, ln);
  if constexpr (kDual) load_row_items(own_v, v, n, row, ln);
  const Walk walk = Walk::of(beg, whole);
  for (int base = walk.first; base < end; base += walk.stride) {
    const int cnt = min(kWarp, end - base);
    const bool mine = ln.lane < cnt;
    const int o_l = mine ? side.oth[base + ln.lane] : 0;
    const int dst_l = mine ? side.w_idx[base + ln.lane] : 0;
    for (int k0 = 0; k0 < cnt; k0 += ln.groups * kU) {
      Vec<T, N> rows_b[kU][kI], rows_u[kU][kI];
#pragma unroll
      for (int f = 0; f < kU; ++f) {
        const int k = k0 + f * ln.groups + ln.group;
        // the same on every lane: whether the warp has edges left
        if (k0 + f * ln.groups < cnt) {
          const long o = __shfl_sync(kFull, o_l, k & (kWarp - 1));
          if (k < cnt) {
            load_row_items(rows_b[f], b, o, row, ln);
            if constexpr (kDual) load_row_items(rows_u[f], u, o, row, ln);
          }
        }
      }
#pragma unroll
      for (int f = 0; f < kU; ++f) {
        const int k = k0 + f * ln.groups + ln.group;
        if (k0 + f * ln.groups >= cnt) continue;  // on every lane alike
        float part = 0.f;
#pragma unroll
        for (int i = 0; i < kI; ++i) {
          if (k >= cnt || ln.c0 + i * ln.lanes >= row) continue;
#pragma unroll
          for (int q = 0; q < N; ++q) {
            part = fmaf(to_f32(own_a[i].v[q]), to_f32(rows_b[f][i].v[q]),
                        part);
            if constexpr (kDual)
              part = fmaf(to_f32(rows_u[f][i].v[q]), to_f32(own_v[i].v[q]),
                          part);
          }
        }
        part = group_sum(part, ln.lanes);
        const int dst = __shfl_sync(kFull, dst_l, k & (kWarp - 1));
        if (k < cnt && ln.c0 == 0) out[dst] = part;
      }
    }
  }
}

// The entry points.  sddmm's takes no minimum of blocks an SM: at the
// fullevent D = 66 it then takes 48 registers and fits five blocks, as
// before it shared sddmm_rows; any minimum made ptxas schedule it
// otherwise, and it ran up to 8% slower in f32 (PERF.md).  sddmm_dual's,
// where a lane holds at most 10 elements of each row (D = 66: 5 items of
// 2), is held to four blocks an SM, 64 registers a thread: uncapped it
// took 66 (bf16) and 72 (f32), three blocks, and ran 1.2x and 1.08x
// slower; its D = 66 instances do not spill under the cap.
template <typename T, int N, int kI>
__global__ void __launch_bounds__(kThreads)
sddmm_kernel(int n_node, int row, int log_lanes,
             const Vec<T, N>* __restrict__ a,
             const Vec<T, N>* __restrict__ b, Side side,
             const int32_t* __restrict__ long_seg, int n_long,
             float* __restrict__ out) {
  sddmm_rows<T, N, kI, false>(n_node, row, log_lanes, a, b, nullptr,
                              nullptr, side, long_seg, n_long, out);
}

template <typename T, int N, int kI>
__global__ void __launch_bounds__(kThreads, kI * N <= 10 ? 4 : 1)
sddmm_two_pair_kernel(int n_node, int row, int log_lanes,
                      const Vec<T, N>* __restrict__ p,
                      const Vec<T, N>* __restrict__ q,
                      const Vec<T, N>* __restrict__ u,
                      const Vec<T, N>* __restrict__ v, Side side,
                      const int32_t* __restrict__ long_seg, int n_long,
                      float* __restrict__ out) {
  sddmm_rows<T, N, kI, true>(n_node, row, log_lanes, p, q, u, v, side,
                             long_seg, n_long, out);
}

// Launches sddmm_kernel, or with kDual sddmm_two_pair_kernel, over the
// tables a, b (and u, v), the rows of `ri`, after dispatch_rows checks
// them.
template <bool kDual>
int launch_sddmm(int dtype, int n_node, const RowItems& ri, const void* a,
                 const void* b, const void* u, const void* v, Side side,
                 const int32_t* long_seg, int n_long, float* out,
                 void* stream) {
  const void* tables[] = {a, b, u, v};
  const unsigned blocks = n_long + gnn::blocks_for_warps(n_node);
  return dispatch_rows(dtype, n_node, ri, tables, kDual ? 4 : 2, n_long, 0,
                       [&](auto var) {
    using R = decltype(var);
    using T = typename R::type;
    using Item = typename R::Item;
    const auto st = static_cast<cudaStream_t>(stream);
    const auto* ta = static_cast<const Item*>(a);
    const auto* tb = static_cast<const Item*>(b);
    if (blocks > 0) {
      if constexpr (kDual)
        sddmm_two_pair_kernel<T, R::n, R::items>
            <<<blocks, kThreads, 0, st>>>(
                n_node, ri.row(), ri.log_lanes, ta, tb,
                static_cast<const Item*>(u), static_cast<const Item*>(v),
                side, long_seg, n_long, out);
      else
        sddmm_kernel<T, R::n, R::items><<<blocks, kThreads, 0, st>>>(
            n_node, ri.row(), ri.log_lanes, ta, tb, side, long_seg, n_long,
            out);
    }
    return static_cast<int>(cudaGetLastError());
  });
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (the tables); a, b: [n_node, d];
// item_bytes, log_lanes: ops/cuda/spmm.py::row_launch (rows.cuh); the
// plan's CSR offsets, other endpoints and edge order; long_seg [n_long]:
// its nodes with more than kLongSegment edges (EdgePlan.long_seg).  out:
// [E] f32 in EDGE order.
int gnn_sddmm(int dtype, int n_node, int d, int item_bytes, int log_lanes,
              const void* a, const void* b, const int32_t* seg_ptr,
              const int32_t* oth, const int32_t* order,
              const int32_t* long_seg, int n_long, float* out,
              void* stream) {
  return launch_sddmm<false>(
      dtype, n_node, RowItems{d, dtype == 0 ? 4 : 2, item_bytes, log_lanes},
      a, b, nullptr, nullptr, Side{seg_ptr, oth, order}, long_seg, n_long,
      out, stream);
}

// p, q, u, v: [n_node, d] in dtype; the rest as for gnn_sddmm.
int gnn_sddmm_dual(int dtype, int n_node, int d, int item_bytes,
                   int log_lanes, const void* p, const void* q,
                   const void* u, const void* v, const int32_t* seg_ptr,
                   const int32_t* oth, const int32_t* order,
                   const int32_t* long_seg, int n_long, float* out,
                   void* stream) {
  return launch_sddmm<true>(
      dtype, n_node, RowItems{d, dtype == 0 ? 4 : 2, item_bytes, log_lanes},
      p, q, u, v, Side{seg_ptr, oth, order}, long_seg, n_long, out, stream);
}

}  // extern "C"
