// Hand-written Hopper kernel for the SegmentClassifier's edge-weighted
// neighbour aggregations with the weights given (the unfused iteration's
// aggregate_pair), and for the op API's single-direction spmm, the same
// sum over one plan:
//
//     mi[n]  = sum_{e: recv[e]==n} w[e] * h[send[e]]
//     mo[n]  = sum_{e: send[e]==n} w[e] * h[recv[e]]
//     out[n] = sum_{e: seg[e]==n}  w[e] * h[oth[e]]          (spmm)
//
// The fused iteration, which scores the edges itself, is iteration_fwd.cu.
//
// Replaces: gnn_fpga_tpu/ops/pallas/spmm.py::_agg_pair_kernel (and its
// prebuilt-one-hot twin _agg_pair_kernel_pre), and ::_spmm_kernel (reached
// from spmm).  The TPU kernels turn every gather into a windowed one-hot
// matmul because Mosaic lacks a large dynamic row gather; on Hopper a row
// gather is native, so the kernel reads rows directly and keeps only the
// sorted edge orders.
//
// Design: rows.cuh's segment_rows_kernel, weighted.  Edges come in two CSR
// orders (the recv-sorted and send-sorted plans of ops/cuda/spmm.py); one
// warp owns one (node, direction), a node's two side by side, and sums w *
// h[oth] over its segment, a lane group an edge: the fullevent D = 66 rows
// (132 bytes in bf16, 264 in f32) are 33 items of 4 or 8 bytes, 5 a lane
// on 8 lanes, so one warp instruction reads 4 whole rows.  Each chunk of
// 32 edges brings its other endpoints and weights in two coalesced loads
// (the weights read through the plan's order, in edge order).  The groups'
// rows are added in a fixed order and the row written once, zero for
// nodes without edges; a segment of more than 32 edges (the packed graph's
// pad node has 160 each way) is walked by a block of its own at the front
// of the grid, whose warps' rows are added in warp order.  No atomics:
// results are identical from run to run.
//
// What bounds it on this card: not bytes.  At the fullevent shapes
// (V = 15,848, E = 180,736) it gathers one h row per edge and direction,
// 2 E D 2 B ~ 48 MB in bf16, from a 2 MB table that stays in the 50 MB
// L2, against a bound that counts h once (2.5 us); each warp's walk is a
// chain of dependent loads (offsets, ids and weights, rows) whose latency
// the resident warps hide, and each 132-byte row takes 5 loads a lane of
// 4-byte items (4-byte alignment allows no wider).  Measured on an NVIDIA
// H100 80GB HBM3 at 700 W (PERF.md): 0.026 ms in bf16 and 0.024 ms in
// f32, the same with and without the pad edges, against 0.036 and 0.033
// for the first design (a warp a node and direction, one element a lane,
// one edge in flight); at D = 64, whose rows are one 16-byte item on each
// of 8 lanes, the same kernel takes 0.016 ms.  spmm runs it with one side:
// a warp a node of the one plan, the plan's long segments on blocks of
// their own, half the grid of aggregate_pair: 0.013 ms in bf16 and 0.012
// ms in f32, the same with and without the pad edges, against 0.018 and
// 0.018 for its first design (a warp a node, one element a lane, one edge
// in flight, the pad node's segment on one warp).
//
// Types: T is float or __nv_bfloat16 for the tables; edge weights are f32;
// accumulation is f32; outputs are written in T.
//
// Interface: plain C functions, loaded with ctypes.  They launch on the
// given stream, allocate nothing, and return cudaGetLastError().

#include "rows.cuh"

extern "C" {

// h, mi, mo: [n_node, d] in dtype (0 = float32, 1 = bfloat16); w: [E] f32
// edge weights in EDGE order; item_bytes, log_lanes: ops/cuda/spmm.py::
// row_launch (rows.cuh).  Per plan: CSR offsets, the other endpoint and
// the edge of each sorted position, and the nodes with more than
// kLongSegment edges (EdgePlan.long_seg).
int gnn_aggregate_pair_fwd(int dtype, int n_node, int d, int item_bytes,
                           int log_lanes, const void* h, const float* w,
                           const int32_t* recv_ptr, const int32_t* recv_oth,
                           const int32_t* recv_order,
                           const int32_t* recv_long, int n_recv_long,
                           const int32_t* send_ptr, const int32_t* send_oth,
                           const int32_t* send_order,
                           const int32_t* send_long, int n_send_long,
                           void* mi, void* mo, void* stream) {
  const gnn::RowItems ri{d, dtype == 0 ? 4 : 2, item_bytes, log_lanes};
  return gnn::launch_segment_rows<true>(
      dtype, n_node, ri, h, w, gnn::Side{recv_ptr, recv_oth, recv_order},
      gnn::Side{send_ptr, send_oth, send_order}, recv_long, n_recv_long,
      send_long, n_send_long, mi, mo, stream);
}

// spmm over one plan: h, out: [n_node, d] in dtype; w, item_bytes,
// log_lanes as above; the plan's CSR offsets, other endpoints, edge order
// and long segments.
int gnn_spmm(int dtype, int n_node, int d, int item_bytes, int log_lanes,
             const void* h, const float* w, const int32_t* seg_ptr,
             const int32_t* oth, const int32_t* order,
             const int32_t* long_seg, int n_long, void* out, void* stream) {
  const gnn::RowItems ri{d, dtype == 0 ? 4 : 2, item_bytes, log_lanes};
  return gnn::launch_segment_rows<true>(
      dtype, n_node, ri, h, w, gnn::Side{seg_ptr, oth, order}, gnn::Side{},
      long_seg, n_long, nullptr, 0, out, nullptr, stream);
}

}  // extern "C"
