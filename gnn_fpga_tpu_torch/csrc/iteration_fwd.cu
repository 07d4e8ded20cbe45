// Hand-written Hopper kernels for the forward of the fused message-passing
// iteration, ops/cuda/spmm.py::iteration_pair:
//
//     pre[e] = (pa[s] + pb[r]) * em[e],   z[e] = tanh(pre[e] + b1)
//     w[e]   = sigmoid(z[e] . w2 + b2) * em[e]
//     mi[n]  = sum_{e: r==n} w[e] * h[s],   mo[n] = sum_{e: s==n} w[e] * h[r]
//
// Replaces: gnn_fpga_tpu/ops/pallas/spmm.py::_iter_pair_kernel (reached
// from _iteration_pair_fwd).  The TPU kernel walks edge tiles of the recv
// plan and turns every gather and scatter into a windowed one-hot matmul;
// here rows are gathered directly and only the sorted edge orders are
// kept.
//
// What bounds it on this card: bytes, at the fullevent shapes (V = 15,848,
// E = 180,736, H = 64, D = 66, bf16): the node tables (pa, pb, h: 6 MB)
// read once, the edge ids and masks (2.9 MB), mi and mo (4.2 MB) written
// once, 13 MB in all, ~4 us at 3.35 TB/s.  The gathers come from L2, where
// the tables stay.  The first design (one warp per node and direction
// walking the whole CSR segment and scoring every edge twice) took
// 0.234 ms: the pad node's 160-edge segment set its tail, each score cost
// a warp reduction on both sides, and one edge was in flight per warp.
//
// Design, three passes (PERF.md, PR 5):
//
// 1. score: each recv-sorted edge's weight once.  A lane group takes an
//    edge (8 lanes of 16-byte items cover a 128-byte bf16 row of pa or pb
//    at H = 64), each lane keeps kEdgeUnroll edges in flight, the ids and
//    em read coalesced; the group reduces z . w2 with log2(lanes) shuffles
//    and writes e_sorted[j] (f32, E floats).
// 2. walk: one warp per work item of IterItems (at most ITEM_EDGES edges
//    of one node and direction): it loads the ids, weights (through
//    send_in_recv on the send side) and h rows of kEdgeUnroll edges
//    (element pairs: 4-byte loads in bf16, D = 66 is 33 pairs) before any
//    FMA, sums w * h[oth] in f32 registers and writes the node's row in T,
//    zero for a node without edges; an item of a split node writes an f32
//    partial row to its slot instead.
// 3. combine (only when a node is split): one warp per split node sums its
//    items' partial rows in item order and writes mi and mo.
//
// No atomics: every output is written by one warp in a fixed order, so
// results are identical from run to run.  Types: T = float or
// __nv_bfloat16 for the tables, f32 for em, the weights and every sum;
// tanhf and expf are the accurate versions.
//
// Interface: a plain C function, loaded with ctypes.  It launches on the
// given stream, allocates nothing, and returns cudaGetLastError().

#include "iteration.cuh"

namespace {

using gnn::from_f32;
using gnn::group_sum;
using gnn::IterShape;
using gnn::kEdgeUnroll;
using gnn::kThreads;
using gnn::kWarp;
using gnn::kWarpsPerBlock;
using gnn::store_items;
using gnn::to_f32;
using gnn::Vec;

__device__ __forceinline__ float sigmoid(float x) {
  return 1.f / (1.f + expf(-x));
}

template <typename T, int N>
__device__ __forceinline__ void unpack(float (&dst)[N], const Vec<T, N>& v) {
#pragma unroll
  for (int q = 0; q < N; ++q) dst[q] = to_f32(v.v[q]);
}

// Items first + i * stride (i < kI) of a row of `n_items` items, in f32,
// zero past the row's end.
template <int kI, typename T, int N>
__device__ __forceinline__ void load_items(float (&dst)[kI][N],
                                           const Vec<T, N>* row, int n_items,
                                           int first, int stride) {
#pragma unroll
  for (int i = 0; i < kI; ++i) {
    const int c = first + i * stride;
    if (c < n_items) {
      unpack(dst[i], row[c]);
    } else {
#pragma unroll
      for (int q = 0; q < N; ++q) dst[i][q] = 0.f;
    }
  }
}

// The forward walk's inner loop: adds w[j] * tab[oth[j]] (w read through w_idx
// when it is not null) over the sorted positions [beg, end) into acc, lane
// l holding items l, l + 32, ... of a row of `row` items.
template <int kC, typename T, int N>
__device__ __forceinline__ void add_rows(float (&acc)[kC][N], int beg,
                                         int end, int row,
                                         const int32_t* __restrict__ oth,
                                         const int32_t* __restrict__ w_idx,
                                         const float* __restrict__ w,
                                         const Vec<T, N>* __restrict__ tab,
                                         int lane) {
  for (int j0 = beg; j0 < end; j0 += kEdgeUnroll) {
    long o[kEdgeUnroll];
    float wu[kEdgeUnroll];
#pragma unroll
    for (int u = 0; u < kEdgeUnroll; ++u) {
      const int j = j0 + u;
      o[u] = 0;
      wu[u] = 0.f;
      if (j < end) {
        o[u] = static_cast<long>(oth[j]) * row;
        wu[u] = w[w_idx ? w_idx[j] : j];
      }
    }
    Vec<T, N> x[kEdgeUnroll][kC];
#pragma unroll
    for (int u = 0; u < kEdgeUnroll; ++u)
#pragma unroll
      for (int c = 0; c < kC; ++c) {
        const int k = c * kWarp + lane;
        if (j0 + u < end && k < row) x[u][c] = tab[o[u] + k];
      }
#pragma unroll
    for (int u = 0; u < kEdgeUnroll; ++u)
#pragma unroll
      for (int c = 0; c < kC; ++c) {
        const int k = c * kWarp + lane;
        if (j0 + u < end && k < row)
#pragma unroll
          for (int q = 0; q < N; ++q)
            acc[c][q] += wu[u] * to_f32(x[u][c].v[q]);
      }
  }
}

// Calls f(std::integral_constant<int, K>{}) with K the least of {1, 2, 4, 8}
// at or above n (H items a lane), instantiating K up to kMax only.
template <int kMax, typename F>
int with_items(int n, F f) {
  if (n <= 1) return f(std::integral_constant<int, 1>{});
  if (n <= 2) return f(std::integral_constant<int, 2>{});
  if constexpr (kMax >= 4) {
    if (n <= 4) return f(std::integral_constant<int, 4>{});
    if (n <= 8) return f(std::integral_constant<int, 8>{});
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// Calls f(std::integral_constant<int, K>{}) with K the least of
// {1, 2, 3, 4, 8} at or above ceil(n / 32) (D row chunks a lane in a walk).
template <typename F>
int with_chunks(int n, F f) {
  const int c = (n + kWarp - 1) / kWarp;
  if (c <= 1) return f(std::integral_constant<int, 1>{});
  if (c == 2) return f(std::integral_constant<int, 2>{});
  if (c == 3) return f(std::integral_constant<int, 3>{});
  if (c == 4) return f(std::integral_constant<int, 4>{});
  if (c <= 8) return f(std::integral_constant<int, 8>{});
  return static_cast<int>(cudaErrorInvalidValue);
}

// Pass 1.  H rows of `row` items of N elements; kI items a lane.
template <typename T, int N, int kI>
__global__ void __launch_bounds__(kThreads)
score_kernel(long n_edge, int row, int log_lanes,
             const Vec<T, N>* __restrict__ pa,
             const Vec<T, N>* __restrict__ pb,
             const int32_t* __restrict__ snd, const int32_t* __restrict__ rcv,
             const float* __restrict__ em, const Vec<T, N>* __restrict__ w2,
             const Vec<T, N>* __restrict__ b1, const T* __restrict__ b2,
             float* __restrict__ e_out, float* __restrict__ sig_out) {
  const int lanes = 1 << log_lanes;
  const int lane = threadIdx.x & (lanes - 1);
  const int groups = kThreads >> log_lanes;
  const long e0 = static_cast<long>(blockIdx.x) * groups * kEdgeUnroll +
                  (threadIdx.x >> log_lanes);
  float b1r[kI][N], w2r[kI][N];
  load_items<kI>(b1r, b1, row, lane, lanes);
  load_items<kI>(w2r, w2, row, lane, lanes);
  const float bias2 = to_f32(b2[0]);

  long sa[kEdgeUnroll], sb[kEdgeUnroll];
  float emu[kEdgeUnroll], part[kEdgeUnroll];
#pragma unroll
  for (int u = 0; u < kEdgeUnroll; ++u) {
    const long e = e0 + static_cast<long>(u) * groups;
    const bool ok = e < n_edge;
    sa[u] = ok ? static_cast<long>(snd[e]) * row : 0;
    sb[u] = ok ? static_cast<long>(rcv[e]) * row : 0;
    emu[u] = ok ? em[e] : 0.f;
    part[u] = 0.f;
  }
#pragma unroll
  for (int i = 0; i < kI; ++i) {
    const int c = lane + i * lanes;
    if (c < row) {
      Vec<T, N> a[kEdgeUnroll], b[kEdgeUnroll];
#pragma unroll
      for (int u = 0; u < kEdgeUnroll; ++u) {
        if (e0 + static_cast<long>(u) * groups < n_edge) {
          a[u] = pa[sa[u] + c];
          b[u] = pb[sb[u] + c];
        }
      }
#pragma unroll
      for (int u = 0; u < kEdgeUnroll; ++u) {
        if (e0 + static_cast<long>(u) * groups < n_edge) {
#pragma unroll
          for (int q = 0; q < N; ++q) {
            // (pa[send] + pb[recv]) * em, in the plain version's order
            const float pre = (to_f32(a[u].v[q]) + to_f32(b[u].v[q])) * emu[u];
            part[u] += tanhf(pre + b1r[i][q]) * w2r[i][q];
          }
        }
      }
    }
  }
#pragma unroll
  for (int u = 0; u < kEdgeUnroll; ++u) {
    const float logit = group_sum(part[u], lanes) + bias2;
    const long e = e0 + static_cast<long>(u) * groups;
    if (e < n_edge && lane == 0) {
      const float sig = sigmoid(logit);
      sig_out[e] = sig;
      e_out[e] = sig * emu[u];
    }
  }
}

// Pass 2.  D rows of `row` items of N elements; kC items a lane.
template <typename T, int N, int kC>
__global__ void __launch_bounds__(kThreads)
walk_kernel(int n_item, int n_recv, int row, const Vec<T, N>* __restrict__ h,
            const float* __restrict__ e_sorted,
            const int32_t* __restrict__ send_in_recv,
            const int4* __restrict__ items,
            const int32_t* __restrict__ recv_oth,
            const int32_t* __restrict__ send_oth, Vec<T, N>* __restrict__ mi,
            Vec<T, N>* __restrict__ mo, Vec<float, N>* __restrict__ partial) {
  const int lane = threadIdx.x & (kWarp - 1);
  const int i = blockIdx.x * kWarpsPerBlock + threadIdx.x / kWarp;
  if (i >= n_item) return;
  const int4 it = items[i];            // beg, end, node, slot
  const bool by_send = i >= n_recv;
  float acc[kC][N];
#pragma unroll
  for (int c = 0; c < kC; ++c)
#pragma unroll
    for (int q = 0; q < N; ++q) acc[c][q] = 0.f;
  add_rows(acc, it.x, it.y, row, by_send ? send_oth : recv_oth,
           by_send ? send_in_recv : nullptr, e_sorted, h, lane);
  store_items(acc, (by_send ? mo : mi) + static_cast<long>(it.z) * row,
              it.w, partial, row, lane, kWarp);
}

// Pass 3.  One warp per split node (node, slot_beg, slot_mid, slot_end):
// mi from the slots [beg, mid), mo from [mid, end), each in slot order.
template <typename T>
__global__ void __launch_bounds__(kThreads)
combine_kernel(int n_split, int d, const int4* __restrict__ splits,
               const float* __restrict__ partial, T* __restrict__ mi,
               T* __restrict__ mo) {
  const int lane = threadIdx.x & (kWarp - 1);
  const int k = blockIdx.x * kWarpsPerBlock + threadIdx.x / kWarp;
  if (k >= n_split) return;
  const int4 sp = splits[k];
  for (int c = lane; c < d; c += kWarp) {
    float a = 0.f, b = 0.f;
    for (int s = sp.y; s < sp.z; ++s)
      a += partial[static_cast<long>(s) * d + c];
    for (int s = sp.z; s < sp.w; ++s)
      b += partial[static_cast<long>(s) * d + c];
    mi[static_cast<long>(sp.x) * d + c] = from_f32<T>(a);
    mo[static_cast<long>(sp.x) * d + c] = from_f32<T>(b);
  }
}

struct FwdArgs {
  const void *pa, *pb, *h, *w2, *b1, *b2;
  const float* em;
  const int32_t *send_in_recv, *recv_oth, *recv_seg, *send_oth;
  const int4* items;
  int n_item, n_recv;
  const int4* splits;
  int n_split;
  float *e_sorted, *sig_sorted, *partial;
  void *mi, *mo;
};

template <typename T, int NH, int ND>
int launch(const IterShape& sh, int log_lanes, int blocks, const FwdArgs& a,
           cudaStream_t st) {
  using VH = Vec<T, NH>;
  using VD = Vec<T, ND>;
  const int row_h = sh.row_h(), row_d = sh.row_d();
  int err = 0;
  if (blocks > 0) {
    const int lanes = 1 << log_lanes;
    err = with_items<NH == 1 ? 8 : 2>(
        (row_h + lanes - 1) / lanes, [&](auto ki) {
          score_kernel<T, NH, decltype(ki)::value>
              <<<blocks, kThreads, 0, st>>>(
                  sh.n_edge, row_h, log_lanes, static_cast<const VH*>(a.pa),
                  static_cast<const VH*>(a.pb), a.recv_oth, a.recv_seg, a.em,
                  static_cast<const VH*>(a.w2), static_cast<const VH*>(a.b1),
                  static_cast<const T*>(a.b2), a.e_sorted, a.sig_sorted);
          return static_cast<int>(cudaGetLastError());
        });
    if (err != 0) return err;
  }
  if (a.n_item > 0) {
    err = with_chunks(row_d, [&](auto kc) {
      walk_kernel<T, ND, decltype(kc)::value>
          <<<gnn::blocks_for_warps(a.n_item), kThreads, 0, st>>>(
              a.n_item, a.n_recv, row_d, static_cast<const VD*>(a.h),
              a.e_sorted, a.send_in_recv, a.items, a.recv_oth, a.send_oth,
              static_cast<VD*>(a.mi), static_cast<VD*>(a.mo),
              reinterpret_cast<Vec<float, ND>*>(a.partial));
      return static_cast<int>(cudaGetLastError());
    });
    if (err != 0) return err;
  }
  if (a.n_split > 0)
    combine_kernel<T><<<gnn::blocks_for_warps(a.n_split), kThreads, 0, st>>>(
        a.n_split, sh.d, a.splits, a.partial, static_cast<T*>(a.mi),
        static_cast<T*>(a.mo));
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_typed(IterShape sh, int log_lanes, int blocks, const FwdArgs& a,
                 cudaStream_t st) {
  sh.elem = sizeof(T);
  const void* h_rows[] = {a.pa, a.pb, a.w2, a.b1};
  const void* d_rows[] = {a.h, a.mi, a.mo};
  int err = sh.check(h_rows, 4, d_rows, 3);
  if (err == 0) err = sh.check_edge_pass(log_lanes, blocks);
  if (err != 0) return err;
  constexpr int kVecH = 16 / sizeof(T);
  if (sh.vec_h && sh.vec_d)
    return launch<T, kVecH, 2>(sh, log_lanes, blocks, a, st);
  if (sh.vec_h) return launch<T, kVecH, 1>(sh, log_lanes, blocks, a, st);
  if (sh.vec_d) return launch<T, 1, 2>(sh, log_lanes, blocks, a, st);
  return launch<T, 1, 1>(sh, log_lanes, blocks, a, st);
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (pa, pb, h, w2, b1, b2, mi, mo).
// vec_h, vec_d, log_lanes, blocks (of the score pass): ops/cuda/spmm.py::
// iteration_launch.  em: [E] f32 edge mask in the recv plan's order;
// send_in_recv: [E] position in the recv order of each send-sorted edge;
// recv_oth / recv_seg: senders / receivers in recv order; send_oth:
// receivers in send order.  items [n_item, 4], splits [n_split, 4]:
// IterItems.  Outputs besides mi, mo: e_sorted [E] f32 (the weights the
// walk sums with) and sig_sorted [E] f32 (the scores, which the backward
// takes); scratch: partial [n_slot, d] f32.
int gnn_iteration_pair_fwd(int dtype, int n_edge, int d, int hdim, int vec_h,
                           int vec_d, int log_lanes, int blocks,
                           const void* pa, const void* pb, const void* h,
                           const float* em, const int32_t* send_in_recv,
                           const void* w2, const void* b1, const void* b2,
                           const int32_t* recv_oth, const int32_t* recv_seg,
                           const int32_t* send_oth, const int32_t* items,
                           int n_item, int n_recv, const int32_t* splits,
                           int n_split, float* e_sorted, float* sig_sorted,
                           float* partial, void* mi, void* mo, void* stream) {
  const IterShape sh{n_edge, d, hdim, vec_h, vec_d, 0};
  const FwdArgs a{pa, pb, h, w2, b1, b2, em, send_in_recv, recv_oth,
                  recv_seg, send_oth, reinterpret_cast<const int4*>(items),
                  n_item, n_recv, reinterpret_cast<const int4*>(splits),
                  n_split, e_sorted, sig_sorted, partial, mi, mo};
  const auto st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_typed<float>(sh, log_lanes, blocks, a, st);
  if (dtype == 1)
    return launch_typed<__nv_bfloat16>(sh, log_lanes, blocks, a, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
