// Hand-written Hopper kernels of the port's probes (gnn_fpga_tpu_torch/
// probes/): instruments that measure this card, not parts of the model.
//
// 1. passthrough_kernel: out = x * 2 over a contiguous [E, D] table, f32 or
//    bf16, in 16-byte vectors.
//    Replaces: benchmarks/probe_bw.py::passthrough and benchmarks/
//    probe_ops.py::passthrough, the TPU's streaming-bandwidth probes.  The
//    TPU's knob, the tile of rows a grid step copies through VMEM, becomes
//    the number of 16-byte vectors a thread loads before it stores any
//    (1, 2 or 4): on this card that sets the bytes in flight.
//    Bound: bytes, 2 E D b (read once, written once).
// 2. gather_rows_kernel: out[j] = h[idx[j]] for [V, D] rows and [E] int32
//    ids, one item (16 bytes where the row and the tables allow) a thread,
//    neighbouring threads on neighbouring items of a row.
//    Replaces: benchmarks/probe_ops.py::gather_kernel_builder, the TPU's
//    row gather from a table held whole in VMEM.  Here the table is held
//    by the 50 MB L2 when it fits (8.4 MB at the probe's shape).
//    Bound: bytes, the ids, the table once and the output once.  An id
//    outside [0, V) stops the kernel at a device-side assert, as
//    index_select does.
// 3. ablate_rows_kernel<T, N, kI, kMode>: the single-direction SpMM of
//    spmm.cu (out[n] = sum_{seg=n} w h[oth], rows.cuh's
//    segment_rows_kernel over one plan) with parts taken out:
//      kFull      the same walk and arithmetic as segment_rows_kernel
//                 with one side, so its output equals spmm_raw's bit for
//                 bit: the anchor of the instrument to production;
//      kNoGather  the same segments and writes, the row of sorted edge j
//                 read at h[j mod 256] (the indirection taken out);
//      kNoScatter the gather and weights of kFull, summed over fixed
//                 groups of kAblateGroup sorted edges, one row written a
//                 group (the per-node segments and writes taken out);
//      kCompute   both: rows h[j mod 256] summed over the groups;
//      kIdsOnly   no rows: (sum w, sum oth as f32) a group, from the
//                 plan's ids and weights (the index traffic alone).
//    The group modes walk a group with a cluster of eight blocks (64 warps
//    on neighbouring SMs), whose rows meet in one block's shared memory
//    through the cluster's distributed shared memory.  The
//    "aligned" ablation is kFull on a copy of h whose rows are padded to
//    a 16-byte pitch, read as 16-byte items on the lanes kFull takes at
//    the unpadded width, so each column is summed in the same order and
//    its output equals kFull's bit for bit (ops/cuda/probes.py).
//    Replaces: benchmarks/probe_spmm_ablate.py::build and its bodies
//    k_full, k_nogather, k_noscatter, k_compute, k_onehot (whose one-hot
//    builds the port has none of: kIdsOnly reads the ids they are built
//    from) and k_aligned (the TPU's accumulation window aligned to 8
//    rows; on this card the alignment that matters is the row's).
//    Instantiated only for the row layouts the probes launch: those of
//    D = 128 and of the fullevent D = 66 (72 and 68 padded), f32 and bf16;
//    a width whose items and lanes match none of them is refused.
//    Bound: bytes; each mode's own (utils/flops.py::kernel_work).
//
// No atomics: every kernel here gives the same bits run to run.
//
// Interface: plain C functions, loaded with ctypes.  They launch on the
// given stream, allocate nothing, and return cudaGetLastError().

#include <cooperative_groups.h>

#include <cassert>

#include "rows.cuh"

namespace {

using gnn::kFull;
using gnn::kThreads;
using gnn::kWarp;
using gnn::kWarpsPerBlock;
using gnn::Lanes;
using gnn::Side;
using gnn::Vec;
using gnn::Walk;

// out = x * 2 on the n_vec 16-byte vectors of x: block b's thread t takes
// vectors b * kThreads * kV + t + i * kThreads, i < kV, all loaded before
// any is stored.  The n_tail elements after the vectors are taken by the
// first threads of block 0.
template <typename T, int kV>
__global__ void __launch_bounds__(kThreads)
passthrough_kernel(long n_vec, int n_tail, const Vec<T, 16 / sizeof(T)>* x,
                   Vec<T, 16 / sizeof(T)>* out) {
  constexpr int N = 16 / sizeof(T);
  const long base =
      static_cast<long>(blockIdx.x) * kThreads * kV + threadIdx.x;
  Vec<T, N> v[kV];
#pragma unroll
  for (int i = 0; i < kV; ++i) {
    const long k = base + static_cast<long>(i) * kThreads;
    if (k < n_vec) v[i] = x[k];
  }
#pragma unroll
  for (int i = 0; i < kV; ++i) {
    const long k = base + static_cast<long>(i) * kThreads;
    if (k >= n_vec) continue;
    Vec<T, N> o;
#pragma unroll
    for (int q = 0; q < N; ++q)
      o.v[q] = gnn::from_f32<T>(gnn::to_f32(v[i].v[q]) * 2.f);
    out[k] = o;
  }
  if (blockIdx.x == 0 && static_cast<int>(threadIdx.x) < n_tail) {
    const T* xs = reinterpret_cast<const T*>(x + n_vec);
    T* os = reinterpret_cast<T*>(out + n_vec);
    os[threadIdx.x] = gnn::from_f32<T>(gnn::to_f32(xs[threadIdx.x]) * 2.f);
  }
}

// out[j] = h[idx[j]], rows of `row` items I: thread k of the grid copies
// item k % row of output row k / row.
template <typename I>
__global__ void __launch_bounds__(kThreads)
gather_rows_kernel(long n_items, int row, int n_node,
                   const I* __restrict__ h, const int32_t* __restrict__ idx,
                   I* __restrict__ out) {
  const long k = static_cast<long>(blockIdx.x) * kThreads + threadIdx.x;
  if (k >= n_items) return;
  const long j = k / row;
  const int c = static_cast<int>(k - j * row);
  const int r = idx[j];
  assert(0 <= r && r < n_node);
  out[k] = h[static_cast<long>(r) * row + c];
}

enum Mode { kFullMode = 0, kNoGather = 1, kNoScatter = 2, kCompute = 3,
            kIdsOnly = 4 };

// Sorted edges a group of the group modes sums: the TPU probe's grid
// step (its tile of 256 edges times 8 subtiles).
constexpr int kAblateGroup = 2048;
// The rows kNoGather and kCompute read: h[j mod kStaticRows].
constexpr int kStaticRows = 256;

__host__ __device__ constexpr bool by_node(int mode) {
  return mode == kFullMode || mode == kNoGather;
}
__host__ __device__ constexpr bool gathers(int mode) {
  return mode == kFullMode || mode == kNoScatter;
}

// rows.cuh's sum_rows (weighted) with the row of sorted position j taken
// from side.oth[j] (kFull, kNoScatter) or as j mod kStaticRows (kNoGather,
// kCompute, which read no ids): the same chunks, groups, edges in flight
// and fmaf order.
template <int kMode, int kI, typename T, int N>
__device__ __forceinline__ void ablate_sum_rows(
    float (&acc)[kI][N], const Vec<T, N>* __restrict__ tab,
    const float* __restrict__ w, const Side& side, const Walk& walk, int end,
    int row, const Lanes& ln) {
  constexpr int kU = gnn::edges_in_flight<kI, sizeof(Vec<T, N>)>();
  for (int base = walk.first; base < end; base += walk.stride) {
    const int cnt = min(kWarp, end - base);
    const bool mine = ln.lane < cnt;
    int r_l = 0;
    if constexpr (gathers(kMode)) r_l = mine ? side.oth[base + ln.lane] : 0;
    const float w_l = mine ? w[side.w_idx[base + ln.lane]] : 0.f;
    for (int k0 = 0; k0 < cnt; k0 += ln.groups * kU) {
      Vec<T, N> rows[kU][kI];
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        const int k = k0 + u * ln.groups + ln.group;
        if (k0 + u * ln.groups < cnt) {
          long r;
          if constexpr (gathers(kMode))
            r = __shfl_sync(kFull, r_l, k & (kWarp - 1));
          else
            r = (base + k) % kStaticRows;
          if (k < cnt) gnn::load_row_items(rows[u], tab, r, row, ln);
        }
      }
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        const int k = k0 + u * ln.groups + ln.group;
        if (k0 + u * ln.groups >= cnt) continue;
        const float wk = __shfl_sync(kFull, w_l, k & (kWarp - 1));
        if (k >= cnt) continue;
#pragma unroll
        for (int i = 0; i < kI; ++i) {
          if (ln.c0 + i * ln.lanes >= row) continue;
#pragma unroll
          for (int q = 0; q < N; ++q)
            acc[i][q] = fmaf(wk, gnn::to_f32(rows[u][i].v[q]), acc[i][q]);
        }
      }
    }
  }
}

// kFull and kNoGather: segment_rows_kernel<T, N, kI, true> with one side
// (blocks [0, n_long) for the long segments, then a warp a node).
template <typename T, int N, int kI, int kMode>
__global__ void __launch_bounds__(kThreads)
ablate_rows_kernel(int n_node, int row, int log_lanes,
                   const Vec<T, N>* __restrict__ tab,
                   const float* __restrict__ w, Side side,
                   const int32_t* __restrict__ long_seg, int n_long,
                   Vec<T, N>* __restrict__ out) {
  const Lanes ln(log_lanes);
  const int warp = threadIdx.x / kWarp;
  const bool whole = static_cast<int>(blockIdx.x) >= n_long;
  long n;
  if (whole) {
    n = static_cast<long>(blockIdx.x - n_long) * kWarpsPerBlock + warp;
    if (n >= n_node) return;
  } else {
    n = long_seg[blockIdx.x];
    if (n < 0) return;
  }
  const int beg = side.seg_ptr[n], end = side.seg_ptr[n + 1];
  if (whole && end - beg > gnn::kLongSegment) return;
  float acc[kI][N];
  gnn::zero(acc);
  ablate_sum_rows<kMode>(acc, tab, w, side, Walk::of(beg, whole), end, row,
                         ln);
  gnn::sum_groups(acc, ln.lanes);
  Vec<T, N>* o = out + n * row;
  if (whole) {
    gnn::store_row_items(o, acc, row, ln);
    return;
  }
  __shared__ float part[kWarpsPerBlock][gnn::kMaxWidth];
  gnn::put_row(part[warp], acc, row, ln);
  __syncthreads();
  T* flat = reinterpret_cast<T*>(o);
  for (int col = threadIdx.x; col < row * N; col += kThreads)
    flat[col] = gnn::from_f32<T>(gnn::warp_order_sum(part, col));
}

// The group modes walk group g (sorted edges [g * kAblateGroup, ...)) with
// a cluster of kGroupBlocks blocks, which the card schedules together on
// neighbouring SMs: warp w of the cluster's kGroupWarps takes the group's
// chunks of 32 edges w, w + kGroupWarps, ... (one chunk each).  Each block
// adds its warps' rows in warp order and puts the sum into block 0's
// shared memory (the cluster's distributed shared memory); block 0 adds
// the blocks' rows in block order and writes row g.  At the probe's E =
// 131,072 that is 512 blocks, nearly four an SM, where a block a group
// (64 blocks) left half the card idle and four a group (256) held too
// few edges in flight at D = 128 (PERF.md, the SpMM ablation).
constexpr int kGroupBlocks = 8;
constexpr int kGroupWarps = kGroupBlocks * kWarpsPerBlock;

// A block may write into another block's shared memory only once every
// block of the cluster has started.  The group kernels split that cluster
// barrier in two: a block arrives as it starts and waits just before its
// first remote write, so the barrier's latency hides behind the row work.
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

template <typename T, int N, int kI, int kMode>
__global__ void __launch_bounds__(kThreads) __cluster_dims__(kGroupBlocks, 1, 1)
ablate_group_kernel(int n_edge, int row, int log_lanes,
                    const Vec<T, N>* __restrict__ tab,
                    const float* __restrict__ w, Side side,
                    Vec<T, N>* __restrict__ out) {
  namespace cg = cooperative_groups;
  const cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  cluster_arrive_relaxed();
  const Lanes ln(log_lanes);
  const int gw = rank * kWarpsPerBlock + threadIdx.x / kWarp;
  const int g = blockIdx.x / kGroupBlocks;
  const int beg = g * kAblateGroup;
  const int end = min(beg + kAblateGroup, n_edge);
  float acc[kI][N];
  gnn::zero(acc);
  ablate_sum_rows<kMode>(acc, tab, w, side,
                         Walk{beg + gw * kWarp, kGroupWarps * kWarp}, end,
                         row, ln);
  gnn::sum_groups(acc, ln.lanes);
  __shared__ float part[kWarpsPerBlock][gnn::kMaxWidth];
  __shared__ float blocks[kGroupBlocks][gnn::kMaxWidth];  // block 0's is read
  gnn::put_row(part[threadIdx.x / kWarp], acc, row, ln);
  __syncthreads();
  cluster_wait();
  float* to_first = cluster.map_shared_rank(&blocks[rank][0], 0);
  for (int col = threadIdx.x; col < row * N; col += kThreads)
    to_first[col] = gnn::warp_order_sum(part, col);
  cluster.sync();
  if (rank != 0) return;
  T* flat = reinterpret_cast<T*>(out + static_cast<long>(g) * row);
  for (int col = threadIdx.x; col < row * N; col += kThreads) {
    float sum = blocks[0][col];
    for (int k = 1; k < kGroupBlocks; ++k) sum += blocks[k][col];
    flat[col] = gnn::from_f32<T>(sum);
  }
}

// kIdsOnly: the group's sorted edges' ids and weights (side.oth, and w
// through side.w_idx) read lane by lane by a cluster as above, and out[g]
// = (sum w, sum oth as f32): each lane's sums added over its warp, the
// warps' in warp order by block 0.
__global__ void __launch_bounds__(kThreads) __cluster_dims__(kGroupBlocks, 1, 1)
ablate_ids_kernel(int n_edge, const float* __restrict__ w, Side side,
                  float2* __restrict__ out) {
  namespace cg = cooperative_groups;
  const cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  cluster_arrive_relaxed();
  const int lane = threadIdx.x & (kWarp - 1);
  const int gw = rank * kWarpsPerBlock + threadIdx.x / kWarp;
  const int g = blockIdx.x / kGroupBlocks;
  const int beg = g * kAblateGroup;
  const int end = min(beg + kAblateGroup, n_edge);
  float sw = 0.f, so = 0.f;
  for (int j = beg + gw * kWarp + lane; j < end; j += kGroupWarps * kWarp) {
    sw += w[side.w_idx[j]];
    so += static_cast<float>(side.oth[j]);
  }
  sw = gnn::warp_sum(sw);
  so = gnn::warp_sum(so);
  __shared__ float2 part[kGroupWarps];  // block 0's is read
  cluster_wait();
  if (lane == 0) *cluster.map_shared_rank(&part[gw], 0) = make_float2(sw, so);
  cluster.sync();
  if (rank != 0 || threadIdx.x != 0) return;
  float2 s = part[0];
  for (int k = 1; k < kGroupWarps; ++k) {
    s.x += part[k].x;
    s.y += part[k].y;
  }
  out[g] = s;
}

// Calls launch(Rows<T, N, kI>{}) for the rows the probes launch: D = 128
// (one 16-byte item a lane), D = 66 (5 items of 4 bf16 or 8 f32 bytes a
// lane on 8 lanes) and D = 66 padded to 72 in bf16 or 68 in f32 (2 or 3
// 16-byte items a lane on 8 lanes); anything else is refused.
template <typename Launch>
int with_probe_rows(int dtype, int item_bytes, int per_lane, Launch launch) {
  using gnn::Rows;
  using bf16 = __nv_bfloat16;
  if (dtype == 0 && item_bytes == 16 && per_lane <= 1)
    return launch(Rows<float, 4, 1>{});
  if (dtype == 0 && item_bytes == 16 && per_lane <= 4)
    return launch(Rows<float, 4, 4>{});
  if (dtype == 0 && item_bytes == 8 && per_lane <= 5)
    return launch(Rows<float, 2, 5>{});
  if (dtype == 1 && item_bytes == 16 && per_lane <= 1)
    return launch(Rows<bf16, 8, 1>{});
  if (dtype == 1 && item_bytes == 16 && per_lane <= 2)
    return launch(Rows<bf16, 8, 2>{});
  if (dtype == 1 && item_bytes == 4 && per_lane <= 5)
    return launch(Rows<bf16, 2, 5>{});
  return static_cast<int>(cudaErrorInvalidValue);
}

template <int kMode>
int launch_ablate(int dtype, int n_node, int n_edge, const gnn::RowItems& ri,
                  const void* tab, const float* w, Side side,
                  const int32_t* long_seg, int n_long, void* out,
                  cudaStream_t st) {
  const void* rows[] = {tab, out};
  const int err = ri.check(rows, 2);
  if (err != 0) return err;
  const unsigned blocks =
      by_node(kMode)
          ? n_long + gnn::blocks_for_warps(n_node)
          : (n_edge + kAblateGroup - 1) / kAblateGroup * kGroupBlocks;
  return with_probe_rows(dtype, ri.item_bytes, ri.per_lane(), [&](auto v) {
    using R = decltype(v);
    using Item = typename R::Item;
    const auto* t = static_cast<const Item*>(tab);
    auto* o = static_cast<Item*>(out);
    if (blocks == 0) return 0;
    if constexpr (by_node(kMode))
      ablate_rows_kernel<typename R::type, R::n, R::items, kMode>
          <<<blocks, kThreads, 0, st>>>(n_node, ri.row(), ri.log_lanes, t,
                                        w, side, long_seg, n_long, o);
    else
      ablate_group_kernel<typename R::type, R::n, R::items, kMode>
          <<<blocks, kThreads, 0, st>>>(n_edge, ri.row(), ri.log_lanes, t,
                                        w, side, o);
    return static_cast<int>(cudaGetLastError());
  });
}

}  // namespace

extern "C" {

// x, out: n elements of dtype (0 = float32, 1 = bfloat16), 16-byte
// aligned; vectors: 16-byte vectors a thread, 1, 2 or 4.
int gnn_passthrough(int dtype, long n, int vectors, const void* x, void* out,
                    void* stream) {
  const int elem = dtype == 0 ? 4 : 2;
  if ((dtype != 0 && dtype != 1) || n < 0 ||
      !gnn::aligned_to(x, 16) || !gnn::aligned_to(out, 16) ||
      (vectors != 1 && vectors != 2 && vectors != 4))
    return static_cast<int>(cudaErrorInvalidValue);
  const long n_vec = n * elem / 16;
  const int n_tail = static_cast<int>(n - n_vec * 16 / elem);
  const long per_block = static_cast<long>(kThreads) * vectors;
  long n_blocks = (n_vec + per_block - 1) / per_block;
  if (n_blocks == 0 && n_tail > 0) n_blocks = 1;
  const unsigned blocks = static_cast<unsigned>(n_blocks);
  if (blocks == 0) return 0;
  const auto st = static_cast<cudaStream_t>(stream);
  auto go = [&](auto t, auto kv) {
    using T = decltype(t);
    using V = Vec<T, 16 / sizeof(T)>;
    passthrough_kernel<T, decltype(kv)::value><<<blocks, kThreads, 0, st>>>(
        n_vec, n_tail, static_cast<const V*>(x), static_cast<V*>(out));
    return static_cast<int>(cudaGetLastError());
  };
  using std::integral_constant;
  auto with_v = [&](auto t) {
    if (vectors == 1) return go(t, integral_constant<int, 1>{});
    if (vectors == 2) return go(t, integral_constant<int, 2>{});
    return go(t, integral_constant<int, 4>{});
  };
  return dtype == 0 ? with_v(0.f) : with_v(__nv_bfloat16{});
}

// h: [n_node, row_bytes / item_bytes items]; idx: [n_edge] int32;
// out: [n_edge, same]; item_bytes: 16, 8, 4 or 2, dividing row_bytes and
// the three base addresses.
int gnn_gather_rows(int n_node, int n_edge, int row_bytes, int item_bytes,
                    const void* h, const int32_t* idx, void* out,
                    void* stream) {
  if (n_node < 0 || n_edge < 0 || row_bytes < 0 ||
      (item_bytes != 16 && item_bytes != 8 && item_bytes != 4 &&
       item_bytes != 2) ||
      row_bytes % item_bytes != 0 || !gnn::aligned_to(h, item_bytes) ||
      !gnn::aligned_to(out, item_bytes))
    return static_cast<int>(cudaErrorInvalidValue);
  const int row = row_bytes / item_bytes;
  const long n_items = static_cast<long>(n_edge) * row;
  if (n_items == 0) return 0;
  const unsigned blocks =
      static_cast<unsigned>((n_items + kThreads - 1) / kThreads);
  const auto st = static_cast<cudaStream_t>(stream);
  auto go = [&](auto item) {
    using I = decltype(item);
    gather_rows_kernel<I><<<blocks, kThreads, 0, st>>>(
        n_items, row, n_node, static_cast<const I*>(h), idx,
        static_cast<I*>(out));
    return static_cast<int>(cudaGetLastError());
  };
  if (item_bytes == 16) return go(uint4{});
  if (item_bytes == 8) return go(uint2{});
  if (item_bytes == 4) return go(uint32_t{});
  return go(uint16_t{});
}

// mode: 0 full, 1 no_gather, 2 no_scatter, 3 compute, 4 ids_only.  h:
// [n_node, width] in dtype (width: the row's elements, the padded pitch
// for the aligned ablation); w: [n_edge] f32 in EDGE order, read through
// `order`; seg_ptr, oth, order, long_seg (n_long entries): one EdgePlan;
// item_bytes, log_lanes: the rows' items and lanes (rows.cuh).  out:
// [n_node, width] (modes 0, 1), [G, width] (2, 3) in dtype, or [G, 2] f32
// (4), G = ceil(n_edge / 2048).  Modes 1 and 3 need n_node >= 256.
int gnn_ablate_rows(int mode, int dtype, int n_node, int n_edge, int width,
                    int item_bytes, int log_lanes, const void* h,
                    const float* w, const int32_t* seg_ptr,
                    const int32_t* oth, const int32_t* order,
                    const int32_t* long_seg, int n_long, void* out,
                    void* stream) {
  if (n_node < 0 || n_edge < 0 || n_long < 0 || (dtype != 0 && dtype != 1) ||
      ((mode == kNoGather || mode == kCompute) && n_node < kStaticRows))
    return static_cast<int>(cudaErrorInvalidValue);
  const Side side{seg_ptr, oth, order};
  const auto st = static_cast<cudaStream_t>(stream);
  if (mode == kIdsOnly) {
    const unsigned blocks =
        (n_edge + kAblateGroup - 1) / kAblateGroup * kGroupBlocks;
    if (blocks > 0)
      ablate_ids_kernel<<<blocks, kThreads, 0, st>>>(
          n_edge, w, side, static_cast<float2*>(out));
    return static_cast<int>(cudaGetLastError());
  }
  const gnn::RowItems ri{width, dtype == 0 ? 4 : 2, item_bytes, log_lanes};
  switch (mode) {
    case kFullMode:
      return launch_ablate<kFullMode>(dtype, n_node, n_edge, ri, h, w, side,
                                      long_seg, n_long, out, st);
    case kNoGather:
      return launch_ablate<kNoGather>(dtype, n_node, n_edge, ri, h, w, side,
                                      long_seg, n_long, out, st);
    case kNoScatter:
      return launch_ablate<kNoScatter>(dtype, n_node, n_edge, ri, h, w,
                                       side, long_seg, n_long, out, st);
    case kCompute:
      return launch_ablate<kCompute>(dtype, n_node, n_edge, ri, h, w, side,
                                     long_seg, n_long, out, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
