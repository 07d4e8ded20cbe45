// Hand-written Hopper kernels for ops/cuda/segment_sum.py's sorted segment
// sum:
//
//     out[n] = sum_{ids[e]==n} msgs[e]        msgs already sorted by id
//
// Replaces: gnn_fpga_tpu/ops/pallas/segment_sum.py::_segment_sum_kernel.
// The TPU kernel rank-compacts the sorted ids so that each edge tile is one
// [T, T] one-hot matmul, and scatters the compact sums to node rows with
// XLA afterwards.  Here the sorted ids and their CSR offsets ptr[n] say
// which node owns each row; rows whose id is n_node (padding) lie past
// ptr[n_node] and are never read.
//
// What bounds it on this card: reading the kept messages once, n_kept x D
// x sizeof(T) bytes (23.6 MB in bf16 at the fullevent 178,900 kept rows,
// D = 66), one add per element: device-memory bandwidth.  The rows are one
// contiguous stream, so the design streams it in equal tiles and leaves
// the degrees out of the split:
//
// 1. segment_tile_kernel: block t owns the sorted rows [t R, t R + R) of
//    the kept rows (R = tile_rows: 128 at the fullevent D = 66), whatever
//    nodes they belong to, so a hub or the pad node costs its rows and
//    leaves no tail.  The block copies the tile's bytes into shared memory
//    with one TMA bulk copy (cp.async.bulk on an mbarrier), from the
//    16-byte boundary at or below its first byte to the one at or above
//    its last (whatever D is, and whatever the base's alignment: a view is
//    handled here, never by the plain version), and skips the bytes
//    outside; until the copy lands its threads write the zero rows they
//    own and load their first pair's offsets.  Its
//    threads are then laid over the (node, unit) pairs of the nodes the
//    tile touches, a unit being one column or, where the width and the
//    base allow two-element loads, two (the fullevent D = 66 is 33
//    units), so no lane idles on a short last chunk of a row; each adds
//    its node's rows in the tile in row order, in f32 (under
//    precision="default" each f32 message rounded to bf16 first, as the
//    one-pass bf16 MXU product does).  A node whose rows lie wholly in the
//    tile is written to out, rounded once to T.  A node cut by a tile
//    boundary leaves the tile's f32 partial in part[t][0] (the node the
//    tile starts inside) or part[t][1] (the node that runs on past the
//    tile's end).  Nodes with no rows are written as zeros by this
//    launch: those between two nodes of one tile by the tile's pairs,
//    those between two tiles' nodes (before the first kept id, or whose
//    offset is the boundary) by the later tile, those past the last kept
//    id by the last tile, and with no kept rows at all every node by
//    block 0.
// 2. segment_cut_kernel, launched with programmatic dependence so that it
//    is ready when the tiles end: one warp a tile boundary; the warp of
//    the last boundary a cut node crosses adds the node's partials in tile
//    order (part[t0][1], then part[t][0] for t = t0 + 1 ... t1) and writes
//    the node, rounded once to T.
//
// So a node's sum is its rows added in order within each tile, the tiles'
// pieces in tile order.  Every output row has one writer: no atomics, no
// separate zero-fill, and two launches agree bit for bit.  Types: T = float or __nv_bfloat16 for
// messages and out; the sums and part are f32.
//
// Interface: a plain C function, loaded with ctypes.  It launches on the
// given stream, allocates nothing, and returns cudaGetLastError().

#include <type_traits>

#include "common.cuh"

namespace {

using gnn::from_f32;
using gnn::kThreads;
using gnn::kWarp;
using gnn::kWarpsPerBlock;
using gnn::to_f32;
using gnn::Vec;

// The shared memory a block can have: 227 KB.
constexpr long kMaxSmem = 227 * 1024;

// Shared memory for a tile of `bytes`: the 15 before and after it that its
// 16-byte copies may take, in whole 16-byte pieces.
inline long tile_smem(long bytes) { return (bytes + 30 + 15) / 16 * 16; }

// Copies `bytes` from src into `stage` with one TMA bulk copy, from the
// 16-byte boundary at or below src to the one at or above its end, issued
// by thread 0 and counted on the mbarrier `bar`; returns where src lies in
// the stage.
__device__ __forceinline__ int stage_span(char* stage, const char* src,
                                          long bytes, uint64_t* bar) {
  const char* lo16 = reinterpret_cast<const char*>(
      reinterpret_cast<uintptr_t>(src) & ~static_cast<uintptr_t>(15));
  if (threadIdx.x == 0) {
    const unsigned size =
        static_cast<unsigned>((src - lo16 + bytes + 15) / 16 * 16);
    const unsigned b = static_cast<unsigned>(__cvta_generic_to_shared(bar));
    const unsigned dst =
        static_cast<unsigned>(__cvta_generic_to_shared(stage));
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(b)
                 : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    asm volatile(
        "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(b),
        "r"(size)
        : "memory");
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
        " [%0], [%1], %2, [%3];" ::"r"(dst),
        "l"(lo16), "r"(size), "r"(b)
        : "memory");
  }
  return static_cast<int>(src - lo16);
}

// Waits on every thread for stage_span's copy; the block's barrier first
// makes thread 0's set-up of `bar` visible to the others.
__device__ __forceinline__ void wait_span(uint64_t* bar) {
  __syncthreads();
  const unsigned b = static_cast<unsigned>(__cvta_generic_to_shared(bar));
  asm volatile(
      "{\n .reg .pred done;\n WAIT_%=:\n"
      " mbarrier.try_wait.parity.shared::cta.b64 done, [%0], 0;\n"
      " @!done bra WAIT_%=;\n}" ::"r"(b)
      : "memory");
}

// Writes zeros to the rows of nodes [first, last) of out.
template <typename T>
__device__ __forceinline__ void zero_rows(T* __restrict__ out, long first,
                                          long last, int d) {
  for (long i = first * d + threadIdx.x; i < last * d; i += kThreads)
    out[i] = from_f32<T>(0.f);
}

// Block t: the tile of sorted rows [a, b) = [t R, t R + R) of the kept
// rows, staged in shared memory; its threads over the (node, unit) pairs
// of the nodes the tile touches, a unit being W columns (W divides d).
template <typename T, int W, bool kRound>
__global__ void __launch_bounds__(kThreads)
segment_tile_kernel(int n_node, long n_kept, int d, int tile_rows,
                    const T* __restrict__ msgs,
                    const int32_t* __restrict__ sorted_ids,
                    const int32_t* __restrict__ ptr, float* __restrict__ part,
                    T* __restrict__ out) {
  extern __shared__ __align__(16) char smem[];
  __shared__ uint64_t copied;   // the mbarrier of the tile's copy
  // the cut kernel may launch now: it waits for this grid before it reads
  // part
  asm volatile("griddepcontrol.launch_dependents;");
  const long t = blockIdx.x;
  const long a = t * tile_rows;
  const long b = min(a + tile_rows, n_kept);
  const int off =
      b > a ? stage_span(smem, reinterpret_cast<const char*>(msgs + a * d),
                         (b - a) * d * static_cast<long>(sizeof(T)), &copied)
            : 0;
  // while the copy is in flight: the nodes before the tile's first that no
  // tile holds (ids between two tiles' nodes, or before the first kept id)
  const int first = a < n_kept ? sorted_ids[a] : n_node;
  const int before = t == 0 ? -1 : sorted_ids[a - 1];
  zero_rows(out, before + 1L, first, d);
  if (b <= a) return;   // tile 0 with no kept rows: every node was zeroed
  const int last = sorted_ids[b - 1];
  if (b == n_kept) zero_rows(out, last + 1L, n_node, d);
  // pair p = k U + u: unit u of node first + k, stepped without division;
  // each pair's offsets are loaded before the previous pair is summed (the
  // first's while the copy is in flight)
  const int units = d / W;
  const long pairs = static_cast<long>(last - first + 1) * units;
  const int step_k = kThreads / units, step_u = kThreads % units;
  int k = threadIdx.x / units, u = threadIdx.x % units;
  long beg = 0, end = 0;
  if (threadIdx.x < pairs) {
    beg = ptr[first + k];
    end = ptr[first + k + 1];
  }
  wait_span(&copied);
  const T* rows = reinterpret_cast<const T*>(smem + off);
  for (long p = threadIdx.x; p < pairs; p += kThreads) {
    const int n = first + k;
    int k_next = k + step_k, u_next = u + step_u;
    if (u_next >= units) {
      u_next -= units;
      ++k_next;
    }
    long beg_next = 0, end_next = 0;
    if (p + kThreads < pairs) {
      beg_next = ptr[first + k_next];
      end_next = ptr[first + k_next + 1];
    }
    const int j0 = static_cast<int>(max(beg, a) - a);
    const int j1 = static_cast<int>(min(end, b) - a);
    const T* col = rows + u * W;
    float s[W];
#pragma unroll
    for (int w = 0; w < W; ++w) s[w] = 0.f;
#pragma unroll 4
    for (int j = j0; j < j1; ++j) {
      const Vec<T, W> x = *reinterpret_cast<const Vec<T, W>*>(col + j * d);
#pragma unroll
      for (int w = 0; w < W; ++w) {
        float m = to_f32(x.v[w]);
        if (kRound) m = __bfloat162float(__float2bfloat16(m));
        s[w] += m;
      }
    }
    if (beg >= a && end <= b) {
      *reinterpret_cast<Vec<T, W>*>(out + static_cast<long>(n) * d + u * W) =
          gnn::pack<T, W>(s);
    } else {   // cut: the node the tile starts inside, or the one running on
      float* dst = part + (2 * t + (beg < a ? 0 : 1)) * d + u * W;
#pragma unroll
      for (int w = 0; w < W; ++w) dst[w] = s[w];
    }
    k = k_next;
    u = u_next;
    beg = beg_next;
    end = end_next;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
segment_cut_kernel(int d, int tile_rows, long n_tiles,
                   const int32_t* __restrict__ sorted_ids,
                   const int32_t* __restrict__ ptr,
                   const float* __restrict__ part, T* __restrict__ out) {
  const int lane = threadIdx.x & (kWarp - 1);
  const long t = static_cast<long>(blockIdx.x) * kWarpsPerBlock +
                 threadIdx.x / kWarp + 1;   // the boundary at row t R
  if (t >= n_tiles) return;
  const long a = t * tile_rows;
  const int n = sorted_ids[a];
  const long beg = ptr[n], end = ptr[n + 1];
  // n is cut here; its last boundary (the tile holding its last row) takes
  // it
  if (beg >= a || (end - 1) / tile_rows != t) return;
  const long t0 = beg / tile_rows;
  // the partials are the tile kernel's: wait for it (a launch without
  // programmatic dependence finds it done)
  asm volatile("griddepcontrol.wait;" ::: "memory");
  for (int c = lane; c < d; c += kWarp) {
    float s = part[(2 * t0 + 1) * d + c];
    for (long u = t0 + 1; u <= t; ++u) s += part[2 * u * d + c];
    out[static_cast<long>(n) * d + c] = from_f32<T>(s);
  }
}

template <typename T, int W, bool kRound>
int launch(int n_kept, int n_node, int d, int tile_rows, const void* msgs,
           const int32_t* sorted_ids, const int32_t* ptr, float* part,
           void* out, cudaStream_t stream) {
  const long n_tiles =
      max(1L, (static_cast<long>(n_kept) + tile_rows - 1) / tile_rows);
  const size_t smem = tile_smem(static_cast<long>(tile_rows) * d * sizeof(T));
  auto* kern = segment_tile_kernel<T, W, kRound>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kern<<<static_cast<unsigned>(n_tiles), kThreads, smem, stream>>>(
      n_node, n_kept, d, tile_rows, static_cast<const T*>(msgs), sorted_ids,
      ptr, part, static_cast<T*>(out));
  if (n_tiles > 1) {
    // with programmatic dependence: it launches while the tiles run
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(gnn::blocks_for_warps(n_tiles - 1));
    cfg.blockDim = dim3(kThreads);
    cfg.stream = stream;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
    attr[0].val.programmaticStreamSerializationAllowed = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    const cudaError_t err = cudaLaunchKernelEx(
        &cfg, segment_cut_kernel<T>, d, tile_rows, n_tiles,
        sorted_ids, ptr, static_cast<const float*>(part),
        static_cast<T*>(out));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (msgs and out).  msgs: [E, d] in the
// segments' sorted order; sorted_ids: [E] int32 ids in [0, n_node]; ptr:
// [n_node + 1] CSR offsets; n_kept = ptr[n_node], the rows whose id is
// below n_node (SortedSegments.n_kept); tile_rows, unit (columns a thread
// takes): ops/cuda/segment_sum.py::segment_launch (unit 2 needs an even d
// and msgs aligned to two elements); part: [max(1, ceil(n_kept /
// tile_rows)), 2, d] f32 scratch; out: [n_node, d].
int gnn_sorted_segment_sum(int dtype, int n_kept, int n_node, int d,
                           int tile_rows, int unit, const void* msgs,
                           const int32_t* sorted_ids, const int32_t* ptr,
                           int round_bf16, float* part, void* out,
                           void* stream) {
  const int elem = dtype == 0 ? 4 : 2;
  if (n_kept < 0 || n_node < 0 || d < 1 || d > 8 * kWarp || tile_rows < 1 ||
      (dtype != 0 && dtype != 1) || (unit != 1 && unit != 2) ||
      d % unit != 0 || !gnn::aligned_to(msgs, unit * elem) ||
      tile_smem(static_cast<long>(tile_rows) * d * elem) > kMaxSmem)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto st = static_cast<cudaStream_t>(stream);
  auto go = [&](auto t, auto w, auto round) {
    using T = decltype(t);
    return launch<T, decltype(w)::value, decltype(round)::value>(
        n_kept, n_node, d, tile_rows, msgs, sorted_ids, ptr, part, out, st);
  };
  using One = std::integral_constant<int, 1>;
  using Two = std::integral_constant<int, 2>;
  using Exact = std::false_type;
  if (dtype == 1)
    return unit == 2 ? go(__nv_bfloat16{}, Two{}, Exact{})
                     : go(__nv_bfloat16{}, One{}, Exact{});
  if (round_bf16)
    return unit == 2 ? go(0.f, Two{}, std::true_type{})
                     : go(0.f, One{}, std::true_type{});
  return unit == 2 ? go(0.f, Two{}, Exact{}) : go(0.f, One{}, Exact{});
}

}  // extern "C"
