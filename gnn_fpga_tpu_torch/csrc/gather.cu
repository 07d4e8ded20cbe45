// Hand-written Hopper kernel for the forward of ops/cuda/spmm.py::gather_pair,
// the projection-form first layer of the edge MLP:
//
//     out[e] = pa[send[e]] + pb[recv[e]]        [E, H], EDGE order
//
// Replaces: gnn_fpga_tpu/ops/pallas/spmm.py::_gather_pair_kernel (called by
// _gather_pair_raw).  The TPU kernel walks the recv plan's tiles, rebuilds
// each gather as a windowed one-hot matmul (Mosaic has no large dynamic row
// gather), writes f32 rows in sorted order and reorders them with
// take(inv_order).  On Hopper a row gather is native: the kernel reads the
// two rows of each edge straight from the ids in edge order, so it needs no
// plan and no reorder, and writes the sum once in the tables' type.
//
// Numbers: each element is round(f32(a) + f32(b)), one rounding from the
// f32 sum (__fadd_rn, never contracted), which is what PyTorch's
// pa.index_select(0, s) + pb.index_select(0, r) computes on the card, so
// the kernel and its plain version agree bit for bit in f32 and in bf16.
//
// Design.  A row is `row` items, an item being 16 bytes (8 bf16 or 4 f32)
// when the row's bytes are a multiple of 16 and the three pointers are
// 16-byte aligned, else one element (a misaligned view).  Each edge has a
// group of L lanes, L the power of two at or above `row`, at most 32;
// lane c of the group covers items c, c + L, ... of the row, so a row's
// 16-byte pieces are read by consecutive lanes (H = 64: 8 lanes in bf16,
// 16 in f32).  A warp takes the edges in chunks of 32: one coalesced load
// brings the chunk's 32 senders and 32 receivers, and the groups take
// their edges' ids from those lanes by shuffle, so no id is loaded twice.
// Group g takes edges g, g + G, ... of the chunk (G = 32 / L groups a
// warp), kEdgesInFlight at a time: it loads all their items before it
// stores any, so 8 16-byte loads a lane are in flight, and neighbouring
// groups store neighbouring rows.  The output is written with streaming
// stores (st.global.cs): it is written once and never read back, and
// evict-first stores keep the 46 MB (f32) stream from evicting the two
// tables, which every edge gathers again, from the 50 MB L2.  Neither 2
// nor 8 edges in flight, nor a persistent grid-stride grid, ran faster
// (PERF.md, PR 9).  No index is divided; edges and offsets are 64-bit.
//
// What bounds it on this card: bytes.  At the fullevent shapes (E = 180,736,
// H = 64) it writes 23 MB (bf16) or 46 MB (f32) once and gathers twice
// that of rows from two 2 or 4 MB tables that stay in L2, plus 1.4 MB of
// ids: the write to device memory and the L2 gather bandwidth set the
// time.  Pad edges point at a pad node and are gathered like any other;
// the caller masks them.
//
// An id outside [0, V) stops the kernel at a device-side assert, as
// PyTorch's own index_select does on the card: it never reads past a
// table, and the error surfaces at the next synchronisation.
//
// Interface: a plain C function, loaded with ctypes.  It launches on the
// given stream, allocates nothing, and returns cudaGetLastError().

#include <cassert>

#include "common.cuh"

namespace {

using gnn::from_f32;
using gnn::kFull;
using gnn::kThreads;
using gnn::kWarp;
using gnn::kWarpsPerBlock;
using gnn::to_f32;

// 16 bytes of a row: the unit of the vector path.
template <typename T>
using Pack = gnn::Vec<T, 16 / sizeof(T)>;

__device__ __forceinline__ float add(float a, float b) {
  return __fadd_rn(a, b);
}

__device__ __forceinline__ __nv_bfloat16 add(__nv_bfloat16 a,
                                             __nv_bfloat16 b) {
  return from_f32<__nv_bfloat16>(__fadd_rn(to_f32(a), to_f32(b)));
}

template <typename T>
__device__ __forceinline__ Pack<T> add(const Pack<T>& a, const Pack<T>& b) {
  Pack<T> r;
#pragma unroll
  for (int k = 0; k < Pack<T>::n; ++k) r.v[k] = add(a.v[k], b.v[k]);
  return r;
}

// Streaming (evict-first) stores of one item.
__device__ __forceinline__ void store_cs(float* p, float v) { __stcs(p, v); }

__device__ __forceinline__ void store_cs(__nv_bfloat16* p, __nv_bfloat16 v) {
  __stcs(reinterpret_cast<unsigned short*>(p), __bfloat16_as_ushort(v));
}

template <typename T>
__device__ __forceinline__ void store_cs(Pack<T>* p, const Pack<T>& v) {
  __stcs(reinterpret_cast<uint4*>(p), *reinterpret_cast<const uint4*>(&v));
}

constexpr int kEdgesInFlight = 4;   // a lane group's edges in flight

// P is T (one element an item) or Pack<T> (16 bytes an item); `row` is the
// number of items in a row; each edge has 2^log_lanes lanes; each warp
// takes one chunk of 32 edges.
template <typename P>
__global__ void __launch_bounds__(kThreads)
gather_pair_kernel(long n_edge, int n_node, int row, int log_lanes,
                   const P* __restrict__ pa, const P* __restrict__ pb,
                   const int32_t* __restrict__ send,
                   const int32_t* __restrict__ recv, P* __restrict__ out) {
  constexpr int kU = kEdgesInFlight;
  const int lane = threadIdx.x & (kWarp - 1);
  const int lanes = 1 << log_lanes;
  const int c0 = lane & (lanes - 1);
  const int group = lane >> log_lanes;
  const int groups = kWarp >> log_lanes;
  const long e0 = (static_cast<long>(blockIdx.x) * kWarpsPerBlock +
                   threadIdx.x / kWarp) * kWarp;
  if (e0 >= n_edge) return;
  const int cnt = static_cast<int>(min(static_cast<long>(kWarp),
                                       n_edge - e0));
  int s_l = 0, r_l = 0;
  if (lane < cnt) {
    s_l = send[e0 + lane];
    r_l = recv[e0 + lane];
    assert(0 <= s_l && s_l < n_node && 0 <= r_l && r_l < n_node);
  }
  for (int k0 = 0; k0 < cnt; k0 += groups * kU) {
    const P* src_a[kU];
    const P* src_b[kU];
    bool mine[kU];
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const int k = k0 + u * groups + group;
      mine[u] = k < cnt;
      src_a[u] = pa + static_cast<long>(__shfl_sync(kFull, s_l, k & 31)) *
                          row;
      src_b[u] = pb + static_cast<long>(__shfl_sync(kFull, r_l, k & 31)) *
                          row;
    }
    for (int c = c0; c < row; c += lanes) {
      P a[kU], b[kU];
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        if (mine[u]) {
          a[u] = src_a[u][c];
          b[u] = src_b[u][c];
        }
      }
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        const long e = e0 + k0 + u * groups + group;
        if (mine[u]) store_cs(out + e * row + c, add(a[u], b[u]));
      }
    }
  }
}

template <typename P>
int launch(long n_edge, int n_node, int row, const void* pa, const void* pb,
           const int32_t* send, const int32_t* recv, void* out,
           cudaStream_t stream) {
  int log_lanes = 0;
  while ((1 << log_lanes) < row && (1 << log_lanes) < kWarp) ++log_lanes;
  // one chunk of 32 edges a warp: at most 2^31 / 256 blocks, within the
  // grid's limit
  const long blocks = (n_edge + kThreads - 1) / kThreads;
  if (blocks > 0 && row > 0)
    gather_pair_kernel<P><<<static_cast<unsigned>(blocks), kThreads, 0,
                            stream>>>(
        n_edge, n_node, row, log_lanes, static_cast<const P*>(pa),
        static_cast<const P*>(pb), send, recv, static_cast<P*>(out));
  return static_cast<int>(cudaGetLastError());
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

template <typename T>
int launch_typed(long n_edge, int n_node, int hdim, const void* pa,
                 const void* pb, const int32_t* send, const int32_t* recv,
                 void* out, cudaStream_t stream) {
  constexpr int kPer = Pack<T>::n;
  if (hdim % kPer == 0 && aligned16(pa) && aligned16(pb) && aligned16(out))
    return launch<Pack<T>>(n_edge, n_node, hdim / kPer, pa, pb, send, recv,
                           out, stream);
  return launch<T>(n_edge, n_node, hdim, pa, pb, send, recv, out, stream);
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (pa, pb, out).  pa, pb: [n_node, hdim];
// send, recv: [n_edge] int32 ids in [0, n_node); out: [n_edge, hdim].
int gnn_gather_pair_fwd(int dtype, int n_edge, int n_node, int hdim,
                        const void* pa, const void* pb, const int32_t* send,
                        const int32_t* recv, void* out, void* stream) {
  if (n_edge < 0 || n_node < 0 || hdim < 0 || hdim > 8 * kWarp ||
      (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_typed<float>(n_edge, n_node, hdim, pa, pb, send, recv, out,
                               st);
  return launch_typed<__nv_bfloat16>(n_edge, n_node, hdim, pa, pb, send, recv,
                                     out, st);
}

}  // extern "C"
