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
// 16-byte aligned, else one element.  Each edge has a group of L lanes, L
// the power of two at or above `row`, at most 32; lane c of the group
// covers items c, c + L, ... of the row, so a row's 16-byte pieces are
// read by consecutive lanes (H = 64 bf16 is 8 lanes) and neighbouring
// groups store neighbouring rows.  A thread takes kUnroll edges, a block's
// worth of groups apart: it loads their ids once, then 2 * kUnroll items,
// then stores kUnroll sums, so several 16-byte loads are in flight.  No
// index is divided; edges and offsets are 64-bit.
//
// What bounds it on this card: bytes.  At the fullevent shapes (E = 180,736,
// H = 64, bf16) it writes 23 MB once and gathers 46 MB of rows from two
// 2 MB tables that stay in the 50 MB L2, plus 1.4 MB of ids: the write to
// device memory and the L2 gather bandwidth set the time.  Pad edges point
// at a pad node and are gathered like any other; the caller masks them.
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
using gnn::kThreads;
using gnn::kWarp;
using gnn::to_f32;

constexpr int kUnroll = 4;

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

// P is T (one element an item) or Pack<T> (16 bytes an item); `row` is the
// number of items in a row; each edge has 2^log_lanes lanes.
template <typename P>
__global__ void __launch_bounds__(kThreads)
gather_pair_kernel(long n_edge, int n_node, int row, int log_lanes,
                   const P* __restrict__ pa, const P* __restrict__ pb,
                   const int32_t* __restrict__ send,
                   const int32_t* __restrict__ recv, P* __restrict__ out) {
  const int lanes = 1 << log_lanes;
  const int lane = threadIdx.x & (lanes - 1);
  const int groups = kThreads >> log_lanes;   // edges a block takes at once
  const long e0 = static_cast<long>(blockIdx.x) * groups * kUnroll +
                  (threadIdx.x >> log_lanes);
  long src_a[kUnroll] = {}, src_b[kUnroll] = {};
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    const long e = e0 + static_cast<long>(u) * groups;
    if (e < n_edge) {
      const int s = send[e], r = recv[e];
      assert(0 <= s && s < n_node && 0 <= r && r < n_node);
      src_a[u] = static_cast<long>(s) * row;
      src_b[u] = static_cast<long>(r) * row;
    }
  }
  for (int c = lane; c < row; c += lanes) {
    P a[kUnroll], b[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (e0 + static_cast<long>(u) * groups < n_edge) {
        a[u] = pa[src_a[u] + c];
        b[u] = pb[src_b[u] + c];
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long e = e0 + static_cast<long>(u) * groups;
      if (e < n_edge) out[e * row + c] = add(a[u], b[u]);
    }
  }
}

template <typename P>
int launch(long n_edge, int n_node, int row, const void* pa, const void* pb,
           const int32_t* send, const int32_t* recv, void* out,
           cudaStream_t stream) {
  int log_lanes = 0;
  while ((1 << log_lanes) < row && (1 << log_lanes) < kWarp) ++log_lanes;
  const long per_block = static_cast<long>(kThreads >> log_lanes) * kUnroll;
  // at most 2^31 / 32 blocks: within the grid's limit, so no stride loop
  const long blocks = (n_edge + per_block - 1) / per_block;
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
