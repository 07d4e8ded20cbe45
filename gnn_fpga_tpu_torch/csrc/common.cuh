// Helpers shared by the message-passing kernels (spmm.cu, spmm_bwd.cu,
// spmm_ops.cu, segment_sum.cu, gather.cu, iteration_fwd.cu,
// iteration_bwd.cu).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace gnn {

constexpr int kWarp = 32;
constexpr int kWarpsPerBlock = 8;
constexpr int kThreads = kWarpsPerBlock * kWarp;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// N consecutive elements of a row, loaded and stored as one access of
// N * sizeof(T) bytes (the pointer must be aligned to that).
template <typename T, int N>
struct alignas(N * sizeof(T)) Vec {
  static constexpr int n = N;
  T v[N];
};

// A warp's lanes in groups of 2^log_lanes, one edge a group.
struct Lanes {
  int lane, c0, group, groups, lanes;

  __device__ explicit Lanes(int log_lanes)
      : lane(threadIdx.x & (kWarp - 1)),
        c0(lane & ((1 << log_lanes) - 1)),
        group(lane >> log_lanes),
        groups(kWarp >> log_lanes),
        lanes(1 << log_lanes) {}
};

// A lane's items c0, c0 + lanes, ... of row `r` of a table of rows of
// `row` items, as stored; items past the row are left as they are.
template <int kI, typename V>
__device__ __forceinline__ void load_row_items(V (&dst)[kI],
                                               const V* __restrict__ tab,
                                               long r, int row,
                                               const Lanes& ln) {
#pragma unroll
  for (int i = 0; i < kI; ++i) {
    const int c = ln.c0 + i * ln.lanes;
    if (c < row) dst[i] = tab[r * row + c];
  }
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = kWarp / 2; off > 0; off >>= 1)
    v += __shfl_xor_sync(kFull, v, off);
  return v;
}

// Sum over an aligned group of `lanes` lanes (a power of two, at most 32):
// every lane of the warp calls it, every lane of a group gets its sum.
__device__ __forceinline__ float group_sum(float v, int lanes) {
  for (int off = lanes >> 1; off > 0; off >>= 1)
    v += __shfl_xor_sync(kFull, v, off);
  return v;
}

// The sum of a warp's groups of `lanes` lanes, on every lane, in a fixed
// order (xor partners: group g adds g ^ 1, then g ^ 2, ...).
template <int kI, int N>
__device__ __forceinline__ void sum_groups(float (&acc)[kI][N], int lanes) {
  for (int off = lanes; off < kWarp; off <<= 1)
#pragma unroll
    for (int k = 0; k < kI; ++k)
#pragma unroll
      for (int q = 0; q < N; ++q)
        acc[k][q] += __shfl_xor_sync(kFull, acc[k][q], off);
}

template <typename T, int N>
__device__ __forceinline__ Vec<T, N> pack(const float (&src)[N]) {
  Vec<T, N> r;
#pragma unroll
  for (int q = 0; q < N; ++q) r.v[q] = from_f32<T>(src[q]);
  return r;
}

// One CSR direction: segment offsets, the row each sorted edge reads (its
// other endpoint's; for a table in edge order, gather_pair_bwd's g, the
// edge's own: the plan's order), and where each sorted edge's weight or
// edge-order output lives (the plan's order; null where a kernel needs
// neither).
struct Side {
  const int32_t* seg_ptr;  // [V + 1]
  const int32_t* oth;      // [E]
  const int32_t* w_idx;    // [E] or null
};

inline bool aligned_to(const void* p, int bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

inline unsigned blocks_for_warps(long warps) {
  return static_cast<unsigned>((warps + kWarpsPerBlock - 1) / kWarpsPerBlock);
}

}  // namespace gnn
