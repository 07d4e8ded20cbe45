// Helpers shared by the message-passing kernels (spmm.cu, spmm_bwd.cu,
// spmm_ops.cu, gather.cu).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace gnn {

constexpr int kWarp = 32;
constexpr int kWarpsPerBlock = 8;
constexpr int kThreads = kWarpsPerBlock * kWarp;

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

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = kWarp / 2; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// One row of `width` columns in registers: lane l holds columns l, l+32, ...
template <int kC, typename T>
__device__ __forceinline__ void load_row(float (&dst)[kC], const T* row,
                                         int width, int lane) {
#pragma unroll
  for (int c = 0; c < kC; ++c) {
    const int k = c * kWarp + lane;
    dst[c] = k < width ? to_f32(row[k]) : 0.f;
  }
}

template <int kC, typename T>
__device__ __forceinline__ void store_row(T* row, const float (&src)[kC],
                                          int width, int lane) {
#pragma unroll
  for (int c = 0; c < kC; ++c) {
    const int k = c * kWarp + lane;
    if (k < width) row[k] = from_f32<T>(src[c]);
  }
}

// One CSR direction: segment offsets, gathered endpoint per sorted edge,
// and where each sorted edge's weight lives in the weight vector (null:
// the weight vector is already in this plan's order).
struct Side {
  const int32_t* seg_ptr;  // [V + 1]
  const int32_t* oth;      // [E]
  const int32_t* w_idx;    // [E] or null
};

inline unsigned blocks_for_warps(long warps) {
  return static_cast<unsigned>((warps + kWarpsPerBlock - 1) / kWarpsPerBlock);
}

// Host side: pick T from the dtype code and the register chunks per lane
// kC = ceil(width / 32) in {1, 2, 3, 4, 8} from the widest row.
template <typename T, int kC>
struct Variant {
  using type = T;
  static constexpr int chunks = kC;
};

// Calls launch(Variant<T, kC>{}) for dtype (0 = float32, 1 = bfloat16) and
// rows of up to `width` columns (at most 256).
template <typename Launch>
int dispatch(int dtype, int width, Launch launch) {
  if (width < 0 || width > 8 * kWarp || (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const int c = (width + kWarp - 1) / kWarp;
  if (dtype == 0) {
    if (c <= 1) return launch(Variant<float, 1>{});
    if (c == 2) return launch(Variant<float, 2>{});
    if (c == 3) return launch(Variant<float, 3>{});
    if (c == 4) return launch(Variant<float, 4>{});
    return launch(Variant<float, 8>{});
  }
  if (c <= 1) return launch(Variant<__nv_bfloat16, 1>{});
  if (c == 2) return launch(Variant<__nv_bfloat16, 2>{});
  if (c == 3) return launch(Variant<__nv_bfloat16, 3>{});
  if (c == 4) return launch(Variant<__nv_bfloat16, 4>{});
  return launch(Variant<__nv_bfloat16, 8>{});
}

// One direction of the weighted aggregation of spmm.cu (its pair kernel
// with a single side): out[n] = sum_{j in side's segment n} w[w_idx[j]] *
// h[oth[j]], in T, zero rows for nodes without edges.  Defined in spmm.cu.
int aggregate_one_side(int dtype, int n_node, int d, const void* h,
                       const float* w, Side side, void* out, void* stream);

}  // namespace gnn
