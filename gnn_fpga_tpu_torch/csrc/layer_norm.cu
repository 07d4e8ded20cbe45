// Hand-written Hopper kernels for ops/cuda/layer_norm.py::layer_norm_relu,
// one hidden layer of the Interaction Network's MLPs after its bias-free
// Linear (y = x W^T):
//
//     out = relu(round(xhat * g + beta)),  xhat = (y + b - mean) * rstd
//
// mean and rstd = 1 / sqrt(var + eps) over each row of y + b, and its
// backward, which also sums the bias's, the scale's and the shift's
// gradients over the rows.
//
// Replaces no TPU kernel: the JAX package has no Interaction Network.  On
// the card the unfused layer was PyTorch's LayerNorm forward, its input
// gradient, two passes for the scale's and the shift's gradients, a ReLU
// forward and backward and a column sum for the Linear's bias: seven
// passes over [N, H] tensors whose rows are only H = 128 values long.
//
// What bounds it on this card: bytes.  A row takes a few f32 operations a
// value, far below the card's ridge point.  The forward reads y once and
// writes out once (and 8 bytes of statistics a row); the backward reads dz
// and y once and writes dy once, and keeps the three column sums in
// registers.  At N = 180,736, H = 128 in bf16 that is 94 MB forward and
// 140 MB backward.
//
// Numbers.  The bias add, the statistics, the normalisation and every sum
// are f32; the output is rounded to T once, from xhat * g + beta, and ReLU
// applied to the rounded value.  The mean and the variance are two passes
// over the row as the lanes hold it in registers (no Welford), each lane's
// values summed in order and the 16 lanes of a row by xor shuffles.  The
// backward recomputes the ReLU mask from y, b and the saved mean and rstd
// with the forward's own device functions, each operation an explicitly
// rounded intrinsic that the compiler never contracts, so the mask is the
// forward's !(out <= 0) bit for bit (PyTorch's threshold_backward: a NaN
// output passes its gradient).  Per row, with gz = dz * mask and
// gx = gz * g:
//
//     dy = rstd * (gx - mean(gx) - xhat * mean(gx * xhat))
//     dg += gz * xhat,  dbeta += gz,  db += round(dy)     (column sums)
//
// db sums dy as rounded to T: the gradient the Linear's weight takes too.
//
// Design.  A row is H * sizeof(T) / 16 items of 16 bytes (H = 128: 16 in
// bf16, 32 in f32).  A group of 16 lanes takes a row, lane c its items c,
// c + 16, ...; a warp's two groups take neighbouring rows, so a warp reads
// 512 contiguous bytes of bf16 rows.  A group holds a few rows in flight
// (kFwdRows, kBwdRows): it loads all of them before it computes any.  The
// bias, scale and shift of a lane's columns are read once a thread.
//
// The backward's column sums: each lane keeps f32 partial sums of its
// columns over the rows its group takes; a block adds its groups in a
// fixed order (the warp's two groups by one xor shuffle, then the 8 warps
// in order through shared memory) and writes one row of partials;
// layer_norm_relu_sums_kernel adds the blocks' rows, each column by 64
// threads in fixed slices and a fixed tree.  No atomics, and the grid
// depends on the row count and the row's items alone, so a call repeats
// bit for bit.
//
// Interface: plain C functions, loaded with ctypes.  They launch on the
// given stream, allocate nothing, and return cudaGetLastError().

#include <initializer_list>

#include "common.cuh"

namespace {

using gnn::from_f32;
using gnn::kFull;
using gnn::kThreads;
using gnn::kWarp;
using gnn::kWarpsPerBlock;
using gnn::to_f32;

template <typename T>
using Pack = gnn::Vec<T, 16 / sizeof(T)>;

constexpr int kLanes = 16;                   // lanes of a row
constexpr int kGroups = kThreads / kLanes;   // rows a block takes at once
constexpr int kMaxWidth = 256;
// the backward's blocks at most, each a row of 3 * H f32 partial sums
// (ops/cuda/layer_norm.py::BWD_MAX_BLOCKS allocates them)
constexpr int kMaxBlocks = 1024;
// layer_norm_relu_sums_kernel: columns a block, threads a column
constexpr int kSumCols = 16, kSumSlices = 64;

// items a lane holds of a row of T
template <typename T>
constexpr int kMaxItems = (kMaxWidth * sizeof(T) / 16 + kLanes - 1) / kLanes;

// rows a group holds in flight with kI items a lane: the forward 64 bytes
// a lane of y; the backward 32 bytes of dz and of y, which with its column
// sums fits 128 registers unspilled (bf16, H = 128: 63.8 us against 76.3
// with 4 rows, 85.5 with 4 rows and one block an SM; f32 105.5 against
// 110.8; 8 rows in the forward 44.3 against 37.1, on an H100)
template <int kI>
constexpr int kFwdRows = kI >= 3 ? 1 : 4 / kI;
template <int kI>
constexpr int kBwdRows = kI >= 2 ? 1 : 2;

// The layer's value before ReLU, rounded to T, from the row's f32 value v
// (y + b) and its statistics; the forward and the backward both call it.
__device__ __forceinline__ float xhat_of(float v, float mean, float rstd) {
  return __fmul_rn(__fsub_rn(v, mean), rstd);
}

template <typename T>
__device__ __forceinline__ T pre_relu(float xhat, float g, float beta) {
  return from_f32<T>(__fmaf_rn(xhat, g, beta));
}

// ReLU passes a value that is not <= 0 (NaN too), as PyTorch's relu and
// threshold_backward do.
template <typename T>
__device__ __forceinline__ bool live(T o) {
  return !(to_f32(o) <= 0.f);
}

// A lane's columns of a [H] parameter, in f32 (`fill` without one).
template <typename T, int kI>
__device__ __forceinline__ void load_cols(float (&dst)[kI][Pack<T>::n],
                                          const Pack<T>* __restrict__ p,
                                          int c0, int items, float fill) {
#pragma unroll
  for (int i = 0; i < kI; ++i) {
    const int it = c0 + i * kLanes;
    Pack<T> v;
    const bool ok = p != nullptr && it < items;
    if (ok) v = p[it];
#pragma unroll
    for (int q = 0; q < Pack<T>::n; ++q)
      dst[i][q] = ok ? to_f32(v.v[q]) : fill;
  }
}

// Loads the kR rows from row0 + group (a stride of kGroups rows) that lie
// below `end`: their items of `src` (zeros elsewhere).
template <typename T, int kI, int kR>
__device__ __forceinline__ void load_rows(Pack<T> (&dst)[kR][kI],
                                          const Pack<T>* __restrict__ src,
                                          long row0, long end, int group,
                                          int c0, int items) {
#pragma unroll
  for (int u = 0; u < kR; ++u) {
    const long r = row0 + u * kGroups + group;
#pragma unroll
    for (int i = 0; i < kI; ++i) {
      const int it = c0 + i * kLanes;
      if (r < end && it < items) {
        dst[u][i] = src[r * items + it];
      } else {
#pragma unroll
        for (int q = 0; q < Pack<T>::n; ++q) dst[u][i].v[q] = from_f32<T>(0.f);
      }
    }
  }
}

// y + b of a lane's share of a row, in f32 (zero past the row).
template <typename T, int kI>
__device__ __forceinline__ void biased(float (&v)[kI][Pack<T>::n],
                                       const Pack<T> (&y)[kI],
                                       const float (&bv)[kI][Pack<T>::n],
                                       int c0, int items) {
#pragma unroll
  for (int i = 0; i < kI; ++i)
#pragma unroll
    for (int q = 0; q < Pack<T>::n; ++q)
      v[i][q] = c0 + i * kLanes < items ? __fadd_rn(to_f32(y[i].v[q]),
                                                    bv[i][q])
                                        : 0.f;
}

template <typename T, int kI>
__global__ void __launch_bounds__(kThreads)
layer_norm_relu_fwd_kernel(long n_row, int hdim, float eps,
                           const Pack<T>* __restrict__ y,
                           const Pack<T>* __restrict__ b,
                           const Pack<T>* __restrict__ g,
                           const Pack<T>* __restrict__ beta,
                           Pack<T>* __restrict__ out,
                           float* __restrict__ mean_out,
                           float* __restrict__ rstd_out) {
  constexpr int kN = Pack<T>::n, kR = kFwdRows<kI>;
  const int items = hdim / kN;
  const int c0 = threadIdx.x % kLanes, group = threadIdx.x / kLanes;
  const float h = static_cast<float>(hdim);
  float bv[kI][kN], gv[kI][kN], sv[kI][kN];
  load_cols<T, kI>(bv, b, c0, items, 0.f);
  load_cols<T, kI>(gv, g, c0, items, 0.f);
  load_cols<T, kI>(sv, beta, c0, items, 0.f);
  const long row0 = static_cast<long>(blockIdx.x) * (kGroups * kR);
  Pack<T> raw[kR][kI];
  load_rows<T, kI, kR>(raw, y, row0, n_row, group, c0, items);
#pragma unroll
  for (int u = 0; u < kR; ++u) {
    const long r = row0 + u * kGroups + group;
    float v[kI][kN];
    biased<T, kI>(v, raw[u], bv, c0, items);
    float s = 0.f;
#pragma unroll
    for (int i = 0; i < kI; ++i)
#pragma unroll
      for (int q = 0; q < kN; ++q) s = __fadd_rn(s, v[i][q]);
    const float mean = __fdiv_rn(gnn::group_sum(s, kLanes), h);
    float ss = 0.f;
#pragma unroll
    for (int i = 0; i < kI; ++i)
#pragma unroll
      for (int q = 0; q < kN; ++q) {
        const float d = c0 + i * kLanes < items ? __fsub_rn(v[i][q], mean)
                                                : 0.f;
        ss = __fmaf_rn(d, d, ss);
      }
    const float var = __fdiv_rn(gnn::group_sum(ss, kLanes), h);
    const float rstd = __frsqrt_rn(__fadd_rn(var, eps));
    if (r >= n_row) continue;
#pragma unroll
    for (int i = 0; i < kI; ++i) {
      const int it = c0 + i * kLanes;
      if (it >= items) continue;
      Pack<T> o;
#pragma unroll
      for (int q = 0; q < kN; ++q) {
        const T t = pre_relu<T>(xhat_of(v[i][q], mean, rstd), gv[i][q],
                                sv[i][q]);
        o.v[q] = live(t) ? t : from_f32<T>(0.f);
      }
      out[r * items + it] = o;
    }
    if (c0 == 0) {
      mean_out[r] = mean;
      rstd_out[r] = rstd;
    }
  }
}

// Two blocks an SM at least: 16 warps, 128 registers a thread at most.
template <typename T, int kI>
__global__ void __launch_bounds__(kThreads, 2)
layer_norm_relu_bwd_kernel(long n_row, long rows_per_block, int hdim,
                           const Pack<T>* __restrict__ dz,
                           const Pack<T>* __restrict__ y,
                           const Pack<T>* __restrict__ b,
                           const Pack<T>* __restrict__ g,
                           const Pack<T>* __restrict__ beta,
                           const float* __restrict__ mean_in,
                           const float* __restrict__ rstd_in,
                           Pack<T>* __restrict__ dy,
                           float* __restrict__ part) {
  constexpr int kN = Pack<T>::n, kR = kBwdRows<kI>;
  __shared__ float red[kWarpsPerBlock][3][kMaxWidth];
  const int items = hdim / kN;
  const int c0 = threadIdx.x % kLanes, group = threadIdx.x / kLanes;
  const float h = static_cast<float>(hdim);
  float bv[kI][kN], gv[kI][kN], sv[kI][kN];
  load_cols<T, kI>(bv, b, c0, items, 0.f);
  load_cols<T, kI>(gv, g, c0, items, 0.f);
  load_cols<T, kI>(sv, beta, c0, items, 0.f);
  // column sums: the scale's, the shift's and the bias's gradients
  float acc[3][kI][kN];
#pragma unroll
  for (int k = 0; k < 3; ++k)
#pragma unroll
    for (int i = 0; i < kI; ++i)
#pragma unroll
      for (int q = 0; q < kN; ++q) acc[k][i][q] = 0.f;
  const long lo = static_cast<long>(blockIdx.x) * rows_per_block;
  const long hi = min(n_row, lo + rows_per_block);
  for (long row0 = lo; row0 < hi; row0 += kGroups * kR) {
    Pack<T> rz[kR][kI], ry[kR][kI];
    float mu[kR], rs[kR];
    load_rows<T, kI, kR>(rz, dz, row0, hi, group, c0, items);
    load_rows<T, kI, kR>(ry, y, row0, hi, group, c0, items);
#pragma unroll
    for (int u = 0; u < kR; ++u) {
      const long r = row0 + u * kGroups + group;
      mu[u] = r < hi ? mean_in[r] : 0.f;
      rs[u] = r < hi ? rstd_in[r] : 0.f;
    }
#pragma unroll
    for (int u = 0; u < kR; ++u) {
      const long r = row0 + u * kGroups + group;
      float v[kI][kN], gz[kI][kN];
      biased<T, kI>(v, ry[u], bv, c0, items);
      float s1 = 0.f, s2 = 0.f;
#pragma unroll
      for (int i = 0; i < kI; ++i)
#pragma unroll
        for (int q = 0; q < kN; ++q) {
          v[i][q] = xhat_of(v[i][q], mu[u], rs[u]);   // now xhat
          const bool on = live(pre_relu<T>(v[i][q], gv[i][q], sv[i][q]));
          // dz is zero past the row and on rows past the block
          gz[i][q] = on ? to_f32(rz[u][i].v[q]) : 0.f;
          const float gx = __fmul_rn(gz[i][q], gv[i][q]);
          s1 = __fadd_rn(s1, gx);
          s2 = __fmaf_rn(gx, v[i][q], s2);
        }
      const float a = __fdiv_rn(gnn::group_sum(s1, kLanes), h);
      const float c = __fdiv_rn(gnn::group_sum(s2, kLanes), h);
#pragma unroll
      for (int i = 0; i < kI; ++i) {
        const int it = c0 + i * kLanes;
        Pack<T> o;
#pragma unroll
        for (int q = 0; q < kN; ++q) {
          const float gx = __fmul_rn(gz[i][q], gv[i][q]);
          o.v[q] = from_f32<T>(__fmul_rn(
              rs[u], __fsub_rn(gx, __fmaf_rn(v[i][q], c, a))));
          acc[0][i][q] = __fmaf_rn(gz[i][q], v[i][q], acc[0][i][q]);
          acc[1][i][q] = __fadd_rn(acc[1][i][q], gz[i][q]);
          acc[2][i][q] = __fadd_rn(acc[2][i][q], to_f32(o.v[q]));
        }
        if (r < hi && it < items) dy[r * items + it] = o;
      }
    }
  }
  // the warp's two groups, then the block's warps in order
  const int warp = threadIdx.x / kWarp;
#pragma unroll
  for (int k = 0; k < 3; ++k)
#pragma unroll
    for (int i = 0; i < kI; ++i)
#pragma unroll
      for (int q = 0; q < kN; ++q)
        acc[k][i][q] = __fadd_rn(acc[k][i][q],
                                 __shfl_xor_sync(kFull, acc[k][i][q], kLanes));
  if (group % 2 == 0) {
#pragma unroll
    for (int i = 0; i < kI; ++i) {
      const int it = c0 + i * kLanes;
      if (it >= items) continue;
#pragma unroll
      for (int k = 0; k < 3; ++k)
#pragma unroll
        for (int q = 0; q < kN; ++q) red[warp][k][it * kN + q] = acc[k][i][q];
    }
  }
  __syncthreads();
  for (int t = threadIdx.x; t < 3 * hdim; t += kThreads) {
    const int k = t / hdim, col = t - k * hdim;
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < kWarpsPerBlock; ++w) s = __fadd_rn(s, red[w][k][col]);
    part[static_cast<long>(blockIdx.x) * 3 * hdim + t] = s;
  }
}

// The blocks' partial sums [blocks][3][H] added a column at a time, in a
// fixed order: thread slice j adds rows j, j + 64, ... in order, then the
// 64 slices by a fixed tree.  Writes dg, dbeta and (when given) db in T.
template <typename T>
__global__ void __launch_bounds__(kSumCols * kSumSlices)
layer_norm_relu_sums_kernel(int blocks, int hdim,
                            const float* __restrict__ part,
                            T* __restrict__ dg, T* __restrict__ dbeta,
                            T* __restrict__ db) {
  __shared__ float red[kSumSlices][kSumCols];
  const int tx = threadIdx.x % kSumCols, ty = threadIdx.x / kSumCols;
  const int cols = 3 * hdim;
  const int t = blockIdx.x * kSumCols + tx;
  float s = 0.f;
  if (t < cols) {
#pragma unroll 4
    for (int k = ty; k < blocks; k += kSumSlices)
      s = __fadd_rn(s, part[static_cast<long>(k) * cols + t]);
  }
  red[ty][tx] = s;
  __syncthreads();
#pragma unroll
  for (int half = kSumSlices / 2; half > 0; half >>= 1) {
    if (ty < half) red[ty][tx] = __fadd_rn(red[ty][tx], red[ty + half][tx]);
    __syncthreads();
  }
  if (ty == 0 && t < cols) {
    const int k = t / hdim;
    T* dst = k == 0 ? dg : k == 1 ? dbeta : db;
    if (dst != nullptr) dst[t - k * hdim] = from_f32<T>(red[0][tx]);
  }
}

template <typename T, int kI>
int fwd_launch(long n_row, int hdim, float eps, const void* y, const void* b,
               const void* g, const void* beta, void* out, float* mean,
               float* rstd, cudaStream_t stream) {
  constexpr int rows = kGroups * kFwdRows<kI>;
  const long blocks = (n_row + rows - 1) / rows;
  if (blocks > 0)
    layer_norm_relu_fwd_kernel<T, kI>
        <<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
            n_row, hdim, eps, static_cast<const Pack<T>*>(y),
            static_cast<const Pack<T>*>(b), static_cast<const Pack<T>*>(g),
            static_cast<const Pack<T>*>(beta), static_cast<Pack<T>*>(out),
            mean, rstd);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int kI>
int bwd_launch(long n_row, int hdim, const void* dz, const void* y,
               const void* b, const void* g, const void* beta,
               const float* mean, const float* rstd, void* dy, float* part,
               void* dg, void* dbeta, void* db, cudaStream_t stream) {
  constexpr int rows = kGroups * kBwdRows<kI>;
  const long chunks = (n_row + rows - 1) / rows;
  const long per = (chunks + kMaxBlocks - 1) / kMaxBlocks;  // chunks a block
  const int blocks = per > 0 ? static_cast<int>((chunks + per - 1) / per) : 0;
  if (blocks > 0)
    layer_norm_relu_bwd_kernel<T, kI><<<blocks, kThreads, 0, stream>>>(
        n_row, per * rows, hdim, static_cast<const Pack<T>*>(dz),
        static_cast<const Pack<T>*>(y), static_cast<const Pack<T>*>(b),
        static_cast<const Pack<T>*>(g), static_cast<const Pack<T>*>(beta),
        mean, rstd, static_cast<Pack<T>*>(dy), part);
  const int err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  layer_norm_relu_sums_kernel<T>
      <<<(3 * hdim + kSumCols - 1) / kSumCols, kSumCols * kSumSlices, 0,
         stream>>>(blocks, hdim, part, static_cast<T*>(dg),
                   static_cast<T*>(dbeta), static_cast<T*>(db));
  return static_cast<int>(cudaGetLastError());
}

// The instantiation for kI items a lane: kI = 1 .. kMaxItems<T>.
template <typename T, int kI = 1>
int fwd_items(int want, long n_row, int hdim, float eps, const void* y,
              const void* b, const void* g, const void* beta, void* out,
              float* mean, float* rstd, cudaStream_t stream) {
  if (want == kI)
    return fwd_launch<T, kI>(n_row, hdim, eps, y, b, g, beta, out, mean,
                             rstd, stream);
  if constexpr (kI < kMaxItems<T>)
    return fwd_items<T, kI + 1>(want, n_row, hdim, eps, y, b, g, beta, out,
                                mean, rstd, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename T, int kI = 1>
int bwd_items(int want, long n_row, int hdim, const void* dz, const void* y,
              const void* b, const void* g, const void* beta,
              const float* mean, const float* rstd, void* dy, float* part,
              void* dg, void* dbeta, void* db, cudaStream_t stream) {
  if (want == kI)
    return bwd_launch<T, kI>(n_row, hdim, dz, y, b, g, beta, mean, rstd, dy,
                             part, dg, dbeta, db, stream);
  if constexpr (kI < kMaxItems<T>)
    return bwd_items<T, kI + 1>(want, n_row, hdim, dz, y, b, g, beta, mean,
                                rstd, dy, part, dg, dbeta, db, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

// items a lane holds for rows of `hdim` values of `bytes` bytes
int items_a_lane(int hdim, int bytes) {
  return (hdim * bytes / 16 + kLanes - 1) / kLanes;
}

bool valid(int dtype, long n_row, int hdim) {
  return (dtype == 0 || dtype == 1) && n_row >= 0 && hdim > 0 &&
         hdim % 8 == 0 && hdim <= kMaxWidth;
}

bool aligned(std::initializer_list<const void*> ptrs) {
  for (const void* p : ptrs)
    if (p != nullptr && !gnn::aligned_to(p, 16)) return false;
  return true;
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (y, b, g, beta, out).  y, out:
// [n_row, hdim]; b (or null), g, beta: [hdim]; mean, rstd: [n_row] f32.
// hdim a multiple of 8 up to 256; y, b, g, beta and out 16-byte aligned.
int gnn_layer_norm_relu_fwd(int dtype, long n_row, int hdim, double eps,
                            const void* y, const void* b, const void* g,
                            const void* beta, void* out, float* mean,
                            float* rstd, void* stream) {
  if (!valid(dtype, n_row, hdim) || g == nullptr || beta == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  if (!aligned({y, b, g, beta, out}))
    return static_cast<int>(cudaErrorMisalignedAddress);
  const auto st = static_cast<cudaStream_t>(stream);
  const float e = static_cast<float>(eps);
  if (dtype == 0)
    return fwd_items<float>(items_a_lane(hdim, 4), n_row, hdim, e, y, b, g,
                            beta, out, mean, rstd, st);
  return fwd_items<__nv_bfloat16>(items_a_lane(hdim, 2), n_row, hdim, e, y,
                                  b, g, beta, out, mean, rstd, st);
}

// The backward: dz, y, dy: [n_row, hdim]; mean, rstd from the forward;
// part: [1024, 3, hdim] f32 scratch; dg, dbeta and (with b) db: [hdim], in
// the dtype.  Two launches: the rows, then the column sums.
int gnn_layer_norm_relu_bwd(int dtype, long n_row, int hdim, const void* dz,
                            const void* y, const void* b, const void* g,
                            const void* beta, const float* mean,
                            const float* rstd, void* dy, float* part,
                            void* dg, void* dbeta, void* db, void* stream) {
  if (!valid(dtype, n_row, hdim) || g == nullptr || beta == nullptr ||
      dg == nullptr || dbeta == nullptr || (b == nullptr) != (db == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if (!aligned({dz, y, b, g, beta, dy}))
    return static_cast<int>(cudaErrorMisalignedAddress);
  const auto st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return bwd_items<float>(items_a_lane(hdim, 4), n_row, hdim, dz, y, b, g,
                            beta, mean, rstd, dy, part, dg, dbeta, db, st);
  return bwd_items<__nv_bfloat16>(items_a_lane(hdim, 2), n_row, hdim, dz, y,
                                  b, g, beta, mean, rstd, dy, part, dg, dbeta,
                                  db, st);
}

}  // extern "C"
