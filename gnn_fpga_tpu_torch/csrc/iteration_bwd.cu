// Hand-written Hopper kernels for the backward of the fused message-passing
// iteration, ops/cuda/spmm.py::iteration_pair_bwd, the vector-Jacobian
// product of iteration_fwd.cu's function:
//
//     z = tanh((pa[s] + pb[r]) * em + b1),  sig = sigmoid(z . w2 + b2)
//     e = sig * em,  de = <g_mi[r], h[s]> + <g_mo[s], h[r]>
//     dlogit = de * em * sig * (1 - sig),   t = dlogit * w2 * (1 - z^2)
//     dh[s] += e g_mi[r],  dh[r] += e g_mo[s]
//     dpa[s] += t em,  dpb[r] += t em
//     dw2 = sum z dlogit,  db1 = sum t,  db2 = sum dlogit
//
// Replaces: gnn_fpga_tpu/ops/pallas/spmm.py::_iter_pair_bwd_kernel (reached
// from _iteration_pair_bwd).
//
// What bounds it on this card: bytes, at the fullevent shapes (bf16): the
// node tables pa, pb, h, g_mi, g_mo (10.4 MB) read once, the edge ids and
// mask (2.2 MB) and dh, dpa, dpb (6.2 MB) written once, 18.7 MB, ~5.6 us
// at 3.35 TB/s; the gathers come from L2, where the tables stay.  The
// first design (one warp per node walking both of its segments,
// recomputing each edge's score on both sides with three warp reductions
// an edge and side) took 0.234 ms, set by the pad node's 320-edge walk.
//
// Design, three passes (PERF.md, PR 5).  The recv and send passes walk
// the work items of IterItems (at most ITEM_EDGES sorted edges of one node
// and direction), one warp an item; the warp's lanes split into groups of
// 2^log_lanes, one edge a group, each group holding the edge's H rows (one
// 16- or 8-byte item a lane) and D rows (at most 8 items a lane).  A warp
// takes its item's edges in chunks: lane l loads chunk edge l's ids and
// per-edge values in one coalesced load, each group stages the gathered
// rows of its edges into its warp's shared-memory slots with cp.async (so
// the whole chunk is in flight at once and the copies hold no registers),
// then computes them from shared memory.  Each group sums its edges in
// edge order; the groups' rows are added once at the end of the item, in
// a fixed order, and an item of a split node writes its rows to its slot
// of f32 partial rows instead.
//
// 1. recv pass (node n = r): it holds pb[n], g_mi[n] and h[n] and stages
//    pa[s], h[s] and g_mo[s] an edge.  Each edge's values are computed
//    once, here: de = <g_mi[n], h[s]> + <g_mo[s], h[n]> with one group
//    reduction, dlogit and e from the forward's sig; it writes e_sorted[j]
//    and dl[j] = (dlogit, em), and sums dpb[n] (t em, from the z it
//    computes) and n's recv part of dh (e g_mo[s], into an f32 row).
// 2. send pass (node n = s; its warps stride over the send items): it
//    stages pb[r] and g_mi[r] an edge and reads e, dlogit and em through
//    send_in_recv; z is recomputed (a second tanh an element: 2 E H tanhf
//    in all) for dpa[n] += t em and the parameter sums (dw2, db1, db2),
//    and dh[n] = (its recv part) + sum e g_mi[r] is written once, with no
//    reduction inside the walk.  Each warp writes one row of parameter
//    partials.  Recomputing z was measured against z written by the recv
//    pass ([E, H] f32) and staged here in place of pb[r], which gives the
//    same bits: the send pass took as long without its tanh, and writing
//    z made the recv pass slower, so the stash lost at 3 of the 4 main-path
//    shapes (fullevent and hit, bf16 and f32; PERF.md, PR 5).
// 3. finish: the column sums of the parameter partials, each column in a
//    fixed order, and, one block per split node, dpb, dpa and dh from the
//    partial rows in slot order (dh: the recv items', then the send
//    items').
//
// Neither more warps an SM, nor more edges in flight a warp, nor the send
// pass's tanh taken out shortened the walks (PERF.md, PR 5): what bounds
// them is still open.
//
// Pad items and splits (node -1) of plans padded to static capacities
// (ops/cuda/spmm.py::pad_plans) come after the real ones and do nothing:
// a send-pass warp skips them, so with the same send_blocks every warp
// sums the same items as on the unpadded plans, and the outputs agree bit
// for bit.
//
// No atomics: results are identical from run to run.  Types as the
// forward: T tables and outputs, f32 em, e, dl and every sum; tanhf and
// expf are the accurate versions.
//
// Interface: a plain C function, loaded with ctypes.  It launches on the
// given stream, allocates nothing, and returns cudaGetLastError().

#include "iteration.cuh"

namespace {

using gnn::from_f32;
using gnn::group_sum;
using gnn::IterShape;
using gnn::Lanes;
using gnn::load_row_items;
using gnn::kFull;
using gnn::kThreads;
using gnn::kWarp;
using gnn::kWarpsPerBlock;
using gnn::pack;
using gnn::store_items;
using gnn::sum_groups;
using gnn::to_f32;
using gnn::Vec;
using gnn::warp_sum;

// Staging of gathered rows in shared memory with cp.async, whose copies
// hold no registers while they are in flight.  A row of 4-, 8- or 16-byte
// items is copied item by item; a row of 2-byte items (bf16, odd width or
// unaligned) as the 4-byte words that hold its bytes, from the word its
// first byte lies in, so a slot takes the row's bytes + 4.
__device__ __forceinline__ void cp_async4(char* dst, const char* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(src));
}

__device__ __forceinline__ void cp_async16(char* dst, const char* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src));
}

__device__ __forceinline__ void cp_async8(char* dst, const char* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(d),
               "l"(src));
}

__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Row `r` (of `row` items V) into `slot`, by the lanes of one group.
// Items of 4, 8 or 16 bytes are aligned to their size (the host checks
// it).
template <typename V>
__device__ __forceinline__ void stage_row(char* slot,
                                          const V* __restrict__ tab, long r,
                                          int row, const Lanes& ln) {
  const char* p = reinterpret_cast<const char*>(tab + r * row);
  if (sizeof(V) == 16) {
    for (int c = ln.c0; c < row; c += ln.lanes)
      cp_async16(slot + 16 * c, p + 16 * c);
    return;
  }
  if (sizeof(V) == 8) {
    for (int c = ln.c0; c < row; c += ln.lanes)
      cp_async8(slot + 8 * c, p + 8 * c);
    return;
  }
  if (sizeof(V) == 4) {
    for (int c = ln.c0; c < row; c += ln.lanes)
      cp_async4(slot + 4 * c, p + 4 * c);
    return;
  }
  const uintptr_t a = reinterpret_cast<uintptr_t>(p);
  const char* first = p - (a & 3);
  const int words = static_cast<int>((a + row * sizeof(V) + 3) / 4 - a / 4);
  for (int w = ln.c0; w < words; w += ln.lanes)
    cp_async4(slot + 4 * w, first + 4 * w);
}

// The staged row `r` of `tab` in `slot`, as items V.
template <typename V>
__device__ __forceinline__ const V* staged(const char* slot,
                                           const V* __restrict__ tab,
                                           long r, int row) {
  if (sizeof(V) >= 4) return reinterpret_cast<const V*>(slot);
  const uintptr_t a = reinterpret_cast<uintptr_t>(tab + r * row);
  return reinterpret_cast<const V*>(slot + (a & 3));
}

template <int kI, int N>
__device__ __forceinline__ void zero(float (&acc)[kI][N]) {
#pragma unroll
  for (int c = 0; c < kI; ++c)
#pragma unroll
    for (int q = 0; q < N; ++q) acc[c][q] = 0.f;
}

// Pass 1.  One warp per recv item (node n = r), the item's edges taken in
// chunks of `chunk` (at most 32): lane l loads chunk edge l's sender, mask
// and score; group g stages the rows pa[s], h[s] and g_mo[s] of the
// chunk's edges g, g + groups, ... into its warp's slots of `slot` bytes
// (an H row in slot_h, then two D rows in slot_d each), all in flight at
// once, then computes them.
template <typename T, int NH, int kI, int ND, int kC>
__global__ void __launch_bounds__(kThreads, 2)
recv_kernel(int n_recv, int row_h, int row_d, int log_lanes, int chunk,
            int slot_h, int slot_d, const Vec<T, NH>* __restrict__ pa,
            const Vec<T, NH>* __restrict__ pb,
            const Vec<T, NH>* __restrict__ w2,
            const Vec<T, NH>* __restrict__ b1,
            const float* __restrict__ sig_sorted,
            const Vec<T, ND>* __restrict__ h,
            const Vec<T, ND>* __restrict__ g_mi,
            const Vec<T, ND>* __restrict__ g_mo,
            const float* __restrict__ em, const int4* __restrict__ items,
            const int32_t* __restrict__ recv_oth,
            float* __restrict__ e_sorted, float2* __restrict__ dl,
            Vec<T, NH>* __restrict__ dpb, Vec<float, NH>* __restrict__ hpart,
            Vec<float, ND>* __restrict__ dh_recv,
            Vec<float, ND>* __restrict__ dpart) {
  extern __shared__ __align__(16) char smem[];
  const Lanes ln(log_lanes);
  const int wib = threadIdx.x / kWarp;
  const int i = blockIdx.x * kWarpsPerBlock + wib;
  if (i >= n_recv) return;
  const int slot = slot_h + 2 * slot_d;
  char* buf = smem + static_cast<long>(wib) * chunk * slot;
  const int4 it = items[i];            // beg, end, node, slot
  if (it.z < 0) return;                // a pad item of padded plans
  const long n = it.z;
  // the rows every edge of the item uses, kept as stored (bf16 pairs
  // take half the registers of f32 ones) and widened where used
  Vec<T, NH> w2r[kI], b1r[kI], own[kI];
  Vec<T, ND> gin[kC], hn[kC];
  load_row_items(w2r, w2, 0, row_h, ln);
  load_row_items(b1r, b1, 0, row_h, ln);
  load_row_items(own, pb, n, row_h, ln);
  load_row_items(gin, g_mi, n, row_d, ln);
  load_row_items(hn, h, n, row_d, ln);
  float hacc[kI][NH], dacc[kC][ND];
  zero(hacc);
  zero(dacc);
  for (int base = it.x; base < it.y; base += chunk) {
    const int cnt = min(chunk, it.y - base);
    const bool mine = ln.lane < cnt;
    const int s_l = mine ? recv_oth[base + ln.lane] : 0;
    const float em_l = mine ? em[base + ln.lane] : 0.f;
    const float sig_l = mine ? sig_sorted[base + ln.lane] : 0.f;
    for (int k0 = 0; k0 < cnt; k0 += ln.groups) {
      const int k = k0 + ln.group;
      const long s = __shfl_sync(kFull, s_l, k & (kWarp - 1));
      if (k >= cnt) continue;
      char* sl = buf + k * slot;
      stage_row(sl, pa, s, row_h, ln);
      stage_row(sl + slot_h, h, s, row_d, ln);
      stage_row(sl + slot_h + slot_d, g_mo, s, row_d, ln);
    }
    cp_async_wait();
    __syncwarp();
    for (int k0 = 0; k0 < cnt; k0 += ln.groups) {
      const int k = k0 + ln.group;
      const bool ok = k < cnt;
      const int src = k & (kWarp - 1);
      const long s = __shfl_sync(kFull, s_l, src);
      const float emj = __shfl_sync(kFull, em_l, src);
      const float sig = __shfl_sync(kFull, sig_l, src);
      const char* sl = buf + k * slot;
      const Vec<T, NH>* ra = staged(sl, pa, s, row_h);
      const Vec<T, ND>* rh = staged(sl + slot_h, h, s, row_d);
      const Vec<T, ND>* rg = staged(sl + slot_h + slot_d, g_mo, s, row_d);
      // de = <g_mi[n], h[s]> + <g_mo[s], h[n]>, over the group
      float part = 0.f;
#pragma unroll
      for (int c = 0; c < kC; ++c) {
        const int cc = ln.c0 + c * ln.lanes;
        if (!ok || cc >= row_d) continue;
        const Vec<T, ND> hs = rh[cc], gs = rg[cc];
#pragma unroll
        for (int q = 0; q < ND; ++q)
          part += to_f32(gin[c].v[q]) * to_f32(hs.v[q]) +
                  to_f32(gs.v[q]) * to_f32(hn[c].v[q]);
      }
      const float de = group_sum(part, ln.lanes);
      if (!ok) continue;
      const float dlogit = de * emj * sig * (1.f - sig);
      const float e = sig * emj;
      if (ln.c0 == 0) {
        e_sorted[base + k] = e;
        dl[base + k] = make_float2(dlogit, emj);
      }
#pragma unroll
      for (int c = 0; c < kI; ++c) {
        const int cc = ln.c0 + c * ln.lanes;
        if (cc >= row_h) continue;
        const Vec<T, NH> a = ra[cc];
#pragma unroll
        for (int q = 0; q < NH; ++q) {
          // (pa[send] + pb[recv]) * em, in the plain version's order
          const float zz =
              tanhf((to_f32(a.v[q]) + to_f32(own[c].v[q])) * emj +
                    to_f32(b1r[c].v[q]));
          hacc[c][q] += dlogit * to_f32(w2r[c].v[q]) * (1.f - zz * zz) * emj;
        }
      }
      // n's recv part of dh: e * g_mo[s]
#pragma unroll
      for (int c = 0; c < kC; ++c) {
        const int cc = ln.c0 + c * ln.lanes;
        if (cc >= row_d) continue;
        const Vec<T, ND> gs = rg[cc];
#pragma unroll
        for (int q = 0; q < ND; ++q) dacc[c][q] += e * to_f32(gs.v[q]);
      }
    }
    __syncwarp();     // the slots are read before the next chunk fills them
  }
  sum_groups(hacc, ln.lanes);
  sum_groups(dacc, ln.lanes);
  if (ln.group != 0) return;
  store_items(hacc, dpb + n * row_h, it.w, hpart, row_h, ln.c0, ln.lanes);
  // in f32 either way: the send pass adds its part to dh_recv[n]
  store_items(dacc, dh_recv + n * row_d, it.w, dpart, row_d, ln.c0,
              ln.lanes);
}

// Pass 2.  Warp w of the grid's W takes the send items w, w + W, ...
// (items n_recv + i) in turn, each as the recv pass takes its items (node
// n = s; slots of an H row, pb[r], and a D row, g_mi[r]), and writes its
// parameter sums to column partial[col * W + w].
template <typename T, int NH, int kI, int ND, int kC>
__global__ void __launch_bounds__(kThreads, 2)
send_kernel(int n_send, int n_recv, int row_h, int row_d, int log_lanes,
            int chunk, int slot_h, int slot_d,
            const Vec<T, NH>* __restrict__ pa,
            const Vec<T, NH>* __restrict__ pb,
            const Vec<T, NH>* __restrict__ w2,
            const Vec<T, NH>* __restrict__ b1,
            const Vec<T, ND>* __restrict__ g_mi,
            const float* __restrict__ e_sorted,
            const float2* __restrict__ dl,
            const int32_t* __restrict__ send_in_recv,
            const int4* __restrict__ items,
            const int32_t* __restrict__ send_oth,
            const Vec<float, ND>* __restrict__ dh_recv,
            Vec<T, NH>* __restrict__ dpa, Vec<T, ND>* __restrict__ dh,
            Vec<float, NH>* __restrict__ hpart,
            Vec<float, ND>* __restrict__ dpart,
            float* __restrict__ partial) {
  extern __shared__ __align__(16) char smem[];
  const Lanes ln(log_lanes);
  const int hdim = row_h * NH;
  const int wib = threadIdx.x / kWarp;
  const int w = blockIdx.x * kWarpsPerBlock + wib;
  const int n_warps = gridDim.x * kWarpsPerBlock;
  const int slot = slot_h + slot_d;
  char* buf = smem + static_cast<long>(wib) * chunk * slot;
  Vec<T, NH> w2r[kI], b1r[kI];
  load_row_items(w2r, w2, 0, row_h, ln);
  load_row_items(b1r, b1, 0, row_h, ln);
  float dw2[kI][NH], db1[kI][NH], db2 = 0.f;
  zero(dw2);
  zero(db1);
  for (int i = w; i < n_send; i += n_warps) {
    const int4 it = items[n_recv + i];   // beg, end, node, slot
    if (it.z < 0) continue;              // a pad item of padded plans
    const long n = it.z;
    Vec<T, NH> own[kI];
    load_row_items(own, pa, n, row_h, ln);
    float hacc[kI][NH], dacc[kC][ND];
    zero(hacc);
    zero(dacc);
    for (int base = it.x; base < it.y; base += chunk) {
      const int cnt = min(chunk, it.y - base);
      const bool mine = ln.lane < cnt;
      const int r_l = mine ? send_oth[base + ln.lane] : 0;
      const int jr = mine ? send_in_recv[base + ln.lane] : 0;
      const float2 d_l = mine ? dl[jr] : make_float2(0.f, 0.f);
      const float e_l = mine ? e_sorted[jr] : 0.f;
      for (int k0 = 0; k0 < cnt; k0 += ln.groups) {
        const int k = k0 + ln.group;
        const long r = __shfl_sync(kFull, r_l, k & (kWarp - 1));
        if (k >= cnt) continue;
        char* sl = buf + k * slot;
        stage_row(sl, pb, r, row_h, ln);
        stage_row(sl + slot_h, g_mi, r, row_d, ln);
      }
      cp_async_wait();
      __syncwarp();
      for (int k0 = 0; k0 < cnt; k0 += ln.groups) {
        const int k = k0 + ln.group;
        const int src = k & (kWarp - 1);
        const long r = __shfl_sync(kFull, r_l, src);
        const float dlogit = __shfl_sync(kFull, d_l.x, src);
        const float emj = __shfl_sync(kFull, d_l.y, src);
        const float e = __shfl_sync(kFull, e_l, src);
        if (k >= cnt) continue;
        const char* sl = buf + k * slot;
        const Vec<T, NH>* ra = staged(sl, pb, r, row_h);
        const Vec<T, ND>* rg = staged(sl + slot_h, g_mi, r, row_d);
        // dpa[n] and the parameter sums, z recomputed from pb[r]
#pragma unroll
        for (int c = 0; c < kI; ++c) {
          const int cc = ln.c0 + c * ln.lanes;
          if (cc >= row_h) continue;
          const Vec<T, NH> a = ra[cc];
#pragma unroll
          for (int q = 0; q < NH; ++q) {
            // pa[s] + pb[r]: the same float, so the same z, as the recv
            // pass's; the parameter sums take each edge once, here
            const float zz =
                tanhf((to_f32(own[c].v[q]) + to_f32(a.v[q])) * emj +
                      to_f32(b1r[c].v[q]));
            const float t = dlogit * to_f32(w2r[c].v[q]) * (1.f - zz * zz);
            hacc[c][q] += t * emj;
            db1[c][q] += t;
            dw2[c][q] += zz * dlogit;
          }
        }
        if (ln.c0 == 0) db2 += dlogit;
        // dh[n]: e * g_mi[r]
#pragma unroll
        for (int c = 0; c < kC; ++c) {
          const int cc = ln.c0 + c * ln.lanes;
          if (cc >= row_d) continue;
          const Vec<T, ND> g = rg[cc];
#pragma unroll
          for (int q = 0; q < ND; ++q) dacc[c][q] += e * to_f32(g.v[q]);
        }
      }
      __syncwarp();   // the slots are read before the next chunk fills them
    }
    sum_groups(hacc, ln.lanes);
    sum_groups(dacc, ln.lanes);
    if (ln.group == 0) {
      store_items(hacc, dpa + n * row_h, it.w, hpart, row_h, ln.c0,
                  ln.lanes);
      if (it.w >= 0) {
        store_items(dacc, dh + n * row_d, it.w, dpart, row_d, ln.c0,
                    ln.lanes);
      } else {
        // dh[n] = (n's recv part) + (its send part), rounded once
#pragma unroll
        for (int c = 0; c < kC; ++c) {
          const int k = ln.c0 + c * ln.lanes;
          if (k >= row_d) continue;
          const Vec<float, ND> r = dh_recv[n * row_d + k];
          float sum[ND];
#pragma unroll
          for (int q = 0; q < ND; ++q) sum[q] = r.v[q] + dacc[c][q];
          dh[n * row_d + k] = pack<T>(sum);
        }
      }
    }
  }

  // the warp's parameter sums [dw2 | db1 | db2], its groups added in a
  // fixed order
  sum_groups(dw2, ln.lanes);
  sum_groups(db1, ln.lanes);
  db2 = warp_sum(db2);
  if (ln.group != 0) return;
#pragma unroll
  for (int k = 0; k < kI; ++k) {
    const int c = ln.c0 + k * ln.lanes;
    if (c < row_h)
#pragma unroll
      for (int q = 0; q < NH; ++q) {
        partial[static_cast<long>(c * NH + q) * n_warps + w] = dw2[k][q];
        partial[static_cast<long>(hdim + c * NH + q) * n_warps + w] =
            db1[k][q];
      }
  }
  if (ln.c0 == 0) partial[static_cast<long>(2 * hdim) * n_warps + w] = db2;
}

// Pass 3.  Blocks [0, 2 hdim + 1): block b sums column b of partial
// [2 hdim + 1, n_rows] with a fixed-order tree into dw2[b] (b < hdim),
// db1[b - hdim] (b < 2 hdim) or db2[0].  The blocks after them: one per
// split node (node, slot_beg, slot_mid, slot_end), a thread a column of
// dpb (from the slots [beg, mid)), dpa ([mid, end)) and dh ([beg, end)),
// each summed in slot order.
template <typename T>
__global__ void __launch_bounds__(kThreads)
finish_kernel(int n_rows, int hdim, int d, const float* __restrict__ partial,
              T* __restrict__ dw2, T* __restrict__ db1, T* __restrict__ db2,
              int n_split, const int4* __restrict__ splits,
              const float* __restrict__ hpart,
              const float* __restrict__ dpart, T* __restrict__ dh,
              T* __restrict__ dpa, T* __restrict__ dpb) {
  __shared__ float buf[kThreads];
  const int n_cols = 2 * hdim + 1;
  if (static_cast<int>(blockIdx.x) < n_cols) {
    const int col = blockIdx.x;
    float s = 0.f;
    for (int i = threadIdx.x; i < n_rows; i += kThreads)
      s += partial[static_cast<long>(col) * n_rows + i];
    buf[threadIdx.x] = s;
    __syncthreads();
    for (int stride = kThreads / 2; stride > 0; stride >>= 1) {
      if (threadIdx.x < stride) buf[threadIdx.x] += buf[threadIdx.x + stride];
      __syncthreads();
    }
    if (threadIdx.x == 0) {
      T* out = col < hdim ? dw2 + col
               : col < 2 * hdim ? db1 + (col - hdim) : db2;
      *out = from_f32<T>(buf[0]);
    }
    return;
  }
  const int4 sp = splits[blockIdx.x - n_cols];
  if (sp.x < 0) return;                // a pad split of padded plans
  const long n = sp.x;
  for (int col = threadIdx.x; col < 2 * hdim + d; col += kThreads) {
    // dh by default, then dpb and dpa
    int beg = sp.y, end = sp.w, c = col - 2 * hdim, width = d;
    const float* part = dpart;
    T* out = dh + n * d;
    if (col < 2 * hdim) {
      const bool recv = col < hdim;
      c = recv ? col : col - hdim;
      beg = recv ? sp.y : sp.z;
      end = recv ? sp.z : sp.w;
      width = hdim;
      part = hpart;
      out = (recv ? dpb : dpa) + n * hdim;
    }
    float a = 0.f;
    for (int slot = beg; slot < end; ++slot)
      a += part[static_cast<long>(slot) * width + c];
    out[c] = from_f32<T>(a);
  }
}

struct BwdArgs {
  const void *pa, *pb, *h, *w2, *b1, *g_mi, *g_mo;
  const float *em, *sig_sorted;
  const int32_t *send_in_recv, *recv_oth, *send_oth;
  const int4* items;
  int n_item, n_recv;
  const int4* splits;
  int n_split;
  float* e_sorted;
  float2* dl;
  float *dh_recv, *param_partial, *hpart, *dpart;
  void *dh, *dpa, *dpb, *dw2, *db1, *db2;
};

// Runs f(NH, kI, ND, kC) (as std::integral_constant) for the call's rows
// in groups of 2^log_lanes lanes: H rows as items of sh.h_bytes (16 or 8)
// on the vector path, one a lane, else one or eight elements a lane; D
// rows 2, 5 or 8 items a lane.
template <typename T, typename F>
int with_rows(const IterShape& sh, int log_lanes, F f) {
  using std::integral_constant;
  const int lanes = 1 << log_lanes;
  const int n_items = (sh.row_h() + lanes - 1) / lanes;
  const int chunks = (sh.row_d() + lanes - 1) / lanes;
  auto with_d = [&](auto nh, auto ki) {
    auto with_c = [&](auto nd) {
      if (chunks <= 2) return f(nh, ki, nd, integral_constant<int, 2>{});
      if (chunks <= 5) return f(nh, ki, nd, integral_constant<int, 5>{});
      return f(nh, ki, nd, integral_constant<int, 8>{});
    };
    return sh.vec_d ? with_c(integral_constant<int, 2>{})
                    : with_c(integral_constant<int, 1>{});
  };
  const auto one = integral_constant<int, 1>{};
  if (sh.vec_h) {
    if (n_items != 1) return static_cast<int>(cudaErrorInvalidValue);
    if (sh.h_bytes == 16)
      return with_d(integral_constant<int, 16 / sizeof(T)>{}, one);
    return with_d(integral_constant<int, 8 / sizeof(T)>{}, one);
  }
  if (n_items == 1) return with_d(one, one);
  return with_d(one, integral_constant<int, 8>{});
}

// The walks' staging: edges a chunk in each pass, and the bytes of an H
// and a D row's slot.
struct Staging {
  int recv_chunk, send_chunk, slot_h, slot_d;

  // Shared memory of a block of the recv (rows = 3) or send (2) pass.
  int smem(int chunk, int rows) const {
    return kWarpsPerBlock * chunk * (slot_h + (rows - 1) * slot_d);
  }

  // 0, or cudaErrorInvalidValue unless the slots hold a staged row (its
  // bytes + 4, in 16-byte multiples) and each pass's chunks take 1 to 32
  // edges in at most 48 KB of shared memory a block.
  int check(const IterShape& sh) const {
    const auto holds = [](int slot, int width, int elem) {
      return slot % 16 == 0 && slot >= width * elem + 4;
    };
    const auto fits = [&](int chunk, int rows) {
      return chunk >= 1 && chunk <= kWarp && smem(chunk, rows) <= 48 * 1024;
    };
    const bool ok = holds(slot_h, sh.hdim, sh.elem) &&
                    holds(slot_d, sh.d, sh.elem) && fits(recv_chunk, 3) &&
                    fits(send_chunk, 2);
    return ok ? 0 : static_cast<int>(cudaErrorInvalidValue);
  }
};

template <typename T>
int launch(IterShape sh, int log_lanes, int send_blocks, const Staging& sg,
           const BwdArgs& a, cudaStream_t st) {
  sh.elem = sizeof(T);
  const void* h_rows[] = {a.pa, a.pb, a.w2, a.b1, a.dpa, a.dpb};
  const void* d_rows[] = {a.h, a.g_mi, a.g_mo, a.dh};
  int err = sh.check(h_rows, 6, d_rows, 4);
  if (err == 0) err = sh.check_lanes(log_lanes, true);
  if (err == 0) err = sg.check(sh);
  const int n_send = a.n_item - a.n_recv;
  if (send_blocks < 0 || (n_send > 0) != (send_blocks > 0))
    err = static_cast<int>(cudaErrorInvalidValue);
  if (err != 0) return err;
  const unsigned recv_blocks = gnn::blocks_for_warps(a.n_recv);
  err = with_rows<T>(sh, log_lanes, [&](auto nh, auto ki, auto nd, auto kc) {
    constexpr int NH = decltype(nh)::value, kI = decltype(ki)::value;
    constexpr int ND = decltype(nd)::value, kC = decltype(kc)::value;
    using VH = Vec<T, NH>;
    using VD = Vec<T, ND>;
    const int row_h = sh.hdim / NH, row_d = sh.d / ND;
    if (recv_blocks > 0) {
      recv_kernel<T, NH, kI, ND, kC>
          <<<recv_blocks, kThreads, sg.smem(sg.recv_chunk, 3), st>>>(
              a.n_recv, row_h, row_d, log_lanes, sg.recv_chunk, sg.slot_h,
              sg.slot_d, static_cast<const VH*>(a.pa),
              static_cast<const VH*>(a.pb), static_cast<const VH*>(a.w2),
              static_cast<const VH*>(a.b1), a.sig_sorted,
              static_cast<const VD*>(a.h), static_cast<const VD*>(a.g_mi),
              static_cast<const VD*>(a.g_mo), a.em, a.items, a.recv_oth,
              a.e_sorted, a.dl, static_cast<VH*>(a.dpb),
              reinterpret_cast<Vec<float, NH>*>(a.hpart),
              reinterpret_cast<Vec<float, ND>*>(a.dh_recv),
              reinterpret_cast<Vec<float, ND>*>(a.dpart));
      const int e = static_cast<int>(cudaGetLastError());
      if (e != 0) return e;
    }
    if (send_blocks > 0)
      send_kernel<T, NH, kI, ND, kC>
          <<<send_blocks, kThreads, sg.smem(sg.send_chunk, 2), st>>>(
              n_send, a.n_recv, row_h, row_d, log_lanes, sg.send_chunk,
              sg.slot_h, sg.slot_d, static_cast<const VH*>(a.pa),
              static_cast<const VH*>(a.pb), static_cast<const VH*>(a.w2),
              static_cast<const VH*>(a.b1), static_cast<const VD*>(a.g_mi),
              a.e_sorted, a.dl, a.send_in_recv, a.items, a.send_oth,
              reinterpret_cast<const Vec<float, ND>*>(a.dh_recv),
              static_cast<VH*>(a.dpa), static_cast<VD*>(a.dh),
              reinterpret_cast<Vec<float, NH>*>(a.hpart),
              reinterpret_cast<Vec<float, ND>*>(a.dpart), a.param_partial);
    return static_cast<int>(cudaGetLastError());
  });
  if (err != 0) return err;
  finish_kernel<T><<<2 * sh.hdim + 1 + a.n_split, kThreads, 0, st>>>(
      send_blocks * kWarpsPerBlock, sh.hdim, sh.d, a.param_partial,
      static_cast<T*>(a.dw2), static_cast<T*>(a.db1), static_cast<T*>(a.db2),
      a.n_split, a.splits, a.hpart, a.dpart, static_cast<T*>(a.dh),
      static_cast<T*>(a.dpa), static_cast<T*>(a.dpb));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (pa, pb, h, w2, b1, g_mi, g_mo and
// every output).  h_bytes: H rows as items of 16 or 8 bytes, or 0 for
// one element an item.  vec_d, log_lanes (bwd_log_lanes there),
// recv_chunk, send_chunk, slot_h, slot_d: ops/cuda/spmm.py::
// iteration_launch; send_blocks: the send pass's grid (its warps stride
// over the send items), > 0 unless there are none.  em: [E] f32 edge mask
// and sig_sorted: [E] f32 the forward's edge scores
// (gnn_iteration_pair_fwd), both in the recv plan's order; send_in_recv:
// [E] position in the recv order of each send-sorted edge; recv_oth:
// senders in recv order; send_oth: receivers in send order.  items
// [n_item, 4], splits [n_split, 4]: IterItems, padded or not (entries of
// node -1 are skipped).  Scratch: e_sorted [E] f32
// and dl [E, 2] f32 (in recv order); dh_recv [V, d] f32; param_partial
// [2 hdim + 1, 8 send_blocks] f32; hpart [n_slot, hdim] and dpart
// [n_slot, d] f32.
int gnn_iteration_pair_bwd(
    int dtype, int n_edge, int d, int hdim, int h_bytes, int vec_d,
    int log_lanes, int send_blocks, int recv_chunk, int send_chunk,
    int slot_h, int slot_d, const void* pa, const void* pb, const void* h,
    const float* em, const float* sig_sorted, const int32_t* send_in_recv,
    const void* w2, const void* b1, const void* g_mi, const void* g_mo,
    const int32_t* recv_oth, const int32_t* send_oth, const int32_t* items,
    int n_item, int n_recv, const int32_t* splits, int n_split,
    float* e_sorted, float* dl, float* dh_recv, float* param_partial,
    float* hpart, float* dpart, void* dh, void* dpa, void* dpb, void* dw2,
    void* db1, void* db2, void* stream) {
  if (h_bytes != 0 && h_bytes != 8 && h_bytes != 16)
    return static_cast<int>(cudaErrorInvalidValue);
  const IterShape sh{n_edge, d, hdim, h_bytes != 0, vec_d, 0,
                     h_bytes != 0 ? h_bytes : 16};
  const Staging sg{recv_chunk, send_chunk, slot_h, slot_d};
  const BwdArgs a{pa, pb, h, w2, b1, g_mi, g_mo, em, sig_sorted,
                  send_in_recv, recv_oth, send_oth,
                  reinterpret_cast<const int4*>(items),
                  n_item, n_recv, reinterpret_cast<const int4*>(splits),
                  n_split, e_sorted, reinterpret_cast<float2*>(dl), dh_recv,
                  param_partial, hpart, dpart, dh, dpa, dpb, dw2, db1, db2};
  const auto st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(sh, log_lanes, send_blocks, sg, a, st);
  if (dtype == 1)
    return launch<__nv_bfloat16>(sh, log_lanes, send_blocks, sg, a, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
