// Hand-written Hopper kernel for the doublet cross-join of graph
// preprocessing, ops/cuda/doublets.py::select_segments:
//
//   for each layer pair p, inner hit i of p and outer hit j of p:
//     dphi = wrap(phi2[j] - phi1[i])           (into [-pi, pi], two steps)
//     keep (i, j) if |dphi / (r2[j] - r1[i])| < cut[p]
//              and |z1[i] - r1[i] * (z2[j] - z1[i]) / (r2[j] - r1[i])| < z0_max
//
// Replaces: native/doublets.cpp (count_segments_f64 and
// select_segments_f64, the repo's only native kernel, C++/OpenMP on the
// host), which gnn_fpga_tpu/data/doublets.py calls once per layer pair.
// Here one call covers every layer pair of a graph: the hits of all pairs
// are concatenated, inner (r1, phi1, z1: [N1]) and outer (r2, phi2, z2:
// [N2]), with int64 offsets off1, off2: [P + 1] and a phi-slope cut a pair.
//
// Numbers: every quantity is computed in double with IEEE round-to-nearest
// intrinsics (__dsub_rn, __dadd_rn, __dmul_rn, __ddiv_rn), which the
// compiler never contracts into fused multiply-adds, in the order of the
// numpy expression (dphi / dr; z1 - ((r1 * dz) / dr)), and the two wraps
// of calc_dphi are applied one after the other as numpy's two `where`s
// are.  So the kept pairs equal numpy's bit for bit, and so does their
// order: pair by pair, then inner row, then outer row (np.nonzero's
// row-major order).  A zero dr gives an infinite or NaN slope, which no
// cut keeps, as in numpy.
//
// Two passes, as in the C++: `count_kernel` writes the number of kept
// outer hits of each inner row; the caller takes an inclusive prefix sum
// of the counts (one host sync reads the total and sizes the output);
// `emit_kernel` writes int64 (i1, i2), global row indices into the
// concatenated inner and outer hits, at each row's offset.
//
// Design (simple first): one warp an inner row.  The warp finds the row's
// pair in off1, keeps the row's r1, phi1, z1 in registers and walks the
// pair's outer hits 32 at a time, a lane a hit, reading them coalesced
// through the read-only cache.  The count pass sums the lanes' counts with
// a warp reduction; the emit pass takes a ballot of the 32 lanes' tests,
// and each kept lane writes at the row's offset plus the kept lanes below
// it, so the outer hits stay in order.  No shared memory.
//
// What bounds it on this card: operations.  A pair evaluation reads 24
// bytes of outer hit that the other rows of its pair read too (they stay
// in L2), and does two double divisions, which Hopper computes in several
// double operations each; the bytes a call must move (each hit read once,
// each kept pair written once) are small beside that.
//
// Interface: plain C functions, loaded with ctypes.  Each launches on the
// given stream, allocates nothing, and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarp = 32;
constexpr int kWarpsPerBlock = 8;
constexpr unsigned kFull = 0xffffffffu;
// numpy's np.pi and 2 * np.pi
constexpr double kPi = 3.141592653589793;
constexpr double kTwoPi = 6.283185307179586;
// inner rows a launch can take: blocks of kWarpsPerBlock rows, at most
// 2^31 - 1 blocks
constexpr int64_t kMaxRows = int64_t{kWarpsPerBlock} * 0x7fffffff;

struct Hits {
  const double* r;
  const double* phi;
  const double* z;
};

struct Args {
  int n_pairs;
  int64_t n1;
  Hits in, out;
  const int64_t* off1;
  const int64_t* off2;
  const double* cut;
  double z0_max;
};

// The test of numpy's select_segments_arrays for one (inner, outer) pair.
__device__ __forceinline__ bool keep(double ri, double pi, double zi,
                                     double rj, double pj, double zj,
                                     double cut, double z0_max) {
  double dphi = __dsub_rn(pj, pi);
  if (dphi > kPi) dphi = __dsub_rn(dphi, kTwoPi);
  if (dphi < -kPi) dphi = __dadd_rn(dphi, kTwoPi);
  const double dr = __dsub_rn(rj, ri);
  const double dz = __dsub_rn(zj, zi);
  const double slope = __ddiv_rn(dphi, dr);
  const double z0 = __dsub_rn(zi, __ddiv_rn(__dmul_rn(ri, dz), dr));
  return fabs(slope) < cut && fabs(z0) < z0_max;
}

// The pair of inner row `row`: the p with off1[p] <= row < off1[p + 1].
__device__ __forceinline__ int pair_of(const Args& a, int64_t row) {
  int p = 0;
  while (p + 1 < a.n_pairs && a.off1[p + 1] <= row) ++p;
  return p;
}

__global__ void __launch_bounds__(kWarp * kWarpsPerBlock)
    count_kernel(Args a, int64_t* __restrict__ counts) {
  const int64_t row = static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock +
                      threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  if (row >= a.n1) return;
  const int p = pair_of(a, row);
  const double ri = a.in.r[row], pi = a.in.phi[row], zi = a.in.z[row];
  const double cut = a.cut[p];
  const int64_t beg = a.off2[p], end = a.off2[p + 1];
  int n = 0;
  for (int64_t j = beg + lane; j < end; j += kWarp)
    n += keep(ri, pi, zi, __ldg(a.out.r + j), __ldg(a.out.phi + j),
              __ldg(a.out.z + j), cut, a.z0_max);
  long long total = n;
#pragma unroll
  for (int s = kWarp / 2; s > 0; s /= 2)
    total += __shfl_down_sync(kFull, total, s);
  if (lane == 0) counts[row] = total;
}

__global__ void __launch_bounds__(kWarp * kWarpsPerBlock)
    emit_kernel(Args a, const int64_t* __restrict__ ends,
                int64_t* __restrict__ out1, int64_t* __restrict__ out2) {
  const int64_t row = static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock +
                      threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  if (row >= a.n1) return;
  int64_t at = row == 0 ? 0 : ends[row - 1];
  if (at == ends[row]) return;   // no kept pair: the whole warp leaves
  const int p = pair_of(a, row);
  const double ri = a.in.r[row], pi = a.in.phi[row], zi = a.in.z[row];
  const double cut = a.cut[p];
  const int64_t beg = a.off2[p], end = a.off2[p + 1];
  const unsigned below = (1u << lane) - 1u;
  for (int64_t j0 = beg; j0 < end; j0 += kWarp) {
    const int64_t j = j0 + lane;
    const bool k = j < end &&
                   keep(ri, pi, zi, __ldg(a.out.r + j), __ldg(a.out.phi + j),
                        __ldg(a.out.z + j), cut, a.z0_max);
    const unsigned ballot = __ballot_sync(kFull, k);
    if (k) {
      const int64_t o = at + __popc(ballot & below);
      out1[o] = row;
      out2[o] = j;
    }
    at += __popc(ballot);
  }
}

Args make_args(int n_pairs, int64_t n1, const void* r1, const void* phi1,
               const void* z1, const void* r2, const void* phi2,
               const void* z2, const void* off1, const void* off2,
               const void* cut, double z0_max) {
  Args a;
  a.n_pairs = n_pairs;
  a.n1 = n1;
  a.in = {static_cast<const double*>(r1), static_cast<const double*>(phi1),
          static_cast<const double*>(z1)};
  a.out = {static_cast<const double*>(r2), static_cast<const double*>(phi2),
           static_cast<const double*>(z2)};
  a.off1 = static_cast<const int64_t*>(off1);
  a.off2 = static_cast<const int64_t*>(off2);
  a.cut = static_cast<const double*>(cut);
  a.z0_max = z0_max;
  return a;
}

unsigned blocks_for(int64_t n1) {
  return static_cast<unsigned>((n1 + kWarpsPerBlock - 1) / kWarpsPerBlock);
}

}  // namespace

extern "C" {

// r1, phi1, z1: [n1] f64 inner hits; r2, phi2, z2: [N2] f64 outer hits;
// off1, off2: [n_pairs + 1] int64 (off1[n_pairs] == n1); cut: [n_pairs]
// f64.  counts: [n1] int64, the kept outer hits of each inner row.
int gnn_doublet_count(int n_pairs, int64_t n1, const void* r1,
                      const void* phi1, const void* z1, const void* r2,
                      const void* phi2, const void* z2, const void* off1,
                      const void* off2, const void* cut, double z0_max,
                      void* counts, void* stream) {
  if (n_pairs < 1 || n1 < 1 || n1 > kMaxRows)
    return static_cast<int>(cudaErrorInvalidValue);
  count_kernel<<<blocks_for(n1), kWarp * kWarpsPerBlock, 0,
                 static_cast<cudaStream_t>(stream)>>>(
      make_args(n_pairs, n1, r1, phi1, z1, r2, phi2, z2, off1, off2, cut,
                z0_max),
      static_cast<int64_t*>(counts));
  return static_cast<int>(cudaGetLastError());
}

// As gnn_doublet_count, with ends: [n1] int64, the inclusive prefix sum of
// its counts; out1, out2: [ends[n1 - 1]] int64, the kept (inner, outer)
// global rows in (pair, inner, outer) order.
int gnn_doublet_emit(int n_pairs, int64_t n1, const void* r1,
                     const void* phi1, const void* z1, const void* r2,
                     const void* phi2, const void* z2, const void* off1,
                     const void* off2, const void* cut, double z0_max,
                     const void* ends, void* out1, void* out2,
                     void* stream) {
  if (n_pairs < 1 || n1 < 1 || n1 > kMaxRows)
    return static_cast<int>(cudaErrorInvalidValue);
  emit_kernel<<<blocks_for(n1), kWarp * kWarpsPerBlock, 0,
                static_cast<cudaStream_t>(stream)>>>(
      make_args(n_pairs, n1, r1, phi1, z1, r2, phi2, z2, off1, off2, cut,
                z0_max),
      static_cast<const int64_t*>(ends), static_cast<int64_t*>(out1),
      static_cast<int64_t*>(out2));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
