// Damped responsibility update (paper Eq 2.1):
//   v = a + s;  (m1, i1, m2) = per-row (max, first argmax, second max) of v
//   out_ij = lam * r_old_ij + (1 - lam) * (s_ij + min(tau_i, -(j == i1 ? m2 : m1)))
//
// Replaces src/repro/kernels/responsibility.py:responsibility_pallas
// (_top2_kernel and _emit_kernel).
//
// Bound on the H100: bytes. s, a and r_old are read and r written once:
// four N x N f32 matrices per level, 1.8 GB at N = 10,609 (0.538 ms at
// 3.35 TB/s); the work is a handful of FP32 operations per element.
// Design: one block per row, so the row reduction needs no second pass and
// no scratch in device memory. The block reads a and s once, forms v = a + s
// in registers (the TPU wrapper materialised v in HBM), reduces (max, first
// argmax, second max) with an order-independent combine, and emits the damped
// row from s and r_old. The second read of the row of s (42 KB at
// N = 10,609) is expected to hit L2; on an H100 SXM it measured faster than keeping
// the row in shared memory (PERF.md), and it has no limit on row length. The
// combine keeps the lowest index on ties, so the result does not depend on
// how the row is split over threads, and is bit-identical to the plain
// PyTorch version.
#include <climits>
#include <math.h>

#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;

struct Top2 {
  float m1;  // max
  int i1;    // first index of the max; INT_MAX when nothing seen
  float m2;  // max with one instance of m1 (at i1) removed
};

// Merge two summaries of disjoint index sets; commutative and associative.
__device__ __forceinline__ Top2 combine(Top2 a, Top2 b) {
  const bool b_wins = b.m1 > a.m1 || (b.m1 == a.m1 && b.i1 < a.i1);
  if (b_wins) return {b.m1, b.i1, fmaxf(b.m2, a.m1)};
  return {a.m1, a.i1, fmaxf(a.m2, b.m1)};
}

__global__ void __launch_bounds__(THREADS)
responsibility_kernel(const float* __restrict__ s, const float* __restrict__ a,
                      const float* __restrict__ tau,
                      const float* __restrict__ r_old, float* __restrict__ out,
                      int64_t m, float lam, float one_minus_lam) {
  __shared__ Top2 warp_top[WARPS];
  __shared__ Top2 row_top;

  const int64_t row = static_cast<int64_t>(blockIdx.x) * m;
  const float* s_i = s + row;
  const float* a_i = a + row;

  // Each thread walks its columns in increasing order, so a strict '>'
  // keeps the first occurrence of its maximum.
  Top2 top = {-INFINITY, INT_MAX, -INFINITY};
  for (int j = threadIdx.x; j < m; j += THREADS) {
    const float v = __fadd_rn(a_i[j], s_i[j]);
    if (v > top.m1 || top.i1 == INT_MAX) {
      top.m2 = top.m1;
      top.m1 = v;
      top.i1 = j;
    } else if (v > top.m2) {
      top.m2 = v;
    }
  }

  const unsigned full = 0xffffffffu;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    Top2 other;
    other.m1 = __shfl_down_sync(full, top.m1, off);
    other.i1 = __shfl_down_sync(full, top.i1, off);
    other.m2 = __shfl_down_sync(full, top.m2, off);
    top = combine(top, other);
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) warp_top[warp] = top;
  __syncthreads();
  if (warp == 0) {
    top = lane < WARPS ? warp_top[lane]
                       : Top2{-INFINITY, INT_MAX, -INFINITY};
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      Top2 other;
      other.m1 = __shfl_down_sync(full, top.m1, off);
      other.i1 = __shfl_down_sync(full, top.i1, off);
      other.m2 = __shfl_down_sync(full, top.m2, off);
      top = combine(top, other);
    }
    if (lane == 0) row_top = top;
  }
  __syncthreads();

  const Top2 rt = row_top;
  const float t = tau[blockIdx.x];
  const float* r_i = r_old + row;
  float* o_i = out + row;
  for (int j = threadIdx.x; j < m; j += THREADS) {
    const float row_max = (j == rt.i1) ? rt.m2 : rt.m1;
    const float fresh = __fadd_rn(s_i[j], fminf(t, -row_max));
    o_i[j] = __fadd_rn(__fmul_rn(lam, r_i[j]), __fmul_rn(one_minus_lam, fresh));
  }
}

}  // namespace

// s, a, r_old, out (n, m); tau (n,); all f32, contiguous, on one device.
REPRO_API int repro_responsibility(const void* s, const void* a,
                                   const void* tau, const void* r_old,
                                   void* out, int64_t n, int64_t m, float lam,
                                   float one_minus_lam, void* stream) {
  if (n <= 0 || m <= 0) return 0;
  if (m >= INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  responsibility_kernel<<<static_cast<unsigned>(n), THREADS, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(s), static_cast<const float*>(a),
      static_cast<const float*>(tau), static_cast<const float*>(r_old),
      static_cast<float*>(out), m, lam, one_minus_lam);
  return repro_launch_status();
}
