// Damped availability update (paper Eq 2.2/2.3):
//   col_j  = sum_{k != j} max(0, r_kj);   diag_j = r_jj;   base_j = c_j + phi_j
//   new_ij = min(0, base_j + diag_j + col_j - max(0, r_ij))   (i != j)
//   new_jj = base_j + col_j
//   out_ij = lam * a_old_ij + (1 - lam) * new_ij
//
// Replaces src/repro/kernels/availability.py:availability_pallas
// (_colstats_kernel and _emit_kernel).
//
// Bound on the H100: bytes. r and a_old are read and a written once: three
// N x N f32 matrices per level, 1.35 GB at N = 10,609 (0.403 ms at
// 3.35 TB/s). This first version reads r twice (once for the column sums,
// once to emit), so it moves four matrices' worth.
// Design: the column sums run in a fixed order with no atomics, so re-runs
// are bit-identical. Pass 1 gives every (column, chunk of ROWS_PER_CHUNK
// rows) pair to one thread, which sums its rows in order (adjacent threads
// read adjacent columns, so each warp load is one 128-byte line); pass 2
// sums each column's chunk partials in chunk order and folds in c, phi and
// the diagonal; pass 3 emits one row per block. The summation order differs
// from PyTorch's, so the column sums (and only they) can differ from the
// plain version by a few ulps; on integer-valued inputs they are exact and
// the kernel is bit-identical to the plain version.
#include <math.h>

#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int ROWS_PER_CHUNK = 64;

__global__ void __launch_bounds__(THREADS)
col_partial_kernel(const float* __restrict__ r, float* __restrict__ partial,
                   int64_t n) {
  const int64_t j = static_cast<int64_t>(blockIdx.x) * THREADS + threadIdx.x;
  if (j >= n) return;
  const int64_t k0 = static_cast<int64_t>(blockIdx.y) * ROWS_PER_CHUNK;
  const int64_t k1 = k0 + ROWS_PER_CHUNK < n ? k0 + ROWS_PER_CHUNK : n;
  float acc = 0.f;
#pragma unroll 8
  for (int64_t k = k0; k < k1; ++k) {
    const float v = r[k * n + j];
    if (k != j) acc = __fadd_rn(acc, fmaxf(v, 0.f));
  }
  partial[static_cast<int64_t>(blockIdx.y) * n + j] = acc;
}

// off_j = (base_j + diag_j) + col_j and on_j = base_j + col_j, in the plain
// version's order of additions.
__global__ void __launch_bounds__(THREADS)
col_finish_kernel(const float* __restrict__ partial,
                  const float* __restrict__ r, const float* __restrict__ c,
                  const float* __restrict__ phi, float* __restrict__ off,
                  float* __restrict__ on, int64_t n, int n_chunks) {
  const int64_t j = static_cast<int64_t>(blockIdx.x) * THREADS + threadIdx.x;
  if (j >= n) return;
  float col = 0.f;
  for (int q = 0; q < n_chunks; ++q) {
    col = __fadd_rn(col, partial[static_cast<int64_t>(q) * n + j]);
  }
  const float base = __fadd_rn(c[j], phi[j]);
  off[j] = __fadd_rn(__fadd_rn(base, r[j * n + j]), col);
  on[j] = __fadd_rn(base, col);
}

__global__ void __launch_bounds__(THREADS)
availability_emit_kernel(const float* __restrict__ r,
                         const float* __restrict__ a_old,
                         const float* __restrict__ off,
                         const float* __restrict__ on, float* __restrict__ out,
                         int64_t n, float lam, float one_minus_lam) {
  const int64_t i = blockIdx.x;
  const int64_t row = i * n;
  for (int64_t j = threadIdx.x; j < n; j += THREADS) {
    float fresh;
    if (j == i) {
      fresh = on[j];
    } else {
      const float rp = fmaxf(r[row + j], 0.f);
      fresh = fminf(__fsub_rn(off[j], rp), 0.f);
    }
    out[row + j] = __fadd_rn(__fmul_rn(lam, a_old[row + j]),
                             __fmul_rn(one_minus_lam, fresh));
  }
}

}  // namespace

// Scratch floats the caller allocates for an n x n update.
REPRO_API int64_t repro_availability_scratch(int64_t n) {
  const int64_t n_chunks = (n + ROWS_PER_CHUNK - 1) / ROWS_PER_CHUNK;
  return (n_chunks + 2) * n;
}

// r, a_old, out (n, n); c, phi (n,); scratch repro_availability_scratch(n)
// floats; all f32, contiguous, on one device.
REPRO_API int repro_availability(const void* r, const void* c, const void* phi,
                                 const void* a_old, void* out, void* scratch,
                                 int64_t n, float lam, float one_minus_lam,
                                 void* stream) {
  if (n <= 0) return 0;
  const int64_t n_chunks = (n + ROWS_PER_CHUNK - 1) / ROWS_PER_CHUNK;
  if (n_chunks > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const auto st = static_cast<cudaStream_t>(stream);
  const auto rf = static_cast<const float*>(r);
  float* partial = static_cast<float*>(scratch);
  float* off = partial + n_chunks * n;
  float* on = off + n;
  const unsigned col_blocks = static_cast<unsigned>((n + THREADS - 1) / THREADS);

  col_partial_kernel<<<dim3(col_blocks, static_cast<unsigned>(n_chunks)),
                       THREADS, 0, st>>>(rf, partial, n);
  col_finish_kernel<<<col_blocks, THREADS, 0, st>>>(
      partial, rf, static_cast<const float*>(c),
      static_cast<const float*>(phi), off, on, n, static_cast<int>(n_chunks));
  availability_emit_kernel<<<static_cast<unsigned>(n), THREADS, 0, st>>>(
      rf, static_cast<const float*>(a_old), off, on, static_cast<float*>(out),
      n, lam, one_minus_lam);
  return repro_launch_status();
}
