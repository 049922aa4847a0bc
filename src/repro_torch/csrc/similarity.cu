// Negative squared Euclidean similarity:
//   s_ij = -max(0, ||x_i||^2 + ||y_j||^2 - 2 <x_i, y_j>)
//
// Replaces src/repro/kernels/similarity.py:similarity_pallas (_sim_kernel).
//
// Bound on the H100: bytes. The (N, M) f32 output is written once (N = M
// = 10,609 is 450 MB, 0.134 ms at 3.35 TB/s); the inputs are N*d floats
// and the work is ~2d+4 FP32 operations per output, far below the card's
// FP32 rate for the small d of pixel and point data (d = 3 for RGB).
// Design: a block owns a TI x TJ output tile. The x rows and y columns of
// the tile are staged in shared memory in chunks of DK features (y
// transposed, so a warp reads consecutive addresses), each thread owns one
// output column and keeps TI accumulators in registers, and every row of
// the tile is written as one coalesced 1 KB store per block. Plain FP32
// multiplies and adds, no tensor cores (TF32 would round the products).
// Row norms are summed in the same loop as the inner products.
#include "common.cuh"

namespace {

constexpr int TJ = 256;  // output columns per block = threads per block
constexpr int TI = 16;   // output rows per block
constexpr int DK = 32;   // features staged per shared-memory chunk

__global__ void __launch_bounds__(TJ)
similarity_kernel(const float* __restrict__ x, const float* __restrict__ y,
                  float* __restrict__ out, int64_t n, int64_t m, int d) {
  __shared__ float xs[TI][DK];
  __shared__ float ys[DK][TJ];
  const int t = threadIdx.x;
  const int64_t i0 = static_cast<int64_t>(blockIdx.x) * TI;
  const int64_t j0 = static_cast<int64_t>(blockIdx.y) * TJ;
  const int64_t j = j0 + t;

  float acc[TI], xx[TI];
#pragma unroll
  for (int r = 0; r < TI; ++r) { acc[r] = 0.f; xx[r] = 0.f; }
  float yy = 0.f;

  for (int k0 = 0; k0 < d; k0 += DK) {
    const int dk = min(DK, d - k0);
    for (int kk = 0; kk < DK; ++kk) {
      ys[kk][t] = (j < m && kk < dk) ? y[j * d + k0 + kk] : 0.f;
    }
    for (int idx = t; idx < TI * DK; idx += TJ) {
      const int r = idx / DK, kk = idx % DK;
      const int64_t i = i0 + r;
      xs[r][kk] = (i < n && kk < dk) ? x[i * d + k0 + kk] : 0.f;
    }
    __syncthreads();
    for (int kk = 0; kk < dk; ++kk) {
      const float yv = ys[kk][t];
      yy = __fadd_rn(yy, __fmul_rn(yv, yv));
#pragma unroll
      for (int r = 0; r < TI; ++r) {
        const float xv = xs[r][kk];
        acc[r] = __fadd_rn(acc[r], __fmul_rn(xv, yv));
        xx[r] = __fadd_rn(xx[r], __fmul_rn(xv, xv));
      }
    }
    __syncthreads();
  }

  if (j >= m) return;
#pragma unroll
  for (int r = 0; r < TI; ++r) {
    const int64_t i = i0 + r;
    if (i < n) {
      const float d2 = __fsub_rn(__fadd_rn(xx[r], yy), 2.0f * acc[r]);
      out[i * m + j] = -fmaxf(d2, 0.f);
    }
  }
}

}  // namespace

// x (n, d), y (m, d), out (n, m); all f32, contiguous, on one device.
REPRO_API int repro_similarity(const void* x, const void* y, void* out,
                               int64_t n, int64_t m, int d, void* stream) {
  if (n <= 0 || m <= 0) return 0;
  const dim3 grid(static_cast<unsigned>((n + TI - 1) / TI),
                  static_cast<unsigned>((m + TJ - 1) / TJ));
  similarity_kernel<<<grid, TJ, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(y),
      static_cast<float*>(out), n, m, d);
  return repro_launch_status();
}
