// Fused top-k similarity build: for every row i of the (n, d) points x, the
// k largest off-diagonal similarities
//   s_ij = -max(0, ||x_i||^2 + ||x_j||^2 - 2 <x_i, x_j>)
// and their columns, under (value desc, col asc), without writing the
// (n, n) similarity matrix anywhere.
//
// Replaces src/repro/kernels/topk_build_fused.py:topk_similarity_fused
// (_build_kernel), whose k-step extract-max over (carry ++ tile) is not
// carried over.
//
// Bound on the H100: operations. n^2 (2d + 5) + 2nd FP32 operations (per
// pair the d products and d sums of the dot, xx + yy, 2 acc, the
// subtraction, the max and the gate's compare; per point its norm), 5.37 ms
// at n = 200,000, d = 2 at 67 TFLOP/s; the bytes are the points and the
// (n, k) output, 0.03 ms. Design: each block owns ROWS = 32 rows, four per warp, and walks
// every column in ascending order in tiles of TC = 256 columns whose
// features are staged in shared memory (feature-major, so a warp reads
// consecutive addresses). Each lane computes one column's similarity for
// the warp's four rows with the arithmetic and order of csrc/similarity.cu
// (acc, ||x_i||^2 and ||x_j||^2 summed over features in ascending order
// with __fmul_rn/__fadd_rn; d2 = (xx + yy) - 2 acc), so this build and the
// reference scan on the card, whose tiles that kernel computes, select
// bit-identical edge sets. Each row's running top-k is a list sorted by
// (value desc, col asc) in shared memory (in the output row itself when k
// is too large for shared memory), with its k-th value `thr` in a
// register. The gate is a strict s > thr: columns arrive in ascending
// order, so a candidate equal to thr would lose its tie. A warp ballot
// finds the lanes that pass; they are inserted in ascending lane (= column)
// order by a warp-wide shift of the list, re-checked against the raised
// thr. After warm-up insertions are rare, so the cost is the similarity
// arithmetic and the compare.
#include <math.h>

#include "common.cuh"

namespace {

constexpr int WARPS = 8;                 // warps per block
constexpr int RPW = 4;                   // rows per warp
constexpr int ROWS = WARPS * RPW;        // rows per block
constexpr int TC = WARPS * 32;           // columns per staged tile
constexpr int GROUPS = TC / 32;          // 32-column groups per tile
constexpr int DK = 16;                   // features per staged chunk
constexpr int SMEM_MAX_K = 640;          // lists in shared memory up to here
constexpr unsigned FULL = 0xffffffffu;

__global__ void __launch_bounds__(256)
sqnorm_kernel(const float* __restrict__ x, float* __restrict__ norms,
              int64_t n, int d) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * 256 + threadIdx.x;
  if (i >= n) return;
  float acc = 0.f;
  for (int f = 0; f < d; ++f) {
    const float v = x[i * d + f];
    acc = __fadd_rn(acc, __fmul_rn(v, v));
  }
  norms[i] = acc;
}

// Insert (v, c) into the warp's list lv/lc of length k, sorted by (value
// desc, col asc), given v > lv[k - 1] and c larger than every column in the
// list. Every lane of the warp calls it with the same arguments; returns
// the new k-th value.
__device__ __noinline__ float list_insert(float* lv, int* lc, int k, float v,
                                          int c, int lane) {
  // p = entries >= v: equal values hold smaller columns and stay first.
  int p = 0;
  for (int b = 0; b < k; b += 32) {
    const int q = b + lane;
    const int cnt = __popc(__ballot_sync(FULL, q < k && lv[q] >= v));
    p += cnt;
    if (cnt < 32) break;
  }
  // shift [p, k - 1) one slot down, from the top chunk to p's chunk
  for (int b = ((k - 1) >> 5) << 5; b + 31 > p; b -= 32) {
    const int q = b + lane;
    const bool move = q > p && q < k;
    float tv = 0.f;
    int tc = 0;
    if (move) {
      tv = lv[q - 1];
      tc = lc[q - 1];
    }
    __syncwarp();
    if (move) {
      lv[q] = tv;
      lc[q] = tc;
    }
    __syncwarp();
  }
  if (lane == 0) {
    lv[p] = v;
    lc[p] = c;
  }
  __syncwarp();
  return lv[k - 1];
}

__global__ void __launch_bounds__(TC)
topk_build_kernel(const float* __restrict__ x, const float* __restrict__ norms,
                  float* __restrict__ out_v, int* __restrict__ out_i,
                  int64_t n, int d, int k, bool lists_in_smem) {
  extern __shared__ float lists[];        // ROWS*k values, then ROWS*k cols
  __shared__ float ys[DK][TC];
  __shared__ float xs[ROWS][DK];
  __shared__ float yn[TC];
  const int t = threadIdx.x, lane = t & 31, w = t >> 5;
  const int64_t row0 = static_cast<int64_t>(blockIdx.x) * ROWS;

  float* lv[RPW];
  int* lc[RPW];
  float thr[RPW], xn[RPW];
  int64_t row[RPW];
  bool live[RPW];
#pragma unroll
  for (int r = 0; r < RPW; ++r) {
    const int lr = w * RPW + r;
    row[r] = row0 + lr;
    live[r] = row[r] < n;
    xn[r] = live[r] ? norms[row[r]] : 0.f;
    thr[r] = -INFINITY;
    if (lists_in_smem) {
      lv[r] = lists + static_cast<int64_t>(lr) * k;
      lc[r] = reinterpret_cast<int*>(lists + static_cast<int64_t>(ROWS) * k)
              + static_cast<int64_t>(lr) * k;
    } else {
      const int64_t base = (live[r] ? row[r] : 0) * k;
      lv[r] = out_v + base;
      lc[r] = out_i + base;
    }
    if (live[r]) {
      for (int q = lane; q < k; q += 32) {
        lv[r][q] = -INFINITY;
        lc[r][q] = 0;
      }
    }
  }
  __syncwarp();

  for (int64_t c0 = 0; c0 < n; c0 += TC) {
    float acc[RPW][GROUPS];
#pragma unroll
    for (int r = 0; r < RPW; ++r) {
#pragma unroll
      for (int g = 0; g < GROUPS; ++g) acc[r][g] = 0.f;
    }
    const int64_t j = c0 + t;            // the column this thread stages
    for (int k0 = 0; k0 < d; k0 += DK) {
      const int dk = min(DK, d - k0);
      __syncthreads();                   // the previous chunk is read
      for (int kk = 0; kk < DK; ++kk) {
        ys[kk][t] = (j < n && kk < dk) ? x[j * d + k0 + kk] : 0.f;
      }
      for (int e = t; e < ROWS * DK; e += TC) {
        const int r = e / DK, kk = e % DK;
        const int64_t i = row0 + r;
        xs[r][kk] = (i < n && kk < dk) ? x[i * d + k0 + kk] : 0.f;
      }
      if (k0 == 0) yn[t] = j < n ? norms[j] : 0.f;
      __syncthreads();
      for (int kk = 0; kk < dk; ++kk) {
        float xv[RPW];
#pragma unroll
        for (int r = 0; r < RPW; ++r) xv[r] = xs[w * RPW + r][kk];
#pragma unroll
        for (int g = 0; g < GROUPS; ++g) {
          const float yv = ys[kk][g * 32 + lane];
#pragma unroll
          for (int r = 0; r < RPW; ++r) {
            acc[r][g] = __fadd_rn(acc[r][g], __fmul_rn(xv[r], yv));
          }
        }
      }
    }

#pragma unroll
    for (int g = 0; g < GROUPS; ++g) {
      const int64_t col = c0 + g * 32 + lane;
      const float ynv = yn[g * 32 + lane];
#pragma unroll
      for (int r = 0; r < RPW; ++r) {
        if (!live[r]) continue;          // warp-uniform
        const float d2 = __fsub_rn(__fadd_rn(xn[r], ynv), 2.0f * acc[r][g]);
        const float s = -fmaxf(d2, 0.f);
        unsigned pass = __ballot_sync(
            FULL, col < n && col != row[r] && s > thr[r]);
        while (pass) {
          const int src = __ffs(pass) - 1;
          pass &= pass - 1;
          const float v = __shfl_sync(FULL, s, src);
          if (v > thr[r]) {
            thr[r] = list_insert(lv[r], lc[r], k, v,
                                 static_cast<int>(c0 + g * 32 + src), lane);
          }
        }
      }
    }
  }

  if (lists_in_smem) {
#pragma unroll
    for (int r = 0; r < RPW; ++r) {
      if (!live[r]) continue;
      for (int q = lane; q < k; q += 32) {
        out_v[row[r] * k + q] = lv[r][q];
        out_i[row[r] * k + q] = lc[r][q];
      }
    }
  }
}

}  // namespace

// x (n, d) f32; norms (n,) f32 scratch; vals (n, k) f32 and idx (n, k) i32
// out, each row sorted by (value desc, col asc); all contiguous, on one
// device. Needs 1 <= k <= n - 1 < 2^31.
REPRO_API int repro_topk_build(const void* x, void* norms, void* vals,
                               void* idx, int64_t n, int d, int k,
                               void* stream) {
  if (n <= 0) return 0;
  if (d < 1 || k < 1 || k > n - 1 || n > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto st = static_cast<cudaStream_t>(stream);
  const auto xf = static_cast<const float*>(x);
  const auto nf = static_cast<float*>(norms);
  sqnorm_kernel<<<static_cast<unsigned>((n + 255) / 256), 256, 0, st>>>(
      xf, nf, n, d);
  const bool smem = k <= SMEM_MAX_K;
  const size_t dyn = smem ? static_cast<size_t>(ROWS) * k * 8 : 0;
  const cudaError_t attr = cudaFuncSetAttribute(
      topk_build_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(dyn));
  if (attr != cudaSuccess) return static_cast<int>(attr);
  topk_build_kernel<<<static_cast<unsigned>((n + ROWS - 1) / ROWS), TC, dyn,
                      st>>>(xf, nf, static_cast<float*>(vals),
                            static_cast<int*>(idx), n, d, k, smem);
  return repro_launch_status();
}
