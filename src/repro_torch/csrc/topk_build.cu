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
// subtraction, the max and the gate's compare; per point its norm): 5.37 ms
// at n = 200,000, d = 2 at 67 TFLOP/s; the bytes are the points and the
// (n, k) output, 0.03 ms. That bound counts two operations an FMA. The
// build must not use FMAs (below), so each operation is an instruction of
// its own and 33.5 T instructions/s is the floor: n^2 (2d + 5) / 33.5e12 =
// 10.7 ms at the blobs.
//
// Arithmetic (what keeps the edge sets bit-identical): every similarity is
// computed with the arithmetic and order of csrc/similarity.cu (the dot and
// the norms summed over features in ascending order, each product and sum
// rounded once with __fmul_rn/__fadd_rn; d2 = (xx + yy) - 2 acc), the
// library is built with --fmad=false, and no tensor core takes part (a TF32
// or split-bf16 product rounds otherwise). So this build, in_kernel_order
// and the reference scan on the card, whose tiles that kernel computes,
// select the same edges bit for bit. The first product starts the sum
// (acc = p0, not 0 + p0): the two differ only in the sign of a zero acc,
// and (xx + yy) - 2 acc is the same for either sign.
//
// Selection: each row's running top-k is a list sorted by (value desc, col
// asc) in shared memory (in the output row itself when k > SMEM_MAX_K),
// with its k-th value thr and that entry's column in registers. A candidate
// enters when it comes before the k-th entry in that order; it is inserted
// at its place by a shift of the list, and the result is the top k of all
// columns under the order, which depends only on the values.
//
// Design, against what held the first kernel (commit 4608d21 and before) to
// 4.9 % of the bound (staging waste and two barriers every 256 columns;
// per-pair index compares, a ballot per row, and 2 acc and fmaxf on every
// pair; issue stalls):
// 1. Staging: for d <= 15 (the packed path, which the solve's points take)
//    a pre-pass writes each point as 1, 2 or 4 float4s, its features then
//    zeros then its norm in the last slot, n rounded up to a whole step of
//    128 columns. A warp's rows (R = 2 for d <= 7, 1 for d <= 15) live in
//    registers for the whole column loop; each lane reads its column's
//    float4s straight from L1/L2 (__ldg; the blobs' 3.2 MB stay in L2) for
//    C = 4 groups of 32 columns at a time. The 8 warps of a block walk the
//    same columns, so L1 serves most of their reads, and the other warps of
//    the SM (64 registers a thread at d = 2: 32 warps) hide the load's
//    latency. No shared-memory tile, no block barrier. For d = 1, 2, 3 the feature loop
//    is exactly d long; for 4 <= d <= 15 it runs over 7 or 15 features, the
//    zeros adding exact +0 products. Larger d takes the staged path below
//    (the first kernel's tiles, staging only the chunk's features).
// 2. Per-pair work: d products, d - 1 sums, xx + yy, 2 acc, the subtraction
//    and one compare against a per-row bound G. For columns above every
//    listed one, G = -thr while thr < 0 and -inf otherwise (thr = +-0 or,
//    impossible here, > 0), so that -max(d2, 0) > thr <=> d2 < G for every
//    d2 that is not NaN:
//    - thr < 0: -max(d2, 0) > thr <=> max(d2, 0) < -thr <=> d2 < -thr (a
//      negative d2 from rounding gives max = 0 < -thr and d2 < -thr alike);
//    - thr = -inf: G = +inf, so every finite d2 passes, +inf does not;
//    - thr = +-0: s = -max(d2, 0) is -0 or below, never > +-0; d2 < -inf
//      never holds.
//    For columns below some listed one (segment B of point 5) a tie wins
//    when its column is smaller, so G is the float after -thr (d2 < G <=>
//    d2 <= -thr <=> -max(d2, 0) >= thr). The fast test is !(d2 >= G), which
//    also lets a NaN d2 through; the slow path then applies the exact test
//    on s = -fmaxf(d2, 0) (fmaxf(NaN, 0) = 0, so a NaN pair still counts as
//    -0, as it did), with col < n and col != row. So the selected set is
//    that of the first kernel for every input, NaN included.
//    topk_build.gate_in_kernel is this gate in PyTorch, and the CPU tests
//    hold both forms to the plain ones.
// 3. One vote per 32-column group for the warp's R rows: the rows' fast
//    tests are OR-ed into one predicate and __any_sync'd; only a group that
//    any row lets through takes per-row ballots. Column ids are 32-bit
//    (n < 2^31 is checked), and the diagonal and the padded columns past n
//    are tested only there, not on every pair.
// 4. Insertion: for k <= 64 lane l owns the list entries q = 32 j + l, so an
//    insertion loads them, shifts them with shuffles and stores them back
//    without a barrier (slot_insert); larger k keeps the first kernel's
//    warp-wide shift (list_insert). On the blobs the insertions (about
//    800 a row in ascending order) cost more than the pairs' arithmetic
//    (tools/topk_levers.py times both; PERF.md).
// 5. Order of the columns: each warp starts at the 128-column step that
//    holds its rows, runs to the end (segment A, every column above the
//    listed ones), and wraps to column 0 (segment B). Points near in index
//    are often near in space (a blob's points are contiguous, an image's
//    pixels in raster order), so the lists fill with near neighbours early
//    and fewer later columns pass.

#include <math.h>

#include "common.cuh"

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int SMEM_MAX_K = 640;          // lists in shared memory up to here

// ------------------------------------------------------------ packed path
constexpr int PW = 8;                    // warps per block
constexpr int PC = 4;                    // 32-column groups per step
constexpr int PSTEP = PC * 32;           // columns per step
constexpr int PACKED_MAX_D = 15;

// ------------------------------------------------------------ staged path
constexpr int WARPS = 8;                 // warps per block
constexpr int RPW = 4;                   // rows per warp
constexpr int ROWS = WARPS * RPW;        // rows per block
constexpr int TC = WARPS * 32;           // columns per staged tile
constexpr int GROUPS = TC / 32;          // 32-column groups per tile
constexpr int DK = 16;                   // features per staged chunk

// float4s per packed point (features, zeros, norm last) for the padded
// feature count D, and rows per warp: the rows' features stay in registers.
__host__ __device__ constexpr int packed_nv(int D) { return (D + 4) / 4; }
__host__ __device__ constexpr int packed_rows(int D) {
  return D <= 3 ? 2 : (D <= 7 ? 2 : 1);
}

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

// Point i of x (i < n) as 4 * NV floats: its d features, zeros, and its
// squared norm (summed as sqnorm_kernel does) in the last slot; the rows
// from n to n_pad are all zeros.
template <int NV>
__global__ void __launch_bounds__(256)
pack_kernel(const float* __restrict__ x, float* __restrict__ packed,
            int n, int n_pad, int d) {
  const int i = blockIdx.x * 256 + threadIdx.x;
  if (i >= n_pad) return;
  float* p = packed + static_cast<size_t>(i) * (4 * NV);
  float acc = 0.f;
  for (int f = 0; f < 4 * NV - 1; ++f) {
    float v = 0.f;
    if (i < n && f < d) {
      v = x[static_cast<size_t>(i) * d + f];
      acc = __fadd_rn(acc, __fmul_rn(v, v));
    }
    p[f] = v;
  }
  p[4 * NV - 1] = acc;
}

// Insert (v, c) into the warp's list lv/lc of length k, sorted by (value
// desc, col asc), given that (v, c) comes before the list's k-th entry in
// that order. Every lane of the warp calls it with the same arguments;
// returns the new k-th value.
__device__ __noinline__ float list_insert(float* lv, int* lc, int k, float v,
                                          int c, int lane) {
  // p = entries that come before (v, c): a prefix of the sorted list
  int p = 0;
  for (int b = 0; b < k; b += 32) {
    const int q = b + lane;
    const int cnt = __popc(__ballot_sync(
        FULL, q < k && (lv[q] > v || (lv[q] == v && lc[q] < c))));
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

// The fast gate's bound for a list whose k-th value is thr (see the note):
// columns above every listed one (strict), or below some (ties pass too).
__device__ __forceinline__ float gate_bound(float thr, bool ties) {
  if (ties) return thr > 0.f ? -INFINITY : nextafterf(-thr, INFINITY);
  return thr < 0.f ? -thr : -INFINITY;
}

// list_insert for k <= 32 KS: lane l owns the entries q = 32 j + l of the
// list (j < KS), so it loads them, the warp shifts them with shuffles and
// each lane stores its own back; no lane touches another's entries, so no
// barrier is needed. Returns the new k-th value.
template <int KS>
__device__ __forceinline__ float slot_insert(float* lv, int* lc, int k,
                                             float v, int c, int lane,
                                             int& kth_col) {
  float ov[KS], uv[KS];
  int oc[KS], uc[KS];
  int p = 0;                             // entries that come before (v, c)
#pragma unroll
  for (int j = 0; j < KS; ++j) {
    const int q = j * 32 + lane;
    ov[j] = q < k ? lv[q] : -INFINITY;
    oc[j] = q < k ? lc[q] : 0;
    p += __popc(__ballot_sync(
        FULL, q < k && (ov[j] > v || (ov[j] == v && oc[j] < c))));
  }
#pragma unroll
  for (int j = 0; j < KS; ++j) {         // entry q - 1, for every q
    uv[j] = __shfl_up_sync(FULL, ov[j], 1);
    uc[j] = __shfl_up_sync(FULL, oc[j], 1);
    if (j > 0) {
      const float cv = __shfl_sync(FULL, ov[j - 1], 31);
      const int cc = __shfl_sync(FULL, oc[j - 1], 31);
      if (lane == 0) {
        uv[j] = cv;
        uc[j] = cc;
      }
    }
  }
  float last = 0.f;
  int last_c = 0;
#pragma unroll
  for (int j = 0; j < KS; ++j) {
    const int q = j * 32 + lane;
    float nv = ov[j];
    int nc = oc[j];
    if (q > p) {
      nv = uv[j];
      nc = uc[j];
    } else if (q == p) {
      nv = v;
      nc = c;
    }
    if (q < k && q >= p) {
      lv[q] = nv;
      lc[q] = nc;
    }
    if (j == (k - 1) >> 5) {
      last = nv;
      last_c = nc;
    }
  }
  kth_col = __shfl_sync(FULL, last_c, (k - 1) & 31);
  return __shfl_sync(FULL, last, (k - 1) & 31);
}

// d features of each point exactly (D = d <= 3), or D = 7 or 15 with zero
// padding; NV float4s a point. KS > 0 (k <= 32 KS): each lane's slots of
// the lists in shared memory, slot_insert; KS = 0: list_insert on lists in
// shared memory or in the output rows.
template <int D, int KS>
__global__ void __launch_bounds__(PW * 32)
topk_packed_kernel(const float4* __restrict__ pk, float* __restrict__ out_v,
                   int* __restrict__ out_i, int n, int n_pad, int k,
                   bool lists_in_smem) {
  constexpr int NV = packed_nv(D);
  constexpr int PR = packed_rows(D);
  constexpr int PROWS = PW * PR;
  extern __shared__ float lists[];        // PROWS*k values, then PROWS*k cols
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int row0 = blockIdx.x * PROWS + w * PR;   // this warp's first row

  float xr[PR][D], xn[PR], thr[PR], gate[PR];
  int tcol[PR];                           // column of the k-th entry
#pragma unroll
  for (int r = 0; r < PR; ++r) {
    const int i = row0 + r;
    tcol[r] = 0;
    if (i < n) {
      float4 v[NV];
#pragma unroll
      for (int j = 0; j < NV; ++j) v[j] = pk[static_cast<size_t>(i) * NV + j];
      const float* f = reinterpret_cast<const float*>(v);
#pragma unroll
      for (int q = 0; q < D; ++q) xr[r][q] = f[q];
      xn[r] = f[4 * NV - 1];
      thr[r] = -INFINITY;
      gate[r] = INFINITY;
    } else {                              // no list: nothing ever passes
#pragma unroll
      for (int q = 0; q < D; ++q) xr[r][q] = 0.f;
      xn[r] = 0.f;
      thr[r] = INFINITY;
      gate[r] = -INFINITY;
    }
  }
  auto list_v = [&](int r) -> float* {
    return lists_in_smem ? lists + static_cast<size_t>(w * PR + r) * k
                         : out_v + static_cast<size_t>(row0 + r) * k;
  };
  auto list_c = [&](int r) -> int* {
    return lists_in_smem
               ? reinterpret_cast<int*>(lists + static_cast<size_t>(PROWS) * k)
                     + static_cast<size_t>(w * PR + r) * k
               : out_i + static_cast<size_t>(row0 + r) * k;
  };
#pragma unroll
  for (int r = 0; r < PR; ++r) {
    if (row0 + r < n) {                   // warp-uniform
      float* lv = list_v(r);
      int* lc = list_c(r);
      for (int q = lane; q < k; q += 32) {
        lv[q] = -INFINITY;
        lc[q] = 0;
      }
    }
  }
  __syncwarp();

  // Columns from the step holding the warp's rows to the end, then from 0
  // (segment B): near rows first, so the lists fill with near neighbours
  // early and fewer later columns pass. In segment B a candidate may tie
  // the k-th value with a smaller column, so its fast gate lets ties
  // through, and the exact test compares columns.
  const int a0 = row0 / PSTEP * PSTEP;
  bool wrapped = false;
  for (int t = 0, c0 = a0; t < n_pad / PSTEP; ++t, c0 += PSTEP) {
    if (c0 == n_pad) {                    // warp-uniform
      c0 = 0;
      wrapped = true;
#pragma unroll
      for (int r = 0; r < PR; ++r) {
        if (row0 + r < n) gate[r] = gate_bound(thr[r], true);
      }
    }
    float4 y[PC][NV];
#pragma unroll
    for (int g = 0; g < PC; ++g) {
#pragma unroll
      for (int j = 0; j < NV; ++j) {
        y[g][j] = __ldg(pk + static_cast<size_t>(c0 + g * 32 + lane) * NV + j);
      }
    }
#pragma unroll
    for (int g = 0; g < PC; ++g) {
      const float* yf = reinterpret_cast<const float*>(y[g]);
      const float yn = yf[4 * NV - 1];
      float d2[PR];
      bool pass = false;
#pragma unroll
      for (int r = 0; r < PR; ++r) {
        float acc = __fmul_rn(xr[r][0], yf[0]);
#pragma unroll
        for (int q = 1; q < D; ++q) {
          acc = __fadd_rn(acc, __fmul_rn(xr[r][q], yf[q]));
        }
        d2[r] = __fsub_rn(__fadd_rn(xn[r], yn), __fmul_rn(2.0f, acc));
        pass |= !(d2[r] >= gate[r]);
      }
      if (!__any_sync(FULL, pass)) continue;
      const int col = c0 + g * 32 + lane;
#pragma unroll
      for (int r = 0; r < PR; ++r) {
        const float s = -fmaxf(d2[r], 0.f);
        unsigned m = __ballot_sync(
            FULL, col < n && col != row0 + r
                      && (s > thr[r] || (s == thr[r] && col < tcol[r])));
        while (m) {
          const int src = __ffs(m) - 1;
          m &= m - 1;
          const float v = __shfl_sync(FULL, s, src);
          const int c = c0 + g * 32 + src;
          if (v > thr[r] || (v == thr[r] && c < tcol[r])) {
            if constexpr (KS > 0) {
              thr[r] = slot_insert<KS>(list_v(r), list_c(r), k, v, c, lane,
                                       tcol[r]);
            } else {
              thr[r] = list_insert(list_v(r), list_c(r), k, v, c, lane);
              tcol[r] = list_c(r)[k - 1];
            }
            gate[r] = gate_bound(thr[r], wrapped);
          }
        }
      }
    }
  }

  if (lists_in_smem) {
#pragma unroll
    for (int r = 0; r < PR; ++r) {
      const int i = row0 + r;
      if (i >= n) continue;
      const float* lv = list_v(r);
      const int* lc = list_c(r);
      for (int q = lane; q < k; q += 32) {
        out_v[static_cast<size_t>(i) * k + q] = lv[q];
        out_i[static_cast<size_t>(i) * k + q] = lc[q];
      }
    }
  }
}

// d > PACKED_MAX_D: each block owns ROWS = 32 rows, four per warp, and
// walks every column in ascending order in tiles of TC = 256 columns whose
// features are staged in shared memory in chunks of DK, feature-major, so a
// warp reads consecutive addresses; the same list and gate as above.
__global__ void __launch_bounds__(TC)
topk_staged_kernel(const float* __restrict__ x, const float* __restrict__ norms,
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
  float thr[RPW], gate[RPW], xn[RPW];
  int64_t row[RPW];
  bool live[RPW];
#pragma unroll
  for (int r = 0; r < RPW; ++r) {
    const int lr = w * RPW + r;
    row[r] = row0 + lr;
    live[r] = row[r] < n;
    xn[r] = live[r] ? norms[row[r]] : 0.f;
    thr[r] = -INFINITY;
    gate[r] = INFINITY;
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
      for (int kk = 0; kk < dk; ++kk) {
        ys[kk][t] = j < n ? x[j * d + k0 + kk] : 0.f;
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
      float d2[RPW];
      bool pass = false;
#pragma unroll
      for (int r = 0; r < RPW; ++r) {
        d2[r] = __fsub_rn(__fadd_rn(xn[r], ynv), 2.0f * acc[r][g]);
        pass |= live[r] && !(d2[r] >= gate[r]);
      }
      if (!__any_sync(FULL, pass)) continue;
#pragma unroll
      for (int r = 0; r < RPW; ++r) {
        if (!live[r]) continue;          // warp-uniform
        const float s = -fmaxf(d2[r], 0.f);
        unsigned m = __ballot_sync(
            FULL, col < n && col != row[r] && s > thr[r]);
        while (m) {
          const int src = __ffs(m) - 1;
          m &= m - 1;
          const float v = __shfl_sync(FULL, s, src);
          if (v > thr[r]) {
            thr[r] = list_insert(lv[r], lc[r], k, v,
                                 static_cast<int>(c0 + g * 32 + src), lane);
            gate[r] = gate_bound(thr[r], false);
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

int padded_d(int d) { return d <= 3 ? d : (d <= 7 ? 7 : 15); }

int64_t padded_n(int64_t n) { return (n + PSTEP - 1) / PSTEP * PSTEP; }

template <int D, int KS>
cudaError_t launch_packed_ks(const float4* pk, float* vals, int* idx, int n,
                             int n_pad, int k, cudaStream_t st) {
  constexpr int PROWS = PW * packed_rows(D);
  const bool smem = k <= SMEM_MAX_K;
  const size_t dyn = smem ? static_cast<size_t>(PROWS) * k * 8 : 0;
  const cudaError_t attr = cudaFuncSetAttribute(
      topk_packed_kernel<D, KS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(dyn));
  if (attr != cudaSuccess) return attr;
  topk_packed_kernel<D, KS><<<(n + PROWS - 1) / PROWS, PW * 32, dyn, st>>>(
      pk, vals, idx, n, n_pad, k, smem);
  return cudaSuccess;
}

template <int D>
cudaError_t launch_packed(const float* x, float* scratch, float* vals,
                          int* idx, int n, int d, int k, cudaStream_t st) {
  constexpr int NV = packed_nv(D);
  const int n_pad = static_cast<int>(padded_n(n));
  pack_kernel<NV><<<(n_pad + 255) / 256, 256, 0, st>>>(x, scratch, n, n_pad,
                                                       d);
  const auto pk = reinterpret_cast<const float4*>(scratch);
  if (k <= 32) return launch_packed_ks<D, 1>(pk, vals, idx, n, n_pad, k, st);
  if (k <= 64) return launch_packed_ks<D, 2>(pk, vals, idx, n, n_pad, k, st);
  return launch_packed_ks<D, 0>(pk, vals, idx, n, n_pad, k, st);
}

}  // namespace

// Floats of scratch repro_topk_build needs for n points of d features: the
// packed points for d <= 15, the norms otherwise.
REPRO_API int64_t repro_topk_build_scratch(int64_t n, int d) {
  if (d <= PACKED_MAX_D) return padded_n(n) * 4 * packed_nv(padded_d(d));
  return n;
}

// x (n, d) f32; scratch (repro_topk_build_scratch(n, d),) f32; vals (n, k)
// f32 and idx (n, k) i32 out, each row sorted by (value desc, col asc); all
// contiguous, on one device. Needs 1 <= k <= n - 1 < 2^31.
REPRO_API int repro_topk_build(const void* x, void* scratch, void* vals,
                               void* idx, int64_t n, int d, int k,
                               void* stream) {
  if (n <= 0) return 0;
  if (d < 1 || k < 1 || k > n - 1 || n > 0x7fffffffLL - PSTEP) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto st = static_cast<cudaStream_t>(stream);
  const auto xf = static_cast<const float*>(x);
  const auto sf = static_cast<float*>(scratch);
  const auto vf = static_cast<float*>(vals);
  const auto ii = static_cast<int*>(idx);
  const int n32 = static_cast<int>(n);
  cudaError_t err = cudaSuccess;
  switch (padded_d(d)) {
    case 1: err = launch_packed<1>(xf, sf, vf, ii, n32, d, k, st); break;
    case 2: err = launch_packed<2>(xf, sf, vf, ii, n32, d, k, st); break;
    case 3: err = launch_packed<3>(xf, sf, vf, ii, n32, d, k, st); break;
    case 7: err = launch_packed<7>(xf, sf, vf, ii, n32, d, k, st); break;
    default: {
      if (d <= PACKED_MAX_D) {
        err = launch_packed<15>(xf, sf, vf, ii, n32, d, k, st);
        break;
      }
      sqnorm_kernel<<<static_cast<unsigned>((n + 255) / 256), 256, 0, st>>>(
          xf, sf, n, d);
      const bool smem = k <= SMEM_MAX_K;
      const size_t dyn = smem ? static_cast<size_t>(ROWS) * k * 8 : 0;
      err = cudaFuncSetAttribute(topk_staged_kernel,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 static_cast<int>(dyn));
      if (err != cudaSuccess) break;
      topk_staged_kernel<<<static_cast<unsigned>((n + ROWS - 1) / ROWS), TC,
                           dyn, st>>>(xf, sf, vf, ii, n, d, k, smem);
    }
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  return repro_launch_status();
}
