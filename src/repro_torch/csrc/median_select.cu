// Exact middle pair of a float32 array and its mean (the median preference):
//   lo = the ((cnt - 1) / 2)-th and hi = the (cnt / 2)-th smallest value
//   (0-based) of the cnt values; out = {lo, hi, 0.5f * (lo + hi)}
// over every value of an (rows, cols) array, or over its off-diagonal
// entries when the array is square and skip_diagonal is set.
//
// Replaces no TPU kernel: the reference takes the median with jnp.sort
// (src/repro/core/preferences.py:median_preference,
// src/repro/solver/topk.py:topk_preferences). torch.kthvalue, which the
// port used before, hands a 1-D input to one thread block: one SM of 132.
//
// Bound on the H100: bytes. Each pass reads the values once (the Mandrill's
// N*N - N = 112.5 M similarities are 450 MB, 0.134 ms at 3.35 TB/s), and a
// value costs a handful of integer operations.
// Design: an exact radix select over a monotone uint32 key of each value,
// in three digit passes (11, 11 and 10 bits, most significant first). A
// pass builds the histogram of the next digit of the values whose key
// matches the prefix found so far, in shared memory with warp-aggregated
// increments (__match_any_sync: integer-valued similarities crowd into a
// few dozen bins, where one shared atomic per value would serialise), and
// merges it into global memory. Then one block scans the histogram, finds
// the bins that hold the two ranks, and writes the longer prefixes and the
// ranks left inside them to device memory, where the next pass reads them.
// The two ranks travel together, each with a histogram of its own once
// their prefixes differ. The diagonal is skipped by index: nothing is
// copied. No value comes to the host and the launch sequence is fixed, so
// the selection adds no host sync. The mean rounds as the plain version's
// 0.5 * (lo + hi) does (--fmad=false).
#include <math.h>

#include "common.cuh"

namespace {

constexpr int THREADS = 256;       // histogram threads per block
constexpr int UNROLL = 8;          // values a thread loads per chunk
constexpr int CHUNK = THREADS * UNROLL;
constexpr int BLOCKS_PER_SM = 8;
constexpr int HIST = 2048;         // bins of the widest digit (11 bits)
constexpr int SCAN_THREADS = 256;
constexpr uint32_t NO_BIN = 0xffffffffu;
constexpr unsigned FULL = 0xffffffffu;

struct Select {
  unsigned long long hist[2][HIST];  // [0] the low rank's, [1] the high's
  unsigned long long rank[2];        // 0-based ranks left inside prefix
  uint32_t prefix[2];                // the key bits found so far
};

__host__ __device__ constexpr int shift_of(int pass) {
  return pass == 0 ? 21 : pass == 1 ? 10 : 0;
}
__host__ __device__ constexpr int bits_of(int pass) {
  return pass == 2 ? 10 : 11;
}

// A key whose unsigned order is the order torch.kthvalue ranks by: -0.0
// ranks as +0.0 and every NaN above +inf.
__device__ __forceinline__ uint32_t key_of(float v) {
  if (isnan(v)) return 0xffffffffu;
  uint32_t b = __float_as_uint(v);
  if (b == 0x80000000u) b = 0u;
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}

__device__ __forceinline__ float value_of(uint32_t key) {
  return __uint_as_float((key & 0x80000000u) ? (key & 0x7fffffffu) : ~key);
}

// One increment of hist[bin] for each lane whose bin is not NO_BIN, one
// shared atomic per distinct bin of the warp. Every lane of the warp calls.
__device__ __forceinline__ void count(uint32_t* hist, uint32_t bin,
                                      int lane) {
  if (__ballot_sync(FULL, bin != NO_BIN) == 0) return;
  const unsigned peers = __match_any_sync(FULL, bin);
  if (bin != NO_BIN && lane == __ffs(peers) - 1) {
    atomicAdd(&hist[bin], static_cast<uint32_t>(__popc(peers)));
  }
}

// The histogram of this pass's digit. Work item w is chunk w % per_row of
// row w / per_row; blocks stride over the work items.
template <int PASS>
__global__ void __launch_bounds__(THREADS)
digit_histogram_kernel(const float* __restrict__ x, int64_t rows,
                       int64_t cols, int64_t per_row, int skip_diagonal,
                       Select* st) {
  constexpr int SHIFT = shift_of(PASS);
  constexpr int BITS = bits_of(PASS);
  constexpr uint32_t MASK = (1u << BITS) - 1;
  constexpr int TARGETS = PASS == 0 ? 1 : 2;
  __shared__ uint32_t hist[TARGETS * HIST];
  for (int i = threadIdx.x; i < TARGETS * HIST; i += THREADS) hist[i] = 0;
  uint32_t pre_lo = 0, pre_hi = 0;
  if (PASS > 0) {
    pre_lo = st->prefix[0];
    pre_hi = st->prefix[1];
  }
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int64_t work = rows * per_row;
  for (int64_t w = blockIdx.x; w < work; w += gridDim.x) {
    const int64_t row = w / per_row;
    const int64_t c0 = (w - row * per_row) * CHUNK + threadIdx.x;
    const float* xr = x + row * cols;
    float v[UNROLL];
    bool ok[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int64_t c = c0 + u * THREADS;
      ok[u] = c < cols && !(skip_diagonal && c == row);
      v[u] = ok[u] ? xr[c] : 0.f;
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      uint32_t bin = NO_BIN;
      if (ok[u]) {
        const uint32_t key = key_of(v[u]);
        const uint32_t digit = (key >> SHIFT) & MASK;
        if (PASS == 0) {
          bin = digit;
        } else {
          const uint32_t top = key >> (SHIFT + BITS);
          if (top == pre_lo) {
            bin = digit;
          } else if (top == pre_hi) {
            bin = HIST + digit;
          }
        }
      }
      count(hist, bin, lane);
    }
  }
  __syncthreads();
  unsigned long long* out = &st->hist[0][0];
  for (int i = threadIdx.x; i < TARGETS * HIST; i += THREADS) {
    if (hist[i] != 0) {
      atomicAdd(&out[i], static_cast<unsigned long long>(hist[i]));
    }
  }
}

// One block: find the bins that hold the two ranks in this pass's
// histograms, extend the prefixes, leave the histograms zeroed for the next
// pass, and after the last pass write the two values and their mean.
__global__ void __launch_bounds__(SCAN_THREADS)
narrow_kernel(Select* st, int pass, unsigned long long k_lo,
              unsigned long long k_hi, float* out) {
  __shared__ unsigned long long h[2][HIST];
  __shared__ unsigned long long part[SCAN_THREADS];
  __shared__ unsigned long long found_rank[2];
  __shared__ uint32_t found_prefix[2];
  const int t = threadIdx.x;
  const int bits = pass == 2 ? 10 : 11;
  const int per = (1 << bits) / SCAN_THREADS;
  unsigned long long* g = &st->hist[0][0];
  for (int i = t; i < 2 * HIST; i += SCAN_THREADS) {
    (&h[0][0])[i] = g[i];
    g[i] = 0;
  }
  const unsigned long long rank[2] = {pass == 0 ? k_lo : st->rank[0],
                                      pass == 0 ? k_hi : st->rank[1]};
  const uint32_t prefix[2] = {pass == 0 ? 0u : st->prefix[0],
                              pass == 0 ? 0u : st->prefix[1]};
  __syncthreads();

  for (int target = 0; target < 2; ++target) {
    // pass 0 counts every value into h[0]; later passes count the high
    // rank's values into h[1] only where its prefix differs
    const unsigned long long* hh =
        h[(target == 1 && pass > 0 && prefix[1] != prefix[0]) ? 1 : 0];
    unsigned long long mine = 0;
    for (int j = 0; j < per; ++j) mine += hh[t * per + j];
    part[t] = mine;
    __syncthreads();
    for (int off = 1; off < SCAN_THREADS; off <<= 1) {
      const unsigned long long add = t >= off ? part[t - off] : 0ull;
      __syncthreads();
      part[t] += add;
      __syncthreads();
    }
    unsigned long long below = part[t] - mine;
    const unsigned long long r = rank[target];
    if (r >= below && r < below + mine) {
      for (int j = 0; j < per; ++j) {
        const unsigned long long c = hh[t * per + j];
        if (r < below + c) {
          found_rank[target] = r - below;
          found_prefix[target] =
              (prefix[target] << bits) | static_cast<uint32_t>(t * per + j);
          break;
        }
        below += c;
      }
    }
    __syncthreads();
  }
  if (t == 0) {
    st->rank[0] = found_rank[0];
    st->rank[1] = found_rank[1];
    st->prefix[0] = found_prefix[0];
    st->prefix[1] = found_prefix[1];
    if (pass == 2) {
      const float lo = value_of(found_prefix[0]);
      const float hi = value_of(found_prefix[1]);
      out[0] = lo;
      out[1] = hi;
      out[2] = __fmul_rn(__fadd_rn(lo, hi), 0.5f);
    }
  }
}

}  // namespace

REPRO_API int64_t repro_median_select_scratch() {
  return static_cast<int64_t>(sizeof(Select));
}

// x (rows, cols) f32, contiguous; the (k_lo)-th and (k_hi)-th smallest of
// its values (0-based; of its off-diagonal entries when skip_diagonal, for
// rows == cols) and their mean written to out (three f32). scratch holds
// repro_median_select_scratch() bytes; sms is the card's SM count.
REPRO_API int repro_median_select(const void* x, int64_t rows, int64_t cols,
                                  int skip_diagonal, int64_t k_lo,
                                  int64_t k_hi, int sms, void* scratch,
                                  void* out, void* stream) {
  if (rows <= 0 || cols <= 0 || sms <= 0 || k_lo < 0 || k_hi < k_lo) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto s = static_cast<cudaStream_t>(stream);
  const auto xf = static_cast<const float*>(x);
  auto st = static_cast<Select*>(scratch);
  auto of = static_cast<float*>(out);
  const int64_t per_row = (cols + CHUNK - 1) / CHUNK;
  const int64_t work = rows * per_row;
  const int64_t cap = static_cast<int64_t>(sms) * BLOCKS_PER_SM;
  const unsigned grid = static_cast<unsigned>(work < cap ? work : cap);
  const auto lo = static_cast<unsigned long long>(k_lo);
  const auto hi = static_cast<unsigned long long>(k_hi);
  int err = static_cast<int>(cudaMemsetAsync(st, 0, sizeof(Select), s));
  if (err != 0) return err;

  digit_histogram_kernel<0><<<grid, THREADS, 0, s>>>(
      xf, rows, cols, per_row, skip_diagonal, st);
  if ((err = repro_launch_status()) != 0) return err;
  narrow_kernel<<<1, SCAN_THREADS, 0, s>>>(st, 0, lo, hi, of);
  if ((err = repro_launch_status()) != 0) return err;
  digit_histogram_kernel<1><<<grid, THREADS, 0, s>>>(
      xf, rows, cols, per_row, skip_diagonal, st);
  if ((err = repro_launch_status()) != 0) return err;
  narrow_kernel<<<1, SCAN_THREADS, 0, s>>>(st, 1, lo, hi, of);
  if ((err = repro_launch_status()) != 0) return err;
  digit_histogram_kernel<2><<<grid, THREADS, 0, s>>>(
      xf, rows, cols, per_row, skip_diagonal, st);
  if ((err = repro_launch_status()) != 0) return err;
  narrow_kernel<<<1, SCAN_THREADS, 0, s>>>(st, 2, lo, hi, of);
  return repro_launch_status();
}
