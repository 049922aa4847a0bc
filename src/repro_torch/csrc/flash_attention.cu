// Forward attention with an online softmax:
//   o = softmax(q k^T / sqrt(D), causal: row >= col) v
// over (BH, S, D) tensors, f32 or bf16, with scores, running max, running
// sum and the output accumulator in f32 and the output in the inputs'
// dtype. A row that sees no key emits 0.
//
// Replaces src/repro/kernels/flash_attention.py:flash_attention_pallas
// (_flash_kernel). Its TPU grid carries m, l and acc in VMEM across a
// sequential kv axis; here a loop inside one block takes that axis. Key
// columns >= Sk are masked explicitly, not through the causal test, so a
// causal call with Sq > Sk and a ragged Sk gives the oracle's answer
// (ref.flash_attention), which the Pallas kernel does not: its zero-padded
// keys score 0 for the query rows >= Sk.
//
// Bound on the H100: operations. 4 D operations per unmasked (query, key)
// pair (the q.k products and sums, the p.v products and sums): at the
// tinyllama prefill (BH = 256, S = 2,048, D = 64, causal) 137 GFLOP, 0.14 ms
// at the bf16 tensor-core rate (989 TFLOP/s) and 2.05 ms at the FP32 rate
// (67 TFLOP/s); q, k, v and o move 0.27 GB (bf16), 0.08 ms at 3.35 TB/s.
// This kernel runs on the CUDA cores in FP32 (fmaf), so its own floor is
// the FP32 rate for either dtype; tensor cores (mma.sync / wgmma on bf16
// tiles) are the lever a later change takes.
// Design: one block of 8 warps per (bh, tile of BQ = 64 query rows); the
// heaviest causal tiles are scheduled first. The block stages its q tile
// once and then walks the key/value tiles of BK = 64 rows in shared
// memory (dynamic, up to 209 KB at D = 256), converted to f32 on load. A
// causal block stops at the last key tile that meets the diagonal. Each
// warp owns 8 query rows: a lane computes the scores of 2 key columns for
// its warp's rows (q read as broadcast float4, k rows padded to an odd
// float4 stride so a warp's reads hit distinct banks), the row max and sum
// are warp shuffles, p goes through shared memory, and a lane keeps the
// accumulator of columns lane + 32 j for the 8 rows in registers.
#include <cuda_bf16.h>
#include <math.h>

#include "common.cuh"

namespace {

constexpr int BQ = 64;                   // query rows per block
constexpr int BK = 64;                   // key rows per staged tile
constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int RPW = BQ / WARPS;          // query rows per warp
constexpr int MAX_D = 256;
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// dst[r * stride + c] = src[r * d + c] as f32 for r < ROWS, c < cols; 0
// where r >= avail (past the sequence) or c >= d (padding).
template <int ROWS, typename T>
__device__ void stage(float* dst, int stride, int cols, const T* src,
                      int64_t avail, int d) {
  for (int e = threadIdx.x; e < ROWS * cols; e += THREADS) {
    const int r = e / cols, c = e % cols;
    dst[r * stride + c] = (r < avail && c < d)
        ? to_f32(src[static_cast<int64_t>(r) * d + c]) : 0.f;
  }
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(FULL, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
  return v;
}

__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

// Shared-memory strides, in floats: q rows d4 (d rounded up to 4), k rows
// ks (an odd number of float4s), v rows DJ * 32 (every lane's columns).
struct Strides {
  int d4, ks, vs;
};

__host__ __device__ inline Strides strides(int d, int dj) {
  const int q4 = (d + 3) / 4;
  return {4 * q4, 4 * (q4 % 2 == 0 ? q4 + 1 : q4), 32 * dj};
}

template <typename T, int DJ>
__global__ void __launch_bounds__(THREADS)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, T* __restrict__ o, int64_t sq,
             int64_t sk, int d, int nq, bool causal, float scale) {
  extern __shared__ float4 smem4[];
  const Strides st = strides(d, DJ);
  float* qs = reinterpret_cast<float*>(smem4);   // BQ x d4
  float* kst = qs + BQ * st.d4;                  // BK x ks
  float* vst = kst + BK * st.ks;                 // BK x vs
  float* ps = vst + BK * st.vs;                  // BQ x BK
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int64_t bh = blockIdx.x / nq;
  const int64_t q0 = static_cast<int64_t>(nq - 1 - blockIdx.x % nq) * BQ;
  const T* kb = k + bh * sk * d;
  const T* vb = v + bh * sk * d;
  stage<BQ>(qs, st.d4, st.d4, q + (bh * sq + q0) * d, sq - q0, d);

  float m[RPW], l[RPW], acc[RPW][DJ];
#pragma unroll
  for (int r = 0; r < RPW; ++r) {
    m[r] = -INFINITY;
    l[r] = 0.f;
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[r][j] = 0.f;
  }

  const int64_t kv_end = (causal && q0 + BQ < sk) ? q0 + BQ : sk;
  for (int64_t k0 = 0; k0 < kv_end; k0 += BK) {
    __syncthreads();                     // the previous tile is consumed
    stage<BK>(kst, st.ks, st.d4, kb + k0 * d, sk - k0, d);
    stage<BK>(vst, st.vs, st.vs, vb + k0 * d, sk - k0, d);
    __syncthreads();

    float s[RPW][2];
#pragma unroll
    for (int r = 0; r < RPW; ++r) s[r][0] = s[r][1] = 0.f;
    for (int c = 0; c < st.d4; c += 4) {
      const float4 ka = *reinterpret_cast<const float4*>(kst + lane * st.ks + c);
      const float4 kc =
          *reinterpret_cast<const float4*>(kst + (lane + 32) * st.ks + c);
#pragma unroll
      for (int r = 0; r < RPW; ++r) {
        const float4 qv =
            *reinterpret_cast<const float4*>(qs + (w * RPW + r) * st.d4 + c);
        s[r][0] = dot4(qv, ka, s[r][0]);
        s[r][1] = dot4(qv, kc, s[r][1]);
      }
    }

#pragma unroll
    for (int r = 0; r < RPW; ++r) {
      const int64_t row = q0 + w * RPW + r;
      const int64_t ca = k0 + lane, cb = k0 + lane + 32;
      // explicit column mask: keys past Sk never score, causal or not
      const float va = (ca < sk && !(causal && ca > row))
          ? s[r][0] * scale : -INFINITY;
      const float vb2 = (cb < sk && !(causal && cb > row))
          ? s[r][1] * scale : -INFINITY;
      const float m_new = fmaxf(m[r], warp_max(fmaxf(va, vb2)));
      const float safe = m_new == -INFINITY ? 0.f : m_new;
      const float alpha = m[r] == -INFINITY ? 0.f : expf(m[r] - safe);
      const float pa = va == -INFINITY ? 0.f : expf(va - safe);
      const float pb = vb2 == -INFINITY ? 0.f : expf(vb2 - safe);
      l[r] = alpha * l[r] + warp_sum(pa + pb);
      m[r] = m_new;
#pragma unroll
      for (int j = 0; j < DJ; ++j) acc[r][j] *= alpha;
      ps[(w * RPW + r) * BK + lane] = pa;
      ps[(w * RPW + r) * BK + lane + 32] = pb;
    }
    __syncwarp();                        // a warp reads only its own p rows

    for (int c = 0; c < BK; c += 4) {
      float4 p[RPW];
#pragma unroll
      for (int r = 0; r < RPW; ++r) {
        p[r] = *reinterpret_cast<const float4*>(ps + (w * RPW + r) * BK + c);
      }
#pragma unroll
      for (int j = 0; j < DJ; ++j) {
        const float* vc = vst + c * st.vs + lane + 32 * j;
        const float4 vv = {vc[0], vc[st.vs], vc[2 * st.vs], vc[3 * st.vs]};
#pragma unroll
        for (int r = 0; r < RPW; ++r) acc[r][j] = dot4(p[r], vv, acc[r][j]);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < RPW; ++r) {
    const int64_t row = q0 + w * RPW + r;
    if (row >= sq) continue;
    T* orow = o + (bh * sq + row) * d;
#pragma unroll
    for (int j = 0; j < DJ; ++j) {
      const int col = lane + 32 * j;
      if (col < d) store(orow + col, l[r] == 0.f ? 0.f : acc[r][j] / l[r]);
    }
  }
}

size_t smem_bytes(int d, int dj) {
  const Strides st = strides(d, dj);
  return sizeof(float) * (static_cast<size_t>(BQ) * st.d4 + BK * st.ks
                          + BK * st.vs + BQ * BK);
}

template <typename T, int DJ>
int launch(const void* q, const void* k, const void* v, void* o, int64_t bh,
           int64_t sq, int64_t sk, int d, bool causal, cudaStream_t stream) {
  const int nq = static_cast<int>((sq + BQ - 1) / BQ);
  const size_t smem = smem_bytes(d, DJ);
  const cudaError_t attr = cudaFuncSetAttribute(
      flash_kernel<T, DJ>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (attr != cudaSuccess) return static_cast<int>(attr);
  flash_kernel<T, DJ><<<static_cast<unsigned>(bh * nq), THREADS, smem,
                        stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), sq, sk, d, nq, causal,
      1.0f / sqrtf(static_cast<float>(d)));
  return repro_launch_status();
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* o, int64_t bh,
             int64_t sq, int64_t sk, int d, bool causal, cudaStream_t st) {
  switch ((d + 31) / 32) {
    case 1: return launch<T, 1>(q, k, v, o, bh, sq, sk, d, causal, st);
    case 2: return launch<T, 2>(q, k, v, o, bh, sq, sk, d, causal, st);
    case 3: return launch<T, 3>(q, k, v, o, bh, sq, sk, d, causal, st);
    case 4: return launch<T, 4>(q, k, v, o, bh, sq, sk, d, causal, st);
    case 5: return launch<T, 5>(q, k, v, o, bh, sq, sk, d, causal, st);
    case 6: return launch<T, 6>(q, k, v, o, bh, sq, sk, d, causal, st);
    case 7: return launch<T, 7>(q, k, v, o, bh, sq, sk, d, causal, st);
    default: return launch<T, 8>(q, k, v, o, bh, sq, sk, d, causal, st);
  }
}

}  // namespace

// q (bh, sq, d), k and v (bh, sk, d), o (bh, sq, d) out; all contiguous, on
// one device, f32 (bf16 = 0) or bf16 (bf16 = 1). Needs 1 <= d <= 256 and
// bh * ceil(sq / 64) < 2^31.
REPRO_API int repro_flash_attention(const void* q, const void* k,
                                    const void* v, void* o, int64_t bh,
                                    int64_t sq, int64_t sk, int d, int causal,
                                    int bf16, void* stream) {
  if (d < 1 || d > MAX_D || bh < 0 || sq < 0 || sk < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (bh == 0 || sq == 0) return 0;
  if (bh * ((sq + BQ - 1) / BQ) > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto st = static_cast<cudaStream_t>(stream);
  return bf16 ? dispatch<__nv_bfloat16>(q, k, v, o, bh, sq, sk, d,
                                        causal != 0, st)
              : dispatch<float>(q, k, v, o, bh, sq, sk, d, causal != 0, st);
}
