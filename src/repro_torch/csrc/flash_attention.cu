// Forward attention with an online softmax, on the tensor cores:
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
// Bound on the H100: operations. The function needs 4 D operations per
// unmasked (query, key) pair (the q.k products and sums, the p.v products
// and sums): at the tinyllama prefill (BH = 256, S = 2,048, D = 64, causal)
// 137.4 GFLOP, 0.139 ms at the bf16 tensor-core rate (989 TFLOP/s), and
// 0.83 ms in f32 at 495 / 3 = 165 TFLOP/s, the rate at which the tensor
// cores give f32-accurate products (3xTF32, below); q, k, v and o move
// 0.27 GB in bf16, 0.08 ms at 3.35 TB/s.
//
// Precision, and the extra tensor-core work it costs. A single bf16
// rounding of p, or one TF32 pass in f32, misses the f32 tolerance that
// the port holds the kernel to (kernels/flash_attention.py: tolerance,
// in_kernel_precision emulates both schemes), so:
// - bf16: q.k is exact (bf16 products, f32 sums); p is split into
//   hi = bf16(p) and lo = bf16(p - hi) and o += hi.v + lo.v: 6 D
//   tensor-core operations per pair instead of 4 D.
// - f32: every operand x of both products splits into big = tf32(x) and
//   small = tf32(x - big) (cvt.rna rounding) and a.b is taken as
//   small.big + big.small + big.big: 12 D operations per pair, at half the
//   bf16 rate.
// The tensor cores' own sums truncate: an mma.sync aligns its products and
// its accumulator to the largest of them, keeps 2 bits below f32's last
// place and drops the rest (in_kernel_precision models it). The f32 error
// is therefore several times that of round-to-nearest sums, within the
// tolerance all the same.
//
// Design, against what held the CUDA-core version of this kernel back:
// - Tensor cores (it ran every product as FP32 fmaf): mma.sync m16n8k16
//   (bf16 operands) or m16n8k8 (TF32), f32 accumulators. A block of 4
//   warps owns 64 query rows, 16 a warp, or 128 rows, 32 a warp, for bf16
//   at D <= 64. A thread holds 2 rows of each 16-row score and output
//   tile, so a row's max is 2 quad shuffles and its sum is reduced once at
//   the end. The softmax folds 1/sqrt(D) log2(e) into one scale and runs
//   ex2.approx. p goes from the score accumulators into A fragments in
//   registers without a shuffle: in bf16 the accumulator layout of two n8
//   tiles is the A layout of one k16 step; in TF32 the k index of each
//   8-key step is permuted (t <-> key 2t, t + 4 <-> key 2t + 1), and V's
//   fragments are read in that order. The q tile is loaded once and held
//   in registers as (split) A fragments (bf16 D <= 128, f32 D <= 64; wider
//   heads re-read it from shared memory each tile). The kernel is
//   declared for 1 block an SM so that ptxas may spend registers on
//   loads in flight: 2 blocks fit at D = 128 all the same.
// - Shared-memory traffic (10 LDS.128 per 64 FMAs, V gathered one scalar
//   at a time): K and V fragments come through ldmatrix (bf16; .trans for
//   V) or 64/32-bit loads (f32, with the sum over d in the same permuted
//   order so that q and k pairs are adjacent); each bf16 V fragment serves
//   hi and lo, and at 32 rows a warp each K and V fragment two row tiles.
//   Rows are padded by 16 B (bf16) or 32 B / 16 B (f32 k / v) so every
//   fragment read is free of bank conflicts.
// - bf16 widened to f32 in shared memory: tiles stay in the input dtype.
// - No overlap of loads and math: a ring of 2 key/value stages filled with
//   16-byte cp.async.cg (zero-filling rows past Sk and columns past D);
//   tile i + 1 is issued before tile i's math. A D whose rows are not
//   16-byte aligned stages with element loads into the same zero-padded
//   layout.
// - D in buckets of 32, 64, 128, 256 (zero-padded). Key tiles of 64 rows,
//   32 for f32 at D > 64 (shared memory: 202 KB at D = 256). At D = 256 the
//   accumulators alone take 128 registers a thread and ptxas spills 76
//   bytes (bf16) or 120 (f32).
// - The causal and Sk masks are applied only on a tile that crosses the
//   warp's diagonal or the ragged end; a causal block stops at its last
//   diagonal tile, and the heaviest causal blocks of a head launch first.
// - No atomics and a fixed order of every sum: a re-run is bit-equal.
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "common.cuh"

namespace {

constexpr int WARPS = 4;
constexpr int THREADS = WARPS * 32;
constexpr int MIN_BQ = 64;               // query rows per block, at least
constexpr int MAX_D = 256;
constexpr unsigned FULL = 0xffffffffu;

using bf16 = __nv_bfloat16;

// Tiling and shared-memory layout of one (dtype, padded D) instance;
// strides in elements. A warp owns MT m16 tiles of query rows: 2 for bf16
// at D <= 64, where the registers allow each K and V fragment read to
// serve two row tiles, else 1. With q in registers its staging area is the
// ring's stage 1, free again before the first tile is consumed.
template <typename T, int DP>
struct Geom {
  static constexpr bool F32 = std::is_same<T, float>::value;
  static constexpr int MT = (!F32 && DP <= 64) ? 2 : 1;
  static constexpr int BQ = 16 * MT * WARPS;     // query rows per block
  static constexpr int BK = (F32 && DP > 64) ? 32 : 64;  // key rows a tile
  static constexpr int QS = DP + 8;
  static constexpr int KS = DP + 8;
  static constexpr int VS = F32 ? DP + 4 : DP + 8;
  static constexpr bool Q_REGS = DP <= (F32 ? 64 : 128);
  static constexpr int Q_ELEMS = BQ * QS;
  static constexpr int K_ELEMS = BK * KS;
  static constexpr int STAGE = BK * (KS + VS);
  static_assert(!Q_REGS || Q_ELEMS <= STAGE, "q staging must fit a stage");
  static constexpr int ELEMS = Q_REGS ? 2 * STAGE : Q_ELEMS + 2 * STAGE;
};

// ------------------------------------------------------------------ PTX
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; bytes = 0 writes 16 zero bytes, reads nothing
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(bytes) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(smem_u32(p)));
}

// c += a b for a 16 x 16 bf16 A, a 16 x 8 bf16 B, f32 c
__device__ __forceinline__ void mma_bf16(float (&c)[4],
                                         const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c += a b for a 16 x 8 TF32 A, an 8 x 8 TF32 B, f32 c
__device__ __forceinline__ void mma_tf32(float (&c)[4],
                                         const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 2^x on the special-function unit (ex2.approx; 2^-inf = 0)
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// cvt.rna.tf32.f32 for finite x, in two integer operations: round the 13
// dropped mantissa bits to nearest, ties away from zero
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

__device__ __forceinline__ void split_tf32(float x, uint32_t& big,
                                           uint32_t& small) {
  big = tf32_rna(x);
  small = tf32_rna(__fsub_rn(x, __uint_as_float(big)));
}

// (x, y) -> hi = bf16(x, y), lo = bf16(x - hi.x, y - hi.y), x in the low
// half of each register
__device__ __forceinline__ void split_bf16(float x, float y, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  const float2 hf = __bfloat1622float2(h);
  const __nv_bfloat162 r =
      __floats2bfloat162_rn(__fsub_rn(x, hf.x), __fsub_rn(y, hf.y));
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&r);
}

// ------------------------------------------------------------- staging
__device__ __forceinline__ float zero_of(float) { return 0.f; }
__device__ __forceinline__ bf16 zero_of(bf16) { return __float2bfloat16(0.f); }

// Rows [0, ROWS) of the (., d) matrix at src into dst (row stride STRIDE,
// columns [0, DP)), zero where r >= avail or c >= d. vec: 16-byte cp.async
// (rows 16-byte aligned); else element loads.
template <typename T, int ROWS, int DP, int STRIDE>
__device__ __forceinline__ void stage(T* dst, const T* src, int64_t avail,
                                      int d, bool vec) {
  if (vec) {
    constexpr int EPC = 16 / static_cast<int>(sizeof(T));
    constexpr int CPR = DP / EPC;
    static_assert(ROWS * CPR % THREADS == 0, "whole chunks per thread");
#pragma unroll
    for (int it = 0; it < ROWS * CPR / THREADS; ++it) {
      const int e = threadIdx.x + it * THREADS;
      const int r = e / CPR, c = (e % CPR) * EPC;
      const bool in = r < avail && c < d;
      cp_async16(dst + r * STRIDE + c,
                 in ? src + static_cast<int64_t>(r) * d + c : src,
                 in ? 16 : 0);
    }
  } else {
    for (int e = threadIdx.x; e < ROWS * DP; e += THREADS) {
      const int r = e / DP, c = e % DP;
      dst[r * STRIDE + c] = (r < avail && c < d)
          ? src[static_cast<int64_t>(r) * d + c] : zero_of(T());
    }
  }
}

// ---------------------------------------------------------- bf16 products
template <int DP>
struct Bf16Math {
  using G = Geom<bf16, DP>;
  static constexpr int MT = G::MT;
  static constexpr int KQ = DP / 16;     // k16 steps over D
  static constexpr int NT = G::BK / 8;   // n8 tiles of scores
  struct QFrag {
    uint32_t a[G::Q_REGS ? KQ : 1][MT][4];
  };

  // ldmatrix.x4 of rows r0 .. r0 + 15, columns 16 kk .. 16 kk + 15: the
  // four 8 x 8 matrices are A's registers 0..3
  static __device__ __forceinline__ void q_frag(uint32_t (&a)[4],
                                                const bf16* qs, int r0,
                                                int lane, int kk) {
    ldsm_x4(a, qs + (r0 + (lane & 7) + ((lane >> 3) & 1) * 8) * G::QS
                   + 16 * kk + (lane >> 4) * 8);
  }

  static __device__ __forceinline__ void load_q(QFrag& f, const bf16* qs,
                                                int w, int lane) {
    if constexpr (G::Q_REGS) {
#pragma unroll
      for (int kk = 0; kk < KQ; ++kk) {
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          q_frag(f.a[kk][mt], qs, 16 * (MT * w + mt), lane, kk);
        }
      }
    }
  }

  // s = q k^T (unscaled) for the warp's rows and the tile's keys; each K
  // fragment serves the warp's MT row tiles
  static __device__ __forceinline__ void qk(float (&s)[MT][NT][4],
                                            const QFrag& f, const bf16* qs,
                                            const bf16* ks, int w, int lane) {
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        s[mt][j][0] = s[mt][j][1] = s[mt][j][2] = s[mt][j][3] = 0.f;
      }
    }
#pragma unroll
    for (int kk = 0; kk < KQ; ++kk) {
      uint32_t a[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        if constexpr (G::Q_REGS) {
#pragma unroll
          for (int i = 0; i < 4; ++i) a[mt][i] = f.a[kk][mt][i];
        } else {
          q_frag(a[mt], qs, 16 * (MT * w + mt), lane, kk);
        }
      }
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        // keys 16 np .. +15 by d 16 kk .. +15: B fragments of n-tiles
        // 2 np (registers 0, 1) and 2 np + 1 (registers 2, 3)
        uint32_t b[4];
        ldsm_x4(b, ks + (16 * np + (lane & 7) + (lane >> 4) * 8) * G::KS
                       + 16 * kk + ((lane >> 3) & 1) * 8);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          mma_bf16(s[mt][2 * np], a[mt], b[0], b[1]);
          mma_bf16(s[mt][2 * np + 1], a[mt], b[2], b[3]);
        }
      }
    }
  }

  // o += p v with p = hi + lo, both bf16; p is in the score layout. Each V
  // fragment serves MT row tiles times hi and lo.
  static __device__ __forceinline__ void pv(float (&o)[MT][DP / 8][4],
                                            const float (&p)[MT][NT][4],
                                            const bf16* vs, int lane) {
#pragma unroll
    for (int kk = 0; kk < NT / 2; ++kk) {
      // the accumulators of n-tiles 2 kk, 2 kk + 1 are the A fragment of
      // keys 16 kk .. 16 kk + 15
      uint32_t hi[MT][4], lo[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const float (&p0)[4] = p[mt][2 * kk];
        const float (&p1)[4] = p[mt][2 * kk + 1];
        split_bf16(p0[0], p0[1], hi[mt][0], lo[mt][0]);
        split_bf16(p0[2], p0[3], hi[mt][1], lo[mt][1]);
        split_bf16(p1[0], p1[1], hi[mt][2], lo[mt][2]);
        split_bf16(p1[2], p1[3], hi[mt][3], lo[mt][3]);
      }
#pragma unroll
      for (int dp = 0; dp < DP / 16; ++dp) {
        // keys 16 kk .. +15 by d 16 dp .. +15, transposed: B fragments of
        // d-tiles 2 dp (registers 0, 1) and 2 dp + 1 (registers 2, 3)
        uint32_t b[4];
        ldsm_x4_t(b, vs + (16 * kk + (lane & 7) + ((lane >> 3) & 1) * 8)
                         * G::VS + 16 * dp + (lane >> 4) * 8);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          mma_bf16(o[mt][2 * dp], hi[mt], b[0], b[1]);
          mma_bf16(o[mt][2 * dp + 1], hi[mt], b[2], b[3]);
          mma_bf16(o[mt][2 * dp], lo[mt], b[0], b[1]);
          mma_bf16(o[mt][2 * dp + 1], lo[mt], b[2], b[3]);
        }
      }
    }
  }
};

// ----------------------------------------------------- f32 (3xTF32) products
template <int DP>
struct Tf32Math {
  using G = Geom<float, DP>;
  static constexpr int MT = G::MT;
  static constexpr int KQ = DP / 8;      // k8 steps over D
  static constexpr int NT = G::BK / 8;
  struct QFrag {
    uint32_t big[G::Q_REGS ? KQ : 1][MT][4];
    uint32_t small[G::Q_REGS ? KQ : 1][MT][4];
  };

  // A fragment of rows r0 .. r0 + 15, d 8 kk .. 8 kk + 7 with its k index
  // permuted (t <-> d 2t, t + 4 <-> d 2t + 1), so that a thread's two
  // columns are adjacent
  static __device__ __forceinline__ void q_frag(uint32_t (&big)[4],
                                                uint32_t (&small)[4],
                                                const float* qs, int r0,
                                                int lane, int kk) {
    const int g = lane >> 2, t = lane & 3;
    const float* r = qs + (r0 + g) * G::QS + 8 * kk + 2 * t;
    const float2 top = *reinterpret_cast<const float2*>(r);
    const float2 bot = *reinterpret_cast<const float2*>(r + 8 * G::QS);
    split_tf32(top.x, big[0], small[0]);
    split_tf32(bot.x, big[1], small[1]);
    split_tf32(top.y, big[2], small[2]);
    split_tf32(bot.y, big[3], small[3]);
  }

  static __device__ __forceinline__ void load_q(QFrag& f, const float* qs,
                                                int w, int lane) {
    if constexpr (G::Q_REGS) {
#pragma unroll
      for (int kk = 0; kk < KQ; ++kk) {
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          q_frag(f.big[kk][mt], f.small[kk][mt], qs, 16 * (MT * w + mt),
                 lane, kk);
        }
      }
    }
  }

  static __device__ __forceinline__ void qk(float (&s)[MT][NT][4],
                                            const QFrag& f, const float* qs,
                                            const float* ks, int w,
                                            int lane) {
    const int g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        s[mt][j][0] = s[mt][j][1] = s[mt][j][2] = s[mt][j][3] = 0.f;
      }
    }
#pragma unroll
    for (int kk = 0; kk < KQ; ++kk) {
      uint32_t ab[MT][4], as[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        if constexpr (G::Q_REGS) {
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            ab[mt][i] = f.big[kk][mt][i];
            as[mt][i] = f.small[kk][mt][i];
          }
        } else {
          q_frag(ab[mt], as[mt], qs, 16 * (MT * w + mt), lane, kk);
        }
      }
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        // key 8 j + g, d 8 kk + 2t and + 1: B's k indices t and t + 4
        const float2 kv = *reinterpret_cast<const float2*>(
            ks + (8 * j + g) * G::KS + 8 * kk + 2 * t);
        uint32_t bb0, bs0, bb1, bs1;
        split_tf32(kv.x, bb0, bs0);
        split_tf32(kv.y, bb1, bs1);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          mma_tf32(s[mt][j], as[mt], bb0, bb1);
          mma_tf32(s[mt][j], ab[mt], bs0, bs1);
          mma_tf32(s[mt][j], ab[mt], bb0, bb1);
        }
      }
    }
  }

  static __device__ __forceinline__ void pv(float (&o)[MT][DP / 8][4],
                                            const float (&p)[MT][NT][4],
                                            const float* vs, int lane) {
    const int g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      // keys 8 j .. 8 j + 7 with A's k index t <-> key 2t, t + 4 <-> key
      // 2t + 1: the score accumulator as it stands
      uint32_t ab[MT][4], as[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        split_tf32(p[mt][j][0], ab[mt][0], as[mt][0]);
        split_tf32(p[mt][j][2], ab[mt][1], as[mt][1]);
        split_tf32(p[mt][j][1], ab[mt][2], as[mt][2]);
        split_tf32(p[mt][j][3], ab[mt][3], as[mt][3]);
      }
      const float* v0 = vs + (8 * j + 2 * t) * G::VS + g;
#pragma unroll
      for (int n = 0; n < DP / 8; ++n) {
        uint32_t bb0, bs0, bb1, bs1;
        split_tf32(v0[8 * n], bb0, bs0);
        split_tf32(v0[G::VS + 8 * n], bb1, bs1);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          mma_tf32(o[mt][n], as[mt], bb0, bb1);
          mma_tf32(o[mt][n], ab[mt], bs0, bs1);
          mma_tf32(o[mt][n], ab[mt], bb0, bb1);
        }
      }
    }
  }
};

__device__ __forceinline__ void store2(float* p, float x, float y) {
  *reinterpret_cast<float2*>(p) = make_float2(x, y);
}
__device__ __forceinline__ void store2(bf16* p, float x, float y) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x, y);
}
__device__ __forceinline__ void store1(float* p, float x) { *p = x; }
__device__ __forceinline__ void store1(bf16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

template <typename T, int DP>
__global__ void __launch_bounds__(THREADS, 1)   // 1: registers for ILP
flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, T* __restrict__ o, int64_t sq,
             int64_t sk, int d, int nq, bool causal, bool vec,
             float scale_log2) {
  using G = Geom<T, DP>;
  using M = std::conditional_t<G::F32, Tf32Math<DP>, Bf16Math<DP>>;
  constexpr int BQ = G::BQ, BK = G::BK, MT = G::MT, NT = BK / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* const smem = reinterpret_cast<T*>(smem_raw);
  T* const ring = G::Q_REGS ? smem : smem + G::Q_ELEMS;
  T* const qs = G::Q_REGS ? smem + G::STAGE : smem;
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int64_t bh = blockIdx.x / nq;
  const int64_t q0 = static_cast<int64_t>(nq - 1 - blockIdx.x % nq) * BQ;
  const T* kb = k + bh * sk * d;
  const T* vb = v + bh * sk * d;
  const int64_t kv_end = (causal && q0 + BQ < sk) ? q0 + BQ : sk;
  const int tiles = static_cast<int>((kv_end + BK - 1) / BK);

  auto load_tile = [&](int i) {
    T* ks = ring + (i & 1) * G::STAGE;
    const int64_t k0 = static_cast<int64_t>(i) * BK;
    stage<T, BK, DP, G::KS>(ks, kb + k0 * d, sk - k0, d, vec);
    stage<T, BK, DP, G::VS>(ks + G::K_ELEMS, vb + k0 * d, sk - k0, d, vec);
    cp_async_commit();
  };

  stage<T, BQ, DP, G::QS>(qs, q + (bh * sq + q0) * d, sq - q0, d, vec);
  cp_async_commit();
  if (tiles > 0) load_tile(0);
  cp_async_wait_all();
  __syncthreads();
  typename M::QFrag qf;
  M::load_q(qf, qs, w, lane);

  float acc[MT][DP / 8][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int n = 0; n < DP / 8; ++n) {
      acc[mt][n][0] = acc[mt][n][1] = acc[mt][n][2] = acc[mt][n][3] = 0.f;
    }
  }
  // the warp's rows start at wrow; this thread's rows are wrow + 16 mt + g
  // (registers 0, 1) and + 8 (2, 3). m is kept in the log2 domain (scores
  // times scale_log2).
  const int64_t wrow = q0 + 16 * MT * w;
  float m[MT][2], l[MT][2];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    m[mt][0] = m[mt][1] = -INFINITY;
    l[mt][0] = l[mt][1] = 0.f;
  }

  for (int i = 0; i < tiles; ++i) {
    cp_async_wait_all();
    __syncthreads();          // tile i has landed; tile i - 1 is consumed
    if (i + 1 < tiles) load_tile(i + 1);
    const T* ks = ring + (i & 1) * G::STAGE;
    const T* vs = ks + G::K_ELEMS;
    const int64_t k0 = static_cast<int64_t>(i) * BK;

    float s[MT][NT][4];
    M::qk(s, qf, qs, ks, w, lane);
    if (k0 + BK > sk || (causal && k0 + BK - 1 > wrow)) {
      // explicit column mask: keys past Sk never score, causal or not
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
        for (int j = 0; j < NT; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int64_t col = k0 + 8 * j + 2 * t + (e & 1);
            const int64_t row = wrow + 16 * mt + g + 8 * (e >> 1);
            if (col >= sk || (causal && col > row)) s[mt][j][e] = -INFINITY;
          }
        }
      }
    }

#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        mx[0] = fmaxf(mx[0], fmaxf(s[mt][j][0], s[mt][j][1]));
        mx[1] = fmaxf(mx[1], fmaxf(s[mt][j][2], s[mt][j][3]));
      }
      float neg[2], alpha[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(FULL, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(FULL, mx[r], 2));
        const float m_new = fmaxf(m[mt][r], __fmul_rn(mx[r], scale_log2));
        const float safe = m_new == -INFINITY ? 0.f : m_new;
        alpha[r] = exp2_approx(__fsub_rn(m[mt][r], safe));
        m[mt][r] = m_new;
        neg[r] = -safe;
      }
      float rs[2] = {0.f, 0.f};
#pragma unroll
      for (int j = 0; j < NT; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[mt][j][e] =
              exp2_approx(__fmaf_rn(s[mt][j][e], scale_log2, neg[e >> 1]));
          rs[e >> 1] = __fadd_rn(rs[e >> 1], s[mt][j][e]);
        }
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        l[mt][r] = __fmaf_rn(l[mt][r], alpha[r], rs[r]);
      }
#pragma unroll
      for (int n = 0; n < DP / 8; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          acc[mt][n][e] = __fmul_rn(acc[mt][n][e], alpha[e >> 1]);
        }
      }
    }
    M::pv(acc, s, vs, lane);
  }

#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float lr = l[mt][r];
      lr = __fadd_rn(lr, __shfl_xor_sync(FULL, lr, 1));
      lr = __fadd_rn(lr, __shfl_xor_sync(FULL, lr, 2));
      const int64_t row = wrow + 16 * mt + g + 8 * r;
      if (row >= sq) continue;
      T* orow = o + (bh * sq + row) * d;
#pragma unroll
      for (int n = 0; n < DP / 8; ++n) {
        const int col = 8 * n + 2 * t;
        const float x = lr == 0.f ? 0.f : __fdiv_rn(acc[mt][n][2 * r], lr);
        const float y =
            lr == 0.f ? 0.f : __fdiv_rn(acc[mt][n][2 * r + 1], lr);
        if (vec && col < d) {
          store2(orow + col, x, y);       // d is a multiple of 4
        } else {
          if (col < d) store1(orow + col, x);
          if (col + 1 < d) store1(orow + col + 1, y);
        }
      }
    }
  }
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

template <typename T, int DP>
int launch(const void* q, const void* k, const void* v, void* o, int64_t bh,
           int64_t sq, int64_t sk, int d, bool causal, cudaStream_t stream) {
  using G = Geom<T, DP>;
  const int nq = static_cast<int>((sq + G::BQ - 1) / G::BQ);
  const size_t smem = sizeof(T) * G::ELEMS;
  const cudaError_t attr = cudaFuncSetAttribute(
      flash_kernel<T, DP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const bool vec = (d * sizeof(T)) % 16 == 0 && aligned16(q)
      && aligned16(k) && aligned16(v) && aligned16(o);
  const float scale_log2 =
      static_cast<float>(1.4426950408889634 / sqrt(static_cast<double>(d)));
  flash_kernel<T, DP><<<static_cast<unsigned>(bh * nq), THREADS, smem,
                        stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), sq, sk, d, nq, causal,
      vec, scale_log2);
  return repro_launch_status();
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* o, int64_t bh,
             int64_t sq, int64_t sk, int d, bool causal, cudaStream_t st) {
  if (d <= 32) return launch<T, 32>(q, k, v, o, bh, sq, sk, d, causal, st);
  if (d <= 64) return launch<T, 64>(q, k, v, o, bh, sq, sk, d, causal, st);
  if (d <= 128) return launch<T, 128>(q, k, v, o, bh, sq, sk, d, causal, st);
  return launch<T, 256>(q, k, v, o, bh, sq, sk, d, causal, st);
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
  if (bh * ((sq + MIN_BQ - 1) / MIN_BQ) > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto st = static_cast<cudaStream_t>(stream);
  return bf16 ? dispatch<__nv_bfloat16>(q, k, v, o, bh, sq, sk, d,
                                        causal != 0, st)
              : dispatch<float>(q, k, v, o, bh, sq, sk, d, causal != 0, st);
}
