// Flash forward tiles on Hopper's tensor cores by mma.sync, shared by K2
// (flash_packed.cu, f32 and bf16) and K6 (flash_2seg.cu, f32): the online
// softmax in f32, two policies for the products. K8 (flash_heads.cu) runs
// the F32 policy's arithmetic (split, mma3, the chains below) on its own
// heads-major tiles.
//
// F32, split-TF32 products. Every f32 operand x is split into a TF32 big
// part, x rounded to nearest (cvt.rna's rounding; truncating would lose the
// accuracy the split exists for), and the residual small = x - big (see
// split below), and each product a.b is summed as a_small.b_big +
// a_big.b_small + a_big.b_big by mma.sync.m16n8k8 TF32 with an f32
// accumulator (small.small, ~2^-22 relative, is dropped). One TF32 product
// alone keeps ~2^-11 and misses the parity tolerance, even for P.V with P
// in [0, 1].
//
// BF16: Q, K and V are exact in bf16, so S = Q K^T is one m16n8k16 bf16
// product per k-step; P (f32) is split into a bf16 big part and its bf16
// residual (P to ~2^-16) and P.V is two products, so the output is as
// accurate as f32 arithmetic on the bf16 inputs.
//
// Accumulation. The tensor core rounds each mma's sum toward zero, a bias
// that grows with the length of a chain of mmas into one accumulator. So no
// chain is long: a TF32 score tile sums at most KG = 4 k-steps (32
// channels) into a fresh accumulator before an f32 add joins it to the
// rest (a bf16 one at most 8 k-steps of 16), and each kv tile's P.V goes
// into a fresh accumulator that one FFMA (round to nearest) joins to the
// output with the softmax rescale, o = o * alpha + tile. (On a CPU model of
// the mma with that rounding, one accumulator chained over a 16384-key walk
// gives 6e-6 of output error, these chains 7e-8;
// tests/test_torch_flash_tf32.py.)
//
// Tiles. A CTA of 4 warps owns BQ = 64 query rows, 16 per warp (one m16
// row-block); the kv walk goes in tiles of BKV rows, K, V and the bias row
// double-buffered in shared memory by cp.async (16 bytes a thread; rows past
// the segment are zero-filled), so tile j + 1 loads while tile j computes.
// S (BKV / 8 n-tiles x 4 floats), m, l and the output (Dv / 8 n-tiles x 4
// floats) stay in registers. Two CTAs share an SM at every head dim, which
// the measurements chose (tools/flash_tf32_variants.py):
// - F32 up to D = 64: BKV = 64, and Q is split once, when the block stages
//   it, its big and small planes kept in shared memory (109,056 bytes);
// - F32 at D = 128: both planes and 64-row tiles (207,360 bytes) leave one
//   CTA an SM, 4 warps to hide the latency of dependent mma chains; BKV =
//   32 with Q kept in f32 and split at each fragment load (103,680 bytes)
//   fits two, and runs the image classifier's self-attention 1.7x faster;
// - BF16: BKV = 64, Q in one plane (90,624 bytes at D = 128).
//
// Fragments (lane = 4g + t). TF32 m16n8k8: A holds (row, k) = (g, t),
// (g + 8, t), (g, t + 4), (g + 8, t + 4); B holds (k, n) = (t, g),
// (t + 4, g); C holds (g, 2t), (g, 2t + 1), (g + 8, 2t), (g + 8, 2t + 1).
// The k order of a product does not change its sum, so the TF32 products
// map mma index t to column 2t and t + 4 to column 2t + 1. Then P needs no
// relayout (S's C fragment of kv columns 8kk .. 8kk + 7 is, element for
// element, P.V's A fragment of k-step kk), Q and K fragments are float2
// loads (columns 2t, 2t + 1), and V's are rows 2t, 2t + 1 at column g.
// BF16 m16n8k16 holds pairs: A (g, 2t..2t+1), (g + 8, ..), (g, 2t+8..2t+9),
// (g + 8, ..); B (2t..2t+1, g), (2t+8..2t+9, g); its products map the pair
// at 2t to columns 4t, 4t + 1 and the pair at 2t + 8 to 4t + 2, 4t + 3, so
// a Q or K fragment is one 8-byte load; P's pairs are S's C fragments of
// n-tiles 2kk and 2kk + 1 as they stand; V's B fragments come transposed
// by ldmatrix.x4.trans, two n-tiles a load.
//
// Bank arithmetic (32 banks of 4 bytes; a 64-bit load is served a
// half-warp at a time, lanes 0-15 with g = 0..3). F32: lanes read words
// g * LD + 2t, +1, so a row pitch LD = 8 mod 32 (LDQ = LDK = DMAX + 8) puts
// them on banks 8g + 2t + {0, 1}, all distinct; V's scalar loads read word
// (2t + e) * LDV + g, and LDV = 4 mod 32 (DMAX + 4) gives banks
// 8t + 4e + g, the 32 lanes on 32 banks. BF16: lanes read words
// g * LD / 2 + 2t, +1, and LD / 2 = 8 or 24 mod 32 (LDQ = LDK = DMAX + 16)
// keeps them distinct; ldmatrix reads eight 16-byte rows a matrix, and a
// V pitch of DMAX + 8 elements, an odd number of 16-byte units, spreads
// them over all banks.
//
// Masking. Key j of a tile is visible to query row i iff j < n (the
// segment's length) and j <= i + off (off: the causal offset, or NO_LIMIT).
// A warp whose 16 rows see the whole tile skips the mask arithmetic; only
// the last tile or two of a causal walk pay for it.
#pragma once

#include <stdint.h>

#include "common.cuh"

namespace pio {
namespace mma {

constexpr int BQ = 64;         // query rows per CTA
constexpr int NT = 128;        // 4 warps
constexpr int KG = 4;          // TF32 k-steps summed in one fresh score accumulator
constexpr int NO_LIMIT = 1 << 30;
constexpr int SMEM_PER_SM = 233472;  // 228 KB, of which 1 KB is reserved per CTA

// big: cvt.rna.tf32.f32's rounding (to nearest, ties away from zero, 10
// stored mantissa bits) in two integer operations, add half of the 13
// dropped bits' unit and clear them; exact for every finite x and +-inf.
// (PTX's cvt.rna.tf32.f32 compiles on sm_90a to a longer sequence with NaN
// and infinity checks.) small: the exact residual x - big, whose low 13
// bits the tensor core ignores. So x = big + small to 2^-21 |x|: one bit
// short of rounding small too, which costs 15-20% of the kernel's time and
// changes none of its measured errors. A NaN x stays NaN in small.
__device__ __forceinline__ void split(float x, uint32_t& big, uint32_t& small) {
  big = (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
  small = __float_as_uint(x - __uint_as_float(big));
}

// d += a b, one m16n8k8 TF32 product with an f32 accumulator
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a b at f32 accuracy for b already split (bb big, bs small): the two
// small cross terms, then big x big
__device__ __forceinline__ void mma3_split(float (&d)[4], const uint32_t (&ab)[4], const uint32_t (&as)[4],
                                           uint32_t bb0, uint32_t bb1, uint32_t bs0, uint32_t bs1) {
  mma_tf32(d, as, bb0, bb1);
  mma_tf32(d, ab, bs0, bs1);
  mma_tf32(d, ab, bb0, bb1);
}

// d += a b at f32 accuracy
__device__ __forceinline__ void mma3(float (&d)[4], const uint32_t (&ab)[4], const uint32_t (&as)[4], float b0,
                                     float b1) {
  uint32_t bb0, bs0, bb1, bs1;
  split(b0, bb0, bs0);
  split(b1, bb1, bs1);
  mma3_split(d, ab, as, bb0, bb1, bs0, bs1);
}

// d += a b, one m16n8k16 bf16 product with an f32 accumulator
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// (x0, x1) as bf16 pairs: big rounded to nearest, small the rounded residual
__device__ __forceinline__ void split_bf16(float x0, float x1, uint32_t& big, uint32_t& small) {
  const __nv_bfloat162 b = __floats2bfloat162_rn(x0, x1);
  const float2 bf = __bfloat1622float2(b);
  const __nv_bfloat162 s = __floats2bfloat162_rn(x0 - bf.x, x1 - bf.y);
  big = *reinterpret_cast<const uint32_t*>(&b);
  small = *reinterpret_cast<const uint32_t*>(&s);
}

// four 8x8 b16 matrices, transposed: lanes 8i..8i+7 address matrix i's rows
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* row) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(row));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(s), "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(s), "l"(src), "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;"); }

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N));
}

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// one kv tile of one segment: rows [j0, j0 + BKV) of k/v (head slices with
// row strides row_qk/row_v), the segment's n rows and bias row (or null),
// and the causal offset (or NO_LIMIT) of its visibility rule
template <typename T>
struct Tile {
  const T* k;
  const T* v;
  const float* bias;
  int j0, n, off;
};

// a lane's running state: rows g and g + 8 of its warp's 16
template <int DMAX>
struct State {
  float o[DMAX / 8][4];
  float m[2], l[2];

  __device__ __forceinline__ void init() {
#pragma unroll
    for (int n = 0; n < DMAX / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
    m[0] = m[1] = -CUDART_INF_F;
    l[0] = l[1] = 0.f;
  }
};

// ---------------------------------------------------------------------------
// F32: split-TF32 products
// ---------------------------------------------------------------------------

template <int DMAX_>
struct F32 {
  using T = float;
  static constexpr int DMAX = DMAX_;
  // kv rows per tile, and the Q planes kept: 2 (big and small, split once)
  // or 1 (f32, split at each fragment load)
  static constexpr int BKV = DMAX <= 64 ? 64 : 32;
  static constexpr int QP = DMAX <= 64 ? 2 : 1;
  static constexpr int LDQ = DMAX + 8;
  static constexpr int LDK = DMAX + 8;
  static constexpr int LDV = DMAX + 4;
  static constexpr int Q = BQ * LDQ;   // one plane, in elements
  static constexpr int K = BKV * LDK;  // one buffer
  static constexpr int V = BKV * LDV;
  static constexpr int NS = BKV / 8;   // score n-tiles, P.V k-steps
  static constexpr size_t BYTES = (QP * Q + 2 * K + 2 * V) * sizeof(T) + 2 * BKV * sizeof(float);
  static constexpr int MIN_BLOCKS = 2 * (BYTES + 1024) <= SMEM_PER_SM ? 2 : 1;

  // the block's 64 query rows (rows past nq zero): split into the big and
  // small planes, or as f32 in one
  __device__ static void stage_q(T* sq, const T* qh, long row_qk, int q0, int nq, int dqk) {
    const int per_row = dqk / 4;
    for (int idx = threadIdx.x; idx < BQ * per_row; idx += NT) {
      const int r = idx / per_row, c = 4 * (idx - r * per_row);
      float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
      if (q0 + r < nq) x = *reinterpret_cast<const float4*>(qh + (long)(q0 + r) * row_qk + c);
      if (QP == 1) {
        *reinterpret_cast<float4*>(sq + r * LDQ + c) = x;
        continue;
      }
      uint4 b, s;
      split(x.x, b.x, s.x);
      split(x.y, b.y, s.y);
      split(x.z, b.z, s.z);
      split(x.w, b.w, s.w);
      *reinterpret_cast<uint4*>(sq + r * LDQ + c) = b;
      *reinterpret_cast<uint4*>(sq + Q + r * LDQ + c) = s;
    }
  }

  __device__ static void clear_pad(T*, int) {}

  // s = Q K^T for this warp's rows, NS n-tiles of 8 keys, KG k-steps per
  // fresh accumulator
  __device__ static void scores(float (&s)[NS][4], const T* sq, const T* sk, int dqk) {
    const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3, w = threadIdx.x >> 5;
    const float* qb = sq + (16 * w + g) * LDQ + 2 * t;
    const float* kr = sk + g * LDK + 2 * t;
#pragma unroll
    for (int kg = 0; kg < DMAX / 8; kg += KG) {
      if (8 * kg < dqk) {
        float acc[NS][4];
#pragma unroll
        for (int n = 0; n < NS; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
#pragma unroll
        for (int kk = kg; kk < kg + KG; ++kk) {
          if (8 * kk < dqk) {
            // Q's A fragment: rows g, g + 8; columns 2t, 2t + 1 of the k-step
            const float2 x0 = *reinterpret_cast<const float2*>(qb + 8 * kk);
            const float2 x1 = *reinterpret_cast<const float2*>(qb + 8 * LDQ + 8 * kk);
            uint32_t ab[4], as[4];
            if (QP == 2) {
              const float2 y0 = *reinterpret_cast<const float2*>(qb + Q + 8 * kk);
              const float2 y1 = *reinterpret_cast<const float2*>(qb + Q + 8 * LDQ + 8 * kk);
              ab[0] = __float_as_uint(x0.x), ab[1] = __float_as_uint(x1.x);
              ab[2] = __float_as_uint(x0.y), ab[3] = __float_as_uint(x1.y);
              as[0] = __float_as_uint(y0.x), as[1] = __float_as_uint(y1.x);
              as[2] = __float_as_uint(y0.y), as[3] = __float_as_uint(y1.y);
            } else {
              split(x0.x, ab[0], as[0]);
              split(x1.x, ab[1], as[1]);
              split(x0.y, ab[2], as[2]);
              split(x1.y, ab[3], as[3]);
            }
#pragma unroll
            for (int n = 0; n < NS; ++n) {
              const float2 kv = *reinterpret_cast<const float2*>(kr + 8 * n * LDK + 8 * kk);
              mma3(acc[n], ab, as, kv.x, kv.y);
            }
          }
        }
#pragma unroll
        for (int n = 0; n < NS; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[n][e] = kg == 0 ? acc[n][e] : s[n][e] + acc[n][e];
      }
    }
  }

  // o = o * alpha + P V, NG output n-tiles at a time in fresh accumulators
  __device__ static void pv(float (&o)[DMAX / 8][4], const float (&p)[NS][4], const float (&alpha)[2],
                            const T* sv, int dv) {
    constexpr int NG = DMAX / 8 < 8 ? DMAX / 8 : 8;
    const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
    // P's A fragments, k-step n: (g, 2t), (g + 8, 2t), (g, 2t + 1), (g + 8, 2t + 1)
    uint32_t pb[NS][4], ps[NS][4];
#pragma unroll
    for (int n = 0; n < NS; ++n) {
      split(p[n][0], pb[n][0], ps[n][0]);
      split(p[n][2], pb[n][1], ps[n][1]);
      split(p[n][1], pb[n][2], ps[n][2]);
      split(p[n][3], pb[n][3], ps[n][3]);
    }
    const float* vr = sv + 2 * t * LDV + g;
#pragma unroll
    for (int n0 = 0; n0 < DMAX / 8; n0 += NG) {
      if (8 * n0 < dv) {
        float acc[NG][4];
#pragma unroll
        for (int n = 0; n < NG; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
#pragma unroll
        for (int kk = 0; kk < NS; ++kk)
#pragma unroll
          for (int n = 0; n < NG; ++n)
            if (8 * (n0 + n) < dv) {
              const float* vp = vr + 8 * kk * LDV + 8 * (n0 + n);
              mma3(acc[n], pb[kk], ps[kk], vp[0], vp[LDV]);
            }
#pragma unroll
        for (int n = 0; n < NG; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) o[n0 + n][e] = fmaf(o[n0 + n][e], alpha[e >> 1], acc[n][e]);
      }
    }
  }
};

// ---------------------------------------------------------------------------
// BF16: bf16 products, P split into two bf16 parts
// ---------------------------------------------------------------------------

template <int DMAX_>
struct BF16 {
  using T = __nv_bfloat16;
  static constexpr int DMAX = DMAX_;
  static constexpr int BKV = 64;
  static constexpr int QP = 1;
  static constexpr int LDQ = DMAX + 16;
  static constexpr int LDK = DMAX + 16;
  static constexpr int LDV = DMAX + 8;
  static constexpr int Q = BQ * LDQ;
  static constexpr int K = BKV * LDK;
  static constexpr int V = BKV * LDV;
  static constexpr int NS = BKV / 8;
  static constexpr size_t BYTES = (Q + 2 * K + 2 * V) * sizeof(T) + 2 * BKV * sizeof(float);
  static constexpr int MIN_BLOCKS = 2;

  // the block's 64 query rows, columns up to a multiple of 16 (zeros past
  // dqk and past nq)
  __device__ static void stage_q(T* sq, const T* qh, long row_qk, int q0, int nq, int dqk) {
    const int per_row = (dqk + 15) / 16 * 2;  // 8-element chunks
    for (int idx = threadIdx.x; idx < BQ * per_row; idx += NT) {
      const int r = idx / per_row, c = 8 * (idx - r * per_row);
      uint4 x = make_uint4(0u, 0u, 0u, 0u);
      if (q0 + r < nq && c < dqk) x = *reinterpret_cast<const uint4*>(qh + (long)(q0 + r) * row_qk + c);
      *reinterpret_cast<uint4*>(sq + r * LDQ + c) = x;
    }
  }

  // zeros in both K buffers' columns [dqk, dqk rounded up to 16), which the
  // last k-step reads and cp.async never writes
  __device__ static void clear_pad(T* sk, int dqk) {
    if (dqk % 16 == 0) return;
    for (int r = threadIdx.x; r < 2 * BKV; r += NT)
      *reinterpret_cast<uint4*>(sk + r * LDK + dqk) = make_uint4(0u, 0u, 0u, 0u);
  }

  __device__ static void scores(float (&s)[NS][4], const T* sq, const T* sk, int dqk) {
    const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3, w = threadIdx.x >> 5;
    const T* qr = sq + (16 * w + g) * LDQ + 4 * t;
    const T* kr = sk + g * LDK + 4 * t;
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < DMAX / 16; ++kk) {
      if (16 * kk < dqk) {
        const uint2 x0 = *reinterpret_cast<const uint2*>(qr + 16 * kk);
        const uint2 x1 = *reinterpret_cast<const uint2*>(qr + 8 * LDQ + 16 * kk);
        const uint32_t a[4] = {x0.x, x1.x, x0.y, x1.y};
#pragma unroll
        for (int n = 0; n < NS; ++n) {
          const uint2 kv = *reinterpret_cast<const uint2*>(kr + 8 * n * LDK + 16 * kk);
          mma_bf16(s[n], a, kv.x, kv.y);
        }
      }
    }
  }

  __device__ static void pv(float (&o)[DMAX / 8][4], const float (&p)[NS][4], const float (&alpha)[2],
                            const T* sv, int dv) {
    constexpr int NG = DMAX / 8 < 8 ? DMAX / 8 : 8;
    const int lane = threadIdx.x & 31;
    // P's A fragments, k-step kk: n-tiles 2kk and 2kk + 1 of S, rows g and g + 8
    uint32_t pb[NS / 2][4], ps[NS / 2][4];
#pragma unroll
    for (int kk = 0; kk < NS / 2; ++kk) {
      split_bf16(p[2 * kk][0], p[2 * kk][1], pb[kk][0], ps[kk][0]);
      split_bf16(p[2 * kk][2], p[2 * kk][3], pb[kk][1], ps[kk][1]);
      split_bf16(p[2 * kk + 1][0], p[2 * kk + 1][1], pb[kk][2], ps[kk][2]);
      split_bf16(p[2 * kk + 1][2], p[2 * kk + 1][3], pb[kk][3], ps[kk][3]);
    }
    // ldmatrix rows: kv row (lane & 15) of the k-step, n-tile (lane >> 4) of a pair
    const T* vl = sv + (lane & 15) * LDV + 8 * (lane >> 4);
#pragma unroll
    for (int n0 = 0; n0 < DMAX / 8; n0 += NG) {
      if (8 * n0 < dv) {
        float acc[NG][4];
#pragma unroll
        for (int n = 0; n < NG; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
#pragma unroll
        for (int kk = 0; kk < NS / 2; ++kk)
#pragma unroll
          for (int n = 0; n < NG; n += 2)
            if (8 * (n0 + n) < dv) {
              uint32_t b[4];
              ldmatrix_x4_trans(b, vl + 16 * kk * LDV + 8 * (n0 + n));
              mma_bf16(acc[n], ps[kk], b[0], b[1]);
              mma_bf16(acc[n], pb[kk], b[0], b[1]);
              mma_bf16(acc[n + 1], ps[kk], b[2], b[3]);
              mma_bf16(acc[n + 1], pb[kk], b[2], b[3]);
            }
#pragma unroll
        for (int n = 0; n < NG; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) o[n0 + n][e] = fmaf(o[n0 + n][e], alpha[e >> 1], acc[n][e]);
      }
    }
  }
};

// ---------------------------------------------------------------------------
// the walk, shared by the policies
// ---------------------------------------------------------------------------

// starts the copies of one tile's K, V and bias (zeros past the segment,
// and for a null bias); the caller commits and waits
template <typename P>
__device__ __forceinline__ void stage_kv(typename P::T* sk, typename P::T* sv, float* sb,
                                         const Tile<typename P::T>& tl, long row_qk, long row_v, int dqk, int dv) {
  constexpr int CE = 16 / sizeof(typename P::T);  // elements a 16-byte copy moves
  const int kq = dqk / CE, vq = dv / CE;
  for (int idx = threadIdx.x; idx < P::BKV * kq; idx += NT) {
    const int r = idx / kq, c = CE * (idx - r * kq), j = tl.j0 + r;
    const bool ok = j < tl.n;
    cp_async16(sk + r * P::LDK + c, ok ? tl.k + (long)j * row_qk + c : tl.k, ok);
  }
  for (int idx = threadIdx.x; idx < P::BKV * vq; idx += NT) {
    const int r = idx / vq, c = CE * (idx - r * vq), j = tl.j0 + r;
    const bool ok = j < tl.n;
    cp_async16(sv + r * P::LDV + c, ok ? tl.v + (long)j * row_v + c : tl.v, ok);
  }
  if (threadIdx.x < P::BKV) {
    const int j = tl.j0 + threadIdx.x;
    const bool ok = tl.bias != nullptr && j < tl.n;
    cp_async4(sb + threadIdx.x, ok ? static_cast<const void*>(tl.bias + j) : tl.k, ok);
  }
}

// one kv tile for this warp's 16 rows: scores, the online softmax, o += P V.
// i0 is the lane's first row (q0 + 16 * warp + g) in the visibility rule's
// coordinates
template <typename P>
__device__ __forceinline__ void attend(State<P::DMAX>& st, const typename P::T* sq, const typename P::T* sk,
                                       const typename P::T* sv, const float* sb, const Tile<typename P::T>& tl,
                                       int i0, int dqk, int dv, float sm_scale) {
  constexpr int NS = P::NS;
  const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
  float s[NS][4];
  P::scores(s, sq, sk, dqk);

  // scale, bias, mask; the online softmax of rows g (e = 0, 1) and g + 8
  // (e = 2, 3), each row spread over the 4 lanes of its group
  const bool full = tl.j0 + P::BKV <= tl.n && tl.j0 + P::BKV - 1 <= i0 - g + tl.off;
  float mx[2] = {-CUDART_INF_F, -CUDART_INF_F};
#pragma unroll
  for (int n = 0; n < NS; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int c = 8 * n + 2 * t + (e & 1);
      float x = fmaf(s[n][e], sm_scale, sb[c]);
      if (!full) {
        const int j = tl.j0 + c;
        if (!(j < tl.n && j <= i0 + 8 * (e >> 1) + tl.off)) x = -CUDART_INF_F;
      }
      s[n][e] = x;
      mx[e >> 1] = fmaxf(mx[e >> 1], x);
    }
  float alpha[2], mu[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    const float m_new = fmaxf(st.m[r], mx[r]);
    // a row with nothing visible yet keeps p = 0 and alpha = 0 (no inf - inf)
    mu[r] = m_new == -CUDART_INF_F ? 0.f : m_new;
    alpha[r] = expf(st.m[r] - mu[r]);
    st.m[r] = m_new;
  }
  float psum[2] = {0.f, 0.f};
#pragma unroll
  for (int n = 0; n < NS; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      s[n][e] = expf(s[n][e] - mu[e >> 1]);
      psum[e >> 1] += s[n][e];
    }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    psum[r] += __shfl_xor_sync(0xffffffffu, psum[r], 1);
    psum[r] += __shfl_xor_sync(0xffffffffu, psum[r], 2);
    st.l[r] = st.l[r] * alpha[r] + psum[r];
  }
  P::pv(st.o, s, alpha, sv, dv);
}

// the kv walk over tiles [t_begin, t_end) of P::BKV rows: tile t + 1's
// copies fly while tile t computes. tile_of(t) names a tile; the shared
// memory holds the staged Q first, then the K, V and bias buffers
template <typename P, typename TileOf>
__device__ __forceinline__ void walk(State<P::DMAX>& st, typename P::T* smem, int t_begin, int t_end,
                                     TileOf tile_of, long row_qk, long row_v, int i0, int dqk, int dv,
                                     float sm_scale) {
  using T = typename P::T;
  T* kv = smem + P::QP * P::Q;  // buffer u: K at u * K, V at 2K + u * V, then the bias rows
  auto sk = [&](int u) { return kv + u * P::K; };
  auto sv = [&](int u) { return kv + 2 * P::K + u * P::V; };
  auto sb = [&](int u) { return reinterpret_cast<float*>(kv + 2 * P::K + 2 * P::V) + u * P::BKV; };
  P::clear_pad(kv, dqk);
  if (t_begin < t_end) {
    stage_kv<P>(sk(0), sv(0), sb(0), tile_of(t_begin), row_qk, row_v, dqk, dv);
    cp_commit();
  }
  for (int t = t_begin; t < t_end; ++t) {
    const int u = (t - t_begin) & 1;
    if (t + 1 < t_end) {
      stage_kv<P>(sk(u ^ 1), sv(u ^ 1), sb(u ^ 1), tile_of(t + 1), row_qk, row_v, dqk, dv);
      cp_commit();
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();  // tile t (and Q) are in shared memory for every warp
    attend<P>(st, smem, sk(u), sv(u), sb(u), tile_of(t), i0, dqk, dv, sm_scale);
    __syncthreads();  // every warp is done with buffer u before it is refilled
  }
}

// the normalized output (a pair per n-tile) and logsumexp of the lane's two
// rows i0, i0 + 8 (rows at or past nq are not written); o_row(i) and
// lse_at(i) give a row's output pointer and its logsumexp slot
template <int DMAX, typename ORow, typename LseAt>
__device__ __forceinline__ void store(const State<DMAX>& st, int i0, int nq, int dv, ORow o_row, LseAt lse_at) {
  const int t = threadIdx.x & 3;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int i = i0 + 8 * r;
    if (i >= nq) continue;
    const float inv = st.l[r] == 0.f ? 1.f : 1.f / st.l[r];
    auto* orow = o_row(i);
#pragma unroll
    for (int n = 0; n < DMAX / 8; ++n)
      if (8 * n < dv) store2(orow + 8 * n + 2 * t, st.o[n][2 * r] * inv, st.o[n][2 * r + 1] * inv);
    if (t == 0) *lse_at(i) = st.m[r] + logf(st.l[r] == 0.f ? 1.f : st.l[r]);
  }
}

// the unnormalized f32 partial of a split walk: o_row(i) gets acc, ml(i)
// the (m, l) pair
template <int DMAX, typename ORow, typename MlAt>
__device__ __forceinline__ void store_partial(const State<DMAX>& st, int i0, int nq, int dv, ORow o_row, MlAt ml) {
  const int t = threadIdx.x & 3;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int i = i0 + 8 * r;
    if (i >= nq) continue;
    float* orow = o_row(i);
#pragma unroll
    for (int n = 0; n < DMAX / 8; ++n)
      if (8 * n < dv) store2(orow + 8 * n + 2 * t, st.o[n][2 * r], st.o[n][2 * r + 1]);
    if (t == 0) {
      float* p = ml(i);
      p[0] = st.m[r];
      p[1] = st.l[r];
    }
  }
}

}  // namespace mma
}  // namespace pio
