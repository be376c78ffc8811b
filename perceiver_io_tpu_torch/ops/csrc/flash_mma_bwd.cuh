// Flash backward tiles on Hopper's tensor cores by mma.sync, for K4a / K4b
// (flash_packed_bwd.cu), on the fragment layouts of flash_mma.cuh (the
// m16n8k8 A, B and C fragments; mma index t mapped to columns 2t and
// 2t + 1), which this header only adds to.
//
// Three products, all on the tensor cores by mma.sync:
// - prod_abt64: C = A B^T in f64 (m16n8k4, whose products of f32 inputs
//   are exact and whose sums are f64). A is the warp's 16 rows of an
//   operand the CTA keeps for its whole walk, B the rows of a walked tile:
//   the score products S = Q K^T and dP = dO V^T in K4b, S^T = K Q^T and
//   dP^T = V dO^T in K4a. The gradients are sensitive to them: dS =
//   p (dP - delta) amplifies an error in dP by p and one in S by
//   |dP - delta| (up to ~30 at the latent self-attention); with split-TF32
//   scores dQ came within 1% of the 1e-5 tolerance at |dQ| ~ 12;
// - prod_ab64: O += P B in f64, P a product's C fragments, B the same
//   walked tile read down its rows: K4b's dQ += dS K, summed in f64 over
//   the whole walk and rounded to f32 once. On an H100 80GB HBM3 it ran
//   6-9% faster than the split-TF32 form at the CLM's cross-attention and
//   left half the error or less (PERF.md, PR 6);
// - prod_ab: O += P B split-TF32, for K4a's dV += P^T dO and dK += dS^T Q,
//   whose two f64 accumulators would not fit a thread's registers at
//   D = 128 (2 x 16 n-tiles x 4 doubles = 256 registers). Each f32 operand
//   x is split into a TF32 big part (rounded to nearest) and the residual,
//   and a b is summed as a_small b_big + a_big b_small + a_big b_big by
//   m16n8k8 TF32 with an f32 accumulator (flash_mma.cuh's split and mma3).
//   The tensor core truncates each TF32 mma's sum toward zero at the
//   magnitude of the accumulator it adds into, so each walked tile's
//   product (8 or 4 k-steps) goes into a fresh accumulator that an f32 add
//   (rounded to nearest) joins to the gradient. Chained over a whole walk
//   instead, the CPU model of tests/test_torch_flash_tf32.py misses the
//   1e-5 tolerance.
// As in K2's P.V, the C fragment of columns 8kk .. 8kk + 7 is, element for
// element, the A fragment of k-step kk of the product that follows it: no
// shuffle, no trip through shared memory.
//
// Two access patterns on one tile. prod_abt64 reads B rows 8n + g at
// columns 8kk + 2t, +1 (a float2 a lane); prod_ab and prod_ab64 read rows
// 8kk + 2t + e at column 8n + g (a float a lane, e = 0, 1 in two loads). A
// padded pitch serves one of them: 8 mod 32 words (K2's K) puts the float2 loads on 32 distinct banks
// but the scalar loads of rows 2t and 2t + 4 on one bank (2-way conflicts);
// 4 mod 32 (K2's V) the reverse. So the walked tiles are swizzled instead:
// pitch DMAX words (a multiple of 32), word c of row r stored at column
// c ^ 8 sw(r), sw(r) = (r + (r >> 2)) & 3. The XOR moves whole 8-word
// groups, so a 16-byte cp.async chunk and a float2 stay contiguous. Bank
// arithmetic (32 banks of 4 bytes; a 64-bit load is served a half-warp at a
// time):
// - float2 loads, half-warp g = 0..3 (or 4..7), t = 0..3: row 8n + g has
//   sw = (g + (g >> 2) + 2n) & 3, four distinct values over the half-warp,
//   and the words 8 (kk ^ sw) + 2t + {0, 1} fill 32 distinct banks;
// - scalar loads, fixed e: row 8kk + 2t + e has sw = (2t + e + [t >= 2] +
//   2kk) & 3, which takes the four values once each over t = 0..3, and the
//   words 8 (n ^ sw) + g (g = 0..7) fill 32 distinct banks.
// The CTA's own operands are read only by float2 loads of rows g and g + 8:
// K2's padded pitch DMAX + 8 keeps them conflict-free.
#pragma once

#include "flash_mma.cuh"

namespace pio {
namespace mma_bwd {

using mma::cp_async16;
using mma::mma3;
using mma::split;

// the word offset of column c of tile row r: c ^ 8 sw(r)
__device__ __forceinline__ int sw(int r) { return (r + (r >> 2)) & 3; }

// rows [r0, r0 + BR) of a head slice (row stride row_stride, d columns) into
// a swizzled tile of pitch DMAX by cp.async (rows at or past n zero-filled);
// the caller commits and waits
template <int DMAX, int BR, int NT>
__device__ __forceinline__ void stage_swizzled(float* dst, const float* src, long row_stride, int r0, int n,
                                               int d) {
  const int per = d / 4;
  for (int idx = threadIdx.x; idx < BR * per; idx += NT) {
    const int r = idx / per, c = 4 * (idx - r * per), gr = r0 + r;
    const bool ok = gr < n;
    cp_async16(dst + r * DMAX + (c ^ (8 * sw(r))), ok ? src + (long)gr * row_stride + c : src, ok);
  }
}

// rows [r0, r0 + BR) of a head slice into an f32 buffer of pitch LD (rows
// at or past n zero), by plain loads: the operand a CTA keeps
template <int LD, int BR, int NT>
__device__ __forceinline__ void stage_rows(float* dst, const float* src, long row_stride, int r0, int n, int d) {
  const int per = d / 4;
  for (int idx = threadIdx.x; idx < BR * per; idx += NT) {
    const int r = idx / per, c = 4 * (idx - r * per);
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r0 + r < n) x = *reinterpret_cast<const float4*>(src + (long)(r0 + r) * row_stride + c);
    *reinterpret_cast<float4*>(dst + r * LD + c) = x;
  }
}

// o += P B split-TF32: P the C fragments of NS n-tiles (the k-steps: rows of
// b), b a swizzled tile read down its rows, output n-tiles of 8 columns up
// to d; NG n-tiles at a time, each group's NS k-steps a fresh accumulator
// joined to o by an f32 add
template <int DMAX, int NS, int NG>
__device__ __forceinline__ void prod_ab(float (&o)[DMAX / 8][4], const float (&p)[NS][4], const float* b, int d) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  // P's A fragments, k-step kk: (g, 2t), (g + 8, 2t), (g, 2t + 1), (g + 8, 2t + 1)
  uint32_t pb[NS][4], ps[NS][4];
#pragma unroll
  for (int kk = 0; kk < NS; ++kk) {
    split(p[kk][0], pb[kk][0], ps[kk][0]);
    split(p[kk][2], pb[kk][1], ps[kk][1]);
    split(p[kk][1], pb[kk][2], ps[kk][2]);
    split(p[kk][3], pb[kk][3], ps[kk][3]);
  }
  // B rows 8kk + 2t + e at column 8n + g; sw of row 8kk + 2t + e is
  // (s_e + 2kk) & 3
  const float* br = b + 2 * t * DMAX + g;
  const int s_0 = (2 * t + ((2 * t) >> 2)) & 3, s_1 = (2 * t + 1 + ((2 * t + 1) >> 2)) & 3;
#pragma unroll
  for (int n0 = 0; n0 < DMAX / 8; n0 += NG) {
    if (8 * n0 < d) {
      float acc[NG][4];
#pragma unroll
      for (int n = 0; n < NG; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < NS; ++kk)
#pragma unroll
        for (int n = 0; n < NG; ++n)
          if (8 * (n0 + n) < d) {
            const float* row = br + 8 * kk * DMAX;
            mma3(acc[n], pb[kk], ps[kk], row[8 * ((n0 + n) ^ ((s_0 + 2 * kk) & 3))],
                 row[DMAX + 8 * ((n0 + n) ^ ((s_1 + 2 * kk) & 3))]);
          }
#pragma unroll
      for (int n = 0; n < NG; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) o[n0 + n][e] += acc[n][e];
    }
  }
}

// d += a b for 16 rows, one m16n8k4 f64 product (exact products, f64 sum):
// A (g, t), (g + 8, t); B (t, g); C (g, 2t..2t+1), (g + 8, 2t..2t+1)
__device__ __forceinline__ void dmma16(double (&d)[4], double a0, double a1, double b) {
  asm("mma.sync.aligned.m16n8k4.row.col.f64.f64.f64.f64 {%0, %1, %2, %3}, {%4, %5}, {%6}, {%0, %1, %2, %3};"
      : "+d"(d[0]), "+d"(d[1]), "+d"(d[2]), "+d"(d[3])
      : "d"(a0), "d"(a1), "d"(b));
}

// c = A B^T in f64 on the tensor cores for the warp's 16 rows: a points at
// the warp's first row of an f32 buffer of pitch LDA, b at a swizzled tile
// of NS * 8 rows; depth d (a multiple of 8). The 8 columns of a k-step are
// two k = 4 products, the first taking column 2t as its k index t, the
// second 2t + 1, so each lane's fragments are one float2 load of A's rows
// g, g + 8 and one of B's row 8n + g, and c has the m16n8 C layout
template <int DMAX, int LDA, int NS>
__device__ __forceinline__ void prod_abt64(double (&c)[NS][4], const float* a, const float* b, int d) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const float* ar = a + g * LDA + 2 * t;
  const float* br = b + g * DMAX + 2 * t;
  const int s0 = (g + (g >> 2)) & 3;
#pragma unroll
  for (int n = 0; n < NS; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) c[n][e] = 0.0;
#pragma unroll
  for (int kk = 0; kk < DMAX / 8; ++kk) {
    if (8 * kk < d) {
      const float2 x0 = *reinterpret_cast<const float2*>(ar + 8 * kk);
      const float2 x1 = *reinterpret_cast<const float2*>(ar + 8 * LDA + 8 * kk);
#pragma unroll
      for (int n = 0; n < NS; ++n) {
        const float2 y = *reinterpret_cast<const float2*>(br + 8 * n * DMAX + 8 * (kk ^ ((s0 + 2 * n) & 3)));
        dmma16(c[n], x0.x, x1.x, y.x);
        dmma16(c[n], x0.y, x1.y, y.y);
      }
    }
  }
}

// o += P B in f64 on the tensor cores, for the operands prod_ab takes (P's C
// fragments as the A fragments of two k = 4 products per k-step)
template <int DMAX, int NS>
__device__ __forceinline__ void prod_ab64(double (&o)[DMAX / 8][4], const float (&p)[NS][4], const float* b,
                                          int d) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const float* br = b + 2 * t * DMAX + g;
  const int s_0 = (2 * t + ((2 * t) >> 2)) & 3, s_1 = (2 * t + 1 + ((2 * t + 1) >> 2)) & 3;
#pragma unroll
  for (int kk = 0; kk < NS; ++kk) {
    const float* row = br + 8 * kk * DMAX;
#pragma unroll
    for (int n = 0; n < DMAX / 8; ++n)
      if (8 * n < d) {
        const double y0 = row[8 * (n ^ ((s_0 + 2 * kk) & 3))];
        const double y1 = row[DMAX + 8 * (n ^ ((s_1 + 2 * kk) & 3))];
        dmma16(o[n], p[kk][0], p[kk][2], y0);
        dmma16(o[n], p[kk][1], p[kk][3], y1);
      }
  }
}

// the lane's two rows r0 + g, r0 + g + 8 of a C-fragment accumulator (a
// pair per n-tile) to the rows of a head slice, up to row n and column d
template <int DMAX, typename Acc>
__device__ __forceinline__ void store_rows(float* dst, long row_stride, int r0, int n, int d,
                                           const Acc (&o)[DMAX / 8][4]) {
  const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r0 + g + 8 * r;
    if (row >= n) continue;
    float* out = dst + (long)row * row_stride + 2 * t;
#pragma unroll
    for (int m = 0; m < DMAX / 8; ++m)
      if (8 * m < d) mma::store2(out + 8 * m, (float)o[m][2 * r], (float)o[m][2 * r + 1]);
  }
}

}  // namespace mma_bwd
}  // namespace pio
