// Flash backward on Hopper's tensor cores by mma.sync: the tiles, and the
// kernel bodies of K4a / K4b (flash_packed_bwd.cu) and K7a / K7b
// (flash_2seg_bwd.cu), which walk one kv sequence given as segments (one
// right-aligned causal segment, or a prefix and the latents), on the
// fragment layouts of flash_mma.cuh (the m16n8k8 A, B and C fragments; mma
// index t mapped to columns 2t and 2t + 1), which this header only adds to.
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
//   magnitude of the accumulator it adds into, so every KJ = 2 k-steps of
//   a walked tile's product go into fresh accumulators that f32 adds
//   (rounded to nearest) join to the gradient. Chained over a whole walk
//   instead, the CPU model of tests/test_torch_flash_tf32.py misses the
//   1e-5 tolerance; one fresh accumulator a walked tile (8 or 4 k-steps)
//   left dK/dV up to 3.2e-6 from f64 at short walks on an H100, further
//   than the f32 plain version (2.6e-6), and two k-steps a third of that
//   (PERF.md). The two small cross terms and big x big sum in two
//   accumulators, joined by one f32 add (rounded to nearest) before the
//   gradient's, so no cross term is truncated at the magnitude of the big
//   products; two n-tiles at a time hold as many registers as four did with
//   one accumulator.
// As in K2's P.V, the C fragment of columns 8kk .. 8kk + 7 is, element for
// element, the A fragment of k-step kk of the product that follows it: no
// shuffle, no trip through shared memory.
//
// The f64 products take DK columns of depth an instruction: 4 (m16n8k4,
// two instructions a k-step of 8), 8 (m16n8k8) or 16 (m16n8k16, two
// k-steps; sm_90's larger f64 shapes, PTX ISA 7.8). The lanes' loads are
// the same in all three: column 2t of a k-step is mma index t and column
// 2t + 1 index t + 4 (and t + 8, t + 12 for the second k-step of k16), on A
// and B alike, so only the instruction count changes; the products are
// exact and the sums f64, so the gradients agree to rounding.
// Each kernel's DK, below the tiles, is the fastest that does not spill on
// an H100 (PERF.md).
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
using mma::mma_tf32;
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
// to d; NG n-tiles at a time, every KJ k-steps two fresh accumulators (the
// cross terms, big x big) whose f32 sum an f32 add joins to o
template <int DMAX, int NS, int NG, int KJ>
__device__ __forceinline__ void prod_ab(float (&o)[DMAX / 8][4], const float (&p)[NS][4], const float* b, int d) {
  static_assert(NS % KJ == 0, "KJ divides the k-steps");
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
#pragma unroll
      for (int k0 = 0; k0 < NS; k0 += KJ) {
        float big[NG][4], small[NG][4];
#pragma unroll
        for (int n = 0; n < NG; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) big[n][e] = small[n][e] = 0.f;
#pragma unroll
        for (int kk = k0; kk < k0 + KJ; ++kk)
#pragma unroll
          for (int n = 0; n < NG; ++n)
            if (8 * (n0 + n) < d) {
              const float* row = br + 8 * kk * DMAX;
              uint32_t bb0, bs0, bb1, bs1;
              split(row[8 * ((n0 + n) ^ ((s_0 + 2 * kk) & 3))], bb0, bs0);
              split(row[DMAX + 8 * ((n0 + n) ^ ((s_1 + 2 * kk) & 3))], bb1, bs1);
              mma_tf32(small[n], ps[kk], bb0, bb1);
              mma_tf32(small[n], pb[kk], bs0, bs1);
              mma_tf32(big[n], pb[kk], bb0, bb1);
            }
#pragma unroll
        for (int n = 0; n < NG; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) o[n0 + n][e] += big[n][e] + small[n][e];
      }
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

// d += a b, one m16n8k8 f64 product: A (g, t), (g + 8, t), (g, t + 4),
// (g + 8, t + 4); B (t, g), (t + 4, g); C as dmma16's
__device__ __forceinline__ void dmma_k8(double (&d)[4], double a0, double a1, double a2, double a3, double b0,
                                        double b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f64.f64.f64.f64 {%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};"
      : "+d"(d[0]), "+d"(d[1]), "+d"(d[2]), "+d"(d[3])
      : "d"(a0), "d"(a1), "d"(a2), "d"(a3), "d"(b0), "d"(b1));
}

// d += a b, one m16n8k16 f64 product: A (g + 8 (i & 1), t + 4 (i >> 1))
// for a[i]; B (t + 4 i, g) for b[i]; C as dmma16's
__device__ __forceinline__ void dmma_k16(double (&d)[4], const double (&a)[8], const double (&b)[4]) {
  asm("mma.sync.aligned.m16n8k16.row.col.f64.f64.f64.f64 {%0, %1, %2, %3}, {%4, %5, %6, %7, %8, %9, %10, %11}, "
      "{%12, %13, %14, %15}, {%0, %1, %2, %3};"
      : "+d"(d[0]), "+d"(d[1]), "+d"(d[2]), "+d"(d[3])
      : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(a[4]), "d"(a[5]), "d"(a[6]), "d"(a[7]), "d"(b[0]),
        "d"(b[1]), "d"(b[2]), "d"(b[3]));
}

// d += a b over one k-step of 8 columns (or two, with `two`): x0, x1 the
// lane's A values of rows g and g + 8 at columns 2t, 2t + 1 (x0b, x1b the
// second k-step's), y the B values of column g at rows 2t, 2t + 1 (yb the
// second's); DK (4, 8 or 16) picks the instructions
template <int DK>
__device__ __forceinline__ void dmma_steps(double (&d)[4], double2 x0, double2 x1, double2 y, bool two,
                                           double2 x0b, double2 x1b, double2 yb) {
  static_assert(DK == 4 || DK == 8 || DK == 16, "f64 mma.sync depths: 4, 8, 16");
  if constexpr (DK == 4) {
    dmma16(d, x0.x, x1.x, y.x);
    dmma16(d, x0.y, x1.y, y.y);
    if (two) {
      dmma16(d, x0b.x, x1b.x, yb.x);
      dmma16(d, x0b.y, x1b.y, yb.y);
    }
  } else {
    if constexpr (DK == 16) {
      if (two) {
        const double a[8] = {x0.x, x1.x, x0.y, x1.y, x0b.x, x1b.x, x0b.y, x1b.y};
        const double b[4] = {y.x, y.y, yb.x, yb.y};
        dmma_k16(d, a, b);
        return;
      }
    }
    dmma_k8(d, x0.x, x1.x, x0.y, x1.y, y.x, y.y);
    if (two) dmma_k8(d, x0b.x, x1b.x, x0b.y, x1b.y, yb.x, yb.y);
  }
}

// c = A B^T in f64 on the tensor cores for the warp's 16 rows: a points at
// the warp's first row of an f32 buffer of pitch LDA, b at a swizzled tile
// of NS * 8 rows; depth d (a multiple of 8). The 8 columns of a k-step are
// mma indices t (column 2t) and t + 4 (column 2t + 1), so each lane's
// fragments are one float2 load of A's rows g, g + 8 and one of B's row
// 8n + g, and c has the m16n8 C layout; DK columns an f64 mma
template <int DMAX, int LDA, int NS, int DK>
__device__ __forceinline__ void prod_abt64(double (&c)[NS][4], const float* a, const float* b, int d) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const float* ar = a + g * LDA + 2 * t;
  const float* br = b + g * DMAX + 2 * t;
  const int s0 = (g + (g >> 2)) & 3;
  constexpr int KS = DK == 16 ? 2 : 1;  // k-steps an iteration
#pragma unroll
  for (int n = 0; n < NS; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) c[n][e] = 0.0;
  auto ld = [](const float* p) {
    const float2 v = *reinterpret_cast<const float2*>(p);
    return make_double2(v.x, v.y);
  };
#pragma unroll
  for (int kk = 0; kk < DMAX / 8; kk += KS) {
    if (8 * kk < d) {
      const bool two = KS == 2 && 8 * (kk + 1) < d;
      const int k2 = KS == 2 ? kk + 1 : kk;
      const double2 x0 = ld(ar + 8 * kk), x1 = ld(ar + 8 * LDA + 8 * kk);
      const double2 x0b = two ? ld(ar + 8 * k2) : x0, x1b = two ? ld(ar + 8 * LDA + 8 * k2) : x1;
#pragma unroll
      for (int n = 0; n < NS; ++n) {
        const double2 y = ld(br + 8 * n * DMAX + 8 * (kk ^ ((s0 + 2 * n) & 3)));
        const double2 yb = two ? ld(br + 8 * n * DMAX + 8 * (k2 ^ ((s0 + 2 * n) & 3))) : y;
        dmma_steps<DK>(c[n], x0, x1, y, two, x0b, x1b, yb);
      }
    }
  }
}

// o += P B in f64 on the tensor cores, for the operands prod_ab takes (P's C
// fragments as the A fragments: column 2t of k-step kk is mma index t,
// column 2t + 1 index t + 4); DK columns an f64 mma
template <int DMAX, int NS, int DK>
__device__ __forceinline__ void prod_ab64(double (&o)[DMAX / 8][4], const float (&p)[NS][4], const float* b,
                                          int d) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const float* br = b + 2 * t * DMAX + g;
  const int s_0 = (2 * t + ((2 * t) >> 2)) & 3, s_1 = (2 * t + 1 + ((2 * t + 1) >> 2)) & 3;
  constexpr int KS = DK == 16 && NS % 2 == 0 ? 2 : 1;
#pragma unroll
  for (int kk = 0; kk < NS; kk += KS) {
    const int k2 = KS == 2 ? kk + 1 : kk;
    const float* row = br + 8 * kk * DMAX;
    const float* row_b = br + 8 * k2 * DMAX;
    const double2 x0 = make_double2(p[kk][0], p[kk][1]), x1 = make_double2(p[kk][2], p[kk][3]);
    const double2 x0b = make_double2(p[k2][0], p[k2][1]), x1b = make_double2(p[k2][2], p[k2][3]);
#pragma unroll
    for (int n = 0; n < DMAX / 8; ++n)
      if (8 * n < d) {
        const double2 y = make_double2(row[8 * (n ^ ((s_0 + 2 * kk) & 3))],
                                       row[DMAX + 8 * (n ^ ((s_1 + 2 * kk) & 3))]);
        const double2 yb = KS == 2 ? make_double2(row_b[8 * (n ^ ((s_0 + 2 * k2) & 3))],
                                                  row_b[DMAX + 8 * (n ^ ((s_1 + 2 * k2) & 3))])
                                   : y;
        dmma_steps<DK>(o[n], x0, x1, y, KS == 2, x0b, x1b, yb);
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


// ---------------------------------------------------------------------------
// the kernel bodies, shared by K4 (one segment) and K7 (prefix + latents)
// ---------------------------------------------------------------------------

using mma::cp_async4;
using mma::cp_commit;
using mma::cp_wait;
using mma::NO_LIMIT;
using mma::SMEM_PER_SM;
using mma::Tile;

// the head-dim bucket (32, 64 or 128) a kernel is instantiated for
inline int dmax_bucket(int dqk, int dv) {
  const int d = dqk > dv ? dqk : dv;
  return d <= 32 ? 32 : (d <= 64 ? 64 : 128);
}

template <int DMAX_>
struct Dq {
  static constexpr int DMAX = DMAX_;
  static constexpr int NW = DMAX <= 64 ? 4 : 8;  // warps
  static constexpr int NT = 32 * NW;
  static constexpr int BQ = 16 * NW;                // q rows a CTA owns
  static constexpr int BKV = DMAX <= 64 ? 64 : 32;  // kv rows a walked tile
  static constexpr int NS = BKV / 8;
  static constexpr int DK = DMAX <= 64 ? 16 : 8;  // f64 mma.sync depth (16 spills at 128)
  static constexpr int LDA = DMAX + 8;
  static constexpr int A = BQ * LDA;    // Q or dO, in floats
  static constexpr int B = BKV * DMAX;  // one K or V buffer
  static constexpr size_t BYTES = (2 * A + 4 * B + 2 * BKV) * sizeof(float);
  static constexpr int MIN_BLOCKS = 2 * (BYTES + 1024) <= SMEM_PER_SM ? 2 : 1;
};

template <int DMAX_>
struct Dkv {
  static constexpr int DMAX = DMAX_;
  static constexpr int NW = DMAX <= 64 ? 4 : 8;
  static constexpr int NT = 32 * NW;
  static constexpr int BKV = 16 * NW;               // kv rows a CTA owns
  static constexpr int BQT = DMAX <= 64 ? 64 : 32;  // q rows a walked tile
  static constexpr int NS = BQT / 8;
  // output n-tiles of the gradient products at a time, each with two
  // accumulators (NG 4 with one spilled nothing; 8 spilled at DMAX = 64;
  // dK and dV fill the registers at 128)
  static constexpr int NG = 2;
  static constexpr int DK = 4;  // f64 mma.sync depth (8 and 16 are slower here)
  // k-steps of the split-TF32 gradient products summed in one fresh
  // accumulator before it is added to dK / dV
  static constexpr int KJ = 2;
  static constexpr int LDA = DMAX + 8;
  static constexpr int A = BKV * LDA;   // K or V
  static constexpr int B = BQT * DMAX;  // one Q or dO buffer
  static constexpr size_t BYTES = (2 * A + 4 * B + 4 * BQT) * sizeof(float);
  static constexpr int MIN_BLOCKS = 2 * (BYTES + 1024) <= SMEM_PER_SM ? 2 : 1;
};

// dQ of the CTA's Dq::BQ query rows from q0 (grid (q blocks, head, batch)):
// walks kv tiles 0 .. n_tiles - 1, tile_of(t) naming each (a Tile: its
// segment's K and V head slices, bias row or null, first row j0, length n
// and causal offset off, key j visible to query i iff j < n and
// j <= i + off), so no tile straddles two segments. Per tile, S = Q K^T and
// dP = dO V^T in f64, then dQ += dS K in f64 over the whole walk, rounded
// to f32 once.
template <int DMAX, typename TileOf>
__device__ __forceinline__ void dq_walk(const float* __restrict__ q, const float* __restrict__ dout,
                                        const float* __restrict__ lse, const float* __restrict__ delta,
                                        float* __restrict__ dq, int nq, int h, int dqk, int dv, float sm_scale,
                                        int n_tiles, TileOf tile_of) {
  using P = Dq<DMAX>;
  constexpr int NS = P::NS;
  extern __shared__ float4 smem4[];
  float* sq = reinterpret_cast<float*>(smem4);
  float* sdo = sq + P::A;
  float* tiles = sdo + P::A;  // K buffers, V buffers, bias rows
  auto sk = [&](int u) { return tiles + u * P::B; };
  auto sv = [&](int u) { return tiles + (2 + u) * P::B; };
  auto sb = [&](int u) { return tiles + 4 * P::B + u * P::BKV; };

  const int q0 = blockIdx.x * P::BQ, head = blockIdx.y, b = blockIdx.z;
  const long row_qk = (long)h * dqk, row_v = (long)h * dv;
  const int w = threadIdx.x >> 5, g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
  const int i0 = q0 + 16 * w + g;  // the lane's rows i0, i0 + 8

  auto stage = [&](int tile, int u) {
    const Tile<float> tl = tile_of(tile);
    stage_swizzled<DMAX, P::BKV, P::NT>(sk(u), tl.k, row_qk, tl.j0, tl.n, dqk);
    stage_swizzled<DMAX, P::BKV, P::NT>(sv(u), tl.v, row_v, tl.j0, tl.n, dv);
    if (threadIdx.x < P::BKV) {
      const int j = tl.j0 + threadIdx.x;
      const bool ok = tl.bias != nullptr && j < tl.n;
      cp_async4(sb(u) + threadIdx.x, ok ? tl.bias + j : tl.k, ok);
    }
    cp_commit();
  };
  if (n_tiles > 0) stage(0, 0);
  stage_rows<P::LDA, P::BQ, P::NT>(sq, q + (long)b * nq * row_qk + (long)head * dqk, row_qk, q0, nq, dqk);
  stage_rows<P::LDA, P::BQ, P::NT>(sdo, dout + (long)b * nq * row_v + (long)head * dv, row_v, q0, nq, dv);
  float lse_r[2], delta_r[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int i = i0 + 8 * r;
    const long stat = ((long)b * nq + i) * h + head;
    lse_r[r] = i < nq ? lse[stat] : 0.f;
    delta_r[r] = i < nq ? delta[stat] : 0.f;
  }

  double acc[DMAX / 8][4];
#pragma unroll
  for (int n = 0; n < DMAX / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0;
  const float* qw = sq + 16 * w * P::LDA;
  const float* dow = sdo + 16 * w * P::LDA;
  for (int tile = 0; tile < n_tiles; ++tile) {
    const int u = tile & 1;
    if (tile + 1 < n_tiles) {
      stage(tile + 1, u ^ 1);
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();  // tile (and the block's Q and dO) in shared memory for every warp

    // p of rows g (e = 0, 1) and g + 8 (e = 2, 3): the exponent
    // s + bias - lse in f64, -inf for keys past the segment or the row's
    // causal limit
    const Tile<float> tl = tile_of(tile);
    const bool full = tl.j0 + P::BKV <= tl.n && tl.j0 + P::BKV - 1 <= q0 + 16 * w + tl.off;
    const float* bt = sb(u);
    float p[NS][4], ds[NS][4];
    {
      double s[NS][4];
      prod_abt64<DMAX, P::LDA, NS, P::DK>(s, qw, sk(u), dqk);
#pragma unroll
      for (int n = 0; n < NS; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = 8 * n + 2 * t + (e & 1), r = e >> 1;
          float x = (float)(s[n][e] * (double)sm_scale + (double)bt[c] - (double)lse_r[r]);
          if (!full) {
            const int j = tl.j0 + c;
            if (!(j < tl.n && j <= i0 + 8 * r + tl.off)) x = -CUDART_INF_F;
          }
          p[n][e] = expf(x);
        }
    }
    // dS = p (dP - delta) sm_scale, dP - delta in f64
    {
      double dp[NS][4];
      prod_abt64<DMAX, P::LDA, NS, P::DK>(dp, dow, sv(u), dv);
#pragma unroll
      for (int n = 0; n < NS; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) ds[n][e] = p[n][e] * (float)(dp[n][e] - (double)delta_r[e >> 1]) * sm_scale;
    }
    prod_ab64<DMAX, NS, P::DK>(acc, ds, sk(u), dqk);
    __syncthreads();  // every warp is done with buffer u before it is refilled
  }
  store_rows<DMAX>(dq + (long)b * nq * row_qk + (long)head * dqk, row_qk, q0 + 16 * w, nq, dqk, acc);
}

// dK and dV of the CTA's Dkv::BKV kv rows of one segment of (batch b,
// head): seg names them (its K and V head slices, bias row or null, the
// block's first row j0, the segment's length n and causal offset off);
// dk and dvo point at the segment's gradient head slices. Walks the q tiles
// from the first one whose rows can see the block's first key, transposed:
// S^T = K Q^T and dP^T = V dO^T in f64, dV += P^T dO and dK += dS^T Q
// split-TF32.
template <int DMAX>
__device__ __forceinline__ void dkv_walk(const float* __restrict__ q, const float* __restrict__ dout,
                                         const float* __restrict__ lse, const float* __restrict__ delta,
                                         const Tile<float>& seg, float* __restrict__ dk, float* __restrict__ dvo,
                                         int b, int head, int nq, int h, int dqk, int dv, float sm_scale) {
  using P = Dkv<DMAX>;
  constexpr int NS = P::NS;
  extern __shared__ float4 smem4[];
  float* sk = reinterpret_cast<float*>(smem4);
  float* sv = sk + P::A;
  float* tiles = sv + P::A;  // Q buffers, dO buffers, lse rows, delta rows
  auto sq = [&](int u) { return tiles + u * P::B; };
  auto sdo = [&](int u) { return tiles + (2 + u) * P::B; };
  auto slse = [&](int u) { return tiles + 4 * P::B + u * P::BQT; };
  auto sdelta = [&](int u) { return tiles + 4 * P::B + (2 + u) * P::BQT; };

  const int j0 = seg.j0;
  const long row_qk = (long)h * dqk, row_v = (long)h * dv;
  const float* qh = q + (long)b * nq * row_qk + (long)head * dqk;
  const float* doh = dout + (long)b * nq * row_v + (long)head * dv;

  const int w = threadIdx.x >> 5, g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
  const int jw = j0 + 16 * w;  // the warp's first kv row; the lane's are jw + g, jw + g + 8
  // query i sees key j iff j <= i + off: rows below j0 - off see nothing of
  // this block (none with off NO_LIMIT)
  int i_begin = max(0, j0 - seg.off);
  i_begin -= i_begin % P::BQT;
  const int n_tiles = i_begin < nq ? (nq - i_begin + P::BQT - 1) / P::BQT : 0;

  auto stage = [&](int tile, int u) {
    const int i0 = i_begin + tile * P::BQT;
    stage_swizzled<DMAX, P::BQT, P::NT>(sq(u), qh, row_qk, i0, nq, dqk);
    stage_swizzled<DMAX, P::BQT, P::NT>(sdo(u), doh, row_v, i0, nq, dv);
    if (threadIdx.x < P::BQT) {
      const int i = i0 + threadIdx.x;
      const bool ok = i < nq;
      const long stat = ((long)b * nq + (ok ? i : 0)) * h + head;
      cp_async4(slse(u) + threadIdx.x, lse + stat, ok);
      cp_async4(sdelta(u) + threadIdx.x, delta + stat, ok);
    }
    cp_commit();
  };
  if (n_tiles > 0) stage(0, 0);
  stage_rows<P::LDA, P::BKV, P::NT>(sk, seg.k, row_qk, j0, seg.n, dqk);
  stage_rows<P::LDA, P::BKV, P::NT>(sv, seg.v, row_v, j0, seg.n, dv);
  float bias_r[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int j = jw + g + 8 * r;
    bias_r[r] = (seg.bias != nullptr && j < seg.n) ? seg.bias[j] : 0.f;
  }

  float acc_k[DMAX / 8][4], acc_v[DMAX / 8][4];
#pragma unroll
  for (int n = 0; n < DMAX / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc_k[n][e] = acc_v[n][e] = 0.f;
  const float* kw = sk + 16 * w * P::LDA;
  const float* vw = sv + 16 * w * P::LDA;
  for (int tile = 0; tile < n_tiles; ++tile) {
    const int u = tile & 1;
    if (tile + 1 < n_tiles) {
      stage(tile + 1, u ^ 1);
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();

    // S^T and dP^T: kv rows g (e = 0, 1) and g + 8 (e = 2, 3), q columns
    // 8n + 2t + (e & 1)
    const int i0 = i_begin + tile * P::BQT;
    const bool full = i0 + P::BQT <= nq && jw + 15 < seg.n && jw + 15 <= i0 + seg.off;
    const float *lt = slse(u), *dt = sdelta(u);
    // p: the exponent s + bias - lse in f64, -inf past the segment or the
    // causal limit, and its exp in f64, rounded to f32 once. expf of the
    // exponent rounded to f32 (up to ~2 ulp of p at exponents of a few
    // units) left dV 3.38e-7 from f64 at one query row on an H100 (MNIST's
    // decoder, where dV is p dO with no sum to hide it), further than the
    // f32 plain version's 3.22e-7
    float p[NS][4], ds[NS][4];
    {
      double st[NS][4];
      prod_abt64<DMAX, P::LDA, NS, P::DK>(st, kw, sq(u), dqk);
#pragma unroll
      for (int n = 0; n < NS; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = 8 * n + 2 * t + (e & 1), r = e >> 1;
          double x = st[n][e] * (double)sm_scale + (double)bias_r[r] - (double)lt[c];
          if (!full) {
            const int i = i0 + c, j = jw + g + 8 * r;
            if (!(i < nq && j < seg.n && j <= i + seg.off)) x = -CUDART_INF;
          }
          p[n][e] = (float)exp(x);
        }
    }
    // dS^T = p (dP^T - delta) sm_scale, dP^T - delta in f64
    {
      double dpt[NS][4];
      prod_abt64<DMAX, P::LDA, NS, P::DK>(dpt, vw, sdo(u), dv);
#pragma unroll
      for (int n = 0; n < NS; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = 8 * n + 2 * t + (e & 1);
          ds[n][e] = p[n][e] * (float)(dpt[n][e] - (double)dt[c]) * sm_scale;
        }
    }
    // each walked tile's dV and dK products a fresh split-TF32 accumulator
    prod_ab<DMAX, NS, P::NG, P::KJ>(acc_v, p, sdo(u), dv);
    prod_ab<DMAX, NS, P::NG, P::KJ>(acc_k, ds, sq(u), dqk);
    __syncthreads();
  }
  store_rows<DMAX>(dk, row_qk, jw, seg.n, dqk, acc_k);
  store_rows<DMAX>(dvo, row_v, jw, seg.n, dv, acc_v);
}


// ---------------------------------------------------------------------------
// bf16: the kernel bodies of K4a / K4b's bf16 build
// ---------------------------------------------------------------------------
//
// The JAX package's bf16 backward (perceiver_io_tpu/ops/flash_attention.py
// _dkv_packed_kernel, _dq_packed_kernel on bf16 operands): every product
// takes bf16 operands and sums in f32, which m16n8k16 bf16 mma.sync does
// exactly (the products of bf16 values are exact in f32). p is recomputed in
// f32 from the score product and the f32 logsumexp, and rounded to bf16 (to
// nearest) before dV += P^T dO; dS = p (dP - delta) sm_scale in f32, rounded
// to bf16 before dK += dS^T Q and dQ += dS K, where the JAX kernels round
// them. No f64 and no split: the f32 build's accuracy has no bf16 form to
// keep, and bf16 rounding of p and dS sets the gradients' error.
//
// Fragments, all by ldmatrix from shared memory (bf16 rows of pitch
// LD = DMAX + 8 elements, an odd number of 16-byte units, so the eight rows
// of each 8x8 matrix fall on distinct banks): the A operand (the warp's 16
// rows of the block's own operand) and the B operand of a score product
// (rows of a walked tile, channels along k) by ldmatrix.x4, the B operand of
// a gradient product (rows of a walked tile along k, channels along n) by
// ldmatrix.x4.trans; one tile serves both reads, so no swizzle is needed.
// The C fragment of n-tiles 2kk and 2kk + 1 of a score tile is, pair for
// pair, the A fragment of k-step kk of the gradient product that follows it.
// Each walked tile's gradient product sums into a fresh accumulator that an
// f32 add joins to dQ, dK or dV (the tensor core rounds a chained sum toward
// zero; see flash_mma.cuh).
//
// Tiles: 4 warps, a CTA owns 64 rows (16 a warp), walked tiles of 64 rows
// up to head dim 64 and 32 at 128, double-buffered by cp.async (rows past
// the sequence and channels from d to d rounded up to 16 zero-filled).

using bf16 = __nv_bfloat16;
using mma::ldmatrix_x4_trans;
using mma::mma_bf16;

template <int DMAX_>
struct B16 {
  static constexpr int DMAX = DMAX_;
  static constexpr int NW = 4;
  static constexpr int NT = 32 * NW;
  static constexpr int BM = 16 * NW;                // rows a CTA owns
  static constexpr int BN = DMAX <= 64 ? 64 : 32;   // rows a walked tile
  static constexpr int NS = BN / 8;                 // score n-tiles
  static constexpr int LD = DMAX + 8;               // row pitch, in elements
  static constexpr int A = BM * LD;                 // the CTA's operand
  static constexpr int B = BN * LD;                 // one walked buffer
  // two own operands, two double-buffered walked operands, and four f32 rows
  // of BN (bias rows in K4b; lse and delta rows in K4a)
  static constexpr size_t BYTES = (2 * A + 4 * B) * sizeof(bf16) + 4 * BN * sizeof(float);
  static constexpr int MIN_BLOCKS = DMAX <= 64 ? 2 : 1;
};

// four 8x8 b16 matrices: lanes 8i..8i+7 address matrix i's rows
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* row) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(row));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s));
}

// two 8x8 b16 matrices: lanes 8i..8i+7 address matrix i's rows (the
// addresses of lanes 16-31 are not read)
__device__ __forceinline__ void ldmatrix_x2(uint32_t (&r)[2], const void* row) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(row));
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];" : "=r"(r[0]), "=r"(r[1]) : "r"(s));
}

// two 8x8 b16 matrices, transposed (as ldmatrix_x2)
__device__ __forceinline__ void ldmatrix_x2_trans(uint32_t (&r)[2], const void* row) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(row));
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];" : "=r"(r[0]), "=r"(r[1]) : "r"(s));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// rows [r0, r0 + BR) of a head slice (row stride row_stride, d channels) into
// a buffer of pitch LD by cp.async, 8 elements a copy: rows at or past n and
// channels [d, d rounded up to 16) zero-filled; the caller commits and waits
template <int LD, int BR, int NT>
__device__ __forceinline__ void stage16(bf16* dst, const bf16* src, long row_stride, int r0, int n, int d) {
  const int per = (d + 15) / 16 * 2;
  for (int idx = threadIdx.x; idx < BR * per; idx += NT) {
    const int r = idx / per, c = 8 * (idx - r * per), gr = r0 + r;
    const bool ok = gr < n && c < d;
    cp_async16(dst + r * LD + c, ok ? src + (long)gr * row_stride + c : src, ok);
  }
}

// c = A B^T for the warp's 16 rows: a at the warp's first row, b a walked
// tile of NS * 8 rows, both of pitch LD; depth d
template <int DMAX, int LD, int NS>
__device__ __forceinline__ void prod_abt16(float (&c)[NS][4], const bf16* a, const bf16* b, int d) {
  static_assert(NS % 2 == 0, "n-tiles come in pairs");
  const int lane = threadIdx.x & 31;
  const bf16* ap = a + (lane & 15) * LD + 8 * (lane >> 4);
  const bf16* bp = b + ((lane & 7) + 8 * (lane >> 4)) * LD + 8 * ((lane >> 3) & 1);
#pragma unroll
  for (int n = 0; n < NS; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) c[n][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < DMAX / 16; ++kk) {
    if (16 * kk < d) {
      uint32_t af[4];
      ldmatrix_x4(af, ap + 16 * kk);
#pragma unroll
      for (int n = 0; n < NS; n += 2) {
        uint32_t bq[4];
        ldmatrix_x4(bq, bp + 8 * n * LD + 16 * kk);
        mma_bf16(c[n], af, bq[0], bq[1]);
        mma_bf16(c[n + 1], af, bq[2], bq[3]);
      }
    }
  }
}

// o += bf16(P) B: P the C fragments of NS n-tiles (the k-steps: rows of b),
// rounded to bf16 here; b a walked tile of pitch LD read down its rows;
// output n-tiles of 8 channels up to d, a fresh accumulator a pair
template <int DMAX, int LD, int NS>
__device__ __forceinline__ void prod_ab16(float (&o)[DMAX / 8][4], const float (&p)[NS][4], const bf16* b, int d) {
  const int lane = threadIdx.x & 31;
  uint32_t pa[NS / 2][4];
#pragma unroll
  for (int kk = 0; kk < NS / 2; ++kk) {
    pa[kk][0] = pack_bf16(p[2 * kk][0], p[2 * kk][1]);
    pa[kk][1] = pack_bf16(p[2 * kk][2], p[2 * kk][3]);
    pa[kk][2] = pack_bf16(p[2 * kk + 1][0], p[2 * kk + 1][1]);
    pa[kk][3] = pack_bf16(p[2 * kk + 1][2], p[2 * kk + 1][3]);
  }
  const bf16* bl = b + (lane & 15) * LD + 8 * (lane >> 4);
#pragma unroll
  for (int n = 0; n < DMAX / 8; n += 2) {
    if (8 * n < d) {
      float acc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
      for (int kk = 0; kk < NS / 2; ++kk) {
        uint32_t r[4];
        ldmatrix_x4_trans(r, bl + 16 * kk * LD + 8 * n);
        mma_bf16(acc[0], pa[kk], r[0], r[1]);
        mma_bf16(acc[1], pa[kk], r[2], r[3]);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        o[n][e] += acc[0][e];
        o[n + 1][e] += acc[1][e];
      }
    }
  }
}

// the lane's rows r0 + g, r0 + g + 8 of an accumulator to bf16 rows of a
// head slice, up to row n and channel d
template <int DMAX>
__device__ __forceinline__ void store_rows16(bf16* dst, long row_stride, int r0, int n, int d,
                                             const float (&o)[DMAX / 8][4]) {
  const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r0 + g + 8 * r;
    if (row >= n) continue;
    bf16* out = dst + (long)row * row_stride + 2 * t;
#pragma unroll
    for (int m = 0; m < DMAX / 8; ++m)
      if (8 * m < d) mma::store2(out + 8 * m, o[m][2 * r], o[m][2 * r + 1]);
  }
}

// dQ of the CTA's B16::BM query rows from q0 (grid (q blocks, head, batch)),
// bf16: walks kv tiles 0 .. n_tiles - 1 named by tile_of (as dq_walk). Per
// tile, S = Q K^T and dP = dO V^T, then dQ += bf16(dS) K.
template <int DMAX, typename TileOf>
__device__ __forceinline__ void dq_walk16(const bf16* __restrict__ q, const bf16* __restrict__ dout,
                                          const float* __restrict__ lse, const float* __restrict__ delta,
                                          bf16* __restrict__ dq, int nq, int h, int dqk, int dv, float sm_scale,
                                          int n_tiles, TileOf tile_of) {
  using P = B16<DMAX>;
  constexpr int NS = P::NS, LD = P::LD;
  extern __shared__ float4 smem4[];
  bf16* sq = reinterpret_cast<bf16*>(smem4);
  bf16* sdo = sq + P::A;
  bf16* tiles = sdo + P::A;  // K buffers, V buffers, then the bias rows
  auto sk = [&](int u) { return tiles + u * P::B; };
  auto sv = [&](int u) { return tiles + (2 + u) * P::B; };
  auto sb = [&](int u) { return reinterpret_cast<float*>(tiles + 4 * P::B) + u * P::BN; };

  const int q0 = blockIdx.x * P::BM, head = blockIdx.y, b = blockIdx.z;
  const long row_qk = (long)h * dqk, row_v = (long)h * dv;
  const int w = threadIdx.x >> 5, g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
  const int i0 = q0 + 16 * w + g;  // the lane's rows i0, i0 + 8

  auto stage = [&](int tile, int u) {
    const Tile<bf16> tl = tile_of(tile);
    stage16<LD, P::BN, P::NT>(sk(u), tl.k, row_qk, tl.j0, tl.n, dqk);
    stage16<LD, P::BN, P::NT>(sv(u), tl.v, row_v, tl.j0, tl.n, dv);
    if (threadIdx.x < P::BN) {
      const int j = tl.j0 + threadIdx.x;
      const bool ok = tl.bias != nullptr && j < tl.n;
      cp_async4(sb(u) + threadIdx.x, ok ? static_cast<const void*>(tl.bias + j) : tl.k, ok);
    }
  };
  stage16<LD, P::BM, P::NT>(sq, q + (long)b * nq * row_qk + (long)head * dqk, row_qk, q0, nq, dqk);
  stage16<LD, P::BM, P::NT>(sdo, dout + (long)b * nq * row_v + (long)head * dv, row_v, q0, nq, dv);
  if (n_tiles > 0) stage(0, 0);
  cp_commit();
  float lse_r[2], delta_r[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int i = i0 + 8 * r;
    const long stat = ((long)b * nq + i) * h + head;
    lse_r[r] = i < nq ? lse[stat] : 0.f;
    delta_r[r] = i < nq ? delta[stat] : 0.f;
  }

  float acc[DMAX / 8][4];
#pragma unroll
  for (int n = 0; n < DMAX / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  const bf16* qw = sq + 16 * w * LD;
  const bf16* dow = sdo + 16 * w * LD;
  for (int tile = 0; tile < n_tiles; ++tile) {
    const int u = tile & 1;
    if (tile + 1 < n_tiles) {
      stage(tile + 1, u ^ 1);
      cp_commit();
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();  // tile (and the block's Q and dO) in shared memory for every warp

    const Tile<bf16> tl = tile_of(tile);
    const bool full = tl.j0 + P::BN <= tl.n && tl.j0 + P::BN - 1 <= q0 + 16 * w + tl.off;
    const float* bt = sb(u);
    float p[NS][4], ds[NS][4];
    prod_abt16<DMAX, LD, NS>(p, qw, sk(u), dqk);
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = 8 * n + 2 * t + (e & 1), r = e >> 1;
        float x = fmaf(p[n][e], sm_scale, bt[c]) - lse_r[r];
        if (!full) {
          const int j = tl.j0 + c;
          if (!(j < tl.n && j <= i0 + 8 * r + tl.off)) x = -CUDART_INF_F;
        }
        p[n][e] = expf(x);
      }
    prod_abt16<DMAX, LD, NS>(ds, dow, sv(u), dv);
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) ds[n][e] = p[n][e] * (ds[n][e] - delta_r[e >> 1]) * sm_scale;
    prod_ab16<DMAX, LD, NS>(acc, ds, sk(u), dqk);
    __syncthreads();  // every warp is done with buffer u before it is refilled
  }
  cp_wait<0>();  // no copy left in flight (an empty walk staged Q and dO alone)
  store_rows16<DMAX>(dq + (long)b * nq * row_qk + (long)head * dqk, row_qk, q0 + 16 * w, nq, dqk, acc);
}

// dK and dV of the CTA's B16::BM kv rows of one segment (as dkv_walk), bf16:
// walks the q tiles that can see the block, transposed: S^T = K Q^T and
// dP^T = V dO^T, dV += bf16(P^T) dO and dK += bf16(dS^T) Q.
template <int DMAX>
__device__ __forceinline__ void dkv_walk16(const bf16* __restrict__ q, const bf16* __restrict__ dout,
                                           const float* __restrict__ lse, const float* __restrict__ delta,
                                           const Tile<bf16>& seg, bf16* __restrict__ dk, bf16* __restrict__ dvo,
                                           int b, int head, int nq, int h, int dqk, int dv, float sm_scale) {
  using P = B16<DMAX>;
  constexpr int NS = P::NS, LD = P::LD;
  extern __shared__ float4 smem4[];
  bf16* sk = reinterpret_cast<bf16*>(smem4);
  bf16* sv = sk + P::A;
  bf16* tiles = sv + P::A;  // Q buffers, dO buffers, then lse and delta rows
  auto sq = [&](int u) { return tiles + u * P::B; };
  auto sdo = [&](int u) { return tiles + (2 + u) * P::B; };
  auto slse = [&](int u) { return reinterpret_cast<float*>(tiles + 4 * P::B) + u * P::BN; };
  auto sdelta = [&](int u) { return reinterpret_cast<float*>(tiles + 4 * P::B) + (2 + u) * P::BN; };

  const int j0 = seg.j0;
  const long row_qk = (long)h * dqk, row_v = (long)h * dv;
  const bf16* qh = q + (long)b * nq * row_qk + (long)head * dqk;
  const bf16* doh = dout + (long)b * nq * row_v + (long)head * dv;
  const int w = threadIdx.x >> 5, g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
  const int jw = j0 + 16 * w;  // the warp's first kv row; the lane's are jw + g, jw + g + 8
  int i_begin = max(0, j0 - seg.off);
  i_begin -= i_begin % P::BN;
  const int n_tiles = i_begin < nq ? (nq - i_begin + P::BN - 1) / P::BN : 0;

  auto stage = [&](int tile, int u) {
    const int i0 = i_begin + tile * P::BN;
    stage16<LD, P::BN, P::NT>(sq(u), qh, row_qk, i0, nq, dqk);
    stage16<LD, P::BN, P::NT>(sdo(u), doh, row_v, i0, nq, dv);
    if (threadIdx.x < P::BN) {
      const int i = i0 + threadIdx.x;
      const bool ok = i < nq;
      const long stat = ((long)b * nq + (ok ? i : 0)) * h + head;
      cp_async4(slse(u) + threadIdx.x, lse + stat, ok);
      cp_async4(sdelta(u) + threadIdx.x, delta + stat, ok);
    }
  };
  stage16<LD, P::BM, P::NT>(sk, seg.k, row_qk, j0, seg.n, dqk);
  stage16<LD, P::BM, P::NT>(sv, seg.v, row_v, j0, seg.n, dv);
  if (n_tiles > 0) stage(0, 0);
  cp_commit();
  float bias_r[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int j = jw + g + 8 * r;
    bias_r[r] = (seg.bias != nullptr && j < seg.n) ? seg.bias[j] : 0.f;
  }

  float acc_k[DMAX / 8][4], acc_v[DMAX / 8][4];
#pragma unroll
  for (int n = 0; n < DMAX / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc_k[n][e] = acc_v[n][e] = 0.f;
  const bf16* kw = sk + 16 * w * LD;
  const bf16* vw = sv + 16 * w * LD;
  for (int tile = 0; tile < n_tiles; ++tile) {
    const int u = tile & 1;
    if (tile + 1 < n_tiles) {
      stage(tile + 1, u ^ 1);
      cp_commit();
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();

    const int i0 = i_begin + tile * P::BN;
    const bool full = i0 + P::BN <= nq && jw + 15 < seg.n && jw + 15 <= i0 + seg.off;
    const float *lt = slse(u), *dt = sdelta(u);
    float p[NS][4], ds[NS][4];
    prod_abt16<DMAX, LD, NS>(p, kw, sq(u), dqk);
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = 8 * n + 2 * t + (e & 1), r = e >> 1;
        float x = fmaf(p[n][e], sm_scale, bias_r[r]) - lt[c];
        if (!full) {
          const int i = i0 + c, j = jw + g + 8 * r;
          if (!(i < nq && j < seg.n && j <= i + seg.off)) x = -CUDART_INF_F;
        }
        p[n][e] = expf(x);
      }
    prod_abt16<DMAX, LD, NS>(ds, vw, sdo(u), dv);
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) ds[n][e] = p[n][e] * (ds[n][e] - dt[8 * n + 2 * t + (e & 1)]) * sm_scale;
    prod_ab16<DMAX, LD, NS>(acc_v, p, sdo(u), dv);
    prod_ab16<DMAX, LD, NS>(acc_k, ds, sq(u), dqk);
    __syncthreads();
  }
  cp_wait<0>();
  store_rows16<DMAX>(dk, row_qk, jw, seg.n, dqk, acc_k);
  store_rows16<DMAX>(dvo, row_v, jw, seg.n, dv, acc_v);
}

}  // namespace mma_bwd
}  // namespace pio
