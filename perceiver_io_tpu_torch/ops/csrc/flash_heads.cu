// K8: heads-major flash attention forward for Hopper (sm_90a), CUDA C++,
// f32 and bf16 (its bf16 build, heads_fwd_bf16_kernel, below the f32 one),
// on the tensor cores.
//
// Replaces the TPU kernel perceiver_io_tpu/ops/flash_attention.py
// _fwd_kernel (reached from _flash_fwd_impl via flash_attention). Same
// function: for q (B*H, Nq, Dqk), k (B*H, Nkv, Dqk), v (B*H, Nkv, Dv),
// scores s_ij = sm_scale * q_i.k_j + bias_j in f32 (the bias row (B, Nkv) is
// 0 or the finite MASK_VALUE at padded keys, shared by a batch row's H
// heads), an optional right-aligned causal limit j <= i + (Nkv - Nq), the
// online softmax, the output and the per-row logsumexp (B*H, Nq) for the
// backward. Keys past a row's causal limit never enter its softmax; a row
// whose visible keys are all padded gets their uniform average; a row that
// sees no key gets 0 and logsumexp -inf.
//
// What bounds it: at the Perceiver IO image classifier's cross-attention
// (512 latents over 50176 pixels, one head of 264 channels) the work is
// 4 * 512 * 50176 * 264 = 27.1 GFLOP per image against ~107 MB of operands:
// arithmetic. The products run on the tensor cores by mma.sync m16n8k8 TF32
// under flash_mma.cuh's split policy (each f32 operand split into a rounded
// TF32 big part and its residual, three products per f32-accurate product,
// so the bound is a third of the TF32 rate); the softmax stays in f32:
// - S = Q K^T in chains of at most KG = 4 k-steps, each into a fresh
//   accumulator that an f32 add joins to the rest (33 k-steps at D = 264:
//   9 chains an m16n8 unit, a warp's units' chains in flight together);
// - each kv tile's P V into a fresh accumulator, joined to the output by
//   one FFMA with the softmax rescale, o = o * alpha + tile.
// A forward has no gradient amplification (K4, K9), so split-TF32 products
// keep the output within the f32 parity tolerance.
//
// Layout (K9's, flash_heads_bwd.cu): a 264-wide row (up to 512) fits in no
// thread's registers, so the CTA's 8 warps share the work of each tile:
// - A CTA owns BQ = 64 query rows (staged once) and walks tiles of BKV kv
//   rows, every operand tile at pitch DMAX and swizzled as
//   flash_mma_bwd.cuh's walked tiles are, so the score product's float2
//   loads along the rows of Q and K and the P.V product's scalar loads down
//   the columns of V are both free of bank conflicts.
// - Scores: the tile's 4 x BKV / 8 m16n8 units are split over the warps, UW
//   units of one m-tile a warp (its Q fragments split once for them). Each
//   warp's partial row maxima, then its partial row sums, pass through
//   shared memory; every warp reads the row's NWN partials in a fixed order,
//   so all threads agree on the tile's maximum and rescale. P goes through
//   shared memory in f32.
// - P V: a warp takes two m-tiles and every fourth of the output's 8-column
//   n-tiles, up to the real head dim (264, not the bucket's 288); each V
//   fragment is split once for the two m-tiles, each n-tile's product is a
//   fresh accumulator.
// - Row statistics: thread r < BQ keeps row r's running max and sum in
//   registers and publishes the max for the next tile.
// - One buffer each for K and V, and three barriers a tile: the tile's K
//   has arrived (tile t - 1 done; V(t) starts loading and flies during the
//   scores), the maxima (K(t) read; K(t + 1) starts loading and flies during
//   P V), P and the sums (V(t) arrived). On an H100 this ran the image CA
//   faster than K and V double-buffered at 32 kv rows, the deeper tile
//   halving the barriers and the fixed work per key (PERF.md).
// Shared memory (floats): BQ x DMAX for Q, 2 x BKV x DMAX for K and V,
// BQ x (BKV + 8) for P (pitch 8 or 24 mod 32 for its float2 fragment
// loads), and a few rows of statistics. By the head-dim bucket of
// max(Dqk, Dv): DMAX 64 / 128 / 256 / 288 (D 257-288: the image CA's 264 is
// 33 k-steps and 33 n-tiles, looped to 264): BKV = 48, 57,216 / 98,176 /
// 180,096 / 200,576 bytes; DMAX 512: BKV = 16, 204,416 bytes.
// The wrapper reads the CTAs an SM from the runtime
// (pio_flash_heads_fwd_slots) and splits the kv walk across `nsplit` CTAs
// (grid z) where the q blocks leave CTA slots idle: each writes its
// unnormalized partial (acc, m, l) to a scratch buffer and a second pass
// (flash_merge.cuh) merges the splits in a fixed order, as K2 does. Rows
// past Nq and kv rows past Nkv are staged as zeros and masked; the wrapper
// pads odd head dims to a multiple of 8.

#include "flash_merge.cuh"
#include "flash_mma_bwd.cuh"

namespace {

using pio::mma::cp_async4;
using pio::mma::cp_commit;
using pio::mma::cp_wait;
using pio::mma::KG;
using pio::mma::mma3;
using pio::mma::mma3_split;
using pio::mma::NO_LIMIT;
using pio::mma::split;
using pio::mma::store2;
using pio::mma_bwd::stage_swizzled;
using pio::mma_bwd::sw;

constexpr int NW = 8;  // warps
constexpr int NT = 32 * NW;

template <int DMAX_>
struct Cfg {
  static constexpr int DMAX = DMAX_;                      // pitch of every operand tile
  static constexpr int BQ = 64;                           // q rows a CTA owns
  static constexpr int BKV = DMAX == 512 ? 16 : 48;       // kv rows of a walked tile
  static constexpr int MT = BQ / 16;                      // m-tiles
  static constexpr int NS = BKV / 8;                      // score n-tiles, P.V k-steps
  static constexpr int UNITS = MT * NS;                   // m16n8 units of a score tile
  static constexpr int UW = UNITS / NW;                   // units a score warp takes
  static constexpr int NWN = NW / MT;                     // score warps of an m-tile
  static constexpr int NGRP = (DMAX / 8 + KG - 1) / KG;   // score chains
  static constexpr int GI = 4 / UW;                       // chains in flight
  static constexpr int PM = 2;                            // m-tiles of a warp's P.V
  static constexpr int MG = MT / PM;                      // m-groups
  static constexpr int NGW = NW / MG;                     // warps an m-group
  static constexpr int NPW = (DMAX / 8 + NGW - 1) / NGW;  // output n-tiles a warp holds
  static constexpr int LDP = BKV + 8;                     // pitch of P
  static constexpr int TILE = BKV * DMAX;
  static constexpr size_t BYTES =
      (BQ * DMAX + 2 * TILE + BQ * LDP + 2 * BKV + 2 * NWN * BQ + 2 * BQ) * sizeof(float);
};

// s = Q K^T for the warp's UW units (m-tile m; n-tiles wn + i NW / MT) of a
// tile: GI chains of KG k-steps a unit at a time, each in a fresh
// accumulator, the chains joined in order by f32 adds. Q and K are swizzled tiles of pitch
// DMAX; the C layout holds rows g, g + 8 and columns 2t, 2t + 1 of each
// n-tile (mma index t mapped to column 2t, t + 4 to 2t + 1, flash_mma.cuh)
template <int DMAX>
__device__ __forceinline__ void scores(float (&s)[Cfg<DMAX>::UW][4], const float* sq, const float* sk, int m,
                                       int wn, int dqk) {
  using C = Cfg<DMAX>;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int r0 = 16 * m + g, s0 = sw(r0), s1 = sw(r0 + 8);
  const float* a0 = sq + r0 * DMAX + 2 * t;
  const float* a1 = a0 + 8 * DMAX;
  const float* br[C::UW];
  int sb[C::UW];
#pragma unroll
  for (int i = 0; i < C::UW; ++i) {
    const int row = 8 * (wn + i * (NW / C::MT)) + g;
    br[i] = sk + row * DMAX + 2 * t;
    sb[i] = sw(row);
#pragma unroll
    for (int e = 0; e < 4; ++e) s[i][e] = 0.f;
  }
#pragma unroll
  for (int g0 = 0; g0 < C::NGRP; g0 += C::GI) {
    float acc[C::GI][C::UW][4];
#pragma unroll
    for (int gi = 0; gi < C::GI; ++gi)
#pragma unroll
      for (int i = 0; i < C::UW; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[gi][i][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KG; ++kk)
#pragma unroll
      for (int gi = 0; gi < C::GI; ++gi) {
        const int ks = (g0 + gi) * KG + kk;
        if (g0 + gi < C::NGRP && 8 * ks < dqk) {
          const float2 x0 = *reinterpret_cast<const float2*>(a0 + 8 * (ks ^ s0));
          const float2 x1 = *reinterpret_cast<const float2*>(a1 + 8 * (ks ^ s1));
          uint32_t ab[4], as[4];
          split(x0.x, ab[0], as[0]);
          split(x1.x, ab[1], as[1]);
          split(x0.y, ab[2], as[2]);
          split(x1.y, ab[3], as[3]);
#pragma unroll
          for (int i = 0; i < C::UW; ++i) {
            const float2 kv = *reinterpret_cast<const float2*>(br[i] + 8 * (ks ^ sb[i]));
            mma3(acc[gi][i], ab, as, kv.x, kv.y);
          }
        }
      }
#pragma unroll
    for (int gi = 0; gi < C::GI; ++gi)
      if (g0 + gi < C::NGRP && 8 * (g0 + gi) * KG < dqk) {
#pragma unroll
        for (int i = 0; i < C::UW; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[i][e] += acc[gi][i][e];
      }
  }
}

// o = o * alpha + P V for the warp's PM m-tiles (from m-tile PM mg) and
// output n-tiles grp + NGW i below dv/8: P from shared memory (pitch LDP;
// its columns the NS k-steps), split once a tile; V a swizzled tile read
// down its rows (rows 8kk + 2t and 8kk + 2t + 1 at column 8n + g), each V
// fragment split once for the PM m-tiles; each n-tile's NS k-steps in a
// fresh accumulator
template <int DMAX>
__device__ __forceinline__ void pv(float (&o)[Cfg<DMAX>::NPW][Cfg<DMAX>::PM][4],
                                   const float (&alpha)[Cfg<DMAX>::PM][2], const float* sp, const float* sv,
                                   int mg, int grp, int dv) {
  using C = Cfg<DMAX>;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  // P's A fragments, k-step kk: (g, 2t), (g + 8, 2t), (g, 2t + 1), (g + 8, 2t + 1)
  uint32_t pb[C::PM][C::NS][4], ps[C::PM][C::NS][4];
#pragma unroll
  for (int pm = 0; pm < C::PM; ++pm) {
    const float* at = sp + (16 * (C::PM * mg + pm) + g) * C::LDP + 2 * t;
#pragma unroll
    for (int kk = 0; kk < C::NS; ++kk) {
      const float2 x0 = *reinterpret_cast<const float2*>(at + 8 * kk);
      const float2 x1 = *reinterpret_cast<const float2*>(at + 8 * C::LDP + 8 * kk);
      split(x0.x, pb[pm][kk][0], ps[pm][kk][0]);
      split(x1.x, pb[pm][kk][1], ps[pm][kk][1]);
      split(x0.y, pb[pm][kk][2], ps[pm][kk][2]);
      split(x1.y, pb[pm][kk][3], ps[pm][kk][3]);
    }
  }
  // sw of row 8kk + 2t + e is (s_e + 2kk) & 3
  const float* br = sv + 2 * t * DMAX + g;
  const int s_0 = sw(2 * t), s_1 = sw(2 * t + 1);
#pragma unroll
  for (int i = 0; i < C::NPW; ++i) {
    const int n = grp + C::NGW * i;
    if (8 * n < dv) {
      float acc[C::PM][4];
#pragma unroll
      for (int pm = 0; pm < C::PM; ++pm)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[pm][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < C::NS; ++kk) {
        const float* row = br + 8 * kk * DMAX;
        uint32_t bb0, bs0, bb1, bs1;
        split(row[8 * (n ^ ((s_0 + 2 * kk) & 3))], bb0, bs0);
        split(row[DMAX + 8 * (n ^ ((s_1 + 2 * kk) & 3))], bb1, bs1);
#pragma unroll
        for (int pm = 0; pm < C::PM; ++pm) mma3_split(acc[pm], pb[pm][kk], ps[pm][kk], bb0, bb1, bs0, bs1);
      }
#pragma unroll
      for (int pm = 0; pm < C::PM; ++pm)
#pragma unroll
        for (int e = 0; e < 4; ++e) o[i][pm][e] = fmaf(o[i][pm][e], alpha[pm][e >> 1], acc[pm][e]);
    }
  }
}

// the tile's maximum of row `row` from the score warps' partials, in order
template <int NWN, int BQ>
__device__ __forceinline__ float tile_max(const float* rmax, int row) {
  float x = rmax[row];
#pragma unroll
  for (int k = 1; k < NWN; ++k) x = fmaxf(x, rmax[k * BQ + row]);
  return x;
}

// the max a row's softmax shifts by: m, or 0 while the row has seen nothing
// (p = 0 and alpha = 0, never inf - inf)
__device__ __forceinline__ float shift(float m) { return m == -CUDART_INF_F ? 0.f : m; }

// One CTA per (BQ q rows, batch*head, split of the kv walk).
template <int DMAX>
__global__ void __launch_bounds__(NT, 1) heads_fwd_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    const float* __restrict__ bias, float* __restrict__ o, float* __restrict__ lse, float* __restrict__ part,
    int nq, int nkv, int h, int dqk, int dv, int causal, float sm_scale) {
  using C = Cfg<DMAX>;
  extern __shared__ float4 smem4[];
  float* sq = reinterpret_cast<float*>(smem4);  // the block's queries
  float* sk = sq + C::BQ * DMAX;                // the tile's keys
  float* sv = sk + C::TILE;                     // and values
  float* sp = sv + C::TILE;                     // P
  float* sbias = sp + C::BQ * C::LDP;           // bias buffers (by tile parity)
  float* rmax = sbias + 2 * C::BKV;             // partial row maxima (NWN x BQ)
  float* rsum = rmax + C::NWN * C::BQ;          // partial row sums
  float* sm = rsum + C::NWN * C::BQ;            // row maxima before the tile
  float* fl = sm + C::BQ;                       // row sums after the walk

  const int q0 = blockIdx.x * C::BQ, bh = blockIdx.y, z = blockIdx.z, nsplit = gridDim.z;
  const float* kh = k + (long)bh * nkv * dqk;
  const float* vh = v + (long)bh * nkv * dv;
  const float* brow = bias == nullptr ? nullptr : bias + (long)(bh / h) * nkv;

  // the block's visible kv tiles, then this split's contiguous share
  const int off = causal ? nkv - nq : NO_LIMIT;
  const int kv_end = causal ? max(0, min(nkv, min(q0 + C::BQ, nq) + off)) : nkv;
  const int n_tiles = (kv_end + C::BKV - 1) / C::BKV;
  const int per = (n_tiles + nsplit - 1) / nsplit;
  const int t_begin = min(n_tiles, z * per), t_end = min(n_tiles, t_begin + per);

  auto stage_k = [&](int tile, int u) {  // K and the bias row
    const int j0 = tile * C::BKV;
    stage_swizzled<DMAX, C::BKV, NT>(sk, kh, dqk, j0, nkv, dqk);
    if (threadIdx.x < C::BKV) {
      const int j = j0 + threadIdx.x;
      const bool ok = brow != nullptr && j < nkv;
      cp_async4(sbias + u * C::BKV + threadIdx.x, ok ? brow + j : kh, ok);
    }
  };
  stage_swizzled<DMAX, C::BQ, NT>(sq, q + (long)bh * nq * dqk, dqk, q0, nq, dqk);
  if (t_begin < t_end) stage_k(t_begin, 0);
  cp_commit();

  // scores: warp w takes m-tile w % MT and its n-tiles wn + i NW / MT;
  // P.V: m-tiles PM mg .. PM mg + PM - 1, n-tiles grp + NGW i
  const int tid = threadIdx.x, w = tid >> 5, g = (tid & 31) >> 2, t = tid & 3;
  const int m_t = w % C::MT, wn = w / C::MT;
  const int mg = w % C::MG, grp = w / C::MG;

  float acc[C::NPW][C::PM][4];
#pragma unroll
  for (int i = 0; i < C::NPW; ++i)
#pragma unroll
    for (int pm = 0; pm < C::PM; ++pm)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][pm][e] = 0.f;
  float m_row = -CUDART_INF_F, l_row = 0.f;  // row tid's running max and sum (tid < BQ)

  for (int tile = t_begin; tile < t_end; ++tile) {
    const int u = (tile - t_begin) & 1, j0 = tile * C::BKV;
    cp_wait<0>();
    __syncthreads();  // the tile's K in shared memory; every warp done with the previous tile
    if (tid < C::BQ) sm[tid] = m_row;
    stage_swizzled<DMAX, C::BKV, NT>(sv, vh, dv, j0, nkv, dv);  // V flies while the scores are computed
    cp_commit();

    // scores, scaled, biased and masked; the partial row maxima. Element e
    // of unit i: row 16 m_t + g + 8 (e >> 1), column 8 n_i + 2t + (e & 1)
    float s[C::UW][4];
    scores<DMAX>(s, sq, sk, m_t, wn, dqk);
    const float* bt = sbias + u * C::BKV;
    const bool full = j0 + C::BKV <= nkv && j0 + C::BKV - 1 <= q0 + off;
    float mx[2] = {-CUDART_INF_F, -CUDART_INF_F};
#pragma unroll
    for (int i = 0; i < C::UW; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = 8 * (wn + i * (NW / C::MT)) + 2 * t + (e & 1);
        float x = fmaf(s[i][e], sm_scale, bt[col]);
        if (!full) {
          const int j = j0 + col, qi = q0 + 16 * m_t + g + 8 * (e >> 1);
          if (!(j < nkv && j <= qi + off)) x = -CUDART_INF_F;
        }
        s[i][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      if (t == 0) rmax[wn * C::BQ + 16 * m_t + g + 8 * r] = mx[r];
    }
    __syncthreads();  // the partial maxima; every warp done with K
    if (tile + 1 < t_end) {  // the next tile's K flies during this one's P V
      stage_k(tile + 1, u ^ 1);
      cp_commit();
    }

    // p = exp(s - shift(m_new)) into P; the partial row sums
    float mu[2], psum[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = 16 * m_t + g + 8 * r;
      mu[r] = shift(fmaxf(sm[row], tile_max<C::NWN, C::BQ>(rmax, row)));
    }
#pragma unroll
    for (int i = 0; i < C::UW; ++i) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[i][e] = expf(s[i][e] - mu[e >> 1]);
        psum[e >> 1] += s[i][e];
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int at = (16 * m_t + g + 8 * r) * C::LDP + 8 * (wn + i * (NW / C::MT)) + 2 * t;
        *reinterpret_cast<float2*>(sp + at) = make_float2(s[i][2 * r], s[i][2 * r + 1]);
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      psum[r] += __shfl_xor_sync(0xffffffffu, psum[r], 1);
      psum[r] += __shfl_xor_sync(0xffffffffu, psum[r], 2);
      if (t == 0) rsum[wn * C::BQ + 16 * m_t + g + 8 * r] = psum[r];
    }
    if (tile + 1 < t_end) {
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();  // P, the partial sums and V

    float alpha[C::PM][2];
#pragma unroll
    for (int pm = 0; pm < C::PM; ++pm)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = 16 * (C::PM * mg + pm) + g + 8 * r;
        const float m_old = sm[row];
        alpha[pm][r] = expf(m_old - shift(fmaxf(m_old, tile_max<C::NWN, C::BQ>(rmax, row))));
      }
    pv<DMAX>(acc, alpha, sp, sv, mg, grp, dv);
    if (tid < C::BQ) {
      const float m_new = fmaxf(m_row, tile_max<C::NWN, C::BQ>(rmax, tid));
      float sum = rsum[tid];
#pragma unroll
      for (int k2 = 1; k2 < C::NWN; ++k2) sum += rsum[k2 * C::BQ + tid];
      l_row = l_row * expf(m_row - shift(m_new)) + sum;
      m_row = m_new;
    }
  }

  cp_wait<0>();  // (a CTA that walks no tile still has its Q in flight)
  __syncthreads();
  if (tid < C::BQ) fl[tid] = l_row;
  __syncthreads();
  // output rows (bh, i): normalized, or the unnormalized partial
  // (nsplit, B*H, Nq, Dv) of a split walk and its (m, l) pairs after them
  const long rows = (long)gridDim.y * nq;
  float* out = nsplit == 1 ? o : part + (long)z * rows * dv;
#pragma unroll
  for (int pm = 0; pm < C::PM; ++pm)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = 16 * (C::PM * mg + pm) + g + 8 * r, i = q0 + row;
      if (i >= nq) continue;
      const float inv = nsplit > 1 || fl[row] == 0.f ? 1.f : 1.f / fl[row];
      float* orow = out + ((long)bh * nq + i) * dv + 2 * t;
#pragma unroll
      for (int idx = 0; idx < C::NPW; ++idx) {
        const int n = grp + C::NGW * idx;
        if (8 * n < dv) store2(orow + 8 * n, acc[idx][pm][2 * r] * inv, acc[idx][pm][2 * r + 1] * inv);
      }
    }
  if (tid < C::BQ && q0 + tid < nq) {
    const long r = (long)bh * nq + q0 + tid;
    if (nsplit == 1) {
      lse[r] = m_row + logf(l_row == 0.f ? 1.f : l_row);
    } else {
      float* ml = part + (long)nsplit * rows * dv + 2 * ((long)z * rows + r);
      ml[0] = m_row;
      ml[1] = l_row;
    }
  }
}

template <int DMAX>
cudaError_t prepare() {
  return cudaFuncSetAttribute(heads_fwd_kernel<DMAX>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)Cfg<DMAX>::BYTES);
}

template <int DMAX>
cudaError_t launch(const float* q, const float* k, const float* v, const float* bias, float* o, float* lse,
                   float* part, int bh, int nq, int nkv, int h, int dqk, int dv, int causal, float sm_scale,
                   int nsplit, cudaStream_t stream) {
  using C = Cfg<DMAX>;
  cudaError_t err = prepare<DMAX>();
  if (err != cudaSuccess) return err;
  const dim3 grid((nq + C::BQ - 1) / C::BQ, bh, nsplit);
  heads_fwd_kernel<DMAX><<<grid, NT, C::BYTES, stream>>>(q, k, v, bias, o, lse, part, nq, nkv, h, dqk, dv, causal,
                                                         sm_scale);
  err = cudaGetLastError();
  if (err != cudaSuccess || nsplit == 1) return err;
  return pio::merge_splits(part, o, lse, (long)bh * nq, dv, nsplit, stream);
}

// K8's CTAs an SM (or minus a cudaError_t)
template <int DMAX>
int slots() {
  cudaError_t err = prepare<DMAX>();
  int n = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, heads_fwd_kernel<DMAX>, NT, Cfg<DMAX>::BYTES);
  return err == cudaSuccess ? n : -(int)err;
}

// ---------------------------------------------------------------------------
// bf16: K8's bf16 build
// ---------------------------------------------------------------------------
//
// The JAX kernel on bf16 operands: S = Q K^T takes bf16 products with f32
// sums (mma.sync m16n8k16 bf16, f32 accumulator), the online softmax and
// the row sums stay f32, p is rounded to bf16 once before P V (where JAX
// casts p to v's dtype), and P V sums in f32; the output is written in bf16
// and the logsumexp in f32. The walk, the barriers, the split of the score
// units and of the output columns over the 8 warps and the row statistics
// are the f32 build's (above); only the tiles and the products differ:
// - every operand tile is bf16 at pitch LD = DMAX + 8 elements, an odd
//   number of 16-byte units, so the eight rows of each 8x8 matrix that
//   ldmatrix reads fall on distinct banks, with or without .trans; rows
//   past the sequence and channels from d up to d rounded to 16 are staged
//   as zeros, so a head dim that is no multiple of 16 (the image CA's 264:
//   16 k-steps of 16 and one that is half zeros) takes whole k-steps;
// - the score product reads Q (A, ldmatrix.x4) and K (B, ldmatrix.x2)
//   along their rows; P goes through shared memory as bf16 (pitch BKV + 8,
//   odd in 16-byte units), read back as A fragments (ldmatrix.x4) and V as
//   B fragments down its rows (ldmatrix.x2.trans);
// - the split walk's partials stay f32 and the merge writes bf16.
// Shared memory: (BQ + 2 BKV) x LD + BQ x (BKV + 8) bf16 and the f32
// statistics, by bucket 64 / 128 / 256 / 288 (BKV 48): 32,128 / 52,608 /
// 93,568 / 103,808 bytes; 512 (BKV 16): 104,576 bytes.
// What bounds it at the image CA: 4 * 512 * 50176 * 264 = 27.1 GFLOP an
// image at the bf16 tensor-core rate against 53 MB of bf16 operands.

using bf16 = __nv_bfloat16;
using pio::mma::mma_bf16;
using pio::mma_bwd::ldmatrix_x2;
using pio::mma_bwd::ldmatrix_x2_trans;
using pio::mma_bwd::ldmatrix_x4;
using pio::mma_bwd::stage16;

template <int DMAX_>
struct Cfg16 {
  static constexpr int DMAX = DMAX_;
  static constexpr int BQ = 64;                           // q rows a CTA owns
  static constexpr int BKV = DMAX == 512 ? 16 : 48;       // kv rows of a walked tile
  static constexpr int MT = BQ / 16;                      // m-tiles
  static constexpr int NS = BKV / 8;                      // score n-tiles
  static constexpr int KS = BKV / 16;                     // P.V k-steps
  static constexpr int UNITS = MT * NS;                   // m16n8 units of a score tile
  static constexpr int UW = UNITS / NW;                   // units a score warp takes
  static constexpr int NWN = NW / MT;                     // score warps of an m-tile
  static constexpr int PM = 2;                            // m-tiles of a warp's P.V
  static constexpr int MG = MT / PM;                      // m-groups
  static constexpr int NGW = NW / MG;                     // warps an m-group
  static constexpr int NPW = (DMAX / 8 + NGW - 1) / NGW;  // output n-tiles a warp holds
  static constexpr int LD = DMAX + 8;                     // pitch of the operand tiles, in elements
  static constexpr int LDP = BKV + 8;                     // pitch of P
  static constexpr int TILE = BKV * LD;
  static constexpr size_t BYTES =
      (BQ * LD + 2 * TILE + BQ * LDP) * sizeof(bf16) + (2 * BKV + 2 * NWN * BQ + 2 * BQ) * sizeof(float);
};

// s = Q K^T for the warp's UW units (m-tile m; n-tiles wn + i NW / MT) of a
// tile, one f32 accumulator a unit over the k-steps below dqk
template <int DMAX>
__device__ __forceinline__ void scores16(float (&s)[Cfg16<DMAX>::UW][4], const bf16* sq, const bf16* sk, int m,
                                         int wn, int dqk) {
  using C = Cfg16<DMAX>;
  const int lane = threadIdx.x & 31;
  const bf16* ap = sq + (16 * m + (lane & 15)) * C::LD + 8 * (lane >> 4);
  const bf16* bp[C::UW];
#pragma unroll
  for (int i = 0; i < C::UW; ++i) {
    bp[i] = sk + (8 * (wn + i * (NW / C::MT)) + (lane & 7)) * C::LD + 8 * ((lane >> 3) & 1);
#pragma unroll
    for (int e = 0; e < 4; ++e) s[i][e] = 0.f;
  }
#pragma unroll
  for (int kk = 0; kk < DMAX / 16; ++kk) {
    if (16 * kk < dqk) {
      uint32_t a[4];
      ldmatrix_x4(a, ap + 16 * kk);
#pragma unroll
      for (int i = 0; i < C::UW; ++i) {
        uint32_t b[2];
        ldmatrix_x2(b, bp[i] + 16 * kk);
        mma_bf16(s[i], a, b[0], b[1]);
      }
    }
  }
}

// o = o * alpha + P V for the warp's PM m-tiles (from m-tile PM mg) and
// output n-tiles grp + NGW i below dv/8: P (bf16, pitch LDP) as A fragments,
// V read down its rows as B fragments; each n-tile's KS k-steps in a fresh
// accumulator
template <int DMAX>
__device__ __forceinline__ void pv16(float (&o)[Cfg16<DMAX>::NPW][Cfg16<DMAX>::PM][4],
                                     const float (&alpha)[Cfg16<DMAX>::PM][2], const bf16* sp, const bf16* sv,
                                     int mg, int grp, int dv) {
  using C = Cfg16<DMAX>;
  const int lane = threadIdx.x & 31;
  uint32_t pa[C::PM][C::KS][4];
#pragma unroll
  for (int pm = 0; pm < C::PM; ++pm)
#pragma unroll
    for (int kk = 0; kk < C::KS; ++kk)
      ldmatrix_x4(pa[pm][kk], sp + (16 * (C::PM * mg + pm) + (lane & 15)) * C::LDP + 16 * kk + 8 * (lane >> 4));
  const bf16* vl = sv + (lane & 15) * C::LD;
#pragma unroll
  for (int i = 0; i < C::NPW; ++i) {
    const int n = grp + C::NGW * i;
    if (8 * n < dv) {
      float acc[C::PM][4];
#pragma unroll
      for (int pm = 0; pm < C::PM; ++pm)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[pm][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < C::KS; ++kk) {
        uint32_t b[2];
        ldmatrix_x2_trans(b, vl + 16 * kk * C::LD + 8 * n);
#pragma unroll
        for (int pm = 0; pm < C::PM; ++pm) mma_bf16(acc[pm], pa[pm][kk], b[0], b[1]);
      }
#pragma unroll
      for (int pm = 0; pm < C::PM; ++pm)
#pragma unroll
        for (int e = 0; e < 4; ++e) o[i][pm][e] = fmaf(o[i][pm][e], alpha[pm][e >> 1], acc[pm][e]);
    }
  }
}

// One CTA per (BQ q rows, batch*head, split of the kv walk), as
// heads_fwd_kernel.
template <int DMAX>
__global__ void __launch_bounds__(NT, 1) heads_fwd_bf16_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    const float* __restrict__ bias, bf16* __restrict__ o, float* __restrict__ lse, float* __restrict__ part,
    int nq, int nkv, int h, int dqk, int dv, int causal, float sm_scale) {
  using C = Cfg16<DMAX>;
  extern __shared__ float4 smem4[];
  bf16* sq = reinterpret_cast<bf16*>(smem4);  // the block's queries
  bf16* sk = sq + C::BQ * C::LD;                 // the tile's keys
  bf16* sv = sk + C::TILE;                    // and values
  bf16* sp = sv + C::TILE;                    // P
  float* sbias = reinterpret_cast<float*>(sp + C::BQ * C::LDP);  // bias buffers (by tile parity)
  float* rmax = sbias + 2 * C::BKV;           // partial row maxima (NWN x BQ)
  float* rsum = rmax + C::NWN * C::BQ;        // partial row sums
  float* sm = rsum + C::NWN * C::BQ;          // row maxima before the tile
  float* fl = sm + C::BQ;                     // row sums after the walk

  const int q0 = blockIdx.x * C::BQ, bh = blockIdx.y, z = blockIdx.z, nsplit = gridDim.z;
  const bf16* kh = k + (long)bh * nkv * dqk;
  const bf16* vh = v + (long)bh * nkv * dv;
  const float* brow = bias == nullptr ? nullptr : bias + (long)(bh / h) * nkv;

  const int off = causal ? nkv - nq : NO_LIMIT;
  const int kv_end = causal ? max(0, min(nkv, min(q0 + C::BQ, nq) + off)) : nkv;
  const int n_tiles = (kv_end + C::BKV - 1) / C::BKV;
  const int per = (n_tiles + nsplit - 1) / nsplit;
  const int t_begin = min(n_tiles, z * per), t_end = min(n_tiles, t_begin + per);

  auto stage_k = [&](int tile, int u) {  // K and the bias row
    const int j0 = tile * C::BKV;
    stage16<C::LD, C::BKV, NT>(sk, kh, dqk, j0, nkv, dqk);
    if (threadIdx.x < C::BKV) {
      const int j = j0 + threadIdx.x;
      const bool ok = brow != nullptr && j < nkv;
      cp_async4(sbias + u * C::BKV + threadIdx.x, ok ? static_cast<const void*>(brow + j) : kh, ok);
    }
  };
  stage16<C::LD, C::BQ, NT>(sq, q + (long)bh * nq * dqk, dqk, q0, nq, dqk);
  if (t_begin < t_end) stage_k(t_begin, 0);
  cp_commit();

  const int tid = threadIdx.x, w = tid >> 5, g = (tid & 31) >> 2, t = tid & 3;
  const int m_t = w % C::MT, wn = w / C::MT;
  const int mg = w % C::MG, grp = w / C::MG;

  float acc[C::NPW][C::PM][4];
#pragma unroll
  for (int i = 0; i < C::NPW; ++i)
#pragma unroll
    for (int pm = 0; pm < C::PM; ++pm)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][pm][e] = 0.f;
  float m_row = -CUDART_INF_F, l_row = 0.f;  // row tid's running max and sum (tid < BQ)

  for (int tile = t_begin; tile < t_end; ++tile) {
    const int u = (tile - t_begin) & 1, j0 = tile * C::BKV;
    cp_wait<0>();
    __syncthreads();  // the tile's K in shared memory; every warp done with the previous tile
    if (tid < C::BQ) sm[tid] = m_row;
    stage16<C::LD, C::BKV, NT>(sv, vh, dv, j0, nkv, dv);  // V flies while the scores are computed
    cp_commit();

    float s[C::UW][4];
    scores16<DMAX>(s, sq, sk, m_t, wn, dqk);
    const float* bt = sbias + u * C::BKV;
    const bool full = j0 + C::BKV <= nkv && j0 + C::BKV - 1 <= q0 + off;
    float mx[2] = {-CUDART_INF_F, -CUDART_INF_F};
#pragma unroll
    for (int i = 0; i < C::UW; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = 8 * (wn + i * (NW / C::MT)) + 2 * t + (e & 1);
        float x = fmaf(s[i][e], sm_scale, bt[col]);
        if (!full) {
          const int j = j0 + col, qi = q0 + 16 * m_t + g + 8 * (e >> 1);
          if (!(j < nkv && j <= qi + off)) x = -CUDART_INF_F;
        }
        s[i][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      if (t == 0) rmax[wn * C::BQ + 16 * m_t + g + 8 * r] = mx[r];
    }
    __syncthreads();  // the partial maxima; every warp done with K
    if (tile + 1 < t_end) {  // the next tile's K flies during this one's P V
      stage_k(tile + 1, u ^ 1);
      cp_commit();
    }

    // p = exp(s - shift(m_new)) in f32: summed unrounded, stored to P in bf16
    float mu[2], psum[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = 16 * m_t + g + 8 * r;
      mu[r] = shift(fmaxf(sm[row], tile_max<C::NWN, C::BQ>(rmax, row)));
    }
#pragma unroll
    for (int i = 0; i < C::UW; ++i) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[i][e] = expf(s[i][e] - mu[e >> 1]);
        psum[e >> 1] += s[i][e];
      }
#pragma unroll
      for (int r = 0; r < 2; ++r)
        store2(sp + (16 * m_t + g + 8 * r) * C::LDP + 8 * (wn + i * (NW / C::MT)) + 2 * t, s[i][2 * r],
               s[i][2 * r + 1]);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      psum[r] += __shfl_xor_sync(0xffffffffu, psum[r], 1);
      psum[r] += __shfl_xor_sync(0xffffffffu, psum[r], 2);
      if (t == 0) rsum[wn * C::BQ + 16 * m_t + g + 8 * r] = psum[r];
    }
    if (tile + 1 < t_end) {
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();  // P, the partial sums and V

    float alpha[C::PM][2];
#pragma unroll
    for (int pm = 0; pm < C::PM; ++pm)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = 16 * (C::PM * mg + pm) + g + 8 * r;
        const float m_old = sm[row];
        alpha[pm][r] = expf(m_old - shift(fmaxf(m_old, tile_max<C::NWN, C::BQ>(rmax, row))));
      }
    pv16<DMAX>(acc, alpha, sp, sv, mg, grp, dv);
    if (tid < C::BQ) {
      const float m_new = fmaxf(m_row, tile_max<C::NWN, C::BQ>(rmax, tid));
      float sum = rsum[tid];
#pragma unroll
      for (int k2 = 1; k2 < C::NWN; ++k2) sum += rsum[k2 * C::BQ + tid];
      l_row = l_row * expf(m_row - shift(m_new)) + sum;
      m_row = m_new;
    }
  }

  cp_wait<0>();  // (a CTA that walks no tile still has its Q in flight)
  __syncthreads();
  if (tid < C::BQ) fl[tid] = l_row;
  __syncthreads();
  // output rows (bh, i): normalized in bf16, or the unnormalized f32
  // partial (nsplit, B*H, Nq, Dv) of a split walk and its (m, l) pairs
  const long rows = (long)gridDim.y * nq;
#pragma unroll
  for (int pm = 0; pm < C::PM; ++pm)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = 16 * (C::PM * mg + pm) + g + 8 * r, i = q0 + row;
      if (i >= nq) continue;
      const long at = ((long)bh * nq + i) * dv + 2 * t;
      const float inv = fl[row] == 0.f ? 1.f : 1.f / fl[row];
#pragma unroll
      for (int idx = 0; idx < C::NPW; ++idx) {
        const int n = grp + C::NGW * idx;
        if (8 * n >= dv) continue;
        if (nsplit == 1) {
          store2(o + at + 8 * n, acc[idx][pm][2 * r] * inv, acc[idx][pm][2 * r + 1] * inv);
        } else {
          store2(part + (long)z * rows * dv + at + 8 * n, acc[idx][pm][2 * r], acc[idx][pm][2 * r + 1]);
        }
      }
    }
  if (tid < C::BQ && q0 + tid < nq) {
    const long r = (long)bh * nq + q0 + tid;
    if (nsplit == 1) {
      lse[r] = m_row + logf(l_row == 0.f ? 1.f : l_row);
    } else {
      float* ml = part + (long)nsplit * rows * dv + 2 * ((long)z * rows + r);
      ml[0] = m_row;
      ml[1] = l_row;
    }
  }
}

template <int DMAX>
cudaError_t prepare16() {
  return cudaFuncSetAttribute(heads_fwd_bf16_kernel<DMAX>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)Cfg16<DMAX>::BYTES);
}

template <int DMAX>
cudaError_t launch16(const bf16* q, const bf16* k, const bf16* v, const float* bias, bf16* o, float* lse,
                     float* part, int bh, int nq, int nkv, int h, int dqk, int dv, int causal, float sm_scale,
                     int nsplit, cudaStream_t stream) {
  using C = Cfg16<DMAX>;
  cudaError_t err = prepare16<DMAX>();
  if (err != cudaSuccess) return err;
  const dim3 grid((nq + C::BQ - 1) / C::BQ, bh, nsplit);
  heads_fwd_bf16_kernel<DMAX><<<grid, NT, C::BYTES, stream>>>(q, k, v, bias, o, lse, part, nq, nkv, h, dqk, dv,
                                                              causal, sm_scale);
  err = cudaGetLastError();
  if (err != cudaSuccess || nsplit == 1) return err;
  return pio::merge_splits(part, o, lse, (long)bh * nq, dv, nsplit, stream);
}

template <int DMAX>
int slots16() {
  cudaError_t err = prepare16<DMAX>();
  int n = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, heads_fwd_bf16_kernel<DMAX>, NT, Cfg16<DMAX>::BYTES);
  return err == cudaSuccess ? n : -(int)err;
}

bool valid_dims(int dqk, int dv) {
  return dqk >= 8 && dv >= 8 && dqk % 8 == 0 && dv % 8 == 0 && dqk <= 512 && dv <= 512;
}

// the head-dim bucket a kernel is instantiated for
int bucket(int dqk, int dv) {
  const int d = dqk > dv ? dqk : dv;
  return d <= 64 ? 64 : d <= 128 ? 128 : d <= 256 ? 256 : d <= 288 ? 288 : 512;
}

}  // namespace

// q (BH, Nq, Dqk), k (BH, Nkv, Dqk), v (BH, Nkv, Dv), all f32 (dtype 0) or
// all bf16 (dtype 1), contiguous and 16-byte aligned, Dqk and Dv multiples
// of 8 up to 512; bias (BH / h, Nkv) f32 or null; o (BH, Nq, Dv) in the
// operands' dtype and lse (BH, Nq) f32; part: f32 scratch of
// nsplit * BH * Nq * (Dv + 2) floats when nsplit > 1, else unused. Returns a
// cudaError_t (0 = launched).
extern "C" int pio_flash_heads_fwd(const void* q, const void* k, const void* v, const float* bias, void* o,
                                   float* lse, float* part, int bh, int nq, int nkv, int h, int dqk, int dv,
                                   int causal, float sm_scale, int nsplit, int dtype, void* stream) {
  if (bh <= 0 || nq <= 0) return cudaSuccess;
  if (!valid_dims(dqk, dv) || nkv < 0 || h <= 0 || bh > 65535 || nsplit < 1 || nsplit > 65535 ||
      (nsplit > 1 && part == nullptr) || (dtype != pio::kF32 && dtype != pio::kBF16))
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == pio::kBF16) {
    const bf16 *q16 = static_cast<const bf16*>(q), *k16 = static_cast<const bf16*>(k),
               *v16 = static_cast<const bf16*>(v);
    bf16* o16 = static_cast<bf16*>(o);
    switch (bucket(dqk, dv)) {
      case 64: return launch16<64>(q16, k16, v16, bias, o16, lse, part, bh, nq, nkv, h, dqk, dv, causal, sm_scale,
                                   nsplit, s);
      case 128: return launch16<128>(q16, k16, v16, bias, o16, lse, part, bh, nq, nkv, h, dqk, dv, causal,
                                     sm_scale, nsplit, s);
      case 256: return launch16<256>(q16, k16, v16, bias, o16, lse, part, bh, nq, nkv, h, dqk, dv, causal,
                                     sm_scale, nsplit, s);
      case 288: return launch16<288>(q16, k16, v16, bias, o16, lse, part, bh, nq, nkv, h, dqk, dv, causal,
                                     sm_scale, nsplit, s);
      default: return launch16<512>(q16, k16, v16, bias, o16, lse, part, bh, nq, nkv, h, dqk, dv, causal,
                                    sm_scale, nsplit, s);
    }
  }
  const float *qf = static_cast<const float*>(q), *kf = static_cast<const float*>(k),
              *vf = static_cast<const float*>(v);
  float* of = static_cast<float*>(o);
  switch (bucket(dqk, dv)) {
    case 64: return launch<64>(qf, kf, vf, bias, of, lse, part, bh, nq, nkv, h, dqk, dv, causal, sm_scale, nsplit, s);
    case 128: return launch<128>(qf, kf, vf, bias, of, lse, part, bh, nq, nkv, h, dqk, dv, causal, sm_scale, nsplit,
                                 s);
    case 256: return launch<256>(qf, kf, vf, bias, of, lse, part, bh, nq, nkv, h, dqk, dv, causal, sm_scale, nsplit,
                                 s);
    case 288: return launch<288>(qf, kf, vf, bias, of, lse, part, bh, nq, nkv, h, dqk, dv, causal, sm_scale, nsplit,
                                 s);
    default: return launch<512>(qf, kf, vf, bias, of, lse, part, bh, nq, nkv, h, dqk, dv, causal, sm_scale, nsplit,
                                s);
  }
}

// K8's CTA slots an SM at these head dims and dtype on the current device
// (what its split rule counts), or minus a cudaError_t
extern "C" int pio_flash_heads_fwd_slots(int dqk, int dv, int dtype) {
  if (!valid_dims(dqk, dv) || (dtype != pio::kF32 && dtype != pio::kBF16)) return -(int)cudaErrorInvalidValue;
  const bool b16 = dtype == pio::kBF16;
  switch (bucket(dqk, dv)) {
    case 64: return b16 ? slots16<64>() : slots<64>();
    case 128: return b16 ? slots16<128>() : slots<128>();
    case 256: return b16 ? slots16<256>() : slots<256>();
    case 288: return b16 ? slots16<288>() : slots<288>();
    default: return b16 ? slots16<512>() : slots<512>();
  }
}
