// K9a + K9b: heads-major flash attention backward for Hopper (sm_90a), CUDA
// C++, f32 and bf16 (their bf16 builds, heads_bwd_dkv_bf16_kernel and
// heads_bwd_dq_bf16_kernel, below the f32 ones), on the tensor cores.
//
// Replaces the TPU kernels perceiver_io_tpu/ops/flash_attention.py
// _dkv_kernel (K9a) and _dq_kernel (K9b), both reached from _flash_bwd via
// the custom VJP of flash_attention. Same function, on (B*H, N, D) operands:
// P is recomputed from the forward's logsumexp,
// p_ij = exp(sm_scale * q_i.k_j + bias_j - lse_i), only where query i sees
// key j under the optional right-aligned causal limit j <= i + (Nkv - Nq)
// (elsewhere p is exactly 0: the mask sets the exponent to -inf before the
// exp, so a row that sees no key, lse -inf, gets a zero gradient and never
// an inf * 0); with delta_i = rowsum(dO_i * O_i) (computed by the wrapper,
// as the JAX package computes it outside its kernels):
//
//   dV_j += p_ij dO_i,  dS_ij = p_ij (dO_i.v_j - delta_i) sm_scale,
//   dK_j += dS_ij q_i,  dQ_i += dS_ij k_j.
//
// What bounds them: at the image classifier's cross-attention (512 latents
// over 50176 pixels, one head of 264 channels) K9a does four products of
// 2 * 264 operations per (query, key) pair and K9b three, against ~0.2 GB of
// operands: arithmetic. Every product runs on the tensor cores in f64 by
// mma.sync m16n8k4 (flash_mma_bwd.cuh's dmma16), whose products of f32
// inputs are exact and whose sums are f64:
// - the score products S and dP (S^T and dP^T in K9a), as in K4, since
//   dS = p (dP - delta) amplifies a score error by |dP - delta| (up to ~90
//   at head dim 512); the exponent s + bias - lse and dP - delta stay in
//   f64, p is exp of the f32-rounded exponent corrected by the rounding's
//   residual (exp64), and dS is rounded to f32 once;
// - the gradient products dV += P^T dO, dK += dS^T Q and dQ += dS K, summed
//   in f64 over the whole walk and rounded to f32 once at the end.
// So the gradients carry no error of their own beyond the f32 roundings of
// p, dS and the output, and the kernels are held to the plain version
// evaluated in f64 and to no larger an error than the plain version in f32
// has from it (chip_smoke.py). On an H100 80GB HBM3 (700 W) this ran faster
// at the image CA than split-TF32 gradient products (three m16n8k8 TF32
// mmas a product, a fresh accumulator per walked tile), which also came out
// further from f64 than the f32 plain version at small head dims (PERF.md;
// tests/test_torch_flash_tf32.py models both).
//
// Why not K4's layout: its warps own 16 rows and hold a 16 x D gradient in
// registers, 2 x 33 n-tiles x 4 = 264 floats for K9a at D = 264, and K4
// keeps its two A operands at 64 rows and pitch D + 8 beside double-buffered
// walked tiles: 280 KB at D = 264. Here the score tiles are computed once
// per CTA, split over its 8 warps, and go through shared memory (P and dS,
// or P^T and dS^T), so the gradient products can split their output columns
// over the warps as well:
//
// - A CTA owns BO rows (K9a: kv rows, whose K and V stay; K9b: q rows, whose
//   Q and dO stay) and walks tiles of BW rows of the other side (K9a: Q, dO,
//   lse and delta; K9b: K, V and the bias), double-buffered by cp.async so
//   tile t + 1 loads while tile t computes.
// - Scores: warps 0-3 compute S (S^T in K9a) and warps 4-7 dP (dP^T), each
//   NSW of the tile's 8-column n-tiles of one 16-row m-tile, in f64. The S
//   warps write P to shared memory; after a barrier the dP warps read it
//   and write dS (K9b in place of P; K9a beside P^T).
// - Gradients: K9a's warps 0-3 dV += P^T dO and 4-7 dK += dS^T Q, K9b's 8
//   warps dQ += dS K; a warp takes one m-tile and every NG-th n-tile of the
//   output's columns, up to the real head dim (not the bucket's), from a
//   group offset: its accumulator is ceil(DMAX / 8 / NG) n-tiles of 4
//   doubles, 144 registers for K9a and 72 for K9b at the 288 bucket (K9a
//   uses 255 there without spilling: ptxas, chip_smoke.py).
//
// Shared memory (floats; every operand tile at pitch DMAX, a multiple of 32
// words, swizzled as flash_mma_bwd.cuh's walked tiles are: word c of row r
// at c ^ 8 sw(r), which serves the score products' float2 loads along the
// rows and the gradient products' scalar loads down the columns without
// bank conflicts): 2 BO x DMAX owned + 4 BW x DMAX walked + 2 BO x (BW + 8)
// for P and dS (pitch BW + 8 = 8 mod 32 for their float2 fragment loads) +
// 2 BO + 4 BW statistics. By the head-dim bucket of max(Dqk, Dv):
// - DMAX 64 / 128 / 256: BO = BW = 32, 55,296 / 109,312 / 207,616 bytes;
// - DMAX 288 (D 257-288: the image CA's 264 is 33 n-tiles, looped to 264):
//   BO = BW = 32, 232,192 bytes of the 232,448 a CTA may have;
// - DMAX 512 (D 289-512): BO = BW = 16, 200,064 bytes; the score phase
//   then has 2 m16n8 units a product, and two of each four warps idle.
// One CTA of 8 warps an SM from the 256 bucket up (K9b's split rule reads
// the count from the runtime, pio_flash_heads_bwd_dq_slots). K9a's 32-row
// kv blocks give 1568 CTAs an image at the image CA, each reading the
// image's Q and dO (1.1 MB) from L2. K9b's grid is B*H x ceil(Nq / BO) q
// blocks; where that leaves CTA slots idle the wrapper splits the kv walk
// across `nsplit` CTAs (grid z), each writing a partial dQ to scratch, and
// a second pass sums the partials in split order: no atomics, the same sum
// on every run. No output row is written by two CTAs.

#include "flash_mma_bwd.cuh"

namespace {

using pio::mma::cp_async4;
using pio::mma::cp_commit;
using pio::mma::cp_wait;
using pio::mma::NO_LIMIT;
using pio::mma::store2;
using pio::mma_bwd::dmma16;
using pio::mma_bwd::stage_swizzled;
using pio::mma_bwd::sw;

constexpr int NW = 8;  // warps
constexpr int NT = 32 * NW;

template <int DMAX_>
struct Cfg {
  static constexpr int DMAX = DMAX_;                 // pitch of every operand tile
  static constexpr int BO = DMAX <= 288 ? 32 : 16;   // rows a CTA owns
  static constexpr int BW = BO;                      // rows of a walked tile
  static constexpr int MT = BO / 16;                 // m-tiles of the owned rows
  static constexpr int NS = BW / 8;                  // score n-tiles; gradient k-steps
  static constexpr int UNITS = MT * NS;              // m16n8 units of one score product
  static constexpr int NSW = UNITS >= 4 ? UNITS / 4 : 1;  // n-tiles a score warp takes
  static constexpr int LDP = BW + 8;                 // pitch of P and dS
  static constexpr int OWN = BO * DMAX;
  static constexpr int TILE = BW * DMAX;
  static constexpr size_t BYTES = (2 * OWN + 4 * TILE + 2 * BO * LDP + 2 * BO + 4 * BW) * sizeof(float);
};

struct Args {
  const float *q, *k, *v, *dout, *lse, *delta, *bias;
  float *dq, *dk, *dv, *part;
  int bh, nq, nkv, h, dqk, dv_, causal;
  float sm_scale;
  int nsplit;
  cudaStream_t stream;
};

// c = A B^T in f64 on the tensor cores for m-tile m of a (a swizzled owned
// tile) and the n-tiles n0 .. n0 + NSW - 1 of b (a swizzled walked tile),
// depth d: the 8 columns of a k-step are two k = 4 products (column 2t as k
// index t, then 2t + 1), so each lane's fragments are float2 loads, and c
// has the m16n8 C layout (rows g, g + 8; columns 2t, 2t + 1 of each n-tile)
template <int DMAX, int NSW>
__device__ __forceinline__ void scores64(double (&c)[NSW][4], const float* a, const float* b, int m, int n0,
                                         int d) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int r0 = 16 * m + g, s0 = sw(r0), s1 = sw(r0 + 8);
  const float* a0 = a + r0 * DMAX + 2 * t;
  const float* a1 = a0 + 8 * DMAX;
  const float* br = b + (8 * n0 + g) * DMAX + 2 * t;
  int sb[NSW];
#pragma unroll
  for (int n = 0; n < NSW; ++n) {
    sb[n] = sw(8 * (n0 + n) + g);
#pragma unroll
    for (int e = 0; e < 4; ++e) c[n][e] = 0.0;
  }
#pragma unroll 4
  for (int kk = 0; kk < DMAX / 8; ++kk) {
    if (8 * kk < d) {
      const float2 x0 = *reinterpret_cast<const float2*>(a0 + 8 * (kk ^ s0));
      const float2 x1 = *reinterpret_cast<const float2*>(a1 + 8 * (kk ^ s1));
#pragma unroll
      for (int n = 0; n < NSW; ++n) {
        const float2 y = *reinterpret_cast<const float2*>(br + 8 * n * DMAX + 8 * (kk ^ sb[n]));
        dmma16(c[n], x0.x, x1.x, y.x);
        dmma16(c[n], x0.y, x1.y, y.y);
      }
    }
  }
}

// o[i] += A B in f64 on the tensor cores (exact products, f64 sums) for the
// n-tiles n = grp + NG i below d/8: A the rows of m-tile m of an f32 buffer
// of pitch LDP (P, dS, P^T or dS^T; its columns the NS k-steps), B a
// swizzled walked tile read down its rows. The 8 columns of a k-step are two
// k = 4 products: A's column 2t (B's row 8kk + 2t) as k index t, then 2t + 1,
// so A's fragments are float2 loads of rows g and g + 8 and B's are scalar
// loads of column 8n + g
template <int DMAX, int NS, int LDP, int NG, int NPW>
__device__ __forceinline__ void grad64(double (&o)[NPW][4], const float* a, const float* b, int m, int grp,
                                       int d) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  float2 x0[NS], x1[NS];
  const float* ar = a + (16 * m + g) * LDP + 2 * t;
#pragma unroll
  for (int kk = 0; kk < NS; ++kk) {
    x0[kk] = *reinterpret_cast<const float2*>(ar + 8 * kk);
    x1[kk] = *reinterpret_cast<const float2*>(ar + 8 * LDP + 8 * kk);
  }
  const float* br = b + 2 * t * DMAX + g;
  const int s_0 = sw(2 * t), s_1 = sw(2 * t + 1);
#pragma unroll
  for (int i = 0; i < NPW; ++i) {
    const int n = grp + NG * i;
    if (8 * n < d) {
#pragma unroll
      for (int kk = 0; kk < NS; ++kk) {
        const float* row = br + 8 * kk * DMAX;
        dmma16(o[i], x0[kk].x, x1[kk].x, row[8 * (n ^ ((s_0 + 2 * kk) & 3))]);
        dmma16(o[i], x0[kk].y, x1[kk].y, row[DMAX + 8 * (n ^ ((s_1 + 2 * kk) & 3))]);
      }
    }
  }
}

// the lane's rows r0 + g, r0 + g + 8 of a gradient (n-tiles grp + NG i) to
// a (n, d) row-major output, rows below n and columns below d
template <int NG, int NPW>
__device__ __forceinline__ void store_grad(float* out, int d, int r0, int n, int grp, const double (&o)[NPW][4]) {
  const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r0 + g + 8 * r;
    if (row >= n) continue;
#pragma unroll
    for (int i = 0; i < NPW; ++i) {
      const int c = 8 * (grp + NG * i);
      if (c < d) store2(out + (long)row * d + c + 2 * t, (float)o[i][2 * r], (float)o[i][2 * r + 1]);
    }
  }
}

template <int NPW>
__device__ __forceinline__ void zero(double (&o)[NPW][4]) {
#pragma unroll
  for (int i = 0; i < NPW; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[i][e] = 0;
}

// p = exp(x) for an exponent x in f64: expf of x rounded to f32, corrected
// by the rounding's residual, exp(x) = exp(xf) (1 + (x - xf)) to second
// order in x - xf, so the f32 rounding of x (up to 2^-24 |x| absolute, a
// relative error of p that grows with |x|) leaves p with expf's own error
__device__ __forceinline__ float exp64(double x) {
  const float xf = (float)x;
  const float p = expf(xf);
  return isinf(xf) ? p : fmaf(p, (float)(x - (double)xf), p);
}

// K9a: one CTA per (BO kv rows, batch*head); walks the q tiles from the
// first one whose rows can see the block's first key.
template <int DMAX>
__global__ void __launch_bounds__(NT, 1) heads_bwd_dkv_kernel(const Args a) {
  using C = Cfg<DMAX>;
  constexpr int NG = 4 / C::MT, NPW = (DMAX / 8 + NG - 1) / NG;
  extern __shared__ float4 smem4[];
  float* sk = reinterpret_cast<float*>(smem4);  // the block's keys
  float* sv = sk + C::OWN;                      // and values
  float* tiles = sv + C::OWN;                   // Q buffers, dO buffers
  float* spt = tiles + 4 * C::TILE;             // P^T (kv row x q row)
  float* sdst = spt + C::BO * C::LDP;           // dS^T
  float* sbias = sdst + C::BO * C::LDP;         // the block's bias
  float* stat = sbias + 2 * C::BO;              // lse buffers, delta buffers
  auto sq = [&](int u) { return tiles + u * C::TILE; };
  auto sdo = [&](int u) { return tiles + (2 + u) * C::TILE; };
  auto slse = [&](int u) { return stat + u * C::BW; };
  auto sdelta = [&](int u) { return stat + (2 + u) * C::BW; };

  const int dqk = a.dqk, dv = a.dv_, nq = a.nq, nkv = a.nkv;
  const int j0 = blockIdx.x * C::BO, bh = blockIdx.y;
  const float* qh = a.q + (long)bh * nq * dqk;
  const float* doh = a.dout + (long)bh * nq * dv;
  const float* lh = a.lse + (long)bh * nq;
  const float* dh = a.delta + (long)bh * nq;
  // query i sees key j iff j <= i + off: rows below j0 - off see nothing of
  // this block
  const int off = a.causal ? nkv - nq : NO_LIMIT;
  int i_begin = a.causal ? max(0, j0 - off) : 0;
  i_begin -= i_begin % C::BW;
  const int n_tiles = i_begin < nq ? (nq - i_begin + C::BW - 1) / C::BW : 0;

  auto stage = [&](int tile, int u) {
    const int i0 = i_begin + tile * C::BW;
    stage_swizzled<DMAX, C::BW, NT>(sq(u), qh, dqk, i0, nq, dqk);
    stage_swizzled<DMAX, C::BW, NT>(sdo(u), doh, dv, i0, nq, dv);
    if (threadIdx.x < C::BW) {
      const int i = i0 + threadIdx.x;
      const bool ok = i < nq;
      cp_async4(slse(u) + threadIdx.x, lh + (ok ? i : 0), ok);
      cp_async4(sdelta(u) + threadIdx.x, dh + (ok ? i : 0), ok);
    }
  };
  stage_swizzled<DMAX, C::BO, NT>(sk, a.k + (long)bh * nkv * dqk, dqk, j0, nkv, dqk);
  stage_swizzled<DMAX, C::BO, NT>(sv, a.v + (long)bh * nkv * dv, dv, j0, nkv, dv);
  if (threadIdx.x < C::BO) {
    const int j = j0 + threadIdx.x;
    sbias[threadIdx.x] = (a.bias != nullptr && j < nkv) ? a.bias[(long)(bh / a.h) * nkv + j] : 0.f;
  }
  if (n_tiles > 0) stage(0, 0);
  cp_commit();

  // scores: warps 0-3 S^T = K Q^T, 4-7 dP^T = V dO^T; NSW n-tiles of one
  // m-tile a warp. Gradients: warps 0-3 dV += P^T dO, 4-7 dK += dS^T Q; one
  // m-tile and every NG-th n-tile a warp
  const int w = threadIdx.x >> 5, g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
  const int prod = w >> 2, unit = (w & 3) * C::NSW;
  const bool scoring = unit < C::UNITS;
  const int sm = unit / C::NS, sn = unit % C::NS;
  const int gm = (w & 3) % C::MT, grp = (w & 3) / C::MT;
  const int dgrad = prod == 0 ? dv : dqk;

  double acc[NPW][4];
  zero(acc);
  float pv[C::NSW][4];     // P (S warps)
  double dpd[C::NSW][4];   // dP^T - delta (dP warps)
  for (int tile = 0; tile < n_tiles; ++tile) {
    const int u = tile & 1;
    if (tile + 1 < n_tiles) {
      stage(tile + 1, u ^ 1);
      cp_commit();
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();  // tile (and the block's K and V) in shared memory for every warp

    // element e of n-tile n: kv row 16sm + g + 8(e >> 1), q column
    // 8(sn + n) + 2t + (e & 1)
    const int i0 = i_begin + tile * C::BW;
    const bool full = i0 + C::BW <= nq && j0 + C::BO <= nkv && j0 + C::BO - 1 <= i0 + off;
    if (scoring) {
      double c[C::NSW][4];
      if (prod == 0) {
        scores64<DMAX, C::NSW>(c, sk, sq(u), sm, sn, dqk);
        const float* lt = slse(u);
#pragma unroll
        for (int n = 0; n < C::NSW; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int col = 8 * (sn + n) + 2 * t + (e & 1), row = 16 * sm + g + 8 * (e >> 1);
            // the exponent s + bias - lse in f64, -inf past the rows or the causal limit
            double x = c[n][e] * (double)a.sm_scale + (double)sbias[row] - (double)lt[col];
            if (!full) {
              const int i = i0 + col, j = j0 + row;
              if (!(i < nq && j < nkv && j <= i + off)) x = -CUDART_INF;
            }
            pv[n][e] = exp64(x);
          }
#pragma unroll
        for (int n = 0; n < C::NSW; ++n)
#pragma unroll
          for (int r = 0; r < 2; ++r)
            store2(spt + (16 * sm + g + 8 * r) * C::LDP + 8 * (sn + n) + 2 * t, pv[n][2 * r], pv[n][2 * r + 1]);
      } else {
        scores64<DMAX, C::NSW>(c, sv, sdo(u), sm, sn, dv);
        const float* dt = sdelta(u);
#pragma unroll
        for (int n = 0; n < C::NSW; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) dpd[n][e] = c[n][e] - (double)dt[8 * (sn + n) + 2 * t + (e & 1)];
      }
    }
    __syncthreads();  // P^T in shared memory
    if (scoring && prod == 1) {
      // dS^T = p (dP^T - delta) sm_scale in f64, rounded once
#pragma unroll
      for (int n = 0; n < C::NSW; ++n)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int at = (16 * sm + g + 8 * r) * C::LDP + 8 * (sn + n) + 2 * t;
          const float2 p = *reinterpret_cast<const float2*>(spt + at);
          store2(sdst + at, (float)(p.x * dpd[n][2 * r] * a.sm_scale), (float)(p.y * dpd[n][2 * r + 1] * a.sm_scale));
        }
    }
    __syncthreads();  // dS^T in shared memory
    grad64<DMAX, C::NS, C::LDP, NG, NPW>(acc, prod == 0 ? spt : sdst, prod == 0 ? sdo(u) : sq(u), gm, grp, dgrad);
    __syncthreads();  // every warp is done with buffer u, P^T and dS^T before they are refilled
  }
  if (prod == 0) {
    store_grad<NG, NPW>(a.dv + (long)bh * nkv * dv, dv, j0 + 16 * gm, nkv, grp, acc);
  } else {
    store_grad<NG, NPW>(a.dk + (long)bh * nkv * dqk, dqk, j0 + 16 * gm, nkv, grp, acc);
  }
}

// K9b: one CTA per (BO q rows, batch*head, split of the kv walk); walks the
// kv tiles up to the last one the block's causal limit can see.
template <int DMAX>
__global__ void __launch_bounds__(NT, 1) heads_bwd_dq_kernel(const Args a) {
  using C = Cfg<DMAX>;
  constexpr int NG = NW / C::MT, NPW = (DMAX / 8 + NG - 1) / NG;
  extern __shared__ float4 smem4[];
  float* sq = reinterpret_cast<float*>(smem4);  // the block's queries
  float* sdo = sq + C::OWN;                     // and output gradients
  float* tiles = sdo + C::OWN;                  // K buffers, V buffers
  float* sds = tiles + 4 * C::TILE;             // P, then dS in place (q row x kv row)
  float* slse = sds + 2 * C::BO * C::LDP;       // the block's lse
  float* sdelta = slse + C::BO;                 // and delta
  float* sbias = sdelta + C::BO;                // bias buffers
  auto sk = [&](int u) { return tiles + u * C::TILE; };
  auto sv = [&](int u) { return tiles + (2 + u) * C::TILE; };
  auto sb = [&](int u) { return sbias + u * C::BW; };

  const int dqk = a.dqk, dv = a.dv_, nq = a.nq, nkv = a.nkv;
  const int q0 = blockIdx.x * C::BO, bh = blockIdx.y, z = blockIdx.z, nsplit = gridDim.z;
  const float* kh = a.k + (long)bh * nkv * dqk;
  const float* vh = a.v + (long)bh * nkv * dv;
  const float* brow = a.bias == nullptr ? nullptr : a.bias + (long)(bh / a.h) * nkv;
  const int off = a.causal ? nkv - nq : NO_LIMIT;
  const int kv_end = a.causal ? max(0, min(nkv, min(q0 + C::BO, nq) + off)) : nkv;
  const int n_tiles = (kv_end + C::BW - 1) / C::BW;
  const int per = (n_tiles + nsplit - 1) / nsplit;
  const int t_begin = min(n_tiles, z * per), t_end = min(n_tiles, t_begin + per);

  auto stage = [&](int tile, int u) {
    const int j0 = tile * C::BW;
    stage_swizzled<DMAX, C::BW, NT>(sk(u), kh, dqk, j0, nkv, dqk);
    stage_swizzled<DMAX, C::BW, NT>(sv(u), vh, dv, j0, nkv, dv);
    if (threadIdx.x < C::BW) {
      const int j = j0 + threadIdx.x;
      const bool ok = brow != nullptr && j < nkv;
      cp_async4(sb(u) + threadIdx.x, ok ? brow + j : kh, ok);
    }
  };
  stage_swizzled<DMAX, C::BO, NT>(sq, a.q + (long)bh * nq * dqk, dqk, q0, nq, dqk);
  stage_swizzled<DMAX, C::BO, NT>(sdo, a.dout + (long)bh * nq * dv, dv, q0, nq, dv);
  if (threadIdx.x < C::BO) {
    const int i = q0 + threadIdx.x;
    slse[threadIdx.x] = i < nq ? a.lse[(long)bh * nq + i] : 0.f;
    sdelta[threadIdx.x] = i < nq ? a.delta[(long)bh * nq + i] : 0.f;
  }
  if (t_begin < t_end) stage(t_begin, 0);
  cp_commit();

  // scores: warps 0-3 S = Q K^T, 4-7 dP = dO V^T, NSW n-tiles of one m-tile
  // a warp; the gradient dQ += dS K: one m-tile and every NG-th n-tile a warp
  const int w = threadIdx.x >> 5, g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
  const int prod = w >> 2, unit = (w & 3) * C::NSW;
  const bool scoring = unit < C::UNITS;
  const int sm = unit / C::NS, sn = unit % C::NS;
  const int gm = w % C::MT, grp = w / C::MT;

  double acc[NPW][4];
  zero(acc);
  float pv[C::NSW][4];    // P (S warps)
  double dpd[C::NSW][4];  // dP - delta (dP warps)
  for (int tile = t_begin; tile < t_end; ++tile) {
    const int u = (tile - t_begin) & 1;
    if (tile + 1 < t_end) {
      stage(tile + 1, u ^ 1);
      cp_commit();
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();

    // element e of n-tile n: q row 16sm + g + 8(e >> 1), kv column
    // 8(sn + n) + 2t + (e & 1)
    const int j0 = tile * C::BW;
    const bool full = j0 + C::BW <= nkv && j0 + C::BW - 1 <= q0 + off;
    if (scoring) {
      double c[C::NSW][4];
      if (prod == 0) {
        scores64<DMAX, C::NSW>(c, sq, sk(u), sm, sn, dqk);
        const float* bt = sb(u);
#pragma unroll
        for (int n = 0; n < C::NSW; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int col = 8 * (sn + n) + 2 * t + (e & 1), row = 16 * sm + g + 8 * (e >> 1);
            double x = c[n][e] * (double)a.sm_scale + (double)bt[col] - (double)slse[row];
            if (!full) {
              const int i = q0 + row, j = j0 + col;
              if (!(j < nkv && j <= i + off)) x = -CUDART_INF;
            }
            pv[n][e] = exp64(x);
          }
#pragma unroll
        for (int n = 0; n < C::NSW; ++n)
#pragma unroll
          for (int r = 0; r < 2; ++r)
            store2(sds + (16 * sm + g + 8 * r) * C::LDP + 8 * (sn + n) + 2 * t, pv[n][2 * r], pv[n][2 * r + 1]);
      } else {
        scores64<DMAX, C::NSW>(c, sdo, sv(u), sm, sn, dv);
#pragma unroll
        for (int n = 0; n < C::NSW; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) dpd[n][e] = c[n][e] - (double)sdelta[16 * sm + g + 8 * (e >> 1)];
      }
    }
    __syncthreads();  // P in shared memory
    if (scoring && prod == 1) {
      // dS = p (dP - delta) sm_scale in f64, rounded once, in place of P
#pragma unroll
      for (int n = 0; n < C::NSW; ++n)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          float* at = sds + (16 * sm + g + 8 * r) * C::LDP + 8 * (sn + n) + 2 * t;
          const float2 p = *reinterpret_cast<const float2*>(at);
          store2(at, (float)(p.x * dpd[n][2 * r] * a.sm_scale), (float)(p.y * dpd[n][2 * r + 1] * a.sm_scale));
        }
    }
    __syncthreads();  // dS in shared memory
    grad64<DMAX, C::NS, C::LDP, NG, NPW>(acc, sds, sk(u), gm, grp, dqk);
    __syncthreads();
  }
  float* out = nsplit == 1 ? a.dq : a.part + (long)z * gridDim.y * nq * dqk;
  store_grad<NG, NPW>(out + (long)bh * nq * dqk, dqk, q0 + 16 * gm, nq, grp, acc);
}

// dq (f32, or bf16 for the bf16 build) = the sum of the splits' f32
// partials, in split order
template <typename T>
__global__ void __launch_bounds__(256) heads_dq_reduce_kernel(const float4* __restrict__ part, T* __restrict__ dq,
                                                              long n4, int nsplit) {
  for (long idx = (long)blockIdx.x * blockDim.x + threadIdx.x; idx < n4; idx += (long)gridDim.x * blockDim.x) {
    float4 s = part[idx];
    for (int z = 1; z < nsplit; ++z) {
      const float4 x = part[z * n4 + idx];
      s.x += x.x;
      s.y += x.y;
      s.z += x.z;
      s.w += x.w;
    }
    pio::store4(dq + 4 * idx, s);
  }
}

// the second pass of a split K9b walk
template <typename T>
cudaError_t reduce_dq(const float* part, T* dq, long elems, int nsplit, cudaStream_t stream) {
  const long n4 = elems / 4;
  const long blocks = (n4 + 255) / 256;
  heads_dq_reduce_kernel<<<(unsigned)(blocks < 4096 ? blocks : 4096), 256, 0, stream>>>(
      reinterpret_cast<const float4*>(part), dq, n4, nsplit);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bf16: K9a's and K9b's bf16 builds
// ---------------------------------------------------------------------------
//
// The JAX kernels on bf16 operands: every product takes bf16 operands and
// sums in f32 (mma.sync m16n8k16 bf16, f32 accumulator); p is recomputed in
// f32 from the score product and the f32 logsumexp; dS = p (dP - delta)
// sm_scale in f32 from the unrounded p; p is rounded to bf16 before
// dV += P^T dO and dS before dK += dS^T Q and dQ += dS K, where the JAX
// kernels cast them to the operands' dtype. The gradients are written in
// bf16 (K9b's split partials stay f32 and the reduce writes bf16). No f64:
// the bf16 roundings of p and dS, not the products, set the gradients'
// error.
//
// The layout is the f32 build's (above): a CTA owns BO rows and walks tiles
// of BW rows of the other side, double-buffered by cp.async, and its 8
// warps share every product. What differs:
// - every operand tile is bf16 at pitch LD = DMAX + 8 elements, an odd
//   number of 16-byte units, so the rows of each 8x8 matrix that ldmatrix
//   reads fall on distinct banks, with or without .trans; rows past the
//   sequence and channels from d up to d rounded to 16 are staged as zeros,
//   so a head dim that is no multiple of 16 (the image CA's 264) takes
//   whole k-steps of 16;
// - scores: each of the tile's m16n8 units goes to one warp (8 units at
//   BO = BW = 32; 2 at the 512 bucket, where six warps wait), which computes
//   both its S (S^T in K9a) and its dP (dP^T) tile, the two accumulator
//   chains interleaved, and writes bf16(P) (K9a) and bf16(dS) to shared
//   memory (pitch BW + 8, odd in 16-byte units): no f32 P crosses warps;
// - gradients: A fragments of P^T, dS^T or dS by ldmatrix.x4, B fragments
//   of the walked tile down its rows by ldmatrix.x2.trans; a warp takes one
//   m-tile and every NG-th n-tile up to the real head dim, each walked
//   tile's product into a fresh f32 accumulator added to the gradient.
// Shared memory: (2 BO + 4 BW) x LD + 2 BO x (BW + 8) bf16 and the f32
// statistics, by bucket 64 / 128 / 256 / 288: 33,536 / 58,112 / 107,264 /
// 119,552 bytes; 512 (BO = BW = 16): 101,760 bytes.

using bf16 = __nv_bfloat16;
using pio::mma::mma_bf16;
using pio::mma_bwd::ldmatrix_x2;
using pio::mma_bwd::ldmatrix_x2_trans;
using pio::mma_bwd::ldmatrix_x4;
using pio::mma_bwd::stage16;

template <int DMAX_>
struct Cfg16 {
  static constexpr int DMAX = DMAX_;
  static constexpr int BO = DMAX <= 288 ? 32 : 16;  // rows a CTA owns
  static constexpr int BW = BO;                     // rows of a walked tile
  static constexpr int MT = BO / 16;                // m-tiles of the owned rows
  static constexpr int NS = BW / 8;                 // score n-tiles
  static constexpr int KS = BW / 16;                // gradient k-steps
  static constexpr int UNITS = MT * NS;             // m16n8 units of a score tile, one a warp
  static constexpr int LD = DMAX + 8;               // pitch of the operand tiles, in elements
  static constexpr int LDP = BW + 8;                // pitch of P and dS
  static constexpr int OWN = BO * LD;
  static constexpr int TILE = BW * LD;
  static constexpr size_t BYTES =
      (2 * OWN + 4 * TILE + 2 * BO * LDP) * sizeof(bf16) + (2 * BO + 4 * BW) * sizeof(float);
  static_assert(UNITS <= NW, "one score unit a warp");
};

struct Args16 {
  const bf16 *q, *k, *v, *dout;
  const float *lse, *delta, *bias;
  bf16 *dq, *dk, *dv;
  float* part;
  int bh, nq, nkv, h, dqk, dv_, causal;
  float sm_scale;
  int nsplit;
  cudaStream_t stream;
};

// c = A B^T and e = X Y^T for one m16n8 unit each (m-tile m of the owned
// tiles a and x, n-tile n of the walked tiles b and y; depths da and dx),
// the two accumulator chains interleaved
template <int DMAX>
__device__ __forceinline__ void units16(float (&c)[4], const bf16* a, const bf16* b, int da, float (&e)[4],
                                        const bf16* x, const bf16* y, int dx, int m, int n) {
  constexpr int LD = Cfg16<DMAX>::LD;
  const int lane = threadIdx.x & 31;
  const int ra = (16 * m + (lane & 15)) * LD + 8 * (lane >> 4);
  const int rb = (8 * n + (lane & 7)) * LD + 8 * ((lane >> 3) & 1);
#pragma unroll
  for (int i = 0; i < 4; ++i) c[i] = e[i] = 0.f;
#pragma unroll
  for (int kk = 0; kk < DMAX / 16; ++kk) {
    uint32_t af[4], bf[2];
    if (16 * kk < da) {
      ldmatrix_x4(af, a + ra + 16 * kk);
      ldmatrix_x2(bf, b + rb + 16 * kk);
      mma_bf16(c, af, bf[0], bf[1]);
    }
    if (16 * kk < dx) {
      ldmatrix_x4(af, x + ra + 16 * kk);
      ldmatrix_x2(bf, y + rb + 16 * kk);
      mma_bf16(e, af, bf[0], bf[1]);
    }
  }
}

// o[i] += A B for the n-tiles n = grp + NG i below d/8: A the rows of
// m-tile m of a bf16 buffer of pitch LDP (P^T, dS^T or dS; its columns the
// KS k-steps), B a walked tile read down its rows; each n-tile's product
// into a fresh accumulator added to o
template <int DMAX, int NG, int NPW>
__device__ __forceinline__ void grad16(float (&o)[NPW][4], const bf16* a, const bf16* b, int m, int grp, int d) {
  using C = Cfg16<DMAX>;
  const int lane = threadIdx.x & 31;
  uint32_t af[C::KS][4];
#pragma unroll
  for (int kk = 0; kk < C::KS; ++kk)
    ldmatrix_x4(af[kk], a + (16 * m + (lane & 15)) * C::LDP + 16 * kk + 8 * (lane >> 4));
  const bf16* bl = b + (lane & 15) * C::LD;
#pragma unroll
  for (int i = 0; i < NPW; ++i) {
    const int n = grp + NG * i;
    if (8 * n < d) {
      float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int kk = 0; kk < C::KS; ++kk) {
        uint32_t bf[2];
        ldmatrix_x2_trans(bf, bl + 16 * kk * C::LD + 8 * n);
        mma_bf16(acc, af[kk], bf[0], bf[1]);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) o[i][e] += acc[e];
    }
  }
}

// the lane's rows r0 + g, r0 + g + 8 of a gradient (n-tiles grp + NG i) to
// a (n, d) row-major output (bf16, or a split's f32 partial), rows below n
// and columns below d
template <int NG, int NPW, typename T>
__device__ __forceinline__ void store_grad16(T* out, int d, int r0, int n, int grp, const float (&o)[NPW][4]) {
  const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r0 + g + 8 * r;
    if (row >= n) continue;
#pragma unroll
    for (int i = 0; i < NPW; ++i) {
      const int c = 8 * (grp + NG * i);
      if (c < d) store2(out + (long)row * d + c + 2 * t, o[i][2 * r], o[i][2 * r + 1]);
    }
  }
}

// K9a, bf16: one CTA per (BO kv rows, batch*head), as heads_bwd_dkv_kernel.
template <int DMAX>
__global__ void __launch_bounds__(NT, 1) heads_bwd_dkv_bf16_kernel(const Args16 a) {
  using C = Cfg16<DMAX>;
  constexpr int NG = 4 / C::MT, NPW = (DMAX / 8 + NG - 1) / NG;
  extern __shared__ float4 smem4[];
  bf16* sk = reinterpret_cast<bf16*>(smem4);  // the block's keys
  bf16* sv = sk + C::OWN;                     // and values
  bf16* tiles = sv + C::OWN;                  // Q buffers, dO buffers
  bf16* spt = tiles + 4 * C::TILE;            // bf16(P^T) (kv row x q row)
  bf16* sdst = spt + C::BO * C::LDP;          // bf16(dS^T)
  float* sbias = reinterpret_cast<float*>(sdst + C::BO * C::LDP);  // the block's bias
  float* stat = sbias + 2 * C::BO;            // lse buffers, delta buffers
  auto sq = [&](int u) { return tiles + u * C::TILE; };
  auto sdo = [&](int u) { return tiles + (2 + u) * C::TILE; };
  auto slse = [&](int u) { return stat + u * C::BW; };
  auto sdelta = [&](int u) { return stat + (2 + u) * C::BW; };

  const int dqk = a.dqk, dv = a.dv_, nq = a.nq, nkv = a.nkv;
  const int j0 = blockIdx.x * C::BO, bh = blockIdx.y;
  const bf16* qh = a.q + (long)bh * nq * dqk;
  const bf16* doh = a.dout + (long)bh * nq * dv;
  const float* lh = a.lse + (long)bh * nq;
  const float* dh = a.delta + (long)bh * nq;
  const int off = a.causal ? nkv - nq : NO_LIMIT;
  int i_begin = a.causal ? max(0, j0 - off) : 0;
  i_begin -= i_begin % C::BW;
  const int n_tiles = i_begin < nq ? (nq - i_begin + C::BW - 1) / C::BW : 0;

  auto stage = [&](int tile, int u) {
    const int i0 = i_begin + tile * C::BW;
    stage16<C::LD, C::BW, NT>(sq(u), qh, dqk, i0, nq, dqk);
    stage16<C::LD, C::BW, NT>(sdo(u), doh, dv, i0, nq, dv);
    if (threadIdx.x < C::BW) {
      const int i = i0 + threadIdx.x;
      const bool ok = i < nq;
      cp_async4(slse(u) + threadIdx.x, lh + (ok ? i : 0), ok);
      cp_async4(sdelta(u) + threadIdx.x, dh + (ok ? i : 0), ok);
    }
  };
  stage16<C::LD, C::BO, NT>(sk, a.k + (long)bh * nkv * dqk, dqk, j0, nkv, dqk);
  stage16<C::LD, C::BO, NT>(sv, a.v + (long)bh * nkv * dv, dv, j0, nkv, dv);
  if (threadIdx.x < C::BO) {
    const int j = j0 + threadIdx.x;
    sbias[threadIdx.x] = (a.bias != nullptr && j < nkv) ? a.bias[(long)(bh / a.h) * nkv + j] : 0.f;
  }
  if (n_tiles > 0) stage(0, 0);
  cp_commit();

  // scores: warp w < UNITS takes unit (kv m-tile w / NS, q n-tile w % NS) of
  // S^T = K Q^T and dP^T = V dO^T. Gradients: warps 0-3 dV += P^T dO, 4-7
  // dK += dS^T Q; one m-tile and every NG-th n-tile a warp
  const int w = threadIdx.x >> 5, g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
  const bool scoring = w < C::UNITS;
  const int sm = w / C::NS, sn = w % C::NS;
  const int prod = w >> 2, gm = (w & 3) % C::MT, grp = (w & 3) / C::MT;
  const int dgrad = prod == 0 ? dv : dqk;

  float acc[NPW][4];
#pragma unroll
  for (int i = 0; i < NPW; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][e] = 0.f;
  for (int tile = 0; tile < n_tiles; ++tile) {
    const int u = tile & 1;
    if (tile + 1 < n_tiles) {
      stage(tile + 1, u ^ 1);
      cp_commit();
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();  // tile (and the block's K and V) in shared memory for every warp

    // element e: kv row 16 sm + g + 8 (e >> 1), q column 8 sn + 2t + (e & 1)
    const int i0 = i_begin + tile * C::BW;
    const bool full = i0 + C::BW <= nq && j0 + C::BO <= nkv && j0 + C::BO - 1 <= i0 + off;
    if (scoring) {
      float st[4], dpt[4], p[4], ds[4];
      units16<DMAX>(st, sk, sq(u), dqk, dpt, sv, sdo(u), dv, sm, sn);
      const float *lt = slse(u), *dt = sdelta(u);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = 8 * sn + 2 * t + (e & 1), row = 16 * sm + g + 8 * (e >> 1);
        float x = fmaf(st[e], a.sm_scale, sbias[row]) - lt[col];
        if (!full) {
          const int i = i0 + col, j = j0 + row;
          if (!(i < nq && j < nkv && j <= i + off)) x = -CUDART_INF_F;
        }
        p[e] = expf(x);
        ds[e] = p[e] * (dpt[e] - dt[col]) * a.sm_scale;
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int at = (16 * sm + g + 8 * r) * C::LDP + 8 * sn + 2 * t;
        store2(spt + at, p[2 * r], p[2 * r + 1]);
        store2(sdst + at, ds[2 * r], ds[2 * r + 1]);
      }
    }
    __syncthreads();  // bf16(P^T) and bf16(dS^T) in shared memory
    grad16<DMAX, NG, NPW>(acc, prod == 0 ? spt : sdst, prod == 0 ? sdo(u) : sq(u), gm, grp, dgrad);
    __syncthreads();  // every warp is done with buffer u, P^T and dS^T before they are refilled
  }
  cp_wait<0>();  // no copy left in flight (an empty walk staged K and V alone)
  if (prod == 0) {
    store_grad16<NG, NPW>(a.dv + (long)bh * nkv * dv, dv, j0 + 16 * gm, nkv, grp, acc);
  } else {
    store_grad16<NG, NPW>(a.dk + (long)bh * nkv * dqk, dqk, j0 + 16 * gm, nkv, grp, acc);
  }
}

// K9b, bf16: one CTA per (BO q rows, batch*head, split of the kv walk), as
// heads_bwd_dq_kernel.
template <int DMAX>
__global__ void __launch_bounds__(NT, 1) heads_bwd_dq_bf16_kernel(const Args16 a) {
  using C = Cfg16<DMAX>;
  constexpr int NG = NW / C::MT, NPW = (DMAX / 8 + NG - 1) / NG;
  extern __shared__ float4 smem4[];
  bf16* sq = reinterpret_cast<bf16*>(smem4);  // the block's queries
  bf16* sdo = sq + C::OWN;                    // and output gradients
  bf16* tiles = sdo + C::OWN;                 // K buffers, V buffers
  bf16* sds = tiles + 4 * C::TILE;            // bf16(dS) (q row x kv row)
  float* slse = reinterpret_cast<float*>(sds + 2 * C::BO * C::LDP);  // the block's lse
  float* sdelta = slse + C::BO;               // and delta
  float* sbias = sdelta + C::BO;              // bias buffers
  auto sk = [&](int u) { return tiles + u * C::TILE; };
  auto sv = [&](int u) { return tiles + (2 + u) * C::TILE; };
  auto sb = [&](int u) { return sbias + u * C::BW; };

  const int dqk = a.dqk, dv = a.dv_, nq = a.nq, nkv = a.nkv;
  const int q0 = blockIdx.x * C::BO, bh = blockIdx.y, z = blockIdx.z, nsplit = gridDim.z;
  const bf16* kh = a.k + (long)bh * nkv * dqk;
  const bf16* vh = a.v + (long)bh * nkv * dv;
  const float* brow = a.bias == nullptr ? nullptr : a.bias + (long)(bh / a.h) * nkv;
  const int off = a.causal ? nkv - nq : NO_LIMIT;
  const int kv_end = a.causal ? max(0, min(nkv, min(q0 + C::BO, nq) + off)) : nkv;
  const int n_tiles = (kv_end + C::BW - 1) / C::BW;
  const int per = (n_tiles + nsplit - 1) / nsplit;
  const int t_begin = min(n_tiles, z * per), t_end = min(n_tiles, t_begin + per);

  auto stage = [&](int tile, int u) {
    const int j0 = tile * C::BW;
    stage16<C::LD, C::BW, NT>(sk(u), kh, dqk, j0, nkv, dqk);
    stage16<C::LD, C::BW, NT>(sv(u), vh, dv, j0, nkv, dv);
    if (threadIdx.x < C::BW) {
      const int j = j0 + threadIdx.x;
      const bool ok = brow != nullptr && j < nkv;
      cp_async4(sb(u) + threadIdx.x, ok ? static_cast<const void*>(brow + j) : kh, ok);
    }
  };
  stage16<C::LD, C::BO, NT>(sq, a.q + (long)bh * nq * dqk, dqk, q0, nq, dqk);
  stage16<C::LD, C::BO, NT>(sdo, a.dout + (long)bh * nq * dv, dv, q0, nq, dv);
  if (threadIdx.x < C::BO) {
    const int i = q0 + threadIdx.x;
    slse[threadIdx.x] = i < nq ? a.lse[(long)bh * nq + i] : 0.f;
    sdelta[threadIdx.x] = i < nq ? a.delta[(long)bh * nq + i] : 0.f;
  }
  if (t_begin < t_end) stage(t_begin, 0);
  cp_commit();

  // scores: warp w < UNITS takes unit (q m-tile w / NS, kv n-tile w % NS)
  // of S = Q K^T and dP = dO V^T; the gradient dQ += dS K: one m-tile and
  // every NG-th n-tile a warp
  const int w = threadIdx.x >> 5, g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
  const bool scoring = w < C::UNITS;
  const int sm = w / C::NS, sn = w % C::NS;
  const int gm = w % C::MT, grp = w / C::MT;

  float acc[NPW][4];
#pragma unroll
  for (int i = 0; i < NPW; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][e] = 0.f;
  for (int tile = t_begin; tile < t_end; ++tile) {
    const int u = (tile - t_begin) & 1;
    if (tile + 1 < t_end) {
      stage(tile + 1, u ^ 1);
      cp_commit();
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();

    // element e: q row 16 sm + g + 8 (e >> 1), kv column 8 sn + 2t + (e & 1)
    const int j0 = tile * C::BW;
    const bool full = j0 + C::BW <= nkv && j0 + C::BW - 1 <= q0 + off;
    if (scoring) {
      float s[4], dp[4], ds[4];
      units16<DMAX>(s, sq, sk(u), dqk, dp, sdo, sv(u), dv, sm, sn);
      const float* bt = sb(u);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = 8 * sn + 2 * t + (e & 1), row = 16 * sm + g + 8 * (e >> 1);
        float x = fmaf(s[e], a.sm_scale, bt[col]) - slse[row];
        if (!full) {
          const int i = q0 + row, j = j0 + col;
          if (!(j < nkv && j <= i + off)) x = -CUDART_INF_F;
        }
        ds[e] = expf(x) * (dp[e] - sdelta[row]) * a.sm_scale;
      }
#pragma unroll
      for (int r = 0; r < 2; ++r)
        store2(sds + (16 * sm + g + 8 * r) * C::LDP + 8 * sn + 2 * t, ds[2 * r], ds[2 * r + 1]);
    }
    __syncthreads();  // bf16(dS) in shared memory
    grad16<DMAX, NG, NPW>(acc, sds, sk(u), gm, grp, dqk);
    __syncthreads();
  }
  cp_wait<0>();
  if (nsplit == 1) {
    store_grad16<NG, NPW>(a.dq + (long)bh * nq * dqk, dqk, q0 + 16 * gm, nq, grp, acc);
  } else {
    store_grad16<NG, NPW>(a.part + ((long)z * gridDim.y + bh) * nq * dqk, dqk, q0 + 16 * gm, nq, grp, acc);
  }
}

template <typename Kernel>
cudaError_t prepare(Kernel kernel, size_t smem) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

template <int DMAX>
cudaError_t launch_dkv(const Args& a) {
  using C = Cfg<DMAX>;
  auto kernel = heads_bwd_dkv_kernel<DMAX>;
  cudaError_t err = prepare(kernel, C::BYTES);
  if (err != cudaSuccess) return err;
  kernel<<<dim3((a.nkv + C::BO - 1) / C::BO, a.bh), NT, C::BYTES, a.stream>>>(a);
  return cudaGetLastError();
}

template <int DMAX>
cudaError_t launch_dq(const Args& a) {
  using C = Cfg<DMAX>;
  auto kernel = heads_bwd_dq_kernel<DMAX>;
  cudaError_t err = prepare(kernel, C::BYTES);
  if (err != cudaSuccess) return err;
  kernel<<<dim3((a.nq + C::BO - 1) / C::BO, a.bh, a.nsplit), NT, C::BYTES, a.stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess || a.nsplit == 1) return err;
  return reduce_dq(a.part, a.dq, (long)a.bh * a.nq * a.dqk, a.nsplit, a.stream);
}

// K9b's CTAs an SM (or minus a cudaError_t)
template <int DMAX>
int dq_slots() {
  using C = Cfg<DMAX>;
  auto kernel = heads_bwd_dq_kernel<DMAX>;
  cudaError_t err = prepare(kernel, C::BYTES);
  int n = 0;
  if (err == cudaSuccess) err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, NT, C::BYTES);
  return err == cudaSuccess ? n : -(int)err;
}

template <int DMAX>
cudaError_t launch_dkv16(const Args16& a) {
  using C = Cfg16<DMAX>;
  auto kernel = heads_bwd_dkv_bf16_kernel<DMAX>;
  cudaError_t err = prepare(kernel, C::BYTES);
  if (err != cudaSuccess) return err;
  kernel<<<dim3((a.nkv + C::BO - 1) / C::BO, a.bh), NT, C::BYTES, a.stream>>>(a);
  return cudaGetLastError();
}

template <int DMAX>
cudaError_t launch_dq16(const Args16& a) {
  using C = Cfg16<DMAX>;
  auto kernel = heads_bwd_dq_bf16_kernel<DMAX>;
  cudaError_t err = prepare(kernel, C::BYTES);
  if (err != cudaSuccess) return err;
  kernel<<<dim3((a.nq + C::BO - 1) / C::BO, a.bh, a.nsplit), NT, C::BYTES, a.stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess || a.nsplit == 1) return err;
  return reduce_dq(a.part, a.dq, (long)a.bh * a.nq * a.dqk, a.nsplit, a.stream);
}

template <int DMAX>
int dq_slots16() {
  using C = Cfg16<DMAX>;
  auto kernel = heads_bwd_dq_bf16_kernel<DMAX>;
  cudaError_t err = prepare(kernel, C::BYTES);
  int n = 0;
  if (err == cudaSuccess) err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, NT, C::BYTES);
  return err == cudaSuccess ? n : -(int)err;
}

bool valid_dims(int dqk, int dv) {
  return dqk >= 8 && dv >= 8 && dqk % 8 == 0 && dv % 8 == 0 && dqk <= 512 && dv <= 512;
}

template <typename A>
bool valid(const A& a) {
  return valid_dims(a.dqk, a.dv_) && a.nq >= 0 && a.nkv >= 0 && a.h > 0 && a.bh <= 65535;
}

// the head-dim bucket a kernel is instantiated for
int bucket(int dqk, int dv) {
  const int d = dqk > dv ? dqk : dv;
  return d <= 64 ? 64 : d <= 128 ? 128 : d <= 256 ? 256 : d <= 288 ? 288 : 512;
}

}  // namespace

// q/dout (BH, Nq, D), k/v (BH, Nkv, D), all f32 (dtype 0) or all bf16
// (dtype 1), contiguous and 16-byte aligned, D multiples of 8 up to 512;
// lse/delta (BH, Nq) f32; bias (BH / h, Nkv) f32 or null. K9a writes dk
// (BH, Nkv, Dqk) and dv (BH, Nkv, Dv); K9b writes dq (BH, Nq, Dqk), through
// part (nsplit * BH * Nq * Dqk floats of scratch) when nsplit > 1; the
// gradients in the operands' dtype. Each returns a cudaError_t
// (0 = launched).
extern "C" int pio_flash_heads_bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
                                       const float* lse, const float* delta, const float* bias, void* dk, void* dv,
                                       int bh, int nq, int nkv, int h, int dqk, int dv_, int causal, float sm_scale,
                                       int dtype, void* stream) {
  if (bh <= 0 || nkv <= 0) return cudaSuccess;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == pio::kBF16) {
    const Args16 a{static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
                   static_cast<const bf16*>(dout), lse, delta, bias, nullptr, static_cast<bf16*>(dk),
                   static_cast<bf16*>(dv), nullptr, bh, nq, nkv, h, dqk, dv_, causal, sm_scale, 1, s};
    if (!valid(a)) return cudaErrorInvalidValue;
    switch (bucket(dqk, dv_)) {
      case 64: return launch_dkv16<64>(a);
      case 128: return launch_dkv16<128>(a);
      case 256: return launch_dkv16<256>(a);
      case 288: return launch_dkv16<288>(a);
      default: return launch_dkv16<512>(a);
    }
  }
  const Args a{static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
               static_cast<const float*>(dout), lse, delta, bias, nullptr, static_cast<float*>(dk),
               static_cast<float*>(dv), nullptr, bh, nq, nkv, h, dqk, dv_, causal, sm_scale, 1, s};
  if (!valid(a) || dtype != pio::kF32) return cudaErrorInvalidValue;
  switch (bucket(dqk, dv_)) {
    case 64: return launch_dkv<64>(a);
    case 128: return launch_dkv<128>(a);
    case 256: return launch_dkv<256>(a);
    case 288: return launch_dkv<288>(a);
    default: return launch_dkv<512>(a);
  }
}

extern "C" int pio_flash_heads_bwd_dq(const void* q, const void* k, const void* v, const void* dout,
                                      const float* lse, const float* delta, const float* bias, void* dq, float* part,
                                      int bh, int nq, int nkv, int h, int dqk, int dv_, int causal, float sm_scale,
                                      int nsplit, int dtype, void* stream) {
  if (bh <= 0 || nq <= 0) return cudaSuccess;
  if (nsplit < 1 || nsplit > 65535 || (nsplit > 1 && part == nullptr)) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == pio::kBF16) {
    const Args16 a{static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
                   static_cast<const bf16*>(dout), lse, delta, bias, static_cast<bf16*>(dq), nullptr, nullptr, part,
                   bh, nq, nkv, h, dqk, dv_, causal, sm_scale, nsplit, s};
    if (!valid(a)) return cudaErrorInvalidValue;
    switch (bucket(dqk, dv_)) {
      case 64: return launch_dq16<64>(a);
      case 128: return launch_dq16<128>(a);
      case 256: return launch_dq16<256>(a);
      case 288: return launch_dq16<288>(a);
      default: return launch_dq16<512>(a);
    }
  }
  const Args a{static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
               static_cast<const float*>(dout), lse, delta, bias, static_cast<float*>(dq), nullptr, nullptr, part, bh,
               nq, nkv, h, dqk, dv_, causal, sm_scale, nsplit, s};
  if (!valid(a) || dtype != pio::kF32) return cudaErrorInvalidValue;
  switch (bucket(dqk, dv_)) {
    case 64: return launch_dq<64>(a);
    case 128: return launch_dq<128>(a);
    case 256: return launch_dq<256>(a);
    case 288: return launch_dq<288>(a);
    default: return launch_dq<512>(a);
  }
}

// K9b's CTA slots an SM at these head dims and dtype on the current device
// (what its split rule counts), or minus a cudaError_t
extern "C" int pio_flash_heads_bwd_dq_slots(int dqk, int dv, int dtype) {
  if (!valid_dims(dqk, dv) || (dtype != pio::kF32 && dtype != pio::kBF16)) return -(int)cudaErrorInvalidValue;
  const bool b16 = dtype == pio::kBF16;
  switch (bucket(dqk, dv)) {
    case 64: return b16 ? dq_slots16<64>() : dq_slots<64>();
    case 128: return b16 ? dq_slots16<128>() : dq_slots<128>();
    case 256: return b16 ? dq_slots16<256>() : dq_slots<256>();
    case 288: return b16 ? dq_slots16<288>() : dq_slots<288>();
    default: return b16 ? dq_slots16<512>() : dq_slots<512>();
  }
}
