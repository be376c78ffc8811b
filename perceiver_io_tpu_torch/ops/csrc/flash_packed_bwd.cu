// K4a + K4b: packed flash attention backward for Hopper (sm_90a), CUDA C++,
// f32, on the tensor cores.
//
// Replaces the TPU kernels perceiver_io_tpu/ops/flash_attention.py
// _dkv_packed_kernel (K4a) and _dq_packed_kernel (K4b), both reached from
// _flash_packed_bwd via the custom VJP of flash_attention_packed. Same
// function: P is recomputed from the forward's logsumexp,
// p_ij = exp(sm_scale * q_i.k_j + bias_j - lse_i), only where query i sees
// key j under the right-aligned causal limit j <= i + (nkv - nq) (elsewhere
// p is exactly 0: the mask sets the exponent to -inf before the exp, so a
// row that sees no key, lse -inf, gets a zero gradient and never an
// inf * 0); with delta_i = rowsum(dO_i * O_i) per head (computed by the
// wrapper, as the JAX package computes it outside its kernels):
//
//   dV_j += p_ij dO_i,  dS_ij = p_ij (dO_i.v_j - delta_i) sm_scale,
//   dK_j += dS_ij q_i,  dQ_i += dS_ij k_j.
//
// Two kernels, as on the TPU, so no output is written by two CTAs and no
// atomics are needed. K4b owns a block of q rows and walks the kv tiles its
// causal limit can see: S = Q K^T and dP = dO V^T, then dQ += dS K. K4a owns
// a block of kv rows and walks the q tiles that can see it, transposed:
// S^T = K Q^T and dP^T = V dO^T with its kv rows as M, then dV += P^T dO and
// dK += dS^T Q; lse and delta become per-column values, staged with each q
// tile, the bias a per-row value kept in registers.
//
// What bounds them: K4a does four products of 2 * D operations per visible
// (query, key) pair and K4b three, far above the card's operations-per-byte
// line, so arithmetic on the tensor cores (flash_mma_bwd.cuh): the score
// products S and dP (S^T and dP^T in K4a) and K4b's dQ += dS K in f64 by
// mma.sync m16n8k4, whose products are exact, and K4a's dV and dK
// split-TF32 by mma.sync m16n8k8 (each operand split into a TF32 big part
// and its residual, three mmas a product) at f32 accuracy. The bound counts
// every product at the split-TF32 rate, 165 TFLOP/s; mma.sync reaches a
// fraction of the rate that wgmma would (PERF.md). On an H100 a product in
// f64 by m16n8k4 (two mmas per 8 columns of depth) ran as fast as a
// split-TF32 one (three m16n8k8) or faster (PERF.md, PR 6).
//
// Accuracy: the kernels are held to the plain version evaluated in f64
// (chip_smoke.py), and to at least the accuracy of the plain version
// evaluated in f32, which comes within 2.1e-5 of it at the training shapes
// (|dQ| reaches 12 at the self-attentions).
//
// Tiles. A warp owns 16 rows (one m16 row block) of the CTA's block; the
// block's two operands that are read as A (Q and dO in K4b, K and V in K4a)
// stay in shared memory in f32 at pitch DMAX + 8 (converted to f64 at each
// fragment load); the walked tiles (K, V and the bias row in
// K4b; Q, dO, lse and delta in K4a) are double-buffered by cp.async, so
// tile t + 1 loads while tile t computes. Only the tiles that cross a
// warp's causal limit or the end of the rows pay for the mask. By head-dim
// bucket:
// - DMAX <= 64: 4 warps, 64-row blocks, 64-row walked tiles, ~101 KB of
//   shared memory: two CTAs an SM;
// - DMAX = 128: 8 warps, 128-row blocks, 32-row walked tiles, ~200 KB: one
//   CTA of 8 warps an SM, every walked tile shared by twice the rows (at 64
//   rows and 4 warps, the A operands alone take 68 KB, and two CTAs would
//   need 16-row tiles).
// K4a's registers at DMAX = 128 hold dK and dV (2 x 16 n-tiles x 4 floats),
// so its prod_ab joins 4 n-tiles at a time; K4b's hold dQ in f64 (16
// n-tiles x 4 doubles, 128 registers). No kernel spills (ptxas,
// chip_smoke.py).
//
// A head is a strided column slice of the packed rows (row stride H*D), so no
// transpose copy is made.

#include "flash_mma_bwd.cuh"

namespace {

using namespace pio::mma_bwd;
using pio::mma::cp_async4;
using pio::mma::cp_commit;
using pio::mma::cp_wait;
using pio::mma::NO_LIMIT;
using pio::mma::SMEM_PER_SM;

template <int DMAX_>
struct Dq {
  static constexpr int DMAX = DMAX_;
  static constexpr int NW = DMAX <= 64 ? 4 : 8;  // warps
  static constexpr int NT = 32 * NW;
  static constexpr int BQ = 16 * NW;                // q rows a CTA owns
  static constexpr int BKV = DMAX <= 64 ? 64 : 32;  // kv rows a walked tile
  static constexpr int NS = BKV / 8;
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
  static constexpr int NG = DMAX <= 64 ? DMAX / 8 : 4;  // dK and dV fill the registers at DMAX = 128
  static constexpr int LDA = DMAX + 8;
  static constexpr int A = BKV * LDA;   // K or V
  static constexpr int B = BQT * DMAX;  // one Q or dO buffer
  static constexpr size_t BYTES = (2 * A + 4 * B + 4 * BQT) * sizeof(float);
  static constexpr int MIN_BLOCKS = 2 * (BYTES + 1024) <= SMEM_PER_SM ? 2 : 1;
};

// K4b: one CTA per (BQ query rows, head, batch); walks the kv tiles up to
// the last one the block's causal limit can see.
template <int DMAX>
__global__ void __launch_bounds__(Dq<DMAX>::NT, Dq<DMAX>::MIN_BLOCKS) flash_bwd_dq_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    const float* __restrict__ dout, const float* __restrict__ lse, const float* __restrict__ delta,
    const float* __restrict__ bias, float* __restrict__ dq, int nq, int nkv, int h, int dqk, int dv,
    int causal, float sm_scale) {
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
  const float* kh = k + (long)b * nkv * row_qk + (long)head * dqk;
  const float* vh = v + (long)b * nkv * row_v + (long)head * dv;
  const float* brow = bias == nullptr ? nullptr : bias + (long)b * nkv;

  const int w = threadIdx.x >> 5, g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
  const int i0 = q0 + 16 * w + g;  // the lane's rows i0, i0 + 8
  const int off = causal ? nkv - nq : NO_LIMIT;
  const int kv_end = causal ? max(0, min(nkv, min(q0 + P::BQ, nq) + off)) : nkv;
  const int n_tiles = (kv_end + P::BKV - 1) / P::BKV;

  auto stage = [&](int tile, int u) {
    const int j0 = tile * P::BKV;
    stage_swizzled<DMAX, P::BKV, P::NT>(sk(u), kh, row_qk, j0, nkv, dqk);
    stage_swizzled<DMAX, P::BKV, P::NT>(sv(u), vh, row_v, j0, nkv, dv);
    if (threadIdx.x < P::BKV) {
      const int j = j0 + threadIdx.x;
      const bool ok = brow != nullptr && j < nkv;
      cp_async4(sb(u) + threadIdx.x, ok ? brow + j : kh, ok);
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
    const int j0 = tile * P::BKV;
    const bool full = j0 + P::BKV <= nkv && j0 + P::BKV - 1 <= q0 + 16 * w + off;
    const float* bt = sb(u);
    float p[NS][4], ds[NS][4];
    {
      double s[NS][4];
      prod_abt64<DMAX, P::LDA, NS>(s, qw, sk(u), dqk);
#pragma unroll
      for (int n = 0; n < NS; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = 8 * n + 2 * t + (e & 1), r = e >> 1;
          float x = (float)(s[n][e] * (double)sm_scale + (double)bt[c] - (double)lse_r[r]);
          if (!full) {
            const int j = j0 + c;
            if (!(j < nkv && j <= i0 + 8 * r + off)) x = -CUDART_INF_F;
          }
          p[n][e] = expf(x);
        }
    }
    // dS = p (dP - delta) sm_scale, dP - delta in f64
    {
      double dp[NS][4];
      prod_abt64<DMAX, P::LDA, NS>(dp, dow, sv(u), dv);
#pragma unroll
      for (int n = 0; n < NS; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) ds[n][e] = p[n][e] * (float)(dp[n][e] - (double)delta_r[e >> 1]) * sm_scale;
    }
    prod_ab64<DMAX, NS>(acc, ds, sk(u), dqk);
    __syncthreads();  // every warp is done with buffer u before it is refilled
  }
  store_rows<DMAX>(dq + (long)b * nq * row_qk + (long)head * dqk, row_qk, q0 + 16 * w, nq, dqk, acc);
}

// K4a: one CTA per (BKV kv rows, head, batch); walks the q tiles from the
// first one whose rows can see the block's first key.
template <int DMAX>
__global__ void __launch_bounds__(Dkv<DMAX>::NT, Dkv<DMAX>::MIN_BLOCKS) flash_bwd_dkv_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    const float* __restrict__ dout, const float* __restrict__ lse, const float* __restrict__ delta,
    const float* __restrict__ bias, float* __restrict__ dk, float* __restrict__ dvo, int nq, int nkv, int h,
    int dqk, int dv, int causal, float sm_scale) {
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

  const int j0 = blockIdx.x * P::BKV, head = blockIdx.y, b = blockIdx.z;
  const long row_qk = (long)h * dqk, row_v = (long)h * dv;
  const float* qh = q + (long)b * nq * row_qk + (long)head * dqk;
  const float* doh = dout + (long)b * nq * row_v + (long)head * dv;

  const int w = threadIdx.x >> 5, g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
  const int jw = j0 + 16 * w;  // the warp's first kv row; the lane's are jw + g, jw + g + 8
  // query i sees key j iff j <= i + off: rows below j0 - off see nothing of
  // this block
  const int off = causal ? nkv - nq : NO_LIMIT;
  int i_begin = causal ? max(0, j0 - off) : 0;
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
  stage_rows<P::LDA, P::BKV, P::NT>(sk, k + (long)b * nkv * row_qk + (long)head * dqk, row_qk, j0, nkv, dqk);
  stage_rows<P::LDA, P::BKV, P::NT>(sv, v + (long)b * nkv * row_v + (long)head * dv, row_v, j0, nkv, dv);
  float bias_r[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int j = jw + g + 8 * r;
    bias_r[r] = (bias != nullptr && j < nkv) ? bias[(long)b * nkv + j] : 0.f;
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
    const bool full = i0 + P::BQT <= nq && jw + 15 < nkv && jw + 15 <= i0 + off;
    const float *lt = slse(u), *dt = sdelta(u);
    // p: the exponent s + bias - lse in f64, -inf past the segment or the
    // causal limit
    float p[NS][4], ds[NS][4];
    {
      double st[NS][4];
      prod_abt64<DMAX, P::LDA, NS>(st, kw, sq(u), dqk);
#pragma unroll
      for (int n = 0; n < NS; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = 8 * n + 2 * t + (e & 1), r = e >> 1;
          float x = (float)(st[n][e] * (double)sm_scale + (double)bias_r[r] - (double)lt[c]);
          if (!full) {
            const int i = i0 + c, j = jw + g + 8 * r;
            if (!(i < nq && j < nkv && j <= i + off)) x = -CUDART_INF_F;
          }
          p[n][e] = expf(x);
        }
    }
    // dS^T = p (dP^T - delta) sm_scale, dP^T - delta in f64
    {
      double dpt[NS][4];
      prod_abt64<DMAX, P::LDA, NS>(dpt, vw, sdo(u), dv);
#pragma unroll
      for (int n = 0; n < NS; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = 8 * n + 2 * t + (e & 1);
          ds[n][e] = p[n][e] * (float)(dpt[n][e] - (double)dt[c]) * sm_scale;
        }
    }
    // each walked tile's dV and dK products a fresh split-TF32 accumulator
    prod_ab<DMAX, NS, P::NG>(acc_v, p, sdo(u), dv);
    prod_ab<DMAX, NS, P::NG>(acc_k, ds, sq(u), dqk);
    __syncthreads();
  }
  store_rows<DMAX>(dk + (long)b * nkv * row_qk + (long)head * dqk, row_qk, jw, nkv, dqk, acc_k);
  store_rows<DMAX>(dvo + (long)b * nkv * row_v + (long)head * dv, row_v, jw, nkv, dv, acc_v);
}

struct Args {
  const float *q, *k, *v, *dout, *lse, *delta, *bias;
  float *dq, *dk, *dv;
  int batch, nq, nkv, h, dqk, dv_, causal;
  float sm_scale;
  cudaStream_t stream;
};

template <int DMAX>
cudaError_t launch_dq(const Args& a) {
  using P = Dq<DMAX>;
  auto kernel = flash_bwd_dq_kernel<DMAX>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)P::BYTES);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.nq + P::BQ - 1) / P::BQ, a.h, a.batch);
  kernel<<<grid, P::NT, P::BYTES, a.stream>>>(a.q, a.k, a.v, a.dout, a.lse, a.delta, a.bias, a.dq, a.nq, a.nkv,
                                                a.h, a.dqk, a.dv_, a.causal, a.sm_scale);
  return cudaGetLastError();
}

template <int DMAX>
cudaError_t launch_dkv(const Args& a) {
  using P = Dkv<DMAX>;
  auto kernel = flash_bwd_dkv_kernel<DMAX>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)P::BYTES);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.nkv + P::BKV - 1) / P::BKV, a.h, a.batch);
  kernel<<<grid, P::NT, P::BYTES, a.stream>>>(a.q, a.k, a.v, a.dout, a.lse, a.delta, a.bias, a.dk, a.dv, a.nq,
                                                a.nkv, a.h, a.dqk, a.dv_, a.causal, a.sm_scale);
  return cudaGetLastError();
}

bool valid(const Args& a) {
  return a.dqk > 0 && a.dv_ > 0 && a.dqk % 8 == 0 && a.dv_ % 8 == 0 && a.dqk <= 128 && a.dv_ <= 128 &&
         a.nq >= 0 && a.nkv >= 0 && a.h <= 65535 && a.batch <= 65535;
}

// the head-dim bucket (32, 64 or 128) a kernel is instantiated for
int dmax_bucket(int dqk, int dv) {
  const int d = dqk > dv ? dqk : dv;
  return d <= 32 ? 32 : (d <= 64 ? 64 : 128);
}

}  // namespace

// q/dout (B, Nq, H*D), k/v (B, Nkv, H*D), all f32, contiguous and 16-byte
// aligned; lse/delta (B, Nq, H) f32; bias (B, Nkv) f32 or null. K4a writes dk
// (B, Nkv, H*Dqk) and dv (B, Nkv, H*Dv); K4b writes dq (B, Nq, H*Dqk). Each
// returns a cudaError_t (0 = launched).
extern "C" int pio_flash_packed_bwd_dkv(const float* q, const float* k, const float* v, const float* dout,
                                        const float* lse, const float* delta, const float* bias, float* dk,
                                        float* dv, int batch, int nq, int nkv, int h, int dqk, int dv_, int causal,
                                        float sm_scale, void* stream) {
  const Args a{q, k, v, dout, lse, delta, bias, nullptr, dk, dv, batch, nq, nkv, h, dqk, dv_, causal, sm_scale,
               static_cast<cudaStream_t>(stream)};
  if (batch <= 0 || nkv <= 0 || h <= 0) return cudaSuccess;
  if (!valid(a)) return cudaErrorInvalidValue;
  switch (dmax_bucket(a.dqk, a.dv_)) {
    case 32: return launch_dkv<32>(a);
    case 64: return launch_dkv<64>(a);
    default: return launch_dkv<128>(a);
  }
}

extern "C" int pio_flash_packed_bwd_dq(const float* q, const float* k, const float* v, const float* dout,
                                       const float* lse, const float* delta, const float* bias, float* dq, int batch,
                                       int nq, int nkv, int h, int dqk, int dv_, int causal, float sm_scale,
                                       void* stream) {
  const Args a{q, k, v, dout, lse, delta, bias, dq, nullptr, nullptr, batch, nq, nkv, h, dqk, dv_, causal,
               sm_scale, static_cast<cudaStream_t>(stream)};
  if (batch <= 0 || nq <= 0 || h <= 0) return cudaSuccess;
  if (!valid(a)) return cudaErrorInvalidValue;
  switch (dmax_bucket(a.dqk, a.dv_)) {
    case 32: return launch_dq<32>(a);
    case 64: return launch_dq<64>(a);
    default: return launch_dq<128>(a);
  }
}
