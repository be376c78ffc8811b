// K9a + K9b: heads-major flash attention backward for Hopper (sm_90a), plain
// CUDA C++, f32.
//
// Replaces the TPU kernels perceiver_io_tpu/ops/flash_attention.py
// _dkv_kernel (K9a) and _dq_kernel (K9b), both reached from _flash_bwd via
// the custom VJP of flash_attention. Same function, on (B*H, N, D) operands:
// P is recomputed from the forward's logsumexp,
// p_ij = exp(sm_scale * q_i.k_j + bias_j - lse_i), only where query i sees
// key j under the optional right-aligned causal limit j <= i + (Nkv - Nq)
// (elsewhere p is exactly 0); with delta_i = rowsum(dO_i * O_i) (computed by
// the wrapper, as the JAX package computes it outside its kernels):
//
//   dV_j += p_ij dO_i,  dS_ij = p_ij (dO_i.v_j - delta_i) sm_scale,
//   dK_j += dS_ij q_i,  dQ_i += dS_ij k_j.
//
// What bounds them: at the image classifier's cross-attention (512 latents
// over 50176 pixels, one head of 264 channels) K9a does four products of
// 2 * 264 operations per (query, key) pair, 54 GFLOP per image, and K9b three,
// 41 GFLOP, against ~0.2 GB of operands: bound by arithmetic, on the CUDA
// cores (f32). The design follows K8 (flash_heads.cu) for the width:
//
// - K9a: one CTA per 32 kv rows, whose K and V rows stay in shared memory;
//   it walks the q tiles (64 rows) that can see them, staging each tile's
//   Q and dO in 64-column chunks twice (once for S and dP, once for
//   dK += dS^T Q and dV += P^T dO, with P^T and dS^T in shared memory). The
//   dK and dV rows (2 x 32 x D) stay in registers as DMAX / 64 float4 chunks
//   per thread: 32-row blocks keep them there, and give 1568 CTAs an image.
// - K9b: one CTA per 64 q rows walks 32-row kv tiles, all four operands in
//   64-column chunks, dQ in registers. Its grid has K8's shortage of CTAs
//   (8 q blocks per image), so the kv walk is split across `nsplit` CTAs
//   (grid z, chosen by the wrapper), each writing a partial dQ to scratch; a
//   second pass sums the partials in split order: no atomics, the same sum
//   on every run.
//
// No output row is written by two CTAs.

#include "flash_heads.cuh"

namespace {

using namespace pio::heads;

constexpr int BQ = 64;         // query rows of a q tile (K9a) or block (K9b)
constexpr int KB = 32;         // kv rows of a kv block (K9a) or tile (K9b)
constexpr int LDT = BQ + 4;    // row stride of P^T / dS^T (kv row x q row)
constexpr int LDS = KB + 4;    // row stride of dS (q row x kv row)

struct Args {
  const float *q, *k, *v, *dout, *lse, *delta, *bias;
  float *dq, *dk, *dv, *part;
  int bh, nq, nkv, h, dqk, dv_, causal;
  float sm_scale;
  int nsplit;
  cudaStream_t stream;
};

// p and dS of one (q row ty + 16e, kv row tx + 16f) pair
__device__ __forceinline__ void p_ds(float s, float dp, float bias, float lse, float delta, bool visible,
                                     float sm_scale, float& p, float& ds) {
  p = visible ? expf(s * sm_scale + bias - lse) : 0.f;
  ds = p * (dp - delta) * sm_scale;
}

// K9a: one CTA per (32 kv rows, batch*head)
template <int DMAX>
__global__ void __launch_bounds__(NT, 1) heads_bwd_dkv_kernel(const Args a) {
  constexpr int CH = Chunks<DMAX>::N;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int dqk = a.dqk, dv = a.dv_, nq = a.nq, nkv = a.nkv;
  const int ldk = dqk + 4, ldv = dv + 4;
  float* sk = smem;              // KB x ldk: the block's keys
  float* sv = sk + KB * ldk;     // KB x ldv: the block's values
  float* sc = sv + KB * ldv;     // BQ x LDC: a column chunk of Q or dO
  float* spt = sc + BQ * LDC;    // KB x LDT: P^T
  float* sdst = spt + KB * LDT;  // KB x LDT: dS^T
  float* slse = sdst + KB * LDT;
  float* sdelta = slse + BQ;

  const int j0 = blockIdx.x * KB, bh = blockIdx.y;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const float* qh = a.q + (long)bh * nq * dqk;
  const float* doh = a.dout + (long)bh * nq * dv;
  stage<KB>(sk, ldk, a.k + (long)bh * nkv * dqk, dqk, j0, nkv, 0, dqk);
  stage<KB>(sv, ldv, a.v + (long)bh * nkv * dv, dv, j0, nkv, 0, dv);

  float bias_r[2];
#pragma unroll
  for (int f = 0; f < 2; ++f) {
    const int j = j0 + tx + 16 * f;
    bias_r[f] = (a.bias != nullptr && j < nkv) ? a.bias[(long)(bh / a.h) * nkv + j] : 0.f;
  }
  // query i sees key j iff j <= i + offset: rows below j0 - offset see
  // nothing of this block
  const int offset = nkv - nq;
  int i_begin = a.causal ? max(0, j0 - offset) : 0;
  i_begin -= i_begin % BQ;

  float4 acc_k[CH][2], acc_v[CH][2];
  zero(acc_k);
  zero(acc_v);
  for (int i0 = i_begin; i0 < nq; i0 += BQ) {
    // S and dP as (q row ty + 16e, kv row tx + 16f)
    float s[4][2] = {}, dp[4][2] = {};
    for (int c0 = 0; c0 < dqk; c0 += DC) {
      const int w = min(DC, dqk - c0);
      __syncthreads();
      stage<BQ>(sc, LDC, qh, dqk, i0, nq, c0, w);
      if (c0 == 0 && threadIdx.x < BQ) {
        const int gi = i0 + threadIdx.x;
        slse[threadIdx.x] = gi < nq ? a.lse[(long)bh * nq + gi] : 0.f;
        sdelta[threadIdx.x] = gi < nq ? a.delta[(long)bh * nq + gi] : 0.f;
      }
      __syncthreads();
      dot<4, 2>(s, sc, LDC, sk + c0, ldk, w, ty, tx);
    }
    for (int c0 = 0; c0 < dv; c0 += DC) {
      const int w = min(DC, dv - c0);
      __syncthreads();
      stage<BQ>(sc, LDC, doh, dv, i0, nq, c0, w);
      __syncthreads();
      dot<4, 2>(dp, sc, LDC, sv + c0, ldv, w, ty, tx);
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int ii = ty + 16 * e, i = i0 + ii;
#pragma unroll
      for (int f = 0; f < 2; ++f) {
        const int jj = tx + 16 * f, j = j0 + jj;
        const bool visible = i < nq && j < nkv && (!a.causal || j <= i + offset);
        float p, ds;
        p_ds(s[e][f], dp[e][f], bias_r[f], slse[ii], sdelta[ii], visible, a.sm_scale, p, ds);
        spt[jj * LDT + ii] = p;
        sdst[jj * LDT + ii] = ds;
      }
    }
    // dV_j += sum_i P^T[j][i] dO_i, dK_j += sum_i dS^T[j][i] q_i, a chunk at a time
#pragma unroll
    for (int ch = 0; ch < CH; ++ch) {
      const int c0 = DC * ch;
      if (c0 < dv) {
        __syncthreads();
        stage<BQ>(sc, LDC, doh, dv, i0, nq, c0, min(DC, dv - c0));
        __syncthreads();
        if (c0 + 4 * tx < dv) acc_rows<2, BQ>(acc_v[ch], spt, LDT, sc, LDC, ty, tx);
      }
    }
#pragma unroll
    for (int ch = 0; ch < CH; ++ch) {
      const int c0 = DC * ch;
      if (c0 < dqk) {
        __syncthreads();
        stage<BQ>(sc, LDC, qh, dqk, i0, nq, c0, min(DC, dqk - c0));
        __syncthreads();
        if (c0 + 4 * tx < dqk) acc_rows<2, BQ>(acc_k[ch], sdst, LDT, sc, LDC, ty, tx);
      }
    }
  }
  store_rows(a.dk + (long)bh * nkv * dqk, dqk, j0, nkv, acc_k, ty, tx);
  store_rows(a.dv + (long)bh * nkv * dv, dv, j0, nkv, acc_v, ty, tx);
}

// K9b: one CTA per (64 q rows, batch*head, split of the kv walk)
template <int DMAX>
__global__ void __launch_bounds__(NT, 1) heads_bwd_dq_kernel(const Args a) {
  constexpr int CH = Chunks<DMAX>::N;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int dqk = a.dqk, dv = a.dv_, nq = a.nq, nkv = a.nkv;
  float* sa = smem;             // BQ x LDC: a column chunk of Q or dO
  float* skv = sa + BQ * LDC;   // KB x LDC: a column chunk of K or V
  float* sds = skv + KB * LDC;  // BQ x LDS: dS
  float* sb = sds + BQ * LDS;   // KB: the tile's bias

  const int q0 = blockIdx.x * BQ, bh = blockIdx.y, z = blockIdx.z, nsplit = gridDim.z;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const float* qh = a.q + (long)bh * nq * dqk;
  const float* doh = a.dout + (long)bh * nq * dv;
  const float* kh = a.k + (long)bh * nkv * dqk;
  const float* vh = a.v + (long)bh * nkv * dv;
  const float* brow = a.bias == nullptr ? nullptr : a.bias + (long)(bh / a.h) * nkv;

  const int offset = nkv - nq;
  float lse_r[4], delta_r[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int i = q0 + ty + 16 * e;
    lse_r[e] = i < nq ? a.lse[(long)bh * nq + i] : 0.f;
    delta_r[e] = i < nq ? a.delta[(long)bh * nq + i] : 0.f;
  }
  const int kv_end = a.causal ? max(0, min(nkv, min(q0 + BQ, nq) + offset)) : nkv;
  const int n_tiles = (kv_end + KB - 1) / KB;
  const int per = (n_tiles + nsplit - 1) / nsplit;
  const int t_begin = min(n_tiles, z * per), t_end = min(n_tiles, t_begin + per);

  float4 acc[CH][4];
  zero(acc);
  for (int t = t_begin; t < t_end; ++t) {
    const int j0 = t * KB;
    float s[4][2] = {}, dp[4][2] = {};
    for (int c0 = 0; c0 < dqk; c0 += DC) {
      const int w = min(DC, dqk - c0);
      __syncthreads();
      stage<BQ>(sa, LDC, qh, dqk, q0, nq, c0, w);
      stage<KB>(skv, LDC, kh, dqk, j0, nkv, c0, w);
      if (c0 == 0 && threadIdx.x < KB) {
        const int gj = j0 + threadIdx.x;
        sb[threadIdx.x] = (brow != nullptr && gj < nkv) ? brow[gj] : 0.f;
      }
      __syncthreads();
      dot<4, 2>(s, sa, LDC, skv, LDC, w, ty, tx);
    }
    for (int c0 = 0; c0 < dv; c0 += DC) {
      const int w = min(DC, dv - c0);
      __syncthreads();
      stage<BQ>(sa, LDC, doh, dv, q0, nq, c0, w);
      stage<KB>(skv, LDC, vh, dv, j0, nkv, c0, w);
      __syncthreads();
      dot<4, 2>(dp, sa, LDC, skv, LDC, w, ty, tx);
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = q0 + ty + 16 * e;
#pragma unroll
      for (int f = 0; f < 2; ++f) {
        const int jj = tx + 16 * f, j = j0 + jj;
        const bool visible = i < nq && j < nkv && (!a.causal || j <= i + offset);
        float p, ds;
        p_ds(s[e][f], dp[e][f], sb[jj], lse_r[e], delta_r[e], visible, a.sm_scale, p, ds);
        sds[(ty + 16 * e) * LDS + jj] = ds;
      }
    }
    // dQ_i += sum_j dS[i][j] k_j, a chunk of K columns at a time
#pragma unroll
    for (int ch = 0; ch < CH; ++ch) {
      const int c0 = DC * ch;
      if (c0 < dqk) {
        __syncthreads();
        stage<KB>(skv, LDC, kh, dqk, j0, nkv, c0, min(DC, dqk - c0));
        __syncthreads();
        if (c0 + 4 * tx < dqk) acc_rows<4, KB>(acc[ch], sds, LDS, skv, LDC, ty, tx);
      }
    }
  }
  float* out = nsplit == 1 ? a.dq : a.part + (long)z * gridDim.y * nq * dqk;
  store_rows(out + (long)bh * nq * dqk, dqk, q0, nq, acc, ty, tx);
}

// dq = the sum of the splits' partials, in split order
__global__ void __launch_bounds__(256) heads_dq_reduce_kernel(const float4* __restrict__ part, float4* __restrict__ dq,
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
    dq[idx] = s;
  }
}

template <int DMAX>
cudaError_t launch_dkv(const Args& a) {
  const size_t floats = (size_t)KB * (a.dqk + 4) + (size_t)KB * (a.dv_ + 4) + (size_t)BQ * LDC +
                        2 * (size_t)KB * LDT + 2 * BQ;
  const size_t smem = floats * sizeof(float);
  auto kernel = heads_bwd_dkv_kernel<DMAX>;
  cudaError_t err = prepare(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3((a.nkv + KB - 1) / KB, a.bh), NT, smem, a.stream>>>(a);
  return cudaGetLastError();
}

template <int DMAX>
cudaError_t launch_dq(const Args& a) {
  const size_t smem = ((size_t)BQ * LDC + (size_t)KB * LDC + (size_t)BQ * LDS + KB) * sizeof(float);
  auto kernel = heads_bwd_dq_kernel<DMAX>;
  cudaError_t err = prepare(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3((a.nq + BQ - 1) / BQ, a.bh, a.nsplit), NT, smem, a.stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess || a.nsplit == 1) return err;
  const long n4 = (long)a.bh * a.nq * a.dqk / 4;
  const long blocks = (n4 + 255) / 256;
  heads_dq_reduce_kernel<<<(unsigned)(blocks < 4096 ? blocks : 4096), 256, 0, a.stream>>>(
      reinterpret_cast<const float4*>(a.part), reinterpret_cast<float4*>(a.dq), n4, a.nsplit);
  return cudaGetLastError();
}

bool valid(const Args& a) {
  return valid_dims(a.dqk, a.dv_) && a.nq >= 0 && a.nkv >= 0 && a.h > 0 && a.bh <= 65535;
}

}  // namespace

// q/dout (BH, Nq, D), k/v (BH, Nkv, D), all f32, contiguous and 16-byte
// aligned, D multiples of 8 up to 512; lse/delta (BH, Nq) f32; bias
// (BH / h, Nkv) f32 or null. K9a writes dk (BH, Nkv, Dqk) and dv (BH, Nkv,
// Dv); K9b writes dq (BH, Nq, Dqk), through part (nsplit * BH * Nq * Dqk
// floats of scratch) when nsplit > 1. Each returns a cudaError_t
// (0 = launched).
extern "C" int pio_flash_heads_bwd_dkv(const float* q, const float* k, const float* v, const float* dout,
                                       const float* lse, const float* delta, const float* bias, float* dk,
                                       float* dv, int bh, int nq, int nkv, int h, int dqk, int dv_, int causal,
                                       float sm_scale, void* stream) {
  const Args a{q, k, v, dout, lse, delta, bias, nullptr, dk, dv, nullptr, bh, nq, nkv, h, dqk, dv_, causal,
               sm_scale, 1, static_cast<cudaStream_t>(stream)};
  if (bh <= 0 || nkv <= 0) return cudaSuccess;
  if (!valid(a)) return cudaErrorInvalidValue;
  switch (dmax_bucket(dqk, dv_)) {
    case 64: return launch_dkv<64>(a);
    case 128: return launch_dkv<128>(a);
    case 256: return launch_dkv<256>(a);
    case 320: return launch_dkv<320>(a);
    default: return launch_dkv<512>(a);
  }
}

extern "C" int pio_flash_heads_bwd_dq(const float* q, const float* k, const float* v, const float* dout,
                                      const float* lse, const float* delta, const float* bias, float* dq,
                                      float* part, int bh, int nq, int nkv, int h, int dqk, int dv_, int causal,
                                      float sm_scale, int nsplit, void* stream) {
  const Args a{q, k, v, dout, lse, delta, bias, dq, nullptr, nullptr, part, bh, nq, nkv, h, dqk, dv_, causal,
               sm_scale, nsplit, static_cast<cudaStream_t>(stream)};
  if (bh <= 0 || nq <= 0) return cudaSuccess;
  if (!valid(a) || nsplit < 1 || nsplit > 65535 || (nsplit > 1 && part == nullptr)) return cudaErrorInvalidValue;
  switch (dmax_bucket(dqk, dv_)) {
    case 64: return launch_dq<64>(a);
    case 128: return launch_dq<128>(a);
    case 256: return launch_dq<256>(a);
    case 320: return launch_dq<320>(a);
    default: return launch_dq<512>(a);
  }
}
