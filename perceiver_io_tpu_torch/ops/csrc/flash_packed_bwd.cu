// K4a + K4b: packed flash attention backward for Hopper (sm_90a), plain
// CUDA C++, f32.
//
// Replaces the TPU kernels perceiver_io_tpu/ops/flash_attention.py
// _dkv_packed_kernel (K4a) and _dq_packed_kernel (K4b), both reached from
// _flash_packed_bwd via the custom VJP of flash_attention_packed. Same
// function: P is recomputed from the forward's logsumexp,
// p_ij = exp(sm_scale * q_i.k_j + bias_j - lse_i), only where query i sees
// key j under the right-aligned causal limit j <= i + (nkv - nq) (elsewhere
// p is exactly 0); with delta_i = rowsum(dO_i * O_i) per head (computed by
// the wrapper, as the JAX package computes it outside its kernels):
//
//   dV_j += p_ij dO_i,  dS_ij = p_ij (dO_i.v_j - delta_i) sm_scale,
//   dK_j += dS_ij q_i,  dQ_i += dS_ij k_j.
//
// Two kernels, as on the TPU, so no output is written by two CTAs and no
// atomics are needed: K4a owns a block of 64 kv rows and loops over the q
// tiles that can see it; K4b owns a block of 64 q rows and loops over the kv
// tiles it can see.
//
// What bounds them: at the flagship training chunk (CA 1024 queries over
// 8704 keys, D = 64, batch 2) K4a does four products of 2*D operations per
// visible (query, key) pair and K4b three, ~69 and ~52 GFLOP against ~100 MB
// of operands, far above the card's operations-per-byte line: bound by
// arithmetic. One TF32 product would miss the f32 parity tolerance, so the
// products run on the CUDA cores (no wgmma, no TMA; K2's split-TF32 tiles in
// flash_mma.cuh are the way to the tensor cores), laid out as register-tiled
// GEMMs (the helpers live in flash_tiles.cuh, shared with the two-segment
// backward):
//
// - every 64 x 64 product tile (S = Q K^T, dP = dO V^T) is split over 256
//   threads as 4 x 4 micro-tiles with strided rows {ty + 16e} and columns
//   {tx + 16f}; each step of the depth loop reads four float4 of each
//   operand from shared memory for 64 FMAs, and rows padded to D + 4 words
//   make the 16 column-threads' float4 reads conflict-free;
// - the accumulating products (dQ = dS K; dV = P^T dO, dK = dS^T Q) go
//   through dS (and P) in shared memory, each thread owning 4 rows x float4
//   column chunks of the output, again 64 FMAs per eight float4 reads;
// - one CTA per (64-row block, head, batch) with at most 128 registers a
//   thread (D <= 64) and ~90-105 KB of shared memory, so two CTAs share an
//   SM.
//
// A head is a strided column slice of the packed rows (row stride H*D), so no
// transpose copy is made. Moving the products onto the tensor cores (bf16
// wgmma) is later work.

#include "flash_tiles.cuh"

namespace {

using namespace pio::tiles;

// K4b: one CTA per (64 query rows, head, batch); loops over the kv tiles up
// to the last one the block's causal limit can see.
template <int DMAX>
__global__ void __launch_bounds__(NT, Occ<DMAX>::MIN_BLOCKS) flash_bwd_dq_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    const float* __restrict__ dout, const float* __restrict__ lse, const float* __restrict__ delta,
    const float* __restrict__ bias, float* __restrict__ dq, int nq, int nkv, int h, int dqk, int dv,
    int causal, float sm_scale) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int ldq = dqk + 4, ldv = dv + 4;
  float* sq = smem;
  float* sdo = sq + BLK * ldq;
  float* sk = sdo + BLK * ldv;
  float* sv = sk + BLK * ldq;
  float* sds = sv + BLK * ldv;
  float* sb = sds + BLK * LDT;

  const int q0 = blockIdx.x * BLK, head = blockIdx.y, b = blockIdx.z;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const long row_qk = (long)h * dqk, row_v = (long)h * dv;
  const float* kh = k + (long)b * nkv * row_qk + (long)head * dqk;
  const float* vh = v + (long)b * nkv * row_v + (long)head * dv;
  stage_tile(sq, ldq, q + (long)b * nq * row_qk + (long)head * dqk, row_qk, q0, nq, dqk);
  stage_tile(sdo, ldv, dout + (long)b * nq * row_v + (long)head * dv, row_v, q0, nq, dv);

  const int offset = nkv - nq;
  float lse_r[4], delta_r[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int i = q0 + ty + 16 * e;
    const long stat = ((long)b * nq + i) * h + head;
    lse_r[e] = i < nq ? lse[stat] : 0.f;
    delta_r[e] = i < nq ? delta[stat] : 0.f;
  }
  int kv_end = nkv;
  if (causal) kv_end = min(nkv, min(q0 + BLK, nq) + offset);

  float4 acc[4][Cols<DMAX>::CH];
  zero<DMAX>(acc);
  for (int j0 = 0; j0 < kv_end; j0 += BLK) {
    __syncthreads();  // the previous tile's readers are done
    stage_tile(sk, ldq, kh, row_qk, j0, nkv, dqk);
    stage_tile(sv, ldv, vh, row_v, j0, nkv, dv);
    if (threadIdx.x < BLK) {
      const int gj = j0 + threadIdx.x;
      sb[threadIdx.x] = (bias != nullptr && gj < nkv) ? bias[(long)b * nkv + gj] : 0.f;
    }
    __syncthreads();

    float s[4][4] = {}, dp[4][4] = {};
    tile_dot<DMAX>(s, sq, sk, ldq, dqk, ty, tx);
    tile_dot<DMAX>(dp, sdo, sv, ldv, dv, ty, tx);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = q0 + ty + 16 * e;
#pragma unroll
      for (int f = 0; f < 4; ++f) {
        const int jj = tx + 16 * f, j = j0 + jj;
        const bool visible = i < nq && j < nkv && (!causal || j <= i + offset);
        const float p = visible ? expf(s[e][f] * sm_scale + sb[jj] - lse_r[e]) : 0.f;
        sds[(ty + 16 * e) * LDT + jj] = p * (dp[e][f] - delta_r[e]) * sm_scale;
      }
    }
    __syncthreads();
    tile_acc<DMAX>(acc, sds, sk, ldq, dqk, ty, tx);
  }
  store_rows<DMAX>(dq + (long)b * nq * row_qk + (long)head * dqk, row_qk, q0, nq, dqk, acc, ty, tx);
}

// K4a: one CTA per (64 kv rows, head, batch); loops over the q tiles from
// the first one whose rows can see the block's first key.
template <int DMAX>
__global__ void __launch_bounds__(NT, Occ<DMAX>::MIN_BLOCKS) flash_bwd_dkv_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    const float* __restrict__ dout, const float* __restrict__ lse, const float* __restrict__ delta,
    const float* __restrict__ bias, float* __restrict__ dk, float* __restrict__ dvo, int nq, int nkv, int h,
    int dqk, int dv, int causal, float sm_scale) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int ldq = dqk + 4, ldv = dv + 4;
  float* sk = smem;
  float* sv = sk + BLK * ldq;
  float* sq = sv + BLK * ldv;
  float* sdo = sq + BLK * ldq;
  float* spt = sdo + BLK * ldv;  // P^T: [kv row][q row]
  float* sdst = spt + BLK * LDT;  // dS^T
  float* slse = sdst + BLK * LDT;
  float* sdelta = slse + BLK;

  const int j0 = blockIdx.x * BLK, head = blockIdx.y, b = blockIdx.z;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const long row_qk = (long)h * dqk, row_v = (long)h * dv;
  const float* qh = q + (long)b * nq * row_qk + (long)head * dqk;
  const float* doh = dout + (long)b * nq * row_v + (long)head * dv;
  stage_tile(sk, ldq, k + (long)b * nkv * row_qk + (long)head * dqk, row_qk, j0, nkv, dqk);
  stage_tile(sv, ldv, v + (long)b * nkv * row_v + (long)head * dv, row_v, j0, nkv, dv);

  float bias_r[4];
#pragma unroll
  for (int f = 0; f < 4; ++f) {
    const int j = j0 + tx + 16 * f;
    bias_r[f] = (bias != nullptr && j < nkv) ? bias[(long)b * nkv + j] : 0.f;
  }
  // query i sees key j iff j <= i + offset: rows below j0 - offset see
  // nothing of this block
  const int offset = nkv - nq;
  int i_begin = causal ? max(0, j0 - offset) : 0;
  i_begin -= i_begin % BLK;

  float4 acc_k[4][Cols<DMAX>::CH], acc_v[4][Cols<DMAX>::CH];
  zero<DMAX>(acc_k);
  zero<DMAX>(acc_v);
  for (int i0 = i_begin; i0 < nq; i0 += BLK) {
    __syncthreads();
    stage_tile(sq, ldq, qh, row_qk, i0, nq, dqk);
    stage_tile(sdo, ldv, doh, row_v, i0, nq, dv);
    if (threadIdx.x < BLK) {
      const int gi = i0 + threadIdx.x;
      const long stat = ((long)b * nq + gi) * h + head;
      slse[threadIdx.x] = gi < nq ? lse[stat] : 0.f;
      sdelta[threadIdx.x] = gi < nq ? delta[stat] : 0.f;
    }
    __syncthreads();

    // S and dP as (q row ty + 16e, kv row tx + 16f)
    float s[4][4] = {}, dp[4][4] = {};
    tile_dot<DMAX>(s, sq, sk, ldq, dqk, ty, tx);
    tile_dot<DMAX>(dp, sdo, sv, ldv, dv, ty, tx);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int ii = ty + 16 * e, i = i0 + ii;
#pragma unroll
      for (int f = 0; f < 4; ++f) {
        const int jj = tx + 16 * f, j = j0 + jj;
        const bool visible = i < nq && j < nkv && (!causal || j <= i + offset);
        const float p = visible ? expf(s[e][f] * sm_scale + bias_r[f] - slse[ii]) : 0.f;
        spt[jj * LDT + ii] = p;
        sdst[jj * LDT + ii] = p * (dp[e][f] - sdelta[ii]) * sm_scale;
      }
    }
    __syncthreads();
    // dV_j += sum_i P^T[j][i] dO_i, dK_j += sum_i dS^T[j][i] q_i
    tile_acc<DMAX>(acc_v, spt, sdo, ldv, dv, ty, tx);
    tile_acc<DMAX>(acc_k, sdst, sq, ldq, dqk, ty, tx);
  }
  store_rows<DMAX>(dk + (long)b * nkv * row_qk + (long)head * dqk, row_qk, j0, nkv, dqk, acc_k, ty, tx);
  store_rows<DMAX>(dvo + (long)b * nkv * row_v + (long)head * dv, row_v, j0, nkv, dv, acc_v, ty, tx);
}

struct Args {
  const float *q, *k, *v, *dout, *lse, *delta, *bias;
  float *dq, *dk, *dv;
  int batch, nq, nkv, h, dqk, dv_, causal;
  float sm_scale;
  cudaStream_t stream;
};

size_t tile_floats(const Args& a) { return (size_t)BLK * (a.dqk + 4) + (size_t)BLK * (a.dv_ + 4); }

template <int DMAX>
cudaError_t launch_dq(const Args& a) {
  // q and dO of the block, one K and V tile, dS, the tile's bias row
  const size_t smem = (2 * tile_floats(a) + (size_t)BLK * LDT + BLK) * sizeof(float);
  auto kernel = flash_bwd_dq_kernel<DMAX>;
  cudaError_t err = prepare(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.nq + BLK - 1) / BLK, a.h, a.batch);
  kernel<<<grid, NT, smem, a.stream>>>(a.q, a.k, a.v, a.dout, a.lse, a.delta, a.bias, a.dq, a.nq, a.nkv, a.h,
                                       a.dqk, a.dv_, a.causal, a.sm_scale);
  return cudaGetLastError();
}

template <int DMAX>
cudaError_t launch_dkv(const Args& a) {
  // K and V of the block, one q and dO tile, P^T and dS^T, lse and delta
  const size_t smem = (2 * tile_floats(a) + 2 * (size_t)BLK * LDT + 2 * BLK) * sizeof(float);
  auto kernel = flash_bwd_dkv_kernel<DMAX>;
  cudaError_t err = prepare(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.nkv + BLK - 1) / BLK, a.h, a.batch);
  kernel<<<grid, NT, smem, a.stream>>>(a.q, a.k, a.v, a.dout, a.lse, a.delta, a.bias, a.dk, a.dv, a.nq, a.nkv,
                                       a.h, a.dqk, a.dv_, a.causal, a.sm_scale);
  return cudaGetLastError();
}

bool valid(const Args& a) {
  return a.dqk > 0 && a.dv_ > 0 && a.dqk % 8 == 0 && a.dv_ % 8 == 0 && a.dqk <= 128 && a.dv_ <= 128 &&
         a.nq >= 0 && a.nkv >= 0 && a.h <= 65535 && a.batch <= 65535;
}

}  // namespace

// q/dout (B, Nq, H*D), k/v (B, Nkv, H*D), all f32 and contiguous; lse/delta
// (B, Nq, H) f32; bias (B, Nkv) f32 or null. K4a writes dk (B, Nkv, H*Dqk)
// and dv (B, Nkv, H*Dv); K4b writes dq (B, Nq, H*Dqk). Each returns a
// cudaError_t (0 = launched).
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
