// K8: heads-major flash attention forward for Hopper (sm_90a), plain CUDA
// C++, f32.
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
// bound by arithmetic, on the CUDA cores (one TF32 product would miss the
// f32 parity tolerance; K2's split-TF32 tiles are the way to the tensor
// cores). Its
// design answers three problems of that shape:
//
// - width: a 264-wide (up to 512) row fits neither in a thread's registers
//   (K2's layout) nor, as whole Q, K and V tiles, in shared memory. The
//   block's 64 queries stay resident in shared memory; each 64-row K tile
//   is staged in 64-column chunks and S = Q K^T accumulated chunk by chunk;
//   P goes through shared memory and each V tile is staged 16 rows at a
//   time for O += P V; the output block (64 x Dv) lives in registers as
//   DMAX / 64 float4 chunks per thread (flash_heads.cuh);
// - too few CTAs: one head and 512 queries give 8 q blocks per image, 8
//   CTAs at batch 1 against 132 SMs, each walking 784 kv tiles. The kv walk
//   is split across `nsplit` CTAs (grid z, chosen by the wrapper); each
//   writes its unnormalized partial (acc, m, l) to a scratch buffer and a
//   second pass (flash_merge.cuh) merges the splits in a fixed order, as K3
//   does;
// - tails: rows past Nq and kv rows past Nkv are staged as zeros and masked;
//   the wrapper pads odd head dims to a multiple of 8.

#include "flash_heads.cuh"
#include "flash_merge.cuh"

namespace {

using namespace pio::heads;

constexpr int BQ = 64;    // query rows per CTA
constexpr int BKV = 64;   // kv rows per tile
constexpr int VR = 16;    // V rows staged at a time

template <int DMAX>
__global__ void __launch_bounds__(NT, 1) heads_fwd_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    const float* __restrict__ bias, float* __restrict__ o, float* __restrict__ lse, float* __restrict__ part,
    int nq, int nkv, int h, int dqk, int dv, int causal, float sm_scale) {
  constexpr int CH = Chunks<DMAX>::N;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int ldq = dqk + 4, ldv = dv + 4;
  float* sq = smem;             // BQ x ldq: the block's queries
  float* sk = sq + BQ * ldq;    // BKV x LDC: one column chunk of a K tile
  float* sv = sk + BKV * LDC;   // VR x ldv: rows of a V tile
  float* sp = sv + VR * ldv;    // BQ x LDC: P of the tile
  float* sb = sp + BQ * LDC;    // BKV: the tile's bias

  const int q0 = blockIdx.x * BQ, bh = blockIdx.y, z = blockIdx.z;
  const int nbh = gridDim.y, nsplit = gridDim.z;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const float* kh = k + (long)bh * nkv * dqk;
  const float* vh = v + (long)bh * nkv * dv;
  const float* brow = bias == nullptr ? nullptr : bias + (long)(bh / h) * nkv;
  stage<BQ>(sq, ldq, q + (long)bh * nq * dqk, dqk, q0, nq, 0, dqk);

  // the block's visible kv tiles, then this split's contiguous share
  const int offset = nkv - nq;
  const int kv_end = causal ? max(0, min(nkv, min(q0 + BQ, nq) + offset)) : nkv;
  const int n_tiles = (kv_end + BKV - 1) / BKV;
  const int per = (n_tiles + nsplit - 1) / nsplit;
  const int t_begin = min(n_tiles, z * per), t_end = min(n_tiles, t_begin + per);

  float m[4], l[4];
  float4 acc[CH][4];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    m[e] = -CUDART_INF_F;
    l[e] = 0.f;
  }
  zero(acc);

  for (int t = t_begin; t < t_end; ++t) {
    const int j0 = t * BKV;
    float s[4][4] = {};
    for (int c0 = 0; c0 < dqk; c0 += DC) {
      const int w = min(DC, dqk - c0);
      __syncthreads();  // the previous chunk's (or tile's) readers are done
      stage<BKV>(sk, LDC, kh, dqk, j0, nkv, c0, w);
      if (c0 == 0 && threadIdx.x < BKV) {
        const int gj = j0 + threadIdx.x;
        sb[threadIdx.x] = (brow != nullptr && gj < nkv) ? brow[gj] : 0.f;
      }
      __syncthreads();
      dot<4, 4>(s, sq + c0, ldq, sk, LDC, w, ty, tx);
    }

    // online softmax; a row's 16 column-threads are 16 lanes of one warp
    float alpha[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = q0 + ty + 16 * e;
      float tmax = -CUDART_INF_F;
#pragma unroll
      for (int f = 0; f < 4; ++f) {
        const int j = j0 + tx + 16 * f;
        const bool visible = j < nkv && (!causal || j <= i + offset);
        s[e][f] = visible ? s[e][f] * sm_scale + sb[tx + 16 * f] : -CUDART_INF_F;
        tmax = fmaxf(tmax, s[e][f]);
      }
#pragma unroll
      for (int w = 1; w < 16; w <<= 1) tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, w));
      const float m_new = fmaxf(m[e], tmax);
      // a row with nothing visible yet keeps p = 0 and alpha = 0 (no inf - inf)
      const float m_use = m_new == -CUDART_INF_F ? 0.f : m_new;
      alpha[e] = expf(m[e] - m_use);
      float psum = 0.f;
#pragma unroll
      for (int f = 0; f < 4; ++f) {
        const float p = expf(s[e][f] - m_use);
        psum += p;
        sp[(ty + 16 * e) * LDC + tx + 16 * f] = p;
      }
#pragma unroll
      for (int w = 1; w < 16; w <<= 1) psum += __shfl_xor_sync(0xffffffffu, psum, w);
      l[e] = l[e] * alpha[e] + psum;
      m[e] = m_new;
    }
#pragma unroll
    for (int ch = 0; ch < CH; ++ch)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        acc[ch][e].x *= alpha[e];
        acc[ch][e].y *= alpha[e];
        acc[ch][e].z *= alpha[e];
        acc[ch][e].w *= alpha[e];
      }

    for (int r0 = 0; r0 < BKV; r0 += VR) {
      __syncthreads();  // P is written; the previous V rows' readers are done
      stage<VR>(sv, ldv, vh, dv, j0 + r0, nkv, 0, dv);
      __syncthreads();
#pragma unroll
      for (int ch = 0; ch < CH; ++ch)
        if (DC * ch + 4 * tx < dv) acc_rows<4, VR>(acc[ch], sp + r0, LDC, sv + DC * ch, ldv, ty, tx);
    }
  }

  if (nsplit == 1) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float inv = l[e] == 0.f ? 1.f : 1.f / l[e];
#pragma unroll
      for (int ch = 0; ch < CH; ++ch) {
        acc[ch][e].x *= inv;
        acc[ch][e].y *= inv;
        acc[ch][e].z *= inv;
        acc[ch][e].w *= inv;
      }
      const int i = q0 + ty + 16 * e;
      if (tx == 0 && i < nq) lse[(long)bh * nq + i] = m[e] + logf(l[e] == 0.f ? 1.f : l[e]);
    }
    store_rows(o + (long)bh * nq * dv, dv, q0, nq, acc, ty, tx);
  } else {
    // unnormalized partials: acc (nsplit, B*H, Nq, Dv), then (m, l) pairs
    const long rows = (long)nbh * nq;
    store_rows(part + ((long)z * rows + (long)bh * nq) * dv, dv, q0, nq, acc, ty, tx);
    float* ml = part + (long)nsplit * rows * dv;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = q0 + ty + 16 * e;
      if (tx == 0 && i < nq) {
        const long r = (long)z * rows + (long)bh * nq + i;
        ml[2 * r] = m[e];
        ml[2 * r + 1] = l[e];
      }
    }
  }
}

template <int DMAX>
cudaError_t launch(const float* q, const float* k, const float* v, const float* bias, float* o, float* lse,
                   float* part, int bh, int nq, int nkv, int h, int dqk, int dv, int causal, float sm_scale,
                   int nsplit, cudaStream_t stream) {
  const size_t floats =
      (size_t)BQ * (dqk + 4) + (size_t)BKV * LDC + (size_t)VR * (dv + 4) + (size_t)BQ * LDC + BKV;
  const size_t smem = floats * sizeof(float);
  auto kernel = heads_fwd_kernel<DMAX>;
  cudaError_t err = prepare(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((nq + BQ - 1) / BQ, bh, nsplit);
  kernel<<<grid, NT, smem, stream>>>(q, k, v, bias, o, lse, part, nq, nkv, h, dqk, dv, causal, sm_scale);
  err = cudaGetLastError();
  if (err != cudaSuccess || nsplit == 1) return err;
  return pio::merge_splits(part, o, lse, (long)bh * nq, dv, nsplit, stream);
}

}  // namespace

// q (BH, Nq, Dqk), k (BH, Nkv, Dqk), v (BH, Nkv, Dv), all f32, contiguous
// and 16-byte aligned, Dqk and Dv multiples of 8 up to 512; bias (BH / h,
// Nkv) f32 or null; o (BH, Nq, Dv) and lse (BH, Nq) f32; part: scratch of
// nsplit * BH * Nq * (Dv + 2) floats when nsplit > 1, else unused. Returns a
// cudaError_t (0 = launched).
extern "C" int pio_flash_heads_fwd(const float* q, const float* k, const float* v, const float* bias, float* o,
                                   float* lse, float* part, int bh, int nq, int nkv, int h, int dqk, int dv,
                                   int causal, float sm_scale, int nsplit, void* stream) {
  if (bh <= 0 || nq <= 0) return cudaSuccess;
  if (!valid_dims(dqk, dv) || nkv < 0 || h <= 0 || bh > 65535 || nsplit < 1 || nsplit > 65535 ||
      (nsplit > 1 && part == nullptr))
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dmax_bucket(dqk, dv)) {
    case 64: return launch<64>(q, k, v, bias, o, lse, part, bh, nq, nkv, h, dqk, dv, causal, sm_scale, nsplit, s);
    case 128: return launch<128>(q, k, v, bias, o, lse, part, bh, nq, nkv, h, dqk, dv, causal, sm_scale, nsplit, s);
    case 256: return launch<256>(q, k, v, bias, o, lse, part, bh, nq, nkv, h, dqk, dv, causal, sm_scale, nsplit, s);
    case 320: return launch<320>(q, k, v, bias, o, lse, part, bh, nq, nkv, h, dqk, dv, causal, sm_scale, nsplit, s);
    default: return launch<512>(q, k, v, bias, o, lse, part, bh, nq, nkv, h, dqk, dv, causal, sm_scale, nsplit, s);
  }
}
