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
// arithmetic. f32 parity forbids TF32, so the products run on the CUDA cores
// (no wgmma, no TMA), laid out as register-tiled GEMMs:
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

#include "common.cuh"

namespace {

constexpr int NT = 256;    // threads: a 16 x 16 grid of (ty, tx)
constexpr int BLK = 64;    // rows of the owned block and of each loaded tile
constexpr int LDT = BLK + 4;  // row stride of the P / dS tiles

// threads needed to cover DMAX columns as float4 chunks 64 words apart
template <int DMAX>
struct Cols {
  static constexpr int CH = DMAX > 64 ? DMAX / 64 : 1;
};

// two CTAs per SM up to D = 64; D = 128 keeps the registers it needs
template <int DMAX>
struct Occ {
  static constexpr int MIN_BLOCKS = DMAX <= 64 ? 2 : 1;
};

__device__ __forceinline__ float4 ld4(const float* p) { return *reinterpret_cast<const float4*>(p); }

// rows [r0, r0 + BLK) of a head's column slice (width d) into a tile with
// row stride ld; rows past n are zero
__device__ __forceinline__ void stage_tile(float* dst, int ld, const float* src, long row_stride, int r0, int n,
                                           int d) {
  const int per_row = d / 4;
  for (int idx = threadIdx.x; idx < BLK * per_row; idx += NT) {
    const int rr = idx / per_row, c = 4 * (idx - rr * per_row), g = r0 + rr;
    const float4 x = g < n ? ld4(src + (long)g * row_stride + c) : make_float4(0.f, 0.f, 0.f, 0.f);
    *reinterpret_cast<float4*>(dst + rr * ld + c) = x;
  }
}

// acc[e][f] += A[ty + 16e] . B[tx + 16f] over depth d (A, B tiles with row
// stride ld): the 64 x 64 product tile's 4 x 4 micro-tile of this thread
template <int DMAX>
__device__ __forceinline__ void tile_dot(float (&acc)[4][4], const float* a, const float* b, int ld, int d,
                                         int ty, int tx) {
#pragma unroll 4
  for (int c4 = 0; c4 < DMAX / 4; ++c4) {
    if (4 * c4 < d) {
      float4 av[4], bv[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) av[e] = ld4(a + (ty + 16 * e) * ld + 4 * c4);
#pragma unroll
      for (int f = 0; f < 4; ++f) bv[f] = ld4(b + (tx + 16 * f) * ld + 4 * c4);
#pragma unroll
      for (int e = 0; e < 4; ++e)
#pragma unroll
        for (int f = 0; f < 4; ++f) {
          acc[e][f] = fmaf(av[e].x, bv[f].x, acc[e][f]);
          acc[e][f] = fmaf(av[e].y, bv[f].y, acc[e][f]);
          acc[e][f] = fmaf(av[e].z, bv[f].z, acc[e][f]);
          acc[e][f] = fmaf(av[e].w, bv[f].w, acc[e][f]);
        }
    }
  }
}

// out[e][ch] (float4 at row ty + 16e, column 4tx + 64ch) += sum over the
// tile's 64 depth rows r of w[ty + 16e][r] * m[r][4tx + 64ch .. + 3]; w has
// row stride LDT, m row stride ldm and width d
template <int DMAX>
__device__ __forceinline__ void tile_acc(float4 (&out)[4][Cols<DMAX>::CH], const float* w, const float* m,
                                         int ldm, int d, int ty, int tx) {
  constexpr int CH = Cols<DMAX>::CH;
#pragma unroll 2
  for (int r4 = 0; r4 < BLK / 4; ++r4) {
    float4 wv[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) wv[e] = ld4(w + (ty + 16 * e) * LDT + 4 * r4);
#pragma unroll
    for (int ch = 0; ch < CH; ++ch) {
      const int c = 4 * tx + 64 * ch;
      if (c < d) {
        float4 mv[4];
#pragma unroll
        for (int g = 0; g < 4; ++g) mv[g] = ld4(m + (4 * r4 + g) * ldm + c);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float ws[4] = {wv[e].x, wv[e].y, wv[e].z, wv[e].w};
#pragma unroll
          for (int g = 0; g < 4; ++g) {
            out[e][ch].x = fmaf(ws[g], mv[g].x, out[e][ch].x);
            out[e][ch].y = fmaf(ws[g], mv[g].y, out[e][ch].y);
            out[e][ch].z = fmaf(ws[g], mv[g].z, out[e][ch].z);
            out[e][ch].w = fmaf(ws[g], mv[g].w, out[e][ch].w);
          }
        }
      }
    }
  }
}

template <int DMAX>
__device__ __forceinline__ void store_rows(float* dst, long row_stride, int r0, int n, int d,
                                           const float4 (&out)[4][Cols<DMAX>::CH], int ty, int tx) {
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int r = r0 + ty + 16 * e;
    if (r < n) {
#pragma unroll
      for (int ch = 0; ch < Cols<DMAX>::CH; ++ch) {
        const int c = 4 * tx + 64 * ch;
        if (c < d) *reinterpret_cast<float4*>(dst + (long)r * row_stride + c) = out[e][ch];
      }
    }
  }
}

template <int DMAX>
__device__ __forceinline__ void zero(float4 (&out)[4][Cols<DMAX>::CH]) {
#pragma unroll
  for (int e = 0; e < 4; ++e)
#pragma unroll
    for (int ch = 0; ch < Cols<DMAX>::CH; ++ch) out[e][ch] = make_float4(0.f, 0.f, 0.f, 0.f);
}

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

// the kernel's dynamic shared memory, and the largest carveout so that two
// CTAs fit on an SM
template <typename Kernel>
cudaError_t prepare(Kernel kernel, size_t smem) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout, cudaSharedmemCarveoutMaxShared);
}

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

int dmax(const Args& a) {
  const int d = a.dqk > a.dv_ ? a.dqk : a.dv_;
  return d <= 32 ? 32 : (d <= 64 ? 64 : 128);
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
  switch (dmax(a)) {
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
  switch (dmax(a)) {
    case 32: return launch_dq<32>(a);
    case 64: return launch_dq<64>(a);
    default: return launch_dq<128>(a);
  }
}
