// K7a + K7b: two-segment packed flash attention backward for Hopper
// (sm_90a), plain CUDA C++, f32.
//
// Replaces the TPU kernels perceiver_io_tpu/ops/flash_attention.py
// _dkv_2seg_kernel (K7a) and _dq_2seg_kernel (K7b), both reached from
// _flash_packed_2seg_bwd via the custom VJP of flash_attention_packed_2seg.
// Same function as K4a/K4b (flash_packed_bwd.cu) over the logical kv
// sequence [prefix; latents], read as two operand pairs that are never
// joined: query i sees every prefix row and latent rows t <= i, P is
// recomputed from the forward's logsumexp, p_ij = exp(sm_scale * q_i.k_j +
// bias_j - lse_i), only there (elsewhere p is exactly 0); with
// delta_i = rowsum(dO_i * O_i) per head (computed by the wrapper):
//
//   dV_j += p_ij dO_i,  dS_ij = p_ij (dO_i.v_j - delta_i) sm_scale,
//   dK_j += dS_ij q_i,  dQ_i += dS_ij k_j,
//
// with dK/dV written per segment (dk_p, dv_p, dk_l, dv_l).
//
// - K7a: each segment has its own range of 64-row kv blocks (the prefix's
//   ceil(Np/64), then the latents' ceil(Nq/64)), as the TPU kernel pads each
//   segment to its own block multiple: no CTA straddles the seam, and each
//   writes only its own segment's dK/dV rows, one writer per row, no
//   atomics. A prefix block is seen by every query, so its CTA walks every
//   q tile; latent row t is seen by queries i >= t, so a latent block's CTA
//   starts at the q tile that holds its first row.
// - K7b: one CTA per 64 query rows walks every prefix tile, then the latent
//   tiles up to its last row.
//
// What bounds them: at the flagship training chunk (1024 latents over 7680
// kept prefix rows + 1024 latents, D = 64, batch 2) K7a does four products
// of 2*D operations per visible (query, key) pair and K7b three, ~69 and
// ~52 GFLOP against ~100 MB of operands: bound by arithmetic, on the CUDA
// cores (one TF32 product misses the f32 parity tolerance; K4's split-TF32
// tiles, flash_mma_bwd.cuh, are the way to the tensor cores). The products
// are register-tiled GEMMs (flash_tiles.cuh): 4 x 4 micro-tiles, P and dS
// through shared memory, one CTA per (64-row block, head, batch), 128
// registers a thread up to D = 64 so two CTAs share an SM.

#include "flash_tiles.cuh"

namespace {

using namespace pio::tiles;

// One kv segment of one (batch, head): its K and V head slices, bias row
// (or null) and length.
struct Seg {
  const float* k;
  const float* v;
  const float* bias;
  int n;
};

__device__ __forceinline__ Seg segment(bool pre, const float* k_p, const float* v_p, const float* k_l,
                                       const float* v_l, const float* bias_p, const float* bias_l, int b, int head,
                                       int nq, int np, long row_qk, long row_v, int dqk, int dv) {
  const int n = pre ? np : nq;
  Seg s;
  s.k = (pre ? k_p : k_l) + (long)b * n * row_qk + (long)head * dqk;
  s.v = (pre ? v_p : v_l) + (long)b * n * row_v + (long)head * dv;
  s.bias = pre ? bias_p : bias_l;
  if (s.bias != nullptr) s.bias += (long)b * n;
  s.n = n;
  return s;
}

// K7b: one CTA per (64 query rows, head, batch).
template <int DMAX>
__global__ void __launch_bounds__(NT, Occ<DMAX>::MIN_BLOCKS) flash_2seg_bwd_dq_kernel(
    const float* __restrict__ q, const float* __restrict__ k_p, const float* __restrict__ v_p,
    const float* __restrict__ k_l, const float* __restrict__ v_l, const float* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta, const float* __restrict__ bias_p,
    const float* __restrict__ bias_l, float* __restrict__ dq, int nq, int np, int h, int dqk, int dv,
    float sm_scale) {
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
  stage_tile(sq, ldq, q + (long)b * nq * row_qk + (long)head * dqk, row_qk, q0, nq, dqk);
  stage_tile(sdo, ldv, dout + (long)b * nq * row_v + (long)head * dv, row_v, q0, nq, dv);

  float lse_r[4], delta_r[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int i = q0 + ty + 16 * e;
    const long stat = ((long)b * nq + i) * h + head;
    lse_r[e] = i < nq ? lse[stat] : 0.f;
    delta_r[e] = i < nq ? delta[stat] : 0.f;
  }
  // every prefix tile, then the latent tiles up to the block's last row
  const int n_pt = (np + BLK - 1) / BLK;
  const int n_tiles = n_pt + (min(q0 + BLK, nq) + BLK - 1) / BLK;

  float4 acc[4][Cols<DMAX>::CH];
  zero<DMAX>(acc);
  for (int t = 0; t < n_tiles; ++t) {
    const bool pre = t < n_pt;
    const int j0 = (pre ? t : t - n_pt) * BLK;
    const Seg sg = segment(pre, k_p, v_p, k_l, v_l, bias_p, bias_l, b, head, nq, np, row_qk, row_v, dqk, dv);
    __syncthreads();  // the previous tile's readers are done
    stage_tile(sk, ldq, sg.k, row_qk, j0, sg.n, dqk);
    stage_tile(sv, ldv, sg.v, row_v, j0, sg.n, dv);
    if (threadIdx.x < BLK) {
      const int gj = j0 + threadIdx.x;
      sb[threadIdx.x] = (sg.bias != nullptr && gj < sg.n) ? sg.bias[gj] : 0.f;
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
        const bool visible = i < nq && j < sg.n && (pre || j <= i);
        const float p = visible ? expf(s[e][f] * sm_scale + sb[jj] - lse_r[e]) : 0.f;
        sds[(ty + 16 * e) * LDT + jj] = p * (dp[e][f] - delta_r[e]) * sm_scale;
      }
    }
    __syncthreads();
    tile_acc<DMAX>(acc, sds, sk, ldq, dqk, ty, tx);
  }
  store_rows<DMAX>(dq + (long)b * nq * row_qk + (long)head * dqk, row_qk, q0, nq, dqk, acc, ty, tx);
}

// K7a: one CTA per (64 kv rows of one segment, head, batch); blockIdx.x
// below ceil(Np/64) is a prefix block, the rest latent blocks.
template <int DMAX>
__global__ void __launch_bounds__(NT, Occ<DMAX>::MIN_BLOCKS) flash_2seg_bwd_dkv_kernel(
    const float* __restrict__ q, const float* __restrict__ k_p, const float* __restrict__ v_p,
    const float* __restrict__ k_l, const float* __restrict__ v_l, const float* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta, const float* __restrict__ bias_p,
    const float* __restrict__ bias_l, float* __restrict__ dk_p, float* __restrict__ dv_p,
    float* __restrict__ dk_l, float* __restrict__ dv_l, int nq, int np, int h, int dqk, int dv, float sm_scale) {
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

  const int n_pb = (np + BLK - 1) / BLK, bx = blockIdx.x;
  const bool pre = bx < n_pb;
  const int j0 = (pre ? bx : bx - n_pb) * BLK;  // first row of the block in its segment
  const int head = blockIdx.y, b = blockIdx.z;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const long row_qk = (long)h * dqk, row_v = (long)h * dv;
  const float* qh = q + (long)b * nq * row_qk + (long)head * dqk;
  const float* doh = dout + (long)b * nq * row_v + (long)head * dv;
  const Seg sg = segment(pre, k_p, v_p, k_l, v_l, bias_p, bias_l, b, head, nq, np, row_qk, row_v, dqk, dv);
  stage_tile(sk, ldq, sg.k, row_qk, j0, sg.n, dqk);
  stage_tile(sv, ldv, sg.v, row_v, j0, sg.n, dv);

  float bias_r[4];
#pragma unroll
  for (int f = 0; f < 4; ++f) {
    const int j = j0 + tx + 16 * f;
    bias_r[f] = (sg.bias != nullptr && j < sg.n) ? sg.bias[j] : 0.f;
  }
  // queries below a latent block's first row see nothing of it (j0 is a
  // multiple of BLK, so the walk starts on a q tile boundary)
  const int i_begin = pre ? 0 : j0;

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
        const bool visible = i < nq && j < sg.n && (pre || j <= i);
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
  const long out_k = (long)b * sg.n * row_qk + (long)head * dqk, out_v = (long)b * sg.n * row_v + (long)head * dv;
  store_rows<DMAX>((pre ? dk_p : dk_l) + out_k, row_qk, j0, sg.n, dqk, acc_k, ty, tx);
  store_rows<DMAX>((pre ? dv_p : dv_l) + out_v, row_v, j0, sg.n, dv, acc_v, ty, tx);
}

struct Args {
  const float *q, *k_p, *v_p, *k_l, *v_l, *dout, *lse, *delta, *bias_p, *bias_l;
  float *dq, *dk_p, *dv_p, *dk_l, *dv_l;
  int batch, nq, np, h, dqk, dv;
  float sm_scale;
  cudaStream_t stream;
};

size_t tile_floats(const Args& a) { return (size_t)BLK * (a.dqk + 4) + (size_t)BLK * (a.dv + 4); }

template <int DMAX>
cudaError_t launch_dq(const Args& a) {
  // q and dO of the block, one K and V tile, dS, the tile's bias row
  const size_t smem = (2 * tile_floats(a) + (size_t)BLK * LDT + BLK) * sizeof(float);
  auto kernel = flash_2seg_bwd_dq_kernel<DMAX>;
  cudaError_t err = prepare(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.nq + BLK - 1) / BLK, a.h, a.batch);
  kernel<<<grid, NT, smem, a.stream>>>(a.q, a.k_p, a.v_p, a.k_l, a.v_l, a.dout, a.lse, a.delta, a.bias_p, a.bias_l,
                                       a.dq, a.nq, a.np, a.h, a.dqk, a.dv, a.sm_scale);
  return cudaGetLastError();
}

template <int DMAX>
cudaError_t launch_dkv(const Args& a) {
  // K and V of the block, one q and dO tile, P^T and dS^T, lse and delta
  const size_t smem = (2 * tile_floats(a) + 2 * (size_t)BLK * LDT + 2 * BLK) * sizeof(float);
  auto kernel = flash_2seg_bwd_dkv_kernel<DMAX>;
  cudaError_t err = prepare(kernel, smem);
  if (err != cudaSuccess) return err;
  // the prefix's blocks, then the latents'
  const dim3 grid((a.np + BLK - 1) / BLK + (a.nq + BLK - 1) / BLK, a.h, a.batch);
  kernel<<<grid, NT, smem, a.stream>>>(a.q, a.k_p, a.v_p, a.k_l, a.v_l, a.dout, a.lse, a.delta, a.bias_p, a.bias_l,
                                       a.dk_p, a.dv_p, a.dk_l, a.dv_l, a.nq, a.np, a.h, a.dqk, a.dv, a.sm_scale);
  return cudaGetLastError();
}

bool valid(const Args& a) {
  return a.np >= 1 && a.dqk > 0 && a.dv > 0 && a.dqk % 8 == 0 && a.dv % 8 == 0 && a.dqk <= 128 && a.dv <= 128 &&
         a.h <= 65535 && a.batch <= 65535;
}

}  // namespace

// q/dout (B, Nq, H*D), k_p/v_p (B, Np, H*D), k_l/v_l (B, Nq, H*D), all f32
// and contiguous; lse/delta (B, Nq, H) f32; bias_p (B, Np) and bias_l (B, Nq)
// f32, each or both null. K7a writes dk_p/dv_p (B, Np, ·) and dk_l/dv_l
// (B, Nq, ·); K7b writes dq (B, Nq, H*Dqk). Each returns a cudaError_t
// (0 = launched).
extern "C" int pio_flash_2seg_bwd_dkv(const float* q, const float* k_p, const float* v_p, const float* k_l,
                                      const float* v_l, const float* dout, const float* lse, const float* delta,
                                      const float* bias_p, const float* bias_l, float* dk_p, float* dv_p,
                                      float* dk_l, float* dv_l, int batch, int nq, int np, int h, int dqk, int dv,
                                      float sm_scale, void* stream) {
  const Args a{q, k_p, v_p, k_l, v_l, dout, lse, delta, bias_p, bias_l, nullptr, dk_p, dv_p, dk_l, dv_l,
               batch, nq, np, h, dqk, dv, sm_scale, static_cast<cudaStream_t>(stream)};
  if (batch <= 0 || nq <= 0 || h <= 0) return cudaSuccess;
  if (!valid(a)) return cudaErrorInvalidValue;
  switch (dmax_bucket(dqk, dv)) {
    case 32: return launch_dkv<32>(a);
    case 64: return launch_dkv<64>(a);
    default: return launch_dkv<128>(a);
  }
}

extern "C" int pio_flash_2seg_bwd_dq(const float* q, const float* k_p, const float* v_p, const float* k_l,
                                     const float* v_l, const float* dout, const float* lse, const float* delta,
                                     const float* bias_p, const float* bias_l, float* dq, int batch, int nq, int np,
                                     int h, int dqk, int dv, float sm_scale, void* stream) {
  const Args a{q, k_p, v_p, k_l, v_l, dout, lse, delta, bias_p, bias_l, dq, nullptr, nullptr, nullptr, nullptr,
               batch, nq, np, h, dqk, dv, sm_scale, static_cast<cudaStream_t>(stream)};
  if (batch <= 0 || nq <= 0 || h <= 0) return cudaSuccess;
  if (!valid(a)) return cudaErrorInvalidValue;
  switch (dmax_bucket(dqk, dv)) {
    case 32: return launch_dq<32>(a);
    case 64: return launch_dq<64>(a);
    default: return launch_dq<128>(a);
  }
}
