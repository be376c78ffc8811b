// K6: two-segment packed flash attention forward for Hopper (sm_90a), plain
// CUDA C++, f32.
//
// Replaces the TPU kernel perceiver_io_tpu/ops/flash_attention.py
// _fwd_2seg_kernel (reached from _flash_packed_2seg_fwd_impl via
// flash_attention_packed_2seg). Same function: the Perceiver AR causal
// cross-attention of Nq latent queries over the logical kv sequence
// [prefix; latents], given as two operand pairs that are never joined:
// k_p/v_p (B, Np, H*D) and k_l/v_l (B, Nq, H*D). Query i sees every prefix
// row and latent rows t <= i (the concat route's j <= i + Np: causal at
// offset 0 in latent-local coordinates). Each segment may carry its own
// additive f32 bias row (0 or the finite MASK_VALUE at padded keys); the
// online softmax runs in f32 and the per-row logsumexp (B, Nq, H) is written
// for the backward.
//
// What bounds it: at the flagship training chunk (1024 latents over 7680
// kept prefix rows + 1024 latents, D = 64, batch 2) the work is ~34 GFLOP
// against ~80 MB of operands, far above the card's operations-per-byte line:
// bound by arithmetic, on the CUDA cores (f32 parity forbids TF32). The
// design is K2's (flash_packed.cu), kept apart so K2's times stay as they
// are:
//
// - one CTA per (q-block of 32 rows, head, batch), eight threads per query
//   row; the row's query lives in registers, so a score costs one
//   shared-memory float4 of K per four FMAs;
// - the kv walk is one loop over the prefix's 64-row tiles, then the latent
//   tiles up to the block's last query; each tile is staged from its own
//   segment's base pointer, so no joined K/V exists, not even in shared
//   memory; no tile straddles the seam, and the last tile of each segment
//   masks its rows past Np (or Nq);
// - P@V: each thread owns DMAX/8 output channels as float4 chunks 32 words
//   apart, so the eight threads of a row cover 32 consecutive banks.
//
// A row whose visible keys all carry MASK_VALUE gets the uniform average of
// those keys' values, like the plain version in ops/flash_attention.py.
// Every row sees at least one prefix key (Np >= 1), so lse is finite.

#include "common.cuh"

namespace {

constexpr int BQ = 32;          // query rows per CTA
constexpr int BKV = 64;         // kv rows per shared-memory tile
constexpr int TPR = 8;          // threads per query row
constexpr int NT = BQ * TPR;    // 256 threads
constexpr int SC = BKV / TPR;   // scores each thread holds per kv tile

__device__ __forceinline__ float4 load4(const float* p) { return *reinterpret_cast<const float4*>(p); }

template <int DMAX>
__global__ void __launch_bounds__(NT) flash_2seg_fwd_kernel(
    const float* __restrict__ q, const float* __restrict__ k_p, const float* __restrict__ v_p,
    const float* __restrict__ k_l, const float* __restrict__ v_l, const float* __restrict__ bias_p,
    const float* __restrict__ bias_l, float* __restrict__ o, float* __restrict__ lse, int nq, int np, int h,
    int dqk, int dv, float sm_scale) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int ldk = dqk + 4;   // rows stay 16-byte aligned; +4 words shifts banks
  const int ldv = dv + 4;
  const int ldp = BKV + 1;
  float* sk = smem;
  float* sv = sk + BKV * ldk;
  float* sp = sv + BKV * ldv;
  float* sb = sp + BQ * ldp;

  const int q0 = blockIdx.x * BQ;
  const int head = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int r = tid / TPR;    // this thread's query row within the block
  const int sub = tid % TPR;  // its place among the row's eight threads
  const int i = q0 + r;

  const long row_qk = (long)h * dqk;
  const long row_v = (long)h * dv;
  const float* qh = q + (long)b * nq * row_qk + (long)head * dqk;

  float qr[DMAX];
#pragma unroll
  for (int c4 = 0; c4 < DMAX / 4; ++c4) {
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (i < nq && 4 * c4 < dqk) x = load4(qh + (long)i * row_qk + 4 * c4);
    qr[4 * c4] = x.x;
    qr[4 * c4 + 1] = x.y;
    qr[4 * c4 + 2] = x.z;
    qr[4 * c4 + 3] = x.w;
  }

  // every prefix tile, then the latent tiles up to the block's last query
  const int n_pt = (np + BKV - 1) / BKV;
  const int n_tiles = n_pt + (min(q0 + BQ, nq) + BKV - 1) / BKV;

  float m = -CUDART_INF_F;
  float l = 0.f;
  float acc[DMAX / 8];
#pragma unroll
  for (int cc = 0; cc < DMAX / 8; ++cc) acc[cc] = 0.f;

  for (int t = 0; t < n_tiles; ++t) {
    const bool pre = t < n_pt;
    const int j0 = (pre ? t : t - n_pt) * BKV;  // first row of the tile in its segment
    const int n = pre ? np : nq;                // the segment's length
    const float* kh = (pre ? k_p : k_l) + (long)b * n * row_qk + (long)head * dqk;
    const float* vh = (pre ? v_p : v_l) + (long)b * n * row_v + (long)head * dv;
    const float* bias = pre ? bias_p : bias_l;

    __syncthreads();  // the previous tile's readers are done
    for (int idx = tid; idx < BKV * (dqk / 4); idx += NT) {
      const int rr = idx / (dqk / 4), c = 4 * (idx - rr * (dqk / 4)), gj = j0 + rr;
      const float4 x = gj < n ? load4(kh + (long)gj * row_qk + c) : make_float4(0.f, 0.f, 0.f, 0.f);
      *reinterpret_cast<float4*>(sk + rr * ldk + c) = x;
    }
    for (int idx = tid; idx < BKV * (dv / 4); idx += NT) {
      const int rr = idx / (dv / 4), c = 4 * (idx - rr * (dv / 4)), gj = j0 + rr;
      const float4 x = gj < n ? load4(vh + (long)gj * row_v + c) : make_float4(0.f, 0.f, 0.f, 0.f);
      *reinterpret_cast<float4*>(sv + rr * ldv + c) = x;
    }
    if (tid < BKV) {
      const int gj = j0 + tid;
      sb[tid] = (bias != nullptr && gj < n) ? bias[(long)b * n + gj] : 0.f;
    }
    __syncthreads();

    float s[SC];
    float tmax = -CUDART_INF_F;
#pragma unroll
    for (int u = 0; u < SC; ++u) {
      const int jj = sub + TPR * u;
      const int j = j0 + jj;
      const float* kr = sk + jj * ldk;
      float dot = 0.f;
#pragma unroll
      for (int c4 = 0; c4 < DMAX / 4; ++c4) {
        if (4 * c4 < dqk) {
          const float4 kk = *reinterpret_cast<const float4*>(kr + 4 * c4);
          dot = fmaf(qr[4 * c4], kk.x, dot);
          dot = fmaf(qr[4 * c4 + 1], kk.y, dot);
          dot = fmaf(qr[4 * c4 + 2], kk.z, dot);
          dot = fmaf(qr[4 * c4 + 3], kk.w, dot);
        }
      }
      // a prefix row is seen by every query, latent row j by queries i >= j
      const bool visible = j < n && (pre || j <= i);
      const float val = visible ? dot * sm_scale + sb[jj] : -CUDART_INF_F;
      s[u] = val;
      tmax = fmaxf(tmax, val);
    }
#pragma unroll
    for (int w = 1; w < TPR; w <<= 1) tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, w));
    const float m_new = fmaxf(m, tmax);
    // a row with nothing visible yet keeps p = 0 and alpha = 0 (no inf - inf)
    const float m_use = m_new == -CUDART_INF_F ? 0.f : m_new;
    const float alpha = expf(m - m_use);
    float psum = 0.f;
    float* pr = sp + r * ldp;
#pragma unroll
    for (int u = 0; u < SC; ++u) {
      const float p = expf(s[u] - m_use);
      psum += p;
      pr[sub + TPR * u] = p;
    }
#pragma unroll
    for (int w = 1; w < TPR; w <<= 1) psum += __shfl_xor_sync(0xffffffffu, psum, w);
    l = l * alpha + psum;
    m = m_new;
    __syncwarp();  // the row's eight threads share pr, all in this warp

#pragma unroll
    for (int cc = 0; cc < DMAX / 8; ++cc) acc[cc] *= alpha;
#pragma unroll 4
    for (int jj = 0; jj < BKV; ++jj) {
      const float p = pr[jj];
      const float* vr = sv + jj * ldv;
#pragma unroll
      for (int g = 0; g < DMAX / 32; ++g) {
        const int c = 4 * sub + 32 * g;
        if (c < dv) {
          const float4 vv = *reinterpret_cast<const float4*>(vr + c);
          acc[4 * g] = fmaf(p, vv.x, acc[4 * g]);
          acc[4 * g + 1] = fmaf(p, vv.y, acc[4 * g + 1]);
          acc[4 * g + 2] = fmaf(p, vv.z, acc[4 * g + 2]);
          acc[4 * g + 3] = fmaf(p, vv.w, acc[4 * g + 3]);
        }
      }
    }
  }

  if (i < nq) {  // padded query rows are never written
    const float inv = l == 0.f ? 1.f : 1.f / l;
    float* orow = o + ((long)b * nq + i) * row_v + (long)head * dv;
#pragma unroll
    for (int g = 0; g < DMAX / 32; ++g) {
      const int c = 4 * sub + 32 * g;
      if (c < dv) {
#pragma unroll
        for (int e = 0; e < 4; ++e) orow[c + e] = acc[4 * g + e] * inv;
      }
    }
    if (sub == 0) lse[((long)b * nq + i) * h + head] = m + logf(l == 0.f ? 1.f : l);
  }
}

template <int DMAX>
cudaError_t launch(const float* q, const float* k_p, const float* v_p, const float* k_l, const float* v_l,
                   const float* bias_p, const float* bias_l, float* o, float* lse, int batch, int nq, int np, int h,
                   int dqk, int dv, float sm_scale, cudaStream_t stream) {
  const size_t floats = (size_t)BKV * (dqk + 4) + (size_t)BKV * (dv + 4) + (size_t)BQ * (BKV + 1) + BKV;
  const size_t smem = floats * sizeof(float);
  auto kernel = flash_2seg_fwd_kernel<DMAX>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((nq + BQ - 1) / BQ, h, batch);
  kernel<<<grid, NT, smem, stream>>>(q, k_p, v_p, k_l, v_l, bias_p, bias_l, o, lse, nq, np, h, dqk, dv, sm_scale);
  return cudaGetLastError();
}

}  // namespace

// q (B, Nq, H*Dqk), k_p (B, Np, H*Dqk), v_p (B, Np, H*Dv), k_l (B, Nq, H*Dqk),
// v_l (B, Nq, H*Dv), all f32 and contiguous; bias_p (B, Np) and bias_l
// (B, Nq) f32, each or both null; o (B, Nq, H*Dv) f32; lse (B, Nq, H) f32.
// Returns a cudaError_t (0 = launched).
extern "C" int pio_flash_2seg_fwd(const float* q, const float* k_p, const float* v_p, const float* k_l,
                                  const float* v_l, const float* bias_p, const float* bias_l, float* o, float* lse,
                                  int batch, int nq, int np, int h, int dqk, int dv, float sm_scale, void* stream) {
  if (batch <= 0 || nq <= 0 || h <= 0) return cudaSuccess;
  if (np < 1 || dqk <= 0 || dv <= 0 || dqk % 8 || dv % 8 || dqk > 128 || dv > 128 || h > 65535 || batch > 65535)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int d = dqk > dv ? dqk : dv;
  if (d <= 32) return launch<32>(q, k_p, v_p, k_l, v_l, bias_p, bias_l, o, lse, batch, nq, np, h, dqk, dv, sm_scale, s);
  if (d <= 64) return launch<64>(q, k_p, v_p, k_l, v_l, bias_p, bias_l, o, lse, batch, nq, np, h, dqk, dv, sm_scale, s);
  return launch<128>(q, k_p, v_p, k_l, v_l, bias_p, bias_l, o, lse, batch, nq, np, h, dqk, dv, sm_scale, s);
}
