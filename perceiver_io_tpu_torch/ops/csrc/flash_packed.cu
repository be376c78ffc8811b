// K2: packed flash attention forward for Hopper (sm_90a), plain CUDA C++.
//
// Replaces the TPU kernel perceiver_io_tpu/ops/flash_attention.py
// _fwd_packed_kernel (reached from _flash_packed_fwd_impl via
// flash_attention_packed). Same function: online-softmax attention over the
// packed (B, N, H*D) layout, right-aligned causal mask j <= i + (nkv - nq)
// from the unpadded lengths, an additive f32 kv bias row (0 or the finite
// MASK_VALUE), f32 running max / sum / accumulator, the l == 0 guard, and the
// per-row logsumexp (B, Nq, H) the backward will need.
//
// What bounds it: at the flagship prefill (Nq = 512 latents over Nkv = 16384
// keys, D = 64) the work is ~17 GFLOP against ~35 MB of operands, far above
// the card's operations-per-byte line, so it is bound by arithmetic. The f32
// path must keep full f32 products (TF32 would miss the parity tolerance), so
// this version runs them on the CUDA cores (no wgmma, no TMA). Its design is
// about feeding those FMAs from shared memory without stalls:
//
// - one CTA per (q-block of 32 rows, head, batch): 128 CTAs at the flagship
//   prefill, about one per SM; eight threads share a query row;
// - the thread's query row lives in registers, so a score costs one
//   shared-memory load (a float4 of K) per four FMAs; K/V tiles of 64 rows are
//   staged in shared memory with rows padded to a multiple of four words, so
//   the eight threads of a row read eight consecutive K rows without bank
//   conflicts;
// - P@V: each thread owns DMAX/8 output channels as float4 chunks 32 words
//   apart, so the eight threads of a row cover 32 consecutive banks.
//
// A head is a strided column slice of the packed rows (row stride H*D), so no
// transpose copy is made. The kv loop stops at the last tile the block's
// causal limit can see; keys past a row's own limit (or past nkv) never enter
// its softmax. A row whose visible keys all carry MASK_VALUE gets the uniform
// average of those keys' values, like the plain version in
// ops/flash_attention.py. Moving the products onto the tensor cores (bf16
// wgmma) is later work.

#include "common.cuh"

namespace {

constexpr int BQ = 32;          // query rows per CTA
constexpr int BKV = 64;         // kv rows per shared-memory tile
constexpr int TPR = 8;          // threads per query row
constexpr int NT = BQ * TPR;    // 256 threads
constexpr int SC = BKV / TPR;   // scores each thread holds per kv tile

__device__ __forceinline__ float4 load4(const float* p) { return *reinterpret_cast<const float4*>(p); }
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const __nv_bfloat162 a = reinterpret_cast<const __nv_bfloat162*>(p)[0];
  const __nv_bfloat162 b = reinterpret_cast<const __nv_bfloat162*>(p)[1];
  return make_float4(__low2float(a), __high2float(a), __low2float(b), __high2float(b));
}

template <typename T, int DMAX>
__global__ void __launch_bounds__(NT) flash_packed_fwd_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const float* __restrict__ bias, T* __restrict__ o, float* __restrict__ lse,
    int nq, int nkv, int h, int dqk, int dv, int causal, float sm_scale) {
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
  const T* qh = q + (long)b * nq * row_qk + (long)head * dqk;
  const T* kh = k + (long)b * nkv * row_qk + (long)head * dqk;
  const T* vh = v + (long)b * nkv * row_v + (long)head * dv;

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

  const int offset = nkv - nq;
  int kv_end = nkv;
  if (causal) kv_end = min(nkv, min(q0 + BQ, nq) + offset);

  float m = -CUDART_INF_F;
  float l = 0.f;
  float acc[DMAX / 8];
#pragma unroll
  for (int cc = 0; cc < DMAX / 8; ++cc) acc[cc] = 0.f;

  for (int j0 = 0; j0 < kv_end; j0 += BKV) {
    __syncthreads();  // the previous tile's readers are done
    for (int idx = tid; idx < BKV * (dqk / 4); idx += NT) {
      const int rr = idx / (dqk / 4), c = 4 * (idx - rr * (dqk / 4)), gj = j0 + rr;
      const float4 x = gj < nkv ? load4(kh + (long)gj * row_qk + c) : make_float4(0.f, 0.f, 0.f, 0.f);
      *reinterpret_cast<float4*>(sk + rr * ldk + c) = x;
    }
    for (int idx = tid; idx < BKV * (dv / 4); idx += NT) {
      const int rr = idx / (dv / 4), c = 4 * (idx - rr * (dv / 4)), gj = j0 + rr;
      const float4 x = gj < nkv ? load4(vh + (long)gj * row_v + c) : make_float4(0.f, 0.f, 0.f, 0.f);
      *reinterpret_cast<float4*>(sv + rr * ldv + c) = x;
    }
    if (tid < BKV) {
      const int gj = j0 + tid;
      sb[tid] = (bias != nullptr && gj < nkv) ? bias[(long)b * nkv + gj] : 0.f;
    }
    __syncthreads();

    float s[SC];
    float tmax = -CUDART_INF_F;
#pragma unroll
    for (int t = 0; t < SC; ++t) {
      const int jj = sub + TPR * t;
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
      const bool visible = j < nkv && (!causal || j <= i + offset);
      const float val = visible ? dot * sm_scale + sb[jj] : -CUDART_INF_F;
      s[t] = val;
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
    for (int t = 0; t < SC; ++t) {
      const float p = expf(s[t] - m_use);
      psum += p;
      pr[sub + TPR * t] = p;
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
    T* orow = o + ((long)b * nq + i) * row_v + (long)head * dv;
#pragma unroll
    for (int g = 0; g < DMAX / 32; ++g) {
      const int c = 4 * sub + 32 * g;
      if (c < dv) {
#pragma unroll
        for (int e = 0; e < 4; ++e) orow[c + e] = pio::from_f32<T>(acc[4 * g + e] * inv);
      }
    }
    if (sub == 0) lse[((long)b * nq + i) * h + head] = m + logf(l == 0.f ? 1.f : l);
  }
}

template <typename T, int DMAX>
cudaError_t launch(const void* q, const void* k, const void* v, const float* bias, void* o,
                   float* lse, int batch, int nq, int nkv, int h, int dqk, int dv, int causal,
                   float sm_scale, cudaStream_t stream) {
  const size_t floats = (size_t)BKV * (dqk + 4) + (size_t)BKV * (dv + 4) +
                        (size_t)BQ * (BKV + 1) + BKV;
  const size_t smem = floats * sizeof(float);
  auto kernel = flash_packed_fwd_kernel<T, DMAX>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((nq + BQ - 1) / BQ, h, batch);
  kernel<<<grid, NT, smem, stream>>>(static_cast<const T*>(q), static_cast<const T*>(k),
                                     static_cast<const T*>(v), bias, static_cast<T*>(o), lse,
                                     nq, nkv, h, dqk, dv, causal, sm_scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* q, const void* k, const void* v, const float* bias, void* o,
                     float* lse, int batch, int nq, int nkv, int h, int dqk, int dv, int causal,
                     float sm_scale, cudaStream_t stream) {
  const int dmax = dqk > dv ? dqk : dv;
  if (dmax <= 32)
    return launch<T, 32>(q, k, v, bias, o, lse, batch, nq, nkv, h, dqk, dv, causal, sm_scale, stream);
  if (dmax <= 64)
    return launch<T, 64>(q, k, v, bias, o, lse, batch, nq, nkv, h, dqk, dv, causal, sm_scale, stream);
  return launch<T, 128>(q, k, v, bias, o, lse, batch, nq, nkv, h, dqk, dv, causal, sm_scale, stream);
}

}  // namespace

// q (B, Nq, H*Dqk), k (B, Nkv, H*Dqk), v (B, Nkv, H*Dv), all contiguous and of
// one dtype (0 = f32, 1 = bf16); bias (B, Nkv) f32 or null; o (B, Nq, H*Dv) in
// the input dtype; lse (B, Nq, H) f32. Returns a cudaError_t (0 = launched).
extern "C" int pio_flash_packed_fwd(const void* q, const void* k, const void* v,
                                    const float* bias, void* o, float* lse, int batch, int nq,
                                    int nkv, int h, int dqk, int dv, int causal, float sm_scale,
                                    int dtype, void* stream) {
  if (batch <= 0 || nq <= 0 || h <= 0) return cudaSuccess;
  if (dqk <= 0 || dv <= 0 || dqk % 8 || dv % 8 || dqk > 128 || dv > 128 || nkv < 0 ||
      h > 65535 || batch > 65535)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == pio::kF32)
    return dispatch<float>(q, k, v, bias, o, lse, batch, nq, nkv, h, dqk, dv, causal, sm_scale, s);
  if (dtype == pio::kBF16)
    return dispatch<__nv_bfloat16>(q, k, v, bias, o, lse, batch, nq, nkv, h, dqk, dv, causal,
                                   sm_scale, s);
  return cudaErrorInvalidValue;
}
