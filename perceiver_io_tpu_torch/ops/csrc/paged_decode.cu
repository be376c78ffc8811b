// K3: paged decode attention for Hopper (sm_90a), plain CUDA C++.
//
// Replaces the TPU kernel perceiver_io_tpu/ops/paged_attention.py
// _paged_kernel (reached from paged_decode_attention). Same function: one
// query per decode slot, scaled and rotated by the caller, attends over the
// slot's first length[s] tokens; token t of slot s lives at pool row
// (page_table[s, t / page], t % page); an optional additive f32 bias row (0
// or the finite MASK_VALUE, built from the caller's (S, capacity) pad/window
// mask) masks more of them; the softmax runs online in f32. Pools are f32,
// the serving path's cache dtype.
//
// What bounds it: decode reads every valid K/V row once and does two FMAs per
// element read, so it is bound by memory bytes. The TPU kernel walks one
// slot's pages in order on one core; here the walk is split so the card's
// 132 SMs all stream pages (split-kv, "flash-decoding"):
//
// - pass 1, grid (slot, head, split): each CTA takes a contiguous run of the
//   slot's ceil(length / page) pages, read straight from the pool through the
//   page table (the contiguous view is never built), and stops at the slot's
//   length. Each warp scores TPI tokens per iteration, lanes across head
//   channels (coalesced row reads, one warp-shuffle reduction per token), and
//   keeps its own running max, sum and accumulator; the CTA merges its warps
//   and writes one partial (max, sum, acc[Dv]) to a scratch buffer the
//   wrapper allocated;
// - pass 2, grid (slot, head): merges the splits' partials and normalizes.
//
// Tokens at or past the slot's length never enter the softmax, so they
// contribute exactly 0, and a bias-masked token contributes exactly 0 once
// the slot has an unmasked token. A slot with length 0 (retired) gets 0; the
// engine discards that output.

#include "common.cuh"

namespace {

constexpr int NW = 4;         // warps per CTA in pass 1
constexpr int NT = NW * 32;
constexpr int TPI = 4;        // tokens a warp scores per iteration
constexpr int CPL = 4;        // head channels per lane: Dqk, Dv <= 128

__global__ void __launch_bounds__(NT) paged_decode_split_kernel(
    const float* __restrict__ q, const float* __restrict__ kpool, const float* __restrict__ vpool,
    const int* __restrict__ table, const int* __restrict__ length,
    const float* __restrict__ bias, float* __restrict__ part, int h, int dqk, int dv, int page,
    int pps, int nsplit) {
  __shared__ float sm_m[NW], sm_l[NW];
  __shared__ float sm_acc[NW][CPL * 32];

  const int slot = blockIdx.x, head = blockIdx.y, split = blockIdx.z;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long row_qk = (long)h * dqk, row_v = (long)h * dv;
  const long cap = (long)pps * page;

  const int len = length[slot];
  const int n_pages = len <= 0 ? 0 : min(pps, (len + page - 1) / page);
  const int per = (n_pages + nsplit - 1) / nsplit;
  const int t_begin = min(n_pages, split * per) * page;
  const int t_end = min(len, min(n_pages, (split + 1) * per) * page);

  float qr[CPL];
#pragma unroll
  for (int i = 0; i < CPL; ++i) {
    const int c = lane + 32 * i;
    qr[i] = c < dqk ? q[slot * row_qk + (long)head * dqk + c] : 0.f;
  }
  float m = -CUDART_INF_F, l = 0.f, acc[CPL];
#pragma unroll
  for (int i = 0; i < CPL; ++i) acc[i] = 0.f;

  for (int t0 = t_begin + warp * TPI; t0 < t_end; t0 += NW * TPI) {
    float s[TPI], vv[TPI][CPL];
#pragma unroll
    for (int u = 0; u < TPI; ++u) {
      const int t = t0 + u;
      s[u] = 0.f;
#pragma unroll
      for (int i = 0; i < CPL; ++i) vv[u][i] = 0.f;
      if (t < t_end) {
        const long row = (long)table[(long)slot * pps + t / page] * page + t % page;
        const float* krow = kpool + row * row_qk + (long)head * dqk;
        const float* vrow = vpool + row * row_v + (long)head * dv;
#pragma unroll
        for (int i = 0; i < CPL; ++i) {
          const int c = lane + 32 * i;
          if (c < dqk) s[u] = fmaf(qr[i], krow[c], s[u]);
          if (c < dv) vv[u][i] = vrow[c];
        }
      }
    }
#pragma unroll
    for (int w = 16; w > 0; w >>= 1) {
#pragma unroll
      for (int u = 0; u < TPI; ++u) s[u] += __shfl_xor_sync(0xffffffffu, s[u], w);
    }
    // t0 < t_end, so at least s[0] is a finite score and m_new is finite
    float m_new = m;
#pragma unroll
    for (int u = 0; u < TPI; ++u) {
      const int t = t0 + u;
      if (t >= t_end)
        s[u] = -CUDART_INF_F;
      else if (bias != nullptr)
        s[u] += bias[(long)slot * cap + t];
      m_new = fmaxf(m_new, s[u]);
    }
    const float alpha = expf(m - m_new);
    l *= alpha;
#pragma unroll
    for (int i = 0; i < CPL; ++i) acc[i] *= alpha;
#pragma unroll
    for (int u = 0; u < TPI; ++u) {
      const float p = expf(s[u] - m_new);
      l += p;
#pragma unroll
      for (int i = 0; i < CPL; ++i) acc[i] = fmaf(p, vv[u][i], acc[i]);
    }
    m = m_new;
  }

  // merge the warps' states; a warp that saw no token has m = -inf, l = 0
  if (lane == 0) {
    sm_m[warp] = m;
    sm_l[warp] = l;
  }
#pragma unroll
  for (int i = 0; i < CPL; ++i) sm_acc[warp][lane + 32 * i] = acc[i];
  __syncthreads();
  float mm = -CUDART_INF_F;
#pragma unroll
  for (int w = 0; w < NW; ++w) mm = fmaxf(mm, sm_m[w]);
  float scale[NW];
#pragma unroll
  for (int w = 0; w < NW; ++w) scale[w] = sm_m[w] == -CUDART_INF_F ? 0.f : expf(sm_m[w] - mm);
  float* out = part + (((long)slot * h + head) * nsplit + split) * (dv + 2);
  for (int c = threadIdx.x; c < dv; c += NT) {
    float a = 0.f;
#pragma unroll
    for (int w = 0; w < NW; ++w) a = fmaf(sm_acc[w][c], scale[w], a);
    out[2 + c] = a;
  }
  if (threadIdx.x == 0) {
    float ll = 0.f;
#pragma unroll
    for (int w = 0; w < NW; ++w) ll = fmaf(sm_l[w], scale[w], ll);
    out[0] = mm;
    out[1] = ll;
  }
}

__global__ void __launch_bounds__(128) paged_decode_combine_kernel(
    const float* __restrict__ part, float* __restrict__ out, int h, int dv, int nsplit) {
  const int slot = blockIdx.x, head = blockIdx.y;
  const long stride = dv + 2;
  const float* p = part + ((long)slot * h + head) * nsplit * stride;
  float mm = -CUDART_INF_F;
  for (int z = 0; z < nsplit; ++z) mm = fmaxf(mm, p[z * stride]);
  float ll = 0.f;
  for (int z = 0; z < nsplit; ++z) {
    const float mz = p[z * stride];
    if (mz != -CUDART_INF_F) ll = fmaf(p[z * stride + 1], expf(mz - mm), ll);
  }
  const float inv = ll == 0.f ? 0.f : 1.f / ll;
  for (int c = threadIdx.x; c < dv; c += blockDim.x) {
    float a = 0.f;
    for (int z = 0; z < nsplit; ++z) {
      const float mz = p[z * stride];
      if (mz != -CUDART_INF_F) a = fmaf(p[z * stride + 2 + c], expf(mz - mm), a);
    }
    out[(long)slot * h * dv + (long)head * dv + c] = a * inv;
  }
}

}  // namespace

// q (S, H*Dqk); pools k (P, page, H*Dqk), v (P, page, H*Dv); table (S, pps)
// int32; length (S,) int32; bias (S, pps*page) or null; part
// (S, H, nsplit, Dv + 2) scratch; out (S, H*Dv); all float tensors f32.
// Returns a cudaError_t (0 = launched).
extern "C" int pio_paged_decode(const float* q, const float* kpool, const float* vpool,
                                const int* table, const int* length, const float* bias, float* part,
                                float* out, int slots, int h, int dqk, int dv, int page, int pps,
                                int nsplit, void* stream) {
  if (slots <= 0 || h <= 0) return cudaSuccess;
  if (dqk <= 0 || dv <= 0 || dqk > 32 * CPL || dv > 32 * CPL || page <= 0 || pps <= 0 ||
      nsplit <= 0 || h > 65535 || nsplit > 65535)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  paged_decode_split_kernel<<<dim3(slots, h, nsplit), NT, 0, s>>>(
      q, kpool, vpool, table, length, bias, part, h, dqk, dv, page, pps, nsplit);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  paged_decode_combine_kernel<<<dim3(slots, h), 128, 0, s>>>(part, out, h, dv, nsplit);
  return cudaGetLastError();
}
