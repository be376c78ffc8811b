// K4a + K4b: packed flash attention backward for Hopper (sm_90a), CUDA C++,
// on the tensor cores: an f32 build and a bf16 build behind one C interface
// with a dtype code (0 f32, 1 bf16), as K2's.
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
// mma.sync (m16n8k4 in K4a; m16n8k16 in K4b up to head dim 64, m16n8k8
// above), whose products are exact, and K4a's dV and dK split-TF32 by
// mma.sync m16n8k8 (each operand split into a TF32 big part and its
// residual, three mmas a product) at f32 accuracy. The bound counts every
// product at the split-TF32 rate, 165 TFLOP/s; mma.sync reaches a fraction
// of the rate that wgmma would (PERF.md). On an H100 a product in f64 by
// m16n8k4 (two mmas per 8 columns of depth) ran as fast as a split-TF32 one
// (three m16n8k8) or faster; K4b's larger f64 shapes ran it 10-17% faster
// than m16n8k4, K4a's ran it no faster (PERF.md).
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
// The bf16 build (flash_bwd_dq_bf16_kernel, flash_bwd_dkv_bf16_kernel,
// bodies dq_walk16 / dkv_walk16 in flash_mma_bwd.cuh) is the JAX kernels' bf16
// arithmetic: bf16 products summed in f32 by mma.sync m16n8k16, p and dS
// rounded to bf16 before the gradient products, gradients written in bf16.
// It moves half the f32 build's bytes and runs at the bf16 tensor-core rate
// (989 TFLOP/s dense), the bound chip_smoke.py charges it.
//
// A head is a strided column slice of the packed rows (row stride H*D), so no
// transpose copy is made. The kernel bodies (dq_walk, dkv_walk) live in
// flash_mma_bwd.cuh, shared with K7a / K7b (flash_2seg_bwd.cu): a K4 CTA
// walks one segment, the whole kv sequence under its right-aligned causal
// offset.

#include "flash_mma_bwd.cuh"

namespace {

using namespace pio::mma_bwd;

// K4b: one CTA per (BQ query rows, head, batch); walks the kv tiles up to
// the last one the block's causal limit can see.
template <int DMAX>
__global__ void __launch_bounds__(Dq<DMAX>::NT, Dq<DMAX>::MIN_BLOCKS) flash_bwd_dq_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    const float* __restrict__ dout, const float* __restrict__ lse, const float* __restrict__ delta,
    const float* __restrict__ bias, float* __restrict__ dq, int nq, int nkv, int h, int dqk, int dv,
    int causal, float sm_scale) {
  using P = Dq<DMAX>;
  const int q0 = blockIdx.x * P::BQ, head = blockIdx.y, b = blockIdx.z;
  const long row_qk = (long)h * dqk, row_v = (long)h * dv;
  const int off = causal ? nkv - nq : NO_LIMIT;
  const int kv_end = causal ? max(0, min(nkv, min(q0 + P::BQ, nq) + off)) : nkv;
  const Tile<float> seg{k + (long)b * nkv * row_qk + (long)head * dqk, v + (long)b * nkv * row_v + (long)head * dv,
                        bias == nullptr ? nullptr : bias + (long)b * nkv, 0, nkv, off};
  dq_walk<DMAX>(q, dout, lse, delta, dq, nq, h, dqk, dv, sm_scale, (kv_end + P::BKV - 1) / P::BKV, [&](int t) {
    Tile<float> tl = seg;
    tl.j0 = t * P::BKV;
    return tl;
  });
}

// K4a: one CTA per (BKV kv rows, head, batch); walks the q tiles from the
// first one whose rows can see the block's first key.
template <int DMAX>
__global__ void __launch_bounds__(Dkv<DMAX>::NT, Dkv<DMAX>::MIN_BLOCKS) flash_bwd_dkv_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    const float* __restrict__ dout, const float* __restrict__ lse, const float* __restrict__ delta,
    const float* __restrict__ bias, float* __restrict__ dk, float* __restrict__ dvo, int nq, int nkv, int h,
    int dqk, int dv, int causal, float sm_scale) {
  const int head = blockIdx.y, b = blockIdx.z;
  const long kv_qk = (long)b * nkv * h * dqk + (long)head * dqk, kv_v = (long)b * nkv * h * dv + (long)head * dv;
  const Tile<float> seg{k + kv_qk, v + kv_v, bias == nullptr ? nullptr : bias + (long)b * nkv,
                        (int)blockIdx.x * Dkv<DMAX>::BKV, nkv, causal ? nkv - nq : NO_LIMIT};
  dkv_walk<DMAX>(q, dout, lse, delta, seg, dk + kv_qk, dvo + kv_v, b, head, nq, h, dqk, dv, sm_scale);
}

// K4b, bf16: as flash_bwd_dq_kernel, on B16's tiles
template <int DMAX>
__global__ void __launch_bounds__(B16<DMAX>::NT, B16<DMAX>::MIN_BLOCKS) flash_bwd_dq_bf16_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    const bf16* __restrict__ dout, const float* __restrict__ lse, const float* __restrict__ delta,
    const float* __restrict__ bias, bf16* __restrict__ dq, int nq, int nkv, int h, int dqk, int dv, int causal,
    float sm_scale) {
  using P = B16<DMAX>;
  const int q0 = blockIdx.x * P::BM, head = blockIdx.y, b = blockIdx.z;
  const long row_qk = (long)h * dqk, row_v = (long)h * dv;
  const int off = causal ? nkv - nq : NO_LIMIT;
  const int kv_end = causal ? max(0, min(nkv, min(q0 + P::BM, nq) + off)) : nkv;
  const Tile<bf16> seg{k + (long)b * nkv * row_qk + (long)head * dqk, v + (long)b * nkv * row_v + (long)head * dv,
                       bias == nullptr ? nullptr : bias + (long)b * nkv, 0, nkv, off};
  dq_walk16<DMAX>(q, dout, lse, delta, dq, nq, h, dqk, dv, sm_scale, (kv_end + P::BN - 1) / P::BN, [&](int t) {
    Tile<bf16> tl = seg;
    tl.j0 = t * P::BN;
    return tl;
  });
}

// K4a, bf16: as flash_bwd_dkv_kernel, on B16's tiles
template <int DMAX>
__global__ void __launch_bounds__(B16<DMAX>::NT, B16<DMAX>::MIN_BLOCKS) flash_bwd_dkv_bf16_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    const bf16* __restrict__ dout, const float* __restrict__ lse, const float* __restrict__ delta,
    const float* __restrict__ bias, bf16* __restrict__ dk, bf16* __restrict__ dvo, int nq, int nkv, int h,
    int dqk, int dv, int causal, float sm_scale) {
  const int head = blockIdx.y, b = blockIdx.z;
  const long kv_qk = (long)b * nkv * h * dqk + (long)head * dqk, kv_v = (long)b * nkv * h * dv + (long)head * dv;
  const Tile<bf16> seg{k + kv_qk, v + kv_v, bias == nullptr ? nullptr : bias + (long)b * nkv,
                       (int)blockIdx.x * B16<DMAX>::BM, nkv, causal ? nkv - nq : NO_LIMIT};
  dkv_walk16<DMAX>(q, dout, lse, delta, seg, dk + kv_qk, dvo + kv_v, b, head, nq, h, dqk, dv, sm_scale);
}

struct Args {
  const void *q, *k, *v, *dout;
  const float *lse, *delta, *bias;
  void *dq, *dk, *dv;
  int batch, nq, nkv, h, dqk, dv_, causal;
  float sm_scale;
  cudaStream_t stream;
};

template <typename T>
const T* in(const void* p) {
  return static_cast<const T*>(p);
}

template <typename T>
T* out(void* p) {
  return static_cast<T*>(p);
}

template <int DMAX>
cudaError_t launch_dq(const Args& a) {
  using P = Dq<DMAX>;
  auto kernel = flash_bwd_dq_kernel<DMAX>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)P::BYTES);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.nq + P::BQ - 1) / P::BQ, a.h, a.batch);
  kernel<<<grid, P::NT, P::BYTES, a.stream>>>(in<float>(a.q), in<float>(a.k), in<float>(a.v), in<float>(a.dout),
                                                a.lse, a.delta, a.bias, out<float>(a.dq), a.nq, a.nkv, a.h, a.dqk,
                                                a.dv_, a.causal, a.sm_scale);
  return cudaGetLastError();
}

template <int DMAX>
cudaError_t launch_dq_bf16(const Args& a) {
  using P = B16<DMAX>;
  auto kernel = flash_bwd_dq_bf16_kernel<DMAX>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)P::BYTES);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.nq + P::BM - 1) / P::BM, a.h, a.batch);
  kernel<<<grid, P::NT, P::BYTES, a.stream>>>(in<bf16>(a.q), in<bf16>(a.k), in<bf16>(a.v), in<bf16>(a.dout), a.lse,
                                                a.delta, a.bias, out<bf16>(a.dq), a.nq, a.nkv, a.h, a.dqk, a.dv_,
                                                a.causal, a.sm_scale);
  return cudaGetLastError();
}

template <int DMAX>
cudaError_t launch_dkv(const Args& a) {
  using P = Dkv<DMAX>;
  auto kernel = flash_bwd_dkv_kernel<DMAX>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)P::BYTES);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.nkv + P::BKV - 1) / P::BKV, a.h, a.batch);
  kernel<<<grid, P::NT, P::BYTES, a.stream>>>(in<float>(a.q), in<float>(a.k), in<float>(a.v), in<float>(a.dout),
                                                a.lse, a.delta, a.bias, out<float>(a.dk), out<float>(a.dv), a.nq,
                                                a.nkv, a.h, a.dqk, a.dv_, a.causal, a.sm_scale);
  return cudaGetLastError();
}

template <int DMAX>
cudaError_t launch_dkv_bf16(const Args& a) {
  using P = B16<DMAX>;
  auto kernel = flash_bwd_dkv_bf16_kernel<DMAX>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)P::BYTES);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.nkv + P::BM - 1) / P::BM, a.h, a.batch);
  kernel<<<grid, P::NT, P::BYTES, a.stream>>>(in<bf16>(a.q), in<bf16>(a.k), in<bf16>(a.v), in<bf16>(a.dout), a.lse,
                                                a.delta, a.bias, out<bf16>(a.dk), out<bf16>(a.dv), a.nq, a.nkv, a.h,
                                                a.dqk, a.dv_, a.causal, a.sm_scale);
  return cudaGetLastError();
}

bool valid(const Args& a) {
  return a.dqk > 0 && a.dv_ > 0 && a.dqk % 8 == 0 && a.dv_ % 8 == 0 && a.dqk <= 128 && a.dv_ <= 128 &&
         a.nq >= 0 && a.nkv >= 0 && a.h <= 65535 && a.batch <= 65535;
}

}  // namespace

// q/dout (B, Nq, H*D), k/v (B, Nkv, H*D), all f32 (dtype 0) or all bf16
// (dtype 1), contiguous and 16-byte aligned; lse/delta (B, Nq, H) f32; bias
// (B, Nkv) f32 or null. K4a writes dk (B, Nkv, H*Dqk) and dv (B, Nkv, H*Dv);
// K4b writes dq (B, Nq, H*Dqk), in the operands' dtype. Each returns a
// cudaError_t (0 = launched).
extern "C" int pio_flash_packed_bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
                                        const float* lse, const float* delta, const float* bias, void* dk, void* dv,
                                        int batch, int nq, int nkv, int h, int dqk, int dv_, int causal,
                                        float sm_scale, int dtype, void* stream) {
  const Args a{q, k, v, dout, lse, delta, bias, nullptr, dk, dv, batch, nq, nkv, h, dqk, dv_, causal, sm_scale,
               static_cast<cudaStream_t>(stream)};
  if (batch <= 0 || nkv <= 0 || h <= 0) return cudaSuccess;
  if (!valid(a) || (dtype != pio::kF32 && dtype != pio::kBF16)) return cudaErrorInvalidValue;
  const int bucket = dmax_bucket(a.dqk, a.dv_);
  if (dtype == pio::kBF16) return bucket == 32 ? launch_dkv_bf16<32>(a) : bucket == 64 ? launch_dkv_bf16<64>(a)
                                                                                    : launch_dkv_bf16<128>(a);
  switch (bucket) {
    case 32: return launch_dkv<32>(a);
    case 64: return launch_dkv<64>(a);
    default: return launch_dkv<128>(a);
  }
}

extern "C" int pio_flash_packed_bwd_dq(const void* q, const void* k, const void* v, const void* dout,
                                       const float* lse, const float* delta, const float* bias, void* dq, int batch,
                                       int nq, int nkv, int h, int dqk, int dv_, int causal, float sm_scale,
                                       int dtype, void* stream) {
  const Args a{q, k, v, dout, lse, delta, bias, dq, nullptr, nullptr, batch, nq, nkv, h, dqk, dv_, causal,
               sm_scale, static_cast<cudaStream_t>(stream)};
  if (batch <= 0 || nq <= 0 || h <= 0) return cudaSuccess;
  if (!valid(a) || (dtype != pio::kF32 && dtype != pio::kBF16)) return cudaErrorInvalidValue;
  const int bucket = dmax_bucket(a.dqk, a.dv_);
  if (dtype == pio::kBF16) return bucket == 32 ? launch_dq_bf16<32>(a) : bucket == 64 ? launch_dq_bf16<64>(a)
                                                                                   : launch_dq_bf16<128>(a);
  switch (bucket) {
    case 32: return launch_dq<32>(a);
    case 64: return launch_dq<64>(a);
    default: return launch_dq<128>(a);
  }
}
