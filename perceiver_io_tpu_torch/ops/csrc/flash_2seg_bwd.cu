// K7a + K7b: two-segment packed flash attention backward for Hopper
// (sm_90a), CUDA C++, on the tensor cores: an f32 build and a bf16 build
// behind one C interface with a dtype code (0 f32, 1 bf16), as K4's.
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
// What bounds them: at the flagship training chunk (1024 latents over 7680
// kept prefix rows + 1024 latents, D = 64, batch 2) K7a does four products
// of 2*D operations per visible (query, key) pair and K7b three, ~69 and
// ~52 GFLOP against ~100 MB of operands: arithmetic, as for K4. They run
// K4's bodies on the tensor cores (flash_mma_bwd.cuh: dq_walk and
// dkv_walk): S and dP (S^T and dP^T in K7a) and K7b's dQ += dS K in f64 by
// mma.sync, K7a's dV and dK split-TF32 by mma.sync m16n8k8, the walked
// tiles swizzled and double-buffered by cp.async. The bodies take the kv
// sequence as segments, each tile staged from its own segment's base
// pointer with its own bias row and causal offset (NO_LIMIT for the prefix,
// 0 for the latents in latent-local coordinates), so no joined K/V exists,
// not even in shared memory, and no tile straddles the seam (each
// segment's last tile zero-fills and masks its rows past Np or Nq):
// - K7a: each segment has its own range of kv blocks (the prefix's, then
//   the latents'), as the TPU kernel pads each segment to its own block
//   multiple: each CTA writes only its own segment's dK/dV rows, one writer
//   per row, no atomics. A prefix block is seen by every query, so its CTA
//   walks every q tile; latent row t is seen by queries i >= t, so a latent
//   block's CTA starts at the q tile that holds its first row.
// - K7b: one CTA per block of query rows walks every prefix tile, then the
//   latent tiles up to its last row.
// The tiles, registers and shared memory are K4's at every head-dim bucket.
//
// The bf16 build (flash_2seg_bwd_dkv_bf16_kernel, flash_2seg_bwd_dq_bf16_kernel)
// runs K4's bf16 bodies (dkv_walk16, dq_walk16) over the same segments: bf16
// products summed in f32 by mma.sync m16n8k16, p rounded to bf16 before dV
// and dS before dK and dQ, where the JAX kernels round them, the gradients
// written in bf16 (lse and delta stay f32). It moves half the f32 build's
// bytes and runs at the bf16 tensor-core rate (989 TFLOP/s dense): 0.069 ms
// (K7a) and 0.052 ms (K7b) bound it at the training chunk.

#include "flash_mma_bwd.cuh"

namespace {

using namespace pio::mma_bwd;

// the prefix's and the latents' K, V and bias rows of (batch b, head), as
// segments whose first row is set per tile or block
template <typename T>
struct Segs {
  Tile<T> pre, lat;
};

template <typename T>
__device__ __forceinline__ Segs<T> segments(const T* k_p, const T* v_p, const T* k_l, const T* v_l,
                                            const float* bias_p, const float* bias_l, int b, int head, int nq,
                                            int np, int h, int dqk, int dv) {
  const long row_qk = (long)h * dqk, row_v = (long)h * dv;
  return {{k_p + (long)b * np * row_qk + (long)head * dqk, v_p + (long)b * np * row_v + (long)head * dv,
           bias_p == nullptr ? nullptr : bias_p + (long)b * np, 0, np, NO_LIMIT},
          {k_l + (long)b * nq * row_qk + (long)head * dqk, v_l + (long)b * nq * row_v + (long)head * dv,
           bias_l == nullptr ? nullptr : bias_l + (long)b * nq, 0, nq, 0}};
}

// tile t of a walk over every prefix tile (the first n_pt), then the latent
// tiles, rows tiles of `rows`
template <typename T>
__device__ __forceinline__ Tile<T> seg_tile(const Segs<T>& sg, int n_pt, int rows, int t) {
  Tile<T> tl = t < n_pt ? sg.pre : sg.lat;
  tl.j0 = (t < n_pt ? t : t - n_pt) * rows;
  return tl;
}

// K7b: one CTA per (BQ query rows, head, batch); every prefix tile, then the
// latent tiles up to the block's last row.
template <int DMAX>
__global__ void __launch_bounds__(Dq<DMAX>::NT, Dq<DMAX>::MIN_BLOCKS) flash_2seg_bwd_dq_kernel(
    const float* __restrict__ q, const float* __restrict__ k_p, const float* __restrict__ v_p,
    const float* __restrict__ k_l, const float* __restrict__ v_l, const float* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta, const float* __restrict__ bias_p,
    const float* __restrict__ bias_l, float* __restrict__ dq, int nq, int np, int h, int dqk, int dv,
    float sm_scale) {
  using P = Dq<DMAX>;
  const int q0 = blockIdx.x * P::BQ, head = blockIdx.y, b = blockIdx.z;
  const Segs<float> sg = segments(k_p, v_p, k_l, v_l, bias_p, bias_l, b, head, nq, np, h, dqk, dv);
  const int n_pt = (np + P::BKV - 1) / P::BKV;
  const int n_tiles = n_pt + (min(q0 + P::BQ, nq) + P::BKV - 1) / P::BKV;
  dq_walk<DMAX>(q, dout, lse, delta, dq, nq, h, dqk, dv, sm_scale, n_tiles,
                [&](int t) { return seg_tile(sg, n_pt, P::BKV, t); });
}

// K7a: one CTA per (BKV kv rows of one segment, head, batch); blockIdx.x
// below the prefix's block count is a prefix block, the rest latent blocks.
template <int DMAX>
__global__ void __launch_bounds__(Dkv<DMAX>::NT, Dkv<DMAX>::MIN_BLOCKS) flash_2seg_bwd_dkv_kernel(
    const float* __restrict__ q, const float* __restrict__ k_p, const float* __restrict__ v_p,
    const float* __restrict__ k_l, const float* __restrict__ v_l, const float* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta, const float* __restrict__ bias_p,
    const float* __restrict__ bias_l, float* __restrict__ dk_p, float* __restrict__ dv_p,
    float* __restrict__ dk_l, float* __restrict__ dv_l, int nq, int np, int h, int dqk, int dv, float sm_scale) {
  constexpr int BKV = Dkv<DMAX>::BKV;
  const int head = blockIdx.y, b = blockIdx.z, n_pb = (np + BKV - 1) / BKV;
  const bool pre = (int)blockIdx.x < n_pb;
  const Segs<float> sg = segments(k_p, v_p, k_l, v_l, bias_p, bias_l, b, head, nq, np, h, dqk, dv);
  Tile<float> seg = pre ? sg.pre : sg.lat;
  seg.j0 = (pre ? blockIdx.x : blockIdx.x - n_pb) * BKV;
  const long out_qk = (long)b * seg.n * h * dqk + (long)head * dqk, out_v = (long)b * seg.n * h * dv + (long)head * dv;
  dkv_walk<DMAX>(q, dout, lse, delta, seg, (pre ? dk_p : dk_l) + out_qk, (pre ? dv_p : dv_l) + out_v, b, head, nq,
                 h, dqk, dv, sm_scale);
}

// K7b, bf16: as flash_2seg_bwd_dq_kernel, on B16's tiles
template <int DMAX>
__global__ void __launch_bounds__(B16<DMAX>::NT, B16<DMAX>::MIN_BLOCKS) flash_2seg_bwd_dq_bf16_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k_p, const bf16* __restrict__ v_p,
    const bf16* __restrict__ k_l, const bf16* __restrict__ v_l, const bf16* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta, const float* __restrict__ bias_p,
    const float* __restrict__ bias_l, bf16* __restrict__ dq, int nq, int np, int h, int dqk, int dv,
    float sm_scale) {
  using P = B16<DMAX>;
  const int q0 = blockIdx.x * P::BM, head = blockIdx.y, b = blockIdx.z;
  const Segs<bf16> sg = segments(k_p, v_p, k_l, v_l, bias_p, bias_l, b, head, nq, np, h, dqk, dv);
  const int n_pt = (np + P::BN - 1) / P::BN;
  const int n_tiles = n_pt + (min(q0 + P::BM, nq) + P::BN - 1) / P::BN;
  dq_walk16<DMAX>(q, dout, lse, delta, dq, nq, h, dqk, dv, sm_scale, n_tiles,
                  [&](int t) { return seg_tile(sg, n_pt, P::BN, t); });
}

// K7a, bf16: as flash_2seg_bwd_dkv_kernel, on B16's tiles (blocks of BM
// kv rows of one segment)
template <int DMAX>
__global__ void __launch_bounds__(B16<DMAX>::NT, B16<DMAX>::MIN_BLOCKS) flash_2seg_bwd_dkv_bf16_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k_p, const bf16* __restrict__ v_p,
    const bf16* __restrict__ k_l, const bf16* __restrict__ v_l, const bf16* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta, const float* __restrict__ bias_p,
    const float* __restrict__ bias_l, bf16* __restrict__ dk_p, bf16* __restrict__ dv_p, bf16* __restrict__ dk_l,
    bf16* __restrict__ dv_l, int nq, int np, int h, int dqk, int dv, float sm_scale) {
  constexpr int BM = B16<DMAX>::BM;
  const int head = blockIdx.y, b = blockIdx.z, n_pb = (np + BM - 1) / BM;
  const bool pre = (int)blockIdx.x < n_pb;
  const Segs<bf16> sg = segments(k_p, v_p, k_l, v_l, bias_p, bias_l, b, head, nq, np, h, dqk, dv);
  Tile<bf16> seg = pre ? sg.pre : sg.lat;
  seg.j0 = (pre ? blockIdx.x : blockIdx.x - n_pb) * BM;
  const long out_qk = (long)b * seg.n * h * dqk + (long)head * dqk, out_v = (long)b * seg.n * h * dv + (long)head * dv;
  dkv_walk16<DMAX>(q, dout, lse, delta, seg, (pre ? dk_p : dk_l) + out_qk, (pre ? dv_p : dv_l) + out_v, b, head,
                   nq, h, dqk, dv, sm_scale);
}

struct Args {
  const void *q, *k_p, *v_p, *k_l, *v_l, *dout;
  const float *lse, *delta, *bias_p, *bias_l;
  void *dq, *dk_p, *dv_p, *dk_l, *dv_l;
  int batch, nq, np, h, dqk, dv;
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
  auto kernel = flash_2seg_bwd_dq_kernel<DMAX>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)P::BYTES);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.nq + P::BQ - 1) / P::BQ, a.h, a.batch);
  kernel<<<grid, P::NT, P::BYTES, a.stream>>>(in<float>(a.q), in<float>(a.k_p), in<float>(a.v_p), in<float>(a.k_l),
                                                in<float>(a.v_l), in<float>(a.dout), a.lse, a.delta, a.bias_p,
                                                a.bias_l, out<float>(a.dq), a.nq, a.np, a.h, a.dqk, a.dv, a.sm_scale);
  return cudaGetLastError();
}

template <int DMAX>
cudaError_t launch_dq_bf16(const Args& a) {
  using P = B16<DMAX>;
  auto kernel = flash_2seg_bwd_dq_bf16_kernel<DMAX>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)P::BYTES);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.nq + P::BM - 1) / P::BM, a.h, a.batch);
  kernel<<<grid, P::NT, P::BYTES, a.stream>>>(in<bf16>(a.q), in<bf16>(a.k_p), in<bf16>(a.v_p), in<bf16>(a.k_l),
                                                in<bf16>(a.v_l), in<bf16>(a.dout), a.lse, a.delta, a.bias_p,
                                                a.bias_l, out<bf16>(a.dq), a.nq, a.np, a.h, a.dqk, a.dv, a.sm_scale);
  return cudaGetLastError();
}

template <int DMAX>
cudaError_t launch_dkv(const Args& a) {
  using P = Dkv<DMAX>;
  auto kernel = flash_2seg_bwd_dkv_kernel<DMAX>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)P::BYTES);
  if (err != cudaSuccess) return err;
  // the prefix's blocks, then the latents'
  const dim3 grid((a.np + P::BKV - 1) / P::BKV + (a.nq + P::BKV - 1) / P::BKV, a.h, a.batch);
  kernel<<<grid, P::NT, P::BYTES, a.stream>>>(in<float>(a.q), in<float>(a.k_p), in<float>(a.v_p), in<float>(a.k_l),
                                                in<float>(a.v_l), in<float>(a.dout), a.lse, a.delta, a.bias_p,
                                                a.bias_l, out<float>(a.dk_p), out<float>(a.dv_p),
                                                out<float>(a.dk_l), out<float>(a.dv_l), a.nq, a.np, a.h, a.dqk,
                                                a.dv, a.sm_scale);
  return cudaGetLastError();
}

template <int DMAX>
cudaError_t launch_dkv_bf16(const Args& a) {
  using P = B16<DMAX>;
  auto kernel = flash_2seg_bwd_dkv_bf16_kernel<DMAX>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)P::BYTES);
  if (err != cudaSuccess) return err;
  // the prefix's blocks, then the latents'
  const dim3 grid((a.np + P::BM - 1) / P::BM + (a.nq + P::BM - 1) / P::BM, a.h, a.batch);
  kernel<<<grid, P::NT, P::BYTES, a.stream>>>(in<bf16>(a.q), in<bf16>(a.k_p), in<bf16>(a.v_p), in<bf16>(a.k_l),
                                                in<bf16>(a.v_l), in<bf16>(a.dout), a.lse, a.delta, a.bias_p,
                                                a.bias_l, out<bf16>(a.dk_p), out<bf16>(a.dv_p), out<bf16>(a.dk_l),
                                                out<bf16>(a.dv_l), a.nq, a.np, a.h, a.dqk, a.dv, a.sm_scale);
  return cudaGetLastError();
}

bool valid(const Args& a) {
  return a.np >= 1 && a.dqk > 0 && a.dv > 0 && a.dqk % 8 == 0 && a.dv % 8 == 0 && a.dqk <= 128 && a.dv <= 128 &&
         a.h <= 65535 && a.batch <= 65535;
}

}  // namespace

// q/dout (B, Nq, H*D), k_p/v_p (B, Np, H*D), k_l/v_l (B, Nq, H*D), all f32
// (dtype 0) or all bf16 (dtype 1), contiguous and 16-byte aligned; lse/delta
// (B, Nq, H) f32; bias_p (B, Np) and bias_l (B, Nq) f32, each or both null.
// K7a writes dk_p/dv_p (B, Np, ·) and dk_l/dv_l (B, Nq, ·); K7b writes dq
// (B, Nq, H*Dqk), in the operands' dtype. Each returns a cudaError_t (0 =
// launched).
extern "C" int pio_flash_2seg_bwd_dkv(const void* q, const void* k_p, const void* v_p, const void* k_l,
                                      const void* v_l, const void* dout, const float* lse, const float* delta,
                                      const float* bias_p, const float* bias_l, void* dk_p, void* dv_p, void* dk_l,
                                      void* dv_l, int batch, int nq, int np, int h, int dqk, int dv, float sm_scale,
                                      int dtype, void* stream) {
  const Args a{q, k_p, v_p, k_l, v_l, dout, lse, delta, bias_p, bias_l, nullptr, dk_p, dv_p, dk_l, dv_l,
               batch, nq, np, h, dqk, dv, sm_scale, static_cast<cudaStream_t>(stream)};
  if (batch <= 0 || nq <= 0 || h <= 0) return cudaSuccess;
  if (!valid(a) || (dtype != pio::kF32 && dtype != pio::kBF16)) return cudaErrorInvalidValue;
  const int bucket = dmax_bucket(dqk, dv);
  if (dtype == pio::kBF16) return bucket == 32 ? launch_dkv_bf16<32>(a) : bucket == 64 ? launch_dkv_bf16<64>(a)
                                                                                    : launch_dkv_bf16<128>(a);
  switch (bucket) {
    case 32: return launch_dkv<32>(a);
    case 64: return launch_dkv<64>(a);
    default: return launch_dkv<128>(a);
  }
}

extern "C" int pio_flash_2seg_bwd_dq(const void* q, const void* k_p, const void* v_p, const void* k_l,
                                     const void* v_l, const void* dout, const float* lse, const float* delta,
                                     const float* bias_p, const float* bias_l, void* dq, int batch, int nq, int np,
                                     int h, int dqk, int dv, float sm_scale, int dtype, void* stream) {
  const Args a{q, k_p, v_p, k_l, v_l, dout, lse, delta, bias_p, bias_l, dq, nullptr, nullptr, nullptr, nullptr,
               batch, nq, np, h, dqk, dv, sm_scale, static_cast<cudaStream_t>(stream)};
  if (batch <= 0 || nq <= 0 || h <= 0) return cudaSuccess;
  if (!valid(a) || (dtype != pio::kF32 && dtype != pio::kBF16)) return cudaErrorInvalidValue;
  const int bucket = dmax_bucket(dqk, dv);
  if (dtype == pio::kBF16) return bucket == 32 ? launch_dq_bf16<32>(a) : bucket == 64 ? launch_dq_bf16<64>(a)
                                                                                   : launch_dq_bf16<128>(a);
  switch (bucket) {
    case 32: return launch_dq<32>(a);
    case 64: return launch_dq<64>(a);
    default: return launch_dq<128>(a);
  }
}
