// K6: two-segment packed flash attention forward for Hopper (sm_90a), CUDA
// C++: an f32 build and a bf16 build behind one C interface with a dtype
// code (0 f32, 1 bf16), as K2's.
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
// for the backward. A row whose visible keys all carry MASK_VALUE gets the
// uniform average of those keys' values, like the plain version in
// ops/flash_attention.py. Every row sees at least one prefix key (Np >= 1),
// so lse is finite.
//
// What bounds it: at the flagship training chunk (1024 latents over 7680
// kept prefix rows + 1024 latents, D = 64, batch 2) the work is ~34 GFLOP
// against ~80 MB of operands: arithmetic. Its products are K2's split-TF32
// products on the tensor cores (flash_mma.cuh: three TF32 products per
// f32-accurate product, 165 TFLOP/s at the full rate), bounding it at
// 0.208 ms there and 0.202 ms at the eval window (15360 prefix rows, batch
// 1). The bf16 build runs K2's bf16 tiles as they are (bf16 products summed
// in f32 by mma.sync m16n8k16, P split into two bf16 parts before P.V, the
// output written in bf16) at the bf16 tensor-core rate, 989 TFLOP/s: 0.035
// ms there. JAX's kernel rounds P to bf16 once before P.V; this build keeps
// it to ~2^-16, so the concat route (K2) and this route compute the same
// function in bf16 too (a difference of contract with the JAX kernel).
//
// Design: K2's tiles (flash_mma.cuh), one CTA of 4 warps per (64-row q
// block, head, batch). The kv walk is one loop over the prefix's tiles,
// then the latent tiles up to the block's last query; each tile is
// staged by cp.async from its own segment's base pointer with its own bias
// row, so no joined K/V exists, not even in shared memory, and no tile
// straddles the seam (the last tile of each segment zero-fills and masks its
// rows past Np or Nq). Prefix tiles are visible to every row (no mask
// arithmetic but at the segment's end); latent tiles follow the causal rule
// at offset 0. The eval window's 1024 latents x 8 heads x batch 1 give 128
// q blocks for 264 CTA slots (two an SM, in both builds), so the wrapper
// splits the walk (ops/flash_attention.py packed_kv_splits, as for K2) and
// a second pass (flash_merge.cuh) merges the f32 partials in a fixed order
// and writes the output in its dtype; the training chunk (256 q blocks)
// runs unsplit.

#include "flash_merge.cuh"
#include "flash_mma.cuh"

namespace {

using namespace pio::mma;

template <typename P>
__global__ void __launch_bounds__(NT, P::MIN_BLOCKS) flash_2seg_fwd_kernel(
    const typename P::T* __restrict__ q, const typename P::T* __restrict__ k_p,
    const typename P::T* __restrict__ v_p, const typename P::T* __restrict__ k_l,
    const typename P::T* __restrict__ v_l, const float* __restrict__ bias_p, const float* __restrict__ bias_l,
    typename P::T* __restrict__ o, float* __restrict__ lse, float* __restrict__ part, int nq, int np, int h,
    int dqk, int dv, float sm_scale, int nsplit) {
  using T = typename P::T;
  extern __shared__ float4 smem4[];
  T* smem = reinterpret_cast<T*>(smem4);
  const int q0 = blockIdx.x * BQ, head = blockIdx.y, b = blockIdx.z / nsplit, z = blockIdx.z % nsplit;
  const long row_qk = (long)h * dqk, row_v = (long)h * dv;
  P::stage_q(smem, q + (long)b * nq * row_qk + (long)head * dqk, row_qk, q0, nq, dqk);

  // every prefix tile, then the latent tiles up to the block's last query;
  // this split's contiguous share of them
  const Tile<T> pre{k_p + (long)b * np * row_qk + (long)head * dqk, v_p + (long)b * np * row_v + (long)head * dv,
                    bias_p == nullptr ? nullptr : bias_p + (long)b * np, 0, np, NO_LIMIT};
  const Tile<T> lat{k_l + (long)b * nq * row_qk + (long)head * dqk, v_l + (long)b * nq * row_v + (long)head * dv,
                    bias_l == nullptr ? nullptr : bias_l + (long)b * nq, 0, nq, 0};
  constexpr int BKV = P::BKV;
  const int n_pt = (np + BKV - 1) / BKV;
  const int n_tiles = n_pt + (min(q0 + BQ, nq) + BKV - 1) / BKV;
  const int per = (n_tiles + nsplit - 1) / nsplit;
  const int t_begin = min(n_tiles, z * per), t_end = min(n_tiles, t_begin + per);
  auto tile_of = [&](int t) {
    Tile<T> tl = t < n_pt ? pre : lat;
    tl.j0 = (t < n_pt ? t : t - n_pt) * BKV;
    return tl;
  };
  const int i0 = q0 + 16 * (threadIdx.x >> 5) + ((threadIdx.x & 31) >> 2);

  State<P::DMAX> st;
  st.init();
  walk<P>(st, smem, t_begin, t_end, tile_of, row_qk, row_v, i0, dqk, dv, sm_scale);

  // output rows (b, i, head) in the packed (B, Nq, H * Dv) order
  const long rows = (long)(gridDim.z / nsplit) * nq * h;
  auto row = [&](int i) { return ((long)b * nq + i) * h + head; };
  if (nsplit == 1) {
    store<P::DMAX>(st, i0, nq, dv, [&](int i) { return o + row(i) * dv; }, [&](int i) { return lse + row(i); });
  } else {
    store_partial<P::DMAX>(st, i0, nq, dv, [&](int i) { return part + ((long)z * rows + row(i)) * dv; },
                           [&](int i) { return part + (long)nsplit * rows * dv + 2 * ((long)z * rows + row(i)); });
  }
}

struct Args {
  const void *q, *k_p, *v_p, *k_l, *v_l;
  const float *bias_p, *bias_l;
  void* o;
  float *lse, *part;
  int batch, nq, np, h, dqk, dv;
  float sm_scale;
  int nsplit;
  cudaStream_t stream;
};

template <typename P>
cudaError_t launch(const Args& a) {
  using T = typename P::T;
  auto kernel = flash_2seg_fwd_kernel<P>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)P::BYTES);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.nq + BQ - 1) / BQ, a.h, a.batch * a.nsplit);
  auto in = [](const void* p) { return static_cast<const T*>(p); };
  kernel<<<grid, NT, P::BYTES, a.stream>>>(in(a.q), in(a.k_p), in(a.v_p), in(a.k_l), in(a.v_l), a.bias_p,
                                           a.bias_l, static_cast<T*>(a.o), a.lse, a.part, a.nq, a.np, a.h, a.dqk,
                                           a.dv, a.sm_scale, a.nsplit);
  err = cudaGetLastError();
  if (err != cudaSuccess || a.nsplit == 1) return err;
  return pio::merge_splits(a.part, static_cast<T*>(a.o), a.lse, (long)a.batch * a.nq * a.h, a.dv, a.nsplit,
                           a.stream);
}

template <template <int> class P>
cudaError_t dispatch(const Args& a) {
  const int d = a.dqk > a.dv ? a.dqk : a.dv;
  if (d <= 32) return launch<P<32>>(a);
  if (d <= 64) return launch<P<64>>(a);
  return launch<P<128>>(a);
}

}  // namespace

// q (B, Nq, H*Dqk), k_p (B, Np, H*Dqk), v_p (B, Np, H*Dv), k_l (B, Nq, H*Dqk),
// v_l (B, Nq, H*Dv), all contiguous, 16-byte aligned and of one dtype (0 =
// f32, 1 = bf16); bias_p (B, Np) and bias_l (B, Nq) f32, each or both null;
// o (B, Nq, H*Dv) in the operands' dtype; lse (B, Nq, H) f32; the kv walk
// split `nsplit` ways, with part a scratch of nsplit * B * Nq * H * (Dv + 2)
// floats when nsplit > 1, else unused. Returns a cudaError_t (0 = launched).
extern "C" int pio_flash_2seg_fwd(const void* q, const void* k_p, const void* v_p, const void* k_l,
                                  const void* v_l, const float* bias_p, const float* bias_l, void* o, float* lse,
                                  float* part, int batch, int nq, int np, int h, int dqk, int dv, float sm_scale,
                                  int nsplit, int dtype, void* stream) {
  if (batch <= 0 || nq <= 0 || h <= 0) return cudaSuccess;
  if (np < 1 || dqk <= 0 || dv <= 0 || dqk % 8 || dv % 8 || dqk > 128 || dv > 128 || h > 65535 || nsplit < 1 ||
      (long)batch * nsplit > 65535 || (nsplit > 1 && part == nullptr))
    return cudaErrorInvalidValue;
  const Args a{q, k_p, v_p, k_l, v_l, bias_p, bias_l, o, lse, part, batch, nq, np, h, dqk, dv, sm_scale, nsplit,
               static_cast<cudaStream_t>(stream)};
  if (dtype == pio::kF32) return dispatch<F32>(a);
  if (dtype == pio::kBF16) return dispatch<BF16>(a);
  return cudaErrorInvalidValue;
}
