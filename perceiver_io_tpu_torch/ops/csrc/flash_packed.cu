// K2: packed flash attention forward for Hopper (sm_90a), CUDA C++.
//
// Replaces the TPU kernel perceiver_io_tpu/ops/flash_attention.py
// _fwd_packed_kernel (reached from _flash_packed_fwd_impl via
// flash_attention_packed). Same function: online-softmax attention over the
// packed (B, N, H*D) layout, a head being a strided column slice (row stride
// H*D, no transpose copy), right-aligned causal mask j <= i + (nkv - nq) from
// the unpadded lengths, an additive f32 kv bias row (0 or the finite
// MASK_VALUE), f32 running max / sum / accumulator, the l == 0 guard, and the
// per-row logsumexp (B, Nq, H) that K4a/K4b read. Keys past a row's causal
// limit (or past nkv) never enter its softmax; a row whose visible keys all
// carry MASK_VALUE gets the uniform average of those keys' values; a row that
// sees no key gets 0 and logsumexp -inf, like the plain version in
// ops/flash_attention.py.
//
// What bounds it: 4 * D * (visible pairs) operations against a few bytes per
// pair, far above the card's operations-per-byte line, so arithmetic. The
// f32 build keeps f32-accurate products on the tensor cores by splitting
// each operand into two TF32 parts and summing three TF32 products
// (flash_mma.cuh), so its peak is a third of the 495 TFLOP/s TF32 rate:
// 165 TFLOP/s. At the main path's shapes that bounds it at 0.104 ms (the
// image classifier's self-attention, 512 x 512, 8 heads of 128, batch 16),
// 0.208 ms (the CLM's training cross-attention, 1024 over 8704 keys, 8 heads
// of 64, batch 2) and 0.102 ms (the serving prefill, 512 over 16384 keys,
// batch 1). The bf16 build runs the same tiles with bf16 products (one for
// S, two for P.V with P split in two bf16 parts).
//
// Design (flash_mma.cuh holds the tiles, the fragment layouts and the bank
// arithmetic): one CTA of 4 warps per (64-row q block, head, batch, split),
// 16 query rows a warp; K, V and the bias row double-buffered by cp.async;
// the walk stops at the last tile the block's causal limit can see, and
// only tiles that cross a warp's limit or the end of the keys pay for the
// mask. Too few CTAs: the serving prefill's 512 latents x 8 heads x batch 1
// give 64 q blocks for 264 CTA slots (two an SM, in both builds), so the
// wrapper (ops/flash_attention.py packed_kv_splits) splits the kv walk
// across the slots one CTA per q block leaves idle, never into a second
// wave; each split writes its unnormalized f32 partial and a second pass
// (flash_merge.cuh) merges them in a fixed order, with no atomics, and
// writes the output in its dtype. The training shapes fill the card
// unsplit.
//
// wgmma is the way to the full TF32 rate, but a TF32 wgmma takes both
// operands K-major, so P.V would need V transposed in shared memory: later
// work.

#include "flash_merge.cuh"
#include "flash_mma.cuh"

namespace {

using namespace pio::mma;

template <typename P>
__global__ void __launch_bounds__(NT, P::MIN_BLOCKS) flash_packed_kernel(
    const typename P::T* __restrict__ q, const typename P::T* __restrict__ k, const typename P::T* __restrict__ v,
    const float* __restrict__ bias, typename P::T* __restrict__ o, float* __restrict__ lse,
    float* __restrict__ part, int nq, int nkv, int h, int dqk, int dv, int causal, float sm_scale, int nsplit) {
  using T = typename P::T;
  extern __shared__ float4 smem4[];
  T* smem = reinterpret_cast<T*>(smem4);
  const int q0 = blockIdx.x * BQ, head = blockIdx.y, b = blockIdx.z / nsplit, z = blockIdx.z % nsplit;
  const long row_qk = (long)h * dqk, row_v = (long)h * dv;
  const T* kh = k + (long)b * nkv * row_qk + (long)head * dqk;
  const T* vh = v + (long)b * nkv * row_v + (long)head * dv;
  const float* brow = bias == nullptr ? nullptr : bias + (long)b * nkv;
  P::stage_q(smem, q + (long)b * nq * row_qk + (long)head * dqk, row_qk, q0, nq, dqk);

  // the block's visible kv tiles, then this split's contiguous share
  const int off = causal ? nkv - nq : NO_LIMIT;
  const int kv_end = causal ? max(0, min(nkv, min(q0 + BQ, nq) + off)) : nkv;
  const int n_tiles = (kv_end + P::BKV - 1) / P::BKV;
  const int per = (n_tiles + nsplit - 1) / nsplit;
  const int t_begin = min(n_tiles, z * per), t_end = min(n_tiles, t_begin + per);
  const int i0 = q0 + 16 * (threadIdx.x >> 5) + ((threadIdx.x & 31) >> 2);

  State<P::DMAX> st;
  st.init();
  walk<P>(st, smem, t_begin, t_end, [&](int t) { return Tile<T>{kh, vh, brow, t * P::BKV, nkv, off}; }, row_qk,
          row_v, i0, dqk, dv, sm_scale);

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

template <typename P>
cudaError_t launch(const void* q, const void* k, const void* v, const float* bias, void* o, float* lse, float* part,
                   int batch, int nq, int nkv, int h, int dqk, int dv, int causal, float sm_scale, int nsplit,
                   cudaStream_t stream) {
  using T = typename P::T;
  auto kernel = flash_packed_kernel<P>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)P::BYTES);
  if (err != cudaSuccess) return err;
  const dim3 grid((nq + BQ - 1) / BQ, h, batch * nsplit);
  kernel<<<grid, NT, P::BYTES, stream>>>(static_cast<const T*>(q), static_cast<const T*>(k),
                                         static_cast<const T*>(v), bias, static_cast<T*>(o), lse, part, nq, nkv, h,
                                         dqk, dv, causal, sm_scale, nsplit);
  err = cudaGetLastError();
  if (err != cudaSuccess || nsplit == 1) return err;
  return pio::merge_splits(part, static_cast<T*>(o), lse, (long)batch * nq * h, dv, nsplit, stream);
}

template <template <int> class P>
cudaError_t dispatch(const void* q, const void* k, const void* v, const float* bias, void* o, float* lse,
                     float* part, int batch, int nq, int nkv, int h, int dqk, int dv, int causal, float sm_scale,
                     int nsplit, cudaStream_t s) {
  const int dmax = dqk > dv ? dqk : dv;
  if (dmax <= 32)
    return launch<P<32>>(q, k, v, bias, o, lse, part, batch, nq, nkv, h, dqk, dv, causal, sm_scale, nsplit, s);
  if (dmax <= 64)
    return launch<P<64>>(q, k, v, bias, o, lse, part, batch, nq, nkv, h, dqk, dv, causal, sm_scale, nsplit, s);
  return launch<P<128>>(q, k, v, bias, o, lse, part, batch, nq, nkv, h, dqk, dv, causal, sm_scale, nsplit, s);
}

}  // namespace

// q (B, Nq, H*Dqk), k (B, Nkv, H*Dqk), v (B, Nkv, H*Dv), all contiguous,
// 16-byte aligned and of one dtype (0 = f32, 1 = bf16), head dims multiples
// of 8 up to 128; bias (B, Nkv) f32 or null; o (B, Nq, H*Dv) in the input
// dtype; lse (B, Nq, H) f32; the kv walk split `nsplit` ways with part a
// scratch of nsplit * B * Nq * H * (Dv + 2) floats when nsplit > 1,
// else unused. Returns a cudaError_t (0 = launched).
extern "C" int pio_flash_packed_fwd(const void* q, const void* k, const void* v, const float* bias, void* o,
                                    float* lse, float* part, int batch, int nq, int nkv, int h, int dqk, int dv,
                                    int causal, float sm_scale, int nsplit, int dtype, void* stream) {
  if (batch <= 0 || nq <= 0 || h <= 0) return cudaSuccess;
  if (dqk <= 0 || dv <= 0 || dqk % 8 || dv % 8 || dqk > 128 || dv > 128 || nkv < 0 || h > 65535 ||
      nsplit < 1 || (long)batch * nsplit > 65535 || (nsplit > 1 && part == nullptr))
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == pio::kF32)
    return dispatch<F32>(q, k, v, bias, o, lse, part, batch, nq, nkv, h, dqk, dv, causal, sm_scale, nsplit, s);
  if (dtype == pio::kBF16)
    return dispatch<BF16>(q, k, v, bias, o, lse, part, batch, nq, nkv, h, dqk, dv, causal, sm_scale, nsplit, s);
  return cudaErrorInvalidValue;
}
