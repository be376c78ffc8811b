// The second pass of a split kv walk, shared by K2 (flash_packed.cu), K6
// (flash_2seg.cu) and K8 (flash_heads.cu): each of `nsplit` CTAs of a q block wrote the unnormalized
// partial (acc, m, l) of its contiguous share of the walk, acc as
// (nsplit, rows, Dv) and then the (m, l) pairs as (nsplit, rows, 2), where
// `rows` numbers the output rows in the order of the output's (rows, Dv)
// layout. One warp per row merges them in split order (no atomics, the
// same sums every run) and writes the normalized row (f32, or bf16 for
// the bf16 builds) and its f32 logsumexp.
// A split that saw no key (m = -inf) adds nothing; a row that saw none gets
// 0 and logsumexp -inf.
#pragma once

#include "common.cuh"

namespace pio {

template <typename T>
__global__ void __launch_bounds__(256) merge_splits_kernel(const float* __restrict__ part, T* __restrict__ o,
                                                           float* __restrict__ lse, long rows, int dv, int nsplit) {
  const long row = (long)blockIdx.x * 8 + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;
  const float* ml = part + (long)nsplit * rows * dv;
  float mm = -CUDART_INF_F;
  for (int z = 0; z < nsplit; ++z) mm = fmaxf(mm, ml[2 * (z * rows + row)]);
  float ll = 0.f;
  for (int z = 0; z < nsplit; ++z) {
    const float mz = ml[2 * (z * rows + row)];
    if (mz != -CUDART_INF_F) ll = fmaf(ml[2 * (z * rows + row) + 1], expf(mz - mm), ll);
  }
  const float inv = ll == 0.f ? 1.f : 1.f / ll;
  for (int c = 4 * lane; c < dv; c += 128) {
    float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int z = 0; z < nsplit; ++z) {
      const float mz = ml[2 * (z * rows + row)];
      if (mz == -CUDART_INF_F) continue;
      const float wz = expf(mz - mm);
      const float4 x = *reinterpret_cast<const float4*>(part + (z * rows + row) * dv + c);
      a.x = fmaf(wz, x.x, a.x);
      a.y = fmaf(wz, x.y, a.y);
      a.z = fmaf(wz, x.z, a.z);
      a.w = fmaf(wz, x.w, a.w);
    }
    a.x *= inv;
    a.y *= inv;
    a.z *= inv;
    a.w *= inv;
    store4(o + row * dv + c, a);
  }
  if (lane == 0) lse[row] = mm + logf(ll == 0.f ? 1.f : ll);
}

template <typename T>
inline cudaError_t merge_splits(const float* part, T* o, float* lse, long rows, int dv, int nsplit,
                                cudaStream_t stream) {
  merge_splits_kernel<<<(unsigned)((rows + 7) / 8), 256, 0, stream>>>(part, o, lse, rows, dv, nsplit);
  return cudaGetLastError();
}

}  // namespace pio
