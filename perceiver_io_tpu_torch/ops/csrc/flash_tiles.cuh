// Register-tiled f32 building blocks of the two-segment flash backward
// kernels (K7a/K7b in flash_2seg_bwd.cu), on the CUDA cores: 64-row tiles
// staged in shared memory, 64 x 64 product tiles split over 256 threads as
// 4 x 4 micro-tiles with strided rows {ty + 16e} and columns {tx + 16f}.
//
// - tile_dot: each step of the depth loop reads four float4 of each operand
//   from shared memory for 64 FMAs; rows padded to D + 4 words make the 16
//   column-threads' float4 reads conflict-free;
// - tile_acc: the accumulating products (dQ = dS K; dV = P^T dO, dK = dS^T Q)
//   go through P / dS in shared memory, each thread owning 4 rows x float4
//   column chunks of the output, again 64 FMAs per eight float4 reads.
#pragma once

#include "common.cuh"

namespace pio {
namespace tiles {

constexpr int NT = 256;       // threads: a 16 x 16 grid of (ty, tx)
constexpr int BLK = 64;       // rows of the owned block and of each loaded tile
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

// the kernel's dynamic shared memory, and the largest carveout so that two
// CTAs fit on an SM
template <typename Kernel>
cudaError_t prepare(Kernel kernel, size_t smem) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout, cudaSharedmemCarveoutMaxShared);
}

// the head-dim bucket (32, 64 or 128) a kernel is instantiated for
inline int dmax_bucket(int dqk, int dv) {
  const int d = dqk > dv ? dqk : dv;
  return d <= 32 ? 32 : (d <= 64 ? 64 : 128);
}

}  // namespace tiles
}  // namespace pio
