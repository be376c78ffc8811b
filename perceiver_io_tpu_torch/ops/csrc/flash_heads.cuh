// Building blocks of the heads-major flash forward (K8 in flash_heads.cu;
// its backward, K9a/K9b, runs on the tensor cores: flash_heads_bwd.cu): f32
// operands (B*H, N, D) with head dims up to 512, so no operand row fits in
// registers and a whole 64-row tile of Q, K and V does not fit in shared
// memory at once. Tiles are staged in 64-column chunks (or a few full-width
// rows) and every product is a register-tiled GEMM over 256 threads, a
// 16 x 16 grid of (ty, tx):
//
// - dot: score-like products, acc[e][f] for rows ty + 16e of A and rows
//   tx + 16f of B over one chunk's depth; rows padded to a stride of 4 mod 32
//   words (or 4 * odd) keep the 16 column-threads' float4 reads free of bank
//   conflicts;
// - acc_rows: accumulating products (O += P V), each thread owning float4
//   column 4tx of a 64-column chunk for rows ty + 16e; the output chunks
//   stay in registers (DMAX / 64 of them), indexed at compile time.
#pragma once

#include "common.cuh"

namespace pio {
namespace heads {

constexpr int NT = 256;       // threads: a 16 x 16 grid of (ty, tx)
constexpr int DC = 64;        // columns of a staged chunk
constexpr int LDC = DC + 4;   // its row stride (68 = 4 mod 32)

// 64-column output chunks a thread carries for head dims up to DMAX
template <int DMAX>
struct Chunks {
  static constexpr int N = (DMAX + DC - 1) / DC;
};

// the head-dim bucket a kernel is instantiated for
inline int dmax_bucket(int dqk, int dv) {
  const int d = dqk > dv ? dqk : dv;
  return d <= 64 ? 64 : d <= 128 ? 128 : d <= 256 ? 256 : d <= 320 ? 320 : 512;
}

__device__ __forceinline__ float4 ld4(const float* p) { return *reinterpret_cast<const float4*>(p); }

// rows [r0, r0 + ROWS) and columns [c0, c0 + w) of a row-major matrix with
// n rows and row stride `stride` into dst (row stride ld); rows past n are
// zero, columns past w are left as they are (every reader stops at w)
template <int ROWS>
__device__ __forceinline__ void stage(float* dst, int ld, const float* src, int stride, int r0, int n, int c0,
                                      int w) {
  const int per_row = w / 4;
  for (int idx = threadIdx.x; idx < ROWS * per_row; idx += NT) {
    const int rr = idx / per_row, c = 4 * (idx - rr * per_row), g = r0 + rr;
    const float4 x = g < n ? ld4(src + (long)g * stride + c0 + c) : make_float4(0.f, 0.f, 0.f, 0.f);
    *reinterpret_cast<float4*>(dst + rr * ld + c) = x;
  }
}

// acc[e][f] += A[ty + 16e] . B[tx + 16f] over depth w <= DC
template <int E, int F>
__device__ __forceinline__ void dot(float (&acc)[E][F], const float* a, int lda, const float* b, int ldb, int w,
                                    int ty, int tx) {
#pragma unroll 4
  for (int c4 = 0; c4 < DC / 4; ++c4) {
    if (4 * c4 < w) {
      float4 av[E], bv[F];
#pragma unroll
      for (int e = 0; e < E; ++e) av[e] = ld4(a + (ty + 16 * e) * lda + 4 * c4);
#pragma unroll
      for (int f = 0; f < F; ++f) bv[f] = ld4(b + (tx + 16 * f) * ldb + 4 * c4);
#pragma unroll
      for (int e = 0; e < E; ++e)
#pragma unroll
        for (int f = 0; f < F; ++f) {
          acc[e][f] = fmaf(av[e].x, bv[f].x, acc[e][f]);
          acc[e][f] = fmaf(av[e].y, bv[f].y, acc[e][f]);
          acc[e][f] = fmaf(av[e].z, bv[f].z, acc[e][f]);
          acc[e][f] = fmaf(av[e].w, bv[f].w, acc[e][f]);
        }
    }
  }
}

// out[e] (the float4 at row ty + 16e, column 4tx of a chunk) += sum over
// r < R of w[(ty + 16e) * ldw + r] * m[r * ldm + 4tx]
template <int E, int R>
__device__ __forceinline__ void acc_rows(float4 (&out)[E], const float* w, int ldw, const float* m, int ldm,
                                         int ty, int tx) {
#pragma unroll 2
  for (int r4 = 0; r4 < R / 4; ++r4) {
    float4 wv[E], mv[4];
#pragma unroll
    for (int e = 0; e < E; ++e) wv[e] = ld4(w + (ty + 16 * e) * ldw + 4 * r4);
#pragma unroll
    for (int g = 0; g < 4; ++g) mv[g] = ld4(m + (4 * r4 + g) * ldm + 4 * tx);
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const float ws[4] = {wv[e].x, wv[e].y, wv[e].z, wv[e].w};
#pragma unroll
      for (int g = 0; g < 4; ++g) {
        out[e].x = fmaf(ws[g], mv[g].x, out[e].x);
        out[e].y = fmaf(ws[g], mv[g].y, out[e].y);
        out[e].z = fmaf(ws[g], mv[g].z, out[e].z);
        out[e].w = fmaf(ws[g], mv[g].w, out[e].w);
      }
    }
  }
}

template <int CH, int E>
__device__ __forceinline__ void zero(float4 (&out)[CH][E]) {
#pragma unroll
  for (int ch = 0; ch < CH; ++ch)
#pragma unroll
    for (int e = 0; e < E; ++e) out[ch][e] = make_float4(0.f, 0.f, 0.f, 0.f);
}

// rows r0 + ty + 16e (those below n) of a (n, d) row-major output, scaled
template <int CH, int E>
__device__ __forceinline__ void store_rows(float* dst, int d, int r0, int n, const float4 (&out)[CH][E], int ty,
                                           int tx) {
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const int r = r0 + ty + 16 * e;
    if (r < n) {
#pragma unroll
      for (int ch = 0; ch < CH; ++ch) {
        const int c = DC * ch + 4 * tx;
        if (c < d) *reinterpret_cast<float4*>(dst + (long)r * d + c) = out[ch][e];
      }
    }
  }
}

template <typename Kernel>
cudaError_t prepare(Kernel kernel, size_t smem) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

inline bool valid_dims(int dqk, int dv) {
  return dqk >= 8 && dv >= 8 && dqk % 8 == 0 && dv % 8 == 0 && dqk <= 512 && dv <= 512;
}

}  // namespace heads
}  // namespace pio
