// Shared helpers for the port's hand-written Hopper kernels (built for sm_90a
// by ops/build.py with nvcc into plain-C shared libraries loaded by ctypes).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace pio {

// Element types the kernels take: 0 = float32, 1 = bfloat16 (the wrappers
// pass the code; see ops/flash_attention.py).
enum DType : int { kF32 = 0, kBF16 = 1 };

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) { return __float2bfloat16(x); }

// four f32 values to four consecutive outputs (16-byte aligned f32, 8-byte
// aligned bf16, each rounded to nearest)
__device__ __forceinline__ void store4(float* p, float4 a) { *reinterpret_cast<float4*>(p) = a; }
__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 a) {
  __nv_bfloat162* q = reinterpret_cast<__nv_bfloat162*>(p);
  q[0] = __floats2bfloat162_rn(a.x, a.y);
  q[1] = __floats2bfloat162_rn(a.z, a.w);
}

}  // namespace pio
