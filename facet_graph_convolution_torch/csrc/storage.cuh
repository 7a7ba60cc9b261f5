// Loads and stores of a kernel's storage type: float32, or bfloat16 upcast on
// load and rounded once on store (round to nearest even). Arithmetic is f32
// in both; the float overloads are the plain __ldg and store, so a float
// instantiation compiles to the same code as a kernel written for float.
// Conversions go through the cuda_bf16.h intrinsics only.

#pragma once

#include <cuda_bf16.h>

__device__ __forceinline__ float load_f32(const float* p) { return __ldg(p); }

__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) {
  return __bfloat162float(__ldg(p));
}

__device__ __forceinline__ void store_f32(float* p, float v) { *p = v; }

__device__ __forceinline__ void store_f32(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// four consecutive values at p, which is 4-element aligned (16 bytes for
// float, 8 for bfloat16)
__device__ __forceinline__ void store4_f32(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}

__device__ __forceinline__ void store4_f32(__nv_bfloat16* p, float4 v) {
  __nv_bfloat162* q = reinterpret_cast<__nv_bfloat162*>(p);
  q[0] = __floats2bfloat162_rn(v.x, v.y);
  q[1] = __floats2bfloat162_rn(v.z, v.w);
}

// four consecutive bfloat16 values at p (4-element aligned: two pairs), as f32
__device__ __forceinline__ float4 load4_f32(const __nv_bfloat16* p) {
  const __nv_bfloat162* q = reinterpret_cast<const __nv_bfloat162*>(p);
  const float2 lo = __bfloat1622float2(__ldg(q)), hi = __bfloat1622float2(__ldg(q + 1));
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}
