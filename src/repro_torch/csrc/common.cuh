// Shared helpers for the repro_torch kernels (plain C interface, loaded
// with ctypes; no PyTorch headers).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#define REPRO_NEG_INF (-1e30f)

// dtype codes passed from Python (kernels/build.py callers)
enum ReproDtype { REPRO_F32 = 0, REPRO_BF16 = 1 };

// Each library carries its own copy (one .so per .cu).
extern "C" const char* repro_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as torch's .to()
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Eight consecutive elements of a row as fp32: one 16-byte load for bf16
// (two for fp32).  `p` must be 16-byte aligned.
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float* out) {
  uint4 raw = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float2 f = __bfloat1622float2(h[i]);
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}
__device__ __forceinline__ void load8(const float* p, float* out) {
  float4 a = *reinterpret_cast<const float4*>(p);
  float4 b = *reinterpret_cast<const float4*>(p + 4);
  out[0] = a.x; out[1] = a.y; out[2] = a.z; out[3] = a.w;
  out[4] = b.x; out[5] = b.y; out[6] = b.z; out[7] = b.w;
}

__device__ __forceinline__ float to_f32(int8_t x) { return (float)x; }

// Eight consecutive int8 of a row as fp32: one 8-byte load.  `p` must be
// 8-byte aligned.
__device__ __forceinline__ void load8(const int8_t* p, float* out) {
  uint2 raw = *reinterpret_cast<const uint2*>(p);
  const char4* c = reinterpret_cast<const char4*>(&raw);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    out[4 * i] = c[i].x;
    out[4 * i + 1] = c[i].y;
    out[4 * i + 2] = c[i].z;
    out[4 * i + 3] = c[i].w;
  }
}

// 16 bytes of a pool row as fp32: 8 bf16, 8 fp32 (two loads) or 16 int8.
// `p` must be 16-byte aligned.
__device__ __forceinline__ void load_chunk(const __nv_bfloat16* p,
                                           float* out) {
  load8(p, out);
}
__device__ __forceinline__ void load_chunk(const float* p, float* out) {
  load8(p, out);
}
__device__ __forceinline__ void load_chunk(const int8_t* p, float* out) {
  int4 raw = *reinterpret_cast<const int4*>(p);
  const char4* c = reinterpret_cast<const char4*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    out[4 * i] = c[i].x;
    out[4 * i + 1] = c[i].y;
    out[4 * i + 2] = c[i].z;
    out[4 * i + 3] = c[i].w;
  }
}

// ---- fused epilogues (vwr_matmul, vwr_conv2d): codes as in
// kernels/vwr_matmul.py ACT_CODES ----

enum Act { ACT_NONE = 0, ACT_RELU = 1, ACT_SILU = 2, ACT_GELU = 3 };

__device__ __forceinline__ float silu(float v) {
  return v / (1.0f + expf(-v));
}

// jax.nn.gelu's default: the tanh approximation
__device__ __forceinline__ float gelu_tanh(float v) {
  const float k0 = 0.7978845608028654f;  // sqrt(2 / pi)
  return 0.5f * v * (1.0f + tanhf(k0 * (v + 0.044715f * v * v * v)));
}

__device__ __forceinline__ float activate(float v, int act) {
  switch (act) {
    case ACT_RELU: return fmaxf(v, 0.0f);
    case ACT_SILU: return silu(v);
    case ACT_GELU: return gelu_tanh(v);
    default: return v;
  }
}

// Eight bf16 of row `row`, columns col .. col+7, of a row-major
// (rows, cols) matrix as one 16-byte chunk; zeros past either edge.
// `vec`: cols % 8 == 0 and `p` 16-byte aligned (the 16-byte load is
// taken only for a chunk wholly inside the row).
__device__ __forceinline__ uint4 chunk8(const __nv_bfloat16* p, int row,
                                        int col, int rows, int cols,
                                        bool vec) {
  if (row < rows && vec && col + 8 <= cols)
    return *reinterpret_cast<const uint4*>(p + (size_t)row * cols + col);
  uint4 out;
  __nv_bfloat16* o = reinterpret_cast<__nv_bfloat16*>(&out);
#pragma unroll
  for (int e = 0; e < 8; ++e)
    o[e] = (row < rows && col + e < cols) ? p[(size_t)row * cols + col + e]
                                          : __float2bfloat16(0.0f);
  return out;
}
