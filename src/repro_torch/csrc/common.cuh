// Shared helpers for the repro_torch kernels (plain C interface, loaded
// with ctypes; no PyTorch headers).
#pragma once

#include <cuda.h>  // CUtensorMap (types only: nothing links -lcuda)
#include <cuda_bf16.h>
#include <cuda_fp16.h>
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

// Across the four lanes of a quad (the threads that share a row of an
// mma / wgmma accumulator fragment).
__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// Two floats as one bf16x2 register, `lo` in the low half (rounded to
// nearest even).
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Two floats as one f16x2 register, `lo` in the low half (rounded to
// nearest even).
__device__ __forceinline__ uint32_t pack_f16(float lo, float hi) {
  __half2 v = __floats2half2_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
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

// Raise `kernel`'s dynamic shared memory limit to `bytes`, once per device
// (the call is not repeated on every launch; up to 16 devices).  One set of
// flags per kernel: the kernel is the template argument.
template <auto kernel>
int smem_limit_once(int bytes) {
  static bool done[16] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev < 16 && done[dev]) return 0;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           bytes);
  if (e != cudaSuccess) return (int)e;
  if (dev < 16) done[dev] = true;
  return 0;
}

// ---- Hopper (sm_90a) building blocks: shared-memory addresses, mbarriers,
// cp.async, TMA and wgmma (the wgmma kernels of vwr_matmul, vwr_attention,
// vwr_conv2d and vwr_mla_decode) ----

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// The first 1024-byte boundary at or after `p` (a 128-byte-swizzled tile
// must start on one; dynamic shared memory is allocated 1024 bytes over).
__device__ __forceinline__ unsigned char* align1024(unsigned char* p) {
  const uint32_t a = smem_u32(p);
  return p + ((1024u - (a & 1023u)) & 1023u);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

// Arrive and add `bytes` to the transactions the current phase waits for.
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

// Spin until the phase of parity `parity` has completed (a fresh barrier
// counts its phase "-1", of parity 1, as completed).
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred p;\nWAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}

// One 2-d TMA box at coordinates (c0 innermost, c1) into `dst`; the bytes
// complete a transaction of `bar`.  Out-of-bounds elements arrive as 0.
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map,
                                            int c0, int c1, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1)
      : "memory");
}

// 3-d TMA box at coordinates (c0 innermost, c1, c2), as tma_load_2d.
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map,
                                            int c0, int c1, int c2,
                                            uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "r"(c2)
      : "memory");
}

// 16 bytes global -> shared, bypassing L1; zeros when !valid.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}
// Arrive on `bar` once this thread's cp.async copies issued so far have
// landed; .noinc: the barrier's expected count includes this arrival.
__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}
// 4 bytes global -> shared (through L1); zeros when !valid.
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Generic-proxy writes to shared memory (st.shared, cp.async) made visible
// to the async proxy (wgmma, TMA) of this CTA.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Byte offset of 16-byte chunk `c` (0..7) of row `r` in a tile of 128-byte
// rows with the 128-byte swizzle (TMA's CU_TENSOR_MAP_SWIZZLE_128B and
// wgmma's layout type 1): the chunk index is XORed with r mod 8.
__device__ __forceinline__ uint32_t swz128(int r, int c) {
  return (uint32_t)(r * 128 + ((c ^ (r & 7)) << 4));
}

// wgmma shared-memory matrix descriptor, 128-byte swizzle.  `lbo`: bytes
// between 64-element column blocks of an MN-major operand (unused for
// K-major); `sbo`: bytes between groups of 8 rows (1024 for 128-byte rows).
__device__ __forceinline__ uint64_t wgmma_desc(const void* p, uint32_t lbo,
                                               uint32_t sbo) {
  uint64_t d = (uint64_t)((smem_u32(p) & 0x3FFFFu) >> 4);
  d |= (uint64_t)((lbo >> 4) & 0x3FFFu) << 16;
  d |= (uint64_t)((sbo >> 4) & 0x3FFFu) << 32;
  d |= (uint64_t)1 << 62;
  return d;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving accesses of wgmma accumulators across
// the asynchronous product.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// bf16 wgmma, m64nNk16, fp32 accumulators d (the fragment layout of
// mma.m16n8: thread t of the warpgroup holds rows 16 (t/32) + (t%32)/4 and
// + 8, columns 8j + 2 (t%4) and + 1, as d[4j + 0..3]).  ss: A and B by
// shared-memory descriptors, A K-major; rs: A from registers (four bf16x2
// a thread, the layout of mma.m16n8k16's A).  TB: 1 when B is MN-major
// (N contiguous), 0 when K-major.  F16 (n32 and the rs forms): both
// operands fp16 instead, in the same layouts.

#define REPRO_WGMMA_N32(TYPES)                                                \
  asm volatile(                                                               \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"                            \
      "wgmma.mma_async.sync.aligned.m64n32k16.f32." TYPES " {"                \
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "     \
      "%15"                                                                   \
      "}, %16, %17, p, 1, 1, 0, %19;\n}\n"                                    \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),           \
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),           \
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),      \
        "+f"(d[15])                                                           \
      : "l"(da), "l"(db), "r"(1), "n"(TB))

template <int TB, bool F16 = false>
__device__ __forceinline__ void wgmma_ss_n32(
    float (&d)[16], uint64_t da, uint64_t db) {
  if constexpr (F16)
    REPRO_WGMMA_N32("f16.f16");
  else
    REPRO_WGMMA_N32("bf16.bf16");
}
#undef REPRO_WGMMA_N32

template <int TB>
__device__ __forceinline__ void wgmma_ss_n64(
    float (&d)[32], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, %35;\n}\n"
    : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),
      "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
      "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
      "+f"(d[31])
      : "l"(da), "l"(db), "r"(1), "n"(TB));
}

template <int TB>
__device__ __forceinline__ void wgmma_ss_n128(
    float (&d)[64], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, %67;\n}\n"
    : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),
      "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
      "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
      "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
      "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]),
      "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]),
      "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]),
      "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
      "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),
      "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1), "n"(TB));
}

#define REPRO_WGMMA_RS_N64(TYPES)                                             \
  asm volatile(                                                               \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"                            \
      "wgmma.mma_async.sync.aligned.m64n64k16.f32." TYPES " {"                \
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "     \
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "     \
      "%28, %29, %30, %31"                                                    \
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"                      \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),           \
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),           \
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),      \
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),      \
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),      \
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),      \
        "+f"(d[30]), "+f"(d[31])                                              \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1),         \
        "n"(TB))

template <int TB, bool F16 = false>
__device__ __forceinline__ void wgmma_rs_n64(
    float (&d)[32], const uint32_t (&a)[4],
    uint64_t db) {
  if constexpr (F16)
    REPRO_WGMMA_RS_N64("f16.f16");
  else
    REPRO_WGMMA_RS_N64("bf16.bf16");
}
#undef REPRO_WGMMA_RS_N64

#define REPRO_WGMMA_RS_N128(TYPES)                                            \
  asm volatile(                                                               \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"                            \
      "wgmma.mma_async.sync.aligned.m64n128k16.f32." TYPES " {"               \
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "     \
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "     \
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "     \
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "     \
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63"                      \
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, %70;\n}\n"                      \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),           \
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),           \
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),      \
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),      \
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),      \
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),      \
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),      \
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),      \
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),      \
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),      \
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),      \
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),      \
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])                    \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1),         \
        "n"(TB))

template <int TB, bool F16 = false>
__device__ __forceinline__ void wgmma_rs_n128(
    float (&d)[64], const uint32_t (&a)[4],
    uint64_t db) {
  if constexpr (F16)
    REPRO_WGMMA_RS_N128("f16.f16");
  else
    REPRO_WGMMA_RS_N128("bf16.bf16");
}
#undef REPRO_WGMMA_RS_N128

// ---- split reductions and the bf16 epilogue (vwr_matmul's split-K and
// tile kernels, vwr_conv2d's wgmma kernel): a block that owns one K slice
// of an output tile stores its fp32 partial; the last of the tile's blocks
// sums them in split order and runs the epilogue (one launch, no float
// atomics, bitwise reproducible) ----

__device__ __forceinline__ void bar_sync(int id, int nthreads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(nthreads) : "memory");
}

// bias -> activation -> residual -> one cast, for columns n and n + 1 of
// row m (n even, N % 8 == 0: one 4-byte load and store).
__device__ __forceinline__ void epilogue_pair(const __nv_bfloat16* bias,
                                              const __nv_bfloat16* res,
                                              __nv_bfloat16* out, int m,
                                              int n, int N, float v0,
                                              float v1, int act) {
  if (bias != nullptr) {
    const float2 b = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(bias + n));
    v0 += b.x;
    v1 += b.y;
  }
  v0 = activate(v0, act);
  v1 = activate(v1, act);
  const size_t o = (size_t)m * N + n;
  if (res != nullptr) {
    const float2 r = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(res + o));
    v0 += r.x;
    v1 += r.y;
  }
  *reinterpret_cast<__nv_bfloat162*>(out + o) = __floats2bfloat162_rn(v0, v1);
}

// Called by the `nthreads` threads (thread 0 among them) of a block that
// has stored its fp32 partial: true in the last of the `nsplit` blocks of
// its output tile to get here.  The fence before the count publishes the
// partial; the one after it orders the reads of the others' partials.
__device__ __forceinline__ bool last_split(int* counter, int nsplit,
                                           int nthreads) {
  __shared__ int last;
  __threadfence();
  bar_sync(1, nthreads);
  if (threadIdx.x == 0) last = atomicAdd(counter, 1) == nsplit - 1;
  bar_sync(1, nthreads);
  if (!last) return false;
  __threadfence();
  return true;
}

// The last block of a tile: rows [m0, m0 + bm) x columns [n0, n0 + bn) of
// the nsplit fp32 partials (planes of M x N), summed in split order, then
// the epilogue; the tile's counter goes back to 0 for the next launch.
// Four columns a thread and FIN partials in flight before the adds, so the
// sum waits on L2 nsplit / FIN times, not nsplit times.
constexpr int FIN = 16;
__device__ void finish_tile(const float* ws, int* counter, int nsplit, int M,
                            int N, int m0, int bm, int n0, int bn,
                            const __nv_bfloat16* bias,
                            const __nv_bfloat16* res, __nv_bfloat16* out,
                            int act, int tid, int nthreads) {
  const size_t plane = (size_t)M * N;
  for (int i = tid; i < bm * bn / 4; i += nthreads) {
    const int m = m0 + i / (bn / 4), n = n0 + 4 * (i % (bn / 4));
    if (m >= M || n >= N) continue;
    const float* p = ws + (size_t)m * N + n;
    float4 s = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    for (int j0 = 0; j0 < nsplit; j0 += FIN) {
      float4 t[FIN];
#pragma unroll
      for (int u = 0; u < FIN; ++u)
        t[u] = j0 + u < nsplit
                   ? __ldcg(reinterpret_cast<const float4*>(
                         p + (j0 + u) * plane))
                   : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll
      for (int u = 0; u < FIN; ++u) {
        s.x += t[u].x;
        s.y += t[u].y;
        s.z += t[u].z;
        s.w += t[u].w;
      }
    }
    epilogue_pair(bias, res, out, m, n, N, s.x, s.y, act);
    epilogue_pair(bias, res, out, m, n + 2, N, s.z, s.w, act);
  }
  if (tid == 0) *counter = 0;
}

// ---- vwr_swiglu's epilogue on the same split reductions: the partials of
// a tile are g and h in planes of M x 2N (g at column n, h at N + n) ----

// silu(g) * h in fp32, then one cast, for columns n and n + 1 of row m
// (n even, N % 8 == 0: one 4-byte store).
__device__ __forceinline__ void swiglu_pair(__nv_bfloat16* out, int m, int n,
                                            int N, float g0, float g1,
                                            float h0, float h1) {
  *reinterpret_cast<__nv_bfloat162*>(out + (size_t)m * N + n) =
      __floats2bfloat162_rn(silu(g0) * h0, silu(g1) * h1);
}

// Four consecutive fp32 partials at `p` of each of `nsplit` planes,
// summed in split order, FIN loads in flight before the adds.
__device__ __forceinline__ float4 sum_splits(const float* p, size_t plane,
                                             int nsplit) {
  float4 s = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  for (int j0 = 0; j0 < nsplit; j0 += FIN) {
    float4 t[FIN];
#pragma unroll
    for (int u = 0; u < FIN; ++u)
      t[u] = j0 + u < nsplit
                 ? __ldcg(reinterpret_cast<const float4*>(p + (j0 + u) * plane))
                 : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll
    for (int u = 0; u < FIN; ++u) {
      s.x += t[u].x;
      s.y += t[u].y;
      s.z += t[u].z;
      s.w += t[u].w;
    }
  }
  return s;
}

// finish_tile for vwr_swiglu: rows [m0, m0 + bm) x output columns [n0, n0
// + bn), g and h each summed in split order, then silu(g) * h; the tile's
// counter goes back to 0.
__device__ void finish_swiglu_tile(const float* ws, int* counter, int nsplit,
                                   int M, int N, int m0, int bm, int n0,
                                   int bn, __nv_bfloat16* out, int tid,
                                   int nthreads) {
  const size_t plane = (size_t)M * 2 * N;
  for (int i = tid; i < bm * bn / 4; i += nthreads) {
    const int m = m0 + i / (bn / 4), n = n0 + 4 * (i % (bn / 4));
    if (m >= M || n >= N) continue;
    const float* p = ws + (size_t)m * 2 * N + n;
    const float4 g = sum_splits(p, plane, nsplit);
    const float4 h = sum_splits(p + N, plane, nsplit);
    swiglu_pair(out, m, n, N, g.x, g.y, h.x, h.y);
    swiglu_pair(out, m, n + 2, N, g.z, g.w, h.z, h.w);
  }
  if (tid == 0) *counter = 0;
}

// ---- split flash partials (vwr_decode's split kernel, vwr_chunk_prefix's
// and vwr_mla_decode's wgmma kernels): a block that owns one key split of a row group stores the
// unnormalized fp32 partial (o_tilde, m, l) of its keys; the last of the
// group's blocks (last_split) merges them in split order (one launch, no
// float atomics, bitwise reproducible) ----

// The last block of a row group: `rows` rows of `nsplit` <= FIN_SPLITS
// partials (o_tilde rows x D at o_part + s * o_step, m and l at m_part /
// l_part + s * ml_step) merged in split order with the flash combine: m =
// max_s m_s, each split weighted by exp(m_s - m), or 0 for a split without
// a valid key (m_s = -1e30), so a row with no valid key in any split gets
// m = -1e30, l = 0, o = 0.  Every split's m and l are loaded at once, and
// FIN partials of o in flight before the adds (4 items of 4 columns a
// thread, 4 splits of each), so the merge waits on L2 about 1 + (items a
// thread / 4) (nsplit / 4) times, however few the splits.  `wsm`: rows * nsplit floats of shared
// memory for the weights.  Called by all `nthreads` threads of the block;
// the group's counter goes back to 0 for the next launch.  D % 4 == 0, o
// 16-byte aligned; `ldo`: o's row stride (D unless given; the partials'
// is D).
constexpr int FIN_SPLITS = 32;
__device__ void finish_partials(const float* o_part, const float* m_part,
                                const float* l_part, int nsplit,
                                size_t o_step, size_t ml_step, int rows,
                                int D, float* o, float* m, float* l,
                                int* counter, float* wsm, int tid,
                                int nthreads, int ldo = 0) {
  if (ldo == 0) ldo = D;
  for (int r = tid; r < rows; r += nthreads) {
    float ms[FIN_SPLITS], ls[FIN_SPLITS];
#pragma unroll
    for (int s = 0; s < FIN_SPLITS; ++s) {
      const bool in = s < nsplit;
      ms[s] = in ? __ldcg(m_part + s * ml_step + r) : REPRO_NEG_INF;
      ls[s] = in ? __ldcg(l_part + s * ml_step + r) : 0.0f;
    }
    float mx = REPRO_NEG_INF;
#pragma unroll
    for (int s = 0; s < FIN_SPLITS; ++s) mx = fmaxf(mx, ms[s]);
    float lsum = 0.0f;
#pragma unroll
    for (int s = 0; s < FIN_SPLITS; ++s) {
      if (s >= nsplit) break;
      const float w = ms[s] > REPRO_NEG_INF / 2 ? expf(ms[s] - mx) : 0.0f;
      wsm[s * rows + r] = w;
      lsum += ls[s] * w;
    }
    m[r] = mx;
    l[r] = lsum;
  }
  __syncthreads();
  // FI_ITEMS 4-column items a thread at once, FIN / FI_ITEMS splits of
  // each in flight: FIN loads before the adds however few the splits
  constexpr int FI_ITEMS = 4, FI_SPLITS = FIN / FI_ITEMS;
  const int q4 = D / 4, items = rows * q4;
  for (int i0 = tid; i0 < items; i0 += FI_ITEMS * nthreads) {
    float4 acc[FI_ITEMS];
#pragma unroll
    for (int v = 0; v < FI_ITEMS; ++v)
      acc[v] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    for (int s0 = 0; s0 < nsplit; s0 += FI_SPLITS) {
      float4 t[FI_ITEMS][FI_SPLITS];
#pragma unroll
      for (int v = 0; v < FI_ITEMS; ++v) {
        const int i = i0 + v * nthreads;
        const float* p = o_part + (size_t)(i / q4) * D + 4 * (i % q4);
#pragma unroll
        for (int u = 0; u < FI_SPLITS; ++u)
          t[v][u] = i < items && s0 + u < nsplit
                        ? __ldcg(reinterpret_cast<const float4*>(
                              p + (s0 + u) * o_step))
                        : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      }
#pragma unroll
      for (int v = 0; v < FI_ITEMS; ++v) {
        const int r = (i0 + v * nthreads) / q4;
#pragma unroll
        for (int u = 0; u < FI_SPLITS; ++u) {
          if (s0 + u >= nsplit || r >= rows) break;
          const float w = wsm[(s0 + u) * rows + r];
          acc[v].x = fmaf(t[v][u].x, w, acc[v].x);
          acc[v].y = fmaf(t[v][u].y, w, acc[v].y);
          acc[v].z = fmaf(t[v][u].z, w, acc[v].z);
          acc[v].w = fmaf(t[v][u].w, w, acc[v].w);
        }
      }
    }
#pragma unroll
    for (int v = 0; v < FI_ITEMS; ++v) {
      const int i = i0 + v * nthreads;
      if (i < items)
        *reinterpret_cast<float4*>(o + (size_t)(i / q4) * ldo +
                                   4 * (i % q4)) = acc[v];
    }
  }
  if (tid == 0) *counter = 0;
}

// Two fp32 values as two bf16x2 terms: hi = bf16(x), lo = bf16(x - hi)
// (hi + lo keeps x to ~2^-17; kernels/vwr_mla_decode.py _bf16_terms).
__device__ __forceinline__ void bf16_terms(float x0, float x1, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat162 b = __floats2bfloat162_rn(x0, x1);
  const float2 bf = __bfloat1622float2(b);
  hi = *reinterpret_cast<const uint32_t*>(&b);
  lo = pack_bf16(x0 - bf.x, x1 - bf.y);
}

// Two fp32 values as two f16x2 terms: hi = fp16(x), lo = fp16(x - hi)
// (hi + lo keeps an x in [2^-14, 1] to ~2^-22).
__device__ __forceinline__ void f16_terms(float x0, float x1, uint32_t& hi,
                                          uint32_t& lo) {
  const __half2 b = __floats2half2_rn(x0, x1);
  const float2 bf = __half22float2(b);
  hi = *reinterpret_cast<const uint32_t*>(&b);
  lo = pack_f16(x0 - bf.x, x1 - bf.y);
}

// ---- int8 keys and values as 16-bit operands (kernels 8, 9 and 15): an
// int8 value is exact in both bf16 and fp16, so the tensor cores take it
// converted, and its scale is applied in fp32 around the products ----

// Four int8 (one word, the first in the low byte) as two fp16x2 words,
// exactly: each byte + 128 is set as the mantissa of 1024 (0x6400), and
// 1152 = 1024 + 128 subtracted (integer ops and one fp16 subtraction a
// pair, not four conversions).
__device__ __forceinline__ void i8x4_to_f16(uint32_t w, uint32_t& lo,
                                            uint32_t& hi) {
  const uint32_t u = w ^ 0x80808080u;
  const __half2 bias = __float2half2_rn(1152.0f);
  uint32_t a = __byte_perm(u, 0x64646464u, 0x4140);
  uint32_t b = __byte_perm(u, 0x64646464u, 0x4342);
  const __half2 x = __hsub2(*reinterpret_cast<__half2*>(&a), bias);
  const __half2 y = __hsub2(*reinterpret_cast<__half2*>(&b), bias);
  lo = *reinterpret_cast<const uint32_t*>(&x);
  hi = *reinterpret_cast<const uint32_t*>(&y);
}

// Four int8 as two bf16x2 words, exactly: each byte + 128 is set as the
// low mantissa byte of 2^23 in fp32 (0x4B000000), 2^23 + 128 subtracted,
// and each pair packed (|x| <= 128 is exact in bf16).
__device__ __forceinline__ void i8x4_to_bf16(uint32_t w, uint32_t& lo,
                                             uint32_t& hi) {
  const uint32_t u = w ^ 0x80808080u;
  const float bias = 8388736.0f;  // 2^23 + 128
  const float x0 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7540));
  const float x1 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7541));
  const float x2 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7542));
  const float x3 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7543));
  lo = pack_bf16(x0 - bias, x1 - bias);
  hi = pack_bf16(x2 - bias, x3 - bias);
}

// 16 int8 (one 16-byte chunk) as two 16-byte chunks of bf16 or fp16.
template <bool F16>
__device__ __forceinline__ void i8x16_to_16bit(const uint4& raw,
                                               uint4 (&out)[2]) {
  auto cvt = [](uint32_t w, uint32_t& lo, uint32_t& hi) {
    if constexpr (F16)
      i8x4_to_f16(w, lo, hi);
    else
      i8x4_to_bf16(w, lo, hi);
  };
  cvt(raw.x, out[0].x, out[0].y);
  cvt(raw.y, out[0].z, out[0].w);
  cvt(raw.z, out[1].x, out[1].y);
  cvt(raw.w, out[1].z, out[1].w);
}

// The power of two that brings `amax` into [2^14, 2^15) (1 for 0), so
// that x times it and its fp16 terms stay inside fp16's normal range for
// every |x| within 2^-17 of amax (kernels/vwr_mla_decode.py _pow2_up).
__device__ __forceinline__ float pow2_up(float amax) {
  if (!(amax > 0.0f)) return 1.0f;
  int e;
  frexpf(amax, &e);
  return ldexpf(1.0f, min(15 - e, 126));
}

// ---- mma.sync (vwr_decode's split kernel) ----

// d (16 x 8, fp32) += a (16 x 16, bf16, row-major) . b (16 x 8, bf16,
// column-major): PTX's mma.m16n8k16 with g = lane / 4, t = lane % 4: a0
// (row g, columns 2t, 2t + 1), a1 (row g + 8), a2 (row g, columns 2t + 8,
// + 9), a3 (row g + 8, columns 2t + 8, + 9); b0 (rows 2t, 2t + 1 of column
// g), b1 (rows 2t + 8, + 9); d0, d1 (row g, columns 2t, 2t + 1), d2, d3
// (row g + 8).
__device__ __forceinline__ void mma_bf16(float (&d)[4],
                                         const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
// The same with fp16 operands.
__device__ __forceinline__ void mma_f16(float (&d)[4], const uint32_t (&a)[4],
                                        uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Four 8 x 8 b16 matrices from shared memory: lanes 8i .. 8i + 7 give the
// addresses of matrix i's rows, and r[i] is its fragment (row lane / 4,
// columns 2 (lane % 4), + 1); _trans: the fragment of its transpose.
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// ---- split flash decode on mma.sync (vwr_decode's split kernels, kernels
// 4 and 9, and vwr_paged_decode's mma kernels, kernels 5 and 7): a
// 128-thread block scores
// its group's G <= 16 query rows, zero-padded to 16, against staged 64-key
// tiles, warp w the 16-key slice w of each, and writes the group's
// partial or its split's ----

constexpr int SD_THREADS = 128, SD_TILE = 64, SD_SLICE = 16;

// Byte offset of 16-byte chunk c of key row r in a staged tile: 64-column
// blocks of SD_TILE 128-byte rows, 128-byte swizzle.
__device__ __forceinline__ uint32_t sd_chunk(int r, int c) {
  return (uint32_t)((c / 8) * (SD_TILE * 128)) + swz128(r, c % 8);
}

// The group's G query rows (row stride D, zero past G) as the A fragments
// of S = Q K^T: rows lane / 4 and lane / 4 + 8.
template <int D>
__device__ __forceinline__ void sd_load_q(uint32_t (&qa)[D / 16][4],
                                          const __nv_bfloat16* qb, int G,
                                          int lane) {
  const int g = lane / 4, t4 = lane % 4;
  auto pair = [&](int r, int c) -> uint32_t {
    return r < G ? *reinterpret_cast<const uint32_t*>(qb + (size_t)r * D + c)
                 : 0u;
  };
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int c = 16 * kk + 2 * t4;
    qa[kk][0] = pair(g, c);
    qa[kk][1] = pair(g + 8, c);
    qa[kk][2] = pair(g, c + 8);
    qa[kk][3] = pair(g + 8, c + 8);
  }
}

// The int8 split kernels (kernels 9 and 7): a warp's 16 rows r0 .. r0 + 15
// of the int8 K tile at kt and of the V tile I8 bytes after it (D bytes a
// row) converted into the 16-bit tiles the slice step reads: K as bf16
// into k16, V as fp16 into v16 (sd_chunk's layout).  Exact: an int8 value
// is exact in both.
template <int D>
__device__ __forceinline__ void sd_convert_q8(const unsigned char* kt,
                                              int I8, unsigned char* k16,
                                              unsigned char* v16, int r0,
                                              int lane) {
  constexpr int NB = D / 16;  // 16-byte int8 chunks a row
  for (int e = lane; e < SD_SLICE * NB; e += 32) {
    const int r = r0 + e / NB, c = e % NB;
    uint4 f[2];
    i8x16_to_16bit<false>(
        *reinterpret_cast<const uint4*>(kt + r * D + c * 16), f);
    *reinterpret_cast<uint4*>(k16 + sd_chunk(r, 2 * c)) = f[0];
    *reinterpret_cast<uint4*>(k16 + sd_chunk(r, 2 * c + 1)) = f[1];
    i8x16_to_16bit<true>(
        *reinterpret_cast<const uint4*>(kt + I8 + r * D + c * 16), f);
    *reinterpret_cast<uint4*>(v16 + sd_chunk(r, 2 * c)) = f[0];
    *reinterpret_cast<uint4*>(v16 + sd_chunk(r, 2 * c + 1)) = f[1];
  }
}

// The running partial of one warp: rows g and g + 8 of the online softmax
// (l sums this thread's columns) and their o fragments.
template <int D>
struct SdPartial {
  float m0 = REPRO_NEG_INF, m1 = REPRO_NEG_INF, l0 = 0.0f, l1 = 0.0f;
  float o[D / 8][4] = {};
};

// One warp's step over its slice: key rows row0 .. row0 + 15 of the staged
// K tile kt and V tile vt, whose valid keys are the set bits of `valid`
// (at least one).  S = Q K^T on mma.sync with K by ldmatrix (exact
// products of bf16 values), `scale` on the fp32 score, masked keys at P =
// 0, the online softmax in fp32 on the fragment, and O += P V with P as
// two bf16 terms (hi, lo = bf16(p - hi): ~2^-17 a weight; one term, 2^-9,
// misses the 1e-4 limit) and V by ldmatrix.trans.  F16 (kernel 9's int8
// cache): V is fp16 and P two fp16 terms (~2^-22 a weight: p <= 1 needs
// no scaling; two bf16 terms used 0.94 of the limit at 2048 int8 keys).
// PK (kernel 7's int8 pages, whose scales vary per key): the slice's 16
// keys' k and v scales at ksc / vsc; key t's score takes scale * ksc[t],
// and its p (after l) vsc[t] * pup before the terms.
template <int D, bool F16 = false, bool PK = false>
__device__ __forceinline__ void sd_slice(SdPartial<D>& w,
                                         const uint32_t (&qa)[D / 16][4],
                                         const unsigned char* kt,
                                         const unsigned char* vt, int row0,
                                         uint32_t valid, float scale,
                                         int lane, const float* ksc = nullptr,
                                         const float* vsc = nullptr,
                                         float pup = 1.0f) {
  const int t4 = lane % 4, mi = lane / 8, mr = lane % 8;
  // S (16 rows x 16 keys): key blocks j = 0, 1 of 8 keys
  float s[2][4] = {};
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    uint32_t kf[4];
    ldsm_x4(kf, kt + sd_chunk(row0 + 8 * (mi / 2) + mr, 2 * kk + mi % 2));
    mma_bf16(s[0], qa[kk], kf[0], kf[1]);
    mma_bf16(s[1], qa[kk], kf[2], kf[3]);
  }
  bool in[2][2];
  float mx0 = w.m0, mx1 = w.m1;
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      in[j][e] = valid >> (8 * j + 2 * t4 + e) & 1u;
      const float f = PK ? scale * ksc[8 * j + 2 * t4 + e] : scale;
      s[j][e] = in[j][e] ? s[j][e] * f : REPRO_NEG_INF;
      s[j][2 + e] = in[j][e] ? s[j][2 + e] * f : REPRO_NEG_INF;
      mx0 = fmaxf(mx0, s[j][e]);
      mx1 = fmaxf(mx1, s[j][2 + e]);
    }
  // the slice holds a valid key, so the maxima are real scores from here
  mx0 = quad_max(mx0);
  mx1 = quad_max(mx1);
  const float c0 = expf(w.m0 - mx0), c1 = expf(w.m1 - mx1);
  w.m0 = mx0;
  w.m1 = mx1;
  w.l0 *= c0;
  w.l1 *= c1;
#pragma unroll
  for (int nb = 0; nb < D / 8; ++nb) {
    w.o[nb][0] *= c0;
    w.o[nb][1] *= c0;
    w.o[nb][2] *= c1;
    w.o[nb][3] *= c1;
  }
  float p[2][4];
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      p[j][e] = in[j][e] ? expf(s[j][e] - w.m0) : 0.0f;
      p[j][2 + e] = in[j][e] ? expf(s[j][2 + e] - w.m1) : 0.0f;
      w.l0 += p[j][e];
      w.l1 += p[j][2 + e];
      if constexpr (PK) {  // the value scale rides on p, after l
        const float f = vsc[8 * j + 2 * t4 + e] * pup;
        p[j][e] *= f;
        p[j][2 + e] *= f;
      }
    }
  // P as two bf16 terms, the A fragments of O += P V: keys 0-7 are key
  // block 0, keys 8-15 block 1
  uint32_t ph[4], pl[4];
  auto terms = [](float x0, float x1, uint32_t& hi, uint32_t& lo) {
    if constexpr (F16)
      f16_terms(x0, x1, hi, lo);
    else
      bf16_terms(x0, x1, hi, lo);
  };
  terms(p[0][0], p[0][1], ph[0], pl[0]);
  terms(p[0][2], p[0][3], ph[1], pl[1]);
  terms(p[1][0], p[1][1], ph[2], pl[2]);
  terms(p[1][2], p[1][3], ph[3], pl[3]);
  auto mma = [](float(&d)[4], const uint32_t(&a)[4], uint32_t b0,
                uint32_t b1) {
    if constexpr (F16)
      mma_f16(d, a, b0, b1);
    else
      mma_bf16(d, a, b0, b1);
  };
#pragma unroll
  for (int nb = 0; nb < D / 8; nb += 2) {
    uint32_t vf[4];  // V transposed: columns nb and nb + 1
    ldsm_x4_trans(vf, vt + sd_chunk(row0 + 8 * (mi % 2) + mr, nb + mi / 2));
    mma(w.o[nb], ph, vf[0], vf[1]);
    mma(w.o[nb], pl, vf[0], vf[1]);
    mma(w.o[nb + 1], ph, vf[2], vf[3]);
    mma(w.o[nb + 1], pl, vf[2], vf[3]);
  }
}

// The block's end, after its key loop (every thread of the block calls
// it): its cp.async copies drained, the four warps' partials merged in
// shared memory (`sm`, the freed stages) in warp order with the flash
// combine (m > -1e30/2 guard) into group bkv's outputs (one split) or into
// split `split`'s partial in `ws` (G x D o, then m, then l, for `groups`
// groups of `nsplit` splits); the group's last block (last_split) then
// merges the partials in split order (finish_partials) and resets the
// group's counter: one launch, no float atomics, bitwise reproducible.
// `vs` multiplies the block's merged o_tilde (kernel 9: the group's v
// scale, constant over its keys; 1 otherwise).
template <int D>
__device__ __forceinline__ void sd_finish(SdPartial<D>& w, unsigned char* sm,
                                          float* o_t, float* m_out,
                                          float* l_out, float* ws,
                                          int* counters, int groups, int bkv,
                                          int split, int nsplit, int G,
                                          float vs = 1.0f) {
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t4 = lane % 4;
  cp_async_wait<0>();
  __syncthreads();  // every warp is done with the stages
  const float l0 = quad_sum(w.l0), l1 = quad_sum(w.l1);
  float* Os = reinterpret_cast<float*>(sm);  // [warp][16][D]
  float* Ms = Os + 4 * 16 * D;               // [warp][16]
  float* Ls = Ms + 4 * 16;
#pragma unroll
  for (int nb = 0; nb < D / 8; ++nb) {
    const int col = 8 * nb + 2 * t4;
    *reinterpret_cast<float2*>(Os + (warp * 16 + g) * D + col) =
        make_float2(w.o[nb][0], w.o[nb][1]);
    *reinterpret_cast<float2*>(Os + (warp * 16 + g + 8) * D + col) =
        make_float2(w.o[nb][2], w.o[nb][3]);
  }
  if (t4 == 0) {
    Ms[warp * 16 + g] = w.m0;
    Ms[warp * 16 + g + 8] = w.m1;
    Ls[warp * 16 + g] = l0;
    Ls[warp * 16 + g + 8] = l1;
  }
  __syncthreads();
  // one split: straight to the outputs; else this split's partial
  const int S = nsplit;
  const size_t part = (size_t)bkv * S + split;
  float* o_dst = S == 1 ? o_t + (size_t)bkv * G * D : ws + part * G * D;
  float* m_ws = ws + (size_t)groups * S * G * D;
  float* l_ws = m_ws + (size_t)groups * S * G;
  float* m_dst = S == 1 ? m_out + (size_t)bkv * G : m_ws + part * G;
  float* l_dst = S == 1 ? l_out + (size_t)bkv * G : l_ws + part * G;
  for (int e = tid; e < G * D; e += SD_THREADS) {
    const int r = e / D, d = e % D;
    float mx = REPRO_NEG_INF;
#pragma unroll
    for (int v = 0; v < 4; ++v) mx = fmaxf(mx, Ms[v * 16 + r]);
    float acc = 0.0f, lsum = 0.0f;
#pragma unroll
    for (int v = 0; v < 4; ++v) {
      const float mv = Ms[v * 16 + r];
      const float sw = mv > REPRO_NEG_INF / 2 ? expf(mv - mx) : 0.0f;
      acc += Os[(v * 16 + r) * D + d] * sw;
      lsum += Ls[v * 16 + r] * sw;
    }
    o_dst[e] = acc * vs;
    if (d == 0) {
      m_dst[r] = mx;
      l_dst[r] = lsum;
    }
  }
  if (S == 1) return;
  if (!last_split(&counters[bkv], S, SD_THREADS)) return;
  // the shared bytes of the partials are free (last_split's barrier)
  finish_partials(ws + (size_t)bkv * S * G * D, m_ws + (size_t)bkv * S * G,
                  l_ws + (size_t)bkv * S * G, S, (size_t)G * D, G, G, D,
                  o_t + (size_t)bkv * G * D, m_out + (size_t)bkv * G,
                  l_out + (size_t)bkv * G, &counters[bkv], Os, tid,
                  SD_THREADS);
}

// ---- the walk over a block table (vwr_mla_decode's and vwr_chunk_prefix's
// wgmma kernels): a key tile of KEYS slots holds up to SEGS segments of
// consecutive rows of one page each (seg = min(ps, KEYS) rows a segment,
// KEYS / seg segments a tile) ----

template <int SEGS>
struct KeyTile {
  int page[SEGS];  // physical page (clamped), or -1: no segment
  int row0[SEGS];  // first row within the page
  int n[SEGS];     // valid rows
};

// The next tile from the cursor (page j, row o) up to table entry J, which
// it advances: count-0 pages are skipped unread, entries clamped to [0,
// n_pages).  page[0] < 0: no keys are left.
template <int KEYS, int SEGS>
__device__ __forceinline__ KeyTile<SEGS> next_tile(const int* table,
                                                   const int* counts, int J,
                                                   int ps, int n_pages,
                                                   int seg, int& j, int& o) {
  KeyTile<SEGS> k;
#pragma unroll
  for (int g = 0; g < SEGS; ++g) {
    k.page[g] = -1;
    k.row0[g] = 0;
    k.n[g] = 0;
    if (g * seg + seg > KEYS) continue;
    while (j < J && min(counts[j], ps) <= 0) ++j;
    if (j >= J) continue;
    const int cnt = min(counts[j], ps);
    k.page[g] = min(max(table[j], 0), n_pages - 1);
    k.row0[g] = o;
    k.n[g] = min(cnt - o, seg);
    o += seg;
    if (o >= cnt) {
      ++j;
      o = 0;
    }
  }
  return k;
}

// Slot t of tile k: its pool row (page * ps + row), or -1 where masked.
template <int SEGS>
__device__ __forceinline__ int slot_row(const KeyTile<SEGS>& k, int t,
                                        int seg, int ps) {
  const int g = t / seg, i = t % seg;
  int row = -1;
#pragma unroll
  for (int q = 0; q < SEGS; ++q)
    if (q == g && k.page[q] >= 0 && i < k.n[q])
      row = k.page[q] * ps + k.row0[q] + i;
  return row;
}

// ---- host: tensor maps ----

// cuTensorMapEncodeTiled, reached through the runtime's driver entry
// point, so the library needs no -lcuda.
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                            cudaEnableDefault, &q);
#endif
    if (e == cudaSuccess && q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A row-major bf16 (rows, cols) matrix as 2-d boxes of box_rows x 64
// columns (128 bytes: the 128-byte swizzle's row); columns past `cols`
// read as zeros.
inline int encode_rows(CUtensorMap* map, const void* base, int rows,
                       int cols, int box_rows) {
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return (int)cudaErrorNotSupported;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * 2};
  const cuuint32_t box[2] = {64, (cuuint32_t)box_rows};
  const cuuint32_t unit[2] = {1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
                        const_cast<void*>(base), dims, strides, box, unit,
                        CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

// encode_rows' sibling for a row-major int8 (rows, cols) matrix: 2-d boxes
// of box_rows x box_cols (box_cols * 1 byte a multiple of 16, at most
// 256), no swizzle (the tile is read by the threads that convert it, not
// by wgmma); columns past `cols` read as zeros.
inline int encode_rows_i8(CUtensorMap* map, const void* base, int rows,
                          int cols, int box_rows, int box_cols) {
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return (int)cudaErrorNotSupported;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols};
  const cuuint32_t box[2] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows};
  const cuuint32_t unit[2] = {1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2,
                        const_cast<void*>(base), dims, strides, box, unit,
                        CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_NONE,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}
