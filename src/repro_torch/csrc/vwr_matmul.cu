// Fused-epilogue GEMM and dual-GEMM swiglu for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/vwr_matmul.py :: vwr_matmul_p
//           (act(x @ w + bias) + residual) and vwr_swiglu_p
//           (silu(x @ wg) * (x @ wi)).
//
// What bounds it on an H100: at the prefill shapes of the main path
// (M = B*S = 512 rows, K and N of 2048..5632) a product does ~300-500
// flops per byte it must move, at or above the card's 295 flop/byte
// bf16 ridge, so the tensor cores bound it.  At decode M = B = 4 and
// the weights are the bytes: the kernel is weight-bandwidth-bound
// (each (K, N) weight is streamed once per step).
//
// Design: one 128-thread block per 64x64 output tile; the K axis that
// the TPU grid walked sequentially is a loop inside the block, stepping
// 32 (bf16) or 16 (fp32) at a time through shared memory.  bf16 tiles
// go through WMMA 16x16x16 (tensor cores, fp32 accumulate); fp32 tiles
// through an fp32 FMA loop (no TF32, so fp32 results match a plain
// fp32 product to rounding).  The next K tile is fetched into registers
// while the current one multiplies.  The epilogue runs on the fp32
// accumulators staged in shared memory: bias -> activation -> residual
// -> cast (or silu(g) * h for swiglu, both in fp32), then one store per
// output element, so the output makes one trip to memory.  Ragged M, N
// and K edges are masked in the loads and the store (no padding pass).
// Swiglu feeds one staged x tile to two accumulators.
//
// Known limit: at decode M = 4 a 64-row tile is mostly padding and the
// grid is N/64 blocks, which underfills 132 SMs; a split-K or
// GEMV-shaped variant is later work (PERF.md).
#include <mma.h>

#include "common.cuh"

using namespace nvcuda;

namespace {

constexpr int BM = 64, BN = 64, THREADS = 128;
// bf16 path (WMMA): K step 32, row-major tiles padded by 8 elements
constexpr int BK_H = 32, A_LD = BK_H + 8, B_LD = BN + 8;
// fp32 path (FMA): K step 16, the x tile stored k-major
constexpr int BK_F = 16, AF_LD = BM + 4, BF_LD = BN + 4;
// fp32 accumulator staging for the epilogue
constexpr int C_LD = BN + 4;

// ---- bf16 tiles: 16-byte chunks (common.cuh chunk8), masked ----

struct TileH {
  uint4 a[2];     // x: 64 rows x 4 chunks = 256 chunks, 2 per thread
  uint4 b[2][2];  // each weight: 32 rows x 8 chunks, 2 per thread
};

template <int NW>
__device__ __forceinline__ void fetch_h(const __nv_bfloat16* x,
                                        const __nv_bfloat16* const* w,
                                        int M, int N, int K, int m0, int n0,
                                        int k0, bool vx, bool vw, TileH& t) {
#pragma unroll
  for (int c = 0; c < 2; ++c) {
    const int id = threadIdx.x + c * THREADS;
    t.a[c] = chunk8(x, m0 + (id >> 2), k0 + (id & 3) * 8, M, K, vx);
#pragma unroll
    for (int q = 0; q < NW; ++q)
      t.b[q][c] = chunk8(w[q], k0 + (id >> 3), n0 + (id & 7) * 8, K, N, vw);
  }
}

template <int NW>
__device__ __forceinline__ void store_h(__nv_bfloat16* As, __nv_bfloat16* Bs,
                                        const TileH& t) {
#pragma unroll
  for (int c = 0; c < 2; ++c) {
    const int id = threadIdx.x + c * THREADS;
    *reinterpret_cast<uint4*>(As + (id >> 2) * A_LD + (id & 3) * 8) = t.a[c];
#pragma unroll
    for (int q = 0; q < NW; ++q)
      *reinterpret_cast<uint4*>(Bs + q * BK_H * B_LD + (id >> 3) * B_LD +
                                (id & 7) * 8) = t.b[q][c];
  }
}

// ---- fp32 tiles: one element per slot, masked ----

struct TileF {
  float a[8];     // x: 64 x 16 = 1024 elements, 8 per thread
  float b[2][8];  // each weight: 16 x 64, 8 per thread
};

template <int NW>
__device__ __forceinline__ void fetch_f(const float* x,
                                        const float* const* w, int M, int N,
                                        int K, int m0, int n0, int k0,
                                        TileF& t) {
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    const int id = threadIdx.x + e * THREADS;
    const int gm = m0 + (id >> 4), gk = k0 + (id & 15);
    t.a[e] = (gm < M && gk < K) ? x[(size_t)gm * K + gk] : 0.0f;
    const int wk = k0 + (id >> 6), wn = n0 + (id & 63);
#pragma unroll
    for (int q = 0; q < NW; ++q)
      t.b[q][e] = (wk < K && wn < N) ? w[q][(size_t)wk * N + wn] : 0.0f;
  }
}

template <int NW>
__device__ __forceinline__ void store_f(float* As, float* Bs,
                                        const TileF& t) {
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    const int id = threadIdx.x + e * THREADS;
    As[(id & 15) * AF_LD + (id >> 4)] = t.a[e];
#pragma unroll
    for (int q = 0; q < NW; ++q)
      Bs[q * BK_F * BF_LD + (id >> 6) * BF_LD + (id & 63)] = t.b[q][e];
  }
}

template <typename T, bool DUAL>
__global__ void __launch_bounds__(THREADS)
gemm_kernel(const T* __restrict__ x, const T* __restrict__ w0,
            const T* __restrict__ w1, const T* __restrict__ bias,
            const T* __restrict__ res, T* __restrict__ out, int M, int N,
            int K, int act) {
  constexpr int NW = DUAL ? 2 : 1;
  constexpr int C_BYTES = NW * BM * C_LD * (int)sizeof(float);
  static_assert(C_BYTES >= (BM * A_LD + NW * BK_H * B_LD) * 2,
                "bf16 tiles must fit in the staging buffer");
  static_assert(C_BYTES >= (BK_F * AF_LD + NW * BK_F * BF_LD) * 4,
                "fp32 tiles must fit in the staging buffer");
  // main-loop tiles, then (after the last barrier) the accumulators
  __shared__ __align__(128) unsigned char smem[C_BYTES];
  float* Cs = reinterpret_cast<float*>(smem);
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int tid = threadIdx.x;

  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    __nv_bfloat16* As = reinterpret_cast<__nv_bfloat16*>(smem);
    __nv_bfloat16* Bs = As + BM * A_LD;
    const bool vx = (reinterpret_cast<uintptr_t>(x) % 16 == 0) && K % 8 == 0;
    const bool vw = (reinterpret_cast<uintptr_t>(w0) % 16 == 0) &&
                    (!DUAL || reinterpret_cast<uintptr_t>(w1) % 16 == 0) &&
                    N % 8 == 0;
    const int warp = tid / 32, wm = warp / 2, wn = warp % 2;  // 2x2 warps
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[NW][2][2];
#pragma unroll
    for (int q = 0; q < NW; ++q)
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[q][i][j], 0.0f);
    const __nv_bfloat16* ws[2] = {w0, w1};
    TileH t;
    fetch_h<NW>(x, ws, M, N, K, m0, n0, 0, vx, vw, t);
    for (int k0 = 0; k0 < K; k0 += BK_H) {
      store_h<NW>(As, Bs, t);
      __syncthreads();
      if (k0 + BK_H < K) fetch_h<NW>(x, ws, M, N, K, m0, n0, k0 + BK_H, vx,
                                     vw, t);
#pragma unroll
      for (int kk = 0; kk < BK_H; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                       wmma::row_major> a[2];
#pragma unroll
        for (int i = 0; i < 2; ++i)
          wmma::load_matrix_sync(a[i], As + (wm * 32 + i * 16) * A_LD + kk,
                                 A_LD);
#pragma unroll
        for (int q = 0; q < NW; ++q)
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                           wmma::row_major> b;
            wmma::load_matrix_sync(
                b, Bs + q * BK_H * B_LD + kk * B_LD + wn * 32 + j * 16,
                B_LD);
#pragma unroll
            for (int i = 0; i < 2; ++i)
              wmma::mma_sync(acc[q][i][j], a[i], b, acc[q][i][j]);
          }
      }
      __syncthreads();
    }
#pragma unroll
    for (int q = 0; q < NW; ++q)
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j)
          wmma::store_matrix_sync(
              Cs + q * BM * C_LD + (wm * 32 + i * 16) * C_LD + wn * 32 +
                  j * 16,
              acc[q][i][j], C_LD, wmma::mem_row_major);
  } else {
    float* As = reinterpret_cast<float*>(smem);
    float* Bs = As + BK_F * AF_LD;
    const int ty = tid / 8, tx = tid % 8;  // rows ty*4+i, cols tx+8*j
    float acc[NW][4][8] = {};
    const float* ws[2] = {w0, w1};
    TileF t;
    fetch_f<NW>(x, ws, M, N, K, m0, n0, 0, t);
    for (int k0 = 0; k0 < K; k0 += BK_F) {
      store_f<NW>(As, Bs, t);
      __syncthreads();
      if (k0 + BK_F < K) fetch_f<NW>(x, ws, M, N, K, m0, n0, k0 + BK_F, t);
#pragma unroll
      for (int kk = 0; kk < BK_F; ++kk) {
        float a[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = As[kk * AF_LD + ty * 4 + i];
#pragma unroll
        for (int q = 0; q < NW; ++q)
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const float b = Bs[q * BK_F * BF_LD + kk * BF_LD + tx + 8 * j];
#pragma unroll
            for (int i = 0; i < 4; ++i)
              acc[q][i][j] = fmaf(a[i], b, acc[q][i][j]);
          }
      }
      __syncthreads();
    }
#pragma unroll
    for (int q = 0; q < NW; ++q)
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j)
          Cs[q * BM * C_LD + (ty * 4 + i) * C_LD + tx + 8 * j] =
              acc[q][i][j];
  }
  __syncthreads();

  for (int idx = tid; idx < BM * BN; idx += THREADS) {
    const int r = idx / BN, c = idx % BN, m = m0 + r, n = n0 + c;
    if (m >= M || n >= N) continue;
    float v = Cs[r * C_LD + c];
    if constexpr (DUAL) {
      v = silu(v) * Cs[BM * C_LD + r * C_LD + c];
    } else {
      if (bias != nullptr) v += to_f32(bias[n]);
      v = activate(v, act);
      if (res != nullptr) v += to_f32(res[(size_t)m * N + n]);
    }
    out[(size_t)m * N + n] = from_f32<T>(v);
  }
}

template <typename T, bool DUAL>
int launch(const void* x, const void* w0, const void* w1, const void* bias,
           const void* res, void* out, int M, int N, int K, int act,
           void* stream) {
  if (M <= 0 || N <= 0) return 0;
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  gemm_kernel<T, DUAL><<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      (const T*)x, (const T*)w0, (const T*)w1, (const T*)bias,
      (const T*)res, (T*)out, M, N, K, act);
  return (int)cudaGetLastError();
}

}  // namespace

// out (M, N) = act(x (M, K) @ w (K, N) + bias (N,)) + res (M, N);
// bias / res may be null.  All row-major and contiguous.
extern "C" int vwr_matmul_launch(const void* x, const void* w,
                                 const void* bias, const void* res,
                                 void* out, int M, int N, int K, int dtype,
                                 int act, void* stream) {
  if (act < ACT_NONE || act > ACT_GELU) return (int)cudaErrorInvalidValue;
  if (dtype == REPRO_BF16)
    return launch<__nv_bfloat16, false>(x, w, nullptr, bias, res, out, M, N,
                                        K, act, stream);
  if (dtype == REPRO_F32)
    return launch<float, false>(x, w, nullptr, bias, res, out, M, N, K, act,
                                stream);
  return (int)cudaErrorInvalidValue;
}

// out (M, N) = silu(x @ wg) * (x @ wi), the product taken in fp32.
extern "C" int vwr_swiglu_launch(const void* x, const void* wg,
                                 const void* wi, void* out, int M, int N,
                                 int K, int dtype, void* stream) {
  if (dtype == REPRO_BF16)
    return launch<__nv_bfloat16, true>(x, wg, wi, nullptr, nullptr, out, M,
                                       N, K, ACT_NONE, stream);
  if (dtype == REPRO_F32)
    return launch<float, true>(x, wg, wi, nullptr, nullptr, out, M, N, K,
                               ACT_NONE, stream);
  return (int)cudaErrorInvalidValue;
}
