// Fused-epilogue GEMM and dual-GEMM swiglu for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/vwr_matmul.py :: vwr_matmul_p
//           (act(x @ w + bias) + residual) and vwr_swiglu_p
//           (silu(x @ wg) * (x @ wi)).
//
// Three kernels for vwr_matmul, two for vwr_swiglu;
// kernels/vwr_matmul.py `variant` (`swiglu_variant`) picks one per call:
//
// 1. splitk_kernel (bf16 vwr_matmul, M <= the crossover, 4: decode).
//    Bound by the weight's bytes: 4x5632x2048 reads 23 MB for 92 MFLOP.
//    The grid is (M tiles of up to 8 rows) x (128-column strips) x (K
//    splits), sized to about one block on each of the 132 SMs.  A block
//    stages its x slice once in shared memory as fp32 (while its first
//    weight loads fly) and streams its (K slice, strip) of w with 16-byte
//    loads that skip L1 and leave L2 first (the weight is read once a
//    step), two batches of four in flight a thread (the next batch is
//    issued before the current one is used); each thread keeps MT x 8
//    fp32 sums (FMA: at M <= 4 the tensor cores would idle on padding).
//    Partials go to an fp32 workspace; the last block of a strip to finish
//    (an int32 counter a strip, reset to 0 by that block) sums them in
//    split order and runs the epilogue, so a call is one launch and its
//    result is bitwise reproducible.  Swiglu has no split-K variant: its
//    wgmma tiles, on one 64-row tile, stream wg and wi as fast at M 1-2
//    on some shapes and faster on others (PERF.md), so every bf16 swiglu
//    takes them.
// 2. tile_kernel (bf16, larger M: prefill, mixed steps; every bf16
//    swiglu).  Bound by operations at prefill (512x5632x2048: ~11.8 GFLOP
//    against ~30 MB; swiglu 512x2048x5632: 23.6 GFLOP).  One producer warp
//    keeps a 192 KB ring of x (K-major, box 64 x BM) and w (MN-major, 64 x
//    64 boxes) tiles full by TMA with the 128-byte swizzle, completing on
//    mbarriers; one or two consumer warpgroups run wgmma m64n128k16 on them
//    (B transposed, as w lies N-contiguous) with fp32 accumulators in
//    registers.  vwr_matmul loads w's boxes at n0 and n0 + 64; swiglu loads
//    wg's box and wi's box at the same n0, so one n128 product leaves g in
//    accumulator columns 0-63 and h in 64-127 of 64 output columns (or, on
//    128-column strips, two boxes of each and two n128 products).  The
//    epilogue (bias -> act -> residual -> cast, or silu(g) * h) runs once
//    the tile is staged in the idle ring, in one short loop with
//    row-contiguous stores (unrolled over the registers, 32 inlined copies
//    of it were a large fixed cost a block).  The wrapper's tile rule
//    (tile_plan) takes one 128-row tile a column strip up to 128 rows, so
//    the weight is read once, with K split (the same last-block reduction
//    as kernel 1) to ~64 blocks; past 128 rows, 128-row tiles where they
//    fill the SMs, else 64-row ones.  Swiglu's (swiglu_tile_plan) is
//    tile_plan's of the product of width 2N up to 128 rows, on one 64-row
//    tile up to 64 rows, and 128-row tiles on 128-column strips past 128
//    rows (measured, PERF.md).  Ragged M, N and the K tail arrive
//    zero-filled from TMA; the stores are masked.  The tensor maps are
//    encoded on the host at each call, through the driver entry point (no
//    -lcuda).
// 3. gemm_kernel: fp32, and every shape the other two cannot take (K or N
//    not a multiple of 8: TMA and the 16-byte loads need 16-byte rows).
//    One 128-thread block per 64x64 output tile; the K axis is a loop
//    inside the block, stepping 32 (bf16) or 16 (fp32) at a time through
//    shared memory.  bf16 tiles go through WMMA 16x16x16 (fp32
//    accumulate); fp32 tiles through an fp32 FMA loop (no TF32, so fp32
//    results match a plain fp32 product to rounding).  The next K tile is
//    fetched into registers while the current one multiplies.  The
//    epilogue runs on the fp32 accumulators staged in shared memory: bias
//    -> activation -> residual -> cast (or silu(g) * h for swiglu, both in
//    fp32), one store an element; ragged edges are masked in the loads and
//    the store.  Swiglu feeds one staged x tile to two accumulators.
//
// Every variant accumulates in fp32 and casts once, as the Pallas kernel.
#include <mma.h>

#include <chrono>

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

// ---------------------------------------------------------------------
// bf16 variants for Hopper: split-K weight streaming and wgmma + TMA tiles
// ---------------------------------------------------------------------

using bf16 = __nv_bfloat16;

// ---- 1. split-K weight streaming ----

constexpr int SK_THREADS = 256, SK_BN = 128;
constexpr int SK_LANES = SK_BN / 8;             // threads across a strip: 16
constexpr int SK_ROWS = SK_THREADS / SK_LANES;  // w rows a step: 16
constexpr int SK_UNROLL = 4;  // 16-byte loads a batch, two batches in flight
constexpr int SK_WARPS = SK_THREADS / 32;

// An L2 policy that evicts these lines first: the weight stream is read
// once a step, so it should displace nothing else held in L2.
__device__ __forceinline__ uint64_t evict_first_policy() {
  uint64_t policy;
  asm("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;\n"
      : "=l"(policy));
  return policy;
}

// 16 bytes of the weight stream: kept out of L1, first out of L2.
__device__ __forceinline__ uint4 ld_stream(const bf16* p, uint64_t policy) {
  uint4 v;
  asm("ld.global.nc.L1::no_allocate.L2::cache_hint.v4.u32 {%0, %1, %2, %3}, "
      "[%4], %5;\n"
      : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
      : "l"(p), "l"(policy));
  return v;
}

__device__ __forceinline__ void unpack8(uint4 v, float* f) {
  const uint32_t u[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(u[i] << 16);
    f[2 * i + 1] = __uint_as_float(u[i] & 0xFFFF0000u);
  }
}

// Dynamic shared memory (floats): x's slice (MT x ksplit), then the warps'
// sums (SK_WARPS x MT x SK_BN).
template <int MT>
constexpr int splitk_smem_floats(int ksplit) {
  return MT * ksplit > SK_WARPS * MT * SK_BN ? MT * ksplit
                                             : SK_WARPS * MT * SK_BN;
}

// grid (M tiles of MT rows, N strips of SK_BN, K splits of ksplit rows);
// the M tiles of one strip and split are neighbours in launch order, so
// the second reads the weight slice from L2.
template <int MT>
__global__ void __launch_bounds__(SK_THREADS, 2)
splitk_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
              const bf16* __restrict__ bias, const bf16* __restrict__ res,
              bf16* __restrict__ out, float* __restrict__ ws,
              int* __restrict__ counters, int M, int N, int K, int ksplit,
              int act) {
  extern __shared__ float sk_smem[];
  const int mt = blockIdx.x, strip = blockIdx.y, split = blockIdx.z;
  const int nsplit = gridDim.z;
  const int m0 = mt * MT, n0 = strip * SK_BN, k0 = split * ksplit;
  const int kl = min(ksplit, K - k0);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;

  const int c = tid % SK_LANES, r = tid / SK_LANES;
  const bool col_ok = n0 + c * 8 < N;
  const bf16* wp = w + (size_t)k0 * N + n0 + c * 8;
  constexpr int STEP = SK_ROWS * SK_UNROLL;  // rows a batch of loads covers
  const uint64_t policy = evict_first_policy();
  auto fetch = [&](uint4 (&wv)[SK_UNROLL], int kb) {
#pragma unroll
    for (int u = 0; u < SK_UNROLL; ++u) {
      const int k = kb + u * SK_ROWS;
      wv[u] = (col_ok && k < kl) ? ld_stream(wp + (size_t)k * N, policy)
                                 : make_uint4(0, 0, 0, 0);
    }
  };
  float acc[MT][8];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[m][e] = 0.0f;
  float* xs = sk_smem;
  auto consume = [&](const uint4 (&wv)[SK_UNROLL], int kb) {
#pragma unroll
    for (int u = 0; u < SK_UNROLL; ++u) {
      const int k = kb + u * SK_ROWS;
      if (k >= kl) break;
      float wf[8];
      unpack8(wv[u], wf);
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        const float xm = xs[m * ksplit + k];
#pragma unroll
        for (int e = 0; e < 8; ++e) acc[m][e] = fmaf(xm, wf[e], acc[m][e]);
      }
    }
  };
  // two batches of loads in flight: the next one is issued before the
  // current one is multiplied (the first while x is staged)
  uint4 wa[SK_UNROLL], wb[SK_UNROLL];
  fetch(wa, r);
  for (int i = tid; i < MT * kl; i += SK_THREADS) {
    const int m = i / kl, k = i % kl;
    xs[m * ksplit + k] =
        m0 + m < M ? __bfloat162float(x[(size_t)(m0 + m) * K + k0 + k])
                   : 0.0f;
  }
  __syncthreads();
  for (int kb = r; kb < kl; kb += 2 * STEP) {
    fetch(wb, kb + STEP);
    consume(wa, kb);
    fetch(wa, kb + 2 * STEP);
    consume(wb, kb + STEP);
  }

  // the block's sum over its 16 row lanes: lanes l and l + 16 of a warp,
  // then the 8 warps in order
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int e = 0; e < 8; ++e)
      acc[m][e] += __shfl_xor_sync(0xffffffffu, acc[m][e], 16);
  __syncthreads();  // xs is read no more
  float* red = sk_smem;
  if (lane < 16) {
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      float4* dst =
          reinterpret_cast<float4*>(red + (warp * MT + m) * SK_BN + c * 8);
      dst[0] = make_float4(acc[m][0], acc[m][1], acc[m][2], acc[m][3]);
      dst[1] = make_float4(acc[m][4], acc[m][5], acc[m][6], acc[m][7]);
    }
  }
  __syncthreads();
  float* part = ws + (size_t)split * M * N;
  for (int i = tid; i < MT * SK_BN / 2; i += SK_THREADS) {
    const int m = i / (SK_BN / 2), col = 2 * (i % (SK_BN / 2));
    float s0 = 0.0f, s1 = 0.0f;
#pragma unroll
    for (int q = 0; q < SK_WARPS; ++q) {
      s0 += red[(q * MT + m) * SK_BN + col];
      s1 += red[(q * MT + m) * SK_BN + col + 1];
    }
    const int gm = m0 + m, gn = n0 + col;
    if (gm >= M || gn >= N) continue;
    if (nsplit == 1)
      epilogue_pair(bias, res, out, gm, gn, N, s0, s1, act);
    else
      *reinterpret_cast<float2*>(part + (size_t)gm * N + gn) =
          make_float2(s0, s1);
  }
  if (nsplit == 1) return;
  int* counter = counters + mt * gridDim.y + strip;
  if (!last_split(counter, nsplit, SK_THREADS)) return;
  finish_tile(ws, counter, nsplit, M, N, m0, MT, n0, SK_BN, bias, res, out,
              act, tid, SK_THREADS);
}

template <int MT>
int splitk_launch(const void* x, const void* w, const void* bias,
                  const void* res, void* out, void* ws, void* counters,
                  int M, int N, int K, int nsplit, int ksplit, int act,
                  void* stream) {
  const size_t smem = splitk_smem_floats<MT>(ksplit) * sizeof(float);
  if (smem > 48 * 1024) return (int)cudaErrorInvalidValue;  // see the plan
  const dim3 grid((M + MT - 1) / MT, (N + SK_BN - 1) / SK_BN, nsplit);
  splitk_kernel<MT><<<grid, SK_THREADS, smem, (cudaStream_t)stream>>>(
      (const bf16*)x, (const bf16*)w, (const bf16*)bias, (const bf16*)res,
      (bf16*)out, (float*)ws, (int*)counters, M, N, K, ksplit, act);
  return (int)cudaGetLastError();
}

// ---- 2. wgmma + TMA tiles ----

constexpr int TG_BN = 128, TG_BK = 64;
constexpr int TG_B_BOX = TG_BK * 64 * 2;  // one 64 x 64 box of w: 8 KB

// SW: 0 for vwr_matmul (two 64 x 64 boxes of w at n0 and n0 + 64, one
// n128 product: 128 output columns a strip); for vwr_swiglu the boxes of
// wg and then of wi at the same columns, so the products leave g in the
// first half of the accumulator columns and h in the second: SW 1, one
// box of each (one n128 product, 64 output columns a strip); SW 2, two of
// each (two n128 products, 128 output columns a strip).  The ring holds
// 192 KB of tiles: 8 stages of 24 KB at BM 64, 6 of 32 KB at BM 128 (4 of
// 40 / 48 KB at SW 2), enough steps in flight to cover TMA's latency.
template <int BM, int SW>
struct TileShape {
  static constexpr int NC = BM / 64;             // consumer warpgroups
  static constexpr int THREADS = NC * 128 + 32;  // + the producer warp
  static constexpr int NBOX = SW == 2 ? 4 : 2;   // 64 x 64 boxes of w a step
  static constexpr int NACC = NBOX * 32;         // accumulators a thread
  static constexpr int OUTW = SW == 0 ? TG_BN : 64 * SW;  // output columns
  static constexpr int C_LD = NBOX * 64 + 8;     // fp32 row of the staged tile
  static constexpr int A_BYTES = BM * TG_BK * 2;
  static constexpr int STAGE = A_BYTES + NBOX * TG_B_BOX;
  static constexpr int STAGES = 192 * 1024 / STAGE;
  static constexpr int SMEM = 1024 + STAGES * STAGE + 2 * STAGES * 8;
  static_assert(BM * C_LD * 4 <= STAGES * STAGE,
                "the staged accumulators fit in the ring");
};

// grid (N strips of OUTW, M tiles of BM, K splits of kt_split 64-deep
// steps); tw1 is wi's map for swiglu (unused by vwr_matmul)
template <int BM, int SW>
__global__ void __launch_bounds__((TileShape<BM, SW>::THREADS))
tile_kernel(const __grid_constant__ CUtensorMap tx,
            const __grid_constant__ CUtensorMap tw,
            const __grid_constant__ CUtensorMap tw1,
            const bf16* __restrict__ bias, const bf16* __restrict__ res,
            bf16* __restrict__ out, float* __restrict__ ws,
            int* __restrict__ counters, int M, int N, int K, int kt_split,
            int act) {
  using S = TileShape<BM, SW>;
  extern __shared__ unsigned char tg_smem[];
  unsigned char* smem = align1024(tg_smem);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + S::STAGES * S::STAGE);
  uint64_t* empty = full + S::STAGES;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int n0 = blockIdx.x * S::OUTW, m0 = blockIdx.y * BM;
  const int KT = (K + TG_BK - 1) / TG_BK;
  const int kt0 = blockIdx.z * kt_split, nk = min(KT - kt0, kt_split);
  const int nsplit = gridDim.z;

  if (tid == 0) {
    for (int s = 0; s < S::STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], S::NC * 4);  // lane 0 of each consumer warp
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (warp == S::NC * 4) {  // producer
    if (lane == 0) {
      for (int i = 0; i < nk; ++i) {
        const int s = i % S::STAGES;
        mbar_wait(&empty[s], ((i / S::STAGES) & 1) ^ 1);
        unsigned char* st = smem + s * S::STAGE;
        const int k = (kt0 + i) * TG_BK;
        mbar_expect_tx(&full[s], S::STAGE);
        tma_load_2d(st, &tx, k, m0, &full[s]);
#pragma unroll
        for (int q = 0; q < S::NBOX; ++q) {
          const bool second = SW != 0 && q >= S::NBOX / 2;  // wi's boxes
          const int col = n0 + 64 * (SW == 0 ? q : q % (S::NBOX / 2));
          tma_load_2d(st + S::A_BYTES + q * TG_B_BOX, second ? &tw1 : &tw,
                      col, k, &full[s]);
        }
      }
    }
    return;
  }

  // consumer warpgroup wg: rows m0 + 64 wg .. + 63
  const int wg = warp / 4;
  float acc[S::NACC];
#pragma unroll
  for (int i = 0; i < S::NACC; ++i) acc[i] = 0.0f;
  for (int i = 0; i < nk; ++i) {
    const int s = i % S::STAGES;
    mbar_wait(&full[s], (i / S::STAGES) & 1);
    const unsigned char* a = smem + s * S::STAGE + wg * 64 * 128;
    const unsigned char* b = smem + s * S::STAGE + S::A_BYTES;
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < TG_BK / 16; ++kk)
#pragma unroll
      for (int h = 0; h < S::NACC / 64; ++h)
        wgmma_ss_n128<1>(*reinterpret_cast<float(*)[64]>(acc + 64 * h),
                         wgmma_desc(a + kk * 32, 16, 1024),
                         wgmma_desc(b + 2 * h * TG_B_BOX + kk * 16 * 128,
                                    TG_B_BOX, 1024));
    wgmma_commit();
    fence_regs(acc);
    if (i > 0) {  // the previous step's products are done: free its stage
      wgmma_wait<1>();
      fence_regs(acc);
      if (lane == 0) mbar_arrive(&empty[(i - 1) % S::STAGES]);
    }
  }
  wgmma_wait<0>();
  fence_regs(acc);

  // The epilogue runs once a block: the accumulators go through the idle
  // ring (fp32, padded rows) so that one short loop, not 32 unrolled
  // copies of it, applies bias -> act -> residual (or silu(g) * h) with
  // 8-byte stores along each row.  Every load of the ring has landed and
  // been used.
  const int nthreads = S::NC * 128;
  bar_sync(1, nthreads);  // both warpgroups are done with the ring
  float* Cs = reinterpret_cast<float*>(smem);
  const int r0 = wg * 64 + (warp % 4) * 16 + lane / 4;
#pragma unroll
  for (int j = 0; j < S::NACC / 4; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      *reinterpret_cast<float2*>(Cs + (r0 + 8 * h) * S::C_LD + 8 * j +
                                 2 * (lane % 4)) =
          make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
  bar_sync(1, nthreads);
  int* counter = counters + blockIdx.y * gridDim.x + blockIdx.x;
  if constexpr (SW != 0) {
    // g in staged columns [0, OUTW), h in [OUTW, 2 OUTW)
    float* part = ws + (size_t)blockIdx.z * M * 2 * N;
#pragma unroll 1
    for (int i = tid; i < BM * S::OUTW / 4; i += nthreads) {
      const int r = i / (S::OUTW / 4), c = 4 * (i % (S::OUTW / 4));
      const int m = m0 + r, n = n0 + c;
      if (m >= M || n >= N) continue;  // N % 8 == 0: n + 3 < N
      const float4 g = *reinterpret_cast<const float4*>(Cs + r * S::C_LD + c);
      const float4 h =
          *reinterpret_cast<const float4*>(Cs + r * S::C_LD + S::OUTW + c);
      if (nsplit == 1) {
        swiglu_pair(out, m, n, N, g.x, g.y, h.x, h.y);
        swiglu_pair(out, m, n + 2, N, g.z, g.w, h.z, h.w);
      } else {
        float* pr = part + (size_t)m * 2 * N + n;
        *reinterpret_cast<float4*>(pr) = g;
        *reinterpret_cast<float4*>(pr + N) = h;
      }
    }
    if (nsplit == 1) return;
    if (!last_split(counter, nsplit, nthreads)) return;
    finish_swiglu_tile(ws, counter, nsplit, M, N, m0, BM, n0, S::OUTW, out,
                       tid, nthreads);
  } else {
    float* part = ws + (size_t)blockIdx.z * M * N;
#pragma unroll 1
    for (int i = tid; i < BM * TG_BN / 4; i += nthreads) {
      const int r = i / (TG_BN / 4), c = 4 * (i % (TG_BN / 4));
      const int m = m0 + r, n = n0 + c;
      if (m >= M || n >= N) continue;  // N % 8 == 0: n + 3 < N
      const float4 v = *reinterpret_cast<const float4*>(Cs + r * S::C_LD + c);
      if (nsplit == 1) {
        epilogue_pair(bias, res, out, m, n, N, v.x, v.y, act);
        epilogue_pair(bias, res, out, m, n + 2, N, v.z, v.w, act);
      } else {
        *reinterpret_cast<float4*>(part + (size_t)m * N + n) = v;
      }
    }
    if (nsplit == 1) return;
    if (!last_split(counter, nsplit, nthreads)) return;
    finish_tile(ws, counter, nsplit, M, N, m0, BM, n0, TG_BN, bias, res, out,
                act, tid, nthreads);
  }
}

template <int BM, int SW>
int tile_launch(const void* x, const void* w, const void* w1,
                const void* bias, const void* res, void* out, void* ws,
                void* counters, int M, int N, int K, int nsplit, int kt_split,
                int act, void* stream) {
  using S = TileShape<BM, SW>;
  CUtensorMap tx, tw, tw1;
  int e = encode_rows(&tx, x, M, K, BM);
  if (e != 0) return e;
  e = encode_rows(&tw, w, K, N, TG_BK);
  if (e != 0) return e;
  if (SW != 0) {
    e = encode_rows(&tw1, w1, K, N, TG_BK);
    if (e != 0) return e;
  } else {
    tw1 = tw;
  }
  e = smem_limit_once<tile_kernel<BM, SW>>(S::SMEM);
  if (e != 0) return e;
  const dim3 grid((N + S::OUTW - 1) / S::OUTW, (M + BM - 1) / BM, nsplit);
  tile_kernel<BM, SW><<<grid, S::THREADS, S::SMEM, (cudaStream_t)stream>>>(
      tx, tw, tw1, (const bf16*)bias, (const bf16*)res, (bf16*)out,
      (float*)ws, (int*)counters, M, N, K, kt_split, act);
  return (int)cudaGetLastError();
}

// The plan's checks shared by the two variants' entries: K in nsplit
// slices of `depth` units (rows or 64-deep steps), none of them empty.
inline bool bad_split(int units, int nsplit, int depth) {
  return nsplit < 1 || depth < 1 || (long)nsplit * depth < units ||
         (long)(nsplit - 1) * depth >= units;
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

// The bf16 split-K variant (kernels/vwr_matmul.py splitk_plan): M rows in
// tiles of mt (1, 2, 4 or 8), nsplit slices of ksplit rows of K
// (nsplit * ksplit >= K > (nsplit - 1) * ksplit); ws: nsplit x M x N fp32
// (unused when nsplit is 1); counters: one int32 of 0 per (M tile, strip),
// left at 0.  N % 8 == 0; pointers 16-byte aligned.
extern "C" int vwr_matmul_splitk_launch(const void* x, const void* w,
                                        const void* bias, const void* res,
                                        void* out, void* ws, void* counters,
                                        int M, int N, int K, int mt,
                                        int nsplit, int ksplit, int act,
                                        void* stream) {
  if (act < ACT_NONE || act > ACT_GELU || N % 8 != 0 ||
      bad_split(K, nsplit, ksplit))
    return (int)cudaErrorInvalidValue;
  if (M <= 0 || N <= 0) return 0;
  switch (mt) {
    case 1: return splitk_launch<1>(x, w, bias, res, out, ws, counters, M, N,
                                    K, nsplit, ksplit, act, stream);
    case 2: return splitk_launch<2>(x, w, bias, res, out, ws, counters, M, N,
                                    K, nsplit, ksplit, act, stream);
    case 4: return splitk_launch<4>(x, w, bias, res, out, ws, counters, M, N,
                                    K, nsplit, ksplit, act, stream);
    case 8: return splitk_launch<8>(x, w, bias, res, out, ws, counters, M, N,
                                    K, nsplit, ksplit, act, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The bf16 wgmma variant (kernels/vwr_matmul.py tile_plan): BM 64 or 128,
// K in nsplit slices of kt_split 64-deep steps; ws: nsplit x M x N fp32
// (unused when nsplit is 1); counters: one int32 of 0 per output tile,
// left at 0.  K % 8 == 0, N % 8 == 0 (TMA's 16-byte rows); pointers
// 16-byte aligned.
extern "C" int vwr_matmul_tile_launch(const void* x, const void* w,
                                      const void* bias, const void* res,
                                      void* out, void* ws, void* counters,
                                      int M, int N, int K, int bm,
                                      int nsplit, int kt_split, int act,
                                      void* stream) {
  const int KT = (K + TG_BK - 1) / TG_BK;
  if (act < ACT_NONE || act > ACT_GELU || K % 8 != 0 || N % 8 != 0 ||
      K <= 0 || bad_split(KT, nsplit, kt_split))
    return (int)cudaErrorInvalidValue;
  if (M <= 0 || N <= 0) return 0;
  if (bm == 64)
    return tile_launch<64, 0>(x, w, nullptr, bias, res, out, ws, counters, M,
                              N, K, nsplit, kt_split, act, stream);
  if (bm == 128)
    return tile_launch<128, 0>(x, w, nullptr, bias, res, out, ws, counters,
                               M, N, K, nsplit, kt_split, act, stream);
  return (int)cudaErrorInvalidValue;
}

// vwr_swiglu's wgmma variant (kernels/vwr_matmul.py swiglu_tile_plan): the
// arguments of vwr_matmul_tile_launch with wg and wi for w; bn, the output
// columns a strip, 64 (boxes of wg and wi side by side in one n128
// product) or 128 (two n128 products); ws: nsplit x M x 2N fp32.
extern "C" int vwr_swiglu_tile_launch(const void* x, const void* wg,
                                      const void* wi, void* out, void* ws,
                                      void* counters, int M, int N, int K,
                                      int bm, int bn, int nsplit,
                                      int kt_split, void* stream) {
  const int KT = (K + TG_BK - 1) / TG_BK;
  if (K % 8 != 0 || N % 8 != 0 || K <= 0 || bad_split(KT, nsplit, kt_split))
    return (int)cudaErrorInvalidValue;
  if (M <= 0 || N <= 0) return 0;
#define SWIGLU_TILE(BM_, SW_)                                                 \
  if (bm == BM_ && bn == 64 * SW_)                                            \
    return tile_launch<BM_, SW_>(x, wg, wi, nullptr, nullptr, out, ws,        \
                                 counters, M, N, K, nsplit, kt_split,         \
                                 ACT_NONE, stream);
  SWIGLU_TILE(64, 1)
  SWIGLU_TILE(128, 1)
  SWIGLU_TILE(64, 2)
  SWIGLU_TILE(128, 2)
#undef SWIGLU_TILE
  return (int)cudaErrorInvalidValue;
}

// Host nanoseconds a call of the wgmma variant spends encoding its tensor
// maps (the mean over `reps` encodings of x (M, K) and `nw` maps of w (K,
// N): 1 for vwr_matmul, 2 for vwr_swiglu's wg and wi); negative on an
// encoding error.  A measurement entry: no kernel runs.
extern "C" double vwr_matmul_encode_ns(const void* x, const void* w, int M,
                                       int N, int K, int bm, int nw,
                                       int reps) {
  CUtensorMap tx, tw;
  // the first encoding (the entry point's lookup) stays outside the mean
  if (encode_rows(&tx, x, M, K, bm) != 0) return -1.0;
  const auto t0 = std::chrono::steady_clock::now();
  for (int i = 0; i < reps; ++i) {
    if (encode_rows(&tx, x, M, K, bm) != 0) return -1.0;
    for (int j = 0; j < nw; ++j)
      if (encode_rows(&tw, w, K, N, TG_BK) != 0) return -1.0;
  }
  const auto t1 = std::chrono::steady_clock::now();
  return std::chrono::duration<double, std::nano>(t1 - t0).count() / reps;
}
