// Direct (im2col-free) NHWC conv2d with a fused bias + activation
// epilogue, for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/vwr_conv2d.py :: vwr_conv2d_p
//           (act(conv2d(x, w) + bias), stride 1, VALID).
//
// Contract: x (N, H, W, C), w (KH, KW, C, F), bias (F,) or null; out
// (N, H-KH+1, W-KW+1, F) in x's type.  Every tap's products are summed in
// fp32; the epilogue (bias, then relu / silu / gelu-tanh) runs on the
// fp32 sum before the one cast and store.
//
// What bounds it on an H100: an implicit GEMM with M = N * H_out * W_out
// output pixels, N = F and a reduction of KH * KW * C.  At the paper's
// ResNet / AlexNet layers it does 2 * KH * KW * C flops per output and
// reads each input and weight once, ~100-1000 flops a byte: in bf16 near
// the 295 flop/byte ridge (RN_56x56 at N 32: 7.4 GFLOP against 26.7 MB),
// in fp32 (no tensor cores, no TF32) well above it, so bound by operations.
//
// Design.  The TPU kernel stages whole halo'd rows (bh + KH - 1, W, C) and
// a (KH, KW, C, bf) weight block in VMEM; at the suite's widths that is
// more than a block's 227 KB of shared memory (RN_7x7's weight block alone
// is 1.18 MB in bf16).  Here a block owns a TH x TW = 4 x 16 tile of
// output pixels of one image and a BN = 64 tile of filters, and walks C in
// chunks of CK channels (32 bf16, 16 fp32).  For each chunk it stages the
// halo'd input tile (TH + KH - 1) x (TW + KW - 1) x CK in shared memory
// once (the paper's wide transaction: no im2col, no input re-read per
// tap) and reads it KH * KW times shifted, one tap at a time, against that
// tap's (CK, BN) weight slice (fetched into registers during the previous
// tap's products, then stored to shared memory).  Accumulators stay in
// registers across all chunks and taps: bf16 tiles go through WMMA
// 16x16x16 (tensor cores, fp32 accumulate; an A fragment is one output
// row's 16 pixels, read straight out of the halo tile with the pixel
// stride as its leading dimension), fp32 tiles through fp32 FMAs.  The
// epilogue stages the fp32 sums in shared memory and stores each output
// once, coalesced along F.  Ragged C, F, H_out and W_out are masked (zeros
// staged past each edge, nothing stored past the output), so no padding
// pass is made; 16-byte loads are taken only where C (input) or F
// (weights) is a multiple of 8.  wgmma / TMA tiles are later work.
#include <mma.h>

#include "common.cuh"

using namespace nvcuda;

namespace {

constexpr int TH = 4, TW = 16, BN = 64, THREADS = 128;
constexpr int TM = TH * TW;  // output pixels a block
constexpr int C_LD = BN + 4;  // fp32 accumulator staging for the epilogue

template <typename T>
struct Tile;
// bf16: a pixel's CK channels padded to 48 elements (96 bytes), so every
// shifted WMMA A fragment starts 32-byte aligned
template <>
struct Tile<__nv_bfloat16> {
  static constexpr int CK = 32, LDC = 48, W_LD = BN + 8;
};
template <>
struct Tile<float> {
  static constexpr int CK = 16, LDC = CK + 1, W_LD = BN + 4;
};

struct ConvArgs {
  const void *x, *w, *bias;
  void* out;
  int N, H, W, C, KH, KW, F, Ho, Wo, tiles_w, act;
};

__host__ __device__ inline int halo_bytes(int HR, int HWW, int ldc, int elt) {
  return (HR * HWW * ldc * elt + 127) / 128 * 128;
}

// ---- staging ----

// The halo'd input tile of channels c0 .. c0+CK-1, zeros past each edge.
template <typename T>
__device__ void stage_halo(const ConvArgs& a, T* Hs, int n, int oh0,
                           int ow0, int c0, int HR, int HWW) {
  constexpr int CK = Tile<T>::CK, LDC = Tile<T>::LDC;
  const T* x = static_cast<const T*>(a.x);
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    const bool vec = a.C % 8 == 0;
    for (int e = threadIdx.x; e < HR * HWW * (CK / 8); e += THREADS) {
      const int q = e % (CK / 8), pix = e / (CK / 8);
      const int ih = oh0 + pix / HWW, iw = ow0 + pix % HWW;
      const bool in = ih < a.H && iw < a.W;
      const __nv_bfloat16* row =
          x + (((size_t)n * a.H + (in ? ih : 0)) * a.W + (in ? iw : 0)) * a.C;
      *reinterpret_cast<uint4*>(Hs + pix * LDC + q * 8) =
          chunk8(row, in ? 0 : 1, c0 + q * 8, 1, a.C, vec);
    }
  } else {
    for (int e = threadIdx.x; e < HR * HWW * CK; e += THREADS) {
      const int q = e % CK, pix = e / CK;
      const int ih = oh0 + pix / HWW, iw = ow0 + pix % HWW, c = c0 + q;
      Hs[pix * LDC + q] =
          (ih < a.H && iw < a.W && c < a.C)
              ? x[(((size_t)n * a.H + ih) * a.W + iw) * a.C + c]
              : 0.0f;
    }
  }
}

// One tap's (CK, BN) weight slice, in registers until it is stored.
template <typename T>
struct WTile;
template <>
struct WTile<__nv_bfloat16> {
  uint4 v[2];  // 32 rows x 8 chunks of 8 = 256 chunks, 2 a thread
  __device__ void fetch(const ConvArgs& a, int tap, int c0, int f0) {
    const __nv_bfloat16* w =
        static_cast<const __nv_bfloat16*>(a.w) + (size_t)tap * a.C * a.F;
    const bool vec = a.F % 8 == 0;
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const int id = threadIdx.x + k * THREADS;
      v[k] = chunk8(w, c0 + (id >> 3), f0 + (id & 7) * 8, a.C, a.F, vec);
    }
  }
  __device__ void store(__nv_bfloat16* Ws) const {
    constexpr int LD = Tile<__nv_bfloat16>::W_LD;
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const int id = threadIdx.x + k * THREADS;
      *reinterpret_cast<uint4*>(Ws + (id >> 3) * LD + (id & 7) * 8) = v[k];
    }
  }
};
template <>
struct WTile<float> {
  float v[8];  // 16 rows x 64 = 1024, 8 a thread
  __device__ void fetch(const ConvArgs& a, int tap, int c0, int f0) {
    const float* w = static_cast<const float*>(a.w) + (size_t)tap * a.C * a.F;
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const int id = threadIdx.x + k * THREADS;
      const int c = c0 + (id >> 6), f = f0 + (id & 63);
      v[k] = (c < a.C && f < a.F) ? w[(size_t)c * a.F + f] : 0.0f;
    }
  }
  __device__ void store(float* Ws) const {
    constexpr int LD = Tile<float>::W_LD;
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const int id = threadIdx.x + k * THREADS;
      Ws[(id >> 6) * LD + (id & 63)] = v[k];
    }
  }
};

// ---- products of one tap over the staged chunk ----

struct AccH {
  // 4 warps as 2 x 2: warp (wm, wn) takes output rows 2 wm + i (16 pixels
  // each) against filters 32 wn + 16 j
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
  __device__ void zero() {
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.0f);
  }
  __device__ void tap(const __nv_bfloat16* Hs, const __nv_bfloat16* Ws,
                      int kj, int ki, int HWW) {
    constexpr int LDC = Tile<__nv_bfloat16>::LDC;
    constexpr int LD = Tile<__nv_bfloat16>::W_LD;
    const int warp = threadIdx.x / 32, wm = warp / 2, wn = warp % 2;
#pragma unroll
    for (int kk = 0; kk < Tile<__nv_bfloat16>::CK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major> fa[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(
            fa[i], Hs + ((wm * 2 + i + kj) * HWW + ki) * LDC + kk, LDC);
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                       wmma::row_major> fb;
        wmma::load_matrix_sync(fb, Ws + kk * LD + wn * 32 + j * 16, LD);
#pragma unroll
        for (int i = 0; i < 2; ++i)
          wmma::mma_sync(acc[i][j], fa[i], fb, acc[i][j]);
      }
    }
  }
  __device__ void spill(float* Cs) const {
    const int warp = threadIdx.x / 32, wm = warp / 2, wn = warp % 2;
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::store_matrix_sync(
            Cs + (wm * 2 + i) * 16 * C_LD + wn * 32 + j * 16, acc[i][j],
            C_LD, wmma::mem_row_major);
  }
};

struct AccF {
  // thread (ty, tx): pixels 4 ty + i (one output row, 4 columns) against
  // filters tx + 8 j
  float acc[4][8];
  __device__ void zero() {
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;
  }
  __device__ void tap(const float* Hs, const float* Ws, int kj, int ki,
                      int HWW) {
    constexpr int LDC = Tile<float>::LDC, LD = Tile<float>::W_LD;
    const int ty = threadIdx.x / 8, tx = threadIdx.x % 8;
    const int r = ty / (TW / 4), c = (ty % (TW / 4)) * 4;
    const float* h = Hs + ((r + kj) * HWW + c + ki) * LDC;
#pragma unroll 4
    for (int cc = 0; cc < Tile<float>::CK; ++cc) {
      float av[4], bv[8];
#pragma unroll
      for (int i = 0; i < 4; ++i) av[i] = h[i * LDC + cc];
#pragma unroll
      for (int j = 0; j < 8; ++j) bv[j] = Ws[cc * LD + tx + 8 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
  }
  __device__ void spill(float* Cs) const {
    const int ty = threadIdx.x / 8, tx = threadIdx.x % 8;
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) Cs[(ty * 4 + i) * C_LD + tx + 8 * j] = acc[i][j];
  }
};

template <typename T>
__global__ void __launch_bounds__(THREADS) conv_kernel(const ConvArgs a) {
  using Acc = typename std::conditional<std::is_same<T, float>::value, AccF,
                                        AccH>::type;
  constexpr int CK = Tile<T>::CK;
  extern __shared__ __align__(128) unsigned char smem[];
  const int HR = TH + a.KH - 1, HWW = TW + a.KW - 1;
  T* Hs = reinterpret_cast<T*>(smem);
  T* Ws = reinterpret_cast<T*>(
      smem + halo_bytes(HR, HWW, Tile<T>::LDC, (int)sizeof(T)));
  const int n = blockIdx.z, f0 = blockIdx.y * BN;
  const int oh0 = (blockIdx.x / a.tiles_w) * TH;
  const int ow0 = (blockIdx.x % a.tiles_w) * TW;
  const int taps = a.KH * a.KW;

  Acc acc;
  acc.zero();
  WTile<T> wt;
  wt.fetch(a, 0, 0, f0);
  for (int c0 = 0; c0 < a.C; c0 += CK) {
    for (int tap = 0; tap < taps; ++tap) {
      __syncthreads();  // every read of the previous tap's tiles is done
      if (tap == 0) stage_halo<T>(a, Hs, n, oh0, ow0, c0, HR, HWW);
      wt.store(Ws);
      __syncthreads();
      int nt = tap + 1, nc = c0;
      if (nt == taps) {
        nt = 0;
        nc += CK;
      }
      if (nc < a.C) wt.fetch(a, nt, nc, f0);
      acc.tap(Hs, Ws, tap / a.KW, tap % a.KW, HWW);
    }
  }
  __syncthreads();
  float* Cs = reinterpret_cast<float*>(smem);
  acc.spill(Cs);
  __syncthreads();

  const T* bias = static_cast<const T*>(a.bias);
  T* out = static_cast<T*>(a.out);
  for (int idx = threadIdx.x; idx < TM * BN; idx += THREADS) {
    const int p = idx / BN, f = f0 + idx % BN;
    const int oh = oh0 + p / TW, ow = ow0 + p % TW;
    if (oh >= a.Ho || ow >= a.Wo || f >= a.F) continue;
    float v = Cs[p * C_LD + idx % BN];
    if (bias != nullptr) v += to_f32(bias[f]);
    v = activate(v, a.act);
    out[(((size_t)n * a.Ho + oh) * a.Wo + ow) * a.F + f] = from_f32<T>(v);
  }
}

template <typename T>
int launch(ConvArgs a, cudaStream_t stream) {
  if (a.N <= 0 || a.Ho <= 0 || a.Wo <= 0 || a.F <= 0) return 0;
  const int HR = TH + a.KH - 1, HWW = TW + a.KW - 1;
  const int tiles = halo_bytes(HR, HWW, Tile<T>::LDC, (int)sizeof(T)) +
                    Tile<T>::CK * Tile<T>::W_LD * (int)sizeof(T);
  const int acc_bytes = TM * C_LD * (int)sizeof(float);
  const int bytes = tiles > acc_bytes ? tiles : acc_bytes;
  if (bytes > 232448) return (int)cudaErrorInvalidValue;
  if (bytes > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        conv_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (e != cudaSuccess) return (int)e;
  }
  const int tiles_h = (a.Ho + TH - 1) / TH;
  a.tiles_w = (a.Wo + TW - 1) / TW;
  const dim3 grid(tiles_h * a.tiles_w, (a.F + BN - 1) / BN, a.N);
  conv_kernel<T><<<grid, THREADS, bytes, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// out (N, H-KH+1, W-KW+1, F) = act(conv2d(x (N, H, W, C), w (KH, KW, C, F))
// + bias (F,)), stride 1, VALID; bias may be null; act a common.cuh Act.
// All contiguous and 16-byte aligned.
extern "C" int vwr_conv2d_launch(const void* x, const void* w,
                                 const void* bias, void* out, int N, int H,
                                 int W, int C, int KH, int KW, int F,
                                 int dtype, int act, void* stream) {
  if (act < ACT_NONE || act > ACT_GELU || C <= 0 || KH <= 0 || KW <= 0)
    return (int)cudaErrorInvalidValue;
  const ConvArgs a{x, w, bias, out, N, H, W, C, KH, KW, F,
                   H - KH + 1, W - KW + 1, 0, act};
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == REPRO_BF16) return launch<__nv_bfloat16>(a, s);
  if (dtype == REPRO_F32) return launch<float>(a, s);
  return (int)cudaErrorInvalidValue;
}
