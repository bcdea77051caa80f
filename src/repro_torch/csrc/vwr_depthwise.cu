// Depthwise NHWC conv2d for Hopper (sm_90a): the paper's low-reuse case.
//
// Replaces: src/repro/kernels/vwr_depthwise.py :: vwr_depthwise_p
//           (out[n, i, j, c] = sum_{kj, ki} x[n, i+kj, j+ki, c] * w[kj, ki, c],
//           stride 1, VALID, no bias, no activation).
//
// Contract: x (N, H, W, C), w (KH, KW, C); out (N, H-KH+1, W-KW+1, C) in
// x's type, the KH * KW products of each output summed in fp32, one cast.
//
// What bounds it on an H100: 2 * KH * KW flops per output and no reduction
// across channels (not a matmul: no tensor-core work), against one read
// of each input and one write of each output: ~4-9 flops a byte, far
// below the ridge.  It is bound by memory bandwidth (MN_56x56 at N 32 in
// bf16: 53.2 MB, 0.0159 ms at 3.35 TB/s).
//
// Design.  The TPU kernel stages a halo'd row block (bh + KH - 1, W, C)
// with every channel in VMEM: ~330 KB for MN_7x7 in fp32, more than a
// block's shared memory.  Here a block owns a TH x TW = 8 x 16 tile of
// output pixels of one image and CB = 64 channels (grid (tiles, C / 64,
// N)).  It stages the halo'd input tile (TH + KH - 1) x (TW + KW - 1) x CB
// in shared memory once, 16-byte loads where C is a multiple of 8, with
// one pixel's CB channels contiguous (128 bytes in bf16, a cache line),
// and the tap weights as fp32.  A thread owns 8 channels of one output
// column and 4 output rows, and runs the KH * KW multiply-adds of each in
// fp32 FMAs out of the staged tile; the output is stored once.  Each input
// element is fetched from memory (TH + KH - 1) / TH x (TW + KW - 1) / TW
// times: 1.25 x 1.125 = 1.41x at 3 x 3 taps (the halo rows and columns
// that neighbouring tiles share), which L2 mostly absorbs; the bound above
// counts it once.  Ragged C, H_out and W_out are masked.
#include "common.cuh"

namespace {

constexpr int TH = 8, TW = 16, VL = 8, CB = VL * 8, THREADS = 256;
constexpr int ROWS = TH / (THREADS / (VL * TW));  // output rows a thread

struct DwArgs {
  const void *x, *w;
  void* out;
  int N, H, W, C, KH, KW, Ho, Wo, tiles_w;
};

__host__ __device__ inline int dw_halo_bytes(int HR, int HWW, int elt) {
  return (HR * HWW * CB * elt + 127) / 128 * 128;
}

// Eight channels c .. c+7 of one pixel's row (C channels), zeros past C.
__device__ __forceinline__ void load_px(const __nv_bfloat16* row, int c,
                                        int C, bool vec, __nv_bfloat16* dst) {
  *reinterpret_cast<uint4*>(dst) = chunk8(row, 0, c, 1, C, vec);
}
__device__ __forceinline__ void load_px(const float* row, int c, int C,
                                        bool vec, float* dst) {
  if (vec && c + 8 <= C) {
    *reinterpret_cast<float4*>(dst) = *reinterpret_cast<const float4*>(row + c);
    *reinterpret_cast<float4*>(dst + 4) =
        *reinterpret_cast<const float4*>(row + c + 4);
    return;
  }
#pragma unroll
  for (int e = 0; e < 8; ++e) dst[e] = c + e < C ? row[c + e] : 0.0f;
}

template <typename T>
__device__ __forceinline__ void store8(T* dst, const float* v, int n,
                                       bool vec) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    if (vec && n == 8) {
      uint4 raw;
      __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
      for (int i = 0; i < 4; ++i)
        h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
      *reinterpret_cast<uint4*>(dst) = raw;
      return;
    }
  } else {
    if (vec && n == 8) {
      *reinterpret_cast<float4*>(dst) = make_float4(v[0], v[1], v[2], v[3]);
      *reinterpret_cast<float4*>(dst + 4) =
          make_float4(v[4], v[5], v[6], v[7]);
      return;
    }
  }
  for (int e = 0; e < n; ++e) dst[e] = from_f32<T>(v[e]);
}

template <typename T>
__global__ void __launch_bounds__(THREADS) dw_kernel(const DwArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int HR = TH + a.KH - 1, HWW = TW + a.KW - 1;
  T* Hs = reinterpret_cast<T*>(smem);
  float* Ws = reinterpret_cast<float*>(
      smem + dw_halo_bytes(HR, HWW, (int)sizeof(T)));
  const int n = blockIdx.z, c0 = blockIdx.y * CB;
  const int oh0 = (blockIdx.x / a.tiles_w) * TH;
  const int ow0 = (blockIdx.x % a.tiles_w) * TW;
  const T* x = static_cast<const T*>(a.x);
  const T* w = static_cast<const T*>(a.w);
  const bool vec = a.C % 8 == 0;

  for (int e = threadIdx.x; e < HR * HWW * VL; e += THREADS) {
    const int v = e % VL, pix = e / VL;
    const int ih = oh0 + pix / HWW, iw = ow0 + pix % HWW;
    T* dst = Hs + pix * CB + v * 8;
    if (ih < a.H && iw < a.W) {
      load_px(x + (((size_t)n * a.H + ih) * a.W + iw) * a.C, c0 + v * 8,
              a.C, vec, dst);
    } else {
#pragma unroll
      for (int i = 0; i < 8; ++i) dst[i] = from_f32<T>(0.0f);
    }
  }
  for (int e = threadIdx.x; e < a.KH * a.KW * CB; e += THREADS) {
    const int c = c0 + e % CB, tap = e / CB;
    Ws[e] = c < a.C ? to_f32(w[(size_t)tap * a.C + c]) : 0.0f;
  }
  __syncthreads();

  const int v = threadIdx.x % VL, col = (threadIdx.x / VL) % TW;
  const int r0 = (threadIdx.x / (VL * TW)) * ROWS;
  float acc[ROWS][8];
#pragma unroll
  for (int r = 0; r < ROWS; ++r)
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[r][e] = 0.0f;
  for (int kj = 0; kj < a.KH; ++kj) {
    for (int ki = 0; ki < a.KW; ++ki) {
      float wv[8];
      const float* wp = Ws + (kj * a.KW + ki) * CB + v * 8;
#pragma unroll
      for (int e = 0; e < 8; ++e) wv[e] = wp[e];
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        float xv[8];
        load8(Hs + ((r0 + r + kj) * HWW + col + ki) * CB + v * 8, xv);
#pragma unroll
        for (int e = 0; e < 8; ++e) acc[r][e] = fmaf(xv[e], wv[e], acc[r][e]);
      }
    }
  }

  const int ow = ow0 + col, c = c0 + v * 8;
  if (ow >= a.Wo || c >= a.C) return;
  const int nc = min(8, a.C - c);
  T* out = static_cast<T*>(a.out);
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    const int oh = oh0 + r0 + r;
    if (oh >= a.Ho) break;
    store8(out + (((size_t)n * a.Ho + oh) * a.Wo + ow) * a.C + c, acc[r], nc,
           vec);
  }
}

template <typename T>
int launch(DwArgs a, cudaStream_t stream) {
  if (a.N <= 0 || a.Ho <= 0 || a.Wo <= 0) return 0;
  const int HR = TH + a.KH - 1, HWW = TW + a.KW - 1;
  const int bytes = dw_halo_bytes(HR, HWW, (int)sizeof(T)) +
                    a.KH * a.KW * CB * (int)sizeof(float);
  if (bytes > 232448) return (int)cudaErrorInvalidValue;
  if (bytes > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        dw_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (e != cudaSuccess) return (int)e;
  }
  const int tiles_h = (a.Ho + TH - 1) / TH;
  a.tiles_w = (a.Wo + TW - 1) / TW;
  const dim3 grid(tiles_h * a.tiles_w, (a.C + CB - 1) / CB, a.N);
  dw_kernel<T><<<grid, THREADS, bytes, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// out (N, H-KH+1, W-KW+1, C) = depthwise conv of x (N, H, W, C) with
// w (KH, KW, C), stride 1, VALID.  All contiguous and 16-byte aligned.
extern "C" int vwr_depthwise_launch(const void* x, const void* w, void* out,
                                    int N, int H, int W, int C, int KH,
                                    int KW, int dtype, void* stream) {
  if (C <= 0 || KH <= 0 || KW <= 0) return (int)cudaErrorInvalidValue;
  const DwArgs a{x, w, out, N, H, W, C, KH, KW, H - KH + 1, W - KW + 1, 0};
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == REPRO_BF16) return launch<__nv_bfloat16>(a, s);
  if (dtype == REPRO_F32) return launch<float>(a, s);
  return (int)cudaErrorInvalidValue;
}
