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
// Two kernels (kernels/vwr_depthwise.py dw_variant picks one per call).
//
// 3 x 3 taps, C a multiple of 8 (dw_stream; "stream": every depthwise
// layer of the paper's suite): row-streamed strips sized to the layer.
//   Blocks.  A block owns one image, a block of cb channels (8-64, taken
//   from C: 32 at MN_112x112, so no thread computes padding), a strip of
//   sh output rows and a column tile of tw output columns (the whole
//   width where tw * cb / 8 <= 256 threads, else balanced tiles with
//   their 2 halo columns); kernels/vwr_depthwise.py dw_plan sizes them
//   from the shape alone, for one wave of ~2 blocks an SM (N 32: strips of
//   28 rows; N 1: cb 8 and strips of 2-4 rows).
//   Rows.  The strip's sh + 2 input rows stream through a ring of 10 rows
//   in shared memory by cp.async 16-byte copies, one commit group a row,
//   9 rows in flight: each input row is read from memory once a strip,
//   (sh + 2) / sh times in all and never again in W (the halo tile read
//   1.41x), and the loads overlap the FMAs.
//   Arithmetic.  A thread owns 8 channels of one output column: their 9
//   fp32 tap weights in registers, and three fp32 accumulators of 8 (a
//   ring indexed by row mod 3).  Input row r adds tap row kj = 0, 1, 2 to
//   output rows r, r - 1, r - 2; output row r - 2 is then complete, cast
//   once and stored.  Each output sums its 9 products in fp32 FMAs in the
//   (kj, ki) order of the halo-tile kernel, so bf16 outputs equal the
//   plain version's and fp32 ones lie within ~1e-6 of it.
//
// Other taps or C off 8 (dw_kernel; "tile"): the halo tile.  The TPU
// kernel stages a halo'd row block (bh + KH - 1, W, C) with every channel
// in VMEM: ~330 KB for MN_7x7 in fp32, more than a block's shared memory.
// Here a block owns a TH x TW = 8 x 16 tile of output pixels of one image
// and CB = 64 channels (grid (tiles, C / 64, N)).  It stages the halo'd
// input tile (TH + KH - 1) x (TW + KW - 1) x CB in shared memory once,
// 16-byte loads where C is a multiple of 8, and the tap weights as fp32.
// A thread owns 8 channels of one output column and 4 output rows, and
// runs the KH * KW multiply-adds of each in fp32 FMAs out of the staged
// tile; the output is stored once.  Ragged C, H_out and W_out are masked.
//
// Known limits: the stream kernel reaches ~1.2x a plain copy of the same
// bytes (MN_56x56 N32 bf16: 0.032 ms against a 0.027 ms device copy,
// 0.93x cuDNN; PERF.md); at N 1 a launch sets the time.  1 x 1, 5 x 5 and
// 7 x 7 taps (no suite layer) and ragged C keep the halo tile, whose
// tile fits only MN_56x56-like widths.
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

// ---- row-streamed strips ("stream"): 3x3 taps, C a multiple of 8 ----

constexpr int DS_K = 3;             // the taps a side (KH = KW = 3)
constexpr int DS_RING = 10;         // input rows in shared memory
constexpr int DS_MAX_THREADS = 256;

struct DsArgs {
  const void *x, *w;
  void* out;
  int N, H, W, C, Ho, Wo;
  int cb, sh, tw, tiles_w;  // the plan: channels, output rows, columns
};

// Bytes of one ring slot: (tw + 2) pixels of cb channels, 16-byte rows.
__host__ __device__ inline int ds_slot_bytes(int tw, int cb, int elt) {
  return ((tw + DS_K - 1) * cb * elt + 15) / 16 * 16;
}

// Eight channels of one staged pixel as fp32: one 16-byte shared load for
// bf16; two for fp32, the lanes of each quarter warp taking the halves in
// an order that puts its eight first loads on 32 distinct banks.
__device__ __forceinline__ void ds_load8(const __nv_bfloat16* p, float* v,
                                         int) {
  load8(p, v);
}
__device__ __forceinline__ void ds_load8(const float* p, float* v,
                                         int lane) {
  const bool h = (lane >> 2) & 1;
  const float4 a = *reinterpret_cast<const float4*>(p + (h ? 4 : 0));
  const float4 b = *reinterpret_cast<const float4*>(p + (h ? 0 : 4));
  const float4 lo = h ? b : a, hi = h ? a : b;  // no dynamic indexing
  v[0] = lo.x;
  v[1] = lo.y;
  v[2] = lo.z;
  v[3] = lo.w;
  v[4] = hi.x;
  v[5] = hi.y;
  v[6] = hi.z;
  v[7] = hi.w;
}

// grid (strips * tiles_w, ceil(C / cb), N): block (s * tiles_w + t, cbk,
// n) computes output rows [s sh, + sh) x columns [t tw, + tw) x channels
// [cbk cb, + cb) of image n.  Thread (col, cv) = (tid / (cb / 8), tid %
// (cb / 8)) owns 8 channels of one output column and walks down the
// strip: input row ri adds its three taps kj = 0, 1, 2 to output rows ri,
// ri - 1, ri - 2 (three fp32 accumulators of 8 channels, a ring indexed
// by row mod 3), and output row ri - 2 is then complete and stored.  Each
// output thus sums its nine products in the (kj, ki) order of the tile
// kernel and the plain version.
template <typename T>
__global__ void __launch_bounds__(DS_MAX_THREADS, 2)
dw_stream(const DsArgs a) {
  extern __shared__ __align__(128) unsigned char ds_smem[];
  constexpr int ELT = (int)sizeof(T);
  constexpr int CH = 16 / ELT;  // channels a 16-byte copy
  const int tid = threadIdx.x, lane = tid % 32;
  const int CV = a.cb / 8;
  const int s = blockIdx.x / a.tiles_w, t = blockIdx.x % a.tiles_w;
  const int n = blockIdx.z, c0 = blockIdx.y * a.cb;
  const int r0 = s * a.sh, w0 = t * a.tw;
  const int n_out = min(a.sh, a.Ho - r0), n_in = n_out + DS_K - 1;
  const int n_col = min(a.tw, a.Wo - w0), in_cols = n_col + DS_K - 1;
  const int ncb = min(a.cb, a.C - c0);
  const int slot = ds_slot_bytes(a.tw, a.cb, ELT);
  const int cv = tid % CV, col = tid / CV;
  const bool active = col < n_col && cv * 8 < ncb;
  const T* x = static_cast<const T*>(a.x);

  // input row ri of the strip into ring slot ri % DS_RING: the in_cols
  // pixels' ncb channels, 16 bytes a copy (the rest is never read)
  const int px_chunks = ncb / CH;
  auto fetch = [&](int ri) {
    const T* src =
        x + (((size_t)n * a.H + r0 + ri) * a.W + w0) * a.C + c0;
    unsigned char* dst = ds_smem + (ri % DS_RING) * slot;
    for (int e = tid; e < in_cols * px_chunks; e += blockDim.x) {
      const int px = e / px_chunks, c = (e % px_chunks) * CH;
      cp_async16(dst + (px * a.cb + c) * ELT, src + (size_t)px * a.C + c,
                 true);
    }
  };
#pragma unroll
  for (int i = 0; i < DS_RING - 1; ++i) {
    if (i < n_in) fetch(i);
    cp_async_commit();
  }

  // this thread's 8 channels' nine tap weights, in fp32 registers
  float wr[DS_K * DS_K][8];
  const T* w = static_cast<const T*>(a.w);
#pragma unroll
  for (int tap = 0; tap < DS_K * DS_K; ++tap)
#pragma unroll
    for (int e = 0; e < 8; ++e)
      wr[tap][e] = active ? to_f32(w[(size_t)tap * a.C + c0 + cv * 8 + e])
                          : 0.0f;
  float acc[DS_K][8];
#pragma unroll
  for (int r = 0; r < DS_K; ++r)
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[r][e] = 0.0f;

  T* out = static_cast<T*>(a.out) +
           (((size_t)n * a.Ho + r0) * a.Wo + w0 + col) * a.C + c0 + cv * 8;
  const size_t out_row = (size_t)a.Wo * a.C;
  for (int base = 0; base < n_in; base += DS_K) {
#pragma unroll
    for (int u = 0; u < DS_K; ++u) {
      const int ri = base + u;  // ri % DS_K == u
      if (ri >= n_in) break;
      // row ri has landed; every thread is done with row ri - 1, whose
      // slot row ri + DS_RING - 1 takes
      cp_async_wait<DS_RING - 2>();
      __syncthreads();
      if (ri + DS_RING - 1 < n_in) fetch(ri + DS_RING - 1);
      cp_async_commit();
      if (!active) continue;
      const T* rowp = reinterpret_cast<const T*>(
                          ds_smem + (ri % DS_RING) * slot) +
                      col * a.cb + cv * 8;
#pragma unroll
      for (int ki = 0; ki < DS_K; ++ki) {
        float xv[8];
        ds_load8(rowp + ki * a.cb, xv, lane);
#pragma unroll
        for (int kj = 0; kj < DS_K; ++kj) {
          const int o = ri - kj;  // the output row this tap feeds
          if (o < 0 || o >= n_out) continue;
#pragma unroll
          for (int e = 0; e < 8; ++e)
            acc[(u - kj + DS_K) % DS_K][e] =
                fmaf(xv[e], wr[kj * DS_K + ki][e],
                     acc[(u - kj + DS_K) % DS_K][e]);
        }
      }
      if (ri >= DS_K - 1) {  // output row ri - 2 is complete
        store8(out + (size_t)(ri - DS_K + 1) * out_row, acc[(u + 1) % DS_K],
               8, true);
#pragma unroll
        for (int e = 0; e < 8; ++e) acc[(u + 1) % DS_K][e] = 0.0f;
      }
    }
  }
  cp_async_wait<0>();
}

template <typename T>
int launch_stream(DsArgs a, cudaStream_t stream) {
  if (a.N <= 0 || a.Ho <= 0 || a.Wo <= 0) return 0;
  const int threads = (a.tw * (a.cb / 8) + 31) / 32 * 32;
  const int bytes = DS_RING * ds_slot_bytes(a.tw, a.cb, (int)sizeof(T));
  if (threads > DS_MAX_THREADS || bytes > 232448)
    return (int)cudaErrorInvalidValue;
  if (bytes > 48 * 1024) {
    const int e = smem_limit_once<dw_stream<T>>(232448);
    if (e != 0) return e;
  }
  a.tiles_w = (a.Wo + a.tw - 1) / a.tw;
  const int strips = (a.Ho + a.sh - 1) / a.sh;
  const dim3 grid(strips * a.tiles_w, (a.C + a.cb - 1) / a.cb, a.N);
  dw_stream<T><<<grid, threads, bytes, stream>>>(a);
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

// The row-streamed kernel: operands as vwr_depthwise_launch, 3 x 3 taps
// (KH = KW = 3), C a multiple of 8, and the plan (kernels/vwr_depthwise.py
// dw_plan): cb channels a block (a multiple of 8, 8..64), sh output rows a
// strip, tw output columns a column tile (tw * cb / 8 threads, rounded up
// to a warp, at most 256).
extern "C" int vwr_depthwise_stream_launch(const void* x, const void* w,
                                           void* out, int N, int H, int W,
                                           int C, int KH, int KW, int cb,
                                           int sh, int tw, int dtype,
                                           void* stream) {
  if (KH != DS_K || KW != DS_K || C <= 0 || C % 8 != 0 || cb < 8 ||
      cb > 64 || cb % 8 != 0 || sh < 1 || tw < 1)
    return (int)cudaErrorInvalidValue;
  const DsArgs a{x, w, out, N, H, W, C, H - KH + 1, W - KW + 1,
                 cb, sh, tw, 0};
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == REPRO_BF16) return launch_stream<__nv_bfloat16>(a, s);
  if (dtype == REPRO_F32) return launch_stream<float>(a, s);
  return (int)cudaErrorInvalidValue;
}
