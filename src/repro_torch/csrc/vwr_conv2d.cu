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
// At N 1 the small layers are bound by their weights' bytes (RN_7x7: 4.7
// MB against 0.23 GFLOP) and by how many SMs the grid reaches.
//
// Two kernels; kernels/vwr_conv2d.py `variant` picks one per call.
//
// 1. conv_wgmma (bf16, C and F multiples of 8, 16-byte aligned operands).
//    The GEMM's rows are the output pixels flattened across images, so a
//    7x7 output wastes no tile rows and a row tile may span two images.
//    K is walked tap by tap in slices of 64 channels (128 bytes).  A block
//    owns a BM x BN tile (BM 64 or 128 pixels, BN 64 or 128 filters) and a
//    range of K steps.  A producer warpgroup fills a 4-stage ring: row m of
//    the A tile of tap (kj, ki) and slice c0 is x[n, oh+kj, ow+ki, c0:+64],
//    one 128-byte run of the NHWC input, gathered by cp.async (16 bytes a
//    thread, eight threads a row, so a warp reads four whole runs) into the
//    128-byte-swizzled K-major layout of wgmma; the weights, viewed as a
//    (KH*KW, C, F) tensor, come in as 64 x 64 TMA boxes with the same
//    swizzle and are read MN-major (the transpose bit), as kernel 1's tile
//    kernel reads w.  Rows past M and channels past C arrive as zeros (the
//    gather's zero fill; TMA's out-of-bounds fill per tap), so C 96 (64 +
//    32) needs no padding pass and the weights are not re-laid out; the
//    consumers skip the 16-deep slices past C.  Each producer thread's
//    copies arrive on the stage's mbarrier as they land
//    (cp.async.mbarrier.arrive.noinc), so the producer never waits on its
//    own loads and the whole ring is in flight (a deeper ring measured no
//    faster); a consumer fences the proxies after its wait, before wgmma
//    reads the gathered rows.
//    TMA's im2col mode (cuTensorMapEncodeIm2col) would do the gather in
//    hardware; the cp.async route was taken because it reuses the
//    swizzled staging that kernel 3 already runs on the card and needs no
//    per-tap corner arithmetic in a tensor map.  Each input row is read
//    from L2 once a tap (every suite input fits in the 50 MB L2), and from
//    device memory about once.  One or two consumer warpgroups run wgmma
//    m64nBNk16 with fp32 accumulators in registers.  Where the tiles leave
//    SMs idle (N 1; RN_7x7 at N 32), the wrapper's plan splits the K steps
//    across blocks: each stores an fp32 partial to a workspace and the last
//    block of a tile (kernel 1's int32 counter, common.cuh last_split /
//    finish_tile) adds them in split order, so a call is one launch,
//    without float atomics, and bitwise reproducible.  The epilogue stages
//    the tile in the idle ring and stores each output once, coalesced
//    along F, with every thread of the block.
// 2. conv_kernel (fp32, and bf16 shapes the first cannot take: C or F off
//    a multiple of 8).  A block owns a TH x TW = 4 x 16 tile of output
//    pixels of one image and a BN = 64 tile of filters, and walks C in
//    chunks of CK channels (32 bf16, 16 fp32).  For each chunk it stages
//    the halo'd input tile (TH + KH - 1) x (TW + KW - 1) x CK in shared
//    memory once (the paper's wide transaction: no im2col, no input re-read
//    per tap) and reads it KH * KW times shifted, one tap at a time,
//    against that tap's (CK, BN) weight slice (fetched into registers
//    during the previous tap's products, then stored to shared memory).
//    Accumulators stay in registers across all chunks and taps: bf16 tiles
//    go through WMMA 16x16x16 (fp32 accumulate; an A fragment is one output
//    row's 16 pixels, read straight out of the halo tile with the pixel
//    stride as its leading dimension), fp32 tiles through fp32 FMAs.  The
//    epilogue stages the fp32 sums in shared memory and stores each output
//    once, coalesced along F.  Ragged C, F, H_out and W_out are masked
//    (zeros staged past each edge, nothing stored past the output); 16-byte
//    loads are taken only where C (input) or F (weights) is a multiple of
//    8.
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

// ---------------------------------------------------------------------
// bf16: wgmma implicit GEMM over flattened output pixels
// ---------------------------------------------------------------------

using bf16 = __nv_bfloat16;

constexpr int STAGES = 4;
constexpr int WG_BOX = 64 * 128;  // one 64-channel x 64-filter box: 8 KB

template <int BM, int BN>
struct WgShape {
  static constexpr int NC = BM / 64;                // consumer warpgroups
  static constexpr int THREADS = (NC + 1) * 128;    // + the producer
  static constexpr int A_BYTES = BM * 128;          // BM pixels x 64 channels
  static constexpr int B_BYTES = (BN / 64) * WG_BOX;
  static constexpr int STAGE = A_BYTES + B_BYTES;
  static constexpr int C_LD = BN + 8;               // fp32 row, epilogue
  static constexpr int SMEM = 1024 + STAGES * STAGE + 2 * STAGES * 8;
  static_assert(BM * C_LD * 4 <= STAGES * STAGE,
                "the staged accumulators fit in the ring");
  static_assert(SMEM <= 232448, "fits a block's shared memory");
};

struct WgArgs {
  const bf16* x;
  const bf16* bias;
  bf16* out;
  float* ws;
  int* counters;
  int N, H, W, C, KH, KW, F, Ho, Wo, M;
  int slices;    // 64-channel slices a tap: ceil(C / 64)
  int kt_split;  // K steps a block (the last block of a tile may have fewer)
  int act;
};

template <int BN>
__device__ __forceinline__ void wgmma_tile(float (&d)[BN / 2], uint64_t da,
                                           uint64_t db) {
  if constexpr (BN == 64) wgmma_ss_n64<1>(d, da, db);
  else wgmma_ss_n128<1>(d, da, db);
}

// grid (M tiles of BM, F tiles of BN, K splits of kt_split steps); a K
// step is one tap's 64-channel slice
template <int BM, int BN>
__global__ void __launch_bounds__(WgShape<BM, BN>::THREADS)
conv_wgmma(const __grid_constant__ CUtensorMap tw, const WgArgs a) {
  using S = WgShape<BM, BN>;
  extern __shared__ unsigned char cw_smem[];
  unsigned char* smem = align1024(cw_smem);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + STAGES * S::STAGE);
  uint64_t* empty = full + STAGES;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int m0 = blockIdx.x * BM, f0 = blockIdx.y * BN;
  const int KT = a.KH * a.KW * a.slices;
  const int kt0 = blockIdx.z * a.kt_split;
  const int nk = min(KT - kt0, a.kt_split);
  const int nsplit = gridDim.z;

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      // the producer's 128 threads (as their copies land), and the
      // arrival that sets the weight boxes' transaction bytes
      mbar_init(&full[s], 128 + 1);
      mbar_init(&empty[s], S::NC * 4);  // lane 0 of each consumer warp
    }
    mbar_init_fence();
  }
  __syncthreads();

  float acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.0f;

  if (warp >= S::NC * 4) {
    // producer: thread p gathers 16-byte chunk p % 8 of rows p / 8 + 16 j
    const int p = tid - S::NC * 128, chunk = p % 8;
    constexpr int RPT = BM / 16;
    long long base[RPT];  // row's pixel (n, oh, ow) in x, or -1 past M
    const int HWo = a.Ho * a.Wo;
#pragma unroll
    for (int j = 0; j < RPT; ++j) {
      const int m = m0 + p / 8 + 16 * j;
      if (m < a.M) {
        const int n = m / HWo, rem = m % HWo;
        const int oh = rem / a.Wo, ow = rem % a.Wo;
        base[j] = (((long long)n * a.H + oh) * a.W + ow) * a.C;
      } else {
        base[j] = -1;
      }
    }
    for (int i = 0; i < nk; ++i) {
      const int s = i % STAGES;
      mbar_wait(&empty[s], ((i / STAGES) & 1) ^ 1);
      const int kt = kt0 + i, tap = kt / a.slices;
      const int c0 = (kt % a.slices) * 64;
      unsigned char* st = smem + s * S::STAGE;
      if (p == 0) {
        mbar_expect_tx(&full[s], S::B_BYTES);
#pragma unroll
        for (int b = 0; b < BN / 64; ++b)
          tma_load_3d(st + S::A_BYTES + b * WG_BOX, &tw, f0 + 64 * b, c0,
                      tap, &full[s]);
      }
      const int c = c0 + chunk * 8;
      const long long off =
          ((long long)(tap / a.KW) * a.W + tap % a.KW) * a.C + c;
#pragma unroll
      for (int j = 0; j < RPT; ++j) {
        const bool ok = base[j] >= 0 && c < a.C;
        cp_async16(st + swz128(p / 8 + 16 * j, chunk),
                   ok ? a.x + base[j] + off : a.x, ok);
      }
      cp_async_arrive(&full[s]);
    }
    cp_async_wait<0>();
  } else {
    // consumer warpgroup wg: rows m0 + 64 wg .. + 63
    const int wg = warp / 4;
    for (int i = 0; i < nk; ++i) {
      const int s = i % STAGES;
      mbar_wait(&full[s], (i / STAGES) & 1);
      fence_proxy_async();  // the gathered rows, to wgmma's async proxy
      const unsigned char* at = smem + s * S::STAGE + wg * 64 * 128;
      const unsigned char* bt = smem + s * S::STAGE + S::A_BYTES;
      // the 16-deep slices that hold channels (C 96: two in the last)
      const int depth = a.C - ((kt0 + i) % a.slices) * 64;
      fence_regs(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        if (kk * 16 < depth)
          wgmma_tile<BN>(acc, wgmma_desc(at + kk * 32, 16, 1024),
                         wgmma_desc(bt + kk * 16 * 128, WG_BOX, 1024));
      wgmma_commit();
      fence_regs(acc);
      if (i > 0) {  // the previous step's products are done: free its stage
        wgmma_wait<1>();
        fence_regs(acc);
        if (lane == 0) mbar_arrive(&empty[(i - 1) % STAGES]);
      }
    }
    wgmma_wait<0>();
    fence_regs(acc);
  }

  // Epilogue, once a block, through the idle ring (every copy has landed
  // and every product is done past this barrier): fp32 rows, then bias ->
  // act -> one cast with 8-byte stores along F, by every thread.
  __syncthreads();
  float* Cs = reinterpret_cast<float*>(smem);
  if (warp < S::NC * 4) {
    const int r0 = (warp / 4) * 64 + (warp % 4) * 16 + lane / 4;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        *reinterpret_cast<float2*>(Cs + (r0 + 8 * h) * S::C_LD + 8 * j +
                                   2 * (lane % 4)) =
            make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
  }
  __syncthreads();
  float* part = a.ws + (size_t)blockIdx.z * a.M * a.F;
#pragma unroll 1
  for (int i = tid; i < BM * BN / 4; i += S::THREADS) {
    const int r = i / (BN / 4), c = 4 * (i % (BN / 4));
    const int m = m0 + r, f = f0 + c;
    if (m >= a.M || f >= a.F) continue;  // F % 8 == 0: f + 3 < F
    const float4 v = *reinterpret_cast<const float4*>(Cs + r * S::C_LD + c);
    if (nsplit == 1) {
      epilogue_pair(a.bias, nullptr, a.out, m, f, a.F, v.x, v.y, a.act);
      epilogue_pair(a.bias, nullptr, a.out, m, f + 2, a.F, v.z, v.w, a.act);
    } else {
      *reinterpret_cast<float4*>(part + (size_t)m * a.F + f) = v;
    }
  }
  if (nsplit == 1) return;
  int* counter = a.counters + blockIdx.y * gridDim.x + blockIdx.x;
  if (!last_split(counter, nsplit, S::THREADS)) return;
  finish_tile(a.ws, counter, nsplit, a.M, a.F, m0, BM, f0, BN, a.bias,
              nullptr, a.out, a.act, tid, S::THREADS);
}

// The weights (KH, KW, C, F) as a (KH*KW, C, F) tensor of 64-filter x
// 64-channel boxes, 128-byte swizzle; channels past C read as zeros.
int encode_weights(CUtensorMap* map, const void* w, int taps, int C, int F) {
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return (int)cudaErrorNotSupported;
  const cuuint64_t dims[3] = {(cuuint64_t)F, (cuuint64_t)C,
                              (cuuint64_t)taps};
  const cuuint64_t strides[2] = {(cuuint64_t)F * 2, (cuuint64_t)C * F * 2};
  const cuuint32_t box[3] = {64, 64, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
                        const_cast<void*>(w), dims, strides, box, unit,
                        CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

template <int BM, int BN>
int wg_launch(const void* w, const WgArgs& a, int nsplit,
              cudaStream_t stream) {
  using S = WgShape<BM, BN>;
  CUtensorMap tw;
  int e = encode_weights(&tw, w, a.KH * a.KW, a.C, a.F);
  if (e != 0) return e;
  e = smem_limit_once<conv_wgmma<BM, BN>>(S::SMEM);
  if (e != 0) return e;
  const dim3 grid((a.M + BM - 1) / BM, (a.F + BN - 1) / BN, nsplit);
  conv_wgmma<BM, BN><<<grid, S::THREADS, S::SMEM, stream>>>(tw, a);
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

// The bf16 wgmma variant (kernels/vwr_conv2d.py plan): tiles of bm (64 or
// 128) output pixels x bn (64 or 128) filters, the KH*KW*ceil(C/64) K
// steps in nsplit slices of kt_split (nsplit * kt_split >= steps >
// (nsplit - 1) * kt_split); ws: nsplit x (N*H_out*W_out) x F fp32 (unused when nsplit is
// 1); counters: one int32 of 0 per output tile, left at 0.  C % 8 == 0,
// F % 8 == 0; pointers 16-byte aligned.
extern "C" int vwr_conv2d_wgmma_launch(const void* x, const void* w,
                                       const void* bias, void* out, void* ws,
                                       void* counters, int N, int H, int W,
                                       int C, int KH, int KW, int F, int bm,
                                       int bn, int nsplit, int kt_split,
                                       int act, void* stream) {
  const int Ho = H - KH + 1, Wo = W - KW + 1, slices = (C + 63) / 64;
  const long long M = (long long)N * Ho * Wo;
  const int KT = KH * KW * slices;
  if (act < ACT_NONE || act > ACT_GELU || C <= 0 || C % 8 != 0 ||
      F % 8 != 0 || KH <= 0 || KW <= 0 || M >= (1LL << 31) ||
      nsplit < 1 || kt_split < 1 || (long long)nsplit * kt_split < KT ||
      (long long)(nsplit - 1) * kt_split >= KT)
    return (int)cudaErrorInvalidValue;
  if (M <= 0 || F <= 0) return 0;
  const WgArgs a{(const bf16*)x, (const bf16*)bias, (bf16*)out, (float*)ws,
                 (int*)counters, N, H, W, C, KH, KW, F, Ho, Wo, (int)M,
                 slices, kt_split, act};
  cudaStream_t s = (cudaStream_t)stream;
  if (bm == 64 && bn == 64) return wg_launch<64, 64>(w, a, nsplit, s);
  if (bm == 64 && bn == 128) return wg_launch<64, 128>(w, a, nsplit, s);
  if (bm == 128 && bn == 64) return wg_launch<128, 64>(w, a, nsplit, s);
  if (bm == 128 && bn == 128) return wg_launch<128, 128>(w, a, nsplit, s);
  return (int)cudaErrorInvalidValue;
}
