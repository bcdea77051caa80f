// Causal flash attention with zero-copy GQA for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/vwr_attention.py :: vwr_attention_p
//           (causal path; the non-causal path stays on the plain
//           version, as in the JAX package).
//
// What bounds it on an H100: at the prefill shapes of the main path
// (S = 128..2048, D = 64) the two products are 4 * S^2/2 * D flops a head
// against (q, k, v, o) bytes; at S = 128 the bytes bound it (0.0014 ms
// for B4 H32 KV4), from S ~ 1k on the operations.
//
// bf16 (attn_wgmma): one 128-thread block (a warpgroup) per (batch, KV
// head, query tile).  The G query heads that share a KV head are packed
// into the 64 rows of one wgmma tile: row r is position q0 + r / G' and
// head kvh * G + g0 + r % G', with G' = min(G, 64) (tinyllama: 8
// positions x 8 heads; qwen, G 1: 64 positions of one head; rows past
// (64 / G') G' pad).  So each K/V tile is read from memory and staged once
// for the whole group, not once a head.  Q and 64-key K/V tiles are
// staged by cp.async in the 128-byte-swizzled layout of wgmma (K/V double
// buffered: the next tile loads while this one multiplies); D 32 is
// zero-filled to 64 columns, D 128 takes two 64-column blocks.
// S = Q K^T is a wgmma m64n64k16 with both operands in shared memory (K
// K-major); the causal mask (each row's own position) and the online
// softmax run in fp32 on the accumulator fragment; P is rounded to bf16
// in registers and is the register A operand of O += P V (V MN-major:
// the transpose bit).  Rounding P to bf16 (the fp32 kernel and the plain
// version keep P in fp32) costs at most 2^-9 of each weight; the row sums
// l stay in fp32.  The KV loop stops at the tile's last position.  The
// output is acc / max(l, 1e-30), as in the Pallas kernel.
//
// fp32 (attn_kernel): one 256-thread block per (batch*head, 64-query
// tile), FMA only (TF32 would move the fp32 numerics).  Each 32-key K/V
// tile is staged once in shared memory as fp32 and serves all 64 queries;
// each warp owns 8 queries, each lane one key of the tile for the score
// and 2 (D = 64) output dims for P @ V; the online softmax (m, l, acc)
// stays in fp32 registers.  Query head h reads KV head h / (H / KV)
// straight from the native (B, S, KV, D) layout — no repeat, no
// transpose; keys past S and above the diagonal are masked in the kernel
// (no padding pass).
#include "common.cuh"

namespace {

constexpr int BQ = 64, BKV = 32, WARPS = 8, THREADS = WARPS * 32;
constexpr int ROWS = BQ / WARPS;

template <int D>
constexpr size_t smem_bytes() {
  return (size_t)(BQ * D + BKV * (D + 1) + BKV * D) * sizeof(float);
}

template <int D>
__global__ void __launch_bounds__(THREADS)
attn_kernel(const float* __restrict__ q, const float* __restrict__ k,
            const float* __restrict__ v, float* __restrict__ o, int S, int H,
            int KV, float scale) {
  constexpr int DL = D / 32;  // output dims per lane
  constexpr int K_LD = D + 1;  // odd stride: lane j reads row j conflict-free
  extern __shared__ float sm[];
  float* Qs = sm;               // BQ x D, pre-scaled
  float* Ks = Qs + BQ * D;      // BKV x K_LD
  float* Vs = Ks + BKV * K_LD;  // BKV x D
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const int kvh = h / (H / KV);
  const int q0 = blockIdx.y * BQ;
  const size_t q_row = (size_t)H * D, kv_row = (size_t)KV * D;
  const float* qb = q + (size_t)b * S * q_row + (size_t)h * D;
  const float* kb = k + (size_t)b * S * kv_row + (size_t)kvh * D;
  const float* vb = v + (size_t)b * S * kv_row + (size_t)kvh * D;
  float* ob = o + (size_t)b * S * q_row + (size_t)h * D;

  for (int idx = tid; idx < BQ * D; idx += THREADS) {
    const int s = q0 + idx / D;
    Qs[idx] = s < S ? qb[(size_t)s * q_row + idx % D] * scale : 0.0f;
  }
  float m[ROWS], l[ROWS], acc[ROWS][DL];
#pragma unroll
  for (int i = 0; i < ROWS; ++i) {
    m[i] = REPRO_NEG_INF;
    l[i] = 0.0f;
#pragma unroll
    for (int c = 0; c < DL; ++c) acc[i][c] = 0.0f;
  }

  const int kv_end = min(S, q0 + BQ);  // causal: nothing past the last query
  for (int t0 = 0; t0 < kv_end; t0 += BKV) {
    __syncthreads();  // the previous tile is consumed
    for (int idx = tid; idx < BKV * D; idx += THREADS) {
      const int j = idx / D, d = idx % D, t = t0 + j;
      float kx = 0.0f, vx = 0.0f;
      if (t < S) {
        kx = kb[(size_t)t * kv_row + d];
        vx = vb[(size_t)t * kv_row + d];
      }
      Ks[j * K_LD + d] = kx;
      Vs[j * D + d] = vx;
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < ROWS; ++i) {
      const int r = warp * ROWS + i, s = q0 + r;
      if (s >= S || t0 > s) continue;  // warp-uniform: tile above the row
      const float* qr = Qs + r * D;
      const float* kr = Ks + lane * K_LD;
      float sc = 0.0f;
#pragma unroll 16
      for (int d = 0; d < D; ++d) sc = fmaf(qr[d], kr[d], sc);
      const int t = t0 + lane;
      if (!(t < S && t <= s)) sc = REPRO_NEG_INF;
      const float m_new = fmaxf(m[i], warp_max(sc));
      const float p = m_new > REPRO_NEG_INF / 2 ? expf(sc - m_new) : 0.0f;
      const float corr = expf(m[i] - m_new);
      l[i] = l[i] * corr + warp_sum(p);
#pragma unroll
      for (int c = 0; c < DL; ++c) acc[i][c] *= corr;
#pragma unroll 8
      for (int j = 0; j < BKV; ++j) {
        const float pj = __shfl_sync(0xffffffffu, p, j);
#pragma unroll
        for (int c = 0; c < DL; ++c)
          acc[i][c] = fmaf(pj, Vs[j * D + lane + 32 * c], acc[i][c]);
      }
      m[i] = m_new;
    }
  }

#pragma unroll
  for (int i = 0; i < ROWS; ++i) {
    const int s = q0 + warp * ROWS + i;
    if (s >= S) continue;
    const float den = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int c = 0; c < DL; ++c)
      ob[(size_t)s * q_row + lane + 32 * c] = acc[i][c] / den;
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int S, int H, int KV, float scale, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0) return 0;
  constexpr size_t smem = smem_bytes<D>();
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        attn_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid(B * H, (S + BQ - 1) / BQ);
  attn_kernel<D><<<grid, THREADS, smem, (cudaStream_t)stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (float*)o, S, H,
      KV, scale);
  return (int)cudaGetLastError();
}

int launch_fp32(const void* q, const void* k, const void* v, void* o,
                int B, int S, int H, int KV, int D, float scale,
                void* stream) {
  switch (D) {
    case 32: return launch<32>(q, k, v, o, B, S, H, KV, scale, stream);
    case 64: return launch<64>(q, k, v, o, B, S, H, KV, scale, stream);
    case 128: return launch<128>(q, k, v, o, B, S, H, KV, scale, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

// ---- bf16: wgmma, the query group packed into the rows ----

using bf16 = __nv_bfloat16;
constexpr int WG_ROWS = 64, WG_BKV = 64, WG_THREADS = 128;

// Shared memory, in 64-row x 64-column bf16 blocks of 8 KB (128-byte
// rows, 128-byte swizzle): Q, then K and V, two buffers each.
template <int DP>
struct WgSmem {
  static constexpr int TILE = (DP / 64) * 8192;
  static constexpr int Q = 0, K = TILE, V = 3 * TILE;
  static constexpr int BYTES = 1024 + 5 * TILE;
};

// cp.async a 64-row tile of DP columns into `tile`: row r from row_ptr(r)
// (nullptr: zeros), its first D columns; the rest zeros.
template <int DP, typename RowPtr>
__device__ __forceinline__ void stage_tile(unsigned char* tile, int D,
                                           const bf16* zero_src,
                                           RowPtr row_ptr) {
  constexpr int CHUNKS = DP / 8;  // 16-byte chunks a row
  for (int i = threadIdx.x; i < WG_ROWS * CHUNKS; i += WG_THREADS) {
    const int r = i / CHUNKS, cc = i % CHUNKS;
    const bf16* src = row_ptr(r);
    const bool ok = src != nullptr && cc * 8 < D;
    cp_async16(tile + (cc / 8) * 8192 + swz128(r, cc % 8),
               ok ? src + cc * 8 : zero_src, ok);
  }
}

template <int DP>
__device__ __forceinline__ void wgmma_pv(float (&o)[DP / 2],
                                         const uint32_t (&a)[4], uint64_t db);
template <>
__device__ __forceinline__ void wgmma_pv<64>(float (&o)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  wgmma_rs_n64<1>(o, a, db);
}
template <>
__device__ __forceinline__ void wgmma_pv<128>(float (&o)[64],
                                              const uint32_t (&a)[4],
                                              uint64_t db) {
  wgmma_rs_n128<1>(o, a, db);
}

// grid (B * KV * head chunks, position tiles); hb = min(G, 64) heads a
// row group, 64 / hb positions a tile.
template <int DP>
__global__ void __launch_bounds__(WG_THREADS)
attn_wgmma(const bf16* __restrict__ q, const bf16* __restrict__ k,
           const bf16* __restrict__ v, bf16* __restrict__ o, int S, int H,
           int KV, int D, int hb, float scale_log2) {
  using L = WgSmem<DP>;
  extern __shared__ unsigned char wg_smem[];
  unsigned char* sm = align1024(wg_smem);
  const int G = H / KV, nhc = (G + hb - 1) / hb, pp = WG_ROWS / hb;
  const int hc = blockIdx.x % nhc, kvh = (blockIdx.x / nhc) % KV;
  const int b = blockIdx.x / (nhc * KV);
  const int p0 = blockIdx.y * pp;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const size_t q_row = (size_t)H * D, kv_row = (size_t)KV * D;
  const bf16* qb = q + (size_t)b * S * q_row + (size_t)(kvh * G) * D;
  const bf16* kb = k + (size_t)b * S * kv_row + (size_t)kvh * D;
  const bf16* vb = v + (size_t)b * S * kv_row + (size_t)kvh * D;

  // row r of the tile: position p0 + r / hb, group head hc * hb + r % hb
  auto q_ptr = [&](int r) -> const bf16* {
    const int pos = p0 + r / hb, g = hc * hb + r % hb;
    if (r >= pp * hb || g >= G || pos >= S) return nullptr;
    return qb + (size_t)pos * q_row + (size_t)g * D;
  };
  auto stage_kv = [&](int tile, int buf) {
    const int t0 = tile * WG_BKV;
    stage_tile<DP>(sm + L::K + buf * L::TILE, D, kb, [&](int r) {
      return t0 + r < S ? kb + (size_t)(t0 + r) * kv_row : nullptr;
    });
    stage_tile<DP>(sm + L::V + buf * L::TILE, D, vb, [&](int r) {
      return t0 + r < S ? vb + (size_t)(t0 + r) * kv_row : nullptr;
    });
  };
  stage_tile<DP>(sm + L::Q, D, qb, q_ptr);
  stage_kv(0, 0);
  cp_async_commit();

  // this thread's two rows of the accumulator fragments
  const int r0 = warp * 16 + lane / 4, r1 = r0 + 8;
  const int pos0 = p0 + r0 / hb, pos1 = p0 + r1 / hb;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.0f, l1 = 0.0f;
  float acc[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) acc[i] = 0.0f;

  const int n_tiles = (min(S, p0 + pp) - 1) / WG_BKV + 1;
  for (int t = 0; t < n_tiles; ++t) {
    if (t + 1 < n_tiles) {
      stage_kv(t + 1, (t + 1) & 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    fence_proxy_async();
    __syncthreads();
    const unsigned char* Kt = sm + L::K + (t & 1) * L::TILE;
    const unsigned char* Vt = sm + L::V + (t & 1) * L::TILE;

    float s[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = 0.0f;
    fence_regs(s);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < DP / 16; ++ks) {
      const int off = (ks / 4) * 8192 + (ks % 4) * 32;
      wgmma_ss_n64<0>(s, wgmma_desc(sm + L::Q + off, 16, 1024),
                      wgmma_desc(Kt + off, 16, 1024));
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);

    // mask by each row's position, scale into log2 units, row maxima
    const int t0 = t * WG_BKV;
    float mx0 = m0, mx1 = m1;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int key = t0 + 8 * j + 2 * (lane % 4) + e;
        const bool in = key < S;
        s[4 * j + e] =
            in && key <= pos0 ? s[4 * j + e] * scale_log2 : -INFINITY;
        s[4 * j + 2 + e] =
            in && key <= pos1 ? s[4 * j + 2 + e] * scale_log2 : -INFINITY;
        mx0 = fmaxf(mx0, s[4 * j + e]);
        mx1 = fmaxf(mx1, s[4 * j + 2 + e]);
      }
    // every row sees key 0 in tile 0, so the maxima are finite from here
    mx0 = quad_max(mx0);
    mx1 = quad_max(mx1);
    const float c0 = exp2f(m0 - mx0), c1 = exp2f(m1 - mx1);
    m0 = mx0;
    m1 = mx1;
    l0 *= c0;
    l1 *= c1;
#pragma unroll
    for (int j = 0; j < DP / 8; ++j) {
      acc[4 * j] *= c0;
      acc[4 * j + 1] *= c0;
      acc[4 * j + 2] *= c1;
      acc[4 * j + 3] *= c1;
    }
    // P = exp2(s - m), rounded to bf16 as the A fragments of P V: keys
    // 16 kc .. + 15 are the accumulator's column blocks 2 kc and 2 kc + 1
    uint32_t pa[4][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float p00 = exp2f(s[4 * j] - m0), p01 = exp2f(s[4 * j + 1] - m0);
      const float p10 = exp2f(s[4 * j + 2] - m1);
      const float p11 = exp2f(s[4 * j + 3] - m1);
      l0 += p00 + p01;
      l1 += p10 + p11;
      pa[j / 2][(j % 2) * 2] = pack_bf16(p00, p01);
      pa[j / 2][(j % 2) * 2 + 1] = pack_bf16(p10, p11);
    }
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int kc = 0; kc < 4; ++kc)
      wgmma_pv<DP>(acc, pa[kc], wgmma_desc(Vt + kc * 16 * 128, 8192, 1024));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
    __syncthreads();  // this buffer is free for the tile after next
  }

  l0 = fmaxf(quad_sum(l0), 1e-30f);
  l1 = fmaxf(quad_sum(l1), 1e-30f);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = h ? r1 : r0, pos = h ? pos1 : pos0;
    const int g = hc * hb + r % hb;
    if (r >= pp * hb || g >= G || pos >= S) continue;
    const float inv = 1.0f / (h ? l1 : l0);
    bf16* orow = o + (((size_t)b * S + pos) * H + (size_t)kvh * G + g) * D;
#pragma unroll
    for (int j = 0; j < DP / 8; ++j) {
      const int col = 8 * j + 2 * (lane % 4);
      if (col < D)
        *reinterpret_cast<__nv_bfloat162*>(orow + col) =
            __floats2bfloat162_rn(acc[4 * j + 2 * h] * inv,
                                  acc[4 * j + 2 * h + 1] * inv);
    }
  }
}

template <int DP>
int launch_wgmma(const void* q, const void* k, const void* v, void* o, int B,
                 int S, int H, int KV, int D, float scale, void* stream) {
  const int G = H / KV, hb = G < WG_ROWS ? G : WG_ROWS;
  const int nhc = (G + hb - 1) / hb, pp = WG_ROWS / hb;
  constexpr int smem = WgSmem<DP>::BYTES;
  if (smem > 48 * 1024) {
    const int e = smem_limit_once<attn_wgmma<DP>>(smem);
    if (e != 0) return e;
  }
  const dim3 grid(B * KV * nhc, (S + pp - 1) / pp);
  attn_wgmma<DP><<<grid, WG_THREADS, smem, (cudaStream_t)stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (bf16*)o, S, H, KV, D,
      hb, scale * 1.4426950408889634f);
  return (int)cudaGetLastError();
}

}  // namespace

// o (B, S, H, D) = causal softmax(scale * q k^T) v with q (B, S, H, D)
// and k, v (B, S, KV, D), all contiguous; H % KV == 0, D in {32, 64, 128}.
// The caller passes scale = 1 / sqrt(D) rounded to fp32.
extern "C" int vwr_attention_launch(const void* q, const void* k,
                                    const void* v, void* o, int B, int S,
                                    int H, int KV, int D, float scale,
                                    int dtype, void* stream) {
  if (KV <= 0 || H % KV != 0) return (int)cudaErrorInvalidValue;
  if (dtype == REPRO_BF16) {
    if (B <= 0 || S <= 0 || H <= 0) return 0;
    if (D == 32 || D == 64)
      return launch_wgmma<64>(q, k, v, o, B, S, H, KV, D, scale, stream);
    if (D == 128)
      return launch_wgmma<128>(q, k, v, o, B, S, H, KV, D, scale, stream);
    return (int)cudaErrorInvalidValue;
  }
  if (dtype == REPRO_F32)
    return launch_fp32(q, k, v, o, B, S, H, KV, D, scale, stream);
  return (int)cudaErrorInvalidValue;
}
