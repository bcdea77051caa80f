// Causal flash attention with zero-copy GQA for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/vwr_attention.py :: vwr_attention_p
//           (causal path; the non-causal path stays on the plain
//           version, as in the JAX package).
//
// What bounds it on an H100: the two products, 2 * 2 * S^2/2 * D flops
// per head against (q, k, v, o) bytes, so at the prefill shapes of the
// main path (S = 128..512, D = 64) the arithmetic is small and this
// fp32-FMA version is bound by its instruction issue, not by memory:
// it does not use the tensor cores (later work: mma.sync / wgmma tiles).
//
// Design: one 256-thread block per (batch*head, 64-query tile).  The KV
// axis that the TPU grid walked sequentially is a loop inside the block,
// and it stops at the tile's last query (causal: no key block above the
// diagonal is read).  Each 32-key K/V tile is staged once in shared
// memory as fp32 and serves all 64 queries; each warp owns 8 queries,
// each lane one key of the tile for the score and 2 (D = 64) output
// dims for P @ V.  The online softmax (m, l, acc) stays in fp32
// registers and the output is acc / max(l, 1e-30), as in the Pallas
// kernel.  Zero-copy GQA: query head h reads KV head h / (H / KV)
// straight from the native (B, S, KV, D) layout — no repeat, no
// transpose; keys past S and above the diagonal are masked in the
// kernel (no padding pass).
#include "common.cuh"

namespace {

constexpr int BQ = 64, BKV = 32, WARPS = 8, THREADS = WARPS * 32;
constexpr int ROWS = BQ / WARPS;

template <int D>
constexpr size_t smem_bytes() {
  return (size_t)(BQ * D + BKV * (D + 1) + BKV * D) * sizeof(float);
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
attn_kernel(const T* __restrict__ q, const T* __restrict__ k,
            const T* __restrict__ v, T* __restrict__ o, int S, int H,
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
  const T* qb = q + (size_t)b * S * q_row + (size_t)h * D;
  const T* kb = k + (size_t)b * S * kv_row + (size_t)kvh * D;
  const T* vb = v + (size_t)b * S * kv_row + (size_t)kvh * D;
  T* ob = o + (size_t)b * S * q_row + (size_t)h * D;

  for (int idx = tid; idx < BQ * D; idx += THREADS) {
    const int s = q0 + idx / D;
    Qs[idx] = s < S ? to_f32(qb[(size_t)s * q_row + idx % D]) * scale : 0.0f;
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
        kx = to_f32(kb[(size_t)t * kv_row + d]);
        vx = to_f32(vb[(size_t)t * kv_row + d]);
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
      ob[(size_t)s * q_row + lane + 32 * c] = from_f32<T>(acc[i][c] / den);
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int S, int H, int KV, float scale, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0) return 0;
  constexpr size_t smem = smem_bytes<D>();
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        attn_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid(B * H, (S + BQ - 1) / BQ);
  attn_kernel<T, D><<<grid, THREADS, smem, (cudaStream_t)stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)o, S, H, KV, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_d(const void* q, const void* k, const void* v, void* o, int B,
             int S, int H, int KV, int D, float scale, void* stream) {
  switch (D) {
    case 32: return launch<T, 32>(q, k, v, o, B, S, H, KV, scale, stream);
    case 64: return launch<T, 64>(q, k, v, o, B, S, H, KV, scale, stream);
    case 128: return launch<T, 128>(q, k, v, o, B, S, H, KV, scale, stream);
    default: return (int)cudaErrorInvalidValue;
  }
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
  if (dtype == REPRO_BF16)
    return launch_d<__nv_bfloat16>(q, k, v, o, B, S, H, KV, D, scale,
                                   stream);
  if (dtype == REPRO_F32)
    return launch_d<float>(q, k, v, o, B, S, H, KV, D, scale, stream);
  return (int)cudaErrorInvalidValue;
}
