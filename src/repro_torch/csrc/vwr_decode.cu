// Flash-decode partials for one new token against a dense KV cache, for
// Hopper (sm_90a): a cache in the query's dtype, or an int8 cache with one
// fp32 scale a (batch, KV head) row.
//
// Replaces: src/repro/kernels/vwr_decode.py :: vwr_flash_decode_p
//           src/repro/kernels/vwr_decode.py :: vwr_flash_decode_q8_p
//
// What bounds it on an H100: every valid cached K/V element is read
// once per generated token and feeds 2 * G flops, so the kernel is
// memory-bound (2 * G flops per 2-byte element, or per int8 byte, is far
// under the 295 flop/byte ridge).  The int8 cache halves those bytes.
//
// Design: one 128-thread block per (batch, KV head) query group: the G
// query heads that share the KV head read each K/V row once (zero-copy
// GQA, straight from the native (B, T, KV, D) cache layout).  The TPU
// grid's sequential KV axis becomes a loop that stops at the last valid
// position (min(T, cur_len - pos0)), so unwritten cache rows are never
// read.  The block's 4 warps split the keys 32 at a time (split-KV
// inside the block); each lane scores one key for all G queries with
// 16-byte loads of its K row, keeps an fp32 online softmax per query,
// and accumulates P @ V over 2 (D = 64) output dims per lane.  The four
// warp partials merge in shared memory with the same flash combine
// (m > -1e30/2 guard) that ``merge_partials`` uses, and the block writes
// the unnormalized fp32 (o_tilde, m, l) the decode contract returns: a
// row with no valid key gives m = -1e30, l = 0, o_tilde = 0.
//
// The int8 kernel is the same body on the cache's element type: its rows
// load 8 int8 a lane at a time, the row's k scale multiplies each score
// after the dot, and its v scale the finished P @ V (the scales are
// constant over the row, so both commute with the sums exactly, as in the
// Pallas kernel; the model-dtype kernel takes scales of 1).
//
// Known limit: at B * KV = 16 groups (tinyllama, batch 4) the grid is
// 16 blocks on 132 SMs; spreading one group over several blocks
// (split-KV across blocks plus a combine pass) is later work.
#include "common.cuh"

namespace {

constexpr int WARPS = 4, THREADS = WARPS * 32, TILE = 32;

template <typename TQ, typename TC, int D, int GM>
__global__ void __launch_bounds__(THREADS)
decode_kernel(const TQ* __restrict__ q, const TC* __restrict__ k,
              const TC* __restrict__ v, const float* __restrict__ k_scale,
              const float* __restrict__ v_scale, float* __restrict__ o_t,
              float* __restrict__ m_out, float* __restrict__ l_out, int T_len,
              int KV, int G, int n_keys, float scale) {
  constexpr int DL = D / 32;
  __shared__ float Qs[GM * D];
  __shared__ float Ms[WARPS][GM], Ls[WARPS][GM];
  __shared__ float Os[WARPS][GM][D];
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int bkv = blockIdx.x, b = bkv / KV, kvh = bkv % KV;
  const size_t row = (size_t)KV * D;
  const TQ* qb = q + (size_t)bkv * G * D;
  const TC* kb = k + (size_t)b * T_len * row + (size_t)kvh * D;
  const TC* vb = v + (size_t)b * T_len * row + (size_t)kvh * D;
  // int8 cache: this (batch, KV head) row's scales; else exact 1s
  const float ks = k_scale != nullptr ? k_scale[bkv] : 1.0f;
  const float vs = v_scale != nullptr ? v_scale[bkv] : 1.0f;

  for (int idx = tid; idx < GM * D; idx += THREADS)
    Qs[idx] = idx / D < G ? to_f32(qb[idx]) * scale : 0.0f;
  __syncthreads();

  float m[GM], l[GM], acc[GM][DL];
#pragma unroll
  for (int g = 0; g < GM; ++g) {
    m[g] = REPRO_NEG_INF;
    l[g] = 0.0f;
#pragma unroll
    for (int c = 0; c < DL; ++c) acc[g][c] = 0.0f;
  }

  for (int t0 = warp * TILE; t0 < n_keys; t0 += WARPS * TILE) {
    const int t = t0 + lane;
    float s[GM];
#pragma unroll
    for (int g = 0; g < GM; ++g) s[g] = 0.0f;
    if (t < n_keys) {
      const TC* kr = kb + (size_t)t * row;
#pragma unroll
      for (int d0 = 0; d0 < D; d0 += 8) {
        float kc[8];
        load8(kr + d0, kc);
#pragma unroll
        for (int g = 0; g < GM; ++g)
#pragma unroll
          for (int e = 0; e < 8; ++e)
            s[g] = fmaf(Qs[g * D + d0 + e], kc[e], s[g]);
      }
    }
    float p[GM];
#pragma unroll
    for (int g = 0; g < GM; ++g) {
      const float sc = t < n_keys ? s[g] * ks : REPRO_NEG_INF;
      const float m_new = fmaxf(m[g], warp_max(sc));
      p[g] = m_new > REPRO_NEG_INF / 2 ? expf(sc - m_new) : 0.0f;
      const float corr = expf(m[g] - m_new);
      l[g] = l[g] * corr + warp_sum(p[g]);
#pragma unroll
      for (int c = 0; c < DL; ++c) acc[g][c] *= corr;
      m[g] = m_new;
    }
    const int n_tile = min(TILE, n_keys - t0);
    for (int j = 0; j < n_tile; ++j) {
      const TC* vr = vb + (size_t)(t0 + j) * row;
      float vv[DL];
#pragma unroll
      for (int c = 0; c < DL; ++c) vv[c] = to_f32(vr[lane + 32 * c]);
#pragma unroll
      for (int g = 0; g < GM; ++g) {
        const float pj = __shfl_sync(0xffffffffu, p[g], j);
#pragma unroll
        for (int c = 0; c < DL; ++c) acc[g][c] = fmaf(pj, vv[c], acc[g][c]);
      }
    }
  }

#pragma unroll
  for (int g = 0; g < GM; ++g) {
    if (lane == 0) {
      Ms[warp][g] = m[g];
      Ls[warp][g] = l[g];
    }
#pragma unroll
    for (int c = 0; c < DL; ++c) Os[warp][g][lane + 32 * c] = acc[g][c];
  }
  __syncthreads();

  for (int idx = tid; idx < G * D; idx += THREADS) {
    const int g = idx / D, d = idx % D;
    float ms = REPRO_NEG_INF;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) ms = fmaxf(ms, Ms[w][g]);
    float o = 0.0f, lsum = 0.0f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      const float sw =
          Ms[w][g] > REPRO_NEG_INF / 2 ? expf(Ms[w][g] - ms) : 0.0f;
      o += Os[w][g][d] * sw;
      lsum += Ls[w][g] * sw;
    }
    o_t[((size_t)bkv * G + g) * D + d] = o * vs;
    if (d == 0) {
      m_out[(size_t)bkv * G + g] = ms;
      l_out[(size_t)bkv * G + g] = lsum;
    }
  }
}

struct DecodeArgs {
  const void *q, *k, *v;
  const float *k_scale, *v_scale;   // int8 cache; nullptr otherwise
  void *o_t, *m, *l;
  int B, T_len, KV, G, n_keys;
  float scale;
};

template <typename TQ, typename TC, int D, int GM>
int launch(const DecodeArgs& a, void* stream) {
  if (a.B <= 0 || a.KV <= 0) return 0;
  decode_kernel<TQ, TC, D, GM>
      <<<a.B * a.KV, THREADS, 0, (cudaStream_t)stream>>>(
          (const TQ*)a.q, (const TC*)a.k, (const TC*)a.v, a.k_scale,
          a.v_scale, (float*)a.o_t, (float*)a.m, (float*)a.l, a.T_len, a.KV,
          a.G, a.n_keys, a.scale);
  return (int)cudaGetLastError();
}

template <typename TQ, typename TC, int D>
int launch_g(const DecodeArgs& a, void* stream) {
  if (a.G <= 1) return launch<TQ, TC, D, 1>(a, stream);
  if (a.G <= 2) return launch<TQ, TC, D, 2>(a, stream);
  if (a.G <= 4) return launch<TQ, TC, D, 4>(a, stream);
  if (a.G <= 8) return launch<TQ, TC, D, 8>(a, stream);
  if (a.G <= 16) return launch<TQ, TC, D, 16>(a, stream);
  return (int)cudaErrorInvalidValue;
}

template <typename TQ, typename TC>
int launch_d(const DecodeArgs& a, int D, void* stream) {
  switch (D) {
    case 32: return launch_g<TQ, TC, 32>(a, stream);
    case 64: return launch_g<TQ, TC, 64>(a, stream);
    case 128: return launch_g<TQ, TC, 128>(a, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// q (B*KV, G, D) — one token's heads, kv-major (h = kv*G + g); k, v
// (B, T, KV, D) the dense cache; keys 0 .. n_keys-1 are valid (the
// caller folds idx < T and pos0 + idx < cur_len into n_keys).  Writes
// fp32 o_t (B*KV, G, D), m and l (B*KV, G).  G <= 16, D in {32, 64,
// 128}; all contiguous, q/k/v 16-byte aligned.
extern "C" int vwr_flash_decode_launch(const void* q, const void* k,
                                       const void* v, void* o_t, void* m,
                                       void* l, int B, int T_len, int KV,
                                       int G, int D, int n_keys, float scale,
                                       int dtype, void* stream) {
  if (G <= 0 || n_keys > T_len) return (int)cudaErrorInvalidValue;
  const DecodeArgs a{q, k, v, nullptr, nullptr, o_t, m, l,
                     B, T_len, KV, G, n_keys, scale};
  if (dtype == REPRO_BF16)
    return launch_d<__nv_bfloat16, __nv_bfloat16>(a, D, stream);
  if (dtype == REPRO_F32) return launch_d<float, float>(a, D, stream);
  return (int)cudaErrorInvalidValue;
}

// Kernel 9: the same over an int8 cache k, v (B, T, KV, D) with fp32
// scales k_scale, v_scale (B*KV,), one a (batch, KV head) row
// (dequantized value = int8 * scale); q stays in `dtype` (bf16 / fp32).
extern "C" int vwr_flash_decode_q8_launch(
    const void* q, const void* k, const void* v, const void* k_scale,
    const void* v_scale, void* o_t, void* m, void* l, int B, int T_len,
    int KV, int G, int D, int n_keys, float scale, int dtype, void* stream) {
  if (G <= 0 || n_keys > T_len) return (int)cudaErrorInvalidValue;
  const DecodeArgs a{q, k, v, (const float*)k_scale, (const float*)v_scale,
                     o_t, m, l, B, T_len, KV, G, n_keys, scale};
  if (dtype == REPRO_BF16)
    return launch_d<__nv_bfloat16, int8_t>(a, D, stream);
  if (dtype == REPRO_F32) return launch_d<float, int8_t>(a, D, stream);
  return (int)cudaErrorInvalidValue;
}
