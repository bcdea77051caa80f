// Chunk-prefix flash attention for chunked prefill, for Hopper (sm_90a):
// one prompt chunk's queries against the prompt's prior pages of a paged
// KV pool, over model-dtype pools (bf16 / fp32) and int8 pools with
// per-(page, KV head) fp32 scales.
//
// Replaces: src/repro/kernels/vwr_decode.py :: vwr_chunk_prefix_attend_p
//           src/repro/kernels/vwr_decode.py :: vwr_chunk_prefix_attend_q8_p
//
// Contract: q (KV, C*G, D), the C chunk tokens' G query heads of each KV
// head (heads kv-major, h = kv*G + g); logical page j of the prefix is
// physical page table[j] (clamped to [0, n_pages)) with counts[j] valid
// keys (0 masks the page).  Writes the unnormalized fp32 partials
// (o_tilde (KV, C*G, D), m and l (KV, C*G)) of an online softmax with
// scale 1/sqrt(D); a row with no valid key gives m = -1e30, l = 0,
// o_tilde = 0.  On int8 pools the scales apply after the dots, as the TPU
// kernel does per page: s = (q . k) * k_scale, o += (p @ v) * v_scale.
//
// What bounds it on an H100: each valid K/V element feeds 2 * C * G
// flops (C * G = 512 query rows at tinyllama's 64-token chunks), 512
// flop per byte of bf16, above the card's 295 flop/byte ridge, so the
// bound is the operations at the tensor-core rate; at one prompt's
// prefix (a few hundred keys) the work is a few tens of MFLOP, and
// latency and the fp32 CUDA-core dots below set its time.
//
// Design: the TPU kernel's wide staging — each page is staged once for
// all C*G query rows of a grid step — kept per block.  One 128-thread
// block per (tile of 32 query rows, KV head); the TPU grid's sequential
// page axis becomes a loop inside the block over the J prior pages,
// whose count and table entry every thread reads alike (a page with
// count 0 is skipped before any pool byte is read).  A page is walked in
// tiles of up to 16 keys: the block stages the tile's K and V rows of
// its KV head into shared memory as fp32 with 16-byte loads (8 bf16,
// 8 fp32 or 16 int8 values), zero past the page's count.  Four threads
// share a query row: each holds the row's q (pre-scaled) and fp32
// accumulator for the dims d = sub + 4 i, scores every key of the tile
// on its dims and the four reduce the dot with two shuffles, so every
// thread of the row has the tile's scores; each then updates the row's
// online softmax (m, l) and its dims of o_tilde with P @ V from shared
// memory.  Reads of a K/V row in shared memory are 4 consecutive floats
// broadcast to the warp's 8 rows, free of bank conflicts.
//
// Known limits: the dots run on the CUDA cores in fp32, not the tensor
// cores; one KV head's C*G rows make ceil(C*G / 32) blocks, so a chunk of
// one token (C = G = 1) keeps 4 of 128 threads busy.
#include "common.cuh"

namespace {

constexpr int THREADS = 128, SUB = 4, ROWS = THREADS / SUB, TK = 16;

struct ChunkArgs {
  const void* q;         // (KV, CG, D) model dtype
  const void* k_pool;    // (n_pages, ps, KV, D) pool dtype
  const void* v_pool;
  const float* k_scale;  // (n_pages, KV), int8 pools only
  const float* v_scale;
  const int* table;      // (J,)
  const int* counts;     // (J,)
  float* o_t;            // (KV, CG, D)
  float* m;              // (KV, CG)
  float* l;
  int CG, J, n_pages, ps, KV;
  float scale;
};

template <typename TQ, typename TP, bool Q8, int D>
__global__ void __launch_bounds__(THREADS)
chunk_prefix_kernel(const ChunkArgs a) {
  constexpr int DS = D / SUB;                     // dims a thread owns
  constexpr int CH = sizeof(TP) == 1 ? 16 : 8;    // pool values a load
  constexpr int ROW_CH = D / CH;                  // loads a key row
  __shared__ __align__(16) float Ks[TK][D];
  __shared__ __align__(16) float Vs[TK][D];
  const int tid = threadIdx.x, sub = tid % SUB;
  const int kvh = blockIdx.y;
  const int r = blockIdx.x * ROWS + tid / SUB;    // this thread's row
  const bool live = r < a.CG;
  const size_t row = (size_t)a.KV * D;            // pool key-row stride
  const TP* kpool = static_cast<const TP*>(a.k_pool);
  const TP* vpool = static_cast<const TP*>(a.v_pool);

  float q[DS], acc[DS];
  {
    const TQ* qr = static_cast<const TQ*>(a.q) +
                   ((size_t)kvh * a.CG + (live ? r : 0)) * D;
#pragma unroll
    for (int i = 0; i < DS; ++i) {
      q[i] = live ? to_f32(qr[sub + SUB * i]) * a.scale : 0.0f;
      acc[i] = 0.0f;
    }
  }
  float m = REPRO_NEG_INF, l = 0.0f;

  for (int j = 0; j < a.J; ++j) {
    const int n = min(a.counts[j], a.ps);
    if (n <= 0) continue;          // the same for every thread
    const int page = min(max(a.table[j], 0), a.n_pages - 1);
    float ksc = 1.0f, vsc = 1.0f;
    if (Q8) {
      ksc = a.k_scale[(size_t)page * a.KV + kvh];
      vsc = a.v_scale[(size_t)page * a.KV + kvh];
    }
    const size_t base = (size_t)page * a.ps * row + (size_t)kvh * D;
    for (int t0 = 0; t0 < n; t0 += TK) {
      const int nt = min(TK, n - t0);
      __syncthreads();             // the previous tile's readers are done
      for (int idx = tid; idx < TK * ROW_CH; idx += THREADS) {
        const int t = idx / ROW_CH, c = (idx % ROW_CH) * CH;
        float kc[CH], vc[CH];
        if (t < nt) {
          const size_t off = base + (size_t)(t0 + t) * row + c;
          load_chunk(kpool + off, kc);
          load_chunk(vpool + off, vc);
        } else {
#pragma unroll
          for (int e = 0; e < CH; ++e) kc[e] = vc[e] = 0.0f;
        }
#pragma unroll
        for (int e = 0; e < CH; e += 4) {
          *reinterpret_cast<float4*>(&Ks[t][c + e]) =
              make_float4(kc[e], kc[e + 1], kc[e + 2], kc[e + 3]);
          *reinterpret_cast<float4*>(&Vs[t][c + e]) =
              make_float4(vc[e], vc[e + 1], vc[e + 2], vc[e + 3]);
        }
      }
      __syncthreads();

      float s[TK];
      float mt = REPRO_NEG_INF;
#pragma unroll
      for (int t = 0; t < TK; ++t) {
        float part = 0.0f;
#pragma unroll
        for (int i = 0; i < DS; ++i)
          part = fmaf(q[i], Ks[t][sub + SUB * i], part);
        part += __shfl_xor_sync(0xffffffffu, part, 1);
        part += __shfl_xor_sync(0xffffffffu, part, 2);
        if (Q8) part *= ksc;
        s[t] = t < nt ? part : REPRO_NEG_INF;
        mt = fmaxf(mt, s[t]);
      }
      // nt >= 1, so m_new is a real score and exp(m - m_new) is 0 for
      // the first valid tile (m = -1e30), where l and acc are still 0
      const float m_new = fmaxf(m, mt);
      const float corr = expf(m - m_new);
      float psum = 0.0f;
#pragma unroll
      for (int t = 0; t < TK; ++t) {
        s[t] = t < nt ? expf(s[t] - m_new) : 0.0f;
        psum += s[t];
      }
      l = l * corr + psum;
#pragma unroll
      for (int i = 0; i < DS; ++i) {
        float pv = 0.0f;
#pragma unroll
        for (int t = 0; t < TK; ++t)
          pv = fmaf(s[t], Vs[t][sub + SUB * i], pv);
        acc[i] = acc[i] * corr + (Q8 ? pv * vsc : pv);
      }
      m = m_new;
    }
  }

  if (live) {
    const size_t o = (size_t)kvh * a.CG + r;
#pragma unroll
    for (int i = 0; i < DS; ++i) a.o_t[o * D + sub + SUB * i] = acc[i];
    if (sub == 0) {
      a.m[o] = m;
      a.l[o] = l;
    }
  }
}

template <typename TQ, typename TP, bool Q8>
int launch(const ChunkArgs& a, int D, cudaStream_t stream) {
  const dim3 grid((a.CG + ROWS - 1) / ROWS, a.KV);
  switch (D) {
    case 32:
      chunk_prefix_kernel<TQ, TP, Q8, 32><<<grid, THREADS, 0, stream>>>(a);
      break;
    case 64:
      chunk_prefix_kernel<TQ, TP, Q8, 64><<<grid, THREADS, 0, stream>>>(a);
      break;
    case 128:
      chunk_prefix_kernel<TQ, TP, Q8, 128><<<grid, THREADS, 0, stream>>>(a);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

bool bad_shape(const ChunkArgs& a) {
  return a.CG < 0 || a.J < 0 || a.ps <= 0 || a.n_pages <= 0 || a.KV < 0 ||
         a.KV > 65535;
}

}  // namespace

// q (KV, CG, D) — CG = C * G chunk rows per KV head, kv-major; k_pool,
// v_pool (n_pages, ps, KV, D) in q's dtype; table, counts (J,) int32.
// Writes fp32 o_t (KV, CG, D), m and l (KV, CG).  D in {32, 64, 128}; all
// contiguous, q and the pools 16-byte aligned.
extern "C" int vwr_chunk_prefix_attend_launch(
    const void* q, const void* k_pool, const void* v_pool, const void* table,
    const void* counts, void* o_t, void* m, void* l, int CG, int J,
    int n_pages, int ps, int KV, int D, float scale, int dtype,
    void* stream) {
  const ChunkArgs a{q, k_pool, v_pool, nullptr, nullptr, (const int*)table,
                    (const int*)counts, (float*)o_t, (float*)m, (float*)l,
                    CG, J, n_pages, ps, KV, scale};
  if (bad_shape(a)) return (int)cudaErrorInvalidValue;
  if (CG == 0 || KV == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == REPRO_BF16)
    return launch<__nv_bfloat16, __nv_bfloat16, false>(a, D, s);
  if (dtype == REPRO_F32) return launch<float, float, false>(a, D, s);
  return (int)cudaErrorInvalidValue;
}

// The same over int8 pools: k_pool, v_pool (n_pages, ps, KV, D) int8 and
// k_scale, v_scale (n_pages, KV) fp32 (dequantized value = int8 * scale);
// q in the model dtype (`dtype`).
extern "C" int vwr_chunk_prefix_attend_q8_launch(
    const void* q, const void* k_pool, const void* v_pool,
    const void* k_scale, const void* v_scale, const void* table,
    const void* counts, void* o_t, void* m, void* l, int CG, int J,
    int n_pages, int ps, int KV, int D, float scale, int dtype,
    void* stream) {
  const ChunkArgs a{q, k_pool, v_pool, (const float*)k_scale,
                    (const float*)v_scale, (const int*)table,
                    (const int*)counts, (float*)o_t, (float*)m, (float*)l,
                    CG, J, n_pages, ps, KV, scale};
  if (bad_shape(a)) return (int)cudaErrorInvalidValue;
  if (CG == 0 || KV == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == REPRO_BF16) return launch<__nv_bfloat16, int8_t, true>(a, D, s);
  if (dtype == REPRO_F32) return launch<float, int8_t, true>(a, D, s);
  return (int)cudaErrorInvalidValue;
}
