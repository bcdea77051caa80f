// Flash-decode partials for one new token against a paged KV pool, for
// Hopper (sm_90a): model-dtype pools (bf16 / fp32) and int8 pools with
// per-(page, KV head) fp32 scales.
//
// Replaces: src/repro/kernels/vwr_decode.py :: vwr_paged_flash_decode_p
//           src/repro/kernels/vwr_decode.py :: vwr_paged_flash_decode_q8_p
//
// What bounds it on an H100: every live K/V element of a slot is read
// once per generated token and feeds 2 * G flops, far under the 295
// flop/byte ridge, so the kernel is memory-bound; the int8 pools halve
// the bytes of bf16 ones (plus 8 bytes of scales per live page and head).
//
// Design: the dense kernel's (csrc/vwr_decode.cu) with a block-table
// walk.  One 128-thread block per (slot, KV head) query group: the G
// query heads that share the KV head read each K/V row once (zero-copy
// GQA).  A page is (page_size, KV, D) rows with the dense cache's
// KV * D row stride, so the inner loop carries over.  The TPU grid's
// sequential logical-page axis becomes a loop inside the block over the
// slot's J * page_size logical key positions, 32 at a time per warp
// (the 4 warps split the keys); a lane's key t lies in logical page
// j = t / page_size, which resolves to physical page table[slot, j]
// (clamped to [0, n_pages), as the JAX wrapper clamps the table) and is
// valid iff t % page_size < counts[slot, j].  The counts need not be a
// prefix: a page with count 0 is masked wherever it lies (the
// sequence-sharded path passes ownership-masked counts), and a 32-key
// tile with no valid key is skipped before any pool byte is read.
// Each lane scores its key for all G queries with 16-byte loads of its
// K row (8 bf16 / 8 fp32 / 16 int8 values), the warp keeps an fp32
// online softmax per query, and P @ V runs over the tile's valid keys
// only, each lane owning D / 32 output dims.  On int8 pools a 32-key
// tile spans pages with different scales, so the scales are applied per
// key, not per tile: each score is (q . k) * k_scale[page, head], and
// each key's p is multiplied by v_scale[page, head] before P @ V (after
// it entered l), which is what the TPU kernel computes per page as
// (q . k) * ks and (p @ v) * vs.  The four warp partials merge in shared
// memory with the flash combine (m > -1e30/2 guard), and the block
// writes the unnormalized fp32 (o_tilde, m, l): a slot with no valid
// key gives m = -1e30, l = 0, o_tilde = 0.
//
// Known limit: at 8 slots x 4 KV heads the grid is 32 blocks on 132
// SMs; spreading one group over several blocks is later work.
#include "common.cuh"

namespace {

constexpr int WARPS = 4, THREADS = WARPS * 32, TILE = 32;

// pool elements per load_chunk: 8 for bf16 and fp32, 16 for int8
template <typename P>
struct Chunk {
  static constexpr int N = sizeof(P) == 1 ? 16 : 8;
};

struct PagedArgs {
  const void* q;           // (B*KV, G, D) model dtype
  const void* k_pool;      // (n_pages, ps, KV, D) pool dtype
  const void* v_pool;
  const float* k_scale;    // (n_pages, KV), int8 pools only
  const float* v_scale;
  const int* table;        // (B, J)
  const int* counts;       // (B, J)
  float* o_t;              // (B*KV, G, D)
  float* m;                // (B*KV, G)
  float* l;
  int B, J, n_pages, ps, KV, G;
  float scale;
};

template <typename TQ, typename TP, bool Q8, int D, int GM>
__global__ void __launch_bounds__(THREADS)
paged_decode_kernel(const PagedArgs a) {
  constexpr int DL = D / 32;
  constexpr int CH = Chunk<TP>::N;
  __shared__ float Qs[GM * D];
  __shared__ float Ms[WARPS][GM], Ls[WARPS][GM];
  __shared__ float Os[WARPS][GM][D];
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int KV = a.KV, G = a.G, ps = a.ps;
  const int bkv = blockIdx.x, b = bkv / KV, kvh = bkv % KV;
  const size_t row = (size_t)KV * D;
  const size_t page_elems = (size_t)ps * row;
  const TQ* qb = static_cast<const TQ*>(a.q) + (size_t)bkv * G * D;
  const TP* kpool = static_cast<const TP*>(a.k_pool);
  const TP* vpool = static_cast<const TP*>(a.v_pool);
  const int* tb = a.table + (size_t)b * a.J;
  const int* cb = a.counts + (size_t)b * a.J;

  for (int idx = tid; idx < GM * D; idx += THREADS)
    Qs[idx] = idx / D < G ? to_f32(qb[idx]) * a.scale : 0.0f;
  __syncthreads();

  float m[GM], l[GM], acc[GM][DL];
#pragma unroll
  for (int g = 0; g < GM; ++g) {
    m[g] = REPRO_NEG_INF;
    l[g] = 0.0f;
#pragma unroll
    for (int c = 0; c < DL; ++c) acc[g][c] = 0.0f;
  }

  const int n_keys = a.J * ps;
  for (int t0 = warp * TILE; t0 < n_keys; t0 += WARPS * TILE) {
    const int t = t0 + lane;
    bool valid = false;
    unsigned long long off = 0;   // element offset of this key's K/V row
    float ksc = 1.0f, vsc = 1.0f;
    if (t < n_keys) {
      const int j = t / ps, o = t - j * ps;
      if (o < cb[j]) {
        const int page = min(max(tb[j], 0), a.n_pages - 1);
        valid = true;
        off = (unsigned long long)page * page_elems + (size_t)o * row +
              (size_t)kvh * D;
        if (Q8) {
          ksc = a.k_scale[(size_t)page * KV + kvh];
          vsc = a.v_scale[(size_t)page * KV + kvh];
        }
      }
    }
    const unsigned vmask = __ballot_sync(0xffffffffu, valid);
    if (vmask == 0u) continue;    // a masked tile reads no pool bytes

    float s[GM];
#pragma unroll
    for (int g = 0; g < GM; ++g) s[g] = 0.0f;
    if (valid) {
      const TP* kr = kpool + off;
#pragma unroll
      for (int d0 = 0; d0 < D; d0 += CH) {
        float kc[CH];
        load_chunk(kr + d0, kc);
#pragma unroll
        for (int g = 0; g < GM; ++g)
#pragma unroll
          for (int e = 0; e < CH; ++e)
            s[g] = fmaf(Qs[g * D + d0 + e], kc[e], s[g]);
      }
      if (Q8) {
#pragma unroll
        for (int g = 0; g < GM; ++g) s[g] *= ksc;
      }
    }
    float p[GM];
#pragma unroll
    for (int g = 0; g < GM; ++g) {
      const float sc = valid ? s[g] : REPRO_NEG_INF;
      const float m_new = fmaxf(m[g], warp_max(sc));
      p[g] = valid ? expf(sc - m_new) : 0.0f;
      const float corr = expf(m[g] - m_new);
      l[g] = l[g] * corr + warp_sum(p[g]);
#pragma unroll
      for (int c = 0; c < DL; ++c) acc[g][c] *= corr;
      m[g] = m_new;
      if (Q8) p[g] *= vsc;        // the value scale rides on p, after l
    }
    unsigned bits = vmask;
    while (bits) {
      const int src = __ffs(bits) - 1;
      bits &= bits - 1;
      const unsigned long long voff = __shfl_sync(0xffffffffu, off, src);
      const TP* vr = vpool + voff;
      float vv[DL];
#pragma unroll
      for (int c = 0; c < DL; ++c) vv[c] = to_f32(vr[lane + 32 * c]);
#pragma unroll
      for (int g = 0; g < GM; ++g) {
        const float pj = __shfl_sync(0xffffffffu, p[g], src);
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
    a.o_t[((size_t)bkv * G + g) * D + d] = o;
    if (d == 0) {
      a.m[(size_t)bkv * G + g] = ms;
      a.l[(size_t)bkv * G + g] = lsum;
    }
  }
}

template <typename TQ, typename TP, bool Q8, int D>
int launch_g(const PagedArgs& a, cudaStream_t stream) {
#define REPRO_PAGED_G(GM)                                                   \
  if (a.G <= GM) {                                                          \
    paged_decode_kernel<TQ, TP, Q8, D, GM><<<a.B * a.KV, THREADS, 0,       \
                                             stream>>>(a);                  \
    return (int)cudaGetLastError();                                         \
  }
  REPRO_PAGED_G(1)
  REPRO_PAGED_G(2)
  REPRO_PAGED_G(4)
  REPRO_PAGED_G(8)
  REPRO_PAGED_G(16)
#undef REPRO_PAGED_G
  return (int)cudaErrorInvalidValue;
}

template <typename TQ, typename TP, bool Q8>
int launch_d(const PagedArgs& a, int D, cudaStream_t stream) {
  switch (D) {
    case 32: return launch_g<TQ, TP, Q8, 32>(a, stream);
    case 64: return launch_g<TQ, TP, Q8, 64>(a, stream);
    case 128: return launch_g<TQ, TP, Q8, 128>(a, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

bool bad_shape(const PagedArgs& a) {
  return a.G <= 0 || a.J < 0 || a.ps <= 0 || a.n_pages <= 0;
}

}  // namespace

// q (B*KV, G, D) — one token's heads per slot, kv-major (h = kv*G + g);
// k_pool, v_pool (n_pages, ps, KV, D) in q's dtype; table, counts (B, J)
// int32: logical page j of slot b is physical page table[b, j] (clamped
// to [0, n_pages)) holding counts[b, j] valid keys.  Writes fp32 o_t
// (B*KV, G, D), m and l (B*KV, G).  G <= 16, D in {32, 64, 128}; all
// contiguous, q and the pools 16-byte aligned.
extern "C" int vwr_paged_flash_decode_launch(
    const void* q, const void* k_pool, const void* v_pool, const void* table,
    const void* counts, void* o_t, void* m, void* l, int B, int J,
    int n_pages, int ps, int KV, int G, int D, float scale, int dtype,
    void* stream) {
  const PagedArgs a{q, k_pool, v_pool, nullptr, nullptr,
                    (const int*)table, (const int*)counts, (float*)o_t,
                    (float*)m, (float*)l, B, J, n_pages, ps, KV, G, scale};
  if (bad_shape(a)) return (int)cudaErrorInvalidValue;
  if (B <= 0 || KV <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == REPRO_BF16)
    return launch_d<__nv_bfloat16, __nv_bfloat16, false>(a, D, s);
  if (dtype == REPRO_F32) return launch_d<float, float, false>(a, D, s);
  return (int)cudaErrorInvalidValue;
}

// The same over int8 pools: k_pool, v_pool (n_pages, ps, KV, D) int8 and
// k_scale, v_scale (n_pages, KV) fp32 (dequantized value = int8 * scale);
// q in the model dtype (`dtype`).
extern "C" int vwr_paged_flash_decode_q8_launch(
    const void* q, const void* k_pool, const void* v_pool,
    const void* k_scale, const void* v_scale, const void* table,
    const void* counts, void* o_t, void* m, void* l, int B, int J,
    int n_pages, int ps, int KV, int G, int D, float scale, int dtype,
    void* stream) {
  const PagedArgs a{q, k_pool, v_pool, (const float*)k_scale,
                    (const float*)v_scale, (const int*)table,
                    (const int*)counts, (float*)o_t, (float*)m, (float*)l,
                    B, J, n_pages, ps, KV, G, scale};
  if (bad_shape(a)) return (int)cudaErrorInvalidValue;
  if (B <= 0 || KV <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == REPRO_BF16)
    return launch_d<__nv_bfloat16, int8_t, true>(a, D, s);
  if (dtype == REPRO_F32) return launch_d<float, int8_t, true>(a, D, s);
  return (int)cudaErrorInvalidValue;
}
