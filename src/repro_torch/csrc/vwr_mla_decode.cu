// Absorbed-MLA flash-decode partials for one new token against the
// latent cache, for Hopper (sm_90a): a dense (B, T, .) cache or page pools
// (n_pages, page_size, .), each in bf16 / fp32 or int8 with fp32 scales;
// and the partials of a prompt chunk's C tokens against its prior latent
// pages (chunked prefill), the pools' contract with one table shared.
//
// Replaces: src/repro/kernels/vwr_decode.py :: vwr_mla_flash_decode_p
//           src/repro/kernels/vwr_decode.py :: vwr_mla_paged_flash_decode_p
//           src/repro/kernels/vwr_decode.py :: vwr_mla_paged_flash_decode_q8_p
//           src/repro/kernels/vwr_decode.py :: vwr_mla_flash_decode_q8_p
//           src/repro/kernels/vwr_decode.py :: vwr_mla_chunk_prefix_attend_p
//           src/repro/kernels/vwr_decode.py :: vwr_mla_chunk_prefix_attend_q8_p
//
// Contract (the Pallas bodies'): the queries are folded through wk_b, so a
// key's score is s = (q_abs * scale) . c_kv + (q_rope * scale) . k_rope
// and its value is the latent row c_kv itself.  q_abs (B, H, r) and q_rope
// (B, H, rope) are fp32.  Masks: dense, key idx is valid iff
// idx < min(T, cur_len - pos0) (the wrapper passes that count); paged, row
// o of logical page j is valid iff o < counts[b, j], a count of 0 masking
// the page, which is then not read.  Table entries are clamped to
// [0, n_pages).  On int8 caches the latent and the rope dots each take
// their own scale after the dot, and P @ c_kv the latent scale: one scale a
// sequence (B,) for the dense cache, one a page (n_pages,) for the pools.
// Writes the unnormalized fp32 (o_tilde (B, H, r), m (B, H), l (B, H)); a
// head with no valid key gets m = -1e30, l = 0, o_tilde = 0.
//
// What bounds it on an H100: each latent element (r + rope = 576 for
// DeepSeek-V3) is read once per token and feeds 4 flops per head, 512 per
// element at H = 128 (about 256 per byte at bf16): near the ridge, but at
// decode's few keys the fp32 queries and partials in and out (2 x H x r x
// 4 bytes a sequence) outweigh the keys, so it is memory-bound.  The chunk
// kernels are not: every prior key is reused by all C x H query rows
// (2 x 576 + 2 x 512 flops a row a key: 4.6 GFLOP at C 64, H 128 and 256
// keys, ~0.07 ms at the fp32 rate, against ~36 MB of fp32 queries and
// partials, ~0.011 ms), so they are bound by operations, the natural
// first target for the tensor cores.
//
// Design.  The TPU kernel keeps all H heads' (H, r) accumulators in VMEM:
// 256 KB at DeepSeek-V3's widths, more than a block's shared memory.  Here
// a block takes one sequence and HB = 16 heads (grid (B, H / 16)), and each
// of its 8 warps owns 2 heads.  A lane holds r / 32 latent and rope / 32
// rope query features of each of its heads, and r / 32 accumulators, for
// dims lane + 32 c.  The block walks the sequence's keys in tiles of at
// most 16 rows (one page, or a sub-tile of a larger page); each tile of
// latent and rope rows is staged once in shared memory as fp32 (16-byte
// loads) and read by every warp.  A warp scores a key for both its heads
// with fp32 FMAs and one warp reduction each, keeps an fp32 online
// softmax per head and adds p * c_kv into the lane's accumulators.  The
// heads-as-M tensor-core form ((H x 576) . (576 x T) a sequence, a wgmma
// tile) is later work.
//
// The chunk kernels run the pools' body with "sequence" read as "chunk
// token" and the table row shared (stride 0).  The TPU kernel keeps all
// (C x H, r) fp32 accumulators in VMEM across a sequential grid over the
// pages: 16 MB at a 64-token chunk of DeepSeek-V3, far past a block's
// shared memory.  Here the rows are independent, so they are tiled across
// blocks (grid (C, H / 16)), and the page loop is the loop inside each
// block; a staged tile serves the block's 16 rows, and L2 serves the C
// blocks that read the same page.
#include "common.cuh"

namespace {

constexpr int WARPS = 8, THREADS = WARPS * 32, HPW = 2, HB = WARPS * HPW;
constexpr int TK = 16;   // rows a staged tile

struct MlaArgs {
  const float* q_abs;        // (B, H, r)
  const float* q_rope;       // (B, H, rope)
  const void* ckv;           // (B, T, r) dense | (n_pages, ps, r) pools
  const void* krope;         // (B, T, rope)    | (n_pages, ps, rope)
  const float* ckv_scale;    // int8: (B,) dense | (n_pages,) pools
  const float* krope_scale;
  const int* table;          // pools: (B, J); nullptr for the dense cache
  const int* counts;
  float* o_t;                // (B, H, r)
  float* m;                  // (B, H)
  float* l;
  int B, H, lead, rows, n;   // lead: B | n_pages; rows: T | ps; n: keys | J
  float scale;
  int tstride;               // pools: table row stride, J | 0 (chunk)
};

// `count` elements (a multiple of 32) from `src` to shared fp32 `dst`,
// 16 bytes of source a load; both 16-byte aligned
template <typename TP>
__device__ __forceinline__ void stage(const TP* src, float* dst, int count) {
  constexpr int CH = sizeof(TP) == 1 ? 16 : 8;
  for (int e = threadIdx.x * CH; e < count; e += THREADS * CH) {
    float v[CH];
    load_chunk(src + e, v);
#pragma unroll
    for (int k = 0; k < CH; k += 4)
      *reinterpret_cast<float4*>(dst + e + k) =
          make_float4(v[k], v[k + 1], v[k + 2], v[k + 3]);
  }
}

template <typename TP, int RC, int RPC>
struct Walker {
  static constexpr int R = RC * 32, RP = RPC * 32;
  static constexpr bool Q8 = sizeof(TP) == 1;
  float* Ls;   // (TK, R) shared
  float* Rs;   // (TK, RP) shared
  int lane;
  float qa[HPW][RC], qr[HPW][RPC], acc[HPW][RC], m[HPW], l[HPW];

  // one tile: `nt` (1..TK) consecutive rows from `ckv` / `kr`, whose
  // latent / rope parts take the scales cs / rs (int8 only)
  __device__ __forceinline__ void tile(const TP* ckv, const TP* kr, int nt,
                                       float cs, float rs) {
    __syncthreads();   // every warp is done with the previous tile
    stage(ckv, Ls, nt * R);
    stage(kr, Rs, nt * RP);
    __syncthreads();
    float s[HPW][TK];
#pragma unroll
    for (int t = 0; t < TK; ++t) {
      if (t < nt) {
        float kv[RC], kp[RPC];
#pragma unroll
        for (int c = 0; c < RC; ++c) kv[c] = Ls[t * R + lane + 32 * c];
#pragma unroll
        for (int c = 0; c < RPC; ++c) kp[c] = Rs[t * RP + lane + 32 * c];
#pragma unroll
        for (int i = 0; i < HPW; ++i) {
          float a = 0.0f, b = 0.0f;
#pragma unroll
          for (int c = 0; c < RC; ++c) a = fmaf(qa[i][c], kv[c], a);
#pragma unroll
          for (int c = 0; c < RPC; ++c) b = fmaf(qr[i][c], kp[c], b);
          s[i][t] = warp_sum(Q8 ? a * cs + b * rs : a + b);
        }
      } else {
#pragma unroll
        for (int i = 0; i < HPW; ++i) s[i][t] = REPRO_NEG_INF;
      }
    }
#pragma unroll
    for (int i = 0; i < HPW; ++i) {
      float mt = m[i];
#pragma unroll
      for (int t = 0; t < TK; ++t) mt = fmaxf(mt, s[i][t]);
      const float corr = expf(m[i] - mt);
      float psum = 0.0f;
#pragma unroll
      for (int t = 0; t < TK; ++t) {
        const float p = t < nt ? expf(s[i][t] - mt) : 0.0f;
        psum += p;
        s[i][t] = Q8 ? p * cs : p;   // the latent scale rides on p, after l
      }
      l[i] = l[i] * corr + psum;
      m[i] = mt;
#pragma unroll
      for (int c = 0; c < RC; ++c) acc[i][c] *= corr;
    }
#pragma unroll
    for (int t = 0; t < TK; ++t) {
      if (t < nt) {
#pragma unroll
        for (int c = 0; c < RC; ++c) {
          const float v = Ls[t * R + lane + 32 * c];
#pragma unroll
          for (int i = 0; i < HPW; ++i) acc[i][c] = fmaf(s[i][t], v, acc[i][c]);
        }
      }
    }
  }
};

template <typename TP, int RC, int RPC>
__global__ void __launch_bounds__(THREADS) mla_decode_kernel(const MlaArgs a) {
  using W = Walker<TP, RC, RPC>;
  constexpr int R = W::R, RP = W::RP;
  __shared__ __align__(16) float Ls[TK * R];
  __shared__ __align__(16) float Rs[TK * RP];
  const int b = blockIdx.x, warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int h0 = blockIdx.y * HB + warp * HPW;
  W w;
  w.Ls = Ls;
  w.Rs = Rs;
  w.lane = lane;
#pragma unroll
  for (int i = 0; i < HPW; ++i) {
    // a head past H computes on zero queries and writes nothing
    const bool on = h0 + i < a.H;
    const size_t bh = (size_t)b * a.H + h0 + i;
#pragma unroll
    for (int c = 0; c < RC; ++c) {
      w.qa[i][c] = on ? a.q_abs[bh * R + lane + 32 * c] * a.scale : 0.0f;
      w.acc[i][c] = 0.0f;
    }
#pragma unroll
    for (int c = 0; c < RPC; ++c)
      w.qr[i][c] = on ? a.q_rope[bh * RP + lane + 32 * c] * a.scale : 0.0f;
    w.m[i] = REPRO_NEG_INF;
    w.l[i] = 0.0f;
  }
  const TP* ckv = static_cast<const TP*>(a.ckv);
  const TP* kr = static_cast<const TP*>(a.krope);

  if (a.table == nullptr) {
    // dense: the first n valid keys of sequence b's slab
    const float cs = W::Q8 ? a.ckv_scale[b] : 1.0f;
    const float rs = W::Q8 ? a.krope_scale[b] : 1.0f;
    const size_t row0 = (size_t)b * a.rows;
    for (int t0 = 0; t0 < a.n; t0 += TK)
      w.tile(ckv + (row0 + t0) * R, kr + (row0 + t0) * RP,
             min(TK, a.n - t0), cs, rs);
  } else {
    // pools: logical page j is physical page table[b, j] (clamped) with
    // counts[b, j] valid rows (table[j] / counts[j] for every chunk
    // token); a page with none is skipped unread
    const int* tb = a.table + (size_t)b * a.tstride;
    const int* cb = a.counts + (size_t)b * a.tstride;
    for (int j = 0; j < a.n; ++j) {
      const int cnt = min(cb[j], a.rows);
      if (cnt <= 0) continue;
      const int page = min(max(tb[j], 0), a.lead - 1);
      const float cs = W::Q8 ? a.ckv_scale[page] : 1.0f;
      const float rs = W::Q8 ? a.krope_scale[page] : 1.0f;
      const size_t row0 = (size_t)page * a.rows;
      for (int o = 0; o < cnt; o += TK)
        w.tile(ckv + (row0 + o) * R, kr + (row0 + o) * RP,
               min(TK, cnt - o), cs, rs);
    }
  }

#pragma unroll
  for (int i = 0; i < HPW; ++i) {
    if (h0 + i >= a.H) continue;
    const size_t bh = (size_t)b * a.H + h0 + i;
#pragma unroll
    for (int c = 0; c < RC; ++c) a.o_t[bh * R + lane + 32 * c] = w.acc[i][c];
    if (lane == 0) {
      a.m[bh] = w.m[i];
      a.l[bh] = w.l[i];
    }
  }
}

template <typename TP, int RC>
int launch_rope(const MlaArgs& a, int rope, cudaStream_t stream) {
  const dim3 grid(a.B, (a.H + HB - 1) / HB);
  switch (rope) {
    case 32:
      mla_decode_kernel<TP, RC, 1><<<grid, THREADS, 0, stream>>>(a);
      break;
    case 64:
      mla_decode_kernel<TP, RC, 2><<<grid, THREADS, 0, stream>>>(a);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

template <typename TP>
int launch(const MlaArgs& a, int r, int rope, cudaStream_t stream) {
  if (a.B <= 0 || a.H <= 0) return 0;
  switch (r) {
    case 32: return launch_rope<TP, 1>(a, rope, stream);
    case 64: return launch_rope<TP, 2>(a, rope, stream);
    case 128: return launch_rope<TP, 4>(a, rope, stream);
    case 256: return launch_rope<TP, 8>(a, rope, stream);
    case 512: return launch_rope<TP, 16>(a, rope, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

int launch_dtype(const MlaArgs& a, int r, int rope, int dtype, bool q8,
                 cudaStream_t stream) {
  if (a.lead <= 0 || a.rows <= 0 || a.n < 0) return (int)cudaErrorInvalidValue;
  if (q8) return launch<int8_t>(a, r, rope, stream);
  if (dtype == REPRO_BF16) return launch<__nv_bfloat16>(a, r, rope, stream);
  if (dtype == REPRO_F32) return launch<float>(a, r, rope, stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// Kernel 10.  q_abs (B, H, r) and q_rope (B, H, rope) fp32; c_kv (B, T, r)
// and k_rope (B, T, rope) in `dtype` (bf16 / fp32); the first n_keys rows
// of each sequence are valid.  Writes fp32 o_t (B, H, r), m and l (B, H).
// r in {32, 64, 128, 256, 512}, rope in {32, 64}; all contiguous and
// 16-byte aligned.  `lead` is B and `rows` is T.
extern "C" int vwr_mla_flash_decode_launch(
    const void* q_abs, const void* q_rope, const void* ckv, const void* krope,
    void* o_t, void* m, void* l, int B, int H, int r, int rope, int lead,
    int rows, int n_keys, float scale, int dtype, void* stream) {
  const MlaArgs a{(const float*)q_abs, (const float*)q_rope, ckv, krope,
                  nullptr, nullptr, nullptr, nullptr, (float*)o_t,
                  (float*)m, (float*)l, B, H, lead, rows, n_keys, scale, 0};
  return launch_dtype(a, r, rope, dtype, false, (cudaStream_t)stream);
}

// Kernel 14: kernel 10 over int8 caches with fp32 (B,) latent and rope
// scales (dequantized value = int8 * scale).
extern "C" int vwr_mla_flash_decode_q8_launch(
    const void* q_abs, const void* q_rope, const void* ckv, const void* krope,
    const void* ckv_scale, const void* krope_scale, void* o_t, void* m,
    void* l, int B, int H, int r, int rope, int lead, int rows, int n_keys,
    float scale, int dtype, void* stream) {
  const MlaArgs a{(const float*)q_abs, (const float*)q_rope, ckv, krope,
                  (const float*)ckv_scale, (const float*)krope_scale,
                  nullptr, nullptr, (float*)o_t, (float*)m, (float*)l, B, H,
                  lead, rows, n_keys, scale, 0};
  return launch_dtype(a, r, rope, dtype, true, (cudaStream_t)stream);
}

// Kernel 11: the pools ckv (n_pages, ps, r) and krope (n_pages, ps, rope)
// in `dtype`, through table and counts (B, J) int32.  `lead` is n_pages
// and `rows` is ps.
extern "C" int vwr_mla_paged_flash_decode_launch(
    const void* q_abs, const void* q_rope, const void* ckv, const void* krope,
    const void* table, const void* counts, void* o_t, void* m, void* l,
    int B, int H, int r, int rope, int lead, int rows, int J, float scale,
    int dtype, void* stream) {
  const MlaArgs a{(const float*)q_abs, (const float*)q_rope, ckv, krope,
                  nullptr, nullptr, (const int*)table, (const int*)counts,
                  (float*)o_t, (float*)m, (float*)l, B, H, lead, rows, J,
                  scale, J};
  return launch_dtype(a, r, rope, dtype, false, (cudaStream_t)stream);
}

// Kernel 13: kernel 11 over int8 pools with fp32 (n_pages,) latent and
// rope scales.
extern "C" int vwr_mla_paged_flash_decode_q8_launch(
    const void* q_abs, const void* q_rope, const void* ckv, const void* krope,
    const void* ckv_scale, const void* krope_scale, const void* table,
    const void* counts, void* o_t, void* m, void* l, int B, int H, int r,
    int rope, int lead, int rows, int J, float scale, int dtype,
    void* stream) {
  const MlaArgs a{(const float*)q_abs, (const float*)q_rope, ckv, krope,
                  (const float*)ckv_scale, (const float*)krope_scale,
                  (const int*)table, (const int*)counts, (float*)o_t,
                  (float*)m, (float*)l, B, H, lead, rows, J, scale, J};
  return launch_dtype(a, r, rope, dtype, true, (cudaStream_t)stream);
}

// Kernel 12: a chunk of C tokens, q_abs (C, H, r) and q_rope (C, H, rope)
// fp32, against the pools ckv (n_pages, ps, r) and krope (n_pages, ps,
// rope) in `dtype` through one table and counts (J,) int32 shared by the C
// tokens.  Writes fp32 o_t (C, H, r), m and l (C, H).  `lead` is n_pages
// and `rows` is ps.
extern "C" int vwr_mla_chunk_prefix_attend_launch(
    const void* q_abs, const void* q_rope, const void* ckv, const void* krope,
    const void* table, const void* counts, void* o_t, void* m, void* l,
    int C, int H, int r, int rope, int lead, int rows, int J, float scale,
    int dtype, void* stream) {
  const MlaArgs a{(const float*)q_abs, (const float*)q_rope, ckv, krope,
                  nullptr, nullptr, (const int*)table, (const int*)counts,
                  (float*)o_t, (float*)m, (float*)l, C, H, lead, rows, J,
                  scale, 0};
  return launch_dtype(a, r, rope, dtype, false, (cudaStream_t)stream);
}

// Kernel 15: kernel 12 over int8 pools with fp32 (n_pages,) latent and
// rope scales.
extern "C" int vwr_mla_chunk_prefix_attend_q8_launch(
    const void* q_abs, const void* q_rope, const void* ckv, const void* krope,
    const void* ckv_scale, const void* krope_scale, const void* table,
    const void* counts, void* o_t, void* m, void* l, int C, int H, int r,
    int rope, int lead, int rows, int J, float scale, int dtype,
    void* stream) {
  const MlaArgs a{(const float*)q_abs, (const float*)q_rope, ckv, krope,
                  (const float*)ckv_scale, (const float*)krope_scale,
                  (const int*)table, (const int*)counts, (float*)o_t,
                  (float*)m, (float*)l, C, H, lead, rows, J, scale, 0};
  return launch_dtype(a, r, rope, dtype, true, (cudaStream_t)stream);
}
