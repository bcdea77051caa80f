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
// 256 KB at DeepSeek-V3's widths, more than a block's shared memory.  Two
// kernels serve kernels 10, 11, 13 and 14 here, and
// kernels/vwr_mla_decode.py decode_variant picks one a call: the wgmma
// kernel (below) for bf16 caches and pools and int8 caches (kernel 14)
// and pools (kernel 13) at r 128 / 256 / 512, rope 32 / 64, pages of a
// multiple of 8 rows, and the FMA kernel (mla_decode_kernel) for fp32
// caches and the padded widths of the reduced configs.
//   The FMA kernel: a block takes one sequence and HB = 16 heads (grid (B,
//   H / 16)), and each of its 8 warps owns 2 heads.  A lane holds r / 32
//   latent and rope / 32 rope query features of each of its heads, and r
//   / 32 accumulators, for dims lane + 32 c.  The block walks the
//   sequence's keys in tiles of at most 16 rows (one page, or a sub-tile
//   of a larger page); each tile of latent and rope rows is staged once in
//   shared memory as fp32 (16-byte loads) and read by every warp.  A warp
//   scores a key for both its heads with fp32 FMAs and one warp reduction
//   each, keeps an fp32 online softmax per head and adds p * c_kv into the
//   lane's accumulators.
//   The wgmma kernel (mla_wgmma, shared with the chunk kernels below): the
//   heads as M, (H x 576) . (576 x T) a sequence, 64 of a sequence's heads
//   a block (rows past H masked), 2 blocks a sequence at H 128.  Its keys
//   are the sequence's own table row (kernels 11, 13) or its slab of the
//   dense cache (kernels 10, 14: rows b T .. b T + n_keys of a (B * T, r)
//   tensor map; the 32-row TMA boxes that run past n_keys into the next
//   sequence are masked in the scores, past the tensor TMA fills zeros).
//   Decode has
//   few keys a sequence (144 in generate, 1-255 a Scheduler slot) and row
//   blocks alone give 8-16 blocks, so mla_decode_plan also cuts a row
//   group's keys into splits (whole table entries, from the table's shape,
//   never its counts; whole 32-key tiles of the slab), one block a split,
//   merged by the group's last block in the same launch (common.cuh
//   finish_partials, as kernels 4-6), and its output columns into 1, 2 or
//   4 column blocks that each score every key of their split and multiply
//   P by their r / NCOL columns of c_kv only (no merge).
//
// The chunk kernels.  The TPU kernel keeps all (C x H, r) fp32
// accumulators in VMEM across a sequential grid over the pages: 16 MB at a
// 64-token chunk of DeepSeek-V3, far past a block's shared memory.  The
// rows are independent, so they are tiled across blocks, and the page loop
// is the loop inside each block.
//
// Kernel 12 on fp32 pools, and both at the padded widths the wgmma
// variant does not take, run the pools' body above with "sequence" read as
// "chunk token" and the table row shared (stride 0): grid (C, H / 16),
// fp32 FMAs; a staged tile serves a block's 16 rows, and L2 serves the C
// blocks that read the same page.
//
// Kernel 12 on bf16 pools and kernel 15 on int8 pools (mla_wgmma's CHUNK
// instance: the chunk as one sequence of C x H rows, one split, one column
// block;
// kernels/vwr_mla_decode.py chunk_variant: r in {128, 256, 512}, rope in
// {32, 64}, pages of a multiple of 8 rows) put the tensor cores on it.
// The rows are the chunk's C x H
// query rows in q_abs's order (c major, h minor), 64 a block: at C 64 and
// H 128 that is 128 blocks, one wave on 132 SMs, and every staged key
// serves 64 rows.  On the tensor cores the 4.6 GFLOP of the headline shape
// take ~0.005 ms (two bf16 terms: ~0.009), under the ~0.011 ms that its
// 36 MB of fp32 queries and partials take, so bytes bound it.
//   Numerics.  The queries are fp32 and are read once, times `scale`, and
//   each is split into two bf16 terms: hi = bf16(x), lo = bf16(x - hi).
//   The pool values are bf16, so every product term is exact in fp32 and
//   wgmma's fp32 sums keep a score to about 2^-17 of |q| |k| a term (the
//   plain version's fp32 einsum: 2^-24).  P is split the same way (hi + lo
//   = p to 2^-17) as the register A operand of P c_kv.  l sums the fp32 p;
//   m is the fp32 row maximum of the scores.
//   Shared memory.  The two query terms, K-major with the 128-byte swizzle
//   (64-column blocks of 64 rows; the rope block last), take 147 KB at r
//   512, rope 64; keys come in tiles of 32 rows (36 KB a tile), two
//   stages: the queries stay resident and no key tile is read twice by a
//   block.
//   Keys.  The block walks the table's pages: a tile holds 32 / ps whole
//   pages (ps <= 32) or 32 rows of one page (larger pages are sub-tiled);
//   a count-0 page is skipped unread and entries are clamped to [0,
//   n_pages).  Each page segment of a tile comes in by TMA (boxes of 64
//   columns x min(ps, 32) rows, the 128-byte swizzle, a box a lane of one
//   warp of the second warpgroup, on the stage's mbarrier): cp.async
//   gathers by every thread took a third of a tile's time.  Slots past a
//   page's count are masked in the scores (P = 0 there, as in the plain
//   version); segments past the table's end are zero-filled.  One warp of
//   the first warpgroup walks the table two tiles ahead into a small map
//   in shared memory while the P c_kv products run.
//   Products.  Two consumer warpgroups; each owns half of the output's r
//   columns (256 fp32 accumulators a row at r 512 would not fit one
//   warpgroup's registers).  S = q . [c_kv | k_rope] is split by its depth
//   instead of computed twice: each warpgroup runs wgmma m64n32k16 over
//   half of the 576 dimensions (hi and lo terms into one accumulator) and
//   the two halves are added through 8 KB of shared memory (each side adds
//   the other's half to its own, the same fp32 sum).  Both then run the
//   same fp32 online softmax on the 64 x 32 fragment, and P (hi, lo) from
//   registers times the tile's c_kv columns of their half (MN-major, the
//   transpose bit) accumulates into o_tilde.  The next tile's loads are
//   issued while the score products run.  A row with no valid key keeps
//   m = -1e30, l = 0, o_tilde = 0.  o_tilde leaves through the idle query
//   blocks, whole rows of 16-byte stores.
//   Kernels 15 and 13 (int8 pools, Q8: the CHUNK instance, and the
//   decode one, whose splits each take P's power of two from their own
//   entries of the sequence's row and write o_tilde divided by it, so the
//   merge takes them unchanged) and kernel 14 (the dense int8 slab: the
//   decode instance with DENSE_Q8; one scale pair a sequence, so every
//   tile of sequence b takes b's scales, and P's power of two is b's
//   latent scale's wherever the split has a key).  An int8 value is exact
//   in a 16-bit float, so the keys are converted and the page scales
//   applied in fp32 outside the products: s = (q_abs . c8) cs + (q_rope .
//   k8) rs, P c8 with P times cs before its hi / lo split, l over the
//   unscaled P (the plain version's order).  The terms are fp16, not
//   bf16: against int8
//   keys two bf16 terms (2^-18 of each product) used 0.79-1.11 of the
//   fp32 tolerance at 256 keys, two fp16 terms (2^-22) ~0.2 (PERF.md).
//   fp16's range is kept by powers of two: each query row is scaled so
//   its largest |q| lies in [2^14, 2^15) (the row is staged by one warp,
//   which takes the maximum from its registers), P times cs so the
//   largest scale of a counted page among the block's entries does, and
//   the scores and o_tilde
//   divide them out again, exactly.  Shared memory holds no third stage:
//   the room of kernel 12's two bf16 stages takes one fp16 stage (36 KB
//   at r 512) and a ring of two int8 stages (32 rows of r + rope bytes,
//   18 KB each, unswizzled; latent boxes of up to 256 columns and a rope
//   box a segment, by TMA).  Tile t + 1 lands in int8 while tile t's
//   products run; once tile t's P c_kv products are done, every thread
//   converts it into the fp16 stage (128-byte swizzle; common.cuh
//   i8x4_to_f16: byte permutes and one fp16 subtraction a pair, not the
//   conversion units), and tile t + 2's loads go to the int8 stage tile t
//   left.  The walking warp also copies
//   each segment's two page scales into the tile's map (0 for an absent
//   segment).  The second warpgroup's half of the score depth ends in the
//   rope dims: it keeps them in a second m64n32 accumulator, and each side
//   scales its sums per key column before the exchange.
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
  // the wgmma kernel's key splits: nsplit splits of `per` table entries
  // (pools) or keys (dense), their partials and counters (nsplit > 1)
  float* ws;
  int* counters;
  int nsplit, per;
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

// ---------------------------------------------------------------------
// The wgmma kernel: kernels 12 and 15 (a chunk's C*H rows as M), 10, 11,
// 13 and 14 (a sequence's heads as M) on bf16 and int8 caches and pools
// ---------------------------------------------------------------------

using bf16 = __nv_bfloat16;

constexpr int CW_ROWS = 64;      // query rows a block
constexpr int CW_KEYS = 32;      // key slots a tile
constexpr int CW_THREADS = 256;  // two consumer warpgroups
constexpr int CW_SEGS = 4;       // page segments a tile, at most (pages of 8)
// a tile's map in shared memory: whether the tile exists, its valid slots
// (bit t), its absent segments (bit g), each segment's first pool row
constexpr int CW_EXISTS = 0, CW_VALID = 1, CW_ABSENT = 2, CW_SEG0 = 3;
constexpr int CW_MAP = CW_SEG0 + CW_SEGS + 1;  // + 1: 8-byte aligned maps
// int8 pools: each segment's latent and rope scales (fp32 bits) follow
constexpr int CW_CS0 = CW_SEG0 + CW_SEGS, CW_RS0 = CW_CS0 + CW_SEGS;
constexpr int CW_MAP_Q8 = CW_RS0 + CW_SEGS + 1;

// Shared memory: 64-column blocks (128-byte rows, 128-byte swizzle) of the
// latent dims, then one of the rope dims (rope 32 fills half of each row).
// int8 pools (Q8): the two key stages' room holds one 16-bit stage (fp16
// there) and a ring of two int8 stages (TMA's; rows of r + rope bytes,
// unswizzled).
template <int R, int RP, bool Q8>
struct CwSmem {
  static constexpr int BLK = R / 64 + 1;
  static constexpr int QBLK = CW_ROWS * 128;          // 8 KB
  static constexpr int KBLK = CW_KEYS * 128;          // 4 KB
  static constexpr int QTERM = BLK * QBLK;            // q_hi, then q_lo
  static constexpr int KEYS = 2 * QTERM;              // two key stages
  static constexpr int KSTAGE = BLK * KBLK;
  static constexpr int I8STAGE = CW_KEYS * (R + RP);  // an int8 stage
  static constexpr int I8 = KEYS + KSTAGE;            // Q8: the int8 ring
  static constexpr int XCH = KEYS + 2 * KSTAGE;       // S exchange
  static constexpr int MAPS = XCH + 128 * 16 * 4;     // 3 tiles' maps
  static constexpr int MAPW = Q8 ? CW_MAP_Q8 : CW_MAP;
  static constexpr int BARS = MAPS + 3 * MAPW * 4;    // a stage's mbarrier
  // Q8: each query row's largest |q| (fp32 bits), then the largest latent
  // scale of a counted page
  static constexpr int EXT = BARS + 2 * 8;
  static constexpr int BYTES = 1024 + EXT + (Q8 ? (CW_ROWS + 1) * 4 : 0);
  static_assert(BARS % 8 == 0, "mbarriers are 8-byte aligned");
  static_assert(BYTES <= 232448, "fits a block's shared memory");
  static_assert(KSTAGE + 2 * I8STAGE <= 2 * KSTAGE, "the int8 ring fits");
};

// A key tile: up to 4 segments of consecutive rows of one page each
// (seg = min(ps, 32) rows a segment, 32 / seg segments a tile; the walk
// is common.cuh's).
using CwTile = KeyTile<CW_SEGS>;

// o (64 rows x OC columns of this warpgroup) += P . V for one 16-key slice:
// P from registers, V MN-major at `vt` (64-column blocks KBLK apart).
// F16: P and V in fp16 (kernel 15), else bf16.
template <int OC, bool F16>
__device__ __forceinline__ void pv_slice(float (&o)[OC / 2],
                                         const uint32_t (&a)[4],
                                         const unsigned char* vt, int kblk) {
  if constexpr (OC == 64) {
    wgmma_rs_n64<1, F16>(o, a, wgmma_desc(vt, kblk, 1024));
  } else {
#pragma unroll
    for (int h = 0; h < OC / 128; ++h)
      wgmma_rs_n128<1, F16>(*reinterpret_cast<float(*)[64]>(o + 64 * h), a,
                            wgmma_desc(vt + 2 * h * kblk, kblk, 1024));
  }
}

// tc, tr: the pools as (n_pages * ps, r) and (n_pages * ps, rope) row
// matrices (the dense caches as (B * T, r) and (B * T, rope)) in boxes of
// 64 columns x seg rows, 128-byte swizzle; int8 pools (Q8) in boxes of
// I8W (latent) or rope columns x seg rows, unswizzled.  Grid (B *
// ceil(H / 64), nsplit, NCOL): block (g, s, c) takes rows 64 hb .. of
// sequence b = g / ceil(H / 64) (hb = g % ceil(H / 64); rows past H
// masked), key split s and output columns c R / NCOL ..  CHUNK: the
// chunk kernels' instance (12 and 15), a chunk as one sequence of C * H
// rows over the shared table, one split, one column block, fixed at
// compile time (no split merge in the kernel).  Int8 (Q8): kernel 15
// (CHUNK) and kernel 13 (a sequence's table row) over pools, and kernel
// 14 (DENSE_Q8: the dense slab, with (B,) scales).  `dense` is fixed at
// compile time in a Q8 instance, so the instances of kernels 13 and 15
// compile as they did before kernel 14 had one (registers: PERF.md).
template <int R, int RP, bool Q8, int NCOL, bool CHUNK, bool DENSE_Q8>
__global__ void __launch_bounds__(CW_THREADS, 1)
mla_wgmma(const __grid_constant__ CUtensorMap tc,
          const __grid_constant__ CUtensorMap tr, const MlaArgs a) {
  static_assert(!CHUNK || NCOL == 1, "a chunk takes one column block");
  static_assert(!DENSE_Q8 || (Q8 && !CHUNK), "the slab is int8 decode");
  using L = CwSmem<R, RP, Q8>;
  constexpr int I8W = R < 256 ? R : 256;  // columns of an int8 latent box
  constexpr int NB8 = R / I8W + 1;        // int8 boxes a segment
  constexpr int KS = (R + RP) / 16;  // 16-deep slices of a score
  constexpr int OCB = R / NCOL;      // output columns a block
  constexpr int OC = OCB / 2;        // output columns a warpgroup
  static_assert(OC == 64 || OC % 128 == 0, "pv_slice's widths");
  constexpr int CH = (R + RP) / 8;
  extern __shared__ unsigned char cw_smem[];
  unsigned char* sm = align1024(cw_smem);
  float* xch = reinterpret_cast<float*>(sm + L::XCH);
  uint64_t* kbar = reinterpret_cast<uint64_t*>(sm + L::BARS);
  const int tid = threadIdx.x, wg = tid / 128, wt = tid % 128;
  const int warp = wt / 32, lane = tid % 32;
  const int nrb = (a.H + CW_ROWS - 1) / CW_ROWS;  // row blocks a sequence
  const int grp = blockIdx.x;
  const int b = CHUNK ? 0 : grp / nrb, hb = CHUNK ? grp : grp % nrb;
  const int split = CHUNK ? 0 : blockIdx.y, col = CHUNK ? 0 : blockIdx.z;
  const int col0 = col * OCB, S = CHUNK ? 1 : a.nsplit;
  const size_t row0 = (size_t)b * a.H + hb * CW_ROWS;
  const int nrow = min(CW_ROWS, a.H - hb * CW_ROWS);
  const bool dense = !CHUNK && (Q8 ? DENSE_Q8 : a.table == nullptr);
  const int ps = a.rows, seg = dense ? CW_KEYS : min(ps, CW_KEYS);
  const int nseg = CW_KEYS / seg;
  // the split's table entries [k0, k1) of row b (pools) or keys (dense)
  const int k0 = CHUNK ? 0 : split * a.per;
  const int k1 = CHUNK ? a.n : min(a.n, k0 + a.per);

  // Warp 0 walks the table two tiles ahead of the products into maps that
  // rotate: the tile in products, the tile in flight, the tile walked.
  int* maps = reinterpret_cast<int*>(sm + L::MAPS);
  auto map = [&](int i) { return maps + (i % 3) * L::MAPW; };
  int j = 0, po = 0;
  auto walk = [&](int i) {  // warp 0
    int* mp = map(i);
    if (dense) {
      // 32 keys of sequence b's slab (rows b T + k ..); the rows past the
      // split's keys are masked (the next sequence's, or TMA's zeros)
      const int k = k0 + i * CW_KEYS;
      const uint32_t valid = __ballot_sync(0xffffffffu, k + lane < k1);
      if (lane < CW_SEGS)
        mp[CW_SEG0 + lane] = lane == 0 && k < k1 ? b * ps + k : -1;
      if (lane == 0) {
        if constexpr (DENSE_Q8) {  // the tile's one segment: b's scales
          mp[CW_CS0] = __float_as_int(a.ckv_scale[b]);
          mp[CW_RS0] = __float_as_int(a.krope_scale[b]);
        }
        mp[CW_EXISTS] = k < k1;
        mp[CW_VALID] = (int)valid;
        mp[CW_ABSENT] = 0;
      }
      return;
    }
    const size_t t0 = (size_t)b * a.tstride + k0;
    const CwTile k = next_tile<CW_KEYS, CW_SEGS>(
        a.table + t0, a.counts + t0, max(k1 - k0, 0), ps, a.lead, seg, j,
        po);
    const uint32_t valid =
        __ballot_sync(0xffffffffu, slot_row(k, lane, seg, ps) >= 0);
    uint32_t absent = 0;
#pragma unroll
    for (int g = 0; g < CW_SEGS; ++g) {
      if (g < nseg && k.page[g] < 0) absent |= 1u << g;
      if (lane == g) {
        mp[CW_SEG0 + g] = k.page[g] >= 0 ? k.page[g] * ps + k.row0[g] : -1;
        if constexpr (Q8) {  // an absent segment's scales are 0
          const bool on = k.page[g] >= 0;
          mp[CW_CS0 + g] = __float_as_int(on ? a.ckv_scale[k.page[g]] : 0.0f);
          mp[CW_RS0 + g] =
              __float_as_int(on ? a.krope_scale[k.page[g]] : 0.0f);
        }
      }
    }
    if (lane == 0) {
      mp[CW_EXISTS] = k.page[0] >= 0;
      mp[CW_VALID] = (int)valid;
      mp[CW_ABSENT] = (int)absent;
    }
  };
  // Tile i into stage i % 2: its segments by TMA, one box a lane of warp
  // 4 (the other warpgroup walks); the absent ones (the table's end) as
  // zeros (every thread, then a proxy fence).
  auto load_tile = [&](int i) {
    const int* mp = map(i);
    const uint32_t absent = mp[CW_ABSENT];
    if constexpr (Q8) {
      // into int8 stage i % 2: latent boxes of I8W columns, then the rope
      // box, each a region of CW_KEYS rows; an absent segment is not
      // loaded (its stale bytes are finite and its slots masked)
      unsigned char* st = sm + L::I8 + (i & 1) * L::I8STAGE;
      if (tid / 32 == 4) {
        if (lane == 0)
          mbar_expect_tx(&kbar[i & 1],
                         (nseg - __popc(absent)) * seg * (R + RP));
        __syncwarp();
        for (int q = lane; q < nseg * NB8; q += 32) {
          const int g = q / NB8, b = q % NB8, r = mp[CW_SEG0 + g];
          if (r >= 0)
            tma_load_2d(b < NB8 - 1
                            ? st + b * CW_KEYS * I8W + g * seg * I8W
                            : st + CW_KEYS * R + g * seg * RP,
                        b < NB8 - 1 ? &tc : &tr, b < NB8 - 1 ? I8W * b : 0,
                        r, &kbar[i & 1]);
        }
      }
      return;
    }
    unsigned char* st = sm + L::KEYS + (i & 1) * L::KSTAGE;
    if (tid / 32 == 4) {
      if (lane == 0)
        mbar_expect_tx(&kbar[i & 1], (nseg - __popc(absent)) * seg * 128 *
                                         L::BLK);
      __syncwarp();
      for (int q = lane; q < nseg * L::BLK; q += 32) {
        const int g = q / L::BLK, b = q % L::BLK, r = mp[CW_SEG0 + g];
        if (r >= 0)
          tma_load_2d(st + b * L::KBLK + g * seg * 128,
                      b < R / 64 ? &tc : &tr, b < R / 64 ? 64 * b : 0, r,
                      &kbar[i & 1]);
      }
    }
    if (absent) {
      for (int g = 0; g < nseg; ++g) {
        if (!(absent >> g & 1)) continue;
        for (int e = tid; e < seg * L::BLK * 8; e += CW_THREADS) {
          const int b = e / (seg * 8), c = e % (seg * 8);
          *reinterpret_cast<uint4*>(st + b * L::KBLK + g * seg * 128 +
                                    c * 16) = make_uint4(0, 0, 0, 0);
        }
      }
      fence_proxy_async();
    }
  };

  // Q8: int8 stage i % 2 (tile i, landed) into the fp16 stage (the 128-
  // byte swizzle of kernel 12's stages), 16 values of a row at a time a
  // thread, then to wgmma's async proxy.  Every row is converted: int8
  // bytes are finite, so masked slots and absent segments, whose stale
  // bytes are never loaded, meet P = 0.
  auto convert = [&](int i) {
    const int8_t* st =
        reinterpret_cast<const int8_t*>(sm + L::I8 + (i & 1) * L::I8STAGE);
    for (int e = tid; e < CW_KEYS * CH / 2; e += CW_THREADS) {
      const int t = e / (CH / 2), cc = 2 * (e % (CH / 2));  // 16 values
      const int8_t* src =
          cc < R / 8
              ? st + (cc * 8 / I8W) * CW_KEYS * I8W + t * I8W + cc * 8 % I8W
              : st + CW_KEYS * R + t * RP + (cc - R / 8) * 8;
      const uint4 raw = *reinterpret_cast<const uint4*>(src);
      uint4 f[2];
      i8x4_to_f16(raw.x, f[0].x, f[0].y);
      i8x4_to_f16(raw.y, f[0].z, f[0].w);
      i8x4_to_f16(raw.z, f[1].x, f[1].y);
      i8x4_to_f16(raw.w, f[1].z, f[1].w);
      const int blk = cc < R / 8 ? cc / 8 : R / 64;
      const int c8 = cc < R / 8 ? cc % 8 : cc - R / 8;
#pragma unroll
      for (int h = 0; h < 2; ++h)
        *reinterpret_cast<uint4*>(sm + L::KEYS + blk * L::KBLK +
                                  swz128(t, c8 + h)) = f[h];
    }
    fence_proxy_async();
  };

  if (tid == 0) {
    mbar_init(&kbar[0], 1);
    mbar_init(&kbar[1], 1);
    mbar_init_fence();
  }
  int* ext = reinterpret_cast<int*>(sm + L::EXT);
  // Q8: P's power of two from the largest latent scale of the block's
  // keys: the slab's sequence scale if the split has a key (DENSE_Q8),
  // else the scan of the table below
  if (Q8 && tid == 0)
    ext[CW_ROWS] =
        DENSE_Q8 && k1 > k0 ? __float_as_int(fabsf(a.ckv_scale[b])) : 0;
  // slots past the last whole segment (pages of 24: rows 24-31) stay zero
  if constexpr (!Q8) {
    for (int e = tid; e < 2 * L::BLK * (CW_KEYS - nseg * seg) * 8;
         e += CW_THREADS) {
      const int per = (CW_KEYS - nseg * seg) * 8, blk = e / per;
      *reinterpret_cast<uint4*>(sm + L::KEYS + blk * L::KBLK +
                                nseg * seg * 128 + (e % per) * 16) =
          make_uint4(0, 0, 0, 0);
    }
  }
  if (tid < 32) {
    walk(0);
    walk(1);
  }
  __syncthreads();
  // the first key tile (Q8: the first two) flies while the queries are
  // staged
  if (map(0)[CW_EXISTS]) load_tile(0);
  if (Q8 && map(1)[CW_EXISTS]) load_tile(1);

  // the queries, times scale, as two bf16 terms (Q8: fp16 terms of each
  // row times its power of two); QB 16-byte chunks of loads in flight a
  // thread before the first is converted
  constexpr int QN = CW_ROWS * CH / CW_THREADS, QB = 9;
  static_assert(CW_ROWS * CH % CW_THREADS == 0, "whole chunks a thread");
  // Q8: the largest latent scale of a counted page of the block's own
  // entries (P's power of two): the split's [k0, k1) of row b (a chunk:
  // the whole shared row)
  if constexpr (Q8 && !DENSE_Q8) {
    const int* tb = a.table + (size_t)b * a.tstride;
    const int* cb = a.counts + (size_t)b * a.tstride;
    float cmax = 0.0f;
    for (int j = k0 + tid; j < k1; j += CW_THREADS)
      if (cb[j] > 0)
        cmax = fmaxf(cmax, fabsf(a.ckv_scale[min(max(tb[j], 0),
                                                 a.lead - 1)]));
    atomicMax(&ext[CW_ROWS], __float_as_int(cmax));
  }
  if constexpr (Q8) {
    // a warp a row (RB rows of loads in flight): the row's largest |q|
    // times scale, from the registers, sets its power of two (kept in ext
    // for the score fragments' rows)
    constexpr int RPW = CW_ROWS / (CW_THREADS / 32), RB = 2;
    constexpr int CL = (CH + 31) / 32;  // chunks a lane a row
#pragma unroll 1
    for (int q0 = 0; q0 < RPW; q0 += RB) {
      float v[RB][CL][8];
#pragma unroll
      for (int q = 0; q < RB; ++q) {
        const int r = (tid / 32) * RPW + q0 + q;
        const size_t g = row0 + r;
#pragma unroll
        for (int k = 0; k < CL; ++k) {
          const int cc = lane + 32 * k;
#pragma unroll
          for (int i = 0; i < 8; ++i) v[q][k][i] = 0.0f;
          if (cc < CH && r < nrow)
            load8(cc < R / 8 ? a.q_abs + g * R + cc * 8
                             : a.q_rope + g * RP + (cc - R / 8) * 8,
                  v[q][k]);
        }
      }
#pragma unroll
      for (int q = 0; q < RB; ++q) {
        const int r = (tid / 32) * RPW + q0 + q;
        float mx = 0.0f;
#pragma unroll
        for (int k = 0; k < CL; ++k)
#pragma unroll
          for (int i = 0; i < 8; ++i)
            mx = fmaxf(mx, fabsf(v[q][k][i] * a.scale));
        mx = warp_max(mx);
        if (lane == 0) ext[r] = __float_as_int(mx);
        const float up = pow2_up(mx);
#pragma unroll
        for (int k = 0; k < CL; ++k) {
          const int cc = lane + 32 * k;
          if (cc >= CH) break;
          uint4 hi, lo;
          uint32_t* h = reinterpret_cast<uint32_t*>(&hi);
          uint32_t* l = reinterpret_cast<uint32_t*>(&lo);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float x0 = v[q][k][2 * i] * a.scale * up;
            const float x1 = v[q][k][2 * i + 1] * a.scale * up;
            const __half2 b = __floats2half2_rn(x0, x1);
            const float2 bf = __half22float2(b);
            h[i] = *reinterpret_cast<const uint32_t*>(&b);
            l[i] = pack_f16(x0 - bf.x, x1 - bf.y);
          }
          const int blk = cc < R / 8 ? cc / 8 : R / 64;
          const int c8 = cc < R / 8 ? cc % 8 : cc - R / 8;
          const uint32_t off = blk * L::QBLK + swz128(r, c8);
          *reinterpret_cast<uint4*>(sm + off) = hi;
          *reinterpret_cast<uint4*>(sm + L::QTERM + off) = lo;
        }
      }
    }
  }
#pragma unroll 1
  for (int b0 = 0; b0 < (Q8 ? 0 : QN); b0 += QB) {
    float v[QB][8];
#pragma unroll
    for (int u = 0; u < QB; ++u) {
      const int e = tid + (b0 + u) * CW_THREADS;
      const int r = e / CH, cc = e % CH;
      const size_t g = row0 + r;
#pragma unroll
      for (int i = 0; i < 8; ++i) v[u][i] = 0.0f;
      if (b0 + u < QN && r < nrow)
        load8(cc < R / 8 ? a.q_abs + g * R + cc * 8
                         : a.q_rope + g * RP + (cc - R / 8) * 8,
              v[u]);
    }
#pragma unroll
    for (int u = 0; u < QB; ++u) {
      if (b0 + u >= QN) break;
      const int e = tid + (b0 + u) * CW_THREADS;
      const int r = e / CH, cc = e % CH;
      uint4 hi, lo;
      uint32_t* h = reinterpret_cast<uint32_t*>(&hi);
      uint32_t* l = reinterpret_cast<uint32_t*>(&lo);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float x0 = v[u][2 * i] * a.scale;
        const float x1 = v[u][2 * i + 1] * a.scale;
        const __nv_bfloat162 b = __floats2bfloat162_rn(x0, x1);
        const float2 bf = __bfloat1622float2(b);
        h[i] = *reinterpret_cast<const uint32_t*>(&b);
        l[i] = pack_bf16(x0 - bf.x, x1 - bf.y);
      }
      const int blk = cc < R / 8 ? cc / 8 : R / 64;
      const int c8 = cc < R / 8 ? cc % 8 : cc - R / 8;
      const uint32_t off = blk * L::QBLK + swz128(r, c8);
      *reinterpret_cast<uint4*>(sm + off) = hi;
      *reinterpret_cast<uint4*>(sm + L::QTERM + off) = lo;
    }
  }
  fence_proxy_async();  // the query terms, to wgmma's async proxy
  if constexpr (Q8) {
    if (map(0)[CW_EXISTS]) {
      mbar_wait(&kbar[0], 0);
      convert(0);
    }
    __syncthreads();  // tile 0 and every row's power of two are in place
  }

  // this thread's two rows of every accumulator fragment, and its 8 key
  // slots of a tile (bit 2 jb + e: slot 8 jb + 2 (lane % 4) + e)
  const int r0 = warp * 16 + lane / 4, r1 = r0 + 8;
  float m0 = REPRO_NEG_INF, m1 = REPRO_NEG_INF, l0 = 0.0f, l1 = 0.0f;
  // Q8: the powers of two of this thread's two query rows and of P (its
  // scores and o_tilde divide them out again, exactly)
  float down0 = 1.0f, down1 = 1.0f, pup = 1.0f;
  if constexpr (Q8) {
    down0 = 1.0f / pow2_up(__int_as_float(ext[r0]));
    down1 = 1.0f / pow2_up(__int_as_float(ext[r1]));
    pup = pow2_up(__int_as_float(ext[CW_ROWS]));
  }
  float o[OC / 2];
#pragma unroll
  for (int i = 0; i < OC / 2; ++i) o[i] = 0.0f;

  // Q8: the segment of each of this thread's 8 key slots (2 bits each:
  // slot 8 (b / 2) + 2 (lane % 4) + b % 2), the same for every tile
  uint32_t segs = 0;
#pragma unroll
  for (int b = 0; b < 8; ++b)
    segs |= (uint32_t)((8 * (b / 2) + 2 * (lane % 4) + b % 2) / seg) << 2 * b;

  for (int t = 0; map(t)[CW_EXISTS]; ++t) {
    // Q8: tile t is in the fp16 stage (converted at the end of iteration
    // t - 1, or before the loop)
    if constexpr (!Q8) {
      // tile t has landed; every warpgroup is done with tile t - 1's
      // stage, which tile t + 1 takes next, and with tile t - 1's map
      mbar_wait(&kbar[t & 1], (t >> 1) & 1);
      __syncthreads();
    }
    const unsigned char* kt = sm + L::KEYS + (Q8 ? 0 : (t & 1) * L::KSTAGE);

    // this warpgroup's half of the score depth, both query terms
    float s[16];
#pragma unroll
    for (int i = 0; i < 16; ++i) s[i] = 0.0f;
    fence_regs(s);
    auto slice = [&](float(&acc)[16], int ks) {
      const uint32_t qo = (ks / 4) * L::QBLK + (ks % 4) * 32;
      const uint64_t db =
          wgmma_desc(kt + (ks / 4) * L::KBLK + (ks % 4) * 32, 16, 1024);
      wgmma_ss_n32<0, Q8>(acc, wgmma_desc(sm + qo, 16, 1024), db);
      wgmma_ss_n32<0, Q8>(acc, wgmma_desc(sm + L::QTERM + qo, 16, 1024), db);
    };
    // Q8: the second warpgroup's half ends in the rope dims, whose page
    // scale differs from the latent one: a second accumulator
    float sr[Q8 ? 16 : 1];
    if constexpr (Q8) {
#pragma unroll
      for (int i = 0; i < 16; ++i) sr[i] = 0.0f;
      fence_regs(sr);
      wgmma_fence();
      if (wg == 0) {
#pragma unroll
        for (int ks = 0; ks < KS / 2; ++ks) slice(s, ks);
      } else {
#pragma unroll
        for (int ks = KS / 2; ks < R / 16; ++ks) slice(s, ks);
#pragma unroll
        for (int ks = R / 16; ks < KS; ++ks) slice(sr, ks);
      }
    } else {
      wgmma_fence();
#pragma unroll
      for (int i = 0; i < KS / 2; ++i) slice(s, wg * (KS / 2) + i);
    }
    wgmma_commit();
    // while the products run: the next tile's loads, this tile's mask
    if (!Q8 && map(t + 1)[CW_EXISTS]) load_tile(t + 1);
    const uint32_t valid = map(t)[CW_VALID];
    uint32_t ok = 0;
#pragma unroll
    for (int b = 0; b < 8; ++b)
      ok |= (valid >> (8 * (b / 2) + 2 * (lane % 4) + b % 2) & 1) << b;
    wgmma_wait<0>();
    fence_regs(s);
    if constexpr (Q8) {
      // each side's sum times its key columns' page scales, in fp32
      fence_regs(sr);
#pragma unroll
      for (int b = 0; b < 8; ++b) {
        const int i = 4 * (b / 2) + b % 2, g = segs >> 2 * b & 3;
        const float cs = __int_as_float(map(t)[CW_CS0 + g]);
        if (wg == 0) {
          s[i] *= cs * down0;
          s[i + 2] *= cs * down1;
        } else {
          const float rs = __int_as_float(map(t)[CW_RS0 + g]);
          s[i] = s[i] * (cs * down0) + sr[i] * (rs * down0);
          s[i + 2] = s[i + 2] * (cs * down1) + sr[i + 2] * (rs * down1);
        }
      }
    }

    // the two halves, added on both sides in the same fp32 sum
    if (wg == 1) {
#pragma unroll
      for (int i = 0; i < 16; ++i) xch[i * 128 + wt] = s[i];
    }
    bar_sync(2, CW_THREADS);
    if (wg == 0) {
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        const float other = xch[i * 128 + wt];
        xch[i * 128 + wt] = s[i];
        s[i] += other;
      }
    }
    bar_sync(2, CW_THREADS);
    if (wg == 1) {
#pragma unroll
      for (int i = 0; i < 16; ++i) s[i] += xch[i * 128 + wt];
    }

    // mask the empty slots, online softmax in fp32
    float mx0 = m0, mx1 = m1;
#pragma unroll
    for (int b = 0; b < 8; ++b) {
      const int i = 4 * (b / 2) + b % 2;
      if (!(ok >> b & 1)) {
        s[i] = REPRO_NEG_INF;
        s[i + 2] = REPRO_NEG_INF;
      }
      mx0 = fmaxf(mx0, s[i]);
      mx1 = fmaxf(mx1, s[i + 2]);
    }
    mx0 = quad_max(mx0);
    mx1 = quad_max(mx1);
    const float c0 = __expf(m0 - mx0), c1 = __expf(m1 - mx1);
    m0 = mx0;
    m1 = mx1;
    l0 *= c0;
    l1 *= c1;
    if (!__all_sync(0xffffffffu, c0 == 1.0f && c1 == 1.0f)) {
#pragma unroll
      for (int i = 0; i < OC / 8; ++i) {
        o[4 * i] *= c0;
        o[4 * i + 1] *= c0;
        o[4 * i + 2] *= c1;
        o[4 * i + 3] *= c1;
      }
    }
    // P = exp(s - m), split into bf16 hi + lo A fragments: keys 16 kc ..
    // + 15 are the accumulator's column blocks 2 kc and 2 kc + 1
    uint32_t ph[2][4], pl[2][4];
#pragma unroll
    for (int jb = 0; jb < 4; ++jb) {
      float p[4];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const bool in = ok >> (2 * jb + e) & 1;
        p[e] = in ? __expf(s[4 * jb + e] - m0) : 0.0f;
        p[2 + e] = in ? __expf(s[4 * jb + 2 + e] - m1) : 0.0f;
      }
      l0 += p[0] + p[1];
      l1 += p[2] + p[3];
      if constexpr (Q8) {
        // the latent scale (times P's power of two) rides on P, after l;
        // fp16 terms
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float cs =
              __int_as_float(map(t)[CW_CS0 + (segs >> 2 * (2 * jb + e) & 3)]) *
              pup;
          p[e] *= cs;
          p[2 + e] *= cs;
        }
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const __half2 b = __floats2half2_rn(p[2 * h], p[2 * h + 1]);
          const float2 bf = __half22float2(b);
          ph[jb / 2][(jb % 2) * 2 + h] =
              *reinterpret_cast<const uint32_t*>(&b);
          pl[jb / 2][(jb % 2) * 2 + h] =
              pack_f16(p[2 * h] - bf.x, p[2 * h + 1] - bf.y);
        }
        continue;
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const __nv_bfloat162 b = __floats2bfloat162_rn(p[2 * h], p[2 * h + 1]);
        const float2 bf = __bfloat1622float2(b);
        ph[jb / 2][(jb % 2) * 2 + h] = *reinterpret_cast<const uint32_t*>(&b);
        pl[jb / 2][(jb % 2) * 2 + h] =
            pack_bf16(p[2 * h] - bf.x, p[2 * h + 1] - bf.y);
      }
    }
    fence_regs(o);
    wgmma_fence();
#pragma unroll
    for (int kc = 0; kc < 2; ++kc) {
      const unsigned char* vt =
          kt + (col0 / 64 + wg * (OC / 64)) * L::KBLK + kc * 16 * 128;
      pv_slice<OC, Q8>(o, ph[kc], vt, L::KBLK);
      pv_slice<OC, Q8>(o, pl[kc], vt, L::KBLK);
    }
    wgmma_commit();
    // while these products run: the walk of tile t + 2
    if (tid < 32) walk(t + 2);
    wgmma_wait<0>();
    fence_regs(o);
    if constexpr (Q8) {
      // every warpgroup is done with the fp16 stage and tile t + 2 is
      // walked: tile t + 2 into tile t's int8 stage (converted before
      // this iteration), tile t + 1 from its int8 stage into the fp16 one
      __syncthreads();
      if (map(t + 2)[CW_EXISTS]) load_tile(t + 2);
      if (map(t + 1)[CW_EXISTS]) {
        mbar_wait(&kbar[(t + 1) & 1], ((t + 1) >> 1) & 1);
        convert(t + 1);
        __syncthreads();
      }
    }
  }

  // o_tilde through the idle query blocks (fp32 rows of the block's OCB
  // columns, padded by 4), then whole rows out with 16-byte stores: to the
  // outputs (one split) or to this split's partial (OCB columns a row)
  constexpr int OLD = OCB + 4;
  static_assert(CW_ROWS * OLD * 4 <= 2 * L::QTERM, "o fits the query area");
  float* os = reinterpret_cast<float*>(sm);
  __syncthreads();  // every warpgroup is done reading the queries
  const float odown = 1.0f / pup;   // Q8: P's power of two, out again
#pragma unroll
  for (int i = 0; i < OC / 8; ++i) {
    const int c = wg * OC + 8 * i + 2 * (lane % 4);
    *reinterpret_cast<float2*>(os + r0 * OLD + c) =
        make_float2(o[4 * i] * odown, o[4 * i + 1] * odown);
    *reinterpret_cast<float2*>(os + r1 * OLD + c) =
        make_float2(o[4 * i + 2] * odown, o[4 * i + 3] * odown);
  }
  l0 = quad_sum(l0);
  l1 = quad_sum(l1);
  const size_t cg = (size_t)grp * NCOL + col;  // the row group's columns
  const size_t n_parts = (size_t)gridDim.x * NCOL * S;
  float* m_ws = a.ws + n_parts * CW_ROWS * OCB;
  float* l_ws = m_ws + n_parts * CW_ROWS;
  const size_t part = cg * S + split;
  float* o_dst =
      S == 1 ? a.o_t + row0 * R + col0 : a.ws + part * CW_ROWS * OCB;
  const int ld = S == 1 ? R : OCB;
  // one split: every column block has the same m and l, the first writes
  if (wg == 0 && lane % 4 == 0 && (S > 1 || col == 0)) {
    float* m_dst = S == 1 ? a.m + row0 : m_ws + part * CW_ROWS;
    float* l_dst = S == 1 ? a.l + row0 : l_ws + part * CW_ROWS;
    if (r0 < nrow) {
      m_dst[r0] = m0;
      l_dst[r0] = l0;
    }
    if (r1 < nrow) {
      m_dst[r1] = m1;
      l_dst[r1] = l1;
    }
  }
  __syncthreads();
  for (int e = tid; e < CW_ROWS * (OCB / 4); e += CW_THREADS) {
    const int r = e / (OCB / 4), c = 4 * (e % (OCB / 4));
    if (r < nrow)
      *reinterpret_cast<float4*>(o_dst + (size_t)r * ld + c) =
          *reinterpret_cast<const float4*>(os + r * OLD + c);
  }
  if (S == 1) return;
  // the row group's last split merges the partials of its columns in
  // split order (each column block's last block writes the same m, l)
  if (!last_split(&a.counters[cg], S, CW_THREADS)) return;
  finish_partials(a.ws + cg * S * CW_ROWS * OCB, m_ws + cg * S * CW_ROWS,
                  l_ws + cg * S * CW_ROWS, S, (size_t)CW_ROWS * OCB, CW_ROWS,
                  nrow, OCB, a.o_t + row0 * R + col0, a.m + row0, a.l + row0,
                  &a.counters[cg], reinterpret_cast<float*>(sm + L::KEYS),
                  tid, CW_THREADS, R);
}

template <int R, int RP, bool Q8, int NCOL, bool CHUNK, bool DENSE_Q8>
int launch_wgmma(const MlaArgs& a, cudaStream_t stream) {
  using L = CwSmem<R, RP, Q8>;
  const int seg = a.table == nullptr ? CW_KEYS
                  : a.rows < CW_KEYS ? a.rows : CW_KEYS;
  CUtensorMap tc, tr;
  int e = Q8 ? encode_rows_i8(&tc, a.ckv, a.lead * a.rows, R, seg,
                              R < 256 ? R : 256)
             : encode_rows(&tc, a.ckv, a.lead * a.rows, R, seg);
  if (e != 0) return e;
  e = Q8 ? encode_rows_i8(&tr, a.krope, a.lead * a.rows, RP, seg, RP)
         : encode_rows(&tr, a.krope, a.lead * a.rows, RP, seg);
  if (e != 0) return e;
  e = smem_limit_once<mla_wgmma<R, RP, Q8, NCOL, CHUNK, DENSE_Q8>>(
      L::BYTES);
  if (e != 0) return e;
  const dim3 grid(a.B * ((a.H + CW_ROWS - 1) / CW_ROWS), a.nsplit, NCOL);
  mla_wgmma<R, RP, Q8, NCOL, CHUNK, DENSE_Q8>
      <<<grid, CW_THREADS, L::BYTES, stream>>>(tc, tr, a);
  return (int)cudaGetLastError();
}

// The instance for rope and the column blocks (the decode kernels only:
// NCOL 2 at r >= 256, 4 at r 512, so that a warpgroup owns >= 64
// columns).
template <int R, bool Q8, bool CHUNK, bool DQ>
int launch_wgmma_rope(const MlaArgs& a, int rope, int ncol,
                      cudaStream_t stream) {
  if (rope != 32 && rope != 64) return (int)cudaErrorInvalidValue;
  const bool r32 = rope == 32;
  if (ncol == 1)
    return r32 ? launch_wgmma<R, 32, Q8, 1, CHUNK, DQ>(a, stream)
               : launch_wgmma<R, 64, Q8, 1, CHUNK, DQ>(a, stream);
  if constexpr (!CHUNK && R >= 256) {
    if (ncol == 2)
      return r32 ? launch_wgmma<R, 32, Q8, 2, CHUNK, DQ>(a, stream)
                 : launch_wgmma<R, 64, Q8, 2, CHUNK, DQ>(a, stream);
  }
  if constexpr (!CHUNK && R >= 512) {
    if (ncol == 4)
      return r32 ? launch_wgmma<R, 32, Q8, 4, CHUNK, DQ>(a, stream)
                 : launch_wgmma<R, 64, Q8, 4, CHUNK, DQ>(a, stream);
  }
  return (int)cudaErrorInvalidValue;
}

// DQ: the dense int8 slab's instance (kernel 14, DENSE_Q8)
template <bool Q8, bool CHUNK, bool DQ = false>
int launch_wgmma_r(const MlaArgs& a, int r, int rope, int ncol,
                   cudaStream_t stream) {
  switch (r) {
    case 128:
      return launch_wgmma_rope<128, Q8, CHUNK, DQ>(a, rope, ncol, stream);
    case 256:
      return launch_wgmma_rope<256, Q8, CHUNK, DQ>(a, rope, ncol, stream);
    case 512:
      return launch_wgmma_rope<512, Q8, CHUNK, DQ>(a, rope, ncol, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The chunk kernels' wgmma variant: the chunk's C x H rows as one
// sequence, one split, the pools' page size (`rows`) a multiple of 8.
template <bool Q8>
int launch_chunk(const MlaArgs& a, int r, int rope, cudaStream_t stream) {
  if (a.lead <= 0 || a.rows < 8 || a.rows % 8 != 0 || a.n < 0)
    return (int)cudaErrorInvalidValue;
  if (a.B <= 0 || a.H <= 0) return 0;
  MlaArgs c = a;
  c.H = a.B * a.H;
  c.B = 1;
  c.tstride = 0;
  c.nsplit = 1;
  c.per = a.n > 0 ? a.n : 1;
  return launch_wgmma_r<Q8, true>(c, r, rope, 1, stream);
}

// Kernels 10, 11, 13 and 14's wgmma variant: the plan's checks (nsplit
// splits of `per` keys or table entries covering the n of them, none
// starting at or past n, at most FIN_SPLITS; a workspace and counters when
// they split; pages of a multiple of 8 rows; int8 (a.ckv_scale set) with
// both scales), then the instance: int8 over pools (13) or the slab (14).
int launch_decode(const MlaArgs& a, int r, int rope, int ncol,
                  cudaStream_t stream) {
  const bool dense = a.table == nullptr;
  const bool q8 = a.ckv_scale != nullptr;
  if ((q8 && a.krope_scale == nullptr) || a.lead <= 0 ||
      a.rows <= 0 || a.n < 0 || a.nsplit < 1 ||
      a.nsplit > FIN_SPLITS || a.per < 1 ||
      (long long)a.nsplit * a.per < a.n ||
      (a.nsplit > 1 && ((long long)(a.nsplit - 1) * a.per >= a.n ||
                        a.ws == nullptr || a.counters == nullptr)) ||
      (!dense && (a.rows < 8 || a.rows % 8 != 0)))
    return (int)cudaErrorInvalidValue;
  if (a.B <= 0 || a.H <= 0) return 0;
  if (!q8) return launch_wgmma_r<false, false>(a, r, rope, ncol, stream);
  return dense ? launch_wgmma_r<true, false, true>(a, r, rope, ncol, stream)
               : launch_wgmma_r<true, false>(a, r, rope, ncol, stream);
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

// Kernels 10 and 11 on bf16 caches and pools, the wgmma variant: the
// operands of vwr_mla_flash_decode_launch / vwr_mla_paged_flash_decode_launch
// (bf16; r in {128, 256, 512}, rope in {32, 64}; pages of a multiple of 8
// rows), plus the plan (kernels/vwr_mla_decode.py mla_decode_plan): nsplit
// splits of `per` keys (dense) or table entries (pools) and ncol column
// blocks (1; 2 at r >= 256; 4 at r 512).  ws: B * ceil(H / 64) * nsplit *
// 64 * (r + 2 ncol) fp32 (the partials; unused at one split); counters: B
// * ceil(H / 64) * ncol int32, zero, left zero.
extern "C" int vwr_mla_flash_decode_wgmma_launch(
    const void* q_abs, const void* q_rope, const void* ckv, const void* krope,
    void* o_t, void* m, void* l, void* ws, void* counters, int B, int H,
    int r, int rope, int lead, int rows, int n_keys, int nsplit, int per,
    int ncol, float scale, void* stream) {
  const MlaArgs a{(const float*)q_abs, (const float*)q_rope, ckv, krope,
                  nullptr, nullptr, nullptr, nullptr, (float*)o_t,
                  (float*)m, (float*)l, B, H, lead, rows, n_keys, scale, 0,
                  (float*)ws, (int*)counters, nsplit, per};
  if (lead != B) return (int)cudaErrorInvalidValue;
  return launch_decode(a, r, rope, ncol, (cudaStream_t)stream);
}

extern "C" int vwr_mla_paged_flash_decode_wgmma_launch(
    const void* q_abs, const void* q_rope, const void* ckv, const void* krope,
    const void* table, const void* counts, void* o_t, void* m, void* l,
    void* ws, void* counters, int B, int H, int r, int rope, int lead,
    int rows, int J, int nsplit, int per, int ncol, float scale,
    void* stream) {
  const MlaArgs a{(const float*)q_abs, (const float*)q_rope, ckv, krope,
                  nullptr, nullptr, (const int*)table, (const int*)counts,
                  (float*)o_t, (float*)m, (float*)l, B, H, lead, rows, J,
                  scale, J, (float*)ws, (int*)counters, nsplit, per};
  return launch_decode(a, r, rope, ncol, (cudaStream_t)stream);
}

// Kernel 14's wgmma variant: the operands of
// vwr_mla_flash_decode_q8_launch (r in {128, 256, 512}, rope in {32, 64})
// with the plan, workspace and counters of
// vwr_mla_flash_decode_wgmma_launch.
extern "C" int vwr_mla_flash_decode_q8_wgmma_launch(
    const void* q_abs, const void* q_rope, const void* ckv, const void* krope,
    const void* ckv_scale, const void* krope_scale, void* o_t, void* m,
    void* l, void* ws, void* counters, int B, int H, int r, int rope,
    int lead, int rows, int n_keys, int nsplit, int per, int ncol,
    float scale, void* stream) {
  if (ckv_scale == nullptr || krope_scale == nullptr || lead != B)
    return (int)cudaErrorInvalidValue;
  const MlaArgs a{(const float*)q_abs, (const float*)q_rope, ckv, krope,
                  (const float*)ckv_scale, (const float*)krope_scale,
                  nullptr, nullptr, (float*)o_t, (float*)m, (float*)l, B, H,
                  lead, rows, n_keys, scale, 0, (float*)ws, (int*)counters,
                  nsplit, per};
  return launch_decode(a, r, rope, ncol, (cudaStream_t)stream);
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

// Kernel 13's wgmma variant: the operands of
// vwr_mla_paged_flash_decode_q8_launch (r in {128, 256, 512}, rope in {32,
// 64}, pages of a multiple of 8 rows) with the plan, workspace and
// counters of vwr_mla_paged_flash_decode_wgmma_launch.
extern "C" int vwr_mla_paged_flash_decode_q8_wgmma_launch(
    const void* q_abs, const void* q_rope, const void* ckv, const void* krope,
    const void* ckv_scale, const void* krope_scale, const void* table,
    const void* counts, void* o_t, void* m, void* l, void* ws,
    void* counters, int B, int H, int r, int rope, int lead, int rows, int J,
    int nsplit, int per, int ncol, float scale, void* stream) {
  if (ckv_scale == nullptr || krope_scale == nullptr || table == nullptr)
    return (int)cudaErrorInvalidValue;
  const MlaArgs a{(const float*)q_abs, (const float*)q_rope, ckv, krope,
                  (const float*)ckv_scale, (const float*)krope_scale,
                  (const int*)table, (const int*)counts, (float*)o_t,
                  (float*)m, (float*)l, B, H, lead, rows, J, scale, J,
                  (float*)ws, (int*)counters, nsplit, per};
  return launch_decode(a, r, rope, ncol, (cudaStream_t)stream);
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

// Kernel 12 on bf16 pools, the wgmma variant: the arguments of
// vwr_mla_chunk_prefix_attend_launch; r in {128, 256, 512}, rope in {32,
// 64}, page size (`rows`) a multiple of 8.
extern "C" int vwr_mla_chunk_prefix_attend_wgmma_launch(
    const void* q_abs, const void* q_rope, const void* ckv, const void* krope,
    const void* table, const void* counts, void* o_t, void* m, void* l,
    int C, int H, int r, int rope, int lead, int rows, int J, float scale,
    int dtype, void* stream) {
  if (dtype != REPRO_BF16) return (int)cudaErrorInvalidValue;
  const MlaArgs a{(const float*)q_abs, (const float*)q_rope, ckv, krope,
                  nullptr, nullptr, (const int*)table, (const int*)counts,
                  (float*)o_t, (float*)m, (float*)l, C, H, lead, rows, J,
                  scale, 0};
  return launch_chunk<false>(a, r, rope, (cudaStream_t)stream);
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

// Kernel 15's wgmma variant: the arguments of
// vwr_mla_chunk_prefix_attend_q8_launch; r in {128, 256, 512}, rope in
// {32, 64}, page size (`rows`) a multiple of 8.
extern "C" int vwr_mla_chunk_prefix_attend_q8_wgmma_launch(
    const void* q_abs, const void* q_rope, const void* ckv, const void* krope,
    const void* ckv_scale, const void* krope_scale, const void* table,
    const void* counts, void* o_t, void* m, void* l, int C, int H, int r,
    int rope, int lead, int rows, int J, float scale, int dtype,
    void* stream) {
  const MlaArgs a{(const float*)q_abs, (const float*)q_rope, ckv, krope,
                  (const float*)ckv_scale, (const float*)krope_scale,
                  (const int*)table, (const int*)counts, (float*)o_t,
                  (float*)m, (float*)l, C, H, lead, rows, J, scale, 0};
  return launch_chunk<true>(a, r, rope, (cudaStream_t)stream);
}
