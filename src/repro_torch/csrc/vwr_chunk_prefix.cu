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
// prefix (a few hundred keys) the work is a few tens of MFLOP (~0.0003
// ms), and a launch and the memory round trips set its time.
//
// Two kernels (kernels/vwr_chunk.py chunk_variant picks one per call).
//
// bf16 pools (chunk_wgmma; kernel 6's "wgmma" variant, pages of a multiple
// of 8 rows): kernel 3's GQA packing over kernel 12's page walk.
//   Rows.  The chunk's C * G query rows of one KV head in q's own order,
//   64 a block as wgmma's M (tinyllama's chunk: 8 tokens x 8 heads; qwen,
//   G 1: 64 tokens); rows past C * G are zeros and never stored.  Q is
//   staged once by cp.async in the 128-byte swizzle; D 32 is zero-filled to
//   64 columns, D 128 takes two 64-column blocks.
//   Keys.  Every thread walks the split's table entries alike (common.cuh
//   next_tile): a 64-key tile holds 64 / ps whole pages (ps <= 64) or 64
//   rows of a larger page; count-0 pages are skipped before any pool byte
//   is read; entries are clamped to [0, n_pages); slots past a page's count
//   are masked per key (a partial page may sit mid-table) and zero-filled.
//   Segments come in by cp.async, two stages: the next tile loads while
//   this one multiplies.
//   Products.  S = Q K^T is a wgmma m64n64k16 with both operands in shared
//   memory (exact products: q and the pools are bf16); the fp32 online
//   softmax runs on the fragment; P is split into two bf16 terms (hi,
//   lo = bf16(p - hi)) as the register A operand of O += P V (V MN-major,
//   the transpose bit), ~2^-17 a weight, inside the 1e-4 limit.
//   Filling the card.  The grid is (ceil(C G / 64), nsplit, KV): the table
//   is cut into nsplit splits of whole tiles (kernels/vwr_chunk.py
//   chunk_plan: near 4 blocks an SM, measured), each split's partial goes
//   to a workspace and the row group's last block merges them in split
//   order (common.cuh finish_partials, kernel 4's merge), one launch,
//   bitwise reproducible.
//
// int8 pools (kernel 8's "wgmma" variant; the same kernel, Q8): an int8
// value is exact in bf16, so the tile's products stay exact and the page
// scales are applied in fp32 around them, as the TPU kernel applies them
// after its dots.  Each tile's int8 K and V rows land by cp.async in a
// ring of two int8 stages (the next tile loads while this one runs), with
// the tile's per-slot page scales (4-byte cp.async, 0 in a masked slot);
// the block then converts the tile exactly into one bf16 K and one V tile
// in the 128-byte swizzle (common.cuh i8x16_to_16bit: byte permutes and
// one fp32 subtraction a value, no conversion unit) before its products.
// Each score column takes scale times its page's k scale after the
// product; l sums the unscaled P, and P takes its column's v scale before
// its split into two bf16 terms (the CPU emulation: 0.15-0.31 of the 1e-4
// limit, so kernel 15's fp16 terms and powers of two are not needed).  At
// D <= 64 the instance is held to 128 registers (4 blocks an SM, as kernel
// 6's): at 136 it fit 3 and ran a 124-page table's 16 splits in two waves.
//
// fp32 pools (chunk_prefix_kernel; "fma") and pages off 8, over either
// pool: the TPU kernel's wide staging — each page is staged once for
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
// Known limits: the wgmma variant re-walks the table in every thread and
// stages by cp.async (no TMA), and a split's merge costs ~2 us; at 124
// prior pages it runs at ~3.5% of its bound.  On int8 pools the tile's
// conversion runs between its landing and its products, not beside the
// previous tile's.  The FMA kernel runs the dots
// on the CUDA cores in fp32, and one KV head's C*G rows make ceil(C*G /
// 32) blocks.
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


// ---- bf16 pools: wgmma, 64 chunk rows a block, key tiles split across
// blocks ----

using bf16 = __nv_bfloat16;
constexpr int CW_ROWS = 64;     // query rows a block (wgmma's M)
constexpr int CW_KEYS = 64;     // key slots a tile
constexpr int CW_THREADS = 128; // one warpgroup
constexpr int CW_SEGS = 8;      // page segments a tile, at most (pages of 8)

// Shared memory, in 64-row x 64-column bf16 blocks of 8 KB (128-byte rows,
// 128-byte swizzle; DP = D rounded up to 64): Q, then K and V, two stages
// each.  Q8 (kernel 8): Q, one bf16 K and one V stage, then a ring of two
// int8 stages (a tile's K and V rows, D bytes a row, unswizzled) and two
// stages of the tile's per-slot scales (k, then v: 64 floats each).  After
// the key loop the K and V tiles' first 2 TILE bytes hold the merge's
// weights.
template <int D, bool Q8>
struct CwSmem {
  static constexpr int DP = D < 64 ? 64 : D;
  static constexpr int TILE = (DP / 64) * 8192;
  static constexpr int Q = 0, K = TILE, V = (Q8 ? 2 : 3) * TILE;
  static constexpr int I8 = CW_KEYS * D;        // an int8 K or V tile
  static constexpr int RING = (Q8 ? 3 : 5) * TILE;
  static constexpr int SC = RING + (Q8 ? 4 * I8 : 0);
  static constexpr int BYTES = 1024 + SC + (Q8 ? 2 * 2 * CW_KEYS * 4 : 0);
};

// Byte offset of 16-byte chunk c of row r in a 64-row tile.
__device__ __forceinline__ uint32_t cw_chunk(int r, int c) {
  return (uint32_t)((c / 8) * 8192) + swz128(r, c % 8);
}

template <int DP>
__device__ __forceinline__ void cw_pv(float (&o)[DP / 2],
                                      const uint32_t (&a)[4], uint64_t db);
template <>
__device__ __forceinline__ void cw_pv<64>(float (&o)[32],
                                          const uint32_t (&a)[4],
                                          uint64_t db) {
  wgmma_rs_n64<1>(o, a, db);
}
template <>
__device__ __forceinline__ void cw_pv<128>(float (&o)[64],
                                           const uint32_t (&a)[4],
                                           uint64_t db) {
  wgmma_rs_n128<1>(o, a, db);
}

// grid (ceil(CG / 64), nsplit, KV): block (rb, s, kvh) takes q rows rb * 64
// .. + 63 of KV head kvh against table entries [s jps, (s + 1) jps).  Q8:
// int8 pools with (n_pages, KV) scales (kernel 8).
template <int D, bool Q8>
__global__ void __launch_bounds__(CW_THREADS, Q8 && D <= 64 ? 4 : 1)
chunk_wgmma(const ChunkArgs a, float* __restrict__ ws,
            int* __restrict__ counters, int jps) {
  using L = CwSmem<D, Q8>;
  using TP = std::conditional_t<Q8, int8_t, bf16>;
  constexpr int DP = L::DP;
  constexpr int NC = DP / 8;   // 16-byte chunks a staged bf16 row
  constexpr int NI = D / 16;   // 16-byte chunks an int8 row
  extern __shared__ unsigned char cw_smem[];
  unsigned char* sm = align1024(cw_smem);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int rb = blockIdx.x, split = blockIdx.y, kvh = blockIdx.z;
  const int RB = gridDim.x, S = gridDim.y;
  const int row0 = rb * CW_ROWS, nq = min(CW_ROWS, a.CG - row0);
  const size_t prow = (size_t)a.KV * D;  // pool key-row stride
  const TP* kpool = static_cast<const TP*>(a.k_pool) + (size_t)kvh * D;
  const TP* vpool = static_cast<const TP*>(a.v_pool) + (size_t)kvh * D;
  const bf16* qb =
      static_cast<const bf16*>(a.q) + ((size_t)kvh * a.CG + row0) * D;
  const int ps = a.ps, seg = min(ps, CW_KEYS);
  const int j_end = min(a.J, (split + 1) * jps);
  int j = split * jps, po = 0;  // the walk's cursor (every thread walks)

  // the chunk rows, zero past nq and past D
  for (int e = tid; e < CW_ROWS * NC; e += CW_THREADS) {
    const int r = e / NC, c = e % NC;
    const bool ok = r < nq && c * 8 < D;
    cp_async16(sm + L::Q + cw_chunk(r, c), ok ? qb + (size_t)r * D + c * 8
                                              : qb, ok);
  }
  // the next key tile of the split into stage `buf` (zeros in its masked
  // slots; Q8: its int8 rows and its slots' page scales, 0 where masked);
  // returns its valid slots (bit t), or 0 when no keys are left
  float* scales = reinterpret_cast<float*>(sm + L::SC);  // [buf][k|v][64]
  auto stage = [&](int buf) -> uint64_t {
    const KeyTile<CW_SEGS> kt = next_tile<CW_KEYS, CW_SEGS>(
        a.table, a.counts, j_end, ps, a.n_pages, seg, j, po);
    if (kt.page[0] < 0) return 0;
    if constexpr (Q8) {
      unsigned char* st = sm + L::RING + buf * 2 * L::I8;
      for (int e = tid; e < CW_KEYS * NI; e += CW_THREADS) {
        const int r = e / NI, c = e % NI;
        const int pr = slot_row(kt, r, seg, ps);
        const size_t off = pr >= 0 ? (size_t)pr * prow + c * 16 : 0;
        cp_async16(st + r * D + c * 16, kpool + off, pr >= 0);
        cp_async16(st + L::I8 + r * D + c * 16, vpool + off, pr >= 0);
      }
      if (tid < CW_KEYS) {
        const int pr = slot_row(kt, tid, seg, ps);
        const size_t off = pr >= 0 ? (size_t)(pr / ps) * a.KV + kvh : 0;
        cp_async4(scales + buf * 2 * CW_KEYS + tid, a.k_scale + off,
                  pr >= 0);
        cp_async4(scales + buf * 2 * CW_KEYS + CW_KEYS + tid,
                  a.v_scale + off, pr >= 0);
      }
    } else {
      for (int e = tid; e < CW_KEYS * NC; e += CW_THREADS) {
        const int r = e / NC, c = e % NC;
        const int pr = slot_row(kt, r, seg, ps);
        const bool ok = pr >= 0 && c * 8 < D;
        const size_t off = ok ? (size_t)pr * prow + c * 8 : 0;
        cp_async16(sm + L::K + buf * L::TILE + cw_chunk(r, c), kpool + off,
                   ok);
        cp_async16(sm + L::V + buf * L::TILE + cw_chunk(r, c), vpool + off,
                   ok);
      }
    }
    const uint32_t lo = __ballot_sync(0xffffffffu,
                                      slot_row(kt, lane, seg, ps) >= 0);
    const uint32_t hi = __ballot_sync(0xffffffffu,
                                      slot_row(kt, lane + 32, seg, ps) >= 0);
    return (uint64_t)hi << 32 | lo;
  };
  uint64_t valid = stage(0);
  cp_async_commit();

  // this thread's two rows of the accumulator fragments
  const int r0 = warp * 16 + lane / 4, r1 = r0 + 8;
  float m0 = REPRO_NEG_INF, m1 = REPRO_NEG_INF, l0 = 0.0f, l1 = 0.0f;
  float acc[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) acc[i] = 0.0f;

  for (int t = 0; valid != 0; ++t) {
    const uint64_t next = stage((t + 1) & 1);
    if (next != 0) {
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    fence_proxy_async();
    __syncthreads();
    if constexpr (Q8) {
      // tile t from its int8 stage into the bf16 K and V tiles (exact),
      // then to wgmma's async proxy
      const unsigned char* st = sm + L::RING + (t & 1) * 2 * L::I8;
      for (int e = tid; e < CW_KEYS * NI; e += CW_THREADS) {
        const int r = e / NI, c = e % NI;
        uint4 f[2];
        i8x16_to_16bit<false>(
            *reinterpret_cast<const uint4*>(st + r * D + c * 16), f);
        *reinterpret_cast<uint4*>(sm + L::K + cw_chunk(r, 2 * c)) = f[0];
        *reinterpret_cast<uint4*>(sm + L::K + cw_chunk(r, 2 * c + 1)) = f[1];
        i8x16_to_16bit<false>(
            *reinterpret_cast<const uint4*>(st + L::I8 + r * D + c * 16), f);
        *reinterpret_cast<uint4*>(sm + L::V + cw_chunk(r, 2 * c)) = f[0];
        *reinterpret_cast<uint4*>(sm + L::V + cw_chunk(r, 2 * c + 1)) = f[1];
      }
      fence_proxy_async();
      __syncthreads();
    }
    const unsigned char* Kt = sm + L::K + (Q8 ? 0 : (t & 1) * L::TILE);
    const unsigned char* Vt = sm + L::V + (Q8 ? 0 : (t & 1) * L::TILE);
    // Q8: this tile's per-slot scales
    const float* ksc = scales + (t & 1) * 2 * CW_KEYS;
    const float* vsc = ksc + CW_KEYS;

    // S = Q K^T over the D / 16 steps that hold columns
    float s[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = 0.0f;
    fence_regs(s);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks) {
      const int off = (ks / 4) * 8192 + (ks % 4) * 32;
      wgmma_ss_n64<0>(s, wgmma_desc(sm + L::Q + off, 16, 1024),
                      wgmma_desc(Kt + off, 16, 1024));
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);

    // scale (Q8: times the slot's page k scale), mask the empty slots (per
    // key), online softmax in fp32; a tile holds a valid key, so the
    // maxima are real scores from here
    float mx0 = m0, mx1 = m1;
#pragma unroll
    for (int jb = 0; jb < 8; ++jb)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int slot = 8 * jb + 2 * (lane % 4) + e;
        const bool in = valid >> slot & 1;
        const float f = Q8 ? a.scale * ksc[slot] : a.scale;
        s[4 * jb + e] = in ? s[4 * jb + e] * f : REPRO_NEG_INF;
        s[4 * jb + 2 + e] = in ? s[4 * jb + 2 + e] * f : REPRO_NEG_INF;
        mx0 = fmaxf(mx0, s[4 * jb + e]);
        mx1 = fmaxf(mx1, s[4 * jb + 2 + e]);
      }
    mx0 = quad_max(mx0);
    mx1 = quad_max(mx1);
    const float c0 = expf(m0 - mx0), c1 = expf(m1 - mx1);
    m0 = mx0;
    m1 = mx1;
    l0 *= c0;
    l1 *= c1;
#pragma unroll
    for (int i = 0; i < DP / 8; ++i) {
      acc[4 * i] *= c0;
      acc[4 * i + 1] *= c0;
      acc[4 * i + 2] *= c1;
      acc[4 * i + 3] *= c1;
    }
    // P = exp(s - m) as two bf16 terms, the A fragments of P V: keys 16 kc
    // .. + 15 are the accumulator's column blocks 2 kc and 2 kc + 1.  Q8:
    // l sums the unscaled P, then P takes its slot's page v scale
    uint32_t ph[4][4], pl[4][4];
#pragma unroll
    for (int jb = 0; jb < 8; ++jb) {
      float p[4];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const bool in = valid >> (8 * jb + 2 * (lane % 4) + e) & 1;
        p[e] = in ? expf(s[4 * jb + e] - m0) : 0.0f;
        p[2 + e] = in ? expf(s[4 * jb + 2 + e] - m1) : 0.0f;
      }
      l0 += p[0] + p[1];
      l1 += p[2] + p[3];
      if constexpr (Q8) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float vs = vsc[8 * jb + 2 * (lane % 4) + e];
          p[e] *= vs;
          p[2 + e] *= vs;
        }
      }
      bf16_terms(p[0], p[1], ph[jb / 2][(jb % 2) * 2],
                 pl[jb / 2][(jb % 2) * 2]);
      bf16_terms(p[2], p[3], ph[jb / 2][(jb % 2) * 2 + 1],
                 pl[jb / 2][(jb % 2) * 2 + 1]);
    }
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int kc = 0; kc < 4; ++kc) {
      const uint64_t db = wgmma_desc(Vt + kc * 16 * 128, 8192, 1024);
      cw_pv<DP>(acc, ph[kc], db);
      cw_pv<DP>(acc, pl[kc], db);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
    __syncthreads();  // stage t % 2 is free for tile t + 2
    valid = next;
  }
  cp_async_wait<0>();  // the queries' copies, when no key tile came
  l0 = quad_sum(l0);
  l1 = quad_sum(l1);

  // one split: straight to the outputs; else this split's partial
  const size_t grp = (size_t)kvh * RB + rb, part = grp * S + split;
  const size_t n_parts = (size_t)a.KV * RB * S;
  float* m_ws = ws + n_parts * CW_ROWS * D;
  float* l_ws = m_ws + n_parts * CW_ROWS;
  const size_t out_row = (size_t)kvh * a.CG + row0;
  float* o_dst = S == 1 ? a.o_t + out_row * D : ws + part * CW_ROWS * D;
  float* m_dst = S == 1 ? a.m + out_row : m_ws + part * CW_ROWS;
  float* l_dst = S == 1 ? a.l + out_row : l_ws + part * CW_ROWS;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = h ? r1 : r0;
    if (r >= nq) continue;
#pragma unroll
    for (int i = 0; i < DP / 8; ++i) {
      const int col = 8 * i + 2 * (lane % 4);
      if (col < D)
        *reinterpret_cast<float2*>(o_dst + (size_t)r * D + col) =
            make_float2(acc[4 * i + 2 * h], acc[4 * i + 2 * h + 1]);
    }
    if (lane % 4 == 0) {
      m_dst[r] = h ? m1 : m0;
      l_dst[r] = h ? l1 : l0;
    }
  }
  if (S == 1) return;
  if (!last_split(&counters[grp], S, CW_THREADS)) return;
  finish_partials(ws + grp * S * CW_ROWS * D, m_ws + grp * S * CW_ROWS,
                  l_ws + grp * S * CW_ROWS, S, (size_t)CW_ROWS * D, CW_ROWS,
                  nq, D, a.o_t + out_row * D, a.m + out_row, a.l + out_row,
                  &counters[grp], reinterpret_cast<float*>(sm + L::K), tid,
                  CW_THREADS);
}

template <int D, bool Q8>
int launch_wgmma(const ChunkArgs& a, float* ws, int* counters, int nsplit,
                 int jps, cudaStream_t stream) {
  using L = CwSmem<D, Q8>;
  if (CW_ROWS * nsplit * 4 > 2 * L::TILE)
    return (int)cudaErrorInvalidValue;  // the merge's weights
  const int e = smem_limit_once<chunk_wgmma<D, Q8>>(L::BYTES);
  if (e != 0) return e;
  const dim3 grid((a.CG + CW_ROWS - 1) / CW_ROWS, nsplit, a.KV);
  chunk_wgmma<D, Q8>
      <<<grid, CW_THREADS, L::BYTES, stream>>>(a, ws, counters, jps);
  return (int)cudaGetLastError();
}

// The wgmma launch's checks of the plan (ps a multiple of 8; nsplit
// splits of jps entries covering J, none starting at or past it) and its
// dispatch on D.
template <bool Q8>
int wgmma_d(const ChunkArgs& a, void* ws, void* counters, int D,
            int nsplit, int jps, void* stream) {
  if (bad_shape(a) || a.ps % 8 != 0 || nsplit < 1 || nsplit > FIN_SPLITS ||
      jps < 1 || (long long)nsplit * jps < a.J ||
      (nsplit > 1 && ((long long)(nsplit - 1) * jps >= a.J || ws == nullptr)))
    return (int)cudaErrorInvalidValue;
  if (a.CG == 0 || a.KV == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  float* w = (float*)ws;
  int* c = (int*)counters;
  switch (D) {
    case 32: return launch_wgmma<32, Q8>(a, w, c, nsplit, jps, s);
    case 64: return launch_wgmma<64, Q8>(a, w, c, nsplit, jps, s);
    case 128: return launch_wgmma<128, Q8>(a, w, c, nsplit, jps, s);
    default: return (int)cudaErrorInvalidValue;
  }
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

// Kernel 6 on bf16 pools, on wgmma: the operands of
// vwr_chunk_prefix_attend_launch (bf16; ps a multiple of 8), plus the plan
// (kernels/vwr_chunk.py chunk_plan): nsplit splits of jps table entries,
// nsplit * jps >= J, none starting at or past J (J 0: one split).  ws:
// KV * ceil(CG / 64) * nsplit * 64 * (D + 2) fp32 (the partials; unused at
// one split); counters: KV * ceil(CG / 64) int32, zero, left zero.
extern "C" int vwr_chunk_prefix_attend_wgmma_launch(
    const void* q, const void* k_pool, const void* v_pool, const void* table,
    const void* counts, void* o_t, void* m, void* l, void* ws,
    void* counters, int CG, int J, int n_pages, int ps, int KV, int D,
    int nsplit, int jps, float scale, void* stream) {
  const ChunkArgs a{q, k_pool, v_pool, nullptr, nullptr, (const int*)table,
                    (const int*)counts, (float*)o_t, (float*)m, (float*)l,
                    CG, J, n_pages, ps, KV, scale};
  return wgmma_d<false>(a, ws, counters, D, nsplit, jps, stream);
}

// Kernel 8 on int8 pools, on wgmma: the operands of
// vwr_chunk_prefix_attend_q8_launch (bf16 q) with the wgmma launch's plan,
// workspace and counters.
extern "C" int vwr_chunk_prefix_attend_q8_wgmma_launch(
    const void* q, const void* k_pool, const void* v_pool,
    const void* k_scale, const void* v_scale, const void* table,
    const void* counts, void* o_t, void* m, void* l, void* ws,
    void* counters, int CG, int J, int n_pages, int ps, int KV, int D,
    int nsplit, int jps, float scale, void* stream) {
  const ChunkArgs a{q, k_pool, v_pool, (const float*)k_scale,
                    (const float*)v_scale, (const int*)table,
                    (const int*)counts, (float*)o_t, (float*)m, (float*)l,
                    CG, J, n_pages, ps, KV, scale};
  return wgmma_d<true>(a, ws, counters, D, nsplit, jps, stream);
}
