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
// At a decode step's few hundred keys a slot the bytes take ~0.0002 ms: a
// launch and a few round trips to memory set the time.
//
// Three kernels (kernels/vwr_decode.py paged_variant picks one per call:
// bf16 queries take the mma kernel of their pools, fp32 queries the FMA
// kernel).
//
// bf16 pools (paged_mma; kernel 5's "mma" variant): kernel 4's split
// kernel (csrc/vwr_decode.cu decode_split) over the block-table walk.
//   Grid (B * KV, nsplit), one 128-thread block a split of a (slot, KV
//   head) group's table entries (kernels/vwr_decode.py paged_plan: at most
//   2 blocks an SM in all, splits of at least 48 key slots, from the
//   table's shape alone, so a paged step stays capturable: tinyllama's
//   Scheduler tables, 32 groups x J 16 of 16, take 4 splits, 128 blocks;
//   a 2048-key table 8).  Splits are ranges of table entries, so each key
//   belongs to one split by construction; more than one split writes fp32
//   partials to a workspace that the group's last block merges in split
//   order (common.cuh last_split, finish_partials): one launch, no float
//   atomics, bitwise reproducible.
//   Keys.  A split's entries are J' * page_size logical key slots (entry
//   j, row o), walked in 64-slot tiles.  Each slot resolves its own entry:
//   masked past counts[slot, j] (a partial or count-0 page may sit
//   anywhere in the table: the sequence-sharded path passes masked
//   counts), the page clamped to [0, n_pages).  So any page size works,
//   and no thread walks the table serially.  A tile's 64-bit slot mask
//   comes from two ballots; its 16-slot slices that hold a valid key come
//   in by cp.async 16-byte copies (masked slots zero-filled) into a ring
//   of 4 stages (3 at D 128; 128-byte swizzle), so a split of up to 3
//   tiles has every tile in flight at once; a tile or a slice without a
//   valid key reads no pool byte and is skipped.
//   Products.  mma.sync.m16n8k16: the group's G rows, zero-padded to 16,
//   are the A operand, loaded once into registers; warp w scores slice w
//   of each tile with K by ldmatrix; `scale` multiplies the fp32 score;
//   masked slots get P = 0; the online softmax runs in fp32 on the
//   fragment; P is split into two bf16 terms (hi, lo = bf16(p - hi)), both
//   the A operand of O += P V with V by ldmatrix.trans (~2^-17 a weight,
//   inside the 1e-4 limit; one term, 2^-9, misses it).  The four warps'
//   partials merge in shared memory in warp order with the flash combine
//   (m > -1e30/2 guard).
//
// int8 pools with bf16 queries (paged_mma_q8; kernel 7's "mma" variant):
// paged_mma's grid, plan, per-slot walk and merge over int8 pages, staged
// as kernel 9's int8 split kernel (csrc/vwr_decode.cu decode_split_q8).
//   Each warp stages only its own 16-slot slice of each 64-slot tile: its
//   slots' 16-byte chunks of int8 rows by cp.async into a ring of 4 int8
//   stages (masked slots zero-filled) and each slot's two page scales by
//   4-byte cp.async (0 where masked); a slice without a valid key reads
//   no pool byte.  It converts the slice (common.cuh i8x16_to_16bit) into
//   the rows of one bf16 K tile and one fp16 V tile that only it reads, so
//   the key loop has no block barrier.
//   Scales.  They vary per page, so they ride on each key (common.cuh
//   sd_slice's PK form): a score column takes scale * k_scale[page, head]
//   in fp32; P, after it entered l, takes v_scale[page, head] times pup
//   before its two fp16 terms (against the fp16 values), pup the power of
//   two that brings the split's largest v scale of a counted page into
//   [2^14, 2^15), divided out of the block's merged o_tilde again.  Two
//   fp16 terms used 0.02-0.06 of the 1e-4 limit in the CPU emulation at
//   the Scheduler's table (653 keys) and at a J 128 table (up to 2,048
//   keys a slot), two bf16 terms 0.16-0.29 (PERF.md).
//
// fp32 queries (paged_decode_kernel; "fma"; chip_smoke also forces it on
// bf16 queries, the parent's kernel), over fp32 or int8 pools: the
// dense FMA kernel's (csrc/vwr_decode.cu decode_kernel) with a
// block-table walk.  One 128-thread block per (slot, KV head) query group:
// the G query heads that share the KV head read each K/V row once
// (zero-copy GQA).  A page is (page_size, KV, D) rows with the dense
// cache's KV * D row stride, so the inner loop carries over.  The TPU
// grid's sequential logical-page axis becomes a loop inside the block over
// the slot's J * page_size logical key positions, 32 at a time per warp
// (the 4 warps split the keys); a lane's key t lies in logical page j = t
// / page_size, which resolves to physical page table[slot, j] (clamped)
// and is valid iff t % page_size < counts[slot, j]; a 32-key tile with no
// valid key is skipped before any pool byte is read.  Each lane scores
// its key for all G queries with 16-byte loads of its K row (8 bf16 / 8
// fp32 / 16 int8 values), the warp keeps an fp32 online softmax per
// query, and P @ V runs over the tile's valid keys only, each lane owning
// D / 32 output dims.  On int8 pools a 32-key tile spans pages with
// different scales, so the scales are applied per key, not per tile: each
// score is (q . k) * k_scale[page, head], and each key's p is multiplied
// by v_scale[page, head] before P @ V (after it entered l), which is what
// the TPU kernel computes per page as (q . k) * ks and (p @ v) * vs.  The
// four warp partials merge in shared memory with the flash combine.
//
// Both write the unnormalized fp32 (o_tilde, m, l): a slot with no valid
// key gives m = -1e30, l = 0, o_tilde = 0.
//
// Known limits: a split's merge costs ~2 us (kernel 4's), so the plan
// keeps splits of at least three slices; at a decode step the time is a
// launch and a few memory round trips (0.014 ms at tinyllama's 8 slots on
// either pool, under half of SDPA over gathered pages; PERF.md).  The FMA
// kernel (fp32 queries) keeps one block a group: 32 blocks on 132 SMs at
// 8 slots x 4 KV heads.
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

// ---- bf16 pools: kernel 4's split kernel over the page walk ----

using bf16 = __nv_bfloat16;

// Shared memory: a ring of NST stages, each a K and a V tile of SD_TILE
// key slots in 64-column blocks of 128-byte rows with the 128-byte swizzle
// (DP = D rounded up to 64: D 32 fills half of each row), then one 64-bit
// slot mask a stage: 64 KB at D 32 / 64 (4 stages), 96 KB at D 128 (3), so
// a split of up to 3 (2) tiles has every tile in flight at once.  After
// the key loop the stages hold the four warps' partials, then the merge's
// weights.
template <int DP>
struct PmSmem {
  static constexpr int NST = DP == 128 ? 3 : 4;
  static constexpr int STAGE = (DP / 64) * SD_TILE * 128;  // K or V
  static constexpr int K = 0, V = NST * STAGE, MASK = 2 * NST * STAGE;
  static constexpr int BYTES = 1024 + MASK + NST * 8;
};

// grid (B * KV, nsplit): block (bkv, s) takes table entries [s jps,
// min(J, (s + 1) jps)) of slot b = bkv / KV, i.e. its logical keys [s jps
// ps, ...); tile i holds the split's logical keys 64 i .. + 63, and warp w
// scores slots 16 w .. + 15 of each tile.
template <int D>
__global__ void __launch_bounds__(SD_THREADS)
paged_mma(const PagedArgs a, float* __restrict__ ws,
          int* __restrict__ counters, int jps) {
  constexpr int DP = D < 64 ? 64 : D;
  using L = PmSmem<DP>;
  constexpr int NB = D / 8;  // 16-byte chunks a row
  extern __shared__ unsigned char pm_smem[];
  unsigned char* sm = align1024(pm_smem);
  uint64_t* masks = reinterpret_cast<uint64_t*>(sm + L::MASK);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int bkv = blockIdx.x, split = blockIdx.y;
  const int KV = a.KV, ps = a.ps;
  const int b = bkv / KV, kvh = bkv % KV;
  const size_t row = (size_t)KV * D;  // pool key-row stride
  const bf16* kpool = static_cast<const bf16*>(a.k_pool) + (size_t)kvh * D;
  const bf16* vpool = static_cast<const bf16*>(a.v_pool) + (size_t)kvh * D;
  const int* tb = a.table + (size_t)b * a.J;
  const int* cb = a.counts + (size_t)b * a.J;
  const int j0 = split * jps, j1 = min(a.J, j0 + jps);
  const int x0 = j0 * ps, x1 = j1 > j0 ? j1 * ps : x0;
  const int n_tiles = (x1 - x0 + SD_TILE - 1) / SD_TILE;

  // the pool row (page * ps + row in page) of the split's logical key x,
  // or -1 where it is masked: past the split, or past its page's count (a
  // count-0 page anywhere in the table masks the page); entries clamped
  // to [0, n_pages)
  auto key_row = [&](int x) -> int {
    if (x >= x1) return -1;
    const int j = x / ps, o = x - j * ps;
    if (o >= __ldg(cb + j)) return -1;
    return min(max(__ldg(tb + j), 0), a.n_pages - 1) * ps + o;
  };
  // tile i into stage i % NST: its slot mask (every warp makes the same
  // ballots; thread 0 keeps it), then the rows of the 16-slot slices that
  // hold a valid key (zeros in their masked slots); a tile without a
  // valid key reads no pool byte, and its slices are neither loaded nor
  // read
  auto stage = [&](int i) {
    const int t0 = x0 + i * SD_TILE;
    const uint32_t lo = __ballot_sync(0xffffffffu, key_row(t0 + lane) >= 0);
    const uint32_t hi =
        __ballot_sync(0xffffffffu, key_row(t0 + lane + 32) >= 0);
    const uint64_t vm = (uint64_t)hi << 32 | lo;
    if (tid == 0) masks[i % L::NST] = vm;
    unsigned char* kt = sm + L::K + (i % L::NST) * L::STAGE;
    unsigned char* vt = sm + L::V + (i % L::NST) * L::STAGE;
    for (int e = tid; e < SD_TILE * NB; e += SD_THREADS) {
      const int r = e / NB, c = e % NB;
      if ((vm >> (r / SD_SLICE * SD_SLICE) & 0xffffu) == 0) continue;
      const int pr = key_row(t0 + r);
      const bool ok = pr >= 0;
      const size_t off = ok ? (size_t)pr * row + c * 8 : 0;
      cp_async16(kt + sd_chunk(r, c), kpool + off, ok);
      cp_async16(vt + sd_chunk(r, c), vpool + off, ok);
    }
  };
  // the first NST - 1 tiles in flight (a group each, empty past n_tiles)
#pragma unroll
  for (int i = 0; i < L::NST - 1; ++i) {
    if (i < n_tiles) stage(i);
    cp_async_commit();
  }

  uint32_t qa[D / 16][4];
  sd_load_q<D>(qa, static_cast<const bf16*>(a.q) + (size_t)bkv * a.G * D,
               a.G, lane);
  SdPartial<D> w;
  for (int i = 0; i < n_tiles; ++i) {
    // tile i has landed; every warp is done with tile i - 1, whose stage
    // tile i + NST - 1 takes
    cp_async_wait<L::NST - 2>();
    __syncthreads();
    const uint64_t vm = masks[i % L::NST];
    if (i + L::NST - 1 < n_tiles) stage(i + L::NST - 1);
    cp_async_commit();
    const uint32_t valid = (uint32_t)(vm >> (warp * SD_SLICE)) & 0xffffu;
    if (valid == 0) continue;  // this warp's slice has no valid key
    sd_slice<D>(w, qa, sm + L::K + (i % L::NST) * L::STAGE,
                sm + L::V + (i % L::NST) * L::STAGE, warp * SD_SLICE, valid,
                a.scale, lane);
  }
  sd_finish<D>(w, sm, a.o_t, a.m, a.l, ws, counters, gridDim.x, bkv, split,
               gridDim.y, a.G);
}

template <int D>
int launch_mma(const PagedArgs& a, float* ws, int* counters, int nsplit,
               int jps, cudaStream_t stream) {
  constexpr int DP = D < 64 ? 64 : D;
  constexpr int smem = PmSmem<DP>::BYTES;
  static_assert(4 * 16 * D * 4 + 2 * 64 * 4 <= PmSmem<DP>::MASK,
                "the warps' partials fit the stages");
  static_assert(16 * FIN_SPLITS * 4 <= PmSmem<DP>::MASK,
                "the merge's weights fit the stages");
  if (smem > 48 * 1024) {
    const int e = smem_limit_once<paged_mma<D>>(smem);
    if (e != 0) return e;
  }
  paged_mma<D><<<dim3(a.B * a.KV, nsplit), SD_THREADS, smem, stream>>>(
      a, ws, counters, jps);
  return (int)cudaGetLastError();
}

// ---- int8 pools (kernel 7): the mma kernel, each warp staging and
// converting its own slices ----

// Shared memory: a ring of NST stages, each the int8 K and V rows of a
// 64-slot tile (D bytes a row, unswizzled), then each stage's 64 k and 64 v
// page scales (fp32, a slot's), then one K tile in bf16 and one V tile in
// fp16 in the bf16 kernel's layout (sd_chunk: DP columns, 128-byte
// swizzle).  A warp stages and converts only its own 16-slot slice of a
// tile, into the 16-bit rows that it alone reads, so the key loop has no
// block barrier.  After the loop the same bytes hold the warps' partials,
// then the merge's weights.
template <int D>
struct PmSmemQ8 {
  static constexpr int DP = D < 64 ? 64 : D;
  static constexpr int NST = 4;
  static constexpr int I8 = SD_TILE * D;  // an int8 K or V tile
  static constexpr int T16 = (DP / 64) * SD_TILE * 128;
  static constexpr int SC = 2 * NST * I8;
  static constexpr int K16 = SC + NST * 2 * SD_TILE * 4, V16 = K16 + T16;
  static constexpr int BYTES = 1024 + V16 + T16;
  static_assert(K16 % 1024 == 0, "the 16-bit tiles keep the swizzle's atoms");
};

// grid (B * KV, nsplit), as paged_mma, over int8 pools: warp w stages,
// converts and scores slots 16 w .. + 15 of each 64-slot tile.  Each
// slot's page scales come with its rows: S = Q K^T on the bf16 keys, each
// score times scale * k_scale[page, head] in fp32; P (after l) times
// v_scale[page, head] * pup before its two fp16 terms against the fp16
// values, pup the power of two that brings the split's largest counted v
// scale into [2^14, 2^15) (common.cuh pow2_up), divided out of the block's
// merged o_tilde again (exactly).
template <int D>
__global__ void __launch_bounds__(SD_THREADS)
paged_mma_q8(const PagedArgs a, float* __restrict__ ws,
             int* __restrict__ counters, int jps) {
  using L = PmSmemQ8<D>;
  constexpr int NB = D / 16;  // 16-byte int8 chunks a row
  static_assert(L::NST * 16 == 64, "a slice mask a stage in one register");
  extern __shared__ unsigned char pq_smem[];
  unsigned char* sm = align1024(pq_smem);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int bkv = blockIdx.x, split = blockIdx.y;
  const int KV = a.KV, ps = a.ps;
  const int b = bkv / KV, kvh = bkv % KV;
  const size_t row = (size_t)KV * D;  // pool key-row stride
  const int8_t* kpool = static_cast<const int8_t*>(a.k_pool) + (size_t)kvh * D;
  const int8_t* vpool = static_cast<const int8_t*>(a.v_pool) + (size_t)kvh * D;
  const int* tb = a.table + (size_t)b * a.J;
  const int* cb = a.counts + (size_t)b * a.J;
  const int j0 = split * jps, j1 = min(a.J, j0 + jps);
  const int x0 = j0 * ps, x1 = j1 > j0 ? j1 * ps : x0;
  const int n_tiles = (x1 - x0 + SD_TILE - 1) / SD_TILE;
  const int r0 = warp * SD_SLICE;  // this warp's rows of every tile
  unsigned char* k16 = sm + L::K16;
  unsigned char* v16 = sm + L::V16;
  float* scl = reinterpret_cast<float*>(sm + L::SC);

  // as paged_mma: the pool row of the split's logical key x, or -1
  auto key_row = [&](int x) -> int {
    if (x >= x1) return -1;
    const int j = x / ps, o = x - j * ps;
    if (o >= __ldg(cb + j)) return -1;
    return min(max(__ldg(tb + j), 0), a.n_pages - 1) * ps + o;
  };
  // this warp's slice of tile i into stage i % NST: its 16-bit slot mask
  // (into `masks`, 16 bits a stage), then, if it holds a valid key, the
  // slots' int8 rows (zeros where masked) and their two page scales (0
  // where masked); a slice without a valid key reads no pool byte
  uint64_t masks = 0;
  auto stage = [&](int i) {
    const int st = i % L::NST;
    const int pr = lane < SD_SLICE ? key_row(x0 + i * SD_TILE + r0 + lane)
                                   : -1;
    const uint32_t vm = __ballot_sync(0xffffffffu, pr >= 0);
    masks = (masks & ~(0xffffull << (16 * st))) | (uint64_t)vm << (16 * st);
    if (vm == 0) return;
    unsigned char* kt = sm + st * 2 * L::I8;
    for (int e = lane; e < SD_SLICE * NB; e += 32) {
      const int r = e / NB, c = e % NB;
      const int p = __shfl_sync(0xffffffffu, pr, r);
      const bool ok = p >= 0;
      const size_t off = ok ? (size_t)p * row + c * 16 : 0;
      cp_async16(kt + (r0 + r) * D + c * 16, kpool + off, ok);
      cp_async16(kt + L::I8 + (r0 + r) * D + c * 16, vpool + off, ok);
    }
    if (lane < SD_SLICE) {
      const bool ok = pr >= 0;
      const size_t si = ok ? (size_t)(pr / ps) * KV + kvh : 0;
      float* sc = scl + st * 2 * SD_TILE + r0 + lane;
      cp_async4(sc, a.k_scale + si, ok);
      cp_async4(sc + SD_TILE, a.v_scale + si, ok);
    }
  };
#pragma unroll
  for (int i = 0; i < L::NST - 1; ++i) {
    if (i < n_tiles) stage(i);
    cp_async_commit();
  }

  // P's power of two: the split's largest v scale of a counted page
  float vmax = 0.0f;
  for (int j = j0 + lane; j < j1; j += 32)
    if (__ldg(cb + j) > 0)
      vmax = fmaxf(vmax, fabsf(__ldg(
                             a.v_scale +
                             (size_t)min(max(__ldg(tb + j), 0), a.n_pages - 1) *
                                 KV +
                             kvh)));
  const float pup = pow2_up(warp_max(vmax));

  uint32_t qa[D / 16][4];
  sd_load_q<D>(qa, static_cast<const bf16*>(a.q) + (size_t)bkv * a.G * D,
               a.G, lane);
  SdPartial<D> w;
  for (int i = 0; i < n_tiles; ++i) {
    // this warp's slice of tile i has landed; its lanes are done with the
    // stage tile i + NST - 1 takes and with the 16-bit rows
    cp_async_wait<L::NST - 2>();
    __syncwarp();
    if (i + L::NST - 1 < n_tiles) stage(i + L::NST - 1);
    cp_async_commit();
    const int st = i % L::NST;
    const uint32_t valid = (uint32_t)(masks >> (16 * st)) & 0xffffu;
    if (valid == 0) continue;  // this warp's slice has no valid key
    sd_convert_q8<D>(sm + st * 2 * L::I8, L::I8, k16, v16, r0, lane);
    __syncwarp();
    const float* sc = scl + st * 2 * SD_TILE + r0;
    sd_slice<D, true, true>(w, qa, k16, v16, r0, valid, a.scale, lane, sc,
                            sc + SD_TILE, pup);
  }
  sd_finish<D>(w, sm, a.o_t, a.m, a.l, ws, counters, gridDim.x, bkv, split,
               gridDim.y, a.G, 1.0f / pup);
}

template <int D>
int launch_mma_q8(const PagedArgs& a, float* ws, int* counters, int nsplit,
                  int jps, cudaStream_t stream) {
  constexpr int smem = PmSmemQ8<D>::BYTES;
  static_assert(4 * 16 * D * 4 + 2 * 64 * 4 <= smem - 1024,
                "the warps' partials fit the stages");
  static_assert(16 * FIN_SPLITS * 4 <= smem - 1024,
                "the merge's weights fit the stages");
  if (smem > 48 * 1024) {
    const int e = smem_limit_once<paged_mma_q8<D>>(smem);
    if (e != 0) return e;
  }
  paged_mma_q8<D><<<dim3(a.B * a.KV, nsplit), SD_THREADS, smem, stream>>>(
      a, ws, counters, jps);
  return (int)cudaGetLastError();
}

bool bad_shape(const PagedArgs& a) {
  return a.G <= 0 || a.J < 0 || a.ps <= 0 || a.n_pages <= 0;
}

// The mma launches' checks of the plan (paged_plan's contract) and their
// dispatch on D: kernel 5's kernel, or kernel 7's (a.k_scale set).
int mma_d(const PagedArgs& a, void* ws, void* counters, int D, int nsplit,
          int jps, void* stream) {
  if (bad_shape(a) || a.G > 16 || nsplit < 1 || nsplit > FIN_SPLITS ||
      jps < 1 || (long long)nsplit * jps < a.J ||
      (long long)a.J * a.ps >= (1LL << 30) ||
      (nsplit > 1 && ((long long)(nsplit - 1) * jps >= a.J || ws == nullptr)))
    return (int)cudaErrorInvalidValue;
  if (a.B <= 0 || a.KV <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  float* w = (float*)ws;
  int* c = (int*)counters;
  const bool q8 = a.k_scale != nullptr;
  switch (D) {
    case 32:
      return q8 ? launch_mma_q8<32>(a, w, c, nsplit, jps, s)
                : launch_mma<32>(a, w, c, nsplit, jps, s);
    case 64:
      return q8 ? launch_mma_q8<64>(a, w, c, nsplit, jps, s)
                : launch_mma<64>(a, w, c, nsplit, jps, s);
    case 128:
      return q8 ? launch_mma_q8<128>(a, w, c, nsplit, jps, s)
                : launch_mma<128>(a, w, c, nsplit, jps, s);
    default: return (int)cudaErrorInvalidValue;
  }
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

// Kernel 5 on bf16 pools, on mma.sync: the operands of
// vwr_paged_flash_decode_launch (bf16), plus the plan
// (kernels/vwr_decode.py paged_plan): nsplit splits of jps table entries a
// (slot, KV head) group, nsplit * jps >= J, none starting at or past J (J
// 0: one split).  ws: B * KV * nsplit * G * (D + 2) fp32 (the partials;
// unused at one split); counters: B * KV int32, zero, left zero.
extern "C" int vwr_paged_flash_decode_mma_launch(
    const void* q, const void* k_pool, const void* v_pool, const void* table,
    const void* counts, void* o_t, void* m, void* l, void* ws,
    void* counters, int B, int J, int n_pages, int ps, int KV, int G, int D,
    int nsplit, int jps, float scale, void* stream) {
  const PagedArgs a{q, k_pool, v_pool, nullptr, nullptr,
                    (const int*)table, (const int*)counts, (float*)o_t,
                    (float*)m, (float*)l, B, J, n_pages, ps, KV, G, scale};
  return mma_d(a, ws, counters, D, nsplit, jps, stream);
}

// Kernel 7 on int8 pools, on mma.sync: the operands of
// vwr_paged_flash_decode_q8_launch (bf16 q) with the mma launch's plan,
// workspace and counters.
extern "C" int vwr_paged_flash_decode_q8_mma_launch(
    const void* q, const void* k_pool, const void* v_pool,
    const void* k_scale, const void* v_scale, const void* table,
    const void* counts, void* o_t, void* m, void* l, void* ws,
    void* counters, int B, int J, int n_pages, int ps, int KV, int G, int D,
    int nsplit, int jps, float scale, void* stream) {
  if (k_scale == nullptr || v_scale == nullptr)
    return (int)cudaErrorInvalidValue;
  const PagedArgs a{q, k_pool, v_pool, (const float*)k_scale,
                    (const float*)v_scale, (const int*)table,
                    (const int*)counts, (float*)o_t, (float*)m, (float*)l,
                    B, J, n_pages, ps, KV, G, scale};
  return mma_d(a, ws, counters, D, nsplit, jps, stream);
}
