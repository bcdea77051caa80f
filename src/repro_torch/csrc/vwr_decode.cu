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
// under the 295 flop/byte ridge).  The int8 cache halves those bytes.  At
// a decode step's ~150 keys the bytes take ~0.0002 ms: a launch and one
// round trip to memory set the time.
//
// Three kernels: kernels/vwr_decode.py decode_variant picks the split
// variant (decode_split on bf16 caches, decode_split_q8 on int8 ones) or
// the FMA kernel per call.
//
// bf16 caches (decode_split; kernel 4's "split" variant): grid (B * KV,
// nsplit), one 128-thread block a split of a (batch, KV head) group's
// keys (kernels/vwr_decode.py decode_plan: splits of at least 256 keys, so
// a decode step's ~150 keys take one block a group and a 2048-key cache 8).
//   Keys.  64-key K and V tiles come in by cp.async 16-byte copies into a
//   ring of 4 stages (3 at D 128; 128-byte swizzle), so a split of up to 3
//   tiles has all of them in flight at once; rows past the split's last
//   valid key are zero-filled, and the 16-key slices past it are neither
//   loaded nor read.  Warp w scores keys 16 w .. + 15 of each tile.
//   Products on the tensor cores with mma.sync.m16n8k16 (bf16 in, fp32
//   sums), not wgmma, whose 64 rows a group of G <= 16 would fill a
//   quarter of at best: the group's G rows, zero-padded to 16, are the A
//   operand, loaded once into registers; K comes by ldmatrix.  S = Q K^T
//   is exact in its products (q and k are bf16) and `scale` multiplies
//   the fp32 score; keys past the split's end are masked (P = 0).  The
//   online softmax runs in fp32 on the fragment.  P is split into two bf16
//   terms, hi = bf16(p) and lo = bf16(p - hi) (kernel 12's split), both the
//   A operand of O += P V with V by ldmatrix.trans: each weight keeps
//   ~2^-17, inside the 1e-4 limit (one term, 2^-9, misses it).
//   Merge.  The four warps' partials merge in shared memory in warp order
//   with the flash combine (m > -1e30/2 guard).  One split writes the
//   outputs; more write fp32 partials (G x D o, m, l) to a workspace, and
//   the group's last block (common.cuh last_split) merges them in split
//   order (finish_partials) and resets the group's counter: one launch,
//   no float atomics, bitwise reproducible.  The slice step and the
//   block's end are common.cuh sd_slice / sd_finish, shared with kernel
//   5's mma variant (csrc/vwr_paged_decode.cu).
//
// int8 caches with bf16 queries (decode_split_q8; kernel 9's "split"
// variant): the same grid, plan, slices and merge over int8 K and V.  An
// int8 value is exact in bf16 and in fp16, and both scales are constant
// over a group's keys, so the products stay exact and the scales commute
// with the sums: scale * k_scale multiplies the fp32 score, and v_scale
// the block's merged o_tilde (the Pallas kernel's order).  Each warp
// stages its own 16-key slice of every tile by cp.async into a ring of 4
// int8 stages (D bytes a row) and converts it (common.cuh i8x16_to_16bit,
// no conversion unit) into the rows of one bf16 K tile and one fp16 V tile
// that only it reads, so the key loop has no block barrier.  P is two fp16
// terms against the fp16 values (~2^-22 a weight, p <= 1 needing no
// scaling): two bf16 terms used 0.94 of the 1e-4 limit at 2048 int8 keys
// in the CPU emulation, fp16 0.12.
//
// fp32 caches and queries (decode_kernel; "fma"), over either cache: one
// 128-thread block per (batch, KV head) query group: the G query heads
// that share the KV head read each K/V row once (zero-copy GQA, straight
// from the native (B, T, KV, D) cache layout).  The TPU grid's sequential
// KV axis becomes a loop that stops at the last valid position (min(T,
// cur_len - pos0)), so unwritten cache rows are never read.  The block's
// 4 warps split the keys 32 at a time; each lane scores one key for all G
// queries with 16-byte loads of its K row, keeps an fp32 online softmax
// per query, and accumulates P @ V over 2 (D = 64) output dims per lane.
// The four warp partials merge in shared memory with the same flash
// combine, and the block writes the unnormalized fp32 (o_tilde, m, l) the
// decode contract returns: a row with no valid key gives m = -1e30, l =
// 0, o_tilde = 0 (both kernels).
//
// On an int8 cache the FMA kernel is the same body on the cache's element
// type: its rows load 8 int8 a lane at a time, the row's k scale
// multiplies each score after the dot, and its v scale the finished P @ V
// (the model-dtype kernel takes scales of 1).
//
// Known limits: a split's merge (fences, a counter in L2, the partials'
// round trip) costs ~2 us on the H100, more than splitting a decode
// step's ~150 keys saves, so tinyllama's batch-4 step runs 16 blocks;
// a 2048-key cache reaches ~15% of its byte bound.  The FMA kernel (fp32)
// keeps one block a group.
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


// ---- bf16 caches: split-KV across blocks on mma.sync ----

using bf16 = __nv_bfloat16;

// Shared memory: a ring of NST stages, each a K and a V tile of SD_TILE
// rows in 64-column blocks of 128-byte rows with the 128-byte swizzle (DP
// = D rounded up to 64: D 32 fills half of each row): 64 KB at D 32 / 64
// (4 stages), 96 KB at D 128 (3), so a split of up to 3 (2) tiles has
// every tile in flight at once.  After the key loop the same bytes hold
// the four warps' partials, then the merge's weights.
template <int DP>
struct SpSmem {
  static constexpr int NST = DP == 128 ? 3 : 4;
  static constexpr int STAGE = (DP / 64) * SD_TILE * 128;  // K or V
  static constexpr int K = 0, V = NST * STAGE;
  static constexpr int BYTES = 1024 + 2 * NST * STAGE;
};

// grid (B * KV, nsplit): block (bkv, s) takes keys [s kps, min(n_keys,
// (s + 1) kps)) of its group; warp w scores keys 16 w .. + 15 of each
// 64-key tile.
template <int D>
__global__ void __launch_bounds__(SD_THREADS)
decode_split(const bf16* __restrict__ q, const bf16* __restrict__ k,
             const bf16* __restrict__ v, float* __restrict__ o_t,
             float* __restrict__ m_out, float* __restrict__ l_out,
             float* __restrict__ ws, int* __restrict__ counters, int T_len,
             int KV, int G, int n_keys, int kps, float scale) {
  constexpr int DP = D < 64 ? 64 : D;
  using L = SpSmem<DP>;
  constexpr int NB = D / 8;  // 16-byte chunks a row
  extern __shared__ unsigned char sp_smem[];
  unsigned char* sm = align1024(sp_smem);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int bkv = blockIdx.x, split = blockIdx.y;
  const int b = bkv / KV, kvh = bkv % KV;
  const size_t row = (size_t)KV * D;
  const bf16* kb = k + (size_t)b * T_len * row + (size_t)kvh * D;
  const bf16* vb = v + (size_t)b * T_len * row + (size_t)kvh * D;
  const int k0 = split * kps, k1 = min(n_keys, k0 + kps);
  const int n_tiles = k1 > k0 ? (k1 - k0 + SD_TILE - 1) / SD_TILE : 0;

  // tile i into stage i % NST: the rows of the slices that hold a valid
  // key (zeros past k1; the slices past them are not read)
  auto stage = [&](int i) {
    const int t0 = k0 + i * SD_TILE;
    const int rows =
        min(SD_TILE, (k1 - t0 + SD_SLICE - 1) / SD_SLICE * SD_SLICE);
    unsigned char* kt = sm + L::K + (i % L::NST) * L::STAGE;
    unsigned char* vt = sm + L::V + (i % L::NST) * L::STAGE;
    for (int e = tid; e < rows * NB; e += SD_THREADS) {
      const int r = e / NB, c = e % NB;
      const bool ok = t0 + r < k1;
      const size_t off = ok ? (size_t)(t0 + r) * row + c * 8 : 0;
      cp_async16(kt + sd_chunk(r, c), kb + off, ok);
      cp_async16(vt + sd_chunk(r, c), vb + off, ok);
    }
  };
  // the first NST - 1 tiles in flight (a group each, empty past n_tiles)
#pragma unroll
  for (int i = 0; i < L::NST - 1; ++i) {
    if (i < n_tiles) stage(i);
    cp_async_commit();
  }

  uint32_t qa[D / 16][4];
  sd_load_q<D>(qa, q + (size_t)bkv * G * D, G, lane);
  SdPartial<D> w;
  for (int i = 0; i < n_tiles; ++i) {
    // tile i has landed; every warp is done with tile i - 1, whose stage
    // tile i + NST - 1 takes
    cp_async_wait<L::NST - 2>();
    __syncthreads();
    if (i + L::NST - 1 < n_tiles) stage(i + L::NST - 1);
    cp_async_commit();
    const int s0 = k0 + i * SD_TILE + warp * SD_SLICE;  // this warp's slice
    if (s0 >= k1) continue;
    const uint32_t valid =
        k1 - s0 >= SD_SLICE ? 0xffffu : (1u << (k1 - s0)) - 1u;
    sd_slice<D>(w, qa, sm + L::K + (i % L::NST) * L::STAGE,
                sm + L::V + (i % L::NST) * L::STAGE, warp * SD_SLICE, valid,
                scale, lane);
  }
  sd_finish<D>(w, sm, o_t, m_out, l_out, ws, counters, gridDim.x, bkv,
               split, gridDim.y, G);
}

template <int D>
int launch_split(const DecodeArgs& a, float* ws, int* counters, int nsplit,
                 int kps, cudaStream_t stream) {
  constexpr int DP = D < 64 ? 64 : D;
  constexpr int smem = SpSmem<DP>::BYTES;
  static_assert(4 * 16 * D * 4 + 2 * 64 * 4 <= smem - 1024,
                "the warps' partials fit the stages");
  static_assert(16 * FIN_SPLITS * 4 <= smem - 1024,
                "the merge's weights fit the stages");
  if (smem > 48 * 1024) {
    const int e = smem_limit_once<decode_split<D>>(smem);
    if (e != 0) return e;
  }
  decode_split<D><<<dim3(a.B * a.KV, nsplit), SD_THREADS, smem, stream>>>(
      (const bf16*)a.q, (const bf16*)a.k, (const bf16*)a.v, (float*)a.o_t,
      (float*)a.m, (float*)a.l, ws, counters, a.T_len, a.KV, a.G, a.n_keys,
      kps, a.scale);
  return (int)cudaGetLastError();
}

// ---- int8 caches (kernel 9): the split kernel, each warp staging and
// converting its own slices ----

// Shared memory: a ring of NST stages, each the int8 K and V rows of a
// 64-key tile (D bytes a row, unswizzled), then one K tile in bf16 and one
// V tile in fp16 in the bf16 kernel's layout (sd_chunk: DP columns,
// 128-byte swizzle).  A warp converts its own 16-key slice of a landed tile
// into the 16-bit rows that it alone reads, so the key loop has no block
// barrier.  After the loop the same bytes hold the warps' partials, then
// the merge's weights.
template <int D>
struct SpSmemQ8 {
  static constexpr int DP = D < 64 ? 64 : D;
  static constexpr int NST = 4;
  static constexpr int I8 = SD_TILE * D;          // an int8 K or V tile
  static constexpr int T16 = (DP / 64) * SD_TILE * 128;
  static constexpr int K16 = 2 * NST * I8, V16 = K16 + T16;
  static constexpr int BYTES = 1024 + V16 + T16;
};

// grid (B * KV, nsplit), as decode_split, over an int8 cache with the
// group's scales: S = Q K^T on the bf16 keys times scale * k_scale in
// fp32, O += P V with P as two fp16 terms against the fp16 values, and the
// block's merged o_tilde times v_scale (both scales are constant over the
// group's keys, so each commutes with the sums exactly).
template <int D>
__global__ void __launch_bounds__(SD_THREADS)
decode_split_q8(const bf16* __restrict__ q, const int8_t* __restrict__ k,
                const int8_t* __restrict__ v,
                const float* __restrict__ k_scale,
                const float* __restrict__ v_scale, float* __restrict__ o_t,
                float* __restrict__ m_out, float* __restrict__ l_out,
                float* __restrict__ ws, int* __restrict__ counters,
                int T_len, int KV, int G, int n_keys, int kps, float scale) {
  using L = SpSmemQ8<D>;
  constexpr int NB = D / 16;  // 16-byte int8 chunks a row
  extern __shared__ unsigned char spq_smem[];
  unsigned char* sm = align1024(spq_smem);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int bkv = blockIdx.x, split = blockIdx.y;
  const int b = bkv / KV, kvh = bkv % KV;
  const size_t row = (size_t)KV * D;
  const int8_t* kb = k + (size_t)b * T_len * row + (size_t)kvh * D;
  const int8_t* vb = v + (size_t)b * T_len * row + (size_t)kvh * D;
  const int k0 = split * kps, k1 = min(n_keys, k0 + kps);
  const int n_tiles = k1 > k0 ? (k1 - k0 + SD_TILE - 1) / SD_TILE : 0;
  const int r0 = warp * SD_SLICE;  // this warp's rows of every tile
  unsigned char* k16 = sm + L::K16;
  unsigned char* v16 = sm + L::V16;

  // this warp's slice of tile i into stage i % NST (zeros past k1; a slice
  // wholly past k1 is neither loaded nor read)
  auto stage = [&](int i) {
    const int s0 = k0 + i * SD_TILE + r0;
    if (s0 >= k1) return;
    unsigned char* kt = sm + (i % L::NST) * 2 * L::I8;
    for (int e = lane; e < SD_SLICE * NB; e += 32) {
      const int r = e / NB, c = e % NB;
      const bool ok = s0 + r < k1;
      const size_t off = ok ? (size_t)(s0 + r) * row + c * 16 : 0;
      cp_async16(kt + (r0 + r) * D + c * 16, kb + off, ok);
      cp_async16(kt + L::I8 + (r0 + r) * D + c * 16, vb + off, ok);
    }
  };
#pragma unroll
  for (int i = 0; i < L::NST - 1; ++i) {
    if (i < n_tiles) stage(i);
    cp_async_commit();
  }

  uint32_t qa[D / 16][4];
  sd_load_q<D>(qa, q + (size_t)bkv * G * D, G, lane);
  const float sk = scale * k_scale[bkv], vs = v_scale[bkv];
  SdPartial<D> w;
  for (int i = 0; i < n_tiles; ++i) {
    // this warp's slice of tile i has landed; its lanes are done with the
    // stage tile i + NST - 1 takes and with the 16-bit rows
    cp_async_wait<L::NST - 2>();
    __syncwarp();
    if (i + L::NST - 1 < n_tiles) stage(i + L::NST - 1);
    cp_async_commit();
    const int s0 = k0 + i * SD_TILE + r0;
    if (s0 >= k1) continue;
    sd_convert_q8<D>(sm + (i % L::NST) * 2 * L::I8, L::I8, k16, v16, r0,
                     lane);
    __syncwarp();
    const uint32_t valid =
        k1 - s0 >= SD_SLICE ? 0xffffu : (1u << (k1 - s0)) - 1u;
    sd_slice<D, true>(w, qa, k16, v16, r0, valid, sk, lane);
  }
  sd_finish<D>(w, sm, o_t, m_out, l_out, ws, counters, gridDim.x, bkv,
               split, gridDim.y, G, vs);
}

template <int D>
int launch_split_q8(const DecodeArgs& a, float* ws, int* counters,
                    int nsplit, int kps, cudaStream_t stream) {
  constexpr int smem = SpSmemQ8<D>::BYTES;
  static_assert(4 * 16 * D * 4 + 2 * 64 * 4 <= smem - 1024,
                "the warps' partials fit the stages");
  static_assert(16 * FIN_SPLITS * 4 <= smem - 1024,
                "the merge's weights fit the stages");
  if (smem > 48 * 1024) {
    const int e = smem_limit_once<decode_split_q8<D>>(smem);
    if (e != 0) return e;
  }
  decode_split_q8<D><<<dim3(a.B * a.KV, nsplit), SD_THREADS, smem, stream>>>(
      (const bf16*)a.q, (const int8_t*)a.k, (const int8_t*)a.v, a.k_scale,
      a.v_scale, (float*)a.o_t, (float*)a.m, (float*)a.l, ws, counters,
      a.T_len, a.KV, a.G, a.n_keys, kps, a.scale);
  return (int)cudaGetLastError();
}

// The split launches' checks of the plan (decode_plan's contract) and
// their dispatch on D: kernel 4's kernel, or kernel 9's (a.k_scale set).
int split_d(const DecodeArgs& a, void* ws, void* counters, int D,
            int nsplit, int kps, void* stream) {
  if (a.G <= 0 || a.G > 16 || a.n_keys < 0 || a.n_keys > a.T_len ||
      nsplit < 1 || nsplit > FIN_SPLITS || kps < 1 ||
      (long long)nsplit * kps < a.n_keys ||
      (nsplit > 1 && ((long long)(nsplit - 1) * kps >= a.n_keys ||
                      ws == nullptr)))
    return (int)cudaErrorInvalidValue;
  if (a.B <= 0 || a.KV <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  float* w = (float*)ws;
  int* c = (int*)counters;
  const bool q8 = a.k_scale != nullptr;
  switch (D) {
    case 32:
      return q8 ? launch_split_q8<32>(a, w, c, nsplit, kps, s)
                : launch_split<32>(a, w, c, nsplit, kps, s);
    case 64:
      return q8 ? launch_split_q8<64>(a, w, c, nsplit, kps, s)
                : launch_split<64>(a, w, c, nsplit, kps, s);
    case 128:
      return q8 ? launch_split_q8<128>(a, w, c, nsplit, kps, s)
                : launch_split<128>(a, w, c, nsplit, kps, s);
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

// Kernel 4 on bf16 caches, split across blocks: the operands of
// vwr_flash_decode_launch (bf16), plus the plan (kernels/vwr_decode.py
// decode_plan): nsplit splits of kps keys a (batch, KV head) group,
// nsplit * kps >= n_keys, no split starting at or past n_keys (n_keys 0:
// one split).  ws: B * KV * nsplit * G * (D + 2) fp32 (the partials; unused
// at one split); counters: B * KV int32, zero, left zero.
extern "C" int vwr_flash_decode_split_launch(
    const void* q, const void* k, const void* v, void* o_t, void* m, void* l,
    void* ws, void* counters, int B, int T_len, int KV, int G, int D,
    int n_keys, int nsplit, int kps, float scale, void* stream) {
  const DecodeArgs a{q, k, v, nullptr, nullptr, o_t, m, l,
                     B, T_len, KV, G, n_keys, scale};
  return split_d(a, ws, counters, D, nsplit, kps, stream);
}

// Kernel 9 on int8 caches, split across blocks: the operands of
// vwr_flash_decode_q8_launch (bf16 q) with the split launch's plan,
// workspace and counters.
extern "C" int vwr_flash_decode_q8_split_launch(
    const void* q, const void* k, const void* v, const void* k_scale,
    const void* v_scale, void* o_t, void* m, void* l, void* ws,
    void* counters, int B, int T_len, int KV, int G, int D, int n_keys,
    int nsplit, int kps, float scale, void* stream) {
  if (k_scale == nullptr || v_scale == nullptr)
    return (int)cudaErrorInvalidValue;
  const DecodeArgs a{q, k, v, (const float*)k_scale, (const float*)v_scale,
                     o_t, m, l, B, T_len, KV, G, n_keys, scale};
  return split_d(a, ws, counters, D, nsplit, kps, stream);
}
