// The sweep of the global flash-attention backward (K2) for Hopper (sm_90a),
// templated on the operand type E (bf16 or fp16) and the head dim D: the one
// sweep over a block's keys that recomputes the probabilities from the
// forward's LSE and does the five products s, dp, dv, dk, dq (the design is
// flash_bwd.cu's item 2). Its entry points are flash_bwd.cu's
// flash_bwd_sweep_bf16 and flash_bwd_f16.cu's flash_bwd_sweep_f16, one library
// each, so that the two types compile side by side. The tiles, stages and
// registers are the same for either type (both 16 bits); the wgmma
// instruction, the tensor maps' element type and the roundings of P and dS
// follow E, as the Pallas body rounds them to the operand dtype
// (pallas_attention.py:636-644). Accumulators are fp32 throughout.
//
// The scratch that the sweep reads is the pre-pass's, in group-major order
// (B * Kv, pad, ...), pad = T * G rounded up to BM: qs and do rows of E, the
// LSE and delta fp32 (pad rows +inf and 0), and the zeroed fp32 dq buffer
// that its atomics add into.

#pragma once

#include <math.h>

#include "hopper.cuh"

namespace {

constexpr int BM = 64;       // query rows per tile of the sweep
constexpr int CONSUMERS = 2;  // consumer warpgroups
constexpr int THREADS = CONSUMERS * 128 + 128;  // and the producer warpgroup
constexpr int SMEM_LIMIT = 232448;
constexpr float LN2 = 0.6931471805599453f;

// The sweep's instance at head dim D. Tiles are D / 64 swizzle atoms wide
// (hopper.cuh), loaded as D / 64 TMA boxes.
//  * D = 64 and 128 (flash_bwd_kernel): BN = 128 keys a block, each consumer
//    warpgroup keeping dk and dv of its 64 keys in fp32 registers (D
//    registers a thread for the two).
//  * D = 192 and 256 (flash_bwd_split_kernel): dk and dv of 64 keys would
//    take 192 and 256 registers a thread, so a block owns BN = 64 keys and
//    the two warpgroups split the products by kind: warpgroup 0 computes S^T
//    and keeps dV, warpgroup 1 dP^T and keeps dK (D / 2 registers each), P^T
//    passing through shared memory in fp32.
// Registers after the hand-over: the producer keeps few, the consumers take
// the rest (2 x 128 x CONSUMER_REGS + 128 x PRODUCER_REGS <= 65536).
template <int D>
struct Bwd {
  static constexpr int ATOMS = D / 64;
  static constexpr bool SPLIT = D > 128;
  static constexpr int BN = SPLIT ? 64 : 128;  // keys per block
  static constexpr int PRODUCER_REGS = SPLIT ? 24 : 40;
  static constexpr int CONSUMER_REGS = SPLIT ? 240 : 232;
  static constexpr int KV_BYTES = BN * D * 2;
  static constexpr int ROW_TILE_BYTES = BM * D * 2;
  static constexpr int STAGE_BYTES = 2 * ROW_TILE_BYTES + 2 * BM * 4;  // qs, do, lse, delta
  static constexpr int DS_BYTES = (SPLIT ? 1 : 2) * BN * BM * 2;        // dS^T, 16 bits
  static constexpr int PF_BYTES = SPLIT ? BN * BM * 4 : 0;              // P^T, fp32 (split only)
  static constexpr int FIXED = 1024 + 2 * KV_BYTES + DS_BYTES + PF_BYTES + 7 * 8;
  static constexpr int FIT = (SMEM_LIMIT - FIXED) / STAGE_BYTES;
  static constexpr int NSTAGE = FIT < 3 ? FIT : 3;  // query tiles in flight
  static constexpr int SMEM_BYTES = FIXED - 7 * 8 + NSTAGE * STAGE_BYTES + (2 * NSTAGE + 1) * 8;
  static_assert(D % 64 == 0 && NSTAGE >= 2 && SMEM_BYTES <= SMEM_LIMIT, "two stages fit shared memory");
  static_assert(CONSUMERS * 128 * CONSUMER_REGS + 128 * PRODUCER_REGS <= 65536, "the hand-over fits the register file");
};

// The pointers into the sweep's shared memory, tiles of the operand type E
template <typename E, int D>
struct BwdSmem {
  E *Ks, *Vs, *Qs, *Os, *Ss;
  float *Pf, *Ls, *Es;
  uint64_t *full, *empty, *kv_bar;
  __device__ explicit BwdSmem(unsigned char* smem) {
    using C = Bwd<D>;
    Ks = reinterpret_cast<E*>(smem);                               // [ATOMS][BN][64]
    Vs = Ks + C::BN * D;                                           // [ATOMS][BN][64]
    Qs = Vs + C::BN * D;                                           // [NSTAGE][ATOMS][BM][64]
    Os = Qs + C::NSTAGE * BM * D;                                  // [NSTAGE][ATOMS][BM][64] do
    Ss = Os + C::NSTAGE * BM * D;                                  // dS^T [key][row], swizzled
    Pf = reinterpret_cast<float*>(Ss + C::DS_BYTES / 2);            // P^T (split): [BM * BN / 128][128]
    Ls = Pf + C::PF_BYTES / 4;                                     // [NSTAGE][BM] lse
    Es = Ls + C::NSTAGE * BM;                                      // [NSTAGE][BM] delta
    full = reinterpret_cast<uint64_t*>(Es + C::NSTAGE * BM);
    empty = full + C::NSTAGE;
    kv_bar = empty + C::NSTAGE;
  }
};

// The producer warpgroup's work, after the barriers are set up: the block's
// keys (k and v, BN rows) once, then every query tile of the group (qs and do
// by TMA, LSE and delta by bulk copy) through the ring of stages.
template <typename E, int D>
__device__ __forceinline__ void bwd_produce(const BwdSmem<E, D>& sm, const CUtensorMap* kmap, const CUtensorMap* vmap,
                                            const CUtensorMap* qmap, const CUtensorMap* domap, const float* lb,
                                            const float* eb, int kv, int s0, int b, int grp, int tile0, int n_tiles) {
  using C = Bwd<D>;
  mbar_expect_tx(sm.kv_bar, 2 * C::KV_BYTES);
#pragma unroll
  for (int a = 0; a < C::ATOMS; ++a) {
    tma_load_4d(sm.Ks + a * C::BN * 64, kmap, sm.kv_bar, 64 * a, kv, s0, b);
    tma_load_4d(sm.Vs + a * C::BN * 64, vmap, sm.kv_bar, 64 * a, kv, s0, b);
  }
  for (int it = 0; it < n_tiles; ++it) {
    const int st = it % C::NSTAGE;
    mbar_wait(&sm.empty[st], ((it / C::NSTAGE) & 1) ^ 1);
    mbar_expect_tx(&sm.full[st], C::STAGE_BYTES);
    const int r0 = (tile0 + it) * BM;
#pragma unroll
    for (int a = 0; a < C::ATOMS; ++a) {
      tma_load_3d(sm.Qs + (st * C::ATOMS + a) * BM * 64, qmap, &sm.full[st], 64 * a, r0, grp);
      tma_load_3d(sm.Os + (st * C::ATOMS + a) * BM * 64, domap, &sm.full[st], 64 * a, r0, grp);
    }
    bulk_load(sm.Ls + st * BM, lb + r0, BM * 4, &sm.full[st]);
    bulk_load(sm.Es + st * BM, eb + r0, BM * 4, &sm.full[st]);
  }
}

// dq_acc rows row_a and row_a + 8 (fp32, D wide), columns col0 + 8 i + 2 tq,
// += the 64-column dQ accumulator dq (fp32 atomics)
template <int D>
__device__ __forceinline__ void add_dq(float* dqb, const float (&dq)[32], int row_a, int rows, int col0, int tq) {
  const int row_b = row_a + 8;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int col = col0 + 8 * i + 2 * tq;
    if (row_a < rows)
      atomicAdd(reinterpret_cast<float2*>(dqb + (size_t)row_a * D + col), make_float2(dq[4 * i], dq[4 * i + 1]));
    if (row_b < rows)
      atomicAdd(reinterpret_cast<float2*>(dqb + (size_t)row_b * D + col), make_float2(dq[4 * i + 2], dq[4 * i + 3]));
  }
}

// dk (times ln 2) and dv of keys key_a and key_a + 8, stored, or with ACCUMULATE
// added into what the buffers hold (the block alone owns its keys' rows); with
// `shared` (the query tiles split over several blocks) added by fp32 atomics
// into buffers that hold zeros or the accumulators
template <int D, bool ACCUMULATE>
__device__ __forceinline__ void put_rows(float* dst, const float (&acc)[D / 2], float mul, int key_a, int S,
                                         size_t ld, int tq, bool shared) {
  auto put = [shared](float* p, float x, float y) {
    float2* q = reinterpret_cast<float2*>(p);
    if (shared) {
      atomicAdd(q, make_float2(x, y));
      return;
    }
    if constexpr (ACCUMULATE) {
      const float2 old = *q;
      x += old.x;
      y += old.y;
    }
    *q = make_float2(x, y);
  };
  const int key_b = key_a + 8;
#pragma unroll
  for (int i = 0; i < D / 8; ++i) {
    const int col = 8 * i + 2 * tq;
    if (key_a < S) put(dst + key_a * ld + col, acc[4 * i] * mul, acc[4 * i + 1] * mul);
    if (key_b < S) put(dst + key_b * ld + col, acc[4 * i + 2] * mul, acc[4 * i + 3] * mul);
  }
}

// The sweep at D = 64 and 128: one block per (batch, KV head, BN = 128 keys),
// each consumer warpgroup owning 64 of the keys.
template <typename E, int D, bool GROUPED, bool ACCUMULATE>
__global__ void __launch_bounds__(THREADS, 1)
flash_bwd_kernel(const __grid_constant__ CUtensorMap kmap, const __grid_constant__ CUtensorMap vmap,
                 const __grid_constant__ CUtensorMap qmap, const __grid_constant__ CUtensorMap domap,
                 const float* __restrict__ lse_g, const float* __restrict__ delta_g, float* __restrict__ dq_acc,
                 float* __restrict__ dk, float* __restrict__ dv, int T, int S, int H, int Kv, int pad) {
  using C = Bwd<D>;
  static_assert(!C::SPLIT && C::BN == CONSUMERS * 64, "each consumer warpgroup owns 64 keys");
  constexpr int BN = C::BN, NSTAGE = C::NSTAGE, ATOMS = C::ATOMS;
  extern __shared__ unsigned char smem_raw[];
  const BwdSmem<E, D> sm(align1024(smem_raw));

  const int b = GROUPED ? blockIdx.y / Kv : blockIdx.y;
  const int kv = GROUPED ? blockIdx.y % Kv : 0;
  const int grp = blockIdx.y;  // b * Kv + kv
  const int rows = T * (H / Kv);
  const int s0 = blockIdx.x * BN;
  // the query tiles of this block: all of them, or its share of a grid that splits them (gridDim.z > 1)
  // (D = 64 never splits: there the range and the plain stores of dk and dv below are fixed at compile time,
  // which on an H100 kept the sweep 1-3 % faster than reading gridDim.z)
  const int tile0 = D == 64 ? 0 : (int)((long long)pad / BM * blockIdx.z / gridDim.z);
  const int n_tiles = D == 64 ? pad / BM : (int)((long long)pad / BM * (blockIdx.z + 1) / gridDim.z) - tile0;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int s = 0; s < NSTAGE; ++s) {
      mbar_init(&sm.full[s], 1);
      mbar_init(&sm.empty[s], CONSUMERS * 4);  // one arrival per consumer warp
    }
    mbar_init(sm.kv_bar, 1);
    fence_barrier_init();
  }
  __syncthreads();

  if (warp >= CONSUMERS * 4) {  // the producer warpgroup; one thread issues every copy
    setmaxnreg_dec<C::PRODUCER_REGS>();
    if (warp == CONSUMERS * 4 && lane == 0)
      bwd_produce<E, D>(sm, &kmap, &vmap, &qmap, &domap, lse_g + (size_t)grp * pad, delta_g + (size_t)grp * pad, kv,
                        s0, b, grp, tile0, n_tiles);
    return;
  }

  setmaxnreg_inc<C::CONSUMER_REGS>();
  const int wg = warp / 4;  // consumer warpgroup: keys s0 + 64 wg ...
  const int wi = warp % 4;
  const int g = lane >> 2;  // accumulator row (and row + 8) in the warp's 16
  const int tq = lane & 3;  // accumulator column pair
  const int key_a = s0 + wg * 64 + wi * 16 + g;  // this thread's two keys (rows of S^T, dk, dv)
  const int key_b = key_a + 8;
  const bool kv_tail = s0 + BN > S;
  // descriptor steps: 16 columns of K inside an atom, one atom of a K / V tile and of a row tile
  constexpr uint64_t K16 = 32 >> 4, KV_ATOM = BN * 128 >> 4, ROW_ATOM = BM * 128 >> 4, STEP16 = 16 * 128 >> 4;
  const uint64_t kdesc = desc_kmajor(sm.Ks + wg * 64 * 64);  // K of this warpgroup's keys, as A
  const uint64_t vdesc = desc_kmajor(sm.Vs + wg * 64 * 64);
  float* dqb = dq_acc + (size_t)grp * pad * D;

  float dv_acc[D / 2], dk_acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dv_acc[i] = dk_acc[i] = 0.f;

  mbar_wait(sm.kv_bar, 0);
  for (int it = 0; it < n_tiles; ++it) {
    const int st = it % NSTAGE;
    mbar_wait(&sm.full[st], (it / NSTAGE) & 1);
    const E* Qt = sm.Qs + st * BM * D;
    const E* Ot = sm.Os + st * BM * D;

    // S^T = K qs^T and dP^T = V do^T: this warpgroup's 64 keys x the tile's 64 rows
    float s[32], dp[32];
    const uint64_t qdesc = desc_kmajor(Qt), odesc = desc_kmajor(Ot);
    reg_fence(s);
    reg_fence(dp);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint64_t step = (kk % 4) * K16;
      wgmma_ss_n64<0, 0, E>(s, kdesc + (kk / 4) * KV_ATOM + step, qdesc + (kk / 4) * ROW_ATOM + step, kk);
    }
    wgmma_commit();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint64_t step = (kk % 4) * K16;
      wgmma_ss_n64<0, 0, E>(dp, vdesc + (kk / 4) * KV_ATOM + step, odesc + (kk / 4) * ROW_ATOM + step, kk);
    }
    wgmma_commit();

    // p = exp2(s - lse2) (zero past S; a padded row has lse = +inf), ds = p (dp - delta)
    const float* lt = sm.Ls + st * BM;
    const float* et = sm.Es + st * BM;
    wgmma_wait<1>();
    reg_fence(s);
#pragma unroll
    for (int i = 0; i < BM / 8; ++i) {
      const float2 l2 = *reinterpret_cast<const float2*>(lt + 8 * i + 2 * tq);
      s[4 * i] = exp2f(s[4 * i] - l2.x);
      s[4 * i + 1] = exp2f(s[4 * i + 1] - l2.y);
      s[4 * i + 2] = exp2f(s[4 * i + 2] - l2.x);
      s[4 * i + 3] = exp2f(s[4 * i + 3] - l2.y);
      if (kv_tail) {
        if (key_a >= S) s[4 * i] = s[4 * i + 1] = 0.f;
        if (key_b >= S) s[4 * i + 2] = s[4 * i + 3] = 0.f;
      }
    }
    wgmma_wait<0>();
    reg_fence(dp);
#pragma unroll
    for (int i = 0; i < BM / 8; ++i) {
      const float2 e2 = *reinterpret_cast<const float2*>(et + 8 * i + 2 * tq);
      dp[4 * i] = s[4 * i] * (dp[4 * i] - e2.x);
      dp[4 * i + 1] = s[4 * i + 1] * (dp[4 * i + 1] - e2.y);
      dp[4 * i + 2] = s[4 * i + 2] * (dp[4 * i + 2] - e2.x);
      dp[4 * i + 3] = s[4 * i + 3] * (dp[4 * i + 3] - e2.y);
    }

    // dV += P^T do and dK += dS^T qs: P^T and dS^T are already A fragments
    // (keys as M, the tile's rows as K); do and qs read MN-major, N = D across their atoms
    uint32_t pa[BM / 16][4], ga[BM / 16][4];
#pragma unroll
    for (int j = 0; j < BM / 16; ++j) {
      a_frag<E>(pa[j], s + 8 * j);
      a_frag<E>(ga[j], dp + 8 * j);
    }
    constexpr uint32_t LBO = ATOMS == 1 ? 1024 : BM * 128;  // one atom along N: LBO unread
    const uint64_t qdesc_b = desc_mnmajor(Qt, LBO), odesc_b = desc_mnmajor(Ot, LBO);
    reg_fence(dv_acc);
    reg_fence(dk_acc);
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < BM / 16; ++j) wgmma_rs<D, 1, E>(dv_acc, pa[j], odesc_b + j * STEP16, 1);
#pragma unroll
    for (int j = 0; j < BM / 16; ++j) wgmma_rs<D, 1, E>(dk_acc, ga[j], qdesc_b + j * STEP16, 1);
    wgmma_commit();

    // dS^T to shared memory in E: [key][row], rows contiguous and swizzled
    E* St = sm.Ss + (it & 1) * BN * BM;
    const int kr_a = wg * 64 + wi * 16 + g, kr_b = kr_a + 8;
#pragma unroll
    for (int i = 0; i < BM / 8; ++i) {
      *reinterpret_cast<uint32_t*>(St + sw128(kr_a, i) + 2 * tq) = ga[i / 2][(i & 1) * 2];
      *reinterpret_cast<uint32_t*>(St + sw128(kr_b, i) + 2 * tq) = ga[i / 2][(i & 1) * 2 + 1];
    }
    fence_proxy_async();
    named_bar_sync(1, CONSUMERS * 128);  // dS^T of all BN keys is in place

    // dQ = dS K over the block's BN keys, 64 columns of D at a time: at D = 64
    // the warpgroups take turns by tile, at D = 128 each takes one atom
    const bool mine = ATOMS == 1 ? (it % CONSUMERS) == wg : true;
    const int atom = ATOMS == 1 ? 0 : wg;
    float dq[32];
    if (mine) {
      const uint64_t sdesc = desc_mnmajor(St);
      const uint64_t kdesc_b = desc_mnmajor(sm.Ks + atom * BN * 64);  // the atom's 64 columns of all BN keys, as B
      reg_fence(dq);
      wgmma_fence();
#pragma unroll
      for (int j = 0; j < BN / 16; ++j) wgmma_ss_n64<1, 1, E>(dq, sdesc + j * STEP16, kdesc_b + j * STEP16, j);
      wgmma_commit();
    }
    wgmma_wait<0>();
    reg_fence(dv_acc);
    reg_fence(dk_acc);
    reg_fence(pa);
    reg_fence(ga);
    __syncwarp();
    if (lane == 0) mbar_arrive(&sm.empty[st]);  // this warp is done with the stage
    if (mine) {
      reg_fence(dq);
      add_dq<D>(dqb, dq, (tile0 + it) * BM + wi * 16 + g, rows, atom * 64, tq);
    }
  }

  const int kvs = GROUPED ? Kv : 1;  // KV heads of a key row
  const size_t ld = (size_t)kvs * D;
  const bool shared = D > 64 && gridDim.z > 1;  // other blocks add into the same keys' rows
  put_rows<D, ACCUMULATE>(dk + ((size_t)b * S * kvs + kv) * D, dk_acc, LN2, key_a, S, ld, tq, shared);
  put_rows<D, ACCUMULATE>(dv + ((size_t)b * S * kvs + kv) * D, dv_acc, 1.f, key_a, S, ld, tq, shared);
}

// The sweep at D = 192 and 256: one block per (batch, KV head, BN = 64 keys).
// Warpgroup 0 computes S^T = K qs^T, P^T = exp2(S^T - lse2), keeps dV += P^T
// do and passes P^T (fp32) through shared memory; warpgroup 1 computes dP^T =
// V do^T, dS^T = P^T (dP^T - delta), keeps dK += dS^T qs and writes dS^T
// (E) for dQ. Both then compute dQ = dS K, warpgroup w over the atoms w,
// w + 2, ... of D. A thread of either holds the same (key, row) entries of
// its 64 x 64 product, so P^T crosses as one register a thread.
template <typename E, int D, bool GROUPED, bool ACCUMULATE>
__global__ void __launch_bounds__(THREADS, 1)
flash_bwd_split_kernel(const __grid_constant__ CUtensorMap kmap, const __grid_constant__ CUtensorMap vmap,
                       const __grid_constant__ CUtensorMap qmap, const __grid_constant__ CUtensorMap domap,
                       const float* __restrict__ lse_g, const float* __restrict__ delta_g, float* __restrict__ dq_acc,
                       float* __restrict__ dk, float* __restrict__ dv, int T, int S, int H, int Kv, int pad) {
  using C = Bwd<D>;
  static_assert(C::SPLIT && C::BN == 64, "both warpgroups share the block's 64 keys");
  constexpr int BN = C::BN, NSTAGE = C::NSTAGE, ATOMS = C::ATOMS;
  extern __shared__ unsigned char smem_raw[];
  const BwdSmem<E, D> sm(align1024(smem_raw));

  const int b = GROUPED ? blockIdx.y / Kv : blockIdx.y;
  const int kv = GROUPED ? blockIdx.y % Kv : 0;
  const int grp = blockIdx.y;  // b * Kv + kv
  const int rows = T * (H / Kv);
  const int s0 = blockIdx.x * BN;
  // the query tiles of this block: all of them, or its share of a grid that splits them (gridDim.z > 1)
  const int tile0 = (int)((long long)pad / BM * blockIdx.z / gridDim.z);
  const int n_tiles = (int)((long long)pad / BM * (blockIdx.z + 1) / gridDim.z) - tile0;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int s = 0; s < NSTAGE; ++s) {
      mbar_init(&sm.full[s], 1);
      mbar_init(&sm.empty[s], CONSUMERS * 4);  // one arrival per consumer warp
    }
    mbar_init(sm.kv_bar, 1);
    fence_barrier_init();
  }
  __syncthreads();

  if (warp >= CONSUMERS * 4) {  // the producer warpgroup; one thread issues every copy
    setmaxnreg_dec<C::PRODUCER_REGS>();
    if (warp == CONSUMERS * 4 && lane == 0)
      bwd_produce<E, D>(sm, &kmap, &vmap, &qmap, &domap, lse_g + (size_t)grp * pad, delta_g + (size_t)grp * pad, kv,
                        s0, b, grp, tile0, n_tiles);
    return;
  }

  setmaxnreg_inc<C::CONSUMER_REGS>();
  const int wg = warp / 4;  // 0: S^T, P^T and dV; 1: dP^T, dS^T and dK
  const int wi = warp % 4;
  const int tid = threadIdx.x % 128;
  const int g = lane >> 2;  // accumulator row (and row + 8) in the warp's 16
  const int tq = lane & 3;  // accumulator column pair
  const int key_a = s0 + wi * 16 + g;  // this thread's two keys (rows of the products, of dk or dv)
  const int key_b = key_a + 8;
  const bool kv_tail = s0 + BN > S;
  constexpr uint64_t K16 = 32 >> 4, KV_ATOM = BN * 128 >> 4, ROW_ATOM = BM * 128 >> 4, STEP16 = 16 * 128 >> 4;
  const uint64_t adesc = desc_kmajor(wg == 0 ? sm.Ks : sm.Vs);  // A of the first product: K or V
  float* dqb = dq_acc + (size_t)grp * pad * D;
  const uint64_t sdesc = desc_mnmajor(sm.Ss);

  float acc[D / 2];  // warpgroup 0: dV; 1: dK (times ln 2 at the end)
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;

  mbar_wait(sm.kv_bar, 0);
  for (int it = 0; it < n_tiles; ++it) {
    const int st = it % NSTAGE;
    mbar_wait(&sm.full[st], (it / NSTAGE) & 1);
    const E* Qt = sm.Qs + st * BM * D;
    const E* Ot = sm.Os + st * BM * D;
    const E* Xt = wg == 0 ? Qt : Ot;  // B of the first product (K-major)
    const E* Yt = wg == 0 ? Ot : Qt;  // B of the kept product (MN-major, N = D)

    // warpgroup 0: S^T = K qs^T; 1: dP^T = V do^T (the block's 64 keys x the tile's 64 rows)
    float s[32];
    const uint64_t xdesc = desc_kmajor(Xt);
    reg_fence(s);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint64_t step = (kk % 4) * K16;
      wgmma_ss_n64<0, 0, E>(s, adesc + (kk / 4) * KV_ATOM + step, xdesc + (kk / 4) * ROW_ATOM + step, kk);
    }
    wgmma_commit();
    wgmma_wait<0>();
    reg_fence(s);
    if (wg == 0) {  // p = exp2(s - lse2) (zero past S; a padded row has lse = +inf), to shared memory
      const float* lt = sm.Ls + st * BM;
#pragma unroll
      for (int i = 0; i < BM / 8; ++i) {
        const float2 l2 = *reinterpret_cast<const float2*>(lt + 8 * i + 2 * tq);
        s[4 * i] = exp2f(s[4 * i] - l2.x);
        s[4 * i + 1] = exp2f(s[4 * i + 1] - l2.y);
        s[4 * i + 2] = exp2f(s[4 * i + 2] - l2.x);
        s[4 * i + 3] = exp2f(s[4 * i + 3] - l2.y);
        if (kv_tail) {
          if (key_a >= S) s[4 * i] = s[4 * i + 1] = 0.f;
          if (key_b >= S) s[4 * i + 2] = s[4 * i + 3] = 0.f;
        }
      }
#pragma unroll
      for (int i = 0; i < 32; ++i) sm.Pf[i * 128 + tid] = s[i];
    }
    named_bar_sync(1, CONSUMERS * 128);  // P^T is in place
    if (wg == 1) {  // ds = p (dp - delta)
      const float* et = sm.Es + st * BM;
#pragma unroll
      for (int i = 0; i < BM / 8; ++i) {
        const float2 e2 = *reinterpret_cast<const float2*>(et + 8 * i + 2 * tq);
        s[4 * i] = sm.Pf[(4 * i) * 128 + tid] * (s[4 * i] - e2.x);
        s[4 * i + 1] = sm.Pf[(4 * i + 1) * 128 + tid] * (s[4 * i + 1] - e2.y);
        s[4 * i + 2] = sm.Pf[(4 * i + 2) * 128 + tid] * (s[4 * i + 2] - e2.x);
        s[4 * i + 3] = sm.Pf[(4 * i + 3) * 128 + tid] * (s[4 * i + 3] - e2.y);
      }
    }

    // warpgroup 0: dV += P^T do; 1: dK += dS^T qs (P^T, dS^T already A fragments)
    uint32_t fr[BM / 16][4];
#pragma unroll
    for (int j = 0; j < BM / 16; ++j) a_frag<E>(fr[j], s + 8 * j);
    const uint64_t ydesc = desc_mnmajor(Yt, BM * 128);
    reg_fence(acc);
    reg_fence(fr);
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < BM / 16; ++j) wgmma_rs<D, 1, E>(acc, fr[j], ydesc + j * STEP16, 1);
    wgmma_commit();
    if (wg == 1) {  // dS^T to shared memory in E: [key][row], rows contiguous and swizzled
      const int kr_a = wi * 16 + g, kr_b = kr_a + 8;
#pragma unroll
      for (int i = 0; i < BM / 8; ++i) {
        *reinterpret_cast<uint32_t*>(sm.Ss + sw128(kr_a, i) + 2 * tq) = fr[i / 2][(i & 1) * 2];
        *reinterpret_cast<uint32_t*>(sm.Ss + sw128(kr_b, i) + 2 * tq) = fr[i / 2][(i & 1) * 2 + 1];
      }
      fence_proxy_async();
    }
    named_bar_sync(2, CONSUMERS * 128);  // dS^T is in place (and warpgroup 1 is done reading P^T)

    // dQ = dS K, 64 columns of D at a time: warpgroup w takes the atoms w, w + 2, ...
#pragma unroll
    for (int n = 0; n < (ATOMS + 1) / 2; ++n) {
      const int atom = wg + 2 * n;
      if (atom >= ATOMS) break;
      float dq[32];
      const uint64_t kdesc_b = desc_mnmajor(sm.Ks + atom * BN * 64);  // the atom's 64 columns of the keys, as B
      reg_fence(dq);
      wgmma_fence();
#pragma unroll
      for (int j = 0; j < BN / 16; ++j) wgmma_ss_n64<1, 1, E>(dq, sdesc + j * STEP16, kdesc_b + j * STEP16, j);
      wgmma_commit();
      wgmma_wait<0>();
      reg_fence(dq);
      if (n == 0) {
        reg_fence(acc);
        reg_fence(fr);
        __syncwarp();
        if (lane == 0) mbar_arrive(&sm.empty[st]);  // the kept product is done too: this warp is done with the stage
      }
      add_dq<D>(dqb, dq, (tile0 + it) * BM + wi * 16 + g, rows, atom * 64, tq);
    }
  }

  const int kvs = GROUPED ? Kv : 1;  // KV heads of a key row
  const size_t ld = (size_t)kvs * D;
  const bool shared = gridDim.z > 1;  // other blocks add into the same keys' rows
  if (wg == 0) put_rows<D, ACCUMULATE>(dv + ((size_t)b * S * kvs + kv) * D, acc, 1.f, key_a, S, ld, tq, shared);
  else put_rows<D, ACCUMULATE>(dk + ((size_t)b * S * kvs + kv) * D, acc, LN2, key_a, S, ld, tq, shared);
}

// (D, rows, groups) rows of E of a group-major buffer, boxes of BM rows and
// 64 of the head dim (one swizzle atom); rows past `rows` arrive as zeros
template <typename E>
int make_rows_map(CUtensorMap* map, const void* ptr, int rows, int groups, int D) {
  const cuuint64_t dims[3] = {(cuuint64_t)D, (cuuint64_t)rows, (cuuint64_t)groups};
  const cuuint64_t strides[2] = {(cuuint64_t)D * 2, (cuuint64_t)rows * D * 2};
  const cuuint32_t box[3] = {64, BM, 1};
  return make_map<E>(map, 3, ptr, dims, strides, box);
}

// The sweep's instance of operand type E and head dim D over S keys: tensor maps, shared memory, launch
template <typename E, int D>
int launch_sweep(const void* k, const void* v, const void* qs_g, const void* do_rows, const void* lse_g,
                 const void* delta_g, void* dq_acc, void* dk, void* dv, int B, int T, int S, int H, int Kv,
                 int accumulate, void* stream) {
  using C = Bwd<D>;
  const int rows = T * (H / Kv);
  const int pad = (rows + BM - 1) / BM * BM;
  const int groups = B * Kv;
  CUtensorMap kmap, vmap, qmap, domap;
  int dev;
  int err = bind_device(&dev);
  if (err == 0) err = make_kv_map<E>(&kmap, k, B, S, Kv, C::BN, D);
  if (err == 0) err = make_kv_map<E>(&vmap, v, B, S, Kv, C::BN, D);
  if (err == 0) err = make_rows_map<E>(&qmap, qs_g, rows, groups, D);
  if (err == 0) err = make_rows_map<E>(&domap, do_rows, rows, groups, D);
  if (err != 0) return err;

  // At a head dim above 64, a grid of fewer blocks than the card has SMs (MQA at a small batch: one block
  // per BN keys and batch) splits each block's query tiles over up to four blocks, which add their dk and
  // dv by atomics (zeroed first unless accumulating); D = 64 keeps one block per key tile.
  const int key_blocks = (S + C::BN - 1) / C::BN * groups;
  int sms = 132;
  if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess) return (int)cudaGetLastError();
  int splits = D == 64 ? 1 : sms / key_blocks;
  splits = splits < 1 ? 1 : splits > 4 ? 4 : splits;
  if (splits > pad / BM) splits = pad / BM;
  if (splits > 1 && !accumulate) {
    const size_t bytes = (size_t)B * S * Kv * D * 4;
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (cudaMemsetAsync(dk, 0, bytes, st) != cudaSuccess || cudaMemsetAsync(dv, 0, bytes, st) != cudaSuccess)
      return (int)cudaGetLastError();
  }
  auto start = [&](auto kernel) {
    static std::atomic<unsigned long long> smem_set[4];  // per instance: devices whose limit is raised
    const int e = allow_smem(kernel, C::SMEM_BYTES, dev, smem_set[(Kv > 1) * 2 + (accumulate != 0)]);
    if (e != 0) return e;
    kernel<<<dim3((S + C::BN - 1) / C::BN, groups, splits), THREADS, C::SMEM_BYTES,
             static_cast<cudaStream_t>(stream)>>>(
        kmap, vmap, qmap, domap, static_cast<const float*>(lse_g), static_cast<const float*>(delta_g),
        static_cast<float*>(dq_acc), static_cast<float*>(dk), static_cast<float*>(dv), T, S, H, Kv, pad);
    return 0;
  };
  if constexpr (C::SPLIT)
    err = start(Kv > 1 ? (accumulate ? flash_bwd_split_kernel<E, D, true, true>
                                     : flash_bwd_split_kernel<E, D, true, false>)
                       : (accumulate ? flash_bwd_split_kernel<E, D, false, true>
                                     : flash_bwd_split_kernel<E, D, false, false>));
  else
    err = start(Kv > 1 ? (accumulate ? flash_bwd_kernel<E, D, true, true> : flash_bwd_kernel<E, D, true, false>)
                       : (accumulate ? flash_bwd_kernel<E, D, false, true> : flash_bwd_kernel<E, D, false, false>));
  if (err != 0) return err;
  return (int)cudaGetLastError();
}

}  // namespace
