// Windowed MQA flash-attention backward, for Hopper (sm_90a): the split pair,
// both kernels and their pre-pass in this source, in two key frames.
//
// Replaces osufusion_tpu/ops/pallas_attention.py::_dq_kernel and ::_dkv_kernel
// (both launched by _flash_bwd), the backward of a sliding-window site, and
// ::_halo_dq_kernel and ::_halo_dkv_kernel (both launched by _halo_flash_bwd),
// the backward of the halo forward (flash_fwd.cu's HALO instance) in
// sequence-parallel training. The two pairs compute the same thing in two
// frames of the keys (template argument HALO, the frame's numbers in a
// KeyFrame of key_frame.cuh):
//  * single device (HALO = false): key s is attended by query t iff |t - s| <=
//    window / 2 (integer half, the forward's rule; window < 0: every key);
//    q arrives raw with the cos/sin tables, k rotated.
//  * halo (HALO = true): a rank's T local queries against a slab of S = T + W
//    keys whose row s is the single-device key s - W/2, so t sees s iff
//    |t - (s - W/2)| <= W/2, and only the slab rows [lo, hi) inside the song
//    exist (key_frame.cuh's halo_frame: lo = max(0, W/2 - g0), hi = min(S,
//    t_global - g0 + W/2)). q arrives rotated (no tables; dq stays in its
//    frame), k rotated. Slab rows outside the song get dk = dv = 0.
//
// Inputs: q (B, T, H, D) bf16, k and v (B, S, D) bf16, do and o (B, T, H, D)
// bf16, lse2 (B, T*H) fp32 (the base-2 log-sum-exp that the forward wrote).
// With qs = q_rot * scale * log2(e) in bf16 (rope_qs.cuh, the forward's bits:
// flash_fwd.cu stages q with the same function in both frames), p = exp2(qs
// k_rot^T - lse2) is the forward's
// probability; a masked key gets p = 0 outright. With ds = p (do v^T - delta),
// delta = rowsum(do * o):
//   dq_rot = scale * ds k_rot      un-rotated in registers (halo: not), bf16 out
//   dv     = p^T do                fp32 out
//   dk_rot = ln(2) * ds^T qs       fp32 out, still in the rotated frame
//
// Bound: compute (each q row meets ~W keys for a few hundred bytes of
// traffic): 3 products of 2 * D FLOP per visited (query, key) pair in dq, 4 in
// dkv, and one exp2 per pair in each. The design (tiles move by TMA,
// `cp.async.bulk.tensor` and `cp.async.bulk` behind `mbarrier`s; every product
// is `wgmma.mma_async`; the wrappers are in hopper.cuh) serves the head dims
// 64, 128, 192 and 256 (template argument D): every tile is D / 64 swizzle
// atoms wide (hopper.cuh), loaded as D / 64 TMA boxes; K-major operands step
// atom to atom, MN-major ones (K in dQ += dS K; qs and do in the dk/dv
// products) read across atoms by the descriptor's LBO.
//
//  * Pre-pass (flash_bwd_prep.cuh, K2's, instanced at each D): qs rotated
//    (halo: only scaled) once per row, delta, and the LSE, t-major (the
//    group-major order at MQA), LSE and delta padded to whole 128-row blocks
//    with +inf and 0, so a pad row has p = ds = 0. Both kernels read qs from
//    there: no row is scaled twice, and no fp32 dq buffer exists.
//  * flash_bwd_dq_kernel (struct Dq): one block per BM (timestep, head) rows,
//    as the forward lays them out, one consumer warpgroup per 64 of them; a
//    producer warpgroup (one thread of it issues every copy) loads the block's
//    qs and do once, in the 128-byte swizzle, then streams the KV tiles of BN
//    keys that intersect [t_lo - w/2, t_hi + w/2] through a ring of NSTAGE
//    stages. Per tile S = qs K^T and dP = do V^T (wgmma m64nBN, both operands
//    in shared memory); ds stays in registers as the A operand of dQ += dS K
//    (wgmma m64nD, K read MN-major). While the tensor cores run tile j's S
//    and dP and tile j-1's dQ, the warpgroup waits only for S and computes p.
//    A warpgroup holds dQ (D / 2 fp32 registers a thread), S and dP (BN / 2
//    each) and dS (BN / 4): D = 64 keeps its first design (BM = 128, BN =
//    128, 4 stages, producer at 40 registers and consumers at 232 by
//    setmaxnreg); wider heads take 64-key tiles (S and dP at 128 keys would
//    not fit beside dQ in 240 registers) and as many stages as fit beside qs
//    and do in shared memory: D = 128 BM = 128 and 4 stages, D = 192 BM = 128
//    and 2, D = 256 BM = 64 (qs and do of 128 rows would leave room for one
//    stage) and 2, its one consumer warpgroup at the 255 registers that 256
//    threads leave a thread, with no hand-over. Only tiles at the window's
//    edge or past the last key (S; halo: hi) are masked; the sweep starts at
//    lo. No atomics and no buffer: each dq row is un-rotated, scaled and
//    stored once, so dq repeats to the last bit.
//  * flash_bwd_dkv_kernel (D = 64): one block per (batch element, KV_BN = 64
//    keys), two blocks per SM (so the narrow levels, T = 8192 at B = 1, still
//    fill the card). Its consumer warpgroup keeps dk and dv of the 64 keys in
//    fp32 registers (232 a thread, by setmaxnreg from a producer warpgroup
//    that keeps 24); one producer thread streams the 64-row tiles of qs and
//    do (TMA) and of the LSE and delta (bulk copy) of the timesteps [s0 -
//    w/2, s_last + w/2] through a ring of KV_NSTAGE stages. Per tile S^T = K
//    qs^T and dP^T = V do^T put the keys in wgmma's M, so P^T and dS^T come
//    out in registers already as the A operands of dV += P^T do and dK +=
//    dS^T qs (do and qs read MN-major): no shared-memory round trip, no
//    transposing loads. Tile j-1's dV, dK run while tile j's p is computed.
//    Each dk, dv row is written once: the same bits from launch to launch.
//    Only tiles whose timesteps touch the window's edge, and blocks with
//    keys outside [lo, hi), are masked; a halo block with no key inside the
//    song writes zeros and sweeps nothing (at level 0's first and last shard,
//    32 blocks). The halo slab's blocks are not reordered: the W / 64 blocks
//    at each end see a ramp of rows (key s meets s + 1 rows at the start, T +
//    W - s at the end), about 256 full blocks' work at level 0 for 264 slots
//    (132 SMs x 2); the light first blocks finish early and take the light
//    last ones, so the launch order makes about one wave.
//  * flash_bwd_dkv_split_kernel (D = 128, 192, 256; struct DkvSplit): dk and
//    dv of 64 keys are D fp32 registers a thread, too many beside the tiles
//    in flight, so the block's two consumer warpgroups split the products by
//    kind, as K2's flash_bwd_split_kernel does: warpgroup 0 computes S^T and
//    P^T and keeps dV, warpgroup 1 dP^T and dS^T and keeps dK (D / 2
//    registers each); P^T crosses in fp32 through shared memory (two
//    buffers, one named barrier a tile). Each warpgroup issues tile j's first
//    product and tile j-1's kept one together and waits only for the first.
//    64 keys a block, one block an SM (qs and do stages fill shared memory:
//    4 at D = 128, 3 at 192, 2 at 256): the narrowest whole-song level (T =
//    8192, B = 1) makes 128 blocks of two consumer warpgroups for 132 SMs,
//    one wave with 4 SMs idle; level 0 (T = 65536) 1024 blocks, 7.8 waves.
//  * The pair recomputes s and dp in both kernels (7 products of T*W*H*D
//    against the fused sweep's 5): that is what the split is (the card's
//    own; the TPU pair exists because its grid has no atomics).
//
// C ABI (loaded with ctypes), every entry point taking the head dim first
// (cudaErrorInvalidValue for one without an instance):
// flash_bwd_windowed_prep_bf16 fills the scratch that the kernels of either
// frame read (with tables or, for the halo pair, without);
// flash_bwd_dq_bf16 and flash_bwd_dkv_bf16 (single device), halo_bwd_dq_bf16
// and halo_bwd_dkv_bf16 (halo) return a cudaError_t, or minus the CUresult of
// a TMA descriptor that failed to encode.

#include <limits.h>
#include <math.h>

#include "flash_bwd_prep.cuh"
#include "hopper.cuh"
#include "key_frame.cuh"

namespace {

constexpr int SMEM_LIMIT = 232448;                // dynamic shared memory a block may take on sm_90
constexpr int ROW_TILE = 64;                      // rows of a qs / do box of TMA
constexpr int ROW_PAD = 128;                      // the scratch's row padding: a multiple of every dq block
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

// The dq kernel's instance at head dim D (see the top of this file)
template <int D>
struct Dq {
  static constexpr int ATOMS = D / 64;
  static constexpr int BM = D <= 192 ? 128 : 64;   // (timestep, head) rows per block
  static constexpr int BN = D == 64 ? 128 : 64;    // keys per KV tile
  static constexpr int CONSUMERS = BM / 64;        // consumer warpgroups, 64 rows each
  static constexpr int THREADS = CONSUMERS * 128 + 128;  // and the producer warpgroup
  // registers a thread after the hand-over (CONSUMERS x 128 x CONSUMER_REGS + 128 x PRODUCER_REGS <= 65536);
  // with one consumer warpgroup 256 threads leave every thread 255 and nothing is handed over
  static constexpr bool HANDOVER = CONSUMERS > 1;
  static constexpr int PRODUCER_REGS = D == 64 ? 40 : 24;
  static constexpr int CONSUMER_REGS = D == 64 ? 232 : 240;
  static constexpr int ROWS_BYTES = BM * D * 2;
  static constexpr int TILE_BYTES = BN * D * 2;
  static constexpr int FIT = (SMEM_LIMIT - 1024 - 2 * ROWS_BYTES - 9 * 8) / (2 * TILE_BYTES);
  static constexpr int NSTAGE = FIT < 4 ? FIT : 4;  // KV tiles in flight
  // qs, do; K and V per stage; barriers
  static constexpr int SMEM_BYTES = 1024 + 2 * ROWS_BYTES + 2 * NSTAGE * TILE_BYTES + (2 * NSTAGE + 1) * 8;
  static_assert(D % 64 == 0 && NSTAGE >= 2 && SMEM_BYTES <= SMEM_LIMIT, "qs, do and two stages fit shared memory");
  static_assert(!HANDOVER || CONSUMERS * 128 * CONSUMER_REGS + 128 * PRODUCER_REGS <= 65536,
                "the register hand-over fits the register file");
  static_assert(ROW_PAD % BM == 0 && BM % ROW_TILE == 0, "the row padding serves every dq block");
};

// The dk/dv kernel at D = 64
constexpr int D64 = 64;
constexpr int KV_BN = 64;        // keys per dkv block: one consumer warpgroup
constexpr int KV_BM = ROW_TILE;  // rows per tile of the dkv sweep
constexpr int KV_NSTAGE = 4;     // row tiles in flight
constexpr int KV_THREADS = 256;  // the consumer warpgroup and the producer warpgroup
constexpr int KV_BLOCKS_PER_SM = 2;
// A warpgroup's registers sit in the SM's four quarters, 16384 each: a
// producer warp alone would make 5 warps a block (10 an SM) and cap every
// thread at 168 registers, which serialises the wgmma pipeline. So the
// producer is a warpgroup that gives its registers to the consumers
// (setmaxnreg).
constexpr int KV_PRODUCER_REGS = 24;
constexpr int KV_CONSUMER_REGS = 232;
constexpr int KV_BYTES = KV_BN * D64 * 2;
constexpr int KV_ROW_BYTES = KV_BM * D64 * 2;
// K, V; per stage qs, do, lse, delta; barriers
constexpr int KV_SMEM_BYTES =
    1024 + 2 * KV_BYTES + KV_NSTAGE * (2 * KV_ROW_BYTES + 2 * KV_BM * 4) + (2 * KV_NSTAGE + 1) * 8;

static_assert(128 * (KV_CONSUMER_REGS + KV_PRODUCER_REGS) <= 65536 / KV_BLOCKS_PER_SM,
              "the register hand-over fits the register file");
static_assert(ROW_PAD % KV_BM == 0, "the row padding serves the dkv tiles");

// The dk/dv kernel's instance at D = 128, 192, 256 (see the top of this file)
template <int D>
struct DkvSplit {
  static constexpr int ATOMS = D / 64;
  static constexpr int BN = 64;        // keys per block
  static constexpr int BM = ROW_TILE;  // rows per tile
  static constexpr int THREADS = 2 * 128 + 128;  // two consumer warpgroups and the producer warpgroup
  static constexpr int PRODUCER_REGS = 24;
  static constexpr int CONSUMER_REGS = 240;
  static constexpr int KV_BYTES = BN * D * 2;
  static constexpr int ROW_BYTES = BM * D * 2;
  static constexpr int STAGE_BYTES = 2 * ROW_BYTES + 2 * BM * 4;  // qs, do, lse, delta
  static constexpr int PF_BYTES = 2 * BN * BM * 4;                // P^T in fp32, two buffers
  static constexpr int FIXED = 1024 + 2 * KV_BYTES + PF_BYTES + 8;
  static constexpr int FIT = (SMEM_LIMIT - FIXED) / (STAGE_BYTES + 16);
  static constexpr int NSTAGE = FIT < 4 ? FIT : 4;  // row tiles in flight
  static constexpr int SMEM_BYTES = FIXED + NSTAGE * (STAGE_BYTES + 16);
  static_assert(D % 64 == 0 && D > 64 && NSTAGE >= 2 && SMEM_BYTES <= SMEM_LIMIT, "two stages fit shared memory");
  static_assert(BN == KV_BN, "64 keys a dk/dv block at every head dim");
  static_assert(2 * 128 * CONSUMER_REGS + 128 * PRODUCER_REGS <= 65536, "the hand-over fits the register file");
};

template <int D, bool HALO>
__global__ void __launch_bounds__(Dq<D>::THREADS, 1)
flash_bwd_dq_kernel(const __grid_constant__ CUtensorMap kmap, const __grid_constant__ CUtensorMap vmap,
                    const __grid_constant__ CUtensorMap qmap, const __grid_constant__ CUtensorMap domap,
                    const float* __restrict__ lse_g, const float* __restrict__ delta_g,
                    const float* __restrict__ cos_t, const float* __restrict__ sin_t, __nv_bfloat16* __restrict__ dq,
                    int T, int S, int H, int pad, int window, float scale, KeyFrame frame) {
  using C = Dq<D>;
  constexpr int BM = C::BM, BN = C::BN, NSTAGE = C::NSTAGE, ATOMS = C::ATOMS, CONSUMERS = C::CONSUMERS;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem);  // [ATOMS][BM][64] qs, swizzled
  __nv_bfloat16* Os = Qs + BM * D;                               // [ATOMS][BM][64] do
  __nv_bfloat16* Ks = Os + BM * D;                               // [NSTAGE][ATOMS][BN][64]
  __nv_bfloat16* Vs = Ks + NSTAGE * BN * D;                      // [NSTAGE][ATOMS][BN][64]
  uint64_t* full = reinterpret_cast<uint64_t*>(Vs + NSTAGE * BN * D);
  uint64_t* empty = full + NSTAGE;
  uint64_t* row_bar = empty + NSTAGE;

  const int b = blockIdx.y;
  const int rows = T * H;
  const int r0 = blockIdx.x * BM;
  const bool local = window >= 0;
  const int w2 = window / 2;
  const KeyFrame kf = HALO ? frame : KeyFrame{0, 0, S};
  const int off = kf.off, key_hi = kf.hi;
  const int t_lo = r0 / H;
  const int t_hi = (min(r0 + BM, rows) - 1) / H;
  const KeySpan span = keys_seen(kf, local, w2, t_lo, t_hi);  // the keys the block's rows see
  const int kv_lo = span.lo;
  const int n_tiles = (span.hi - kv_lo + BN - 1) / BN;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int s = 0; s < NSTAGE; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], CONSUMERS * 4);  // one arrival per consumer warp
    }
    mbar_init(row_bar, 1);
    fence_barrier_init();
  }
  __syncthreads();

  if (warp >= CONSUMERS * 4) {  // the producer warpgroup; one thread issues every copy
    if constexpr (C::HANDOVER) setmaxnreg_dec<C::PRODUCER_REGS>();
    if (warp == CONSUMERS * 4 && lane == 0) {
      mbar_expect_tx(row_bar, 2 * C::ROWS_BYTES);
#pragma unroll
      for (int a = 0; a < ATOMS; ++a) {
        for (int h = 0; h < BM / ROW_TILE; ++h) {  // rows past T*H arrive as zeros
          tma_load_3d(Qs + a * BM * 64 + h * ROW_TILE * 64, &qmap, row_bar, 64 * a, r0 + h * ROW_TILE, b);
          tma_load_3d(Os + a * BM * 64 + h * ROW_TILE * 64, &domap, row_bar, 64 * a, r0 + h * ROW_TILE, b);
        }
      }
      for (int it = 0; it < n_tiles; ++it) {
        const int st = it % NSTAGE;
        mbar_wait(&empty[st], ((it / NSTAGE) & 1) ^ 1);
        mbar_expect_tx(&full[st], 2 * C::TILE_BYTES);
        const int s0 = kv_lo + it * BN;  // keys past S arrive as zeros
#pragma unroll
        for (int a = 0; a < ATOMS; ++a) {  // one box per 64 columns of the head dim
          tma_load_4d(Ks + (st * ATOMS + a) * BN * 64, &kmap, &full[st], 64 * a, 0, s0, b);
          tma_load_4d(Vs + (st * ATOMS + a) * BN * 64, &vmap, &full[st], 64 * a, 0, s0, b);
        }
      }
    }
    return;
  }

  if constexpr (C::HANDOVER) setmaxnreg_inc<C::CONSUMER_REGS>();
  const int wg = warp / 4;  // consumer warpgroup: rows r0 + 64 wg ...
  const int g = lane >> 2;  // accumulator row (and row + 8) of this thread in its warp's 16
  const int tq = lane & 3;  // accumulator column pair
  const int row_a = r0 + wg * 64 + (warp % 4) * 16 + g;
  const int row_b = row_a + 8;
  const int tr[2] = {row_a / H, row_b / H};  // timesteps of the thread's two rows
  // the rows' statistics; the scratch is padded to whole blocks, a pad row has lse = +inf
  const float lse_r[2] = {lse_g[(size_t)b * pad + row_a], lse_g[(size_t)b * pad + row_b]};
  const float delta_r[2] = {delta_g[(size_t)b * pad + row_a], delta_g[(size_t)b * pad + row_b]};
  // the keys each of the two rows sees, [vis_lo, vis_lo + vis_n]: its window within the keys that exist, so
  // that an edge tile masks with one unsigned compare a key (a pad row may get an empty range: its p is 0 anyway)
  int vis_lo[2], vis_n[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const KeySpan seen = keys_seen(kf, local, w2, tr[i], tr[i]);
    vis_lo[i] = seen.lo;
    vis_n[i] = seen.hi - 1 - seen.lo;
  }
  // descriptor steps: 16 columns of K inside an atom, one atom of the rows and of a KV tile, 16 keys of MN-major K
  constexpr uint64_t K16 = 32 >> 4, ROW_ATOM = BM * 128 >> 4, KV_ATOM = BN * 128 >> 4, STEP16 = 16 * 128 >> 4;
  constexpr uint32_t LBO = ATOMS == 1 ? 1024 : BN * 128;  // K as B of dQ, N = D across its atoms (unread at 64)
  const uint64_t qdesc = desc_kmajor(Qs + wg * 64 * 64);
  const uint64_t odesc = desc_kmajor(Os + wg * 64 * 64);

  float acc[D / 2];  // dq_rot of the warpgroup's 64 rows
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  float s[BN / 2], dp[BN / 2];  // the tile's logits, then p; dp, then ds
  uint32_t ga[BN / 16][4];      // ds in bf16, the A operand of dQ += dS K

  // S = qs K^T and dP = do V^T of the tile in stage st, issued as two groups
  auto issue_products = [&](int st) {
    const uint64_t kdesc = desc_kmajor(Ks + st * BN * D), vdesc = desc_kmajor(Vs + st * BN * D);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint64_t step = (kk % 4) * K16;
      wgmma_ss<BN, 0, 0>(s, qdesc + (kk / 4) * ROW_ATOM + step, kdesc + (kk / 4) * KV_ATOM + step, kk);
    }
    wgmma_commit();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint64_t step = (kk % 4) * K16;
      wgmma_ss<BN, 0, 0>(dp, odesc + (kk / 4) * ROW_ATOM + step, vdesc + (kk / 4) * KV_ATOM + step, kk);
    }
    wgmma_commit();
  };
  // dQ += dS K with the previous tile's dS (ga) and the K of stage st, issued
  auto issue_dq = [&](int st) {
    const uint64_t kdesc_b = desc_mnmajor(Ks + st * BN * D, LBO);
#pragma unroll
    for (int j = 0; j < BN / 16; ++j) wgmma_rs<D, 1>(acc, ga[j], kdesc_b + j * STEP16, 1);
    wgmma_commit();
  };
  // s becomes p = exp2(s - lse2), zero outside the window and at or past
  // key_hi; only a tile at the window's edge or past key_hi is masked
  auto probabilities = [&](int it) {
    const int s0 = kv_lo + it * BN;
    const bool interior =
        s0 + BN <= key_hi && (!local || (s0 - off >= t_hi - w2 && s0 - off + BN - 1 <= t_lo + w2));
#pragma unroll
    for (int i = 0; i < BN / 8; ++i) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float p = exp2f(s[4 * i + e] - lse_r[e >> 1]);
        if (!interior) {
          const int key = s0 + i * 8 + 2 * tq + (e & 1);
          if ((unsigned)(key - vis_lo[e >> 1]) > (unsigned)vis_n[e >> 1]) p = 0.f;
        }
        s[4 * i + e] = p;
      }
    }
  };
  // dp becomes ds = p (dp - delta), then its bf16 A fragments
  auto gradients = [&]() {
#pragma unroll
    for (int i = 0; i < BN / 8; ++i) {
#pragma unroll
      for (int e = 0; e < 4; ++e) dp[4 * i + e] = s[4 * i + e] * (dp[4 * i + e] - delta_r[e >> 1]);
    }
  };
  auto release = [&](int st) {
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[st]);  // this warp is done with the stage
  };

  // Software pipeline: while the tensor cores run tile it's S and dP and tile
  // it - 1's dQ, this warpgroup waits only for S and computes p.
  mbar_wait(row_bar, 0);
  mbar_wait(&full[0], 0);
  reg_fence(s);
  reg_fence(dp);
  wgmma_fence();
  issue_products(0);
  wgmma_wait<1>();
  reg_fence(s);
  probabilities(0);
  wgmma_wait<0>();
  reg_fence(dp);
  gradients();
#pragma unroll
  for (int j = 0; j < BN / 16; ++j) a_frag(ga[j], dp + 8 * j);
  for (int it = 1; it < n_tiles; ++it) {
    const int st = it % NSTAGE, prev = (it - 1) % NSTAGE;
    mbar_wait(&full[st], (it / NSTAGE) & 1);
    reg_fence(s);
    reg_fence(dp);
    reg_fence(acc);
    reg_fence(ga);
    wgmma_fence();
    issue_products(st);
    issue_dq(prev);
    wgmma_wait<2>();  // S (committed first) is in
    reg_fence(s);
    probabilities(it);
    wgmma_wait<1>();  // and dP
    reg_fence(dp);
    gradients();
    wgmma_wait<0>();  // and the previous tile's dQ: its K and ga are free
    reg_fence(acc);
    reg_fence(ga);
    release(prev);
#pragma unroll
    for (int j = 0; j < BN / 16; ++j) a_frag(ga[j], dp + 8 * j);
  }
  reg_fence(acc);
  reg_fence(ga);
  wgmma_fence();
  issue_dq((n_tiles - 1) % NSTAGE);
  wgmma_wait<0>();
  reg_fence(acc);
  reg_fence(ga);
  release((n_tiles - 1) % NSTAGE);

  // un-rotate into the raw q's frame (g cos - rot_half(g sin); columns d and
  // d + D/2 sit in the same thread, registers 4j.. and 4(j + D/16)..), apply
  // scale, one bf16 store per row; the halo frame's q was rotated by the
  // caller, so its dq stays in that frame
  __nv_bfloat16* dqb = dq + (size_t)b * rows * D;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = i == 0 ? row_a : row_b;
    if (row >= rows) continue;
    __nv_bfloat16* dst = dqb + (size_t)row * D;
    if constexpr (HALO) {
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        *reinterpret_cast<uint32_t*>(dst + j * 8 + 2 * tq) =
            pack_bf16(acc[4 * j + 2 * i] * scale, acc[4 * j + 2 * i + 1] * scale);
      }
    } else {
      const float* cr = cos_t + (size_t)tr[i] * D;
      const float* sr = sin_t + (size_t)tr[i] * D;
#pragma unroll
      for (int j = 0; j < D / 16; ++j) {
        const int col = j * 8 + 2 * tq;
        const float2 c_lo = *reinterpret_cast<const float2*>(cr + col);
        const float2 c_hi = *reinterpret_cast<const float2*>(cr + col + D / 2);
        const float2 s_lo = *reinterpret_cast<const float2*>(sr + col);
        const float2 s_hi = *reinterpret_cast<const float2*>(sr + col + D / 2);
        const float g_lo0 = acc[4 * j + 2 * i], g_lo1 = acc[4 * j + 2 * i + 1];
        const float g_hi0 = acc[4 * (j + D / 16) + 2 * i], g_hi1 = acc[4 * (j + D / 16) + 2 * i + 1];
        *reinterpret_cast<uint32_t*>(dst + col) =
            pack_bf16((g_lo0 * c_lo.x + g_hi0 * s_hi.x) * scale, (g_lo1 * c_lo.y + g_hi1 * s_hi.y) * scale);
        *reinterpret_cast<uint32_t*>(dst + col + D / 2) =
            pack_bf16((g_hi0 * c_hi.x - g_lo0 * s_lo.x) * scale, (g_hi1 * c_hi.y - g_lo1 * s_lo.y) * scale);
      }
    }
  }
}

// The block's rows of a dkv sweep: the keys of the block that exist, [k_lo,
// k_hi], and the rows whose window reaches them, [row_lo, row_hi), from a
// whole tile on (16-byte aligned for the bulk copies; the rows before the
// window are masked). n_tiles is 0 for a block with no key inside [lo, hi).
struct DkvRows {
  int s_last, k_lo, k_hi, row_lo, row_hi, n_tiles;
};

__device__ __forceinline__ DkvRows dkv_rows(const KeyFrame& kf, bool local, int w2, int s0, int block_keys, int S,
                                            int T, int H, int tile) {
  DkvRows r;
  r.s_last = min(S, s0 + block_keys) - 1;
  r.k_lo = max(s0, kf.lo);
  r.k_hi = min(r.s_last, kf.hi - 1);
  r.row_lo = local ? max(0, r.k_lo - kf.off - w2) * H / tile * tile : 0;
  r.row_hi = (local ? min(T, r.k_hi - kf.off + w2 + 1) : T) * H;
  r.n_tiles = r.k_lo <= r.k_hi ? (r.row_hi - r.row_lo + tile - 1) / tile : 0;
  return r;
}

// a halo block with no key inside the song: dk = dv = 0 for its keys, no sweep
__device__ __forceinline__ void zero_keys(float* dk, float* dv, int b, int s0, int block_keys, int S, int D,
                                          int threads) {
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int i = threadIdx.x; i < block_keys * D / 4; i += threads) {
    const int key = s0 + i / (D / 4);
    if (key < S) {
      reinterpret_cast<float4*>(dk + ((size_t)b * S + key) * D)[i % (D / 4)] = zero;
      reinterpret_cast<float4*>(dv + ((size_t)b * S + key) * D)[i % (D / 4)] = zero;
    }
  }
}

template <bool HALO>
__global__ void __launch_bounds__(KV_THREADS, KV_BLOCKS_PER_SM)
flash_bwd_dkv_kernel(const __grid_constant__ CUtensorMap kmap, const __grid_constant__ CUtensorMap vmap,
                     const __grid_constant__ CUtensorMap qmap, const __grid_constant__ CUtensorMap domap,
                     const float* __restrict__ lse_g, const float* __restrict__ delta_g, float* __restrict__ dk,
                     float* __restrict__ dv, int T, int S, int H, int pad, int window, KeyFrame frame) {
  constexpr int D = D64;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  __nv_bfloat16* Ks = reinterpret_cast<__nv_bfloat16*>(smem);  // [KV_BN][D]
  __nv_bfloat16* Vs = Ks + KV_BN * D;                            // [KV_BN][D]
  __nv_bfloat16* Qs = Vs + KV_BN * D;                            // [KV_NSTAGE][KV_BM][D] qs
  __nv_bfloat16* Os = Qs + KV_NSTAGE * KV_BM * D;                // [KV_NSTAGE][KV_BM][D] do
  float* Ls = reinterpret_cast<float*>(Os + KV_NSTAGE * KV_BM * D);  // [KV_NSTAGE][KV_BM] lse
  float* Es = Ls + KV_NSTAGE * KV_BM;                                // [KV_NSTAGE][KV_BM] delta
  uint64_t* full = reinterpret_cast<uint64_t*>(Es + KV_NSTAGE * KV_BM);
  uint64_t* empty = full + KV_NSTAGE;
  uint64_t* kv_bar = empty + KV_NSTAGE;

  const int b = blockIdx.y;
  const int s0 = blockIdx.x * KV_BN;
  const bool local = window >= 0;
  const int w2 = window / 2;
  const KeyFrame kf = HALO ? frame : KeyFrame{0, 0, S};
  const int off = kf.off, key_lo = kf.lo, key_hi = kf.hi;
  const DkvRows span = dkv_rows(kf, local, w2, s0, KV_BN, S, T, H, KV_BM);
  const int s_last = span.s_last, row_lo = span.row_lo, n_tiles = span.n_tiles;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  if (HALO && n_tiles <= 0) {  // no key of the block inside the song: zeros, and no sweep
    zero_keys(dk, dv, b, s0, KV_BN, S, D, KV_THREADS);
    return;
  }

  if (threadIdx.x == 0) {
    for (int s = 0; s < KV_NSTAGE; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4);  // one arrival per consumer warp
    }
    mbar_init(kv_bar, 1);
    fence_barrier_init();
  }
  __syncthreads();

  if (warp >= 4) {  // the producer warpgroup; one thread issues every copy
    setmaxnreg_dec<KV_PRODUCER_REGS>();
    if (warp == 4 && lane == 0) {
      mbar_expect_tx(kv_bar, 2 * KV_BYTES);
      tma_load_4d(Ks, &kmap, kv_bar, 0, 0, s0, b);  // keys past S arrive as zeros
      tma_load_4d(Vs, &vmap, kv_bar, 0, 0, s0, b);
      const float* lb = lse_g + (size_t)b * pad;
      const float* eb = delta_g + (size_t)b * pad;
      for (int it = 0; it < n_tiles; ++it) {
        const int st = it % KV_NSTAGE;
        const int r0 = row_lo + it * KV_BM;  // a whole tile below pad: rows past T*H arrive as zeros, lse +inf
        mbar_wait(&empty[st], ((it / KV_NSTAGE) & 1) ^ 1);
        mbar_expect_tx(&full[st], 2 * KV_ROW_BYTES + 2 * KV_BM * 4);
        tma_load_3d(Qs + st * KV_BM * D, &qmap, &full[st], 0, r0, b);
        tma_load_3d(Os + st * KV_BM * D, &domap, &full[st], 0, r0, b);
        bulk_load(Ls + st * KV_BM, lb + r0, KV_BM * 4, &full[st]);
        bulk_load(Es + st * KV_BM, eb + r0, KV_BM * 4, &full[st]);
      }
    }
    return;
  }

  setmaxnreg_inc<KV_CONSUMER_REGS>();
  const int g = lane >> 2;  // accumulator row (and row + 8) in the warp's 16
  const int tq = lane & 3;  // accumulator column pair
  const int key_a = s0 + warp * 16 + g;  // this thread's two keys (rows of S^T, dk, dv)
  const int key_b = key_a + 8;
  const bool in_a = key_a >= key_lo && key_a < key_hi, in_b = key_b >= key_lo && key_b < key_hi;
  // the timesteps each key is seen from, [vis_a, vis_a + vis_n]: the window around its place on the queries'
  // diagonal (key - off), so that an edge tile masks with one unsigned compare; none for a key outside
  // [key_lo, key_hi) (its start lies far past every timestep)
  const int vis_n = local ? 2 * w2 : INT_MAX;
  const int vis_a = !in_a ? 1 << 30 : local ? key_a - off - w2 : 0;
  const int vis_b = !in_b ? 1 << 30 : local ? key_b - off - w2 : 0;
  const bool keys_inside = s0 >= key_lo && s0 + KV_BN <= key_hi;
  const uint64_t kdesc = desc_kmajor(Ks);  // K of the block's keys, as A
  const uint64_t vdesc = desc_kmajor(Vs);

  float dv_acc[32], dk_acc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) dv_acc[i] = dk_acc[i] = 0.f;
  float s[32], dp[32];                       // S^T, then P^T; dP^T, then dS^T (keys x the tile's rows)
  uint32_t pa[KV_BM / 16][4], ga[KV_BM / 16][4];  // P^T and dS^T in bf16, the A operands of dV and dK

  // S^T = K qs^T and dP^T = V do^T of the tile in stage st, issued as two groups
  auto issue_products = [&](int st) {
    const uint64_t qdesc = desc_kmajor(Qs + st * KV_BM * D), odesc = desc_kmajor(Os + st * KV_BM * D);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) wgmma_ss_n64<0, 0>(s, kdesc + 2 * kk, qdesc + 2 * kk, kk);
    wgmma_commit();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) wgmma_ss_n64<0, 0>(dp, vdesc + 2 * kk, odesc + 2 * kk, kk);
    wgmma_commit();
  };
  // dV += P^T do and dK += dS^T qs with the previous tile's pa, ga and its
  // stage st (do and qs read MN-major), issued as one group
  auto issue_dkv = [&](int st) {
    const uint64_t qdesc_b = desc_mnmajor(Qs + st * KV_BM * D), odesc_b = desc_mnmajor(Os + st * KV_BM * D);
#pragma unroll
    for (int j = 0; j < KV_BM / 16; ++j) wgmma_rs_n64<1>(dv_acc, pa[j], odesc_b + j * (16 * 128 >> 4), 1);
#pragma unroll
    for (int j = 0; j < KV_BM / 16; ++j) wgmma_rs_n64<1>(dk_acc, ga[j], qdesc_b + j * (16 * 128 >> 4), 1);
    wgmma_commit();
  };
  // s becomes p = exp2(s - lse2) (zero outside the window and for a key
  // outside [key_lo, key_hi); a pad row has lse = +inf); only a tile whose
  // timesteps touch the window's edge, or a block with such keys, is masked
  auto probabilities = [&](int it) {
    const int st = it % KV_NSTAGE;
    const int r0 = row_lo + it * KV_BM;
    const int t_a = r0 / H, t_b = (r0 + KV_BM - 1) / H;
    const bool interior = keys_inside && (!local || (s_last - off - t_a <= w2 && t_b - (s0 - off) <= w2));
    const float* lt = Ls + st * KV_BM;
#pragma unroll
    for (int i = 0; i < KV_BM / 8; ++i) {
      const float2 l2 = *reinterpret_cast<const float2*>(lt + 8 * i + 2 * tq);
      s[4 * i] = exp2f(s[4 * i] - l2.x);
      s[4 * i + 1] = exp2f(s[4 * i + 1] - l2.y);
      s[4 * i + 2] = exp2f(s[4 * i + 2] - l2.x);
      s[4 * i + 3] = exp2f(s[4 * i + 3] - l2.y);
      if (!interior) {
        const int row = r0 + 8 * i + 2 * tq;  // this thread's two columns: rows row, row + 1
        const int tx = row / H, ty = (row + 1) / H;
        if ((unsigned)(tx - vis_a) > (unsigned)vis_n) s[4 * i] = 0.f;
        if ((unsigned)(ty - vis_a) > (unsigned)vis_n) s[4 * i + 1] = 0.f;
        if ((unsigned)(tx - vis_b) > (unsigned)vis_n) s[4 * i + 2] = 0.f;
        if ((unsigned)(ty - vis_b) > (unsigned)vis_n) s[4 * i + 3] = 0.f;
      }
    }
  };
  // dp becomes ds = p (dp - delta)
  auto gradients = [&](int it) {
    const float* et = Es + (it % KV_NSTAGE) * KV_BM;
#pragma unroll
    for (int i = 0; i < KV_BM / 8; ++i) {
      const float2 e2 = *reinterpret_cast<const float2*>(et + 8 * i + 2 * tq);
      dp[4 * i] = s[4 * i] * (dp[4 * i] - e2.x);
      dp[4 * i + 1] = s[4 * i + 1] * (dp[4 * i + 1] - e2.y);
      dp[4 * i + 2] = s[4 * i + 2] * (dp[4 * i + 2] - e2.x);
      dp[4 * i + 3] = s[4 * i + 3] * (dp[4 * i + 3] - e2.y);
    }
  };
  auto fragments = [&]() {
#pragma unroll
    for (int j = 0; j < KV_BM / 16; ++j) {
      a_frag(pa[j], s + 8 * j);
      a_frag(ga[j], dp + 8 * j);
    }
  };
  auto release = [&](int st) {
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[st]);  // this warp is done with the stage
  };

  // Software pipeline: while the tensor cores run tile it's S^T and dP^T and
  // tile it - 1's dV and dK, this warpgroup waits only for S^T and computes p.
  mbar_wait(kv_bar, 0);
  mbar_wait(&full[0], 0);
  reg_fence(s);
  reg_fence(dp);
  wgmma_fence();
  issue_products(0);
  wgmma_wait<1>();
  reg_fence(s);
  probabilities(0);
  wgmma_wait<0>();
  reg_fence(dp);
  gradients(0);
  fragments();
  for (int it = 1; it < n_tiles; ++it) {
    const int st = it % KV_NSTAGE, prev = (it - 1) % KV_NSTAGE;
    mbar_wait(&full[st], (it / KV_NSTAGE) & 1);
    reg_fence(s);
    reg_fence(dp);
    reg_fence(dv_acc);
    reg_fence(dk_acc);
    reg_fence(pa);
    reg_fence(ga);
    wgmma_fence();
    issue_products(st);
    issue_dkv(prev);
    wgmma_wait<2>();  // S^T (committed first) is in
    reg_fence(s);
    probabilities(it);
    wgmma_wait<1>();  // and dP^T
    reg_fence(dp);
    gradients(it);
    wgmma_wait<0>();  // and the previous tile's dV, dK: its stage, pa and ga are free
    reg_fence(dv_acc);
    reg_fence(dk_acc);
    reg_fence(pa);
    reg_fence(ga);
    release(prev);
    fragments();
  }
  reg_fence(dv_acc);
  reg_fence(dk_acc);
  reg_fence(pa);
  reg_fence(ga);
  wgmma_fence();
  issue_dkv((n_tiles - 1) % KV_NSTAGE);
  wgmma_wait<0>();
  reg_fence(dv_acc);
  reg_fence(dk_acc);
  release((n_tiles - 1) % KV_NSTAGE);

  // a halo key outside the song gets exact zeros (its p was 0 on every row)
  auto put = [&](float* dst, bool in, float x, float y) {
    *reinterpret_cast<float2*>(dst) = HALO && !in ? make_float2(0.f, 0.f) : make_float2(x, y);
  };
  float* dkb = dk + (size_t)b * S * D;
  float* dvb = dv + (size_t)b * S * D;
#pragma unroll
  for (int i = 0; i < D / 8; ++i) {
    const int col = 8 * i + 2 * tq;
    if (key_a < S) {
      put(dkb + (size_t)key_a * D + col, in_a, dk_acc[4 * i] * LN2, dk_acc[4 * i + 1] * LN2);
      put(dvb + (size_t)key_a * D + col, in_a, dv_acc[4 * i], dv_acc[4 * i + 1]);
    }
    if (key_b < S) {
      put(dkb + (size_t)key_b * D + col, in_b, dk_acc[4 * i + 2] * LN2, dk_acc[4 * i + 3] * LN2);
      put(dvb + (size_t)key_b * D + col, in_b, dv_acc[4 * i + 2], dv_acc[4 * i + 3]);
    }
  }
}

// The dk/dv kernel at D = 128, 192, 256: one block per (batch element, 64
// keys). Warpgroup 0 computes S^T = K qs^T and P^T = exp2(S^T - lse2), keeps
// dV += P^T do and passes P^T (fp32) through shared memory; warpgroup 1
// computes dP^T = V do^T and dS^T = P^T (dP^T - delta) and keeps dK += dS^T
// qs. A thread of either holds the same (key, row) entries of its 64 x 64
// product, so P^T crosses as one register a thread.
template <int D, bool HALO>
__global__ void __launch_bounds__(DkvSplit<D>::THREADS, 1)
flash_bwd_dkv_split_kernel(const __grid_constant__ CUtensorMap kmap, const __grid_constant__ CUtensorMap vmap,
                           const __grid_constant__ CUtensorMap qmap, const __grid_constant__ CUtensorMap domap,
                           const float* __restrict__ lse_g, const float* __restrict__ delta_g, float* __restrict__ dk,
                           float* __restrict__ dv, int T, int S, int H, int pad, int window, KeyFrame frame) {
  using C = DkvSplit<D>;
  constexpr int BN = C::BN, BM = C::BM, NSTAGE = C::NSTAGE, ATOMS = C::ATOMS;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  __nv_bfloat16* Ks = reinterpret_cast<__nv_bfloat16*>(smem);  // [ATOMS][BN][64]
  __nv_bfloat16* Vs = Ks + BN * D;                               // [ATOMS][BN][64]
  __nv_bfloat16* Qs = Vs + BN * D;                               // [NSTAGE][ATOMS][BM][64] qs
  __nv_bfloat16* Os = Qs + NSTAGE * BM * D;                      // [NSTAGE][ATOMS][BM][64] do
  float* Pf = reinterpret_cast<float*>(Os + NSTAGE * BM * D);    // [2][BN * BM / 128][128] P^T
  float* Ls = Pf + 2 * BN * BM;                                  // [NSTAGE][BM] lse
  float* Es = Ls + NSTAGE * BM;                                  // [NSTAGE][BM] delta
  uint64_t* full = reinterpret_cast<uint64_t*>(Es + NSTAGE * BM);
  uint64_t* empty = full + NSTAGE;
  uint64_t* kv_bar = empty + NSTAGE;

  const int b = blockIdx.y;
  const int s0 = blockIdx.x * BN;
  const bool local = window >= 0;
  const int w2 = window / 2;
  const KeyFrame kf = HALO ? frame : KeyFrame{0, 0, S};
  const int off = kf.off, key_lo = kf.lo, key_hi = kf.hi;
  const DkvRows span = dkv_rows(kf, local, w2, s0, BN, S, T, H, BM);
  const int s_last = span.s_last, row_lo = span.row_lo, n_tiles = span.n_tiles;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  if (HALO && n_tiles <= 0) {  // no key of the block inside the song: zeros, and no sweep
    zero_keys(dk, dv, b, s0, BN, S, D, C::THREADS);
    return;
  }

  if (threadIdx.x == 0) {
    for (int s = 0; s < NSTAGE; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);  // one arrival per consumer warp of both warpgroups
    }
    mbar_init(kv_bar, 1);
    fence_barrier_init();
  }
  __syncthreads();

  if (warp >= 8) {  // the producer warpgroup; one thread issues every copy
    setmaxnreg_dec<C::PRODUCER_REGS>();
    if (warp == 8 && lane == 0) {
      mbar_expect_tx(kv_bar, 2 * C::KV_BYTES);
#pragma unroll
      for (int a = 0; a < ATOMS; ++a) {  // keys past S arrive as zeros
        tma_load_4d(Ks + a * BN * 64, &kmap, kv_bar, 64 * a, 0, s0, b);
        tma_load_4d(Vs + a * BN * 64, &vmap, kv_bar, 64 * a, 0, s0, b);
      }
      const float* lb = lse_g + (size_t)b * pad;
      const float* eb = delta_g + (size_t)b * pad;
      for (int it = 0; it < n_tiles; ++it) {
        const int st = it % NSTAGE;
        const int r0 = row_lo + it * BM;  // a whole tile below pad: rows past T*H arrive as zeros, lse +inf
        mbar_wait(&empty[st], ((it / NSTAGE) & 1) ^ 1);
        mbar_expect_tx(&full[st], C::STAGE_BYTES);
#pragma unroll
        for (int a = 0; a < ATOMS; ++a) {
          tma_load_3d(Qs + (st * ATOMS + a) * BM * 64, &qmap, &full[st], 64 * a, r0, b);
          tma_load_3d(Os + (st * ATOMS + a) * BM * 64, &domap, &full[st], 64 * a, r0, b);
        }
        bulk_load(Ls + st * BM, lb + r0, BM * 4, &full[st]);
        bulk_load(Es + st * BM, eb + r0, BM * 4, &full[st]);
      }
    }
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
  const bool in_a = key_a >= key_lo && key_a < key_hi, in_b = key_b >= key_lo && key_b < key_hi;
  // the timesteps each key is seen from, as in flash_bwd_dkv_kernel
  const int vis_n = local ? 2 * w2 : INT_MAX;
  const int vis_a = !in_a ? 1 << 30 : local ? key_a - off - w2 : 0;
  const int vis_b = !in_b ? 1 << 30 : local ? key_b - off - w2 : 0;
  const bool keys_inside = s0 >= key_lo && s0 + BN <= key_hi;
  // descriptor steps: 16 columns of K inside an atom, one atom of the K / V tile and of a row tile, 16 rows
  constexpr uint64_t K16 = 32 >> 4, KV_ATOM = BN * 128 >> 4, ROW_ATOM = BM * 128 >> 4, STEP16 = 16 * 128 >> 4;
  const uint64_t adesc = desc_kmajor(wg == 0 ? Ks : Vs);  // A of the first product: K or V
  const __nv_bfloat16* Xs = wg == 0 ? Qs : Os;  // B of the first product (K-major): qs or do
  const __nv_bfloat16* Ys = wg == 0 ? Os : Qs;  // B of the kept product (MN-major, N = D): do or qs

  float acc[D / 2];  // warpgroup 0: dV; 1: dK (times ln 2 at the end)
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  float s[32];                // S^T, then P^T (warpgroup 0); dP^T, then dS^T (warpgroup 1)
  uint32_t fr[BM / 16][4];    // P^T or dS^T in bf16, the A operand of the kept product

  // warpgroup 0: S^T = K qs^T; 1: dP^T = V do^T, of the tile in stage st, issued
  auto issue_first = [&](int st) {
    const uint64_t xdesc = desc_kmajor(Xs + st * BM * D);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint64_t step = (kk % 4) * K16;
      wgmma_ss_n64<0, 0>(s, adesc + (kk / 4) * KV_ATOM + step, xdesc + (kk / 4) * ROW_ATOM + step, kk);
    }
    wgmma_commit();
  };
  // warpgroup 0: dV += P^T do; 1: dK += dS^T qs, with the previous tile's fr and its stage st, issued
  auto issue_kept = [&](int st) {
    const uint64_t ydesc = desc_mnmajor(Ys + st * BM * D, BM * 128);
#pragma unroll
    for (int j = 0; j < BM / 16; ++j) wgmma_rs<D, 1>(acc, fr[j], ydesc + j * STEP16, 1);
    wgmma_commit();
  };
  // warpgroup 0: s becomes p = exp2(s - lse2) (zero outside the window and
  // for a key outside [key_lo, key_hi); a pad row has lse = +inf), written to
  // the tile's P^T buffer; only a tile whose timesteps touch the window's
  // edge, or a block with such keys, is masked
  auto probabilities = [&](int it) {
    const int st = it % NSTAGE;
    const int r0 = row_lo + it * BM;
    const int t_a = r0 / H, t_b = (r0 + BM - 1) / H;
    const bool interior = keys_inside && (!local || (s_last - off - t_a <= w2 && t_b - (s0 - off) <= w2));
    const float* lt = Ls + st * BM;
#pragma unroll
    for (int i = 0; i < BM / 8; ++i) {
      const float2 l2 = *reinterpret_cast<const float2*>(lt + 8 * i + 2 * tq);
      s[4 * i] = exp2f(s[4 * i] - l2.x);
      s[4 * i + 1] = exp2f(s[4 * i + 1] - l2.y);
      s[4 * i + 2] = exp2f(s[4 * i + 2] - l2.x);
      s[4 * i + 3] = exp2f(s[4 * i + 3] - l2.y);
      if (!interior) {
        const int row = r0 + 8 * i + 2 * tq;  // this thread's two columns: rows row, row + 1
        const int tx = row / H, ty = (row + 1) / H;
        if ((unsigned)(tx - vis_a) > (unsigned)vis_n) s[4 * i] = 0.f;
        if ((unsigned)(ty - vis_a) > (unsigned)vis_n) s[4 * i + 1] = 0.f;
        if ((unsigned)(tx - vis_b) > (unsigned)vis_n) s[4 * i + 2] = 0.f;
        if ((unsigned)(ty - vis_b) > (unsigned)vis_n) s[4 * i + 3] = 0.f;
      }
    }
    float* pf = Pf + (it & 1) * BN * BM;
#pragma unroll
    for (int i = 0; i < 32; ++i) pf[i * 128 + tid] = s[i];
  };
  // warpgroup 1: dp becomes ds = p (dp - delta), p read from the tile's P^T buffer
  auto gradients = [&](int it) {
    const float* pf = Pf + (it & 1) * BN * BM;
    const float* et = Es + (it % NSTAGE) * BM;
#pragma unroll
    for (int i = 0; i < BM / 8; ++i) {
      const float2 e2 = *reinterpret_cast<const float2*>(et + 8 * i + 2 * tq);
      s[4 * i] = pf[(4 * i) * 128 + tid] * (s[4 * i] - e2.x);
      s[4 * i + 1] = pf[(4 * i + 1) * 128 + tid] * (s[4 * i + 1] - e2.y);
      s[4 * i + 2] = pf[(4 * i + 2) * 128 + tid] * (s[4 * i + 2] - e2.x);
      s[4 * i + 3] = pf[(4 * i + 3) * 128 + tid] * (s[4 * i + 3] - e2.y);
    }
  };
  // P^T or dS^T of the tile in hand: warpgroup 0 computes it, shares it and
  // meets warpgroup 1 at a named barrier, which then reads it. The P^T
  // buffers alternate by tile: warpgroup 0 writes a buffer again only after
  // the next tile's barrier, which warpgroup 1 reaches after reading it.
  auto first_to_fragments = [&](int it) {
    if (wg == 0) probabilities(it);
    named_bar_sync(1, 256);  // P^T of tile it is in place
    if (wg == 1) gradients(it);
  };
  auto fragments = [&]() {
#pragma unroll
    for (int j = 0; j < BM / 16; ++j) a_frag(fr[j], s + 8 * j);
  };
  auto release = [&](int st) {
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[st]);  // this warp is done with the stage
  };

  // Software pipeline: each warpgroup issues tile it's first product and tile
  // it - 1's kept one together, and waits only for the first.
  mbar_wait(kv_bar, 0);
  mbar_wait(&full[0], 0);
  reg_fence(s);
  wgmma_fence();
  issue_first(0);
  wgmma_wait<0>();
  reg_fence(s);
  first_to_fragments(0);
  fragments();
  for (int it = 1; it < n_tiles; ++it) {
    const int st = it % NSTAGE, prev = (it - 1) % NSTAGE;
    mbar_wait(&full[st], (it / NSTAGE) & 1);
    reg_fence(s);
    reg_fence(acc);
    reg_fence(fr);
    wgmma_fence();
    issue_first(st);
    issue_kept(prev);
    wgmma_wait<1>();  // the first product (committed first) is in
    reg_fence(s);
    first_to_fragments(it);
    wgmma_wait<0>();  // and the previous tile's kept product: its stage and fr are free
    reg_fence(acc);
    reg_fence(fr);
    release(prev);
    fragments();
  }
  reg_fence(acc);
  reg_fence(fr);
  wgmma_fence();
  issue_kept((n_tiles - 1) % NSTAGE);
  wgmma_wait<0>();
  reg_fence(acc);
  reg_fence(fr);
  release((n_tiles - 1) % NSTAGE);

  // warpgroup 0 stores dv, 1 dk (times ln 2); a halo key outside the song gets exact zeros
  const float mul = wg == 0 ? 1.f : LN2;
  float* dst = (wg == 0 ? dv : dk) + (size_t)b * S * D;
  auto put = [&](float* p, bool in, float x, float y) {
    *reinterpret_cast<float2*>(p) = HALO && !in ? make_float2(0.f, 0.f) : make_float2(x * mul, y * mul);
  };
#pragma unroll
  for (int i = 0; i < D / 8; ++i) {
    const int col = 8 * i + 2 * tq;
    if (key_a < S) put(dst + (size_t)key_a * D + col, in_a, acc[4 * i], acc[4 * i + 1]);
    if (key_b < S) put(dst + (size_t)key_b * D + col, in_b, acc[4 * i + 2], acc[4 * i + 3]);
  }
}

// (D, rows, B) bf16 rows of a t-major (B, rows, D) buffer, boxes of ROW_TILE
// rows and 64 of the head dim (one swizzle atom; a tile of D > 64 loads as D
// / 64 boxes); rows past `rows` arrive as zeros
int make_rows_map(CUtensorMap* map, const void* ptr, int rows, int B, int D) {
  const cuuint64_t dims[3] = {(cuuint64_t)D, (cuuint64_t)rows, (cuuint64_t)B};
  const cuuint64_t strides[2] = {(cuuint64_t)D * 2, (cuuint64_t)rows * D * 2};
  const cuuint32_t box[3] = {64, ROW_TILE, 1};
  return make_map_bf16(map, 3, ptr, dims, strides, box);
}

// The dq kernel of head dim D in either frame over S keys: tensor maps, shared memory, launch
template <int D, bool HALO>
int launch_dq(const void* k, const void* v, const void* dout, const void* qs_g, const void* lse_g,
              const void* delta_g, const void* cos_t, const void* sin_t, void* dq, int B, int T, int S, int H, int pad,
              int window, float scale, KeyFrame frame, void* stream) {
  using C = Dq<D>;
  if (pad % ROW_PAD != 0 || pad < T * H) return (int)cudaErrorInvalidValue;
  static std::atomic<unsigned long long> smem_set{0};  // devices whose limit is raised
  CUtensorMap kmap, vmap, qmap, domap;
  int dev;
  int err = bind_device(&dev);
  if (err == 0) err = make_kv_map(&kmap, k, B, S, 1, C::BN, D);
  if (err == 0) err = make_kv_map(&vmap, v, B, S, 1, C::BN, D);
  if (err == 0) err = make_rows_map(&qmap, qs_g, T * H, B, D);
  if (err == 0) err = make_rows_map(&domap, dout, T * H, B, D);
  if (err == 0) err = allow_smem(flash_bwd_dq_kernel<D, HALO>, C::SMEM_BYTES, dev, smem_set);
  if (err != 0) return err;
  flash_bwd_dq_kernel<D, HALO><<<dim3(pad / C::BM, B), C::THREADS, C::SMEM_BYTES, static_cast<cudaStream_t>(stream)>>>(
      kmap, vmap, qmap, domap, static_cast<const float*>(lse_g), static_cast<const float*>(delta_g),
      static_cast<const float*>(cos_t), static_cast<const float*>(sin_t), static_cast<__nv_bfloat16*>(dq), T, S, H,
      pad, window, scale, frame);
  return (int)cudaGetLastError();
}

// The dk/dv kernel of head dim D in either frame over S keys
template <int D, bool HALO>
int launch_dkv(const void* k, const void* v, const void* dout, const void* qs_g, const void* lse_g,
               const void* delta_g, void* dk, void* dv, int B, int T, int S, int H, int pad, int window, KeyFrame frame,
               void* stream) {
  if (pad % ROW_PAD != 0 || pad < T * H) return (int)cudaErrorInvalidValue;
  static std::atomic<unsigned long long> smem_set{0};  // devices whose limit is raised
  constexpr int block_keys = KV_BN;  // at every D (DkvSplit::BN)
  CUtensorMap kmap, vmap, qmap, domap;
  int dev;
  int err = bind_device(&dev);
  if (err == 0) err = make_kv_map(&kmap, k, B, S, 1, block_keys, D);
  if (err == 0) err = make_kv_map(&vmap, v, B, S, 1, block_keys, D);
  if (err == 0) err = make_rows_map(&qmap, qs_g, T * H, B, D);
  if (err == 0) err = make_rows_map(&domap, dout, T * H, B, D);
  if (err != 0) return err;
  auto start = [&](auto kernel, int threads, int smem_bytes) {
    const int e = allow_smem(kernel, smem_bytes, dev, smem_set);
    if (e != 0) return e;
    kernel<<<dim3((S + block_keys - 1) / block_keys, B), threads, smem_bytes, static_cast<cudaStream_t>(stream)>>>(
        kmap, vmap, qmap, domap, static_cast<const float*>(lse_g), static_cast<const float*>(delta_g),
        static_cast<float*>(dk), static_cast<float*>(dv), T, S, H, pad, window, frame);
    return 0;
  };
  if constexpr (D == 64)
    err = start(flash_bwd_dkv_kernel<HALO>, KV_THREADS, KV_SMEM_BYTES);
  else
    err = start(flash_bwd_dkv_split_kernel<D, HALO>, DkvSplit<D>::THREADS, DkvSplit<D>::SMEM_BYTES);
  if (err != 0) return err;
  return (int)cudaGetLastError();
}

}  // namespace

// The instances of head dim D: CALL(D) for D in 64, 128, 192, 256, else
// cudaErrorInvalidValue.
#define WINDOWED_HEAD_DIMS(CALL)                 \
  switch (D) {                                   \
    case 64: return CALL(64);                    \
    case 128: return CALL(128);                  \
    case 192: return CALL(192);                  \
    case 256: return CALL(256);                  \
    default: return (int)cudaErrorInvalidValue;  \
  }

// The scratch, allocated by the caller: qs_g (B, T*H, D) bf16, lse_g and
// delta_g (B, pad) fp32, pad = T*H rounded up to a multiple of ROW_PAD (128).
// With null tables (the halo pair: q arrives rotated) q is only scaled.
extern "C" int flash_bwd_windowed_prep_bf16(int D, const void* q, const void* dout, const void* o, const void* lse,
                                            const void* cos_t, const void* sin_t, void* qs_g, void* lse_g,
                                            void* delta_g, int B, int T, int H, int pad, float scale, void* stream) {
  if (pad % ROW_PAD != 0 || pad < T * H) return (int)cudaErrorInvalidValue;
#define CALL(DD)                                                                                                       \
  [&] {                                                                                                                \
    auto prep = cos_t != nullptr ? flash_bwd_prep_kernel<DD, true> : flash_bwd_prep_kernel<DD, false>;                 \
    prep<<<dim3(pad * 4 / 256, B), 256, 0, static_cast<cudaStream_t>(stream)>>>(                                      \
        static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(dout),                                 \
        static_cast<const __nv_bfloat16*>(o), static_cast<const float*>(lse), static_cast<const float*>(cos_t),        \
        static_cast<const float*>(sin_t), static_cast<__nv_bfloat16*>(qs_g), nullptr, static_cast<float*>(lse_g),      \
        static_cast<float*>(delta_g), nullptr, T, H, 1, pad, scale * LOG2E);                                           \
    return (int)cudaGetLastError();                                                                                    \
  }()
  WINDOWED_HEAD_DIMS(CALL)
#undef CALL
}

extern "C" int flash_bwd_dq_bf16(int D, const void* k, const void* v, const void* dout, const void* qs_g,
                                 const void* lse_g, const void* delta_g, const void* cos_t, const void* sin_t,
                                 void* dq, int B, int T, int S, int H, int pad, int window, float scale,
                                 void* stream) {
#define CALL(DD) \
  launch_dq<DD, false>(k, v, dout, qs_g, lse_g, delta_g, cos_t, sin_t, dq, B, T, S, H, pad, window, scale, \
                       KeyFrame{0, 0, S}, stream)
  WINDOWED_HEAD_DIMS(CALL)
#undef CALL
}

extern "C" int flash_bwd_dkv_bf16(int D, const void* k, const void* v, const void* dout, const void* qs_g,
                                  const void* lse_g, const void* delta_g, void* dk, void* dv, int B, int T, int S,
                                  int H, int pad, int window, void* stream) {
#define CALL(DD) \
  launch_dkv<DD, false>(k, v, dout, qs_g, lse_g, delta_g, dk, dv, B, T, S, H, pad, window, KeyFrame{0, 0, S}, stream)
  WINDOWED_HEAD_DIMS(CALL)
#undef CALL
}

// The halo pair, on the scratch of the pre-pass without tables: k and v are
// the slab (B, T + window, D); window even, the shard [g0, g0 + T) inside a
// song of t_global frames (checked by the wrapper).
extern "C" int halo_bwd_dq_bf16(int D, const void* k, const void* v, const void* dout, const void* qs_g,
                                const void* lse_g, const void* delta_g, void* dq, int B, int T, int H, int pad,
                                int window, int g0, int t_global, float scale, void* stream) {
#define CALL(DD)                                                                                               \
  launch_dq<DD, true>(k, v, dout, qs_g, lse_g, delta_g, nullptr, nullptr, dq, B, T, T + window, H, pad, window, \
                      scale, halo_frame(T, window, g0, t_global), stream)
  WINDOWED_HEAD_DIMS(CALL)
#undef CALL
}

extern "C" int halo_bwd_dkv_bf16(int D, const void* k, const void* v, const void* dout, const void* qs_g,
                                 const void* lse_g, const void* delta_g, void* dk, void* dv, int B, int T, int H,
                                 int pad, int window, int g0, int t_global, void* stream) {
#define CALL(DD)                                                                                      \
  launch_dkv<DD, true>(k, v, dout, qs_g, lse_g, delta_g, dk, dv, B, T, T + window, H, pad, window, \
                       halo_frame(T, window, g0, t_global), stream)
  WINDOWED_HEAD_DIMS(CALL)
#undef CALL
}
