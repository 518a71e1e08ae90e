// Windowed MQA flash-attention backward, for Hopper (sm_90a): the split pair,
// both kernels and their pre-pass in this source, in two key frames.
//
// Replaces osufusion_tpu/ops/pallas_attention.py::_dq_kernel and ::_dkv_kernel
// (both launched by _flash_bwd), the backward of a sliding-window site, and
// ::_halo_dq_kernel and ::_halo_dkv_kernel (both launched by _halo_flash_bwd),
// the backward of flash_halo.cu's forward in sequence-parallel training. The
// two pairs compute the same thing in two frames of the keys (template
// argument HALO, the frame's numbers in a KeyFrame):
//  * single device (HALO = false): key s is attended by query t iff |t - s| <=
//    window / 2 (integer half, the forward's rule; window < 0: every key);
//    q arrives raw with the cos/sin tables, k rotated.
//  * halo (HALO = true): a rank's T local queries against a slab of S = T + W
//    keys whose row s is the single-device key s - W/2, so t sees s iff
//    |t - (s - W/2)| <= W/2, and only the slab rows [lo, hi) inside the song
//    exist (flash_halo.cu's frame: lo = max(0, W/2 - g0), hi = min(S,
//    t_global - g0 + W/2)). q arrives rotated (no tables; dq stays in its
//    frame), k rotated. Slab rows outside the song get dk = dv = 0.
//
// Inputs: q (B, T, H, D) bf16, k and v (B, S, D) bf16, do and o (B, T, H, D)
// bf16, lse2 (B, T*H) fp32 (the base-2 log-sum-exp that the forward wrote).
// With qs = q_rot * scale * log2(e) in bf16 (rope_qs.cuh, the forward's bits:
// flash_fwd.cu's, and flash_halo.cu's stage_scaled, which rounds the same
// product the same way), p = exp2(qs k_rot^T - lse2) is the forward's
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
// is `wgmma.mma_async`; the wrappers are in hopper.cuh):
//
//  * Pre-pass (flash_bwd_prep.cuh, K2's): qs rotated (halo: only scaled) once
//    per row, delta, and the LSE, t-major (the group-major order at MQA), LSE
//    and delta padded to whole 128-row blocks with +inf and 0, so a pad row
//    has p = ds = 0. Both kernels read qs from there: no row is scaled twice.
//  * flash_bwd_dq_kernel: one block per 128 (timestep, head) rows, as the
//    forward lays them out. Two consumer warpgroups own 64 rows each; a
//    producer warpgroup (one thread of it, 40 registers so that the
//    consumers get 232) loads the block's qs and do once, in the 128-byte
//    swizzle, then streams the KV tiles of 128 keys that intersect [t_lo -
//    w/2, t_hi + w/2] through a ring of DQ_NSTAGE stages. Per tile S = qs K^T
//    and dP = do V^T (wgmma m64n128, both operands in shared memory); ds
//    stays in registers as the A operand of dQ += dS K (K read MN-major).
//    While the tensor cores run tile j's S and dP and tile j-1's dQ, the
//    warpgroup waits only for S and computes p. Only tiles at the window's
//    edge or past the last key (S; halo: hi) are masked; the sweep starts at
//    lo. No atomics and no buffer: each dq row is un-rotated, scaled and
//    stored once, so dq repeats to the last bit.
//  * flash_bwd_dkv_kernel: one block per (batch element, KV_BN = 64 keys), two
//    blocks per SM (so the narrow levels, T = 8192 at B = 1, still fill the
//    card). Its consumer warpgroup keeps dk and dv of the 64 keys in fp32
//    registers (232 a thread, by setmaxnreg from a producer warpgroup that
//    keeps 24); one producer thread streams the 64-row tiles of qs and do
//    (TMA) and of the LSE and delta (bulk copy) of the timesteps
//    [s0 - w/2, s_last + w/2] through a ring of KV_NSTAGE stages. Per tile
//    S^T = K qs^T and dP^T = V do^T put the keys in wgmma's M, so P^T and dS^T
//    come out in registers already as the A operands of dV += P^T do and dK
//    += dS^T qs (do and qs read MN-major): no shared-memory round trip, no
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
//  * The pair recomputes s and dp in both kernels (7 products of T*W*H*D
//    against the fused sweep's 5): that is what the split is (the card's
//    own; the TPU pair exists because its grid has no atomics).
//
// C ABI (loaded with ctypes): flash_bwd_windowed_prep_bf16 fills the scratch
// that the kernels of either frame read (with tables or, for the halo pair,
// without); flash_bwd_dq_bf16 and flash_bwd_dkv_bf16 (single device),
// halo_bwd_dq_bf16 and halo_bwd_dkv_bf16 (halo) return a cudaError_t, or minus
// the CUresult of a TMA descriptor that failed to encode.

#include <limits.h>
#include <math.h>

#include "flash_bwd_prep.cuh"
#include "hopper.cuh"

namespace {

constexpr int D = 64;                             // head dim
constexpr int ROW_TILE = 64;                      // rows of a qs / do box of TMA
constexpr int DQ_BM = 128;                        // (timestep, head) rows per dq block; the row padding
constexpr int DQ_BN = 128;                        // keys per KV tile of the dq sweep
constexpr int DQ_NSTAGE = 4;                      // KV tiles in flight
constexpr int DQ_CONSUMERS = DQ_BM / 64;          // consumer warpgroups, 64 rows each
constexpr int DQ_THREADS = DQ_CONSUMERS * 128 + 128;  // and the producer warpgroup
// registers a thread after the hand-over: 2 x 128 x 232 + 128 x 40 <= 65536
constexpr int PRODUCER_REGS = 40;
constexpr int CONSUMER_REGS = 232;
constexpr int DQ_ROWS_BYTES = DQ_BM * D * 2;
constexpr int DQ_TILE_BYTES = DQ_BN * D * 2;
// qs, do; K and V per stage; barriers
constexpr int DQ_SMEM_BYTES = 1024 + 2 * DQ_ROWS_BYTES + 2 * DQ_NSTAGE * DQ_TILE_BYTES + (2 * DQ_NSTAGE + 1) * 8;

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
constexpr int KV_BYTES = KV_BN * D * 2;
constexpr int KV_ROW_BYTES = KV_BM * D * 2;
// K, V; per stage qs, do, lse, delta; barriers
constexpr int KV_SMEM_BYTES =
    1024 + 2 * KV_BYTES + KV_NSTAGE * (2 * KV_ROW_BYTES + 2 * KV_BM * 4) + (2 * KV_NSTAGE + 1) * 8;

static_assert(2 * 128 * CONSUMER_REGS + 128 * PRODUCER_REGS <= 65536 &&
                  128 * (CONSUMER_REGS + KV_PRODUCER_REGS) <= 65536 / KV_BLOCKS_PER_SM,
              "the register hand-over fits the register file");

constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

static_assert(DQ_BM % ROW_TILE == 0 && DQ_BM % KV_BM == 0, "the row padding serves both kernels' tiles");

// The halo frame's keys (read only where HALO): key s sits at s - off on the
// queries' diagonal, and only keys in [lo, hi) exist. The single-device frame
// is {0, 0, S}, fixed at compile time.
struct KeyFrame {
  int off, lo, hi;
};

template <bool HALO>
__global__ void __launch_bounds__(DQ_THREADS, 1)
flash_bwd_dq_kernel(const __grid_constant__ CUtensorMap kmap, const __grid_constant__ CUtensorMap vmap,
                    const __grid_constant__ CUtensorMap qmap, const __grid_constant__ CUtensorMap domap,
                    const float* __restrict__ lse_g, const float* __restrict__ delta_g,
                    const float* __restrict__ cos_t, const float* __restrict__ sin_t, __nv_bfloat16* __restrict__ dq,
                    int T, int S, int H, int pad, int window, float scale, KeyFrame frame) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem);  // [DQ_BM][D] qs, swizzled
  __nv_bfloat16* Os = Qs + DQ_BM * D;                            // [DQ_BM][D] do
  __nv_bfloat16* Ks = Os + DQ_BM * D;                            // [DQ_NSTAGE][DQ_BN][D]
  __nv_bfloat16* Vs = Ks + DQ_NSTAGE * DQ_BN * D;                // [DQ_NSTAGE][DQ_BN][D]
  uint64_t* full = reinterpret_cast<uint64_t*>(Vs + DQ_NSTAGE * DQ_BN * D);
  uint64_t* empty = full + DQ_NSTAGE;
  uint64_t* row_bar = empty + DQ_NSTAGE;

  const int b = blockIdx.y;
  const int rows = T * H;
  const int r0 = blockIdx.x * DQ_BM;
  const bool local = window >= 0;
  const int w2 = window / 2;
  const int off = HALO ? frame.off : 0, key_lo = HALO ? frame.lo : 0, key_hi = HALO ? frame.hi : S;
  const int t_lo = r0 / H;
  const int t_hi = (min(r0 + DQ_BM, rows) - 1) / H;
  // the keys the block's rows see; every row sees one (a halo row: its own frame, inside the song)
  const int kv_lo = local ? max(key_lo, t_lo + off - w2) : key_lo;
  const int kv_hi = local ? min(key_hi, t_hi + off + w2 + 1) : key_hi;
  const int n_tiles = (kv_hi - kv_lo + DQ_BN - 1) / DQ_BN;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int s = 0; s < DQ_NSTAGE; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], DQ_CONSUMERS * 4);  // one arrival per consumer warp
    }
    mbar_init(row_bar, 1);
    fence_barrier_init();
  }
  __syncthreads();

  if (warp >= DQ_CONSUMERS * 4) {  // the producer warpgroup; one thread issues every copy
    setmaxnreg_dec<PRODUCER_REGS>();
    if (warp == DQ_CONSUMERS * 4 && lane == 0) {
      mbar_expect_tx(row_bar, 2 * DQ_ROWS_BYTES);
      for (int h = 0; h < DQ_BM / ROW_TILE; ++h) {  // rows past T*H arrive as zeros
        tma_load_3d(Qs + h * ROW_TILE * D, &qmap, row_bar, 0, r0 + h * ROW_TILE, b);
        tma_load_3d(Os + h * ROW_TILE * D, &domap, row_bar, 0, r0 + h * ROW_TILE, b);
      }
      for (int it = 0; it < n_tiles; ++it) {
        const int st = it % DQ_NSTAGE;
        mbar_wait(&empty[st], ((it / DQ_NSTAGE) & 1) ^ 1);
        mbar_expect_tx(&full[st], 2 * DQ_TILE_BYTES);
        const int s0 = kv_lo + it * DQ_BN;  // keys past S arrive as zeros
        tma_load_4d(Ks + st * DQ_BN * D, &kmap, &full[st], 0, 0, s0, b);
        tma_load_4d(Vs + st * DQ_BN * D, &vmap, &full[st], 0, 0, s0, b);
      }
    }
    return;
  }

  setmaxnreg_inc<CONSUMER_REGS>();
  const int wg = warp / 4;  // consumer warpgroup: rows r0 + 64 wg ...
  const int g = lane >> 2;  // accumulator row (and row + 8) of this thread in its warp's 16
  const int tq = lane & 3;  // accumulator column pair
  const int row_a = r0 + wg * 64 + (warp % 4) * 16 + g;
  const int row_b = row_a + 8;
  const int tr[2] = {row_a / H, row_b / H};  // timesteps of the thread's two rows
  // the rows' statistics; the scratch is padded to whole blocks, a pad row has lse = +inf
  const float lse_r[2] = {lse_g[(size_t)b * pad + row_a], lse_g[(size_t)b * pad + row_b]};
  const float delta_r[2] = {delta_g[(size_t)b * pad + row_a], delta_g[(size_t)b * pad + row_b]};
  // the keys each of the two rows sees, [vis_lo, vis_lo + vis_n]: its window within [key_lo, key_hi), so that
  // an edge tile masks with one unsigned compare a key (a pad row may get an empty range: its p is 0 anyway)
  int vis_lo[2], vis_n[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    vis_lo[i] = local ? max(key_lo, tr[i] + off - w2) : key_lo;
    vis_n[i] = (local ? min(key_hi, tr[i] + off + w2 + 1) : key_hi) - 1 - vis_lo[i];
  }
  const uint64_t qdesc = desc_kmajor(Qs + wg * 64 * D);
  const uint64_t odesc = desc_kmajor(Os + wg * 64 * D);

  float acc[32];  // dq_rot of the warpgroup's 64 rows
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.f;
  float s[64], dp[64];           // the tile's logits, then p; dp, then ds
  uint32_t ga[DQ_BN / 16][4];    // ds in bf16, the A operand of dQ += dS K

  // S = qs K^T and dP = do V^T of the tile in stage st, issued as two groups
  auto issue_products = [&](int st) {
    const uint64_t kdesc = desc_kmajor(Ks + st * DQ_BN * D), vdesc = desc_kmajor(Vs + st * DQ_BN * D);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) wgmma_ss_n128<0, 0>(s, qdesc + 2 * kk, kdesc + 2 * kk, kk);
    wgmma_commit();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) wgmma_ss_n128<0, 0>(dp, odesc + 2 * kk, vdesc + 2 * kk, kk);
    wgmma_commit();
  };
  // dQ += dS K with the previous tile's dS (ga) and the K of stage st, issued
  auto issue_dq = [&](int st) {
    const uint64_t kdesc_b = desc_mnmajor(Ks + st * DQ_BN * D);
#pragma unroll
    for (int j = 0; j < DQ_BN / 16; ++j) wgmma_rs_n64<1>(acc, ga[j], kdesc_b + j * (16 * 128 >> 4), 1);
    wgmma_commit();
  };
  // s becomes p = exp2(s - lse2), zero outside the window and at or past
  // key_hi; only a tile at the window's edge or past key_hi is masked
  auto probabilities = [&](int it) {
    const int s0 = kv_lo + it * DQ_BN;
    const bool interior =
        s0 + DQ_BN <= key_hi && (!local || (s0 - off >= t_hi - w2 && s0 - off + DQ_BN - 1 <= t_lo + w2));
#pragma unroll
    for (int i = 0; i < DQ_BN / 8; ++i) {
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
    for (int i = 0; i < DQ_BN / 8; ++i) {
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
  for (int j = 0; j < DQ_BN / 16; ++j) a_frag(ga[j], dp + 8 * j);
  for (int it = 1; it < n_tiles; ++it) {
    const int st = it % DQ_NSTAGE, prev = (it - 1) % DQ_NSTAGE;
    mbar_wait(&full[st], (it / DQ_NSTAGE) & 1);
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
    for (int j = 0; j < DQ_BN / 16; ++j) a_frag(ga[j], dp + 8 * j);
  }
  reg_fence(acc);
  reg_fence(ga);
  wgmma_fence();
  issue_dq((n_tiles - 1) % DQ_NSTAGE);
  wgmma_wait<0>();
  reg_fence(acc);
  reg_fence(ga);
  release((n_tiles - 1) % DQ_NSTAGE);

  // un-rotate into the raw q's frame (g cos - rot_half(g sin); columns d and
  // d + 32 sit in the same thread, registers 4j.. and 4(j + 4)..), apply
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

template <bool HALO>
__global__ void __launch_bounds__(KV_THREADS, KV_BLOCKS_PER_SM)
flash_bwd_dkv_kernel(const __grid_constant__ CUtensorMap kmap, const __grid_constant__ CUtensorMap vmap,
                     const __grid_constant__ CUtensorMap qmap, const __grid_constant__ CUtensorMap domap,
                     const float* __restrict__ lse_g, const float* __restrict__ delta_g, float* __restrict__ dk,
                     float* __restrict__ dv, int T, int S, int H, int pad, int window, KeyFrame frame) {
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
  const int off = HALO ? frame.off : 0, key_lo = HALO ? frame.lo : 0, key_hi = HALO ? frame.hi : S;
  const int s_last = min(S, s0 + KV_BN) - 1;
  // the block's keys that exist, [k_lo, k_hi], and the rows whose window
  // reaches them, from a whole tile on (16-byte aligned for the bulk copies;
  // the rows before the window are masked)
  const int k_lo = max(s0, key_lo), k_hi = min(s_last, key_hi - 1);
  const int row_lo = local ? max(0, k_lo - off - w2) * H / KV_BM * KV_BM : 0;
  const int row_hi = (local ? min(T, k_hi - off + w2 + 1) : T) * H;
  const int n_tiles = k_lo <= k_hi ? (row_hi - row_lo + KV_BM - 1) / KV_BM : 0;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  if (HALO && n_tiles <= 0) {  // no key of the block inside the song: zeros, and no sweep
    const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int i = threadIdx.x; i < KV_BN * D / 4; i += KV_THREADS) {
      const int key = s0 + i / (D / 4);
      if (key < S) {
        reinterpret_cast<float4*>(dk + ((size_t)b * S + key) * D)[i % (D / 4)] = zero;
        reinterpret_cast<float4*>(dv + ((size_t)b * S + key) * D)[i % (D / 4)] = zero;
      }
    }
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

  setmaxnreg_inc<CONSUMER_REGS>();
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

// (D, rows, B) bf16 rows of a t-major (B, rows, D) buffer, boxes of ROW_TILE
// rows; rows past `rows` arrive as zeros
int make_rows_map(CUtensorMap* map, const void* ptr, int rows, int B) {
  const cuuint64_t dims[3] = {D, (cuuint64_t)rows, (cuuint64_t)B};
  const cuuint64_t strides[2] = {D * 2, (cuuint64_t)rows * D * 2};
  const cuuint32_t box[3] = {D, ROW_TILE, 1};
  return make_map_bf16(map, 3, ptr, dims, strides, box);
}

// The halo frame of a launch (flash_halo.cu's make_frame): slab row s is the
// single-device key s - W/2, the rows [lo, hi) lie inside the song
KeyFrame halo_frame(int T, int window, int g0, int t_global) {
  const int w2 = window / 2, lo = w2 - g0, hi = t_global - g0 + w2;
  return {w2, lo > 0 ? lo : 0, hi < T + window ? hi : T + window};
}

// The dq kernel of either frame over S keys: tensor maps, shared memory, launch
template <bool HALO>
int launch_dq(const void* k, const void* v, const void* dout, const void* qs_g, const void* lse_g,
              const void* delta_g, const void* cos_t, const void* sin_t, void* dq, int B, int T, int S, int H, int pad,
              int window, float scale, KeyFrame frame, void* stream) {
  if (pad % DQ_BM != 0 || pad < T * H) return (int)cudaErrorInvalidValue;
  static std::atomic<unsigned long long> smem_set{0};  // devices whose limit is raised
  CUtensorMap kmap, vmap, qmap, domap;
  int dev;
  int err = bind_device(&dev);
  if (err == 0) err = make_kv_map(&kmap, k, B, S, 1, DQ_BN);
  if (err == 0) err = make_kv_map(&vmap, v, B, S, 1, DQ_BN);
  if (err == 0) err = make_rows_map(&qmap, qs_g, T * H, B);
  if (err == 0) err = make_rows_map(&domap, dout, T * H, B);
  if (err == 0) err = allow_smem(flash_bwd_dq_kernel<HALO>, DQ_SMEM_BYTES, dev, smem_set);
  if (err != 0) return err;
  flash_bwd_dq_kernel<HALO><<<dim3(pad / DQ_BM, B), DQ_THREADS, DQ_SMEM_BYTES, static_cast<cudaStream_t>(stream)>>>(
      kmap, vmap, qmap, domap, static_cast<const float*>(lse_g), static_cast<const float*>(delta_g),
      static_cast<const float*>(cos_t), static_cast<const float*>(sin_t), static_cast<__nv_bfloat16*>(dq), T, S, H,
      pad, window, scale, frame);
  return (int)cudaGetLastError();
}

// The dk/dv kernel of either frame over S keys
template <bool HALO>
int launch_dkv(const void* k, const void* v, const void* dout, const void* qs_g, const void* lse_g,
               const void* delta_g, void* dk, void* dv, int B, int T, int S, int H, int pad, int window, KeyFrame frame,
               void* stream) {
  if (pad % DQ_BM != 0 || pad < T * H) return (int)cudaErrorInvalidValue;
  static std::atomic<unsigned long long> smem_set{0};  // devices whose limit is raised
  CUtensorMap kmap, vmap, qmap, domap;
  int dev;
  int err = bind_device(&dev);
  if (err == 0) err = make_kv_map(&kmap, k, B, S, 1, KV_BN);
  if (err == 0) err = make_kv_map(&vmap, v, B, S, 1, KV_BN);
  if (err == 0) err = make_rows_map(&qmap, qs_g, T * H, B);
  if (err == 0) err = make_rows_map(&domap, dout, T * H, B);
  if (err == 0) err = allow_smem(flash_bwd_dkv_kernel<HALO>, KV_SMEM_BYTES, dev, smem_set);
  if (err != 0) return err;
  flash_bwd_dkv_kernel<HALO><<<dim3((S + KV_BN - 1) / KV_BN, B), KV_THREADS, KV_SMEM_BYTES,
                               static_cast<cudaStream_t>(stream)>>>(
      kmap, vmap, qmap, domap, static_cast<const float*>(lse_g), static_cast<const float*>(delta_g),
      static_cast<float*>(dk), static_cast<float*>(dv), T, S, H, pad, window, frame);
  return (int)cudaGetLastError();
}

}  // namespace

// The scratch, allocated by the caller: qs_g (B, T*H, D) bf16, lse_g and
// delta_g (B, pad) fp32, pad = T*H rounded up to a multiple of DQ_BM (128).
// With null tables (the halo pair: q arrives rotated) q is only scaled.
extern "C" int flash_bwd_windowed_prep_bf16(const void* q, const void* dout, const void* o, const void* lse,
                                            const void* cos_t, const void* sin_t, void* qs_g, void* lse_g,
                                            void* delta_g, int B, int T, int H, int pad, float scale, void* stream) {
  if (pad % DQ_BM != 0 || pad < T * H) return (int)cudaErrorInvalidValue;
  auto prep = cos_t != nullptr ? flash_bwd_prep_kernel<true> : flash_bwd_prep_kernel<false>;
  prep<<<dim3(pad * 4 / 256, B), 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(dout),
      static_cast<const __nv_bfloat16*>(o), static_cast<const float*>(lse), static_cast<const float*>(cos_t),
      static_cast<const float*>(sin_t), static_cast<__nv_bfloat16*>(qs_g), nullptr, static_cast<float*>(lse_g),
      static_cast<float*>(delta_g), nullptr, T, H, 1, pad, scale * LOG2E);
  return (int)cudaGetLastError();
}

extern "C" int flash_bwd_dq_bf16(const void* k, const void* v, const void* dout, const void* qs_g,
                                 const void* lse_g, const void* delta_g, const void* cos_t, const void* sin_t,
                                 void* dq, int B, int T, int S, int H, int pad, int window, float scale,
                                 void* stream) {
  return launch_dq<false>(k, v, dout, qs_g, lse_g, delta_g, cos_t, sin_t, dq, B, T, S, H, pad, window, scale,
                          KeyFrame{0, 0, S}, stream);
}

extern "C" int flash_bwd_dkv_bf16(const void* k, const void* v, const void* dout, const void* qs_g,
                                  const void* lse_g, const void* delta_g, void* dk, void* dv, int B, int T, int S,
                                  int H, int pad, int window, void* stream) {
  return launch_dkv<false>(k, v, dout, qs_g, lse_g, delta_g, dk, dv, B, T, S, H, pad, window, KeyFrame{0, 0, S},
                           stream);
}

// The halo pair, on the scratch of the pre-pass without tables: k and v are
// the slab (B, T + window, D); window even, the shard [g0, g0 + T) inside a
// song of t_global frames (checked by the wrapper).
extern "C" int halo_bwd_dq_bf16(const void* k, const void* v, const void* dout, const void* qs_g, const void* lse_g,
                                const void* delta_g, void* dq, int B, int T, int H, int pad, int window, int g0,
                                int t_global, float scale, void* stream) {
  return launch_dq<true>(k, v, dout, qs_g, lse_g, delta_g, nullptr, nullptr, dq, B, T, T + window, H, pad, window,
                         scale, halo_frame(T, window, g0, t_global), stream);
}

extern "C" int halo_bwd_dkv_bf16(const void* k, const void* v, const void* dout, const void* qs_g,
                                 const void* lse_g, const void* delta_g, void* dk, void* dv, int B, int T, int H,
                                 int pad, int window, int g0, int t_global, void* stream) {
  return launch_dkv<true>(k, v, dout, qs_g, lse_g, delta_g, dk, dv, B, T, T + window, H, pad, window,
                          halo_frame(T, window, g0, t_global), stream);
}
