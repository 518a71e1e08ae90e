// Flash-attention forward with fused q-RoPE, for Hopper (sm_90a): MQA, GQA
// and full MHA, windowed or global, on one device or in the halo frame of
// sequence parallelism.
//
// Replaces osufusion_tpu/ops/pallas_attention.py::_fwd_kernel (launched by
// _flash_fwd), in its serving, training and DiT/MMDiT forms, and
// ::_halo_fwd_kernel (launched by _halo_flash_fwd), the forward of
// sequence-parallel training. One body serves both, in two frames of the keys
// (template argument HALO, the frame's numbers in a KeyFrame of
// key_frame.cuh), as the windowed backward pair does (flash_bwd_windowed.cu):
//  * single device (HALO = false, the frame {0, 0, S} fixed at compile
//    time): key s is attended by query t iff |t - s| <= window / 2 (window <
//    0: every key).
//  * halo (HALO = true, MQA, no tables): a rank's T local queries, already
//    rotated, against a slab of S = T + W keys whose row s is the
//    single-device key s - W/2, so t sees s iff |t - (s - W/2)| <= W/2 and lo
//    <= s < hi: only the slab rows inside the song exist (halo_frame). The
//    rows past hi hold real memory, so the mask tests hi, never S.
// With tables, q arrives raw and is rotated here and k arrives already
// rotated; without them (DiT/MMDiT: null tables) q is only scaled. The output
// is softmax(q k^T * scale) v, query head h reading KV head h / G (G = H / Kv
// heads a group). With a non-null lse pointer (the training form) the kernel
// also writes, per (b, t, h) row, the base-2 log-sum-exp of its own logits
// q k^T * scale * log2(e), fp32, flat (B, T*H) in t-major order: what the
// backward kernels recompute the probabilities from. Serving passes null and
// pays nothing for it.
//
// One body serves the head dims 64, 128, 192 and 256 (template argument D,
// struct Fwd): every tile is D / 64 swizzle atoms wide (hopper.cuh), loaded
// as D / 64 TMA boxes, and O += P V is one wgmma of N = D per 16 keys.
//
// Bound: compute (see ops/flash_attention.py): 4 * D FLOP per visited (query,
// key) pair on the tensor cores, and one exp2 per pair, which at D = 64 costs
// the SM's special-function units about as long as the pair's products cost
// its tensor cores (at wider heads the products dominate). The design keeps both busy and moves every tile by TMA
// (`cp.async.bulk.tensor` behind `mbarrier`s; every product is
// `wgmma.mma_async`; the wrappers are in hopper.cuh):
//
//  * Rows. q and o are (B, T, H, D) contiguous. A block owns BM = 128
//    (timestep, head) rows of one KV group: group row r is timestep r / G,
//    head kv * G + r % G. At MQA (Kv = 1) the group is every head and its rows
//    are the T*H contiguous rows of q, and that form is compiled apart
//    (GROUPED = false); at full MHA (G = 1, DiT) a block is 128 consecutive
//    timesteps of one head. The grid's second axis runs over (batch, KV head).
//  * Warp roles. Two consumer warpgroups own 64 rows each; one producer warp
//    (D = 64; a producer warpgroup at wider heads, which hands its registers
//    to the consumers by setmaxnreg: O is D / 2 fp32 registers a thread)
//    streams the KV tiles (BN = 128 keys of the block's KV head; 64 at D >
//    128, where S at 128 keys would not fit beside O) that
//    intersect [t_lo - w/2, t_hi + w/2] (halo: shifted by W/2 and clipped to
//    [lo, hi), so the first box may start anywhere) by TMA into a ring of
//    NSTAGE stages behind full / empty mbarriers. k and v are read through a
//    4-d tensor map (D, Kv, S, B), so keys past S arrive as zeros.
//  * q. Each consumer warpgroup rotates its 64 rows once, in fp32 with the
//    arithmetic of rope_qs.cuh (scale * log2(e) folded in), and stores them
//    in the 128-byte swizzle that wgmma reads (hopper.cuh), then fences the
//    async proxy: the logits are qs k_rot^T with the bits of qs that the
//    windowed backward's pre-pass (flash_bwd_prep.cuh) stages in either
//    frame, so the backward recomputes this kernel's p from its LSE.
//  * Products. S = qs K^T is wgmma m64nBNk16 with both operands in shared
//    memory (fp32 accumulators, BN / 2 a thread), stepping across the atoms
//    of qs and K along D. P, rounded to bf16, stays in registers as the A
//    operand of O += P V (wgmma m64nDk16, V read MN-major across its atoms):
//    no shared-memory round trip.
//  * Softmax. Online, fp32, exp2 domain, the row statistics shared by the four
//    threads of a quad; each exp2 is the special-function unit's instruction
//    alone (hopper.cuh's exp2_ftz: exp2f added a compare and two multiplies
//    to each). Only tiles at the edge of the window or past the last key
//    that exists (S; halo: hi) are masked, each key of them with one unsigned
//    compare against the keys its row sees (the short-circuit test `key < S
//    && |t - key| <= w/2` was slower at the windowed sites and no faster at
//    the others), and a row that has seen no key yet keeps a zero base.
//    Every real row sees at least one key.
//  * Overlap. Each warpgroup issues tile j's scores and tile j-1's P V
//    together and waits only for the scores, so its softmax of tile j runs
//    while the tensor cores do the P V; O is rescaled after. The two
//    warpgroups are not locked together either, so one's softmax also
//    overlaps the other's products. A stage is released once its P V is done;
//    NSTAGE (4 at D = 64, as many as fit beside Q above: 3 at D = 128 and
//    192, 2 at 256) keeps tiles loading ahead of the two in use.
//
// C ABI (loaded with ctypes): flash_fwd_bf16 and halo_fwd_bf16 take the head
// dim first and return a cudaError_t (cudaErrorInvalidValue for a head dim
// without an instance), or minus the CUresult of a TMA descriptor that failed
// to encode; flash_fwd_bf16's lse may be null, and cos_t / sin_t are null
// together or not at all.

#include <math.h>

#include "hopper.cuh"
#include "key_frame.cuh"
#include "rope_qs.cuh"

namespace {

constexpr int BM = 128;             // (timestep, head) rows per block
constexpr int CONSUMERS = BM / 64;  // consumer warpgroups
constexpr int SMEM_LIMIT = 232448;  // dynamic shared memory a block may take on sm_90
constexpr float LOG2E = 1.4426950408889634f;

// The instance at head dim D (64, 128, 192, 256). Tiles are D / 64 swizzle
// atoms wide (hopper.cuh). D = 64 keeps the first design: a producer warp
// beside the consumers, 128-key tiles, 4 stages. Wider heads take a producer
// warpgroup that hands its registers to the consumers by setmaxnreg (O alone
// is D / 2 fp32 registers a thread), 128-key tiles at D = 128 and 64-key
// tiles above (S at 128 keys would be 64 registers more), and as many stages
// as fit beside Q in shared memory: 3 at D = 128 and 192, 2 at 256.
template <int D>
struct Fwd {
  static constexpr int ATOMS = D / 64;
  static constexpr int BN = D <= 128 ? 128 : 64;  // keys per KV tile
  static constexpr bool PRODUCER_WG = D > 64;
  static constexpr int THREADS = CONSUMERS * 128 + (PRODUCER_WG ? 128 : 32);
  static constexpr int PRODUCER_REGS = 24;  // registers a thread after the hand-over (2 x 128 x 240 + 128 x 24 <= 65536)
  static constexpr int CONSUMER_REGS = 240;
  static constexpr int Q_BYTES = BM * D * 2;
  static constexpr int TILE_BYTES = BN * D * 2;
  static constexpr int FIT = (SMEM_LIMIT - 1024 - Q_BYTES - 64) / (2 * TILE_BYTES);
  static constexpr int NSTAGE = FIT < 4 ? FIT : 4;  // KV tiles in flight
  static constexpr int SMEM_BYTES = 1024 + Q_BYTES + 2 * NSTAGE * TILE_BYTES + 2 * NSTAGE * 8;
  static_assert(D % 64 == 0 && NSTAGE >= 2 && SMEM_BYTES <= SMEM_LIMIT, "Q and two stages fit shared memory");
  static_assert(CONSUMERS * 128 * CONSUMER_REGS + 128 * PRODUCER_REGS <= 65536, "the hand-over fits the register file");
};

template <int D, bool GROUPED, bool ROPE, bool HALO>
__global__ void __launch_bounds__(Fwd<D>::THREADS, 1)
flash_fwd_kernel(const __grid_constant__ CUtensorMap kmap, const __grid_constant__ CUtensorMap vmap,
                 const __nv_bfloat16* __restrict__ q, const float* __restrict__ cos_t,
                 const float* __restrict__ sin_t, __nv_bfloat16* __restrict__ o, float* __restrict__ lse, int T,
                 int S, int H, int Kv, int window, float scale, KeyFrame frame) {
  static_assert(!HALO || (!GROUPED && !ROPE), "the halo frame is MQA with q already rotated");
  using C = Fwd<D>;
  constexpr int BN = C::BN, NSTAGE = C::NSTAGE, ATOMS = C::ATOMS, TILE_BYTES = C::TILE_BYTES;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem);               // [ATOMS][BM][64], swizzled
  __nv_bfloat16* Ks = reinterpret_cast<__nv_bfloat16*>(smem + C::Q_BYTES);  // [NSTAGE][ATOMS][BN][64]
  __nv_bfloat16* Vs = Ks + NSTAGE * BN * D;                                 // [NSTAGE][ATOMS][BN][64]
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + C::Q_BYTES + 2 * NSTAGE * TILE_BYTES);
  uint64_t* empty = full + NSTAGE;

  const int b = GROUPED ? blockIdx.y / Kv : blockIdx.y;
  const int kv = GROUPED ? blockIdx.y % Kv : 0;
  const int G = GROUPED ? H / Kv : H;  // heads of the group: its rows are T*G
  const int rows = T * G;
  const int r0 = blockIdx.x * BM;
  const bool local = HALO || window >= 0;
  const int w2 = window / 2;
  const KeyFrame kf = HALO ? frame : KeyFrame{0, 0, S};
  const int t_lo = r0 / G;
  const int t_hi = (min(r0 + BM, rows) - 1) / G;
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
    fence_barrier_init();
  }
  __syncthreads();

  if (warp >= CONSUMERS * 4) {  // producer; one thread issues every copy
    if constexpr (C::PRODUCER_WG) setmaxnreg_dec<C::PRODUCER_REGS>();
    if (warp == CONSUMERS * 4 && lane == 0) {
      for (int it = 0; it < n_tiles; ++it) {
        const int st = it % NSTAGE;
        mbar_wait(&empty[st], ((it / NSTAGE) & 1) ^ 1);
        mbar_expect_tx(&full[st], 2 * TILE_BYTES);
        const int s0 = kv_lo + it * BN;
#pragma unroll
        for (int a = 0; a < ATOMS; ++a) {  // one box per 64 columns of the head dim
          tma_load_4d(Ks + (st * ATOMS + a) * BN * 64, &kmap, &full[st], 64 * a, kv, s0, b);
          tma_load_4d(Vs + (st * ATOMS + a) * BN * 64, &vmap, &full[st], 64 * a, kv, s0, b);
        }
      }
    }
    return;
  }
  if constexpr (C::PRODUCER_WG) setmaxnreg_inc<C::CONSUMER_REGS>();

  const int wg = warp / 4;        // consumer warpgroup
  const int tid = threadIdx.x % 128;
  const int g = lane >> 2;        // accumulator row (and row + 8) of this thread in its warp's 16
  const int tq = lane & 3;        // accumulator column pair
  __nv_bfloat16* Qw = Qs + wg * 64 * 64;  // this warpgroup's rows in atom 0; atom a is BM * 64 elements on
  // (timestep, head) row of q, o and lse that group row r is
  auto mem = [&](int r) { return GROUPED ? (size_t)(r / G) * H + r % G : (size_t)r; };
  const __nv_bfloat16* qb = q + ((size_t)b * T * H + kv * G) * D;
  __nv_bfloat16* ob = o + ((size_t)b * T * H + kv * G) * D;

  // stage this warpgroup's 64 rows as qs, in the swizzled layout: D / 16
  // pieces a row, each 8 columns of the low half and their partners D / 2 on
  constexpr int PIECES = D / 16;
  const float qscale = scale * LOG2E;
  for (int c = tid; c < 64 * PIECES; c += 128) {
    const int r = c / PIECES;
    const int col = (c % PIECES) * 8;
    const int row = r0 + wg * 64 + r;
    uint4 lo = make_uint4(0, 0, 0, 0), hi = make_uint4(0, 0, 0, 0);
    if (row < rows) {
      const size_t t = row / G;
      rope_qs8<ROPE, D>(qb + mem(row) * D, ROPE ? cos_t + t * D : nullptr, ROPE ? sin_t + t * D : nullptr, col,
                        qscale, lo, hi);
    }
    const int hcol = col + D / 2;
    *reinterpret_cast<uint4*>(Qw + (col / 64) * BM * 64 + sw128(r, (col % 64) / 8)) = lo;
    *reinterpret_cast<uint4*>(Qw + (hcol / 64) * BM * 64 + sw128(r, (hcol % 64) / 8)) = hi;
  }
  fence_proxy_async();
  named_bar_sync(1 + wg, 128);

  const uint64_t qdesc = desc_kmajor(Qw);
  // descriptor steps: 16 columns of K inside an atom, and one atom of q / of a K tile
  constexpr uint64_t K16 = 32 >> 4, Q_ATOM = BM * 128 >> 4, KV_ATOM = BN * 128 >> 4;
  const int row_a = r0 + wg * 64 + (warp % 4) * 16 + g;
  const int row_b = row_a + 8;
  // the keys each of the thread's two rows sees, vis_n of them from vis_lo on (none for a pad row past the
  // keys), so that an edge tile masks a key with one unsigned compare
  int vis_lo[2], vis_n[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int t = (i == 0 ? row_a : row_b) / G;
    const KeySpan seen = keys_seen(kf, local, w2, t, t);
    vis_lo[i] = seen.lo;
    vis_n[i] = max(seen.hi - seen.lo, 0);
  }

  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.f, 0.f};
  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  float s[BN / 2];            // the logits of the tile in hand, then its probabilities
  uint32_t pa[BN / 16][4];    // the previous tile's probabilities in bf16, the A operand of O += P V
  float corr[2];

  // mask the logits of tile `it` and fold them into the online softmax:
  // s becomes p = exp2(s - base), corr the factor that moves O to the new base
  auto softmax = [&](int it) {
    const int s0 = kv_lo + it * BN;  // >= kf.lo
    const bool interior =
        s0 + BN <= kf.hi && (!local || (s0 - kf.off >= t_hi - w2 && s0 - kf.off + BN - 1 <= t_lo + w2));
    if (!interior) {
#pragma unroll
      for (int i = 0; i < BN / 8; ++i) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = s0 + i * 8 + 2 * tq + (e & 1);
          if ((unsigned)(key - vis_lo[e >> 1]) >= (unsigned)vis_n[e >> 1]) s[4 * i + e] = -INFINITY;
        }
      }
    }
    // each row's statistics are shared by the 4 threads of a quad
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int i = 0; i < BN / 8; ++i) {
      mx[0] = fmaxf(mx[0], fmaxf(s[4 * i], s[4 * i + 1]));
      mx[1] = fmaxf(mx[1], fmaxf(s[4 * i + 2], s[4 * i + 3]));
    }
    float base[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      base[r] = mx[r] == -INFINITY ? 0.f : mx[r];  // a row with no key yet stays at zero
      corr[r] = exp2_ftz(m[r] - base[r]);
      m[r] = mx[r];
    }
    float rs[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < BN / 8; ++i) {
      s[4 * i] = exp2_ftz(s[4 * i] - base[0]);
      s[4 * i + 1] = exp2_ftz(s[4 * i + 1] - base[0]);
      s[4 * i + 2] = exp2_ftz(s[4 * i + 2] - base[1]);
      s[4 * i + 3] = exp2_ftz(s[4 * i + 3] - base[1]);
      rs[0] += s[4 * i] + s[4 * i + 1];
      rs[1] += s[4 * i + 2] + s[4 * i + 3];
    }
    l[0] = l[0] * corr[0] + rs[0];  // per-thread partial sums, reduced at the end
    l[1] = l[1] * corr[1] + rs[1];
  };
  // S = qs K^T of the tile in stage st (log2-domain logits, 64 rows x BN keys), issued
  auto issue_scores = [&](int st) {
    const uint64_t kdesc = desc_kmajor(Ks + st * BN * D);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss<BN, 0, 0>(s, qdesc + (kk / 4) * Q_ATOM + (kk % 4) * K16, kdesc + (kk / 4) * KV_ATOM + (kk % 4) * K16,
                         kk);
    wgmma_commit();
  };
  // O += P V with the previous tile's P (pa) and the V of stage st (N = D, read MN-major across its atoms), issued
  auto issue_pv = [&](int st) {
    const uint64_t vdesc = desc_mnmajor(Vs + st * BN * D, BN * 128);
#pragma unroll
    for (int j = 0; j < BN / 16; ++j) wgmma_rs<D, 1>(acc, pa[j], vdesc + j * (16 * 128 >> 4), 1);
    wgmma_commit();
  };
  auto release = [&](int st) {
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[st]);  // this warp is done with the stage
  };

  // Software pipeline: while the tensor cores run tile it's scores and tile
  // it - 1's P V, this warpgroup waits only for the scores, then does tile
  // it's softmax; O is rescaled once P V is done.
  mbar_wait(&full[0], 0);
  reg_fence(s);
  wgmma_fence();
  issue_scores(0);
  wgmma_wait<0>();
  reg_fence(s);
  softmax(0);
#pragma unroll
  for (int j = 0; j < BN / 16; ++j) a_frag(pa[j], s + 8 * j);
  for (int it = 1; it < n_tiles; ++it) {
    const int st = it % NSTAGE, prev = (it - 1) % NSTAGE;
    mbar_wait(&full[st], (it / NSTAGE) & 1);
    reg_fence(s);
    reg_fence(acc);
    reg_fence(pa);
    wgmma_fence();
    issue_scores(st);
    issue_pv(prev);
    wgmma_wait<1>();  // the scores (committed first) are in
    reg_fence(s);
    softmax(it);
    wgmma_wait<0>();
    reg_fence(acc);
    reg_fence(pa);
    release(prev);
#pragma unroll
    for (int i = 0; i < D / 8; ++i) {
      acc[4 * i] *= corr[0];
      acc[4 * i + 1] *= corr[0];
      acc[4 * i + 2] *= corr[1];
      acc[4 * i + 3] *= corr[1];
    }
#pragma unroll
    for (int j = 0; j < BN / 16; ++j) a_frag(pa[j], s + 8 * j);
  }
  reg_fence(acc);
  reg_fence(pa);
  wgmma_fence();
  issue_pv((n_tiles - 1) % NSTAGE);
  wgmma_wait<0>();
  reg_fence(acc);
  reg_fence(pa);
  release((n_tiles - 1) % NSTAGE);

  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    inv[r] = 1.f / l[r];
  }
  const size_t mem_a = mem(row_a), mem_b = mem(row_b);
#pragma unroll
  for (int i = 0; i < D / 8; ++i) {
    const int col = i * 8 + 2 * tq;
    if (row_a < rows)
      *reinterpret_cast<uint32_t*>(ob + mem_a * D + col) = pack_bf16(acc[4 * i] * inv[0], acc[4 * i + 1] * inv[0]);
    if (row_b < rows)
      *reinterpret_cast<uint32_t*>(ob + mem_b * D + col) = pack_bf16(acc[4 * i + 2] * inv[1], acc[4 * i + 3] * inv[1]);
  }
  if (lse != nullptr && tq == 0) {  // the 4 threads of a quad hold the same row statistics
    float* lb = lse + (size_t)b * T * H + kv * G;
    if (row_a < rows) lb[mem_a] = m[0] + log2f(l[0]);
    if (row_b < rows) lb[mem_b] = m[1] + log2f(l[1]);
  }
}

// The kernel of one instance over S keys in `frame`: tensor maps, shared memory, launch
template <int D, bool GROUPED, bool ROPE, bool HALO>
int launch_fwd(const void* q, const void* k, const void* v, const void* cos_t, const void* sin_t, void* o, void* lse,
               int B, int T, int S, int H, int Kv, int window, float scale, KeyFrame frame, void* stream) {
  using C = Fwd<D>;
  static std::atomic<unsigned long long> smem_set{0};  // devices whose limit is raised
  auto kernel = flash_fwd_kernel<D, GROUPED, ROPE, HALO>;
  CUtensorMap kmap, vmap;
  int dev;
  int err = bind_device(&dev);
  if (err == 0) err = make_kv_map(&kmap, k, B, S, Kv, C::BN, D);
  if (err == 0) err = make_kv_map(&vmap, v, B, S, Kv, C::BN, D);
  if (err == 0) err = allow_smem(kernel, C::SMEM_BYTES, dev, smem_set);
  if (err != 0) return err;
  const dim3 grid((T * (H / Kv) + BM - 1) / BM, B * Kv);
  kernel<<<grid, C::THREADS, C::SMEM_BYTES, static_cast<cudaStream_t>(stream)>>>(
      kmap, vmap, static_cast<const __nv_bfloat16*>(q), static_cast<const float*>(cos_t),
      static_cast<const float*>(sin_t), static_cast<__nv_bfloat16*>(o), static_cast<float*>(lse), T, S, H, Kv, window,
      scale, frame);
  return (int)cudaGetLastError();
}

// The single-device instances of head dim D
template <int D>
int launch_fwd_single(const void* q, const void* k, const void* v, const void* cos_t, const void* sin_t, void* o,
                      void* lse, int B, int T, int S, int H, int Kv, int window, float scale, void* stream) {
  const KeyFrame frame{0, 0, S};  // unread: the single-device instances fix it at compile time
  auto launch = Kv > 1 ? (cos_t != nullptr ? launch_fwd<D, true, true, false> : launch_fwd<D, true, false, false>)
                       : (cos_t != nullptr ? launch_fwd<D, false, true, false> : launch_fwd<D, false, false, false>);
  return launch(q, k, v, cos_t, sin_t, o, lse, B, T, S, H, Kv, window, scale, frame, stream);
}

}  // namespace

// The instances of head dim D: CALL(D) for D in 64, 128, 192, 256, else
// cudaErrorInvalidValue.
#define FWD_HEAD_DIMS(CALL)                        \
  switch (D) {                                     \
    case 64: return CALL(64);                      \
    case 128: return CALL(128);                    \
    case 192: return CALL(192);                    \
    case 256: return CALL(256);                    \
    default: return (int)cudaErrorInvalidValue;    \
  }

// q (B, T, H, D), k and v (B, S, D) or (B, S, Kv, D), bf16; Kv KV heads (H %
// Kv == 0, checked by the caller); cos_t and sin_t (T, D) fp32, or null for
// no rotary embedding.
extern "C" int flash_fwd_bf16(int D, const void* q, const void* k, const void* v, const void* cos_t,
                              const void* sin_t, void* o, void* lse, int B, int T, int S, int H, int Kv, int window,
                              float scale, void* stream) {
#define CALL(DD) launch_fwd_single<DD>(q, k, v, cos_t, sin_t, o, lse, B, T, S, H, Kv, window, scale, stream)
  FWD_HEAD_DIMS(CALL)
#undef CALL
}

// The halo forward: q (B, T, H, D) already rotated, the slab k (rotated) and
// v (B, T + window, D), the Kv = 1 view of the maps; o and the LSE as
// flash_fwd_bf16 writes them. window even, the shard [g0, g0 + T) inside a
// song of t_global frames (checked by the wrapper).
extern "C" int halo_fwd_bf16(int D, const void* q, const void* k, const void* v, void* o, void* lse, int B, int T,
                             int H, int window, int g0, int t_global, float scale, void* stream) {
  const KeyFrame frame = halo_frame(T, window, g0, t_global);
#define CALL(DD) \
  launch_fwd<DD, false, false, true>(q, k, v, nullptr, nullptr, o, lse, B, T, T + window, H, 1, window, scale, frame, stream)
  FWD_HEAD_DIMS(CALL)
#undef CALL
}
