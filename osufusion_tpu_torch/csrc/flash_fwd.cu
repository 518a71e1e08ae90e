// Flash-attention forward with fused q-RoPE, for Hopper (sm_90a): MQA, GQA
// and full MHA, windowed or global.
//
// Replaces osufusion_tpu/ops/pallas_attention.py::_fwd_kernel (launched by
// _flash_fwd), in its serving, training and DiT/MMDiT forms. Semantics: key s
// is attended by query t iff |t - s| <= window / 2 (window < 0: every key).
// With tables, q arrives raw and is rotated here and k arrives already
// rotated; without them (DiT/MMDiT: null tables) q is only scaled. The output
// is softmax(q k^T * scale) v, query head h reading KV head h / G (G = H / Kv
// heads a group). With a non-null lse pointer (the training form) the kernel
// also writes, per (b, t, h) row, the base-2 log-sum-exp of its own logits
// q k^T * scale * log2(e), fp32, flat (B, T*H) in t-major order: what the
// backward kernels recompute the probabilities from. Serving passes null and
// pays nothing for it.
//
// Bound: compute (see ops/flash_attention.py): 4 * D FLOP per visited (query,
// key) pair on the tensor cores, and one exp2 per pair, which at D = 64 costs
// the SM's special-function units about as long as the pair's products cost
// its tensor cores. The design keeps both busy and moves every tile by TMA
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
//    streams the KV tiles (BN = 128 keys of the block's KV head) that
//    intersect [t_lo - w/2, t_hi + w/2] by TMA into a ring of NSTAGE stages
//    behind full / empty mbarriers. k and v are read through a 4-d tensor map
//    (D, Kv, S, B), so keys past S arrive as zeros.
//  * q. Each consumer warpgroup rotates its 64 rows once, in fp32 with the
//    arithmetic of rope_qs.cuh (scale * log2(e) folded in), and stores them
//    in the 128-byte swizzle that wgmma reads (hopper.cuh), then fences the
//    async proxy: the logits are qs k_rot^T with the bits of qs that the
//    windowed backward (flash_bwd_windowed.cu) stages.
//  * Products. S = qs K^T is wgmma m64n128k16 with both operands in shared
//    memory (fp32 accumulators, 64 a thread). P, rounded to bf16, stays in
//    registers as the A operand of O += P V (wgmma m64n64k16, V read
//    MN-major): no shared-memory round trip.
//  * Softmax. Online, fp32, exp2 domain, the row statistics shared by the four
//    threads of a quad. Only tiles at the edge of the window or past S are
//    masked, and a row that has seen no key yet keeps a zero base.
//  * Overlap. Each warpgroup issues tile j's scores and tile j-1's P V
//    together and waits only for the scores, so its softmax of tile j runs
//    while the tensor cores do the P V; O is rescaled after. The two
//    warpgroups are not locked together either, so one's softmax also
//    overlaps the other's products. A stage is released once its P V is done;
//    NSTAGE = 4 keeps two tiles loading ahead of the two in use.
//
// C ABI (loaded with ctypes): flash_fwd_bf16 returns a cudaError_t, or minus
// the CUresult of a TMA descriptor that failed to encode; lse may
// be null, and cos_t / sin_t are null together or not at all.

#include <math.h>

#include "hopper.cuh"
#include "rope_qs.cuh"

namespace {

constexpr int D = 64;                       // head dim
constexpr int BM = 128;                     // (timestep, head) rows per block
constexpr int BN = 128;                     // keys per KV tile
constexpr int NSTAGE = 4;                   // KV tiles in flight
constexpr int CONSUMERS = BM / 64;          // consumer warpgroups
constexpr int THREADS = CONSUMERS * 128 + 32;  // and the producer warp
constexpr int Q_BYTES = BM * D * 2;
constexpr int TILE_BYTES = BN * D * 2;
constexpr int SMEM_BYTES = 1024 + Q_BYTES + 2 * NSTAGE * TILE_BYTES + 2 * NSTAGE * 8;
constexpr float LOG2E = 1.4426950408889634f;

template <bool GROUPED, bool ROPE>
__global__ void __launch_bounds__(THREADS, 1)
flash_fwd_kernel(const __grid_constant__ CUtensorMap kmap, const __grid_constant__ CUtensorMap vmap,
                 const __nv_bfloat16* __restrict__ q, const float* __restrict__ cos_t,
                 const float* __restrict__ sin_t, __nv_bfloat16* __restrict__ o, float* __restrict__ lse, int T,
                 int S, int H, int Kv, int window, float scale) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem);               // [BM][D], swizzled
  __nv_bfloat16* Ks = reinterpret_cast<__nv_bfloat16*>(smem + Q_BYTES);     // [NSTAGE][BN][D]
  __nv_bfloat16* Vs = Ks + NSTAGE * BN * D;                                 // [NSTAGE][BN][D]
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + Q_BYTES + 2 * NSTAGE * TILE_BYTES);
  uint64_t* empty = full + NSTAGE;

  const int b = GROUPED ? blockIdx.y / Kv : blockIdx.y;
  const int kv = GROUPED ? blockIdx.y % Kv : 0;
  const int G = GROUPED ? H / Kv : H;  // heads of the group: its rows are T*G
  const int rows = T * G;
  const int r0 = blockIdx.x * BM;
  const bool local = window >= 0;
  const int w2 = window / 2;
  const int t_lo = r0 / G;
  const int t_hi = (min(r0 + BM, rows) - 1) / G;
  const int kv_lo = local ? max(0, t_lo - w2) : 0;
  const int kv_hi = local ? min(S, t_hi + w2 + 1) : S;
  const int n_tiles = (kv_hi - kv_lo + BN - 1) / BN;
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

  if (warp == CONSUMERS * 4) {  // producer
    if (lane == 0) {
      for (int it = 0; it < n_tiles; ++it) {
        const int st = it % NSTAGE;
        mbar_wait(&empty[st], ((it / NSTAGE) & 1) ^ 1);
        mbar_expect_tx(&full[st], 2 * TILE_BYTES);
        const int s0 = kv_lo + it * BN;
        tma_load_4d(Ks + st * BN * D, &kmap, &full[st], 0, kv, s0, b);
        tma_load_4d(Vs + st * BN * D, &vmap, &full[st], 0, kv, s0, b);
      }
    }
    return;
  }

  const int wg = warp / 4;        // consumer warpgroup
  const int tid = threadIdx.x % 128;
  const int g = lane >> 2;        // accumulator row (and row + 8) of this thread in its warp's 16
  const int tq = lane & 3;        // accumulator column pair
  __nv_bfloat16* Qw = Qs + wg * 64 * D;
  // (timestep, head) row of q, o and lse that group row r is
  auto mem = [&](int r) { return GROUPED ? (size_t)(r / G) * H + r % G : (size_t)r; };
  const __nv_bfloat16* qb = q + ((size_t)b * T * H + kv * G) * D;
  __nv_bfloat16* ob = o + ((size_t)b * T * H + kv * G) * D;

  // stage this warpgroup's 64 rows as qs, in the swizzled layout
  const float qscale = scale * LOG2E;
  for (int c = tid; c < 64 * 4; c += 128) {
    const int r = c / 4;
    const int col = (c % 4) * 8;  // 8 columns of the low half, and their partners
    const int row = r0 + wg * 64 + r;
    uint4 lo = make_uint4(0, 0, 0, 0), hi = make_uint4(0, 0, 0, 0);
    if (row < rows) {
      const size_t t = row / G;
      rope_qs8<ROPE>(qb + mem(row) * D, ROPE ? cos_t + t * D : nullptr, ROPE ? sin_t + t * D : nullptr, col, qscale,
                     lo, hi);
    }
    *reinterpret_cast<uint4*>(Qw + sw128(r, col / 8)) = lo;
    *reinterpret_cast<uint4*>(Qw + sw128(r, col / 8 + 4)) = hi;
  }
  fence_proxy_async();
  named_bar_sync(1 + wg, 128);

  const uint64_t qdesc = desc_kmajor(Qw);
  const int row_a = r0 + wg * 64 + (warp % 4) * 16 + g;
  const int row_b = row_a + 8;
  const int tr[2] = {row_a / G, row_b / G};  // timesteps of the thread's two rows

  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.f, 0.f};
  float acc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.f;
  float s[64];                // the logits of the tile in hand, then its probabilities
  uint32_t pa[BN / 16][4];    // the previous tile's probabilities in bf16, the A operand of O += P V
  float corr[2];

  // mask the logits of tile `it` and fold them into the online softmax:
  // s becomes p = exp2(s - base), corr the factor that moves O to the new base
  auto softmax = [&](int it) {
    const int s0 = kv_lo + it * BN;
    const bool interior = s0 + BN <= S && (!local || (s0 >= t_hi - w2 && s0 + BN - 1 <= t_lo + w2));
    if (!interior) {
#pragma unroll
      for (int i = 0; i < BN / 8; ++i) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = s0 + i * 8 + 2 * tq + (e & 1);
          const bool ok = key < S && (!local || abs(tr[e >> 1] - key) <= w2);
          if (!ok) s[4 * i + e] = -INFINITY;
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
      corr[r] = exp2f(m[r] - base[r]);
      m[r] = mx[r];
    }
    float rs[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < BN / 8; ++i) {
      s[4 * i] = exp2f(s[4 * i] - base[0]);
      s[4 * i + 1] = exp2f(s[4 * i + 1] - base[0]);
      s[4 * i + 2] = exp2f(s[4 * i + 2] - base[1]);
      s[4 * i + 3] = exp2f(s[4 * i + 3] - base[1]);
      rs[0] += s[4 * i] + s[4 * i + 1];
      rs[1] += s[4 * i + 2] + s[4 * i + 3];
    }
    l[0] = l[0] * corr[0] + rs[0];  // per-thread partial sums, reduced at the end
    l[1] = l[1] * corr[1] + rs[1];
  };
  // S = qs K^T of the tile in stage st (log2-domain logits, 64 rows x 128 keys), issued
  auto issue_scores = [&](int st) {
    const uint64_t kdesc = desc_kmajor(Ks + st * BN * D);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) wgmma_ss_n128<0, 0>(s, qdesc + 2 * kk, kdesc + 2 * kk, kk);
    wgmma_commit();
  };
  // O += P V with the previous tile's P (pa) and the V of stage st, issued
  auto issue_pv = [&](int st) {
    const uint64_t vdesc = desc_mnmajor(Vs + st * BN * D);
#pragma unroll
    for (int j = 0; j < BN / 16; ++j) wgmma_rs_n64<1>(acc, pa[j], vdesc + j * (16 * 128 >> 4), 1);
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
    for (int i = 0; i < 8; ++i) {
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
  for (int i = 0; i < 8; ++i) {
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

}  // namespace

// Kv KV heads (H % Kv == 0, checked by the caller); cos_t and sin_t null for
// no rotary embedding.
extern "C" int flash_fwd_bf16(const void* q, const void* k, const void* v, const void* cos_t, const void* sin_t,
                              void* o, void* lse, int B, int T, int S, int H, int Kv, int window, float scale,
                              void* stream) {
  const bool rope = cos_t != nullptr;
  auto kernel = Kv > 1 ? (rope ? flash_fwd_kernel<true, true> : flash_fwd_kernel<true, false>)
                       : (rope ? flash_fwd_kernel<false, true> : flash_fwd_kernel<false, false>);
  static std::atomic<unsigned long long> smem_set[4];  // per instance: devices whose limit is raised
  CUtensorMap kmap, vmap;
  int dev;
  int err = bind_device(&dev);
  if (err == 0) err = make_kv_map(&kmap, k, B, S, Kv, BN);
  if (err == 0) err = make_kv_map(&vmap, v, B, S, Kv, BN);
  if (err == 0) err = allow_smem(kernel, SMEM_BYTES, dev, smem_set[(Kv > 1) * 2 + rope]);
  if (err != 0) return err;
  const dim3 grid((T * (H / Kv) + BM - 1) / BM, B * Kv);
  kernel<<<grid, THREADS, SMEM_BYTES, static_cast<cudaStream_t>(stream)>>>(
      kmap, vmap, static_cast<const __nv_bfloat16*>(q), static_cast<const float*>(cos_t),
      static_cast<const float*>(sin_t), static_cast<__nv_bfloat16*>(o), static_cast<float*>(lse), T, S, H, Kv, window,
      scale);
  return (int)cudaGetLastError();
}
