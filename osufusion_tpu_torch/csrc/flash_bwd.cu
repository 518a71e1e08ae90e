// Global flash-attention backward with fused q-RoPE, for Hopper (sm_90a):
// MQA, GQA and full MHA.
//
// Replaces osufusion_tpu/ops/pallas_attention.py::_bwd_fused_kernel (launched
// by _flash_bwd_fused): one sweep that recomputes the probabilities from the
// forward's log-sum-exp and does the five products s, dp, dv, dk, dq.
//
// Inputs: raw q (B, T, H, D) bf16, pre-rotated k and v (B, S, Kv, D) bf16
// (query head h reads KV head h / G, G = H / Kv), do and o (B, T, H, D) bf16,
// lse2 (B, T*H) fp32 in t-major order, the cos/sin tables (T, D) fp32, or
// none (DiT/MMDiT: then q is not rotated and dq not un-rotated). lse2 is the
// base-2 log-sum-exp of the forward's logits s2 = q_rot k_rot^T * scale *
// log2(e).
//
// The maths, with p = exp2(s2 - lse2) the softmax probability:
//   dv     = p^T do
//   dp     = do v^T
//   ds     = p * (dp - delta),  delta = rowsum(do * o)
//   dk_rot = scale * ds^T q_rot = ln(2) * ds^T qs
//   dq_rot = scale * ds k_rot, then un-rotated into the raw q's frame
// with qs = q_rot * scale * log2(e) in bf16, staged with the forward's
// arithmetic (rope_qs.cuh), so that s2 = qs k_rot^T repeats the forward's
// logits.
//
// Bound: compute, 5 products of 2 * D FLOP per (query, key) pair against a
// few hundred bytes per row. The design, in three launches (tiles move by
// TMA, `cp.async.bulk.tensor` and `cp.async.bulk` behind `mbarrier`s; every
// product is `wgmma.mma_async`; the wrappers are in hopper.cuh), each with an
// entry point of its own, which flash_bwd_bf16 calls in a row:
//
//  1. Pre-pass (flash_bwd_prep.cuh, shared with the windowed pair), one
//     sweep over the rows: qs (rotated and scaled once, not once per KV
//     tile), delta, and the LSE, each in group-major order, (B * Kv, T * G,
//     ...), so that every KV group's rows are contiguous whatever G is (row r:
//     timestep r / G, head kv * G + r % G); at Kv > 1 do is copied into that
//     order too (at MQA it already is). The LSE and delta are padded to whole
//     64-row tiles with +inf and 0, so a padded row has p = ds = 0. It also
//     zeroes the fp32 dq buffer.
//  2. The sweep (flash_bwd_kernel): one block per (batch, KV head, KV tile of
//     BN = 128 keys). Two consumer warpgroups each keep dk and dv of 64 keys
//     in fp32 registers; a producer warpgroup (one thread of it, holding 40
//     registers so that the consumers get 232) streams the group's query tiles
//     (BM = 64 rows of qs and do by TMA, LSE and delta by bulk copy) through
//     a ring of NSTAGE stages behind mbarriers. Per tile each warpgroup
//     computes S^T = K qs^T and dP^T = V do^T (wgmma, keys as M, both
//     operands in shared memory), so P^T and dS^T come out in registers
//     already as the A operand of dV += P^T do and dK += dS^T qs (no
//     shared-memory round trip, no transposing loads). dS^T goes to shared
//     memory once; then one warpgroup, the two taking turns tile by tile,
//     computes dQ = dS K over all 128 keys (wgmma m64n64, dS read MN-major)
//     and adds it into the fp32 buffer with red.global (atomicAdd of float2):
//     once per 128 keys. The order of the additions varies from run to run,
//     so dq differs in its last bits between runs.
//  3. Post-pass (flash_bwd_dq_kernel): dq = scale * un-rotate(buffer), cast to
//     bf16, back in (B, T, H, D) order.
//
// dk and dv leave in fp32, dk still in the rotated frame; the wrapper
// un-rotates it on the small tensor.
//
// The ring (ops/ring_attention.py, the counterpart of
// osufusion_tpu/ops/pallas_attention.py::_ring_bwd) calls the three apart:
// the pre-pass once, with the global o, LSE and do (delta is the same for
// every chunk of keys); one sweep per hop over the chunk that is here, whose
// dq atomics keep adding into the one fp32 buffer and which, with
// `accumulate`, adds its dk and dv into the travelling fp32 accumulators
// instead of storing them (each block owns its keys' rows: a read-modify-
// write without a race); the post-pass once, after the last sweep.
//
// C ABI (loaded with ctypes): every entry point returns a cudaError_t, or
// minus the CUresult of a TMA descriptor that failed to encode.

#include <math.h>

#include "flash_bwd_prep.cuh"
#include "hopper.cuh"

namespace {

constexpr int D = 64;                          // head dim
constexpr int BM = 64;                         // query rows per tile of the sweep
constexpr int BN = 128;                        // keys per block
constexpr int NSTAGE = 3;                      // query tiles in flight
constexpr int CONSUMERS = BN / 64;             // consumer warpgroups, 64 keys each
constexpr int THREADS = CONSUMERS * 128 + 128;  // and the producer warpgroup
// registers a thread after the hand-over: the producer keeps few, the
// consumers take the rest (2 x 128 x 232 + 128 x 40 <= 65536)
constexpr int PRODUCER_REGS = 40;
constexpr int CONSUMER_REGS = 232;
constexpr int KV_BYTES = BN * D * 2;
constexpr int ROW_TILE_BYTES = BM * D * 2;
constexpr int DS_BYTES = BN * BM * 2;
// K, V; per stage qs, do, lse, delta; two dS buffers; barriers
constexpr int SMEM_BYTES =
    1024 + 2 * KV_BYTES + NSTAGE * (2 * ROW_TILE_BYTES + 2 * BM * 4) + 2 * DS_BYTES + (2 * NSTAGE + 1) * 8;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

template <bool GROUPED, bool ACCUMULATE>
__global__ void __launch_bounds__(THREADS, 1)
flash_bwd_kernel(const __grid_constant__ CUtensorMap kmap, const __grid_constant__ CUtensorMap vmap,
                 const __grid_constant__ CUtensorMap qmap, const __grid_constant__ CUtensorMap domap,
                 const float* __restrict__ lse_g, const float* __restrict__ delta_g, float* __restrict__ dq_acc,
                 float* __restrict__ dk, float* __restrict__ dv, int T, int S, int H, int Kv, int pad) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  __nv_bfloat16* Ks = reinterpret_cast<__nv_bfloat16*>(smem);            // [BN][D]
  __nv_bfloat16* Vs = Ks + BN * D;                                       // [BN][D]
  __nv_bfloat16* Qs = Vs + BN * D;                                       // [NSTAGE][BM][D]
  __nv_bfloat16* Os = Qs + NSTAGE * BM * D;                              // [NSTAGE][BM][D] do
  __nv_bfloat16* Ss = Os + NSTAGE * BM * D;                              // [2][BN][BM] dS^T
  float* Ls = reinterpret_cast<float*>(Ss + 2 * BN * BM);                // [NSTAGE][BM] lse
  float* Es = Ls + NSTAGE * BM;                                          // [NSTAGE][BM] delta
  uint64_t* full = reinterpret_cast<uint64_t*>(Es + NSTAGE * BM);
  uint64_t* empty = full + NSTAGE;
  uint64_t* kv_bar = empty + NSTAGE;

  const int b = GROUPED ? blockIdx.y / Kv : blockIdx.y;
  const int kv = GROUPED ? blockIdx.y % Kv : 0;
  const int grp = blockIdx.y;  // b * Kv + kv
  const int rows = T * (H / Kv);
  const int s0 = blockIdx.x * BN;
  const int n_tiles = pad / BM;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int s = 0; s < NSTAGE; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], CONSUMERS * 4);  // one arrival per consumer warp
    }
    mbar_init(kv_bar, 1);
    fence_barrier_init();
  }
  __syncthreads();

  if (warp >= CONSUMERS * 4) {  // the producer warpgroup; one thread issues every copy
    setmaxnreg_dec<PRODUCER_REGS>();
    if (warp == CONSUMERS * 4 && lane == 0) {
      mbar_expect_tx(kv_bar, 2 * KV_BYTES);
      tma_load_4d(Ks, &kmap, kv_bar, 0, kv, s0, b);
      tma_load_4d(Vs, &vmap, kv_bar, 0, kv, s0, b);
      const float* lb = lse_g + (size_t)grp * pad;
      const float* eb = delta_g + (size_t)grp * pad;
      for (int it = 0; it < n_tiles; ++it) {
        const int st = it % NSTAGE;
        mbar_wait(&empty[st], ((it / NSTAGE) & 1) ^ 1);
        mbar_expect_tx(&full[st], 2 * ROW_TILE_BYTES + 2 * BM * 4);
        tma_load_3d(Qs + st * BM * D, &qmap, &full[st], 0, it * BM, grp);
        tma_load_3d(Os + st * BM * D, &domap, &full[st], 0, it * BM, grp);
        bulk_load(Ls + st * BM, lb + it * BM, BM * 4, &full[st]);
        bulk_load(Es + st * BM, eb + it * BM, BM * 4, &full[st]);
      }
    }
    return;
  }

  setmaxnreg_inc<CONSUMER_REGS>();
  const int wg = warp / 4;  // consumer warpgroup: keys s0 + 64 wg ...
  const int wi = warp % 4;
  const int g = lane >> 2;  // accumulator row (and row + 8) in the warp's 16
  const int tq = lane & 3;  // accumulator column pair
  const int key_a = s0 + wg * 64 + wi * 16 + g;  // this thread's two keys (rows of S^T, dk, dv)
  const int key_b = key_a + 8;
  const bool kv_tail = s0 + BN > S;
  const uint64_t kdesc = desc_kmajor(Ks + wg * 64 * D);  // K of this warpgroup's keys, as A
  const uint64_t vdesc = desc_kmajor(Vs + wg * 64 * D);
  const uint64_t kdesc_b = desc_mnmajor(Ks);             // all 128 keys, as dQ's B
  float* dqb = dq_acc + (size_t)grp * pad * D;

  float dv_acc[32], dk_acc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) dv_acc[i] = dk_acc[i] = 0.f;

  mbar_wait(kv_bar, 0);
  for (int it = 0; it < n_tiles; ++it) {
    const int st = it % NSTAGE;
    mbar_wait(&full[st], (it / NSTAGE) & 1);
    const __nv_bfloat16* Qt = Qs + st * BM * D;
    const __nv_bfloat16* Ot = Os + st * BM * D;

    // S^T = K qs^T and dP^T = V do^T: this warpgroup's 64 keys x the tile's 64 rows
    float s[32], dp[32];
    const uint64_t qdesc = desc_kmajor(Qt), odesc = desc_kmajor(Ot);
    reg_fence(s);
    reg_fence(dp);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) wgmma_ss_n64<0, 0>(s, kdesc + 2 * kk, qdesc + 2 * kk, kk);
    wgmma_commit();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) wgmma_ss_n64<0, 0>(dp, vdesc + 2 * kk, odesc + 2 * kk, kk);
    wgmma_commit();

    // p = exp2(s - lse2) (zero past S; a padded row has lse = +inf), ds = p (dp - delta)
    const float* lt = Ls + st * BM;
    const float* et = Es + st * BM;
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
    // (keys as M, the tile's rows as K); do and qs read MN-major
    uint32_t pa[BM / 16][4], ga[BM / 16][4];
#pragma unroll
    for (int j = 0; j < BM / 16; ++j) {
      a_frag(pa[j], s + 8 * j);
      a_frag(ga[j], dp + 8 * j);
    }
    const uint64_t qdesc_b = desc_mnmajor(Qt), odesc_b = desc_mnmajor(Ot);
    reg_fence(dv_acc);
    reg_fence(dk_acc);
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < BM / 16; ++j) wgmma_rs_n64<1>(dv_acc, pa[j], odesc_b + j * (16 * 128 >> 4), 1);
#pragma unroll
    for (int j = 0; j < BM / 16; ++j) wgmma_rs_n64<1>(dk_acc, ga[j], qdesc_b + j * (16 * 128 >> 4), 1);
    wgmma_commit();

    // dS^T to shared memory in bf16: [key][row], rows contiguous and swizzled
    __nv_bfloat16* St = Ss + (it & 1) * BN * BM;
    const int kr_a = wg * 64 + wi * 16 + g, kr_b = kr_a + 8;
#pragma unroll
    for (int i = 0; i < BM / 8; ++i) {
      *reinterpret_cast<uint32_t*>(St + sw128(kr_a, i) + 2 * tq) = ga[i / 2][(i & 1) * 2];
      *reinterpret_cast<uint32_t*>(St + sw128(kr_b, i) + 2 * tq) = ga[i / 2][(i & 1) * 2 + 1];
    }
    fence_proxy_async();
    named_bar_sync(1, CONSUMERS * 128);  // dS^T of all 128 keys is in place

    // dQ = dS K over the block's 128 keys: the warpgroups take turns by tile
    const bool mine = (it % CONSUMERS) == wg;
    float dq[32];
    if (mine) {
      const uint64_t sdesc = desc_mnmajor(St);
      reg_fence(dq);
      wgmma_fence();
#pragma unroll
      for (int j = 0; j < BN / 16; ++j)
        wgmma_ss_n64<1, 1>(dq, sdesc + j * (16 * 128 >> 4), kdesc_b + j * (16 * 128 >> 4), j);
      wgmma_commit();
    }
    wgmma_wait<0>();
    reg_fence(dv_acc);
    reg_fence(dk_acc);
    reg_fence(pa);
    reg_fence(ga);
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[st]);  // this warp is done with the stage
    if (mine) {
      reg_fence(dq);
      const int row_a = it * BM + wi * 16 + g, row_b = row_a + 8;
#pragma unroll
      for (int i = 0; i < D / 8; ++i) {
        const int col = 8 * i + 2 * tq;
        if (row_a < rows) atomicAdd(reinterpret_cast<float2*>(dqb + (size_t)row_a * D + col), make_float2(dq[4 * i], dq[4 * i + 1]));
        if (row_b < rows)
          atomicAdd(reinterpret_cast<float2*>(dqb + (size_t)row_b * D + col), make_float2(dq[4 * i + 2], dq[4 * i + 3]));
      }
    }
  }

  const int kvs = GROUPED ? Kv : 1;  // KV heads of a key row
  float* dkb = dk + ((size_t)b * S * kvs + kv) * D;
  float* dvb = dv + ((size_t)b * S * kvs + kv) * D;
  const size_t ld = (size_t)kvs * D;
  // ACCUMULATE: add into what the buffers hold (this block alone owns its keys' rows)
  auto put = [](float* dst, float x, float y) {
    float2* p = reinterpret_cast<float2*>(dst);
    if constexpr (ACCUMULATE) {
      const float2 old = *p;
      x += old.x;
      y += old.y;
    }
    *p = make_float2(x, y);
  };
#pragma unroll
  for (int i = 0; i < D / 8; ++i) {
    const int col = 8 * i + 2 * tq;
    if (key_a < S) {
      put(dkb + key_a * ld + col, dk_acc[4 * i] * LN2, dk_acc[4 * i + 1] * LN2);
      put(dvb + key_a * ld + col, dv_acc[4 * i], dv_acc[4 * i + 1]);
    }
    if (key_b < S) {
      put(dkb + key_b * ld + col, dk_acc[4 * i + 2] * LN2, dk_acc[4 * i + 3] * LN2);
      put(dvb + key_b * ld + col, dv_acc[4 * i + 2], dv_acc[4 * i + 3]);
    }
  }
}

// dq (B, T, H, D) bf16 = scale * the un-rotated buffer row (g cos - rot_half(g
// sin); columns d and d + 32 together), one thread per (row, 8 columns of the
// low half and their partners)
template <bool ROPE>
__global__ void flash_bwd_dq_kernel(const float* __restrict__ dq_acc, const float* __restrict__ cos_t,
                                    const float* __restrict__ sin_t, __nv_bfloat16* __restrict__ dq, size_t n_rows,
                                    int T, int H, int Kv, int pad, float scale) {
  const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  const size_t row = idx / 4;  // the (b, t, h) row
  if (row >= n_rows) return;
  const int col = (idx % 4) * 8;
  const int h = row % H;
  const size_t bt = row / H;
  const int t = bt % T;
  const size_t b = bt / T;
  const int G = H / Kv;
  const float* src = dq_acc + ((b * Kv + h / G) * pad + (size_t)t * G + h % G) * D;
  float lo[8], hi[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const float g_lo = src[col + j], g_hi = src[col + D / 2 + j];
    if (ROPE) {
      const float* cr = cos_t + (size_t)t * D;
      const float* sr = sin_t + (size_t)t * D;
      lo[j] = (g_lo * cr[col + j] + g_hi * sr[col + D / 2 + j]) * scale;
      hi[j] = (g_hi * cr[col + D / 2 + j] - g_lo * sr[col + j]) * scale;
    } else {
      lo[j] = g_lo * scale;
      hi[j] = g_hi * scale;
    }
  }
  uint4 pl, ph;
  pl.x = pack_bf16(lo[0], lo[1]); pl.y = pack_bf16(lo[2], lo[3]);
  pl.z = pack_bf16(lo[4], lo[5]); pl.w = pack_bf16(lo[6], lo[7]);
  ph.x = pack_bf16(hi[0], hi[1]); ph.y = pack_bf16(hi[2], hi[3]);
  ph.z = pack_bf16(hi[4], hi[5]); ph.w = pack_bf16(hi[6], hi[7]);
  *reinterpret_cast<uint4*>(dq + row * D + col) = pl;
  *reinterpret_cast<uint4*>(dq + row * D + col + D / 2) = ph;
}

// (D, rows, groups) bf16 rows of a group-major buffer, boxes of BM rows; rows
// past `rows` arrive as zeros
int make_rows_map(CUtensorMap* map, const void* ptr, int rows, int groups) {
  const cuuint64_t dims[3] = {D, (cuuint64_t)rows, (cuuint64_t)groups};
  const cuuint64_t strides[2] = {D * 2, (cuuint64_t)rows * D * 2};
  const cuuint32_t box[3] = {D, BM, 1};
  return make_map_bf16(map, 3, ptr, dims, strides, box);
}

}  // namespace

// The scratch, allocated by the caller: qs_g (B*Kv, T*G, D) bf16; do_g the
// same, or null at Kv == 1 (do is then read in place); lse_g and delta_g
// (B*Kv, pad) fp32 and dq_acc (B*Kv, pad, D) fp32, pad = T*G rounded up to a
// multiple of 64. Kv KV heads (H % Kv == 0, checked by the caller); cos_t and
// sin_t (T, D) fp32, or null for no rotary embedding.

// 1. The pre-pass: qs_g, do_g (Kv > 1), lse_g, delta_g, and dq_acc zeroed.
extern "C" int flash_bwd_prep_bf16(const void* q, const void* dout, const void* o, const void* lse, const void* cos_t,
                                   const void* sin_t, void* qs_g, void* do_g, void* lse_g, void* delta_g, void* dq_acc,
                                   int B, int T, int H, int Kv, float scale, void* stream) {
  if (Kv > 1 && do_g == nullptr) return (int)cudaErrorInvalidValue;
  int dev;
  const int err = bind_device(&dev);
  if (err != 0) return err;
  const int pad = (T * (H / Kv) + BM - 1) / BM * BM;
  auto prep = cos_t != nullptr ? flash_bwd_prep_kernel<true> : flash_bwd_prep_kernel<false>;
  prep<<<dim3(pad * 4 / 256, B * Kv), 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(dout),
      static_cast<const __nv_bfloat16*>(o), static_cast<const float*>(lse), static_cast<const float*>(cos_t),
      static_cast<const float*>(sin_t), static_cast<__nv_bfloat16*>(qs_g),
      Kv > 1 ? static_cast<__nv_bfloat16*>(do_g) : nullptr, static_cast<float*>(lse_g), static_cast<float*>(delta_g),
      static_cast<float*>(dq_acc), T, H, Kv, pad, scale * LOG2E);
  return (int)cudaGetLastError();
}

// 2. The sweep over S keys of k and v (B, S, Kv, D) bf16: dq's atomics add into
// dq_acc; dk and dv (B, S, Kv, D) fp32 are stored, or with `accumulate` added
// into what they hold. do_rows is do_g at Kv > 1, do itself at Kv == 1.
extern "C" int flash_bwd_sweep_bf16(const void* k, const void* v, const void* qs_g, const void* do_rows,
                                    const void* lse_g, const void* delta_g, void* dq_acc, void* dk, void* dv, int B,
                                    int T, int S, int H, int Kv, int accumulate, void* stream) {
  const int rows = T * (H / Kv);
  const int pad = (rows + BM - 1) / BM * BM;
  const int groups = B * Kv;
  CUtensorMap kmap, vmap, qmap, domap;
  int dev;
  int err = bind_device(&dev);
  if (err == 0) err = make_kv_map(&kmap, k, B, S, Kv, BN);
  if (err == 0) err = make_kv_map(&vmap, v, B, S, Kv, BN);
  if (err == 0) err = make_rows_map(&qmap, qs_g, rows, groups);
  if (err == 0) err = make_rows_map(&domap, do_rows, rows, groups);
  if (err != 0) return err;

  auto kernel = Kv > 1 ? (accumulate ? flash_bwd_kernel<true, true> : flash_bwd_kernel<true, false>)
                       : (accumulate ? flash_bwd_kernel<false, true> : flash_bwd_kernel<false, false>);
  static std::atomic<unsigned long long> smem_set[4];  // per instance: devices whose limit is raised
  err = allow_smem(kernel, SMEM_BYTES, dev, smem_set[(Kv > 1) * 2 + (accumulate != 0)]);
  if (err != 0) return err;
  kernel<<<dim3((S + BN - 1) / BN, groups), THREADS, SMEM_BYTES, static_cast<cudaStream_t>(stream)>>>(
      kmap, vmap, qmap, domap, static_cast<const float*>(lse_g), static_cast<const float*>(delta_g),
      static_cast<float*>(dq_acc), static_cast<float*>(dk), static_cast<float*>(dv), T, S, H, Kv, pad);
  return (int)cudaGetLastError();
}

// 3. The post-pass: dq (B, T, H, D) bf16 = scale * the un-rotated dq_acc.
extern "C" int flash_bwd_post_bf16(const void* dq_acc, const void* cos_t, const void* sin_t, void* dq, int B, int T,
                                   int H, int Kv, float scale, void* stream) {
  int dev;
  const int err = bind_device(&dev);
  if (err != 0) return err;
  const int pad = (T * (H / Kv) + BM - 1) / BM * BM;
  const size_t n_rows = (size_t)B * T * H;
  auto post = cos_t != nullptr ? flash_bwd_dq_kernel<true> : flash_bwd_dq_kernel<false>;
  post<<<(unsigned)((n_rows * 4 + 255) / 256), 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(dq_acc), static_cast<const float*>(cos_t), static_cast<const float*>(sin_t),
      static_cast<__nv_bfloat16*>(dq), n_rows, T, H, Kv, pad, scale);
  return (int)cudaGetLastError();
}

// The whole backward at one site: the three in a row, the sweep storing dk, dv.
extern "C" int flash_bwd_bf16(const void* q, const void* k, const void* v, const void* dout, const void* o,
                              const void* lse, const void* cos_t, const void* sin_t, void* qs_g, void* do_g,
                              void* lse_g, void* delta_g, void* dq_acc, void* dq, void* dk, void* dv, int B, int T,
                              int S, int H, int Kv, float scale, void* stream) {
  int err = flash_bwd_prep_bf16(q, dout, o, lse, cos_t, sin_t, qs_g, do_g, lse_g, delta_g, dq_acc, B, T, H, Kv, scale,
                                stream);
  if (err == 0)
    err = flash_bwd_sweep_bf16(k, v, qs_g, Kv > 1 ? do_g : dout, lse_g, delta_g, dq_acc, dk, dv, B, T, S, H, Kv, 0,
                               stream);
  if (err == 0) err = flash_bwd_post_bf16(dq_acc, cos_t, sin_t, dq, B, T, H, Kv, scale, stream);
  return err;
}
