// Global MQA flash-attention backward with fused q-RoPE, for Hopper (sm_90a).
//
// Replaces osufusion_tpu/ops/pallas_attention.py::_bwd_fused_kernel (launched
// by _flash_bwd_fused): one sweep that recomputes the probabilities from the
// forward's log-sum-exp and does the five products s, dp, dv, dk, dq.
//
// Inputs: raw q (B, T, H, D) bf16, pre-rotated k and v (B, S, D) bf16, do and
// o (B, T, H, D) bf16, lse2 (B, T*H) fp32 in t-major order, the cos/sin tables
// (T, D) fp32. lse2 is the base-2 log-sum-exp of the forward's logits
// s2 = q_rot k_rot^T * scale * log2(e). A first small kernel writes
// delta = rowsum(do * o) into a (B, T*H) fp32 scratch buffer (one pass over
// do and o, eight threads a row), which the JAX package leaves to XLA.
//
// The maths, with p = exp2(s2 - lse2) the softmax probability:
//   dv     = p^T do
//   dp     = do v^T
//   ds     = p * (dp - delta)           gradient of the natural-log logits
//   dk_rot = scale * ds^T q_rot
//   dq_rot = scale * ds k_rot
// The kernel holds q as qs = q_rot * scale * log2(e) in bf16, rotated in fp32
// on load exactly as the forward does, so that s2 = qs k_rot^T repeats the
// forward's logits bit for bit. Hence the constants each output carries:
//   dv      no factor;
//   dk_rot  = ln(2) * ds^T qs   (qs already carries scale * log2(e));
//   dq_rot  = scale * ds k_rot, then un-rotated into the raw q's frame,
//             g cos - rot_half(g sin), before it leaves the registers.
//
// Layout and work split (the card's own, not the TPU kernel's):
//  * One block per (batch element, KV tile of BN = 64 keys). It keeps dk and
//    dv of its tile for ALL heads in registers (MQA: both sum over heads and
//    query rows; the (timestep, head) pairs are T*H contiguous rows of q) and
//    sweeps the query rows in tiles of BM = 64. Blocks share nothing except dq.
//  * dq: each block adds its contribution with fp32 atomicAdd (two floats at
//    a time) into a zeroed (B, T, H, D) fp32 buffer. The TPU version has no
//    atomics and writes one partial per KV block instead; that stack is not
//    carried over. The order of the additions varies from run to run, so dq
//    differs in its last bits between runs.
//  * Per query tile: s and dp are mma.sync m16n8k16 bf16 -> fp32 with each of
//    the 4 warps owning 16 rows, every operand fragment read from shared
//    memory with ldmatrix; p and ds are written to shared memory in
//    bf16 so that the transposed products (p^T do, ds^T qs) can read them with
//    ldmatrix.trans, each warp owning 16 keys of dk and dv; dq = ds k_rot uses
//    the ds accumulators re-packed in registers as the A operand.
//  * 128 threads and 54 KB of shared memory per block, so two blocks share an
//    SM (the ~220 registers a thread allow no third) and one's loads overlap
//    the other's products. There is no second cp.async stage for the next
//    query tile: the simple single stage stays until a measurement asks for
//    more.
//
// Bound: compute (5 products of 2*T*S*H*D each per batch element against
// q/do/dq traffic of a few hundred bytes per row). dk and dv leave in fp32;
// the wrapper un-rotates dk and casts.
//
// C ABI (loaded with ctypes): flash_bwd_bf16 returns cudaGetLastError().

#include "flash_bwd_common.cuh"

namespace {

constexpr int BM = 64;        // (timestep, head) rows per sweep step
constexpr int WARPS = BM / 16;
constexpr int THREADS = WARPS * 32;
constexpr int TILE = BM * LDS;  // elements of one staged tile (BN == BM)
constexpr int SMEM_BYTES = 6 * TILE * 2;  // k, v; qs, do, p, ds

static_assert(BM == BN, "one tile size serves k, v, qs, do, p and ds");

__global__ void __launch_bounds__(THREADS, 2)
flash_bwd_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
                 const float* __restrict__ lse, const float* __restrict__ delta,
                 const float* __restrict__ cos_t, const float* __restrict__ sin_t, float* __restrict__ dq,
                 float* __restrict__ dk, float* __restrict__ dv, int T, int S, int H, float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Ks = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [BN][LDS]
  __nv_bfloat16* Vs = Ks + BN * LDS;                                // [BN][LDS]
  __nv_bfloat16* Qs = Vs + TILE;                                    // [BM][LDS] rotated, scaled q
  __nv_bfloat16* Os = Qs + TILE;                                    // [BM][LDS] do
  __nv_bfloat16* Ps = Os + TILE;                                    // [BM][LDS] p, rows x keys
  __nv_bfloat16* Gs = Ps + TILE;                                    // [BM][LDS] ds, rows x keys

  const int b = blockIdx.y;
  const int s0 = blockIdx.x * BN;
  const int rows = T * H;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane >> 2;   // mma group: fragment row (and row + 8)
  const int tg = lane & 3;   // thread in group: fragment column pair
  const int mi = lane >> 3;  // ldmatrix: which of the four 8x8 matrices this lane addresses
  const int mr = lane & 7;   // ldmatrix: row of that matrix
  const int wr = warp * 16;  // this warp's rows of a query tile, and its keys of dk/dv

  const __nv_bfloat16* qb = q + (size_t)b * rows * D;
  const __nv_bfloat16* dob = dout + (size_t)b * rows * D;
  const __nv_bfloat16* kb = k + (size_t)b * S * D;
  const __nv_bfloat16* vb = v + (size_t)b * S * D;
  const float* lseb = lse + (size_t)b * rows;
  const float* deltab = delta + (size_t)b * rows;
  float* dqb = dq + (size_t)b * rows * D;

  copy_kv_tile<THREADS>(Ks, Vs, kb, vb, s0, S, tid);
  cp_async_commit();
  const bool kv_tail = s0 + BN > S;

  float dv_acc[D / 8][4], dk_acc[D / 8][4];
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt) {
    dv_acc[dt][0] = dv_acc[dt][1] = dv_acc[dt][2] = dv_acc[dt][3] = 0.f;
    dk_acc[dt][0] = dk_acc[dt][1] = dk_acc[dt][2] = dk_acc[dt][3] = 0.f;
  }

  const float qscale = scale * LOG2E;
  const int n_tiles = (rows + BM - 1) / BM;

  for (int it = 0; it < n_tiles; ++it) {
    const int r0 = it * BM;

    // stage do (copied as is) and qs (rotated in fp32, as the forward does)
    copy_rows<BM, THREADS>(Os, dob, r0, rows, tid);
    cp_async_commit();
    // this thread's two fragment rows and their statistics; a row past the
    // end gets lse = +inf, so its p and ds are zero
    const int row_a = r0 + wr + g;
    const int row_b = row_a + 8;
    const float lse_r[2] = {row_a < rows ? lseb[row_a] : INFINITY, row_b < rows ? lseb[row_b] : INFINITY};
    const float delta_r[2] = {row_a < rows ? deltab[row_a] : 0.f, row_b < rows ? deltab[row_b] : 0.f};
    stage_qs<BM, THREADS>(Qs, qb, cos_t, sin_t, r0, rows, H, qscale, tid);
    cp_async_wait<0>();  // do of this tile; on the first tile k and v too
    __syncthreads();

    // s = qs k^T and dp = do v^T for this warp's 16 rows x BN keys
    float s[BN / 8][4], dp[BN / 8][4];
#pragma unroll
    for (int nt = 0; nt < BN / 8; ++nt) {
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
      dp[nt][0] = dp[nt][1] = dp[nt][2] = dp[nt][3] = 0.f;
    }
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t qa[4], da[4];
      load_a(qa, Qs, wr, kk, lane);
      load_a(da, Os, wr, kk, lane);
#pragma unroll
      for (int np = 0; np < BN / 16; ++np) {
        uint32_t kf[4], vf[4];
        load_b(kf, Ks, np * 16, kk, lane);
        load_b(vf, Vs, np * 16, kk, lane);
        mma_bf16(s[2 * np], qa, kf[0], kf[1]);
        mma_bf16(s[2 * np + 1], qa, kf[2], kf[3]);
        mma_bf16(dp[2 * np], da, vf[0], vf[1]);
        mma_bf16(dp[2 * np + 1], da, vf[2], vf[3]);
      }
    }

    // p = exp2(s - lse2), ds = p (dp - delta); both to shared memory in bf16
#pragma unroll
    for (int nt = 0; nt < BN / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float p = exp2f(s[nt][e] - lse_r[e >> 1]);
        if (kv_tail && s0 + nt * 8 + 2 * tg + (e & 1) >= S) p = 0.f;
        s[nt][e] = p;
        dp[nt][e] = p * (dp[nt][e] - delta_r[e >> 1]);
      }
      const int off_a = (wr + g) * LDS + nt * 8 + 2 * tg;
      const int off_b = off_a + 8 * LDS;
      *reinterpret_cast<uint32_t*>(Ps + off_a) = pack_bf16(s[nt][0], s[nt][1]);
      *reinterpret_cast<uint32_t*>(Ps + off_b) = pack_bf16(s[nt][2], s[nt][3]);
      *reinterpret_cast<uint32_t*>(Gs + off_a) = pack_bf16(dp[nt][0], dp[nt][1]);
      *reinterpret_cast<uint32_t*>(Gs + off_b) = pack_bf16(dp[nt][2], dp[nt][3]);
    }

    // dq_rot = ds k for this warp's 16 rows: the ds accumulators of two
    // adjacent key tiles are the A fragment of one 16-key step
    float dq_acc[D / 8][4];
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt) dq_acc[dt][0] = dq_acc[dt][1] = dq_acc[dt][2] = dq_acc[dt][3] = 0.f;
#pragma unroll
    for (int kt = 0; kt < BN / 16; ++kt) {
      const uint32_t ga[4] = {pack_bf16(dp[2 * kt][0], dp[2 * kt][1]), pack_bf16(dp[2 * kt][2], dp[2 * kt][3]),
                              pack_bf16(dp[2 * kt + 1][0], dp[2 * kt + 1][1]),
                              pack_bf16(dp[2 * kt + 1][2], dp[2 * kt + 1][3])};
#pragma unroll
      for (int dd = 0; dd < D / 16; ++dd) {
        uint32_t kf[4];
        ldmatrix_x4_trans(kf, Ks + (kt * 16 + mr + (mi & 1) * 8) * LDS + dd * 16 + (mi >> 1) * 8);
        mma_bf16(dq_acc[2 * dd], ga, kf[0], kf[1]);
        mma_bf16(dq_acc[2 * dd + 1], ga, kf[2], kf[3]);
      }
    }
    // un-rotate into the raw q's frame (g cos - rot_half(g sin); columns d and
    // d + 32 sit in the same thread), apply scale, add into the fp32 buffer
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = i == 0 ? row_a : row_b;
      if (row < rows) {
        const float* cr = cos_t + (size_t)(row / H) * D;
        const float* sr = sin_t + (size_t)(row / H) * D;
        float* dst = dqb + (size_t)row * D;
#pragma unroll
        for (int dt = 0; dt < D / 16; ++dt) {
          const int col = dt * 8 + 2 * tg;
          const float2 c_lo = *reinterpret_cast<const float2*>(cr + col);
          const float2 c_hi = *reinterpret_cast<const float2*>(cr + col + D / 2);
          const float2 s_lo = *reinterpret_cast<const float2*>(sr + col);
          const float2 s_hi = *reinterpret_cast<const float2*>(sr + col + D / 2);
          const float g_lo0 = dq_acc[dt][2 * i], g_lo1 = dq_acc[dt][2 * i + 1];
          const float g_hi0 = dq_acc[dt + D / 16][2 * i], g_hi1 = dq_acc[dt + D / 16][2 * i + 1];
          const float2 lo = make_float2((g_lo0 * c_lo.x + g_hi0 * s_hi.x) * scale,
                                        (g_lo1 * c_lo.y + g_hi1 * s_hi.y) * scale);
          const float2 hi = make_float2((g_hi0 * c_hi.x - g_lo0 * s_lo.x) * scale,
                                        (g_hi1 * c_hi.y - g_lo1 * s_lo.y) * scale);
          atomicAdd(reinterpret_cast<float2*>(dst + col), lo);
          atomicAdd(reinterpret_cast<float2*>(dst + col + D / 2), hi);
        }
      }
    }
    __syncthreads();  // p and ds of every warp are in shared memory

    // dv += p^T do and dk += ds^T qs for this warp's 16 keys, over the tile's rows
#pragma unroll
    for (int ks = 0; ks < BM / 16; ++ks) {
      uint32_t pa[4], ga[4];
      const int a_off = (ks * 16 + mr + (mi >> 1) * 8) * LDS + wr + (mi & 1) * 8;
      ldmatrix_x4_trans(pa, Ps + a_off);
      ldmatrix_x4_trans(ga, Gs + a_off);
#pragma unroll
      for (int dd = 0; dd < D / 16; ++dd) {
        uint32_t bf[4];
        const int b_off = (ks * 16 + mr + (mi & 1) * 8) * LDS + dd * 16 + (mi >> 1) * 8;
        ldmatrix_x4_trans(bf, Os + b_off);
        mma_bf16(dv_acc[2 * dd], pa, bf[0], bf[1]);
        mma_bf16(dv_acc[2 * dd + 1], pa, bf[2], bf[3]);
        ldmatrix_x4_trans(bf, Qs + b_off);
        mma_bf16(dk_acc[2 * dd], ga, bf[0], bf[1]);
        mma_bf16(dk_acc[2 * dd + 1], ga, bf[2], bf[3]);
      }
    }
    __syncthreads();  // the tiles just read are the next step's copy targets
  }

  const int key_a = s0 + wr + g;
  const int key_b = key_a + 8;
  float* dkb = dk + (size_t)b * S * D;
  float* dvb = dv + (size_t)b * S * D;
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt) {
    const int col = dt * 8 + 2 * tg;
    if (key_a < S) {
      *reinterpret_cast<float2*>(dkb + (size_t)key_a * D + col) = make_float2(dk_acc[dt][0] * LN2, dk_acc[dt][1] * LN2);
      *reinterpret_cast<float2*>(dvb + (size_t)key_a * D + col) = make_float2(dv_acc[dt][0], dv_acc[dt][1]);
    }
    if (key_b < S) {
      *reinterpret_cast<float2*>(dkb + (size_t)key_b * D + col) = make_float2(dk_acc[dt][2] * LN2, dk_acc[dt][3] * LN2);
      *reinterpret_cast<float2*>(dvb + (size_t)key_b * D + col) = make_float2(dv_acc[dt][2], dv_acc[dt][3]);
    }
  }
}

}  // namespace

// delta is scratch that the first kernel fills; dq must arrive zeroed.
extern "C" int flash_bwd_bf16(const void* q, const void* k, const void* v, const void* dout, const void* o,
                              const void* lse, void* delta, const void* cos_t, const void* sin_t, void* dq, void* dk,
                              void* dv, int B, int T, int S, int H, float scale, void* stream) {
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  err = launch_delta(dout, o, delta, (size_t)B * T * H, st);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((S + BN - 1) / BN, B);
  flash_bwd_kernel<<<grid, THREADS, SMEM_BYTES, st>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const __nv_bfloat16*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta), static_cast<const float*>(cos_t),
      static_cast<const float*>(sin_t), static_cast<float*>(dq), static_cast<float*>(dk), static_cast<float*>(dv), T,
      S, H, scale);
  return (int)cudaGetLastError();
}
