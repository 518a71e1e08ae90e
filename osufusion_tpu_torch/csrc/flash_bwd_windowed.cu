// Windowed MQA flash-attention backward with fused q-RoPE, for Hopper
// (sm_90a): the split pair, both kernels in this one source.
//
// Replaces osufusion_tpu/ops/pallas_attention.py::_dq_kernel and ::_dkv_kernel
// (both launched by _flash_bwd), the backward of a sliding-window site: key s
// is attended by query t iff |t - s| <= window / 2 (integer half, the
// forward's rule; window < 0: every key).
//
// Inputs as in flash_bwd.cu: raw q (B, T, H, D) bf16, pre-rotated k and v
// (B, S, D) bf16, do (and, for delta, o) (B, T, H, D) bf16, lse2 (B, T*H) fp32
// (the base-2 log-sum-exp that flash_fwd.cu wrote), the cos/sin tables (T, D)
// fp32. Both kernels hold q as qs = q_rot * scale * log2(e) in bf16, staged by
// the code flash_bwd.cu uses, so p = exp2(qs k_rot^T - lse2) is the forward's
// probability; a masked key gets p = 0 outright. With ds = p (do v^T - delta):
//   dq_rot = scale * ds k_rot      un-rotated in registers, bf16 out
//   dv     = p^T do                fp32 out
//   dk_rot = ln(2) * ds^T qs       fp32 out, still in the rotated frame
//
// Work split (the card's own; the TPU pair exists because its grid has no
// atomics and a sequential innermost axis):
//  * flash_bwd_dq_kernel: one block per 128 flattened (timestep, head) rows,
//    as the forward lays them out: 8 warps of 16 rows. qs and do are staged
//    once and kept in registers as mma A fragments. The block walks the KV
//    tiles of 64 keys that intersect [t_lo - w/2, t_hi + w/2], the next tile
//    copied by cp.async while the current one is used, and masks only the
//    tiles at the window's edge. s and dp are mma.sync m16n8k16 bf16 -> fp32;
//    the ds accumulators, re-packed in registers, are the A operand of
//    dq += ds k. No atomics and no zeroed buffer: each dq row is written once,
//    so dq is the same to the last bit from run to run. About 170 registers a
//    thread and 72 KB of shared memory: one block of 256 threads per SM.
//  * flash_bwd_dkv_kernel: one block per (batch element, 64-key tile), as in
//    flash_bwd.cu: dk and dv of the tile for all heads stay in registers while
//    the block sweeps the query rows of timesteps [s0 - w/2, s0 + 63 + w/2]
//    clipped to the sequence, 64 rows a step; p and ds go through shared memory
//    in bf16 so that the transposed products read them with ldmatrix.trans.
//    The first and last tiles of a sequence sweep about half the rows of an
//    inner one. 4 warps, 54 KB of shared memory, two blocks per SM.
//  * The pair recomputes s and dp in both kernels (7 products of T*W*H*D
//    against the fused sweep's 5): that is what the split is.
//
// Bound: compute, as the forward (each q row meets ~W keys for a few hundred
// bytes of traffic).
//
// C ABI (loaded with ctypes): flash_bwd_dq_bf16 fills delta = rowsum(do * o)
// (scratch, (B, T*H) fp32) with the small kernel of flash_bwd_common.cuh and
// then runs the dq kernel; flash_bwd_dkv_bf16 reads that delta. Each returns
// cudaGetLastError().

#include "flash_bwd_common.cuh"

namespace {

constexpr int DQ_BM = 128;  // (timestep, head) rows per dq block
constexpr int DQ_THREADS = DQ_BM / 16 * 32;
constexpr int DQ_SMEM_BYTES = (2 * DQ_BM + 4 * BN) * LDS * 2;  // qs, do; 2 stages of k and v

constexpr int KV_BM = 64;  // (timestep, head) rows per dkv sweep step
constexpr int KV_THREADS = KV_BM / 16 * 32;
constexpr int KV_TILE = KV_BM * LDS;
constexpr int KV_SMEM_BYTES = 6 * KV_TILE * 2;  // k, v; qs, do, p, ds

static_assert(KV_BM == BN, "one tile size serves k, v, qs, do, p and ds");

__global__ void __launch_bounds__(DQ_THREADS, 1)
flash_bwd_dq_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                    const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
                    const float* __restrict__ lse, const float* __restrict__ delta,
                    const float* __restrict__ cos_t, const float* __restrict__ sin_t,
                    __nv_bfloat16* __restrict__ dq, int T, int S, int H, int window, float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [DQ_BM][LDS] rotated, scaled q
  __nv_bfloat16* Os = Qs + DQ_BM * LDS;                             // [DQ_BM][LDS] do
  __nv_bfloat16* Ks = Os + DQ_BM * LDS;                             // [2][BN][LDS]
  __nv_bfloat16* Vs = Ks + 2 * BN * LDS;                            // [2][BN][LDS]

  const int b = blockIdx.y;
  const int rows = T * H;
  const int r0 = blockIdx.x * DQ_BM;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane >> 2;   // mma group: fragment row (and row + 8)
  const int tg = lane & 3;   // thread in group: fragment column pair
  const int mi = lane >> 3;  // ldmatrix: which of the four 8x8 matrices this lane addresses
  const int mr = lane & 7;   // ldmatrix: row of that matrix
  const int wr = warp * 16;  // this warp's rows of the block

  const __nv_bfloat16* qb = q + (size_t)b * rows * D;
  const __nv_bfloat16* dob = dout + (size_t)b * rows * D;
  const __nv_bfloat16* kb = k + (size_t)b * S * D;
  const __nv_bfloat16* vb = v + (size_t)b * S * D;

  // the keys this block's timesteps can see
  const bool local = window >= 0;
  const int w2 = window / 2;
  const int t_lo = r0 / H;
  const int t_hi = (min(r0 + DQ_BM, rows) - 1) / H;
  const int kv_lo = local ? max(0, t_lo - w2) : 0;
  const int kv_hi = local ? min(S, t_hi + w2 + 1) : S;
  const int n_tiles = (kv_hi - kv_lo + BN - 1) / BN;

  copy_rows<DQ_BM, DQ_THREADS>(Os, dob, r0, rows, tid);
  copy_kv_tile<DQ_THREADS>(Ks, Vs, kb, vb, kv_lo, S, tid);
  cp_async_commit();
  stage_qs<DQ_BM, DQ_THREADS>(Qs, qb, cos_t, sin_t, r0, rows, H, scale * LOG2E, tid);
  cp_async_wait<0>();
  __syncthreads();

  // qs and do of this warp's 16 rows stay in registers for the whole sweep
  uint32_t qa[D / 16][4], da[D / 16][4];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    load_a(qa[kk], Qs, wr, kk, lane);
    load_a(da[kk], Os, wr, kk, lane);
  }
  // this thread's two fragment rows, their timesteps and statistics; a row
  // past the end gets lse = +inf, so its p and ds are zero
  const int row_a = r0 + wr + g;
  const int row_b = row_a + 8;
  const int tq[2] = {row_a / H, row_b / H};
  const float* lseb = lse + (size_t)b * rows;
  const float* deltab = delta + (size_t)b * rows;
  const float lse_r[2] = {row_a < rows ? lseb[row_a] : INFINITY, row_b < rows ? lseb[row_b] : INFINITY};
  const float delta_r[2] = {row_a < rows ? deltab[row_a] : 0.f, row_b < rows ? deltab[row_b] : 0.f};

  float dq_acc[D / 8][4];
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt) dq_acc[dt][0] = dq_acc[dt][1] = dq_acc[dt][2] = dq_acc[dt][3] = 0.f;

  for (int it = 0; it < n_tiles; ++it) {
    const int s0 = kv_lo + it * BN;
    if (it + 1 < n_tiles) {
      const int stage = (it + 1) & 1;
      copy_kv_tile<DQ_THREADS>(Ks + stage * BN * LDS, Vs + stage * BN * LDS, kb, vb, s0 + BN, S, tid);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const __nv_bfloat16* Kt = Ks + (it & 1) * BN * LDS;
    const __nv_bfloat16* Vt = Vs + (it & 1) * BN * LDS;

    // s = qs k^T and dp = do v^T for this warp's 16 rows x BN keys
    float s[BN / 8][4], dp[BN / 8][4];
#pragma unroll
    for (int nt = 0; nt < BN / 8; ++nt) {
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
      dp[nt][0] = dp[nt][1] = dp[nt][2] = dp[nt][3] = 0.f;
    }
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
      for (int np = 0; np < BN / 16; ++np) {
        uint32_t kf[4], vf[4];
        load_b(kf, Kt, np * 16, kk, lane);
        load_b(vf, Vt, np * 16, kk, lane);
        mma_bf16(s[2 * np], qa[kk], kf[0], kf[1]);
        mma_bf16(s[2 * np + 1], qa[kk], kf[2], kf[3]);
        mma_bf16(dp[2 * np], da[kk], vf[0], vf[1]);
        mma_bf16(dp[2 * np + 1], da[kk], vf[2], vf[3]);
      }
    }

    // ds = p (dp - delta), p = exp2(s - lse2); only a tile at the window's
    // edge or past the end of the sequence is masked
    const bool interior = s0 + BN <= S && (!local || (s0 >= t_hi - w2 && s0 + BN - 1 <= t_lo + w2));
#pragma unroll
    for (int nt = 0; nt < BN / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float p = exp2f(s[nt][e] - lse_r[e >> 1]);
        if (!interior) {
          const int key = s0 + nt * 8 + 2 * tg + (e & 1);
          if (key >= S || (local && abs(tq[e >> 1] - key) > w2)) p = 0.f;
        }
        dp[nt][e] = p * (dp[nt][e] - delta_r[e >> 1]);
      }
    }

    // dq_rot += ds k: the ds accumulators of two adjacent key tiles are the A
    // fragment of one 16-key step
#pragma unroll
    for (int kt = 0; kt < BN / 16; ++kt) {
      const uint32_t ga[4] = {pack_bf16(dp[2 * kt][0], dp[2 * kt][1]), pack_bf16(dp[2 * kt][2], dp[2 * kt][3]),
                              pack_bf16(dp[2 * kt + 1][0], dp[2 * kt + 1][1]),
                              pack_bf16(dp[2 * kt + 1][2], dp[2 * kt + 1][3])};
#pragma unroll
      for (int dd = 0; dd < D / 16; ++dd) {
        uint32_t kf[4];
        ldmatrix_x4_trans(kf, Kt + (kt * 16 + mr + (mi & 1) * 8) * LDS + dd * 16 + (mi >> 1) * 8);
        mma_bf16(dq_acc[2 * dd], ga, kf[0], kf[1]);
        mma_bf16(dq_acc[2 * dd + 1], ga, kf[2], kf[3]);
      }
    }
    __syncthreads();  // the stage just read is the next iteration's copy target
  }

  // un-rotate into the raw q's frame (g cos - rot_half(g sin); columns d and
  // d + 32 sit in the same thread), apply scale, one bf16 store
  __nv_bfloat16* dqb = dq + (size_t)b * rows * D;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = i == 0 ? row_a : row_b;
    if (row < rows) {
      const float* cr = cos_t + (size_t)tq[i] * D;
      const float* sr = sin_t + (size_t)tq[i] * D;
      __nv_bfloat16* dst = dqb + (size_t)row * D;
#pragma unroll
      for (int dt = 0; dt < D / 16; ++dt) {
        const int col = dt * 8 + 2 * tg;
        const float2 c_lo = *reinterpret_cast<const float2*>(cr + col);
        const float2 c_hi = *reinterpret_cast<const float2*>(cr + col + D / 2);
        const float2 s_lo = *reinterpret_cast<const float2*>(sr + col);
        const float2 s_hi = *reinterpret_cast<const float2*>(sr + col + D / 2);
        const float g_lo0 = dq_acc[dt][2 * i], g_lo1 = dq_acc[dt][2 * i + 1];
        const float g_hi0 = dq_acc[dt + D / 16][2 * i], g_hi1 = dq_acc[dt + D / 16][2 * i + 1];
        *reinterpret_cast<uint32_t*>(dst + col) =
            pack_bf16((g_lo0 * c_lo.x + g_hi0 * s_hi.x) * scale, (g_lo1 * c_lo.y + g_hi1 * s_hi.y) * scale);
        *reinterpret_cast<uint32_t*>(dst + col + D / 2) =
            pack_bf16((g_hi0 * c_hi.x - g_lo0 * s_lo.x) * scale, (g_hi1 * c_hi.y - g_lo1 * s_lo.y) * scale);
      }
    }
  }
}

__global__ void __launch_bounds__(KV_THREADS, 2)
flash_bwd_dkv_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
                     const float* __restrict__ lse, const float* __restrict__ delta,
                     const float* __restrict__ cos_t, const float* __restrict__ sin_t, float* __restrict__ dk,
                     float* __restrict__ dv, int T, int S, int H, int window, float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Ks = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [BN][LDS]
  __nv_bfloat16* Vs = Ks + BN * LDS;                                // [BN][LDS]
  __nv_bfloat16* Qs = Vs + KV_TILE;                                 // [KV_BM][LDS] rotated, scaled q
  __nv_bfloat16* Os = Qs + KV_TILE;                                 // [KV_BM][LDS] do
  __nv_bfloat16* Ps = Os + KV_TILE;                                 // [KV_BM][LDS] p, rows x keys
  __nv_bfloat16* Gs = Ps + KV_TILE;                                 // [KV_BM][LDS] ds, rows x keys

  const int b = blockIdx.y;
  const int s0 = blockIdx.x * BN;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane >> 2;   // mma group: fragment row (and row + 8)
  const int tg = lane & 3;   // thread in group: fragment column pair
  const int mi = lane >> 3;  // ldmatrix: which of the four 8x8 matrices this lane addresses
  const int mr = lane & 7;   // ldmatrix: row of that matrix
  const int wr = warp * 16;  // this warp's rows of a query tile, and its keys of dk/dv

  const size_t all_rows = (size_t)T * H;
  const __nv_bfloat16* qb = q + (size_t)b * all_rows * D;
  const __nv_bfloat16* dob = dout + (size_t)b * all_rows * D;
  const __nv_bfloat16* kb = k + (size_t)b * S * D;
  const __nv_bfloat16* vb = v + (size_t)b * S * D;
  const float* lseb = lse + (size_t)b * all_rows;
  const float* deltab = delta + (size_t)b * all_rows;

  // the query rows whose window reaches this tile's keys s0 .. s_last
  const bool local = window >= 0;
  const int w2 = window / 2;
  const int s_last = min(S, s0 + BN) - 1;
  const int row_lo = local ? max(0, s0 - w2) * H : 0;
  const int row_hi = (local ? min(T, s_last + w2 + 1) : T) * H;
  const int n_tiles = (row_hi - row_lo + KV_BM - 1) / KV_BM;

  copy_kv_tile<KV_THREADS>(Ks, Vs, kb, vb, s0, S, tid);
  cp_async_commit();
  const bool kv_tail = s0 + BN > S;

  float dv_acc[D / 8][4], dk_acc[D / 8][4];
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt) {
    dv_acc[dt][0] = dv_acc[dt][1] = dv_acc[dt][2] = dv_acc[dt][3] = 0.f;
    dk_acc[dt][0] = dk_acc[dt][1] = dk_acc[dt][2] = dk_acc[dt][3] = 0.f;
  }

  const float qscale = scale * LOG2E;

  for (int it = 0; it < n_tiles; ++it) {
    const int r0 = row_lo + it * KV_BM;

    // stage do (copied as is) and qs (rotated in fp32, as the forward does)
    copy_rows<KV_BM, KV_THREADS>(Os, dob, r0, row_hi, tid);
    cp_async_commit();
    // this thread's two fragment rows and their statistics; a row past the
    // sweep's end gets lse = +inf, so its p and ds are zero
    const int row_a = r0 + wr + g;
    const int row_b = row_a + 8;
    const float lse_r[2] = {row_a < row_hi ? lseb[row_a] : INFINITY, row_b < row_hi ? lseb[row_b] : INFINITY};
    const float delta_r[2] = {row_a < row_hi ? deltab[row_a] : 0.f, row_b < row_hi ? deltab[row_b] : 0.f};
    stage_qs<KV_BM, KV_THREADS>(Qs, qb, cos_t, sin_t, r0, row_hi, H, qscale, tid);
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

    // p = exp2(s - lse2), ds = p (dp - delta); both to shared memory in bf16.
    // Only a step whose timesteps touch the window's edge is masked.
    const int t_a = r0 / H;
    const int t_b = (min(r0 + KV_BM, row_hi) - 1) / H;
    const bool interior = !kv_tail && (!local || (s_last - t_a <= w2 && t_b - s0 <= w2));
    const int tq[2] = {row_a / H, row_b / H};
#pragma unroll
    for (int nt = 0; nt < BN / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float p = exp2f(s[nt][e] - lse_r[e >> 1]);
        if (!interior) {
          const int key = s0 + nt * 8 + 2 * tg + (e & 1);
          if (key >= S || (local && abs(tq[e >> 1] - key) > w2)) p = 0.f;
        }
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
    __syncthreads();  // p and ds of every warp are in shared memory

    // dv += p^T do and dk += ds^T qs for this warp's 16 keys, over the step's rows
#pragma unroll
    for (int ks = 0; ks < KV_BM / 16; ++ks) {
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

// delta is scratch that this entry point fills before the dq kernel reads it.
extern "C" int flash_bwd_dq_bf16(const void* q, const void* k, const void* v, const void* dout, const void* o,
                                 const void* lse, void* delta, const void* cos_t, const void* sin_t, void* dq, int B,
                                 int T, int S, int H, int window, float scale, void* stream) {
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_dq_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, DQ_SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  err = launch_delta(dout, o, delta, (size_t)B * T * H, st);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((T * H + DQ_BM - 1) / DQ_BM, B);
  flash_bwd_dq_kernel<<<grid, DQ_THREADS, DQ_SMEM_BYTES, st>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const __nv_bfloat16*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta), static_cast<const float*>(cos_t),
      static_cast<const float*>(sin_t), static_cast<__nv_bfloat16*>(dq), T, S, H, window, scale);
  return (int)cudaGetLastError();
}

extern "C" int flash_bwd_dkv_bf16(const void* q, const void* k, const void* v, const void* dout, const void* lse,
                                  const void* delta, const void* cos_t, const void* sin_t, void* dk, void* dv, int B,
                                  int T, int S, int H, int window, float scale, void* stream) {
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_dkv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, KV_SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((S + BN - 1) / BN, B);
  flash_bwd_dkv_kernel<<<grid, KV_THREADS, KV_SMEM_BYTES, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const __nv_bfloat16*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta), static_cast<const float*>(cos_t),
      static_cast<const float*>(sin_t), static_cast<float*>(dk), static_cast<float*>(dv), T, S, H, window, scale);
  return (int)cudaGetLastError();
}
