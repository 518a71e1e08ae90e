// Windowed MQA flash attention of one sequence shard against its
// halo-extended keys, for Hopper (sm_90a): the forward with its LSE (K4).
//
// Replaces osufusion_tpu/ops/pallas_attention.py::_halo_fwd_kernel (launched
// by _halo_flash_fwd), the attention of sequence-parallel training. Its
// backward, the halo dq and dk/dv (_halo_dq_kernel, _halo_dkv_kernel), is the
// windowed pair of flash_bwd_windowed.cu in the halo frame, behind the
// pre-pass of flash_bwd_prep.cuh: it recomputes this kernel's p from the LSE
// written here, with qs staged to the same bits (rope_qs.cuh without tables
// rounds q * qscale to bf16 as stage_scaled below does).
//
// The halo frame: a rank holds T local query rows (global frames g0 ..
// g0 + T - 1) and a slab of S = T + W keys whose row s is global frame
// g0 - W/2 + s. Local query t sees slab row s iff t <= s <= t + W (the
// single-device window |t - s'| <= W/2 with s' = s - W/2; W is even) and
// lo <= s < hi, lo = max(0, W/2 - g0), hi = min(S, t_global - g0 + W/2):
// inside the song. g0 and t_global are runtime arguments, so one build serves
// every rank and level.
//
// Inputs: q (B, T, H, D) bf16 already rotated, k (rotated) and v (B, S, D)
// bf16. The kernel holds q as qs = q * scale * log2(e) rounded to bf16; with
// p = exp2(qs k^T - lse2) it writes o = p v in bf16 and lse2 (B, T*H) fp32,
// the base-2 log-sum-exp, t-major.
//
// Work split, as the single-device forward (flash_fwd.cu) in the halo frame,
// with mma.sync and cp.async (flash_bwd_common.cuh): one block
// per 128 flattened (timestep, head) rows, 8 warps of 16; qs in registers as
// mma A fragments; the block walks the 64-key tiles of [max(lo, t_lo), min(hi,
// t_hi + W + 1)), the next tile copied by cp.async while the current one is
// used, an fp32 online softmax in the exp2 domain, P re-packed in registers as
// the A operand of P V. The visit range is clipped to the song, so no tile is
// entirely outside it; a row that has no key yet in a tile keeps a zero base,
// so no -inf - -inf is ever taken. Only tiles at the window's edge or at the
// song's ends are masked; an interior tile tests neither leg.
//
// Bound: compute (each q row meets up to W + 1 keys for a few hundred bytes of
// traffic); the design spends its effort on the math, as flash_fwd.cu does.
//
// C ABI (loaded with ctypes): halo_fwd_bf16 returns cudaGetLastError().

#include "flash_bwd_common.cuh"

namespace {

constexpr int BM = 128;  // (timestep, head) rows per block
constexpr int ROW_THREADS = BM / 16 * 32;
constexpr int FWD_SMEM_BYTES = (BM + 4 * BN) * LDS * 2;  // qs; 2 stages of k and v

// The halo frame of one launch
struct Frame {
  int T, S, H, window, lo, hi;  // lo <= slab row < hi: inside the song
};

inline Frame make_frame(int T, int H, int window, int g0, int t_global) {
  const int S = T + window;
  const int lo = window / 2 - g0;
  const int hi = t_global - g0 + window / 2;
  return {T, S, H, window, lo > 0 ? lo : 0, hi < S ? hi : S};
}

// Stage ROWS rows of q, from row r0 on, as qs = q * qscale rounded to bf16;
// rows at or past row_end are zeros
template <int ROWS, int NTHREADS>
__device__ __forceinline__ void stage_scaled(__nv_bfloat16* Qs, const __nv_bfloat16* qb, int r0, int row_end,
                                             float qscale, int tid) {
  for (int c = tid; c < ROWS * (D / 8); c += NTHREADS) {
    const int r = c / (D / 8);
    const int col = (c % (D / 8)) * 8;
    const int row = r0 + r;
    uint4 out = make_uint4(0u, 0u, 0u, 0u);
    if (row < row_end) {
      const uint4 x = *reinterpret_cast<const uint4*>(qb + (size_t)row * D + col);
      const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&x);
      float2 f[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) f[j] = __bfloat1622float2(p[j]);
      out.x = pack_bf16(f[0].x * qscale, f[0].y * qscale);
      out.y = pack_bf16(f[1].x * qscale, f[1].y * qscale);
      out.z = pack_bf16(f[2].x * qscale, f[2].y * qscale);
      out.w = pack_bf16(f[3].x * qscale, f[3].y * qscale);
    }
    *reinterpret_cast<uint4*>(Qs + r * LDS + col) = out;
  }
}

// s = qs k^T for one warp's 16 rows x BN keys
__device__ __forceinline__ void tile_logits(float (&s)[BN / 8][4], const uint32_t (&qa)[D / 16][4],
                                            const __nv_bfloat16* Kt, int lane) {
#pragma unroll
  for (int nt = 0; nt < BN / 8; ++nt) s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
    for (int np = 0; np < BN / 16; ++np) {
      uint32_t kf[4];
      load_b(kf, Kt, np * 16, kk, lane);
      mma_bf16(s[2 * np], qa[kk], kf[0], kf[1]);
      mma_bf16(s[2 * np + 1], qa[kk], kf[2], kf[3]);
    }
  }
}

// acc (16 rows x D) += A (16 rows x BN keys, as s accumulators) * X (BN keys x
// D, row-major in shared memory): the accumulators of two adjacent key tiles
// are the A fragment of one 16-key step
__device__ __forceinline__ void rows_times_tile(float (&acc)[D / 8][4], const float (&a)[BN / 8][4],
                                                const __nv_bfloat16* Xt, int lane) {
  const int mi = lane >> 3;
  const int mr = lane & 7;
#pragma unroll
  for (int kt = 0; kt < BN / 16; ++kt) {
    const uint32_t pa[4] = {pack_bf16(a[2 * kt][0], a[2 * kt][1]), pack_bf16(a[2 * kt][2], a[2 * kt][3]),
                            pack_bf16(a[2 * kt + 1][0], a[2 * kt + 1][1]),
                            pack_bf16(a[2 * kt + 1][2], a[2 * kt + 1][3])};
#pragma unroll
    for (int dd = 0; dd < D / 16; ++dd) {
      uint32_t xf[4];
      ldmatrix_x4_trans(xf, Xt + (kt * 16 + mr + (mi & 1) * 8) * LDS + dd * 16 + (mi >> 1) * 8);
      mma_bf16(acc[2 * dd], pa, xf[0], xf[1]);
      mma_bf16(acc[2 * dd + 1], pa, xf[2], xf[3]);
    }
  }
}

// The slab tiles that a block of query rows [r0, r0 + BM) visits: from kv_lo,
// n_tiles of BN keys; t_lo and t_hi are its first and last timesteps
struct RowBlock {
  int t_lo, t_hi, kv_lo, n_tiles;
};

__device__ __forceinline__ RowBlock row_block(const Frame& f, int r0) {
  const int rows = f.T * f.H;
  RowBlock rb;
  rb.t_lo = r0 / f.H;
  rb.t_hi = (min(r0 + BM, rows) - 1) / f.H;
  rb.kv_lo = max(f.lo, rb.t_lo);
  const int kv_hi = min(f.hi, rb.t_hi + f.window + 1);
  rb.n_tiles = (kv_hi - rb.kv_lo + BN - 1) / BN;
  return rb;
}

// Is key in the window of timestep t and inside the song? (key >= lo holds for
// every tile a row block visits: they start at kv_lo >= lo)
__device__ __forceinline__ bool visible(const Frame& f, int t, int key) {
  return key < f.hi && key >= t && key <= t + f.window;
}

// Does the tile of keys [s0, s0 + BN) lie in the window of every timestep of
// [t_lo, t_hi] and inside the song?
__device__ __forceinline__ bool interior(const Frame& f, int s0, int t_lo, int t_hi) {
  return s0 >= f.lo && s0 + BN <= f.hi && s0 >= t_hi && s0 + BN - 1 <= t_lo + f.window;
}

__global__ void __launch_bounds__(ROW_THREADS, 2)
halo_fwd_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
                Frame f, float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [BM][LDS]
  __nv_bfloat16* Ks = Qs + BM * LDS;                                // [2][BN][LDS]
  __nv_bfloat16* Vs = Ks + 2 * BN * LDS;                            // [2][BN][LDS]

  const int b = blockIdx.y;
  const int rows = f.T * f.H;
  const int r0 = blockIdx.x * BM;
  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int g = lane >> 2;
  const int tg = lane & 3;
  const int wr = (tid / 32) * 16;

  const __nv_bfloat16* qb = q + (size_t)b * rows * D;
  const __nv_bfloat16* kb = k + (size_t)b * f.S * D;
  const __nv_bfloat16* vb = v + (size_t)b * f.S * D;
  const RowBlock rb = row_block(f, r0);

  // keys at or past hi arrive as zeros (and are masked)
  copy_kv_tile<ROW_THREADS>(Ks, Vs, kb, vb, rb.kv_lo, f.hi, tid);
  cp_async_commit();
  stage_scaled<BM, ROW_THREADS>(Qs, qb, r0, rows, scale * LOG2E, tid);
  __syncthreads();

  uint32_t qa[D / 16][4];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) load_a(qa[kk], Qs, wr, kk, lane);
  const int tq[2] = {(r0 + wr + g) / f.H, (r0 + wr + g + 8) / f.H};

  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.f, 0.f};
  float acc[D / 8][4];
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt) acc[dt][0] = acc[dt][1] = acc[dt][2] = acc[dt][3] = 0.f;

  for (int it = 0; it < rb.n_tiles; ++it) {
    const int s0 = rb.kv_lo + it * BN;
    if (it + 1 < rb.n_tiles) {
      const int stage = (it + 1) & 1;
      copy_kv_tile<ROW_THREADS>(Ks + stage * BN * LDS, Vs + stage * BN * LDS, kb, vb, s0 + BN, f.hi, tid);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const __nv_bfloat16* Kt = Ks + (it & 1) * BN * LDS;
    const __nv_bfloat16* Vt = Vs + (it & 1) * BN * LDS;

    float s[BN / 8][4];
    tile_logits(s, qa, Kt, lane);
    if (!interior(f, s0, rb.t_lo, rb.t_hi)) {
#pragma unroll
      for (int nt = 0; nt < BN / 8; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if (!visible(f, tq[e >> 1], s0 + nt * 8 + 2 * tg + (e & 1))) s[nt][e] = -INFINITY;
        }
      }
    }

    // online softmax; each row's stats are shared by the 4 threads of a group
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int nt = 0; nt < BN / 8; ++nt) {
      mx[0] = fmaxf(mx[0], fmaxf(s[nt][0], s[nt][1]));
      mx[1] = fmaxf(mx[1], fmaxf(s[nt][2], s[nt][3]));
    }
    float base[2], corr[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      base[i] = mx[i] == -INFINITY ? 0.f : mx[i];  // a row with no key yet stays at zero
      corr[i] = exp2f(m[i] - base[i]);
      m[i] = mx[i];
    }
    float rs[2] = {0.f, 0.f};
#pragma unroll
    for (int nt = 0; nt < BN / 8; ++nt) {
      s[nt][0] = exp2f(s[nt][0] - base[0]);
      s[nt][1] = exp2f(s[nt][1] - base[0]);
      s[nt][2] = exp2f(s[nt][2] - base[1]);
      s[nt][3] = exp2f(s[nt][3] - base[1]);
      rs[0] += s[nt][0] + s[nt][1];
      rs[1] += s[nt][2] + s[nt][3];
    }
    l[0] = l[0] * corr[0] + rs[0];  // per-thread partial sums, reduced at the end
    l[1] = l[1] * corr[1] + rs[1];
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt) {
      acc[dt][0] *= corr[0];
      acc[dt][1] *= corr[0];
      acc[dt][2] *= corr[1];
      acc[dt][3] *= corr[1];
    }
    rows_times_tile(acc, s, Vt, lane);
    __syncthreads();  // the stage just read is the next iteration's copy target
  }

  float inv[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    inv[i] = 1.f / l[i];
  }
  const int row_a = r0 + wr + g;
  const int row_b = row_a + 8;
  __nv_bfloat16* ob = o + (size_t)b * rows * D;
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt) {
    const int col = dt * 8 + 2 * tg;
    if (row_a < rows)
      *reinterpret_cast<uint32_t*>(ob + (size_t)row_a * D + col) = pack_bf16(acc[dt][0] * inv[0], acc[dt][1] * inv[0]);
    if (row_b < rows)
      *reinterpret_cast<uint32_t*>(ob + (size_t)row_b * D + col) = pack_bf16(acc[dt][2] * inv[1], acc[dt][3] * inv[1]);
  }
  if (tg == 0) {  // the 4 threads of a group hold the same row statistics
    float* lb = lse + (size_t)b * rows;
    if (row_a < rows) lb[row_a] = m[0] + log2f(l[0]);
    if (row_b < rows) lb[row_b] = m[1] + log2f(l[1]);
  }
}

}  // namespace

extern "C" int halo_fwd_bf16(const void* q, const void* k, const void* v, void* o, void* lse, int B, int T, int H,
                             int window, int g0, int t_global, float scale, void* stream) {
  cudaError_t err = cudaFuncSetAttribute(halo_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, FWD_SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((T * H + BM - 1) / BM, B);
  halo_fwd_kernel<<<grid, ROW_THREADS, FWD_SMEM_BYTES, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), static_cast<float*>(lse),
      make_frame(T, H, window, g0, t_global), scale);
  return (int)cudaGetLastError();
}
