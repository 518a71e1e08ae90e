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

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int D = 64;         // head dim
constexpr int BM = 64;        // (timestep, head) rows per sweep step
constexpr int BN = 64;        // keys per block
constexpr int WARPS = BM / 16;
constexpr int THREADS = WARPS * 32;
constexpr int LDS = D + 8;    // padded shared-memory row, in bf16 (BN == D, so one pitch serves every tile)
constexpr int TILE = BM * LDS;  // elements of one staged tile (BN == BM)
constexpr int SMEM_BYTES = 6 * TILE * 2;  // k, v; qs, do, p, ds
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

static_assert(BN == 64 && BM == 64 && D == 64, "fragment loops assume 64 x 64 x 64 tiles");

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const __nv_bfloat16* p) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const __nv_bfloat16* p) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// 16-byte global -> shared copy; zero-fills the destination when !valid
__device__ __forceinline__ void cp_async16(__nv_bfloat16* dst, const __nv_bfloat16* src, bool valid) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  const int n = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(addr), "l"(src), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_group 0;\n" ::); }

// A fragment (rows row0..row0+15, columns kk*16..kk*16+15) of a row-major
// tile in one ldmatrix: the four 8x8 matrices are (rows 0-7 | 8-15) x
// (columns 0-7 | 8-15), in the order of the fragment's registers
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const __nv_bfloat16* tile, int row0, int kk, int lane) {
  ldmatrix_x4(a, tile + (row0 + (lane & 15)) * LDS + kk * 16 + (lane >> 4) * 8);
}

// B fragments of two adjacent 8-key tiles (keys key0..key0+15) at depth
// kk*16..kk*16+15, from a [key][d] row-major tile: registers 0,1 serve the
// first key tile, 2,3 the second
__device__ __forceinline__ void load_b(uint32_t (&b)[4], const __nv_bfloat16* tile, int key0, int kk, int lane) {
  ldmatrix_x4(b, tile + (key0 + (lane & 7) + (lane >> 4) * 8) * LDS + kk * 16 + ((lane >> 3) & 1) * 8);
}

// delta[r] = sum_d do[r][d] * o[r][d] in fp32: eight threads a row, 16 bytes each
__global__ void flash_bwd_delta_kernel(const __nv_bfloat16* __restrict__ dout, const __nv_bfloat16* __restrict__ o,
                                       float* __restrict__ delta, size_t n_rows) {
  const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  const size_t row = idx / (D / 8);
  float acc = 0.f;
  if (row < n_rows) {
    const uint4 a = *reinterpret_cast<const uint4*>(dout + idx * 8);
    const uint4 b = *reinterpret_cast<const uint4*>(o + idx * 8);
    const __nv_bfloat162* pa = reinterpret_cast<const __nv_bfloat162*>(&a);
    const __nv_bfloat162* pb = reinterpret_cast<const __nv_bfloat162*>(&b);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 x = __bfloat1622float2(pa[j]);
      const float2 y = __bfloat1622float2(pb[j]);
      acc += x.x * y.x + x.y * y.y;
    }
  }
  // the eight threads of a row are neighbours in one warp (blockDim.x is a multiple of 32)
  acc += __shfl_xor_sync(0xffffffffu, acc, 1);
  acc += __shfl_xor_sync(0xffffffffu, acc, 2);
  acc += __shfl_xor_sync(0xffffffffu, acc, 4);
  if (row < n_rows && (idx & 7) == 0) delta[row] = acc;
}

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

  for (int c = tid; c < BN * (D / 8); c += THREADS) {
    const int r = c / (D / 8);
    const int col = (c % (D / 8)) * 8;
    const int s = s0 + r;
    const bool ok = s < S;
    const size_t off = (size_t)(ok ? s : 0) * D + col;
    cp_async16(Ks + r * LDS + col, kb + off, ok);
    cp_async16(Vs + r * LDS + col, vb + off, ok);
  }
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
    for (int c = tid; c < BM * (D / 8); c += THREADS) {
      const int r = c / (D / 8);
      const int col = (c % (D / 8)) * 8;
      const bool ok = r0 + r < rows;
      cp_async16(Os + r * LDS + col, dob + (size_t)(ok ? r0 + r : 0) * D + col, ok);
    }
    cp_async_commit();
    // this thread's two fragment rows and their statistics; a row past the
    // end gets lse = +inf, so its p and ds are zero
    const int row_a = r0 + wr + g;
    const int row_b = row_a + 8;
    const float lse_r[2] = {row_a < rows ? lseb[row_a] : INFINITY, row_b < rows ? lseb[row_b] : INFINITY};
    const float delta_r[2] = {row_a < rows ? deltab[row_a] : 0.f, row_b < rows ? deltab[row_b] : 0.f};
    for (int c = tid; c < BM * (D / 16); c += THREADS) {
      const int r = c / (D / 16);
      const int col = (c % (D / 16)) * 8;  // 8 columns of the low half, and their partners
      const int row = r0 + r;
      float lo[8], hi[8];
      if (row < rows) {
        const uint4 ql = *reinterpret_cast<const uint4*>(qb + (size_t)row * D + col);
        const uint4 qh = *reinterpret_cast<const uint4*>(qb + (size_t)row * D + col + D / 2);
        const __nv_bfloat16* xl = reinterpret_cast<const __nv_bfloat16*>(&ql);
        const __nv_bfloat16* xh = reinterpret_cast<const __nv_bfloat16*>(&qh);
        // the tables' rows are 256 bytes and col is a multiple of 8: 16-byte loads
        const float4* cr = reinterpret_cast<const float4*>(cos_t + (size_t)(row / H) * D + col);
        const float4* sr = reinterpret_cast<const float4*>(sin_t + (size_t)(row / H) * D + col);
        const float4 c4[4] = {cr[0], cr[1], cr[D / 8], cr[D / 8 + 1]};  // low half, then its partners
        const float4 s4[4] = {sr[0], sr[1], sr[D / 8], sr[D / 8 + 1]};
        const float* cl = reinterpret_cast<const float*>(c4);
        const float* sl = reinterpret_cast<const float*>(s4);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float a = __bfloat162float(xl[j]);
          const float h = __bfloat162float(xh[j]);
          lo[j] = (a * cl[j] - h * sl[j]) * qscale;
          hi[j] = (h * cl[8 + j] + a * sl[8 + j]) * qscale;
        }
      } else {
#pragma unroll
        for (int j = 0; j < 8; ++j) lo[j] = hi[j] = 0.f;
      }
      uint4 pl, ph;
      pl.x = pack_bf16(lo[0], lo[1]); pl.y = pack_bf16(lo[2], lo[3]);
      pl.z = pack_bf16(lo[4], lo[5]); pl.w = pack_bf16(lo[6], lo[7]);
      ph.x = pack_bf16(hi[0], hi[1]); ph.y = pack_bf16(hi[2], hi[3]);
      ph.z = pack_bf16(hi[4], hi[5]); ph.w = pack_bf16(hi[6], hi[7]);
      *reinterpret_cast<uint4*>(Qs + r * LDS + col) = pl;
      *reinterpret_cast<uint4*>(Qs + r * LDS + col + D / 2) = ph;
    }
    cp_async_wait_all();  // do of this tile; on the first tile k and v too
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
  const size_t n_rows = (size_t)B * T * H;
  const size_t delta_threads = n_rows * (D / 8);
  flash_bwd_delta_kernel<<<(unsigned)((delta_threads + 255) / 256), 256, 0, st>>>(
      static_cast<const __nv_bfloat16*>(dout), static_cast<const __nv_bfloat16*>(o), static_cast<float*>(delta), n_rows);
  err = cudaGetLastError();
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
