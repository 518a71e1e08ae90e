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
// backward kernel (flash_bwd.cu) recomputes the probabilities from. Serving
// passes null and pays nothing for it.
//
// Layout and work split:
//  * q and o are (B, T, H, D) contiguous. A block owns BM = 128 (timestep,
//    head) rows of one KV group: group row r is timestep r / G, head
//    kv * G + r % G. At MQA (Kv = 1) the group is every head and its rows are
//    the T*H contiguous rows of q (8 timesteps x 16 heads at H = 16: the head
//    fold), and that form is compiled apart (GROUPED = false), so its code is
//    the MQA kernel's; at full MHA (G = 1, DiT) a block is 128 consecutive
//    timesteps of one head. The grid's second axis runs over (batch, KV head):
//    that is what the card has in place of the TPU kernel's timestep fold.
//    Each of the block's 8 warps owns 16 rows.
//  * k and v are (B, S, Kv, D). A block walks the KV tiles of BN = 64 keys of
//    its KV head that intersect [t_lo - w/2, t_hi + w/2] inside its own loop
//    (blocks share no state), copying the next tile into the second
//    shared-memory stage with cp.async while the current one is used. Each
//    staged tile serves all the block's rows.
//  * q is rotated once (ROPE), on load, in fp32, with scale * log2(e) folded
//    in, and kept in registers as mma A fragments for the whole KV sweep.
//  * Both products are mma.sync m16n8k16 bf16 -> fp32. The S accumulator of
//    QK^T is re-packed in registers as the A operand of PV (FlashAttention-2);
//    V's B operand comes from ldmatrix.trans.
//  * Online softmax in fp32 registers, exp2 domain. Only tiles at the edge of
//    the window (or past the end of the sequence) are masked.
//
// Bound: compute (see ops/flash_attention.py). Shared memory rows are padded to
// 72 bf16 (144 bytes) so fragment loads and ldmatrix hit distinct banks. The
// launch bounds ask for two blocks per SM (55 KB of shared memory and at most
// 128 registers a thread each): one block's softmax overlaps the other's
// products, which is worth more than the few spilled bytes it costs.
//
// C ABI (loaded with ctypes): flash_fwd_bf16 returns cudaGetLastError(); lse
// may be null, and cos_t / sin_t are null together or not at all.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int D = 64;         // head dim
constexpr int BM = 128;       // (timestep, head) rows per block
constexpr int BN = 64;        // keys per KV tile
constexpr int WARPS = BM / 16;
constexpr int THREADS = WARPS * 32;
constexpr int LDS = D + 8;    // padded shared-memory row, in bf16
constexpr int SMEM_BYTES = (BM + 4 * BN) * LDS * 2;  // q + 2 stages of k and v
constexpr float LOG2E = 1.4426950408889634f;

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

// 16-byte global -> shared copy; zero-fills the destination when !valid
__device__ __forceinline__ void cp_async16(__nv_bfloat16* dst, const __nv_bfloat16* src, bool valid) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  const int n = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(addr), "l"(src), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

template <bool GROUPED, bool ROPE>
__global__ void __launch_bounds__(THREADS, 2)  // 128 registers a thread, so two blocks share an SM
flash_fwd_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v, const float* __restrict__ cos_t,
                 const float* __restrict__ sin_t, __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
                 int T, int S, int H, int Kv, int window, float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [BM][LDS]
  __nv_bfloat16* Ks = Qs + BM * LDS;                                // [2][BN][LDS]
  __nv_bfloat16* Vs = Ks + 2 * BN * LDS;                            // [2][BN][LDS]

  const int b = GROUPED ? blockIdx.y / Kv : blockIdx.y;
  const int kv = GROUPED ? blockIdx.y % Kv : 0;
  const int G = GROUPED ? H / Kv : H;  // heads of the group: its rows are T*G
  const int rows = T * G;
  const int kvs = GROUPED ? Kv : 1;  // KV heads of a key row
  const int ld = kvs * D;            // elements from one key to the next
  const int r0 = blockIdx.x * BM;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane >> 2;   // mma group: fragment row (and row + 8)
  const int tg = lane & 3;   // thread in group: fragment column pair
  // (timestep, head) row of q, o and lse that group row r is
  auto mem = [&](int r) { return GROUPED ? (r / G) * H + r % G : r; };

  const __nv_bfloat16* qb = q + ((size_t)b * T * H + kv * G) * D;
  const __nv_bfloat16* kb = k + ((size_t)b * S * kvs + kv) * D;
  const __nv_bfloat16* vb = v + ((size_t)b * S * kvs + kv) * D;
  __nv_bfloat16* ob = o + ((size_t)b * T * H + kv * G) * D;

  const bool local = window >= 0;
  const int w2 = window / 2;
  const int t_lo = r0 / G;
  const int t_hi = (min(r0 + BM, rows) - 1) / G;
  const int kv_lo = local ? max(0, t_lo - w2) : 0;
  const int kv_hi = local ? min(S, t_hi + w2 + 1) : S;
  const int n_tiles = (kv_hi - kv_lo + BN - 1) / BN;

  auto load_kv = [&](int stage, int s0) {
    for (int c = tid; c < BN * (D / 8); c += THREADS) {
      const int r = c / (D / 8);
      const int col = (c % (D / 8)) * 8;
      const int s = s0 + r;
      const bool ok = s < S;
      const size_t off = (size_t)(ok ? s : 0) * ld + col;
      cp_async16(Ks + (stage * BN + r) * LDS + col, kb + off, ok);
      cp_async16(Vs + (stage * BN + r) * LDS + col, vb + off, ok);
    }
    cp_async_commit();
  };

  load_kv(0, kv_lo);

  // rotate the block's q rows once: out[d] = q[d] cos[d] - q[d+32] sin[d],
  // out[d+32] = q[d+32] cos[d+32] + q[d] sin[d+32]; times scale * log2(e)
  const float qscale = scale * LOG2E;
  for (int c = tid; c < BM * (D / 16); c += THREADS) {
    const int r = c / (D / 16);
    const int col = (c % (D / 16)) * 8;  // 8 columns of the low half, and their partners
    const int row = r0 + r;
    float lo[8], hi[8];
    if (row < rows) {
      const __nv_bfloat16* qr = qb + (size_t)mem(row) * D;
      const uint4 ql = *reinterpret_cast<const uint4*>(qr + col);
      const uint4 qh = *reinterpret_cast<const uint4*>(qr + col + D / 2);
      const __nv_bfloat16* xl = reinterpret_cast<const __nv_bfloat16*>(&ql);
      const __nv_bfloat16* xh = reinterpret_cast<const __nv_bfloat16*>(&qh);
      if (ROPE) {
        const float* cr = cos_t + (size_t)(row / G) * D;
        const float* sr = sin_t + (size_t)(row / G) * D;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float a = __bfloat162float(xl[j]);
          const float h = __bfloat162float(xh[j]);
          lo[j] = (a * cr[col + j] - h * sr[col + j]) * qscale;
          hi[j] = (h * cr[col + D / 2 + j] + a * sr[col + D / 2 + j]) * qscale;
        }
      } else {
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          lo[j] = __bfloat162float(xl[j]) * qscale;
          hi[j] = __bfloat162float(xh[j]) * qscale;
        }
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
  __syncthreads();

  const int wr = warp * 16;
  uint32_t qa[D / 16][4];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const __nv_bfloat16* p0 = Qs + (wr + g) * LDS + kk * 16 + 2 * tg;
    const __nv_bfloat16* p1 = p0 + 8 * LDS;
    qa[kk][0] = *reinterpret_cast<const uint32_t*>(p0);
    qa[kk][1] = *reinterpret_cast<const uint32_t*>(p1);
    qa[kk][2] = *reinterpret_cast<const uint32_t*>(p0 + 8);
    qa[kk][3] = *reinterpret_cast<const uint32_t*>(p1 + 8);
  }
  // timesteps of this thread's two fragment rows
  const int tq[2] = {(r0 + wr + g) / G, (r0 + wr + g + 8) / G};

  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.f, 0.f};
  float acc[D / 8][4];
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt) acc[dt][0] = acc[dt][1] = acc[dt][2] = acc[dt][3] = 0.f;

  for (int it = 0; it < n_tiles; ++it) {
    const int s0 = kv_lo + it * BN;
    if (it + 1 < n_tiles) {
      load_kv((it + 1) & 1, s0 + BN);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const __nv_bfloat16* Kt = Ks + (it & 1) * BN * LDS;
    const __nv_bfloat16* Vt = Vs + (it & 1) * BN * LDS;

    // S = Q K^T for this warp's 16 rows x BN keys (log2-domain logits)
    float s[BN / 8][4];
#pragma unroll
    for (int nt = 0; nt < BN / 8; ++nt) s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
      for (int nt = 0; nt < BN / 8; ++nt) {
        const __nv_bfloat16* kp = Kt + (nt * 8 + g) * LDS + kk * 16 + 2 * tg;
        mma_bf16(s[nt], qa[kk], *reinterpret_cast<const uint32_t*>(kp),
                 *reinterpret_cast<const uint32_t*>(kp + 8));
      }
    }

    const bool interior =
        s0 + BN <= S && (!local || (s0 >= t_hi - w2 && s0 + BN - 1 <= t_lo + w2));
    if (!interior) {
#pragma unroll
      for (int nt = 0; nt < BN / 8; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = s0 + nt * 8 + 2 * tg + (e & 1);
          const int t = tq[e >> 1];
          const bool ok = key < S && (!local || abs(t - key) <= w2);
          if (!ok) s[nt][e] = -INFINITY;
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

    // O += P V: the S accumulators of two adjacent key tiles are the A
    // fragment of one 16-key step
    const int mi = lane >> 3;
    const int mr = lane & 7;
#pragma unroll
    for (int kt = 0; kt < BN / 16; ++kt) {
      const uint32_t pa[4] = {pack_bf16(s[2 * kt][0], s[2 * kt][1]), pack_bf16(s[2 * kt][2], s[2 * kt][3]),
                              pack_bf16(s[2 * kt + 1][0], s[2 * kt + 1][1]),
                              pack_bf16(s[2 * kt + 1][2], s[2 * kt + 1][3])};
#pragma unroll
      for (int dp = 0; dp < D / 16; ++dp) {
        uint32_t vf[4];
        ldmatrix_x4_trans(vf, Vt + (kt * 16 + mr + (mi & 1) * 8) * LDS + dp * 16 + (mi >> 1) * 8);
        mma_bf16(acc[2 * dp], pa, vf[0], vf[1]);
        mma_bf16(acc[2 * dp + 1], pa, vf[2], vf[3]);
      }
    }
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
  const size_t mem_a = mem(row_a), mem_b = mem(row_b);
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt) {
    const int col = dt * 8 + 2 * tg;
    if (row_a < rows)
      *reinterpret_cast<uint32_t*>(ob + mem_a * D + col) = pack_bf16(acc[dt][0] * inv[0], acc[dt][1] * inv[0]);
    if (row_b < rows)
      *reinterpret_cast<uint32_t*>(ob + mem_b * D + col) = pack_bf16(acc[dt][2] * inv[1], acc[dt][3] * inv[1]);
  }
  if (lse != nullptr && tg == 0) {  // the 4 threads of a group hold the same row statistics
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
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((T * (H / Kv) + BM - 1) / BM, B * Kv);
  kernel<<<grid, THREADS, SMEM_BYTES, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const float*>(cos_t), static_cast<const float*>(sin_t),
      static_cast<__nv_bfloat16*>(o), static_cast<float*>(lse), T, S, H, Kv, window, scale);
  return (int)cudaGetLastError();
}
