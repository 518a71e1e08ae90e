// Flash attention in fp32 arithmetic on the FMA units, for Hopper (sm_90a):
// the "forms" family, which serves every attention form that the wgmma
// kernels (flash_fwd.cu, flash_bwd.cu, flash_bwd_windowed.cu) do not, from one
// body per kernel templated on the operand type T (float, __nv_bfloat16,
// __half) and the head dim D (64, 128, 192, 256), and one chunked instance of
// the forward, dq and dk/dv bodies for any D > 256 that is a multiple of 64
// (below). ops/flash_forms.py::kernel_form sends here fp32 and fp16 operands
// at every head dim, bf16 operands at D > 256, and at bf16 with D = 128, 192
// or 256 the windowed dq / dk-dv pair and the ring's merge; bf16 forwards and
// global backwards at D <= 256 run the wgmma kernels, and the bf16 forward
// instances here at those head dims are on no path.
//
// Replaces, at those forms, osufusion_tpu/ops/pallas_attention.py::
//  * _fwd_kernel (:208, launched by _flash_fwd), _halo_fwd_kernel (:938,
//    launched by _halo_flash_fwd) and one hop of _ring_fwd (:1310):
//    forms_fwd_kernel, windowed or global, MQA / GQA / full MHA (query head h
//    reads KV head h / (H / Kv)), optional fused q-RoPE, o in T and the base-2
//    LSE in fp32, in the single-device or the halo frame (key_frame.cuh);
//  * _dq_kernel (:435), _halo_dq_kernel (:1054) and the dq part of
//    _bwd_fused_kernel (:575): forms_dq_kernel;
//  * _dkv_kernel (:507), _halo_dkv_kernel (:1099) and the dk/dv part of
//    _bwd_fused_kernel: forms_dkv_kernel, which sums the G query heads of a
//    KV head.
// Global sites take the split pair too: the same function as the fused
// sweep, without atomics. Beside them are the T- and D-generic instances of
// the three helpers of the wgmma family: the pre-pass of flash_bwd_prep.cuh
// (qs in T, do in group-major order, the padded LSE and delta), the dq
// post-pass of flash_bwd.cu (un-rotate, scale, cast to T) and the ring merge
// of ring_merge.cu (o_j in T). Those files keep their vectorised bf16, D = 64
// forms unchanged.
//
// The arithmetic is the Pallas bodies': logits in the exp2 domain, qs =
// rope(q) * D^-0.5 * log2(e) rounded to T (rotated as rope_qs.cuh does, each
// product rounded alone, so that the forward and the pre-pass hold the same
// bits), products accumulated in fp32, P rounded to T before P V
// (`p.astype(v.dtype)`, :284), P before dV and dS before dQ and dK likewise
// (:492, :564, :641-644). At T = float every rounding is the identity, and
// the kernels differ from their plain fp32 versions by summation order only.
//   forward: o = softmax2(qs k^T) v,  lse2 = log2 sum exp2(qs k^T)
//   dq_acc  (+)= ds k                 ds = p (do v^T - delta), p = exp2(qs k^T - lse2)
//   dk      (+)= ln(2) ds^T qs,  dv (+)= p^T do
// dq_acc is fp32 in group-major order; the post-pass scales it by D^-0.5 and
// un-rotates it. The accumulate flags let the ring add over its hops.
//
// Why the FMA units, and what bounds the kernels. A full fp32 product has no
// tensor-core path: wgmma takes TF32, which keeps about three decimal digits
// where a float32 matmul in PyTorch, and the JAX bodies' fp32 dots, keep
// full fp32 (and TF32 wgmma would want V K-major for P V). So every product
// here is an fp32 FFMA, 4 D FLOP per visited (query, key) pair forward and 8 D
// backward (dq: 2 products, dkv: 3 with the logits again), against 67 TFLOP/s
// of fp32 FMA on an H100 SXM: compute bound at every site, by far (a row meets
// up to W + 1 or S keys for a few hundred bytes of traffic). The bf16
// instances run the same FMA arithmetic, so they can reach at most 67 / 989
// (~7 %) of their tensor-core bound: a simple, exact design first, to be
// replaced by wgmma instances (ROADMAP queue 2).
//
// Design. A block of 256 threads (16 x 16) owns a tile of BQ = 64 group rows
// of one (batch, KV head) group (forward and dq; group row r: timestep r / G,
// head kv * G + r % G) or BK keys of it (dk/dv), and sweeps the tiles of the
// other side that its rows or keys see (keys_seen of key_frame.cuh). Tiles
// are staged in shared memory as fp32, rows padded to D + 4 floats, so that
// the 16-byte loads of eight neighbouring threads hit eight different bank
// groups. A thread computes a 4 x (BK / 16) block of the logits (rows ty + 16 i,
// keys tx + 16 j) with 16-byte shared loads along D, keeps its rows' share of
// the output (columns 4 tx + 64 j .. + 3) in registers, and reads P or dS back
// from shared memory for the second product. The online softmax keeps each
// row's max and sum in the 16 threads of its row (shuffles inside a half
// warp), in the exp2 domain; a row that has seen no key yet keeps a zero base.
// BK = 64 keys at D <= 128, 32 above, so that every instance's tiles fit one
// SM's 227 KB of shared memory. Loads are plain 16-byte loads from device
// memory; nothing is asynchronous.
//
// fp16 operands run the bf16 arithmetic with fp16 roundings: operands widened
// to fp32 on load, products accumulated in fp32, P and dS rounded to fp16, as
// the Pallas bodies compute at fp16.
//
// C ABI (loaded with ctypes): every entry point takes the operand type code
// (0 float, 1 bfloat16, 2 float16) and D first and returns a cudaError_t,
// cudaErrorInvalidValue for an instance that does not exist.

#include <math.h>

#include <cuda_fp16.h>

#include "hopper.cuh"
#include "key_frame.cuh"

namespace {

constexpr int THREADS = 256;  // 16 x 16
constexpr int BQ = 64;        // group rows per tile
constexpr int RPT = BQ / 16;  // rows of a thread
constexpr int DTYPE_F32 = 0, DTYPE_BF16 = 1, DTYPE_F16 = 2;
constexpr int CH = 64;        // the chunk of the head dim that the chunked instance (D > 256) stages at a time
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

template <int D>
struct Tile {
  static constexpr int BK = D > 128 ? 32 : 64;  // keys per tile
  static constexpr int KPT = BK / 16;           // keys of a thread
  static constexpr int LD = D + 4;              // floats per staged row
  static constexpr int PLD = BK + 4;            // floats per row of P or dS
  static constexpr int CPT = D / 64;            // 4-column groups of a thread's output share
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f(__half x) { return __half2float(x); }
template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) { return __float2bfloat16_rn(x); }
template <>
__device__ __forceinline__ __half from_f<__half>(float x) { return __float2half_rn(x); }
// x rounded to T and back
template <typename T>
__device__ __forceinline__ float round_t(float x) { return to_f(from_f<T>(x)); }

// Stages `n` rows of D elements of T into shared memory as fp32 rows of LD
// floats: row i comes from row_ptr(i), or is zero where that is null. 16-byte
// loads, neighbouring threads on neighbouring chunks of a row.
template <typename T, int D, typename RowPtr>
__device__ __forceinline__ void stage_rows(float* dst, int n, RowPtr row_ptr) {
  constexpr int CH = 16 / sizeof(T);  // elements a chunk
  constexpr int PER_ROW = D / CH;
  for (int c = threadIdx.x; c < n * PER_ROW; c += THREADS) {
    const int i = c / PER_ROW, col = (c % PER_ROW) * CH;
    const T* src = row_ptr(i);
    float x[CH];
    if (src != nullptr) {
      const uint4 raw = *reinterpret_cast<const uint4*>(src + col);
      const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int u = 0; u < CH; ++u) x[u] = to_f(e[u]);
    } else {
#pragma unroll
      for (int u = 0; u < CH; ++u) x[u] = 0.f;
    }
    float4* d4 = reinterpret_cast<float4*>(dst + i * Tile<D>::LD + col);
#pragma unroll
    for (int u = 0; u < CH / 4; ++u) d4[u] = make_float4(x[4 * u], x[4 * u + 1], x[4 * u + 2], x[4 * u + 3]);
  }
}

// qs of one (d, d + D/2) pair of a row from the raw a = q[d], h = q[d + D/2]:
// rope_qs.cuh's arithmetic at any D (without tables only scaled), rounded to T
template <typename T, bool ROPE>
__device__ __forceinline__ void qs_pair(float a, float h, const float* cr, const float* sr, int d, int half,
                                        float qscale, float& lo, float& hi) {
  if (ROPE) {
    lo = __fmul_rn(__fsub_rn(__fmul_rn(a, cr[d]), __fmul_rn(h, sr[d])), qscale);
    hi = __fmul_rn(__fadd_rn(__fmul_rn(h, cr[d + half]), __fmul_rn(a, sr[d + half])), qscale);
  } else {
    lo = __fmul_rn(a, qscale);
    hi = __fmul_rn(h, qscale);
  }
  lo = round_t<T>(lo);
  hi = round_t<T>(hi);
}

// qs[d] of the raw row qr of `dim` columns: qs_pair's arithmetic for the one
// element d (low half: d and its partner d + dim / 2; high half: d and d -
// dim / 2), so that the chunked instance holds the bits of the others and of
// the pre-pass
template <typename T, bool ROPE>
__device__ __forceinline__ float qs_elem(const T* qr, const float* cr, const float* sr, int d, int dim,
                                         float qscale) {
  const int half = dim / 2;
  float lo, hi;
  if (d < half) {
    qs_pair<T, ROPE>(to_f(qr[d]), to_f(qr[d + half]), cr, sr, d, half, qscale, lo, hi);
    return lo;
  }
  qs_pair<T, ROPE>(to_f(qr[d - half]), to_f(qr[d]), cr, sr, d - half, half, qscale, lo, hi);
  return hi;
}

// The sum (SUM) or max over the 16 threads of a row (one half of a warp)
template <bool SUM>
__device__ __forceinline__ float row_reduce(float x) {
#pragma unroll
  for (int m = 1; m < 16; m <<= 1) {
    const float y = __shfl_xor_sync(0xffffffffu, x, m);
    x = SUM ? x + y : fmaxf(x, y);
  }
  return x;
}

// does group row r (timestep r / G) see key s in frame f?
__device__ __forceinline__ bool sees(const KeyFrame& f, bool local, int w2, int t, int s) {
  return s >= f.lo && s < f.hi && (!local || abs(t + f.off - s) <= w2);
}

// acc[i][x] (rows ty + 16 i of A) = sum over d of A[row][d] * B[key][d], for
// the thread's keys tx + 16 j: the logits-shaped product of two staged tiles
// (ZERO = false: added to what acc holds, one chunk of the head dim at a time)
template <int D, bool ZERO = true>
__device__ __forceinline__ void row_key_dots(const float* A, const float* Bt, int ty, int tx,
                                             float (&acc)[RPT][Tile<D>::KPT]) {
  constexpr int LD = Tile<D>::LD, KPT = Tile<D>::KPT;
  if (ZERO) {
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int j = 0; j < KPT; ++j) acc[i][j] = 0.f;
  }
#pragma unroll 2
  for (int d = 0; d < D; d += 4) {
    float4 a[RPT], b[KPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i) a[i] = *reinterpret_cast<const float4*>(A + (ty + 16 * i) * LD + d);
#pragma unroll
    for (int j = 0; j < KPT; ++j) b[j] = *reinterpret_cast<const float4*>(Bt + (tx + 16 * j) * LD + d);
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int j = 0; j < KPT; ++j)
        acc[i][j] += a[i].x * b[j].x + a[i].y * b[j].y + a[i].z * b[j].z + a[i].w * b[j].w;
  }
}

// out[i][c][u] (rows ty + 16 i, columns 4 tx + 64 c + u) += sum over the n
// keys s of P[row][s] * V[s][column]: the second product of the forward and
// of dq, P (rows x keys, PLD floats a row) and V (keys x D) staged
template <int D>
__device__ __forceinline__ void rows_times_tile(const float* P, const float* V, int n, int ty, int tx,
                                                float (&out)[RPT][Tile<D>::CPT][4]) {
  constexpr int LD = Tile<D>::LD, PLD = Tile<D>::PLD, CPT = Tile<D>::CPT;
#pragma unroll 1
  for (int s = 0; s < n; s += 4) {
    float4 p[RPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i) p[i] = *reinterpret_cast<const float4*>(P + (ty + 16 * i) * PLD + s);
#pragma unroll
    for (int u = 0; u < 4; ++u) {
#pragma unroll
      for (int c = 0; c < CPT; ++c) {
        const float4 v = *reinterpret_cast<const float4*>(V + (s + u) * LD + 4 * tx + 64 * c);
#pragma unroll
        for (int i = 0; i < RPT; ++i) {
          const float pi = u == 0 ? p[i].x : u == 1 ? p[i].y : u == 2 ? p[i].z : p[i].w;
          out[i][c][0] += pi * v.x;
          out[i][c][1] += pi * v.y;
          out[i][c][2] += pi * v.z;
          out[i][c][3] += pi * v.w;
        }
      }
    }
  }
}

// ---- forward ----

// grid (ceil(T*G / BQ), B * Kv). frame: {0, 0, S} on one device, halo_frame
// in the halo slab; q raw with tables (rotated here), else already rotated.
template <typename T, int D, bool ROPE>
__global__ void __launch_bounds__(THREADS, 1)
forms_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 const float* __restrict__ cos_t, const float* __restrict__ sin_t, T* __restrict__ o,
                 float* __restrict__ lse, int Tq, int S, int H, int Kv, int window, float qscale, KeyFrame frame) {
  using TL = Tile<D>;
  constexpr int BK = TL::BK, KPT = TL::KPT, LD = TL::LD, PLD = TL::PLD, CPT = TL::CPT;
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);  // [BQ][LD]
  float* Ks = Qs + BQ * LD;                     // [BK][LD]
  float* Vs = Ks + BK * LD;                     // [BK][LD]
  float* Ps = Vs + BK * LD;                     // [BQ][PLD]

  const int b = blockIdx.y / Kv, kv = blockIdx.y % Kv;
  const int G = H / Kv, rows = Tq * G;
  const int r0 = blockIdx.x * BQ;
  const bool local = window >= 0;
  const int w2 = window / 2;
  const KeySpan span = keys_seen(frame, local, w2, r0 / G, (min(r0 + BQ, rows) - 1) / G);
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  auto row_of = [&](int r) { return ((size_t)b * Tq + r / G) * H + kv * G + r % G; };  // the (b, t, h) row

  stage_rows<T, D>(Qs, BQ, [&](int i) { return r0 + i < rows ? q + row_of(r0 + i) * D : nullptr; });
  __syncthreads();
  constexpr int HALF = D / 2;
  for (int idx = threadIdx.x; idx < BQ * HALF; idx += THREADS) {
    const int i = idx / HALF, d = idx % HALF;
    if (r0 + i >= rows) continue;
    const size_t t = (size_t)((r0 + i) / G);
    float* row = Qs + i * LD;
    qs_pair<T, ROPE>(row[d], row[d + HALF], ROPE ? cos_t + t * D : nullptr, ROPE ? sin_t + t * D : nullptr, d,
                     HALF, qscale, row[d], row[d + HALF]);
  }

  float acc[RPT][CPT][4], m[RPT], l[RPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < CPT; ++c) acc[i][c][0] = acc[i][c][1] = acc[i][c][2] = acc[i][c][3] = 0.f;
  }
  auto key_ptr = [&](const T* base, int s) { return base + (((size_t)b * S + s) * Kv + kv) * D; };
  for (int s0 = span.lo; s0 < span.hi; s0 += BK) {
    __syncthreads();  // the previous tile's P V is done with Ks, Vs, Ps (and Qs is staged)
    stage_rows<T, D>(Ks, BK, [&](int j) { return s0 + j < span.hi ? key_ptr(k, s0 + j) : nullptr; });
    stage_rows<T, D>(Vs, BK, [&](int j) { return s0 + j < span.hi ? key_ptr(v, s0 + j) : nullptr; });
    __syncthreads();
    float s[RPT][KPT];
    row_key_dots<D>(Qs, Ks, ty, tx, s);
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int t = (r0 + ty + 16 * i) / G;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < KPT; ++j) {
        const int key = s0 + tx + 16 * j;
        if (key >= span.hi || !sees(frame, local, w2, t, key)) s[i][j] = -INFINITY;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], row_reduce<false>(mx));
      const float base = m_new == -INFINITY ? 0.f : m_new;
      const float corr = exp2f(m[i] - base);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < KPT; ++j) {
        const float p = exp2f(s[i][j] - base);
        sum += p;
        Ps[(ty + 16 * i) * PLD + tx + 16 * j] = round_t<T>(p);
      }
      l[i] = l[i] * corr + sum;  // this thread's share of the row sum
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < CPT; ++c)
#pragma unroll
        for (int u = 0; u < 4; ++u) acc[i][c][u] *= corr;
    }
    __syncthreads();
    rows_times_tile<D>(Ps, Vs, BK, ty, tx, acc);
  }

#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int r = r0 + ty + 16 * i;
    const float total = row_reduce<true>(l[i]);
    if (r >= rows) continue;
    const size_t row = row_of(r);
    const float inv = 1.f / total;
#pragma unroll
    for (int c = 0; c < CPT; ++c)
#pragma unroll
      for (int u = 0; u < 4; ++u) o[row * D + 4 * tx + 64 * c + u] = from_f<T>(acc[i][c][u] * inv);
    if (lse != nullptr && tx == 0) lse[row] = m[i] + log2f(total);
  }
}

// ---- backward ----

// The pre-pass, one warp a group row: qs (in T), do copied to group-major
// order where do_g is not null (Kv > 1), the LSE and delta = rowsum(do * o)
// padded to `pad` rows a group with +inf and 0. grid (pad / 8, B * Kv).
template <typename T, int D, bool ROPE>
__global__ void __launch_bounds__(THREADS, 1)
forms_prep_kernel(const T* __restrict__ q, const T* __restrict__ dout, const T* __restrict__ o,
                  const float* __restrict__ lse, const float* __restrict__ cos_t, const float* __restrict__ sin_t,
                  T* __restrict__ qs_g, T* __restrict__ do_g, float* __restrict__ lse_g, float* __restrict__ delta_g,
                  int Tq, int H, int Kv, int pad, float qscale, int dim) {
  const int Dd = D ? D : dim;  // D = 0: the chunked instance's head dim, at run time
  const int HALF = Dd / 2;
  const int lane = threadIdx.x % 32;
  const int r = blockIdx.x * (THREADS / 32) + threadIdx.x / 32;  // row of the group
  const size_t grp = blockIdx.y;
  const int G = H / Kv, rows = Tq * G;
  if (r >= pad) return;
  if (r >= rows) {
    if (lane == 0) {
      lse_g[grp * pad + r] = INFINITY;
      delta_g[grp * pad + r] = 0.f;
    }
    return;
  }
  const int b = grp / Kv, kv = grp % Kv, t = r / G;
  const size_t src = (((size_t)b * Tq + t) * H + kv * G + r % G) * Dd;
  const size_t dst = (grp * rows + r) * Dd;
  float part = 0.f;
  for (int d = lane; d < HALF; d += 32) {
    float lo, hi;
    qs_pair<T, ROPE>(to_f(q[src + d]), to_f(q[src + d + HALF]), ROPE ? cos_t + (size_t)t * Dd : nullptr,
                     ROPE ? sin_t + (size_t)t * Dd : nullptr, d, HALF, qscale, lo, hi);
    qs_g[dst + d] = from_f<T>(lo);
    qs_g[dst + d + HALF] = from_f<T>(hi);
    part += to_f(dout[src + d]) * to_f(o[src + d]) + to_f(dout[src + d + HALF]) * to_f(o[src + d + HALF]);
    if (do_g != nullptr) {
      do_g[dst + d] = dout[src + d];
      do_g[dst + d + HALF] = dout[src + d + HALF];
    }
  }
#pragma unroll
  for (int m = 16; m > 0; m >>= 1) part += __shfl_xor_sync(0xffffffffu, part, m);
  if (lane == 0) {
    lse_g[grp * pad + r] = lse[((size_t)b * Tq + t) * H + kv * G + r % G];
    delta_g[grp * pad + r] = part;
  }
}

// dq_acc (B * Kv, pad, D) fp32, group-major, (+)= ds k over the keys the
// block's rows see. grid (ceil(T*G / BQ), B * Kv).
template <typename T, int D>
__global__ void __launch_bounds__(THREADS, 1)
forms_dq_kernel(const T* __restrict__ k, const T* __restrict__ v, const T* __restrict__ qs_g,
                const T* __restrict__ do_rows, const float* __restrict__ lse_g, const float* __restrict__ delta_g,
                float* __restrict__ dq_acc, int Tq, int S, int H, int Kv, int pad, int window, KeyFrame frame,
                int accumulate) {
  using TL = Tile<D>;
  constexpr int BK = TL::BK, KPT = TL::KPT, LD = TL::LD, PLD = TL::PLD, CPT = TL::CPT;
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);  // [BQ][LD]
  float* Os = Qs + BQ * LD;                     // do, [BQ][LD]
  float* Ks = Os + BQ * LD;                     // [BK][LD]
  float* Vs = Ks + BK * LD;                     // [BK][LD]
  float* Ds = Vs + BK * LD;                     // dS, [BQ][PLD]

  const size_t grp = blockIdx.y;
  const int b = grp / Kv, kv = grp % Kv;
  const int G = H / Kv, rows = Tq * G;
  const int r0 = blockIdx.x * BQ;
  const bool local = window >= 0;
  const int w2 = window / 2;
  const KeySpan span = keys_seen(frame, local, w2, r0 / G, (min(r0 + BQ, rows) - 1) / G);
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;

  stage_rows<T, D>(Qs, BQ, [&](int i) { return r0 + i < rows ? qs_g + (grp * rows + r0 + i) * D : nullptr; });
  stage_rows<T, D>(Os, BQ, [&](int i) { return r0 + i < rows ? do_rows + (grp * rows + r0 + i) * D : nullptr; });
  float lse_r[RPT], delta_r[RPT], acc[RPT][CPT][4];
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    lse_r[i] = lse_g[grp * pad + r0 + ty + 16 * i];  // pad rows: +inf
    delta_r[i] = delta_g[grp * pad + r0 + ty + 16 * i];
#pragma unroll
    for (int c = 0; c < CPT; ++c) acc[i][c][0] = acc[i][c][1] = acc[i][c][2] = acc[i][c][3] = 0.f;
  }
  auto key_ptr = [&](const T* base, int s) { return base + (((size_t)b * S + s) * Kv + kv) * D; };
  for (int s0 = span.lo; s0 < span.hi; s0 += BK) {
    __syncthreads();
    stage_rows<T, D>(Ks, BK, [&](int j) { return s0 + j < span.hi ? key_ptr(k, s0 + j) : nullptr; });
    stage_rows<T, D>(Vs, BK, [&](int j) { return s0 + j < span.hi ? key_ptr(v, s0 + j) : nullptr; });
    __syncthreads();
    float s[RPT][KPT], dp[RPT][KPT];
    row_key_dots<D>(Qs, Ks, ty, tx, s);
    row_key_dots<D>(Os, Vs, ty, tx, dp);
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int t = (r0 + ty + 16 * i) / G;
#pragma unroll
      for (int j = 0; j < KPT; ++j) {
        const int key = s0 + tx + 16 * j;
        const float p = key < span.hi && sees(frame, local, w2, t, key) ? exp2f(s[i][j] - lse_r[i]) : 0.f;
        Ds[(ty + 16 * i) * PLD + tx + 16 * j] = round_t<T>(p * (dp[i][j] - delta_r[i]));
      }
    }
    __syncthreads();
    rows_times_tile<D>(Ds, Ks, BK, ty, tx, acc);
  }
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int r = r0 + ty + 16 * i;
    if (r >= rows) continue;
    float* dst = dq_acc + (grp * pad + r) * D + 4 * tx;
#pragma unroll
    for (int c = 0; c < CPT; ++c) {
      float4* d4 = reinterpret_cast<float4*>(dst + 64 * c);
      float4 x = make_float4(acc[i][c][0], acc[i][c][1], acc[i][c][2], acc[i][c][3]);
      if (accumulate) {
        const float4 old = *d4;
        x.x += old.x;
        x.y += old.y;
        x.z += old.z;
        x.w += old.w;
      }
      *d4 = x;
    }
  }
}

// dk, dv (B, S, Kv, D) fp32 (+)= ln(2) ds^T qs, p^T do over the group rows
// that see the block's BK keys; keys outside [frame.lo, frame.hi) get zeros.
// grid (ceil(S / BK), B * Kv).
template <typename T, int D>
__global__ void __launch_bounds__(THREADS, 1)
forms_dkv_kernel(const T* __restrict__ k, const T* __restrict__ v, const T* __restrict__ qs_g,
                 const T* __restrict__ do_rows, const float* __restrict__ lse_g, const float* __restrict__ delta_g,
                 float* __restrict__ dk, float* __restrict__ dv, int Tq, int S, int H, int Kv, int pad, int window,
                 KeyFrame frame, int accumulate) {
  using TL = Tile<D>;
  constexpr int BK = TL::BK, KPT = TL::KPT, LD = TL::LD, PLD = TL::PLD, CPT = TL::CPT;
  extern __shared__ float4 smem4[];
  float* Ks = reinterpret_cast<float*>(smem4);  // [BK][LD]
  float* Vs = Ks + BK * LD;                     // [BK][LD]
  float* Qs = Vs + BK * LD;                     // [BQ][LD]
  float* Os = Qs + BQ * LD;                     // do, [BQ][LD]
  float* Ps = Os + BQ * LD;                     // [BQ][PLD]
  float* Ds = Ps + BQ * PLD;                    // [BQ][PLD]
  float* Ls = Ds + BQ * PLD;                    // [BQ]
  float* Es = Ls + BQ;                          // delta, [BQ]

  const size_t grp = blockIdx.y;
  const int b = grp / Kv, kv = grp % Kv;
  const int G = H / Kv, rows = Tq * G;
  const int s0 = blockIdx.x * BK;
  const bool local = window >= 0;
  const int w2 = window / 2;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  // the keys of the block that exist, and the group rows that see them
  const int k_lo = max(s0, frame.lo), k_hi = min(s0 + BK, frame.hi);
  int row_lo = 0, row_hi = rows;
  if (local) {
    row_lo = max(0, k_lo - frame.off - w2) * G;
    row_hi = min(Tq, k_hi - 1 - frame.off + w2 + 1) * G;
  }
  if (k_hi <= k_lo) row_hi = row_lo;  // no key of the block exists: zeros

  auto key_ptr = [&](const T* base, int s) { return base + (((size_t)b * S + s) * Kv + kv) * D; };
  stage_rows<T, D>(Ks, BK, [&](int j) { return s0 + j >= k_lo && s0 + j < k_hi ? key_ptr(k, s0 + j) : nullptr; });
  stage_rows<T, D>(Vs, BK, [&](int j) { return s0 + j >= k_lo && s0 + j < k_hi ? key_ptr(v, s0 + j) : nullptr; });
  float dk_acc[KPT][CPT][4], dv_acc[KPT][CPT][4];
#pragma unroll
  for (int i = 0; i < KPT; ++i)
#pragma unroll
    for (int c = 0; c < CPT; ++c)
#pragma unroll
      for (int u = 0; u < 4; ++u) dk_acc[i][c][u] = dv_acc[i][c][u] = 0.f;

  for (int r0 = row_lo; r0 < row_hi; r0 += BQ) {
    __syncthreads();
    stage_rows<T, D>(Qs, BQ, [&](int i) { return r0 + i < row_hi ? qs_g + (grp * rows + r0 + i) * D : nullptr; });
    stage_rows<T, D>(Os, BQ, [&](int i) { return r0 + i < row_hi ? do_rows + (grp * rows + r0 + i) * D : nullptr; });
    for (int i = threadIdx.x; i < BQ; i += THREADS) {
      const bool in = r0 + i < row_hi;
      Ls[i] = in ? lse_g[grp * pad + r0 + i] : INFINITY;
      Es[i] = in ? delta_g[grp * pad + r0 + i] : 0.f;
    }
    __syncthreads();
    float s[RPT][KPT], dp[RPT][KPT];
    row_key_dots<D>(Qs, Ks, ty, tx, s);
    row_key_dots<D>(Os, Vs, ty, tx, dp);
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int ri = ty + 16 * i;
      const int t = (r0 + ri) / G;
#pragma unroll
      for (int j = 0; j < KPT; ++j) {
        const int key = s0 + tx + 16 * j;
        const float p = key < S && sees(frame, local, w2, t, key) ? exp2f(s[i][j] - Ls[ri]) : 0.f;
        Ps[ri * PLD + tx + 16 * j] = round_t<T>(p);
        Ds[ri * PLD + tx + 16 * j] = round_t<T>(p * (dp[i][j] - Es[ri]));
      }
    }
    __syncthreads();
    // dv[key] += sum_r P[r][key] do[r], dk[key] += sum_r dS[r][key] qs[r]: keys ty + 16 i
#pragma unroll 1
    for (int r = 0; r < BQ; ++r) {
      float pk[KPT], dk_r[KPT];
#pragma unroll
      for (int i = 0; i < KPT; ++i) {
        pk[i] = Ps[r * PLD + ty + 16 * i];
        dk_r[i] = Ds[r * PLD + ty + 16 * i];
      }
#pragma unroll
      for (int c = 0; c < CPT; ++c) {
        const float4 dov = *reinterpret_cast<const float4*>(Os + r * LD + 4 * tx + 64 * c);
        const float4 qv = *reinterpret_cast<const float4*>(Qs + r * LD + 4 * tx + 64 * c);
#pragma unroll
        for (int i = 0; i < KPT; ++i) {
          dv_acc[i][c][0] += pk[i] * dov.x;
          dv_acc[i][c][1] += pk[i] * dov.y;
          dv_acc[i][c][2] += pk[i] * dov.z;
          dv_acc[i][c][3] += pk[i] * dov.w;
          dk_acc[i][c][0] += dk_r[i] * qv.x;
          dk_acc[i][c][1] += dk_r[i] * qv.y;
          dk_acc[i][c][2] += dk_r[i] * qv.z;
          dk_acc[i][c][3] += dk_r[i] * qv.w;
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < KPT; ++i) {
    const int key = s0 + ty + 16 * i;
    if (key >= S) continue;
    const bool in = key >= frame.lo && key < frame.hi;  // a key outside the song gets exact zeros
    const size_t at = (((size_t)b * S + key) * Kv + kv) * D + 4 * tx;
#pragma unroll
    for (int c = 0; c < CPT; ++c) {
      float4* k4 = reinterpret_cast<float4*>(dk + at + 64 * c);
      float4* v4 = reinterpret_cast<float4*>(dv + at + 64 * c);
      float4 x = in ? make_float4(dk_acc[i][c][0] * LN2, dk_acc[i][c][1] * LN2, dk_acc[i][c][2] * LN2,
                                  dk_acc[i][c][3] * LN2)
                    : make_float4(0.f, 0.f, 0.f, 0.f);
      float4 y = in ? make_float4(dv_acc[i][c][0], dv_acc[i][c][1], dv_acc[i][c][2], dv_acc[i][c][3])
                    : make_float4(0.f, 0.f, 0.f, 0.f);
      if (accumulate) {
        const float4 xo = *k4, yo = *v4;
        x.x += xo.x; x.y += xo.y; x.z += xo.z; x.w += xo.w;
        y.x += yo.x; y.y += yo.y; y.z += yo.z; y.w += yo.w;
      }
      *k4 = x;
      *v4 = y;
    }
  }
}

// dq (B, T, H, D) in T = scale * the un-rotated dq_acc row (g cos -
// rot_half(g sin), flash_bwd.cu's post-pass at any D; without tables only
// scaled), one warp a (b, t, h) row. grid ceil(n_rows / 8).
template <typename T, int D, bool ROPE>
__global__ void __launch_bounds__(THREADS, 1)
forms_post_kernel(const float* __restrict__ dq_acc, const float* __restrict__ cos_t, const float* __restrict__ sin_t,
                  T* __restrict__ dq, size_t n_rows, int Tq, int H, int Kv, int pad, float scale, int dim) {
  const int Dd = D ? D : dim;
  const int HALF = Dd / 2;
  const size_t row = (size_t)blockIdx.x * (THREADS / 32) + threadIdx.x / 32;
  if (row >= n_rows) return;
  const int lane = threadIdx.x % 32;
  const int h = row % H;
  const size_t bt = row / H;
  const int t = bt % Tq;
  const size_t b = bt / Tq;
  const int G = H / Kv;
  const float* src = dq_acc + ((b * Kv + h / G) * pad + (size_t)t * G + h % G) * Dd;
  for (int d = lane; d < HALF; d += 32) {
    const float g_lo = src[d], g_hi = src[d + HALF];
    float lo = g_lo * scale, hi = g_hi * scale;
    if (ROPE) {
      const float* cr = cos_t + (size_t)t * Dd;
      const float* sr = sin_t + (size_t)t * Dd;
      lo = (g_lo * cr[d] + g_hi * sr[d + HALF]) * scale;
      hi = (g_hi * cr[d + HALF] - g_lo * sr[d]) * scale;
    }
    dq[row * Dd + d] = from_f<T>(lo);
    dq[row * Dd + d + HALF] = from_f<T>(hi);
  }
}

// The ring's exact merge (ring_merge.cu's arithmetic) of one hop's o_j (in T)
// and lse_j into the fp32 accumulators, one thread a (row, 4 columns)
template <typename T, int D>
__global__ void __launch_bounds__(THREADS, 1)
forms_merge_kernel(float* __restrict__ o_acc, const float* __restrict__ lse_acc, const T* __restrict__ o_j,
                   const float* __restrict__ lse_j, float* __restrict__ lse_out, T* __restrict__ o, size_t n_rows,
                   int dim) {
  const int Dd = D ? D : dim;
  const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  const size_t row = idx / (Dd / 4);
  if (row >= n_rows) return;
  const int col = (idx % (Dd / 4)) * 4;
  const float lj = lse_j[row];
  const float la = lse_acc != nullptr ? lse_acc[row] : -INFINITY;
  const float m = fmaxf(la, lj);
  const float lse = m + log2f(exp2f(la - m) + exp2f(lj - m));
  const float wa = exp2f(la - lse), wj = exp2f(lj - lse);
  if (col == 0) lse_out[row] = lse;
  float out[4];
#pragma unroll
  for (int u = 0; u < 4; ++u) out[u] = to_f(o_j[row * Dd + col + u]) * wj;
  float4* acc = reinterpret_cast<float4*>(o_acc + row * Dd + col);
  if (lse_acc != nullptr) {
    const float4 a = *acc;
    out[0] += a.x * wa;
    out[1] += a.y * wa;
    out[2] += a.z * wa;
    out[3] += a.w * wa;
  }
  if (o != nullptr) {
#pragma unroll
    for (int u = 0; u < 4; ++u) o[row * Dd + col + u] = from_f<T>(out[u]);
  } else {
    *acc = make_float4(out[0], out[1], out[2], out[3]);
  }
}

// ---- the chunked instance: any head dim above 256 that is a multiple of 64 ----
//
// The bodies above keep a row's whole head dim in shared memory, which at D >
// 256 would not fit. Here a block owns CH = 64 columns of the output (grid
// axis z: o, dq or dk/dv columns 64 z .. 64 z + 63), which are independent
// given P (o = P V) or given P and dS (dq = dS k, dv = P^T do, dk = dS^T qs),
// and recomputes the logits (and dP) over the whole head dim, staging it 64
// columns at a time in the tiles of the D = 64 instance: shared memory stays
// that instance's whatever D is. The arithmetic, and so every rounding, is
// the bodies' above; only the order of the sums over D changes. Speed is not
// the point: no configuration of either package reaches D > 256.

// grid (ceil(T*G / BQ), B * Kv, dim / CH)
template <typename T, bool ROPE>
__global__ void __launch_bounds__(THREADS, 1)
forms_fwd_chunked_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                         const float* __restrict__ cos_t, const float* __restrict__ sin_t, T* __restrict__ o,
                         float* __restrict__ lse, int Tq, int S, int H, int Kv, int window, float qscale,
                         KeyFrame frame, int dim) {
  using TL = Tile<CH>;
  constexpr int BK = TL::BK, KPT = TL::KPT, LD = TL::LD, PLD = TL::PLD;
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);  // [BQ][LD]
  float* Ks = Qs + BQ * LD;                     // [BK][LD]
  float* Vs = Ks + BK * LD;                     // [BK][LD]
  float* Ps = Vs + BK * LD;                     // [BQ][PLD]

  const int b = blockIdx.y / Kv, kv = blockIdx.y % Kv;
  const int G = H / Kv, rows = Tq * G;
  const int r0 = blockIdx.x * BQ;
  const int z = blockIdx.z, chunks = dim / CH;
  const bool local = window >= 0;
  const int w2 = window / 2;
  const KeySpan span = keys_seen(frame, local, w2, r0 / G, (min(r0 + BQ, rows) - 1) / G);
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  auto row_of = [&](int r) { return ((size_t)b * Tq + r / G) * H + kv * G + r % G; };  // the (b, t, h) row
  auto key_ptr = [&](const T* base, int s) { return base + (((size_t)b * S + s) * Kv + kv) * dim; };

  float acc[RPT][1][4], m[RPT], l[RPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
    acc[i][0][0] = acc[i][0][1] = acc[i][0][2] = acc[i][0][3] = 0.f;
  }
  for (int s0 = span.lo; s0 < span.hi; s0 += BK) {
    float s[RPT][KPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int j = 0; j < KPT; ++j) s[i][j] = 0.f;
    for (int c = 0; c < chunks; ++c) {
      __syncthreads();  // the last chunk's dots (and the last tile's P V) are done with Qs, Ks, Vs, Ps
      for (int idx = threadIdx.x; idx < BQ * CH; idx += THREADS) {
        const int i = idx / CH, d = c * CH + idx % CH;
        float x = 0.f;
        if (r0 + i < rows) {
          const size_t t = (size_t)((r0 + i) / G);
          x = qs_elem<T, ROPE>(q + row_of(r0 + i) * dim, ROPE ? cos_t + t * dim : nullptr,
                               ROPE ? sin_t + t * dim : nullptr, d, dim, qscale);
        }
        Qs[i * LD + idx % CH] = x;
      }
      stage_rows<T, CH>(Ks, BK, [&](int j) { return s0 + j < span.hi ? key_ptr(k, s0 + j) + c * CH : nullptr; });
      __syncthreads();
      row_key_dots<CH, false>(Qs, Ks, ty, tx, s);
    }
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int t = (r0 + ty + 16 * i) / G;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < KPT; ++j) {
        const int key = s0 + tx + 16 * j;
        if (key >= span.hi || !sees(frame, local, w2, t, key)) s[i][j] = -INFINITY;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], row_reduce<false>(mx));
      const float base = m_new == -INFINITY ? 0.f : m_new;
      const float corr = exp2f(m[i] - base);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < KPT; ++j) {
        const float p = exp2f(s[i][j] - base);
        sum += p;
        Ps[(ty + 16 * i) * PLD + tx + 16 * j] = round_t<T>(p);
      }
      l[i] = l[i] * corr + sum;
      m[i] = m_new;
#pragma unroll
      for (int u = 0; u < 4; ++u) acc[i][0][u] *= corr;
    }
    stage_rows<T, CH>(Vs, BK, [&](int j) { return s0 + j < span.hi ? key_ptr(v, s0 + j) + z * CH : nullptr; });
    __syncthreads();
    rows_times_tile<CH>(Ps, Vs, BK, ty, tx, acc);
  }

#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int r = r0 + ty + 16 * i;
    const float total = row_reduce<true>(l[i]);
    if (r >= rows) continue;
    const size_t row = row_of(r);
    const float inv = 1.f / total;
#pragma unroll
    for (int u = 0; u < 4; ++u) o[row * dim + z * CH + 4 * tx + u] = from_f<T>(acc[i][0][u] * inv);
    if (lse != nullptr && z == 0 && tx == 0) lse[row] = m[i] + log2f(total);
  }
}

// dq_acc columns 64 z .. 64 z + 63 (+)= ds k. grid (ceil(T*G / BQ), B * Kv, dim / CH).
template <typename T>
__global__ void __launch_bounds__(THREADS, 1)
forms_dq_chunked_kernel(const T* __restrict__ k, const T* __restrict__ v, const T* __restrict__ qs_g,
                        const T* __restrict__ do_rows, const float* __restrict__ lse_g,
                        const float* __restrict__ delta_g, float* __restrict__ dq_acc, int Tq, int S, int H, int Kv,
                        int pad, int window, KeyFrame frame, int accumulate, int dim) {
  using TL = Tile<CH>;
  constexpr int BK = TL::BK, KPT = TL::KPT, LD = TL::LD, PLD = TL::PLD;
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);  // [BQ][LD]
  float* Os = Qs + BQ * LD;                     // do, [BQ][LD]
  float* Ks = Os + BQ * LD;                     // [BK][LD]
  float* Vs = Ks + BK * LD;                     // [BK][LD]
  float* Ds = Vs + BK * LD;                     // dS, [BQ][PLD]

  const size_t grp = blockIdx.y;
  const int b = grp / Kv, kv = grp % Kv;
  const int G = H / Kv, rows = Tq * G;
  const int r0 = blockIdx.x * BQ;
  const int z = blockIdx.z, chunks = dim / CH;
  const bool local = window >= 0;
  const int w2 = window / 2;
  const KeySpan span = keys_seen(frame, local, w2, r0 / G, (min(r0 + BQ, rows) - 1) / G);
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  auto row_ptr = [&](const T* base, int i) { return r0 + i < rows ? base + (grp * rows + r0 + i) * dim : nullptr; };
  auto key_ptr = [&](const T* base, int s) { return base + (((size_t)b * S + s) * Kv + kv) * dim; };

  float lse_r[RPT], delta_r[RPT], acc[RPT][1][4];
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    lse_r[i] = lse_g[grp * pad + r0 + ty + 16 * i];  // pad rows: +inf
    delta_r[i] = delta_g[grp * pad + r0 + ty + 16 * i];
    acc[i][0][0] = acc[i][0][1] = acc[i][0][2] = acc[i][0][3] = 0.f;
  }
  for (int s0 = span.lo; s0 < span.hi; s0 += BK) {
    float s[RPT][KPT], dp[RPT][KPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int j = 0; j < KPT; ++j) s[i][j] = dp[i][j] = 0.f;
    for (int c = 0; c < chunks; ++c) {
      __syncthreads();
      stage_rows<T, CH>(Qs, BQ, [&](int i) { const T* r = row_ptr(qs_g, i); return r ? r + c * CH : r; });
      stage_rows<T, CH>(Os, BQ, [&](int i) { const T* r = row_ptr(do_rows, i); return r ? r + c * CH : r; });
      stage_rows<T, CH>(Ks, BK, [&](int j) { return s0 + j < span.hi ? key_ptr(k, s0 + j) + c * CH : nullptr; });
      stage_rows<T, CH>(Vs, BK, [&](int j) { return s0 + j < span.hi ? key_ptr(v, s0 + j) + c * CH : nullptr; });
      __syncthreads();
      row_key_dots<CH, false>(Qs, Ks, ty, tx, s);
      row_key_dots<CH, false>(Os, Vs, ty, tx, dp);
    }
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int t = (r0 + ty + 16 * i) / G;
#pragma unroll
      for (int j = 0; j < KPT; ++j) {
        const int key = s0 + tx + 16 * j;
        const float p = key < span.hi && sees(frame, local, w2, t, key) ? exp2f(s[i][j] - lse_r[i]) : 0.f;
        Ds[(ty + 16 * i) * PLD + tx + 16 * j] = round_t<T>(p * (dp[i][j] - delta_r[i]));
      }
    }
    __syncthreads();  // every thread is done with Ks before its chunk z arrives
    stage_rows<T, CH>(Ks, BK, [&](int j) { return s0 + j < span.hi ? key_ptr(k, s0 + j) + z * CH : nullptr; });
    __syncthreads();
    rows_times_tile<CH>(Ds, Ks, BK, ty, tx, acc);
  }
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int r = r0 + ty + 16 * i;
    if (r >= rows) continue;
    float4* d4 = reinterpret_cast<float4*>(dq_acc + (grp * pad + r) * dim + z * CH + 4 * tx);
    float4 x = make_float4(acc[i][0][0], acc[i][0][1], acc[i][0][2], acc[i][0][3]);
    if (accumulate) {
      const float4 old = *d4;
      x.x += old.x;
      x.y += old.y;
      x.z += old.z;
      x.w += old.w;
    }
    *d4 = x;
  }
}

// dk, dv columns 64 z .. 64 z + 63 (+)= ln(2) ds^T qs, p^T do over the group
// rows that see the block's BK keys; keys outside [frame.lo, frame.hi) get
// zeros. grid (ceil(S / BK), B * Kv, dim / CH).
template <typename T>
__global__ void __launch_bounds__(THREADS, 1)
forms_dkv_chunked_kernel(const T* __restrict__ k, const T* __restrict__ v, const T* __restrict__ qs_g,
                         const T* __restrict__ do_rows, const float* __restrict__ lse_g,
                         const float* __restrict__ delta_g, float* __restrict__ dk, float* __restrict__ dv, int Tq,
                         int S, int H, int Kv, int pad, int window, KeyFrame frame, int accumulate, int dim) {
  using TL = Tile<CH>;
  constexpr int BK = TL::BK, KPT = TL::KPT, LD = TL::LD, PLD = TL::PLD;
  extern __shared__ float4 smem4[];
  float* Ks = reinterpret_cast<float*>(smem4);  // [BK][LD]
  float* Vs = Ks + BK * LD;                     // [BK][LD]
  float* Qs = Vs + BK * LD;                     // [BQ][LD]
  float* Os = Qs + BQ * LD;                     // do, [BQ][LD]
  float* Ps = Os + BQ * LD;                     // [BQ][PLD]
  float* Ds = Ps + BQ * PLD;                    // [BQ][PLD]
  float* Ls = Ds + BQ * PLD;                    // [BQ]
  float* Es = Ls + BQ;                          // delta, [BQ]

  const size_t grp = blockIdx.y;
  const int b = grp / Kv, kv = grp % Kv;
  const int G = H / Kv, rows = Tq * G;
  const int s0 = blockIdx.x * BK;
  const int z = blockIdx.z, chunks = dim / CH;
  const bool local = window >= 0;
  const int w2 = window / 2;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  // the keys of the block that exist, and the group rows that see them
  const int k_lo = max(s0, frame.lo), k_hi = min(s0 + BK, frame.hi);
  int row_lo = 0, row_hi = rows;
  if (local) {
    row_lo = max(0, k_lo - frame.off - w2) * G;
    row_hi = min(Tq, k_hi - 1 - frame.off + w2 + 1) * G;
  }
  if (k_hi <= k_lo) row_hi = row_lo;  // no key of the block exists: zeros

  auto key_ptr = [&](const T* base, int j, int c) {
    return s0 + j >= k_lo && s0 + j < k_hi ? base + (((size_t)b * S + s0 + j) * Kv + kv) * dim + c * CH : nullptr;
  };
  float dk_acc[KPT][1][4], dv_acc[KPT][1][4];
#pragma unroll
  for (int i = 0; i < KPT; ++i)
#pragma unroll
    for (int u = 0; u < 4; ++u) dk_acc[i][0][u] = dv_acc[i][0][u] = 0.f;

  for (int r0 = row_lo; r0 < row_hi; r0 += BQ) {
    auto row_ptr = [&](const T* base, int i, int c) {
      return r0 + i < row_hi ? base + (grp * rows + r0 + i) * dim + c * CH : nullptr;
    };
    float s[RPT][KPT], dp[RPT][KPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int j = 0; j < KPT; ++j) s[i][j] = dp[i][j] = 0.f;
    for (int c = 0; c < chunks; ++c) {
      __syncthreads();
      stage_rows<T, CH>(Ks, BK, [&](int j) { return key_ptr(k, j, c); });
      stage_rows<T, CH>(Vs, BK, [&](int j) { return key_ptr(v, j, c); });
      stage_rows<T, CH>(Qs, BQ, [&](int i) { return row_ptr(qs_g, i, c); });
      stage_rows<T, CH>(Os, BQ, [&](int i) { return row_ptr(do_rows, i, c); });
      if (c == 0) {
        for (int i = threadIdx.x; i < BQ; i += THREADS) {
          const bool in = r0 + i < row_hi;
          Ls[i] = in ? lse_g[grp * pad + r0 + i] : INFINITY;
          Es[i] = in ? delta_g[grp * pad + r0 + i] : 0.f;
        }
      }
      __syncthreads();
      row_key_dots<CH, false>(Qs, Ks, ty, tx, s);
      row_key_dots<CH, false>(Os, Vs, ty, tx, dp);
    }
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int ri = ty + 16 * i;
      const int t = (r0 + ri) / G;
#pragma unroll
      for (int j = 0; j < KPT; ++j) {
        const int key = s0 + tx + 16 * j;
        const float p = key < S && sees(frame, local, w2, t, key) ? exp2f(s[i][j] - Ls[ri]) : 0.f;
        Ps[ri * PLD + tx + 16 * j] = round_t<T>(p);
        Ds[ri * PLD + tx + 16 * j] = round_t<T>(p * (dp[i][j] - Es[ri]));
      }
    }
    __syncthreads();  // every thread is done with Qs and Os before their chunk z arrives
    stage_rows<T, CH>(Qs, BQ, [&](int i) { return row_ptr(qs_g, i, z); });
    stage_rows<T, CH>(Os, BQ, [&](int i) { return row_ptr(do_rows, i, z); });
    __syncthreads();
    // dv[key] += sum_r P[r][key] do[r], dk[key] += sum_r dS[r][key] qs[r]: keys ty + 16 i
#pragma unroll 1
    for (int r = 0; r < BQ; ++r) {
      const float4 dov = *reinterpret_cast<const float4*>(Os + r * LD + 4 * tx);
      const float4 qv = *reinterpret_cast<const float4*>(Qs + r * LD + 4 * tx);
#pragma unroll
      for (int i = 0; i < KPT; ++i) {
        const float pk = Ps[r * PLD + ty + 16 * i], dk_r = Ds[r * PLD + ty + 16 * i];
        dv_acc[i][0][0] += pk * dov.x;
        dv_acc[i][0][1] += pk * dov.y;
        dv_acc[i][0][2] += pk * dov.z;
        dv_acc[i][0][3] += pk * dov.w;
        dk_acc[i][0][0] += dk_r * qv.x;
        dk_acc[i][0][1] += dk_r * qv.y;
        dk_acc[i][0][2] += dk_r * qv.z;
        dk_acc[i][0][3] += dk_r * qv.w;
      }
    }
  }

#pragma unroll
  for (int i = 0; i < KPT; ++i) {
    const int key = s0 + ty + 16 * i;
    if (key >= S) continue;
    const bool in = key >= frame.lo && key < frame.hi;  // a key outside the song gets exact zeros
    const size_t at = (((size_t)b * S + key) * Kv + kv) * dim + z * CH + 4 * tx;
    float4* k4 = reinterpret_cast<float4*>(dk + at);
    float4* v4 = reinterpret_cast<float4*>(dv + at);
    float4 x = in ? make_float4(dk_acc[i][0][0] * LN2, dk_acc[i][0][1] * LN2, dk_acc[i][0][2] * LN2,
                                dk_acc[i][0][3] * LN2)
                  : make_float4(0.f, 0.f, 0.f, 0.f);
    float4 y = in ? make_float4(dv_acc[i][0][0], dv_acc[i][0][1], dv_acc[i][0][2], dv_acc[i][0][3])
                  : make_float4(0.f, 0.f, 0.f, 0.f);
    if (accumulate) {
      const float4 xo = *k4, yo = *v4;
      x.x += xo.x; x.y += xo.y; x.z += xo.z; x.w += xo.w;
      y.x += yo.x; y.y += yo.y; y.z += yo.z; y.w += yo.w;
    }
    *k4 = x;
    *v4 = y;
  }
}

// ---- host ----

// the tiles' bytes of an instance; D = 0, the chunked instance, stages CH columns at a time
template <int D>
constexpr int fwd_smem() {
  using TL = Tile<D ? D : CH>;
  return ((BQ + 2 * TL::BK) * TL::LD + BQ * TL::PLD) * 4;
}
template <int D>
constexpr int dq_smem() {
  using TL = Tile<D ? D : CH>;
  return ((2 * BQ + 2 * TL::BK) * TL::LD + BQ * TL::PLD) * 4;
}
template <int D>
constexpr int dkv_smem() {
  using TL = Tile<D ? D : CH>;
  return ((2 * BQ + 2 * TL::BK) * TL::LD + 2 * BQ * TL::PLD + 2 * BQ) * 4;
}
static_assert(dkv_smem<256>() <= 232448 && dq_smem<256>() <= 232448 && dkv_smem<128>() <= 232448,
              "every instance's tiles fit one SM's shared memory");
static_assert(dkv_smem<0>() == dkv_smem<CH>() && dq_smem<0>() == dq_smem<CH>() && fwd_smem<0>() == fwd_smem<CH>(),
              "the chunked instance keeps the D = 64 instance's shared memory");

KeyFrame frame_of(int halo, int T, int S, int window, int g0, int t_global) {
  return halo ? halo_frame(T, window, g0, t_global) : KeyFrame{0, 0, S};
}

template <typename Kernel>
int launch_prologue(Kernel kernel, int smem, std::atomic<unsigned long long>& done) {
  int dev;
  int err = bind_device(&dev);
  if (err == 0) err = allow_smem(kernel, smem, dev, done);
  return err;
}

// Each launcher takes the run-time head dim `dim` beside its instance's D (D
// = 0: the chunked instance, whose grid gains the axis of dim / CH column
// chunks).
template <typename T, int D>
int launch_fwd(const void* q, const void* k, const void* v, const void* cos_t, const void* sin_t, void* o, void* lse,
               int B, int Tq, int S, int H, int Kv, int window, float scale, KeyFrame frame, int dim, void* stream) {
  static std::atomic<unsigned long long> smem_set[2];  // per instance: devices whose limit is raised
  const bool rope = cos_t != nullptr;
  const dim3 grid((Tq * (H / Kv) + BQ - 1) / BQ, B * Kv, D ? 1 : dim / CH);
  const float qscale = scale * LOG2E;
  if constexpr (D == 0) {
    auto kernel = rope ? forms_fwd_chunked_kernel<T, true> : forms_fwd_chunked_kernel<T, false>;
    const int err = launch_prologue(kernel, fwd_smem<D>(), smem_set[rope]);
    if (err != 0) return err;
    kernel<<<grid, THREADS, fwd_smem<D>(), static_cast<cudaStream_t>(stream)>>>(
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), static_cast<const float*>(cos_t),
        static_cast<const float*>(sin_t), static_cast<T*>(o), static_cast<float*>(lse), Tq, S, H, Kv, window, qscale,
        frame, dim);
  } else {
    auto kernel = rope ? forms_fwd_kernel<T, D, true> : forms_fwd_kernel<T, D, false>;
    const int err = launch_prologue(kernel, fwd_smem<D>(), smem_set[rope]);
    if (err != 0) return err;
    kernel<<<grid, THREADS, fwd_smem<D>(), static_cast<cudaStream_t>(stream)>>>(
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), static_cast<const float*>(cos_t),
        static_cast<const float*>(sin_t), static_cast<T*>(o), static_cast<float*>(lse), Tq, S, H, Kv, window, qscale,
        frame);
  }
  return (int)cudaGetLastError();
}

template <typename T, int D>
int launch_prep(const void* q, const void* dout, const void* o, const void* lse, const void* cos_t, const void* sin_t,
                void* qs_g, void* do_g, void* lse_g, void* delta_g, int B, int Tq, int H, int Kv, int pad, float scale,
                int dim, void* stream) {
  int dev;
  const int err = bind_device(&dev);
  if (err != 0) return err;
  auto kernel = cos_t != nullptr ? forms_prep_kernel<T, D, true> : forms_prep_kernel<T, D, false>;
  kernel<<<dim3((pad + THREADS / 32 - 1) / (THREADS / 32), B * Kv), THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(q), static_cast<const T*>(dout), static_cast<const T*>(o), static_cast<const float*>(lse),
      static_cast<const float*>(cos_t), static_cast<const float*>(sin_t), static_cast<T*>(qs_g), static_cast<T*>(do_g),
      static_cast<float*>(lse_g), static_cast<float*>(delta_g), Tq, H, Kv, pad, scale * LOG2E, dim);
  return (int)cudaGetLastError();
}

template <typename T, int D>
int launch_dq(const void* k, const void* v, const void* qs_g, const void* do_rows, const void* lse_g,
              const void* delta_g, void* dq_acc, int B, int Tq, int S, int H, int Kv, int pad, int window,
              KeyFrame frame, int accumulate, int dim, void* stream) {
  static std::atomic<unsigned long long> smem_set{0};
  const dim3 grid((Tq * (H / Kv) + BQ - 1) / BQ, B * Kv, D ? 1 : dim / CH);
  if constexpr (D == 0) {
    auto chunked = forms_dq_chunked_kernel<T>;
    const int err = launch_prologue(chunked, dq_smem<D>(), smem_set);
    if (err != 0) return err;
    chunked<<<grid, THREADS, dq_smem<D>(), static_cast<cudaStream_t>(stream)>>>(
        static_cast<const T*>(k), static_cast<const T*>(v), static_cast<const T*>(qs_g),
        static_cast<const T*>(do_rows), static_cast<const float*>(lse_g), static_cast<const float*>(delta_g),
        static_cast<float*>(dq_acc), Tq, S, H, Kv, pad, window, frame, accumulate, dim);
  } else {
    auto kernel = forms_dq_kernel<T, D>;
    const int err = launch_prologue(kernel, dq_smem<D>(), smem_set);
    if (err != 0) return err;
    kernel<<<grid, THREADS, dq_smem<D>(), static_cast<cudaStream_t>(stream)>>>(
        static_cast<const T*>(k), static_cast<const T*>(v), static_cast<const T*>(qs_g),
        static_cast<const T*>(do_rows), static_cast<const float*>(lse_g), static_cast<const float*>(delta_g),
        static_cast<float*>(dq_acc), Tq, S, H, Kv, pad, window, frame, accumulate);
  }
  return (int)cudaGetLastError();
}

template <typename T, int D>
int launch_dkv(const void* k, const void* v, const void* qs_g, const void* do_rows, const void* lse_g,
               const void* delta_g, void* dk, void* dv, int B, int Tq, int S, int H, int Kv, int pad, int window,
               KeyFrame frame, int accumulate, int dim, void* stream) {
  static std::atomic<unsigned long long> smem_set{0};
  constexpr int BK = Tile<D ? D : CH>::BK;
  const dim3 grid((S + BK - 1) / BK, B * Kv, D ? 1 : dim / CH);
  if constexpr (D == 0) {
    auto kernel = forms_dkv_chunked_kernel<T>;
    const int err = launch_prologue(kernel, dkv_smem<D>(), smem_set);
    if (err != 0) return err;
    kernel<<<grid, THREADS, dkv_smem<D>(), static_cast<cudaStream_t>(stream)>>>(
        static_cast<const T*>(k), static_cast<const T*>(v), static_cast<const T*>(qs_g),
        static_cast<const T*>(do_rows), static_cast<const float*>(lse_g), static_cast<const float*>(delta_g),
        static_cast<float*>(dk), static_cast<float*>(dv), Tq, S, H, Kv, pad, window, frame, accumulate, dim);
  } else {
    auto kernel = forms_dkv_kernel<T, D>;
    const int err = launch_prologue(kernel, dkv_smem<D>(), smem_set);
    if (err != 0) return err;
    kernel<<<grid, THREADS, dkv_smem<D>(), static_cast<cudaStream_t>(stream)>>>(
        static_cast<const T*>(k), static_cast<const T*>(v), static_cast<const T*>(qs_g),
        static_cast<const T*>(do_rows), static_cast<const float*>(lse_g), static_cast<const float*>(delta_g),
        static_cast<float*>(dk), static_cast<float*>(dv), Tq, S, H, Kv, pad, window, frame, accumulate);
  }
  return (int)cudaGetLastError();
}

template <typename T, int D>
int launch_post(const void* dq_acc, const void* cos_t, const void* sin_t, void* dq, int B, int Tq, int H, int Kv,
                int pad, float scale, int dim, void* stream) {
  int dev;
  const int err = bind_device(&dev);
  if (err != 0) return err;
  const size_t n_rows = (size_t)B * Tq * H;
  auto kernel = cos_t != nullptr ? forms_post_kernel<T, D, true> : forms_post_kernel<T, D, false>;
  kernel<<<(unsigned)((n_rows + THREADS / 32 - 1) / (THREADS / 32)), THREADS, 0,
           static_cast<cudaStream_t>(stream)>>>(static_cast<const float*>(dq_acc), static_cast<const float*>(cos_t),
                                                static_cast<const float*>(sin_t), static_cast<T*>(dq), n_rows, Tq, H,
                                                Kv, pad, scale, dim);
  return (int)cudaGetLastError();
}

template <typename T, int D>
int launch_merge(void* o_acc, const void* lse_acc, const void* o_j, const void* lse_j, void* lse_out, void* o,
                 int n_rows, int dim, void* stream) {
  int dev;
  const int err = bind_device(&dev);
  if (err != 0) return err;
  const size_t threads = (size_t)n_rows * (dim / 4);
  forms_merge_kernel<T, D><<<(unsigned)((threads + THREADS - 1) / THREADS), THREADS, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<float*>(o_acc), static_cast<const float*>(lse_acc), static_cast<const T*>(o_j),
      static_cast<const float*>(lse_j), static_cast<float*>(lse_out), static_cast<T*>(o), (size_t)n_rows, dim);
  return (int)cudaGetLastError();
}

}  // namespace

// The instance of (dtype, D): CALL(T, D) for each that exists (D = 0: the
// chunked instance, which takes every D > 256 that is a multiple of 64),
// else cudaErrorInvalidValue.
#define FORMS_TYPE(CODE, TT)                                     \
  case CODE * 1000 + 64: return CALL(TT, 64);                    \
  case CODE * 1000 + 128: return CALL(TT, 128);                  \
  case CODE * 1000 + 192: return CALL(TT, 192);                  \
  case CODE * 1000 + 256: return CALL(TT, 256);                  \
  case CODE * 1000 + 0: return CALL(TT, 0);
#define FORMS_DISPATCH(CALL)                                     \
  if (D <= 0 || D % 64 != 0) return (int)cudaErrorInvalidValue;  \
  switch (dtype * 1000 + (D > 256 ? 0 : D)) {                    \
    FORMS_TYPE(DTYPE_F32, float)                                 \
    FORMS_TYPE(DTYPE_BF16, __nv_bfloat16)                        \
    FORMS_TYPE(DTYPE_F16, __half)                                \
    default: return (int)cudaErrorInvalidValue;                  \
  }

// The forward: q (B, T, H, D), k and v (B, S, Kv, D) (Kv = 1: (B, S, D)), o
// like q, lse (B, T*H) fp32 or null. halo = 0: one device, S keys on the
// queries' diagonal (S == T); halo = 1: the halo slab of S = T + window keys
// of the shard [g0, g0 + T) of a song of t_global frames (q already rotated,
// no tables). cos_t, sin_t (T, D) fp32, or null.
extern "C" int forms_fwd(int dtype, int D, const void* q, const void* k, const void* v, const void* cos_t,
                         const void* sin_t, void* o, void* lse, int B, int T, int S, int H, int Kv, int window,
                         int halo, int g0, int t_global, float scale, void* stream) {
  const KeyFrame frame = frame_of(halo, T, S, window, g0, t_global);
#define CALL(TT, DD) launch_fwd<TT, DD>(q, k, v, cos_t, sin_t, o, lse, B, T, S, H, Kv, window, scale, frame, D, stream)
  FORMS_DISPATCH(CALL)
#undef CALL
}

// The pre-pass into scratch allocated by the caller: qs_g (B*Kv, T*G, D) in
// T; do_g the same, or null at Kv == 1; lse_g and delta_g (B*Kv, pad) fp32,
// pad >= T*G.
extern "C" int forms_bwd_prep(int dtype, int D, const void* q, const void* dout, const void* o, const void* lse,
                              const void* cos_t, const void* sin_t, void* qs_g, void* do_g, void* lse_g,
                              void* delta_g, int B, int T, int H, int Kv, int pad, float scale, void* stream) {
  if ((Kv > 1 && do_g == nullptr) || pad < T * (H / Kv)) return (int)cudaErrorInvalidValue;
#define CALL(TT, DD) \
  launch_prep<TT, DD>(q, dout, o, lse, cos_t, sin_t, qs_g, do_g, lse_g, delta_g, B, T, H, Kv, pad, scale, D, stream)
  FORMS_DISPATCH(CALL)
#undef CALL
}

// dq_acc (B*Kv, pad, D) fp32 written, or with `accumulate` added to, over the
// S keys of k and v; do_rows is do_g at Kv > 1, do itself at Kv == 1. Frames
// as forms_fwd's.
extern "C" int forms_bwd_dq(int dtype, int D, const void* k, const void* v, const void* qs_g, const void* do_rows,
                            const void* lse_g, const void* delta_g, void* dq_acc, int B, int T, int S, int H, int Kv,
                            int pad, int window, int halo, int g0, int t_global, int accumulate, void* stream) {
  if (pad % BQ != 0 || pad < T * (H / Kv)) return (int)cudaErrorInvalidValue;
  const KeyFrame frame = frame_of(halo, T, S, window, g0, t_global);
#define CALL(TT, DD)                                                                                                  \
  launch_dq<TT, DD>(k, v, qs_g, do_rows, lse_g, delta_g, dq_acc, B, T, S, H, Kv, pad, window, frame, accumulate, D, \
                    stream)
  FORMS_DISPATCH(CALL)
#undef CALL
}

// dk and dv (B, S, Kv, D) fp32 written, or with `accumulate` added to
extern "C" int forms_bwd_dkv(int dtype, int D, const void* k, const void* v, const void* qs_g, const void* do_rows,
                             const void* lse_g, const void* delta_g, void* dk, void* dv, int B, int T, int S, int H,
                             int Kv, int pad, int window, int halo, int g0, int t_global, int accumulate,
                             void* stream) {
  if (pad % BQ != 0 || pad < T * (H / Kv)) return (int)cudaErrorInvalidValue;
  const KeyFrame frame = frame_of(halo, T, S, window, g0, t_global);
#define CALL(TT, DD)                                                                                              \
  launch_dkv<TT, DD>(k, v, qs_g, do_rows, lse_g, delta_g, dk, dv, B, T, S, H, Kv, pad, window, frame, accumulate, \
                     D, stream)
  FORMS_DISPATCH(CALL)
#undef CALL
}

// dq (B, T, H, D) in T = scale * the un-rotated dq_acc (tables null: scaled only)
extern "C" int forms_bwd_post(int dtype, int D, const void* dq_acc, const void* cos_t, const void* sin_t, void* dq,
                              int B, int T, int H, int Kv, int pad, float scale, void* stream) {
#define CALL(TT, DD) launch_post<TT, DD>(dq_acc, cos_t, sin_t, dq, B, T, H, Kv, pad, scale, D, stream)
  FORMS_DISPATCH(CALL)
#undef CALL
}

// n_rows = B*T*H rows of D; lse_acc null: the first hop; o null: o_acc is
// written, else o alone (the last hop), as ring_merge_bf16
extern "C" int forms_ring_merge(int dtype, int D, void* o_acc, const void* lse_acc, const void* o_j, const void* lse_j,
                                void* lse_out, void* o, int n_rows, void* stream) {
#define CALL(TT, DD) launch_merge<TT, DD>(o_acc, lse_acc, o_j, lse_j, lse_out, o, n_rows, D, stream)
  FORMS_DISPATCH(CALL)
#undef CALL
}
