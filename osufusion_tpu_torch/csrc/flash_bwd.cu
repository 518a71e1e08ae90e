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
//     The sweep (flash_bwd_sweep.cuh) is templated on the operand type, bf16
//     or fp16, and on the head dim (struct Bwd): at D = 128 the
//     same design with tiles of two swizzle atoms, dV and dK as wgmma
//     m64n128 and dQ one 64-column atom per warpgroup each tile; at D = 192
//     and 256, where dk and dv of 64 keys no longer fit one warpgroup's
//     registers, flash_bwd_split_kernel: 64 keys a block, the two warpgroups
//     splitting the products by kind (S^T and dV; dP^T and dK), P^T crossing
//     through shared memory in fp32, dQ split by atoms. At D > 64 a grid of
//     fewer blocks than SMs (MQA at a small batch) splits each block's query
//     tiles over up to four blocks (gridDim.z), which add dk and dv by fp32
//     atomics, so those too vary in their last bits between runs.
//  3. Post-pass (flash_bwd_dq_kernel): dq = scale * un-rotate(buffer), cast to
//     bf16, back in (B, T, H, D) order.
// The pre-pass and the post-pass here are bf16 at D = 64; at D > 64, and at
// fp16 at every D, the wrapper (ops/flash_attention.py) feeds the sweep from
// the forms family's generic pre-pass and post-pass (flash_forms.cu), which
// keep the same contract. The fp16 sweep's entry point, flash_bwd_sweep_f16,
// is a library of its own (flash_bwd_f16.cu), so that the two types compile
// side by side.
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
// minus the CUresult of a TMA descriptor that failed to encode; the sweep
// takes the head dim first.

#include <math.h>

#include "flash_bwd_prep.cuh"
#include "flash_bwd_sweep.cuh"
#include "hopper.cuh"

namespace {

constexpr int D64 = 64;  // the head dim of the pre-pass and the post-pass here
constexpr float LOG2E = 1.4426950408889634f;

// dq (B, T, H, 64) bf16 = scale * the un-rotated buffer row (g cos - rot_half(g
// sin); columns d and d + 32 together), one thread per (row, 8 columns of the
// low half and their partners). Wider heads take the forms post-pass
// (flash_forms.cu), which is D-generic.
template <bool ROPE>
__global__ void flash_bwd_dq_kernel(const float* __restrict__ dq_acc, const float* __restrict__ cos_t,
                                    const float* __restrict__ sin_t, __nv_bfloat16* __restrict__ dq, size_t n_rows,
                                    int T, int H, int Kv, int pad, float scale) {
  constexpr int D = D64;
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

}  // namespace

// The scratch, allocated by the caller: qs_g (B*Kv, T*G, D) bf16; do_g the
// same, or null at Kv == 1 (do is then read in place); lse_g and delta_g
// (B*Kv, pad) fp32 and dq_acc (B*Kv, pad, D) fp32, pad = T*G rounded up to a
// multiple of 64. Kv KV heads (H % Kv == 0, checked by the caller); cos_t and
// sin_t (T, D) fp32, or null for no rotary embedding. The pre-pass and the
// post-pass here are the D = 64 instances; at wider heads the wrapper runs
// the forms pre-pass and post-pass (flash_forms.cu), which write and read the
// same scratch (dq_acc allocated zeroed).

// 1. The pre-pass: qs_g, do_g (Kv > 1), lse_g, delta_g, and dq_acc zeroed.
extern "C" int flash_bwd_prep_bf16(const void* q, const void* dout, const void* o, const void* lse, const void* cos_t,
                                   const void* sin_t, void* qs_g, void* do_g, void* lse_g, void* delta_g, void* dq_acc,
                                   int B, int T, int H, int Kv, float scale, void* stream) {
  if (Kv > 1 && do_g == nullptr) return (int)cudaErrorInvalidValue;
  int dev;
  const int err = bind_device(&dev);
  if (err != 0) return err;
  const int pad = (T * (H / Kv) + BM - 1) / BM * BM;
  auto prep = cos_t != nullptr ? flash_bwd_prep_kernel<__nv_bfloat16, D64, true>
                              : flash_bwd_prep_kernel<__nv_bfloat16, D64, false>;
  prep<<<dim3(pad * 4 / 256, B * Kv), 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(dout),
      static_cast<const __nv_bfloat16*>(o), static_cast<const float*>(lse), static_cast<const float*>(cos_t),
      static_cast<const float*>(sin_t), static_cast<__nv_bfloat16*>(qs_g),
      Kv > 1 ? static_cast<__nv_bfloat16*>(do_g) : nullptr, static_cast<float*>(lse_g), static_cast<float*>(delta_g),
      static_cast<float*>(dq_acc), T, H, Kv, pad, scale * LOG2E);
  return (int)cudaGetLastError();
}

// 2. The sweep over S keys of k and v (B, S, Kv, D) bf16, D = 64, 128, 192 or
// 256: dq's atomics add into dq_acc; dk and dv (B, S, Kv, D) fp32 are stored,
// or with `accumulate` added into what they hold. do_rows is do_g at Kv > 1,
// do itself at Kv == 1. cudaErrorInvalidValue for a head dim without an
// instance.
extern "C" int flash_bwd_sweep_bf16(int D, const void* k, const void* v, const void* qs_g, const void* do_rows,
                                    const void* lse_g, const void* delta_g, void* dq_acc, void* dk, void* dv, int B,
                                    int T, int S, int H, int Kv, int accumulate, void* stream) {
#define CALL(DD) \
  launch_sweep<__nv_bfloat16, DD>(k, v, qs_g, do_rows, lse_g, delta_g, dq_acc, dk, dv, B, T, S, H, Kv, accumulate, \
                                  stream)
  switch (D) {
    case 64: return CALL(64);
    case 128: return CALL(128);
    case 192: return CALL(192);
    case 256: return CALL(256);
    default: return (int)cudaErrorInvalidValue;
  }
#undef CALL
}

// 3. The post-pass: dq (B, T, H, 64) bf16 = scale * the un-rotated dq_acc.
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

// The whole backward at one site of head dim 64: the three in a row, the
// sweep storing dk, dv.
extern "C" int flash_bwd_bf16(const void* q, const void* k, const void* v, const void* dout, const void* o,
                              const void* lse, const void* cos_t, const void* sin_t, void* qs_g, void* do_g,
                              void* lse_g, void* delta_g, void* dq_acc, void* dq, void* dk, void* dv, int B, int T,
                              int S, int H, int Kv, float scale, void* stream) {
  int err = flash_bwd_prep_bf16(q, dout, o, lse, cos_t, sin_t, qs_g, do_g, lse_g, delta_g, dq_acc, B, T, H, Kv, scale,
                                stream);
  if (err == 0)
    err = flash_bwd_sweep_bf16(D64, k, v, qs_g, Kv > 1 ? do_g : dout, lse_g, delta_g, dq_acc, dk, dv, B, T, S, H,
                               Kv, 0, stream);
  if (err == 0) err = flash_bwd_post_bf16(dq_acc, cos_t, sin_t, dq, B, T, H, Kv, scale, stream);
  return err;
}
