// The staging of q as every flash kernel that recomputes the forward's
// probabilities must hold it: qs = rope(q) * qscale in fp32, rounded to the
// operands' type T (bf16 or fp16), with qscale = scale * log2(e), so that qs
// k_rot^T is the forward's logit in the exp2 domain. One function serves the
// forward (flash_fwd.cuh) and the backward pre-pass (flash_bwd_prep.cuh) of
// the fused backward and of the windowed pair, so all of them hold the same
// bits. The products and sums are rounded one at a time (no fused
// multiply-add), as the plain version's separate tensor operations are. With
// h = D / 2:
//   out[d]     = q[d] cos[d] - q[d+h] sin[d]
//   out[d + h] = q[d+h] cos[d+h] + q[d] sin[d+h]

#pragma once

#include <stdint.h>

#include "hopper.cuh"

namespace {

// 8 columns col..col+7 of the low half of the raw q row `qr` (2 * HALF wide,
// of T) and their partners at +HALF, as qs packed to T (lo, hi). cr / sr: the
// row of the cos / sin tables (fp32, 2 * HALF wide) of the row's timestep;
// unread without ROPE. HALF is a run-time argument here (the kernels of
// flash_xwide.cuh take the head dim at run time), a compile-time one through
// rope_qs8 below.
template <bool ROPE, typename T>
__device__ __forceinline__ void rope_qs8_half(const T* qr, const float* cr, const float* sr, int col, int HALF,
                                              float qscale, uint4& lo_out, uint4& hi_out) {
  const uint4 ql = *reinterpret_cast<const uint4*>(qr + col);
  const uint4 qh = *reinterpret_cast<const uint4*>(qr + col + HALF);
  const T* xl = reinterpret_cast<const T*>(&ql);
  const T* xh = reinterpret_cast<const T*>(&qh);
  float lo[8], hi[8];
  if (ROPE) {
    // the tables' rows are 4 D bytes and col is a multiple of 8: 16-byte loads
    const float4* c4 = reinterpret_cast<const float4*>(cr + col);
    const float4* s4 = reinterpret_cast<const float4*>(sr + col);
    const float4 cv[4] = {c4[0], c4[1], c4[HALF / 4], c4[HALF / 4 + 1]};  // low half, then its partners
    const float4 sv[4] = {s4[0], s4[1], s4[HALF / 4], s4[HALF / 4 + 1]};
    const float* cl = reinterpret_cast<const float*>(cv);
    const float* sl = reinterpret_cast<const float*>(sv);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float a = widen(xl[j]);
      const float h = widen(xh[j]);
      lo[j] = __fmul_rn(__fsub_rn(__fmul_rn(a, cl[j]), __fmul_rn(h, sl[j])), qscale);
      hi[j] = __fmul_rn(__fadd_rn(__fmul_rn(h, cl[8 + j]), __fmul_rn(a, sl[8 + j])), qscale);
    }
  } else {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      lo[j] = __fmul_rn(widen(xl[j]), qscale);
      hi[j] = __fmul_rn(widen(xh[j]), qscale);
    }
  }
  uint32_t* pl = reinterpret_cast<uint32_t*>(&lo_out);
  uint32_t* ph = reinterpret_cast<uint32_t*>(&hi_out);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    pl[j] = pack2<T>(lo[2 * j], lo[2 * j + 1]);
    ph[j] = pack2<T>(hi[2 * j], hi[2 * j + 1]);
  }
}

// rope_qs8_half at a head dim D fixed at compile time
template <bool ROPE, int D = 64, typename T>
__device__ __forceinline__ void rope_qs8(const T* qr, const float* cr, const float* sr, int col, float qscale,
                                         uint4& lo_out, uint4& hi_out) {
  rope_qs8_half<ROPE>(qr, cr, sr, col, D / 2, qscale, lo_out, hi_out);
}

}  // namespace
