// The staging of q as every flash kernel that recomputes the forward's
// probabilities must hold it: qs = rope(q) * qscale in fp32, rounded to bf16,
// with qscale = scale * log2(e), so that qs k_rot^T is the forward's logit in
// the exp2 domain. One function serves the forward (flash_fwd.cu) and the
// backward pre-pass (flash_bwd_prep.cuh) of the fused backward and of the
// windowed pair, so all of them hold the same bits. The
// products and sums are rounded one at a time (no fused multiply-add), as the
// plain version's separate tensor operations are. With h = D / 2:
//   out[d]     = q[d] cos[d] - q[d+h] sin[d]
//   out[d + h] = q[d+h] cos[d+h] + q[d] sin[d+h]

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace {

// 8 columns col..col+7 of the low half of the raw q row `qr` (D wide) and
// their partners at +D/2, as qs packed to bf16 (lo, hi). cr / sr: the row of
// the cos / sin tables (fp32, D wide) of the row's timestep; unread without
// ROPE.
template <bool ROPE, int D = 64>
__device__ __forceinline__ void rope_qs8(const __nv_bfloat16* qr, const float* cr, const float* sr, int col,
                                         float qscale, uint4& lo_out, uint4& hi_out) {
  constexpr int HALF = D / 2;
  const uint4 ql = *reinterpret_cast<const uint4*>(qr + col);
  const uint4 qh = *reinterpret_cast<const uint4*>(qr + col + HALF);
  const __nv_bfloat16* xl = reinterpret_cast<const __nv_bfloat16*>(&ql);
  const __nv_bfloat16* xh = reinterpret_cast<const __nv_bfloat16*>(&qh);
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
      const float a = __bfloat162float(xl[j]);
      const float h = __bfloat162float(xh[j]);
      lo[j] = __fmul_rn(__fsub_rn(__fmul_rn(a, cl[j]), __fmul_rn(h, sl[j])), qscale);
      hi[j] = __fmul_rn(__fadd_rn(__fmul_rn(h, cl[8 + j]), __fmul_rn(a, sl[8 + j])), qscale);
    }
  } else {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      lo[j] = __fmul_rn(__bfloat162float(xl[j]), qscale);
      hi[j] = __fmul_rn(__bfloat162float(xh[j]), qscale);
    }
  }
  uint32_t* pl = reinterpret_cast<uint32_t*>(&lo_out);
  uint32_t* ph = reinterpret_cast<uint32_t*>(&hi_out);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    __nv_bfloat162 l2 = __floats2bfloat162_rn(lo[2 * j], lo[2 * j + 1]);
    __nv_bfloat162 h2 = __floats2bfloat162_rn(hi[2 * j], hi[2 * j + 1]);
    pl[j] = *reinterpret_cast<uint32_t*>(&l2);
    ph[j] = *reinterpret_cast<uint32_t*>(&h2);
  }
}

}  // namespace
