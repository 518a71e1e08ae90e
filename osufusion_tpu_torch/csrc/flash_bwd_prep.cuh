// The pre-pass of the backward kernels that recompute the forward's
// probabilities from its LSE: the global backward (flash_bwd.cu) and the split
// windowed pair (flash_bwd_windowed.cuh). One sweep over the (timestep, head)
// rows writes, in group-major order (B * Kv, T * G, ...), so that every KV
// group's rows are contiguous whatever G = H / Kv is (row r: timestep r / G,
// head kv * G + r % G; at MQA that is the t-major order of q itself):
//  * qs = rope(q) * qscale in the operand type E (bf16 or fp16), staged by
//    rope_qs.cuh, so that qs k_rot^T
//    is the forward's logit in the exp2 domain (rotated and scaled once, not
//    once per KV tile that meets the row);
//  * do copied into that order where do_g is not null (Kv > 1);
//  * the LSE and delta = rowsum(do * o), both padded to `pad` rows per group:
//    a pad row gets LSE = +inf and delta = 0, so its p and ds are 0;
//  * where dq_acc is not null, a zeroed fp32 row of the dq buffer that the
//    global backward's atomics add into (the split pair has none).
// Templated on the operand type E and the head dim D: the global backward
// takes its bf16 D = 64 instance (at wider heads and at fp16 it runs the forms
// pre-pass), the windowed pair the E and D of its kernels (bf16 and fp16; 64,
// 128, 192, 256).
//
// Everything sits in an unnamed namespace, so each library gets its own copy.

#pragma once

#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include "rope_qs.cuh"

namespace {

// Four threads per group row, each taking the chunks of 8 columns c, c + 4,
// ... of the low half (D / 64 of them) and their partners D / 2 on; grid
// (pad * 4 / 256, B * Kv) of 256 threads, pad a multiple of 64.
template <typename E, int D, bool ROPE>
__global__ void flash_bwd_prep_kernel(const E* __restrict__ q, const E* __restrict__ dout, const E* __restrict__ o,
                                      const float* __restrict__ lse, const float* __restrict__ cos_t,
                                      const float* __restrict__ sin_t, E* __restrict__ qs_g, E* __restrict__ do_g,
                                      float* __restrict__ lse_g, float* __restrict__ delta_g,
                                      float* __restrict__ dq_acc, int T, int H, int Kv, int pad, float qscale) {
  static_assert(D % 64 == 0, "whole chunks of 8 columns for each of a row's four threads");
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  const int G = H / Kv;
  const int rows = T * G;
  const int c = idx % 4;
  const int r = idx / 4;           // row of the group, < pad
  const size_t grp = blockIdx.y;   // b * Kv + kv
  const size_t gr = grp * pad + r;  // (group, row) over the padded rows
  float part = 0.f;
  const bool real = r < rows;
  if (real) {
    const int b = grp / Kv, kv = grp % Kv;
    const int t = r / G;
    const size_t src = ((size_t)b * T + t) * H + kv * G + r % G;  // the (b, t, h) row
    const size_t dst = grp * rows + r;
#pragma unroll
    for (int j = 0; j < D / 64; ++j) {
      const int col = (c + 4 * j) * 8;
      uint4 lo, hi;
      rope_qs8<ROPE, D>(q + src * D, ROPE ? cos_t + (size_t)t * D : nullptr, ROPE ? sin_t + (size_t)t * D : nullptr,
                        col, qscale, lo, hi);
      *reinterpret_cast<uint4*>(qs_g + dst * D + col) = lo;
      *reinterpret_cast<uint4*>(qs_g + dst * D + col + D / 2) = hi;
      const uint4 d4[2] = {*reinterpret_cast<const uint4*>(dout + src * D + col),
                           *reinterpret_cast<const uint4*>(dout + src * D + col + D / 2)};
      const uint4 o4[2] = {*reinterpret_cast<const uint4*>(o + src * D + col),
                           *reinterpret_cast<const uint4*>(o + src * D + col + D / 2)};
      if (do_g != nullptr) {
        *reinterpret_cast<uint4*>(do_g + dst * D + col) = d4[0];
        *reinterpret_cast<uint4*>(do_g + dst * D + col + D / 2) = d4[1];
      }
      const E* pd = reinterpret_cast<const E*>(d4);
      const E* po = reinterpret_cast<const E*>(o4);
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        part += widen(pd[2 * e]) * widen(po[2 * e]) + widen(pd[2 * e + 1]) * widen(po[2 * e + 1]);
      }
    }
    if (c == 0) lse_g[gr] = lse[src];
  } else if (c == 0) {
    lse_g[gr] = INFINITY;
  }
  // the four threads of a row are neighbours in one warp (blockDim.x is a multiple of 32)
  part += __shfl_xor_sync(0xffffffffu, part, 1);
  part += __shfl_xor_sync(0xffffffffu, part, 2);
  if (c == 0) delta_g[gr] = real ? part : 0.f;
  if (dq_acc != nullptr) {
    float4* dz = reinterpret_cast<float4*>(dq_acc + gr * D);
    const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int j = 0; j < D / 64; ++j) {
      const int col = (c + 4 * j) * 8;
      dz[col / 4] = zero;
      dz[col / 4 + 1] = zero;
      dz[(col + D / 2) / 4] = zero;
      dz[(col + D / 2) / 4 + 1] = zero;
    }
  }
}

}  // namespace
