// The exact merge of one ring hop's partial attention into the running
// accumulators, for Hopper (sm_90a).
//
// Replaces the merge of osufusion_tpu/ops/pallas_attention.py::_ring_fwd
// (its `step`: XLA elementwise code around the K1 call of each hop). Hop j of
// the ring runs the forward kernel (flash_fwd.cu, global, with its base-2 LSE)
// on this rank's queries against the chunk of keys that is here, which gives
// o_j, normalised over that chunk alone, and lse_j. With lse_acc the LSE over
// the chunks seen so far:
//   m   = max(lse_acc, lse_j)
//   lse = m + log2(2^(lse_acc - m) + 2^(lse_j - m))
//   o   = o_acc * 2^(lse_acc - lse) + o_j * 2^(lse_j - lse)
// in fp32. On the first hop o_acc and lse_acc are taken as empty (weight 0);
// on the last, o is written in bf16: the op's output, and the o from which the
// backward's delta is computed.
//
// Layout: o_acc (B, T, H, D) fp32, o_j and o (B, T, H, D) bf16, the LSEs
// (B, T*H) fp32 in the forward's flat t-major order, so that row r of o (the
// (b, t, h) row) has its LSE at r. lse_out is another buffer than lse_acc: the
// eight threads of a row all read lse_acc.
//
// Bound: bytes. Per row of 64 it reads 256 bytes of o_acc (none on the first
// hop), 128 of o_j and 8 of LSEs, and writes 256 of o_acc (128 of o on the
// last hop) and 4 of LSE; a handful of operations per element. One thread per
// (row, 8 columns): 16-byte loads and stores, neighbouring threads on
// neighbouring addresses.
//
// C ABI (loaded with ctypes): returns a cudaError_t.

#include <math.h>

#include "hopper.cuh"

namespace {

constexpr int D = 64;
constexpr int THREADS = 256;

__global__ void ring_merge_kernel(float* __restrict__ o_acc, const float* __restrict__ lse_acc,
                                  const __nv_bfloat16* __restrict__ o_j, const float* __restrict__ lse_j,
                                  float* __restrict__ lse_out, __nv_bfloat16* __restrict__ o, size_t n_rows) {
  const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  const size_t row = idx / (D / 8);
  if (row >= n_rows) return;
  const int col = (idx % (D / 8)) * 8;
  const float lj = lse_j[row];
  const float la = lse_acc != nullptr ? lse_acc[row] : -INFINITY;
  const float m = fmaxf(la, lj);
  const float lse = m + log2f(exp2f(la - m) + exp2f(lj - m));
  const float wa = exp2f(la - lse), wj = exp2f(lj - lse);
  if (col == 0) lse_out[row] = lse;

  const uint4 pj = *reinterpret_cast<const uint4*>(o_j + row * D + col);
  const __nv_bfloat162* bj = reinterpret_cast<const __nv_bfloat162*>(&pj);
  float out[8];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 x = __bfloat1622float2(bj[i]);
    out[2 * i] = x.x * wj;
    out[2 * i + 1] = x.y * wj;
  }
  float4* acc = reinterpret_cast<float4*>(o_acc + row * D + col);
  if (lse_acc != nullptr) {
    const float4 a0 = acc[0], a1 = acc[1];
    out[0] += a0.x * wa; out[1] += a0.y * wa; out[2] += a0.z * wa; out[3] += a0.w * wa;
    out[4] += a1.x * wa; out[5] += a1.y * wa; out[6] += a1.z * wa; out[7] += a1.w * wa;
  }
  if (o != nullptr) {
    uint4 packed;
    packed.x = pack_bf16(out[0], out[1]);
    packed.y = pack_bf16(out[2], out[3]);
    packed.z = pack_bf16(out[4], out[5]);
    packed.w = pack_bf16(out[6], out[7]);
    *reinterpret_cast<uint4*>(o + row * D + col) = packed;
  } else {
    acc[0] = make_float4(out[0], out[1], out[2], out[3]);
    acc[1] = make_float4(out[4], out[5], out[6], out[7]);
  }
}

}  // namespace

// n_rows = B*T*H rows of 64. lse_acc null: the first hop (o_acc is not read).
// o null: o_acc is written; else o alone (the last hop).
extern "C" int ring_merge_bf16(void* o_acc, const void* lse_acc, const void* o_j, const void* lse_j, void* lse_out,
                               void* o, int n_rows, void* stream) {
  int dev;
  const int err = bind_device(&dev);
  if (err != 0) return err;
  const size_t threads = (size_t)n_rows * (D / 8);
  ring_merge_kernel<<<(unsigned)((threads + THREADS - 1) / THREADS), THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<float*>(o_acc), static_cast<const float*>(lse_acc), static_cast<const __nv_bfloat16*>(o_j),
      static_cast<const float*>(lse_j), static_cast<float*>(lse_out), static_cast<__nv_bfloat16*>(o), (size_t)n_rows);
  return (int)cudaGetLastError();
}
