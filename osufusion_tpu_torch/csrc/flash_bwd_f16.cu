// The entry point of the global backward's sweep (K2) at fp16 operands. The
// kernels and their design are flash_bwd_sweep.cuh's (flash_bwd.cu, item 2);
// the bf16 entry points (flash_bwd.cu) are a library of their own, so that
// the two types compile side by side. At fp16 the sweep runs, at every head
// dim, between the forms family's pre-pass and post-pass (flash_forms.cu),
// which write and read its scratch in the same layout as flash_bwd.cu's D =
// 64 pre-pass: rows padded to BM = 64, the dq buffer zeroed.

#include "flash_bwd_sweep.cuh"

// The sweep over S keys of k and v (B, S, Kv, D) fp16, D = 64, 128, 192 or
// 256, reading qs_g (B*Kv, T*G, D) and do_rows (do_g at Kv > 1, do itself at
// Kv == 1) fp16, lse_g and delta_g (B*Kv, pad) fp32: dq's atomics add into
// dq_acc (B*Kv, pad, D) fp32; dk and dv (B, S, Kv, D) fp32 are stored, or
// with `accumulate` added into what they hold. Returns a cudaError_t
// (cudaErrorInvalidValue for a head dim without an instance), or minus the
// CUresult of a TMA descriptor that failed to encode.
extern "C" int flash_bwd_sweep_f16(int D, const void* k, const void* v, const void* qs_g, const void* do_rows,
                                   const void* lse_g, const void* delta_g, void* dq_acc, void* dk, void* dv, int B,
                                   int T, int S, int H, int Kv, int accumulate, void* stream) {
#define CALL(DD) \
  launch_sweep<__half, DD>(k, v, qs_g, do_rows, lse_g, delta_g, dq_acc, dk, dv, B, T, S, H, Kv, accumulate, stream)
  switch (D) {
    case 64: return CALL(64);
    case 128: return CALL(128);
    case 192: return CALL(192);
    case 256: return CALL(256);
    default: return (int)cudaErrorInvalidValue;
  }
#undef CALL
}
