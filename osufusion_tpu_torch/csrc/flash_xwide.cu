// The entry points of the flash forward (every head dim above 256 that is a
// multiple of 64) and the backward pair (D = 320 ... 512) at bf16 operands.
// The kernels and their design are flash_xwide.cuh's; the other operand
// type's entry points (fp16: flash_xwide_f16.cu) are a library of their own, so that
// the two compile side by side.

#include "flash_xwide.cuh"

// q (B, T, H, D), k and v (B, S, D) or (B, S, Kv, D); Kv KV heads (H % Kv ==
// 0, checked by the caller); cos_t and sin_t (T, D) fp32, or null for no
// rotary embedding; qs: scratch of (B * Kv, T * H / Kv, D) for D > 512, else
// null: flash_fwd_bf16's arguments and qs
extern "C" int xwide_fwd_bf16(int D, const void* q, const void* k, const void* v, const void* cos_t,
                              const void* sin_t, void* o, void* lse, void* qs, int B, int T, int S, int H, int Kv,
                              int window, float scale, void* stream) {
  return launch_xwide_fwd<__nv_bfloat16>(q, k, v, cos_t, sin_t, o, lse, qs, B, T, S, H, Kv, D, window, scale,
                                KeyFrame{0, 0, S}, stream);
}

// The halo forward: q (B, T, H, D) already rotated, the slab k (rotated) and
// v (B, T + window, D); halo_fwd_bf16's arguments and qs, as xwide_fwd_bf16's
extern "C" int xwide_halo_fwd_bf16(int D, const void* q, const void* k, const void* v, void* o, void* lse, void* qs,
                                   int B, int T, int H, int window, int g0, int t_global, float scale, void* stream) {
  return launch_xwide_fwd<__nv_bfloat16>(q, k, v, nullptr, nullptr, o, lse, qs, B, T, T + window, H, 1, D, window, scale,
                                halo_frame(T, window, g0, t_global), stream);
}

// dq_acc (B*Kv, pad, D) fp32 written, or with `accumulate` added to, over the
// S keys of k and v, from the forms pre-pass's scratch (qs_g, lse_g, delta_g;
// do_rows is its do_g at Kv > 1, do itself at Kv == 1); halo = 1: the halo
// slab of the shard [g0, g0 + T) of a song of t_global frames
extern "C" int xwide_bwd_dq_bf16(int D, const void* k, const void* v, const void* qs_g, const void* do_rows,
                                 const void* lse_g, const void* delta_g, void* dq_acc, int B, int T, int S, int H,
                                 int Kv, int pad, int window, int halo, int g0, int t_global, int accumulate,
                                 void* stream) {
  return launch_xwide_dq<__nv_bfloat16>(k, v, qs_g, do_rows, lse_g, delta_g, dq_acc, B, T, S, H, Kv, D, pad, window,
                               xw_frame(halo, T, S, window, g0, t_global), accumulate, stream);
}

// dk and dv (B, S, Kv, D) fp32 written, or with `accumulate` added to; slab
// rows outside the song get zeros
extern "C" int xwide_bwd_dkv_bf16(int D, const void* k, const void* v, const void* qs_g, const void* do_rows,
                                  const void* lse_g, const void* delta_g, void* dk, void* dv, int B, int T, int S,
                                  int H, int Kv, int pad, int window, int halo, int g0, int t_global, int accumulate,
                                  void* stream) {
  return launch_xwide_dkv<__nv_bfloat16>(k, v, qs_g, do_rows, lse_g, delta_g, dk, dv, B, T, S, H, Kv, D, pad, window,
                                xw_frame(halo, T, S, window, g0, t_global), accumulate, stream);
}
