// The entry points of the windowed backward pair (K3a / K3b) and of its halo
// instances (K5a / K5b), with their pre-pass, at bf16 operands. The kernels
// and their design are flash_bwd_windowed.cuh's; the fp16 entry points
// (flash_bwd_windowed_f16.cu) are a library of their own, so that the two
// types compile side by side.

#include "flash_bwd_windowed.cuh"

// The scratch, allocated by the caller: qs_g (B, T*H, D) bf16, lse_g and
// delta_g (B, pad) fp32, pad = T*H rounded up to a multiple of ROW_PAD (128).
// With null tables (the halo pair: q arrives rotated) q is only scaled.
extern "C" int flash_bwd_windowed_prep_bf16(int D, const void* q, const void* dout, const void* o, const void* lse,
                                            const void* cos_t, const void* sin_t, void* qs_g, void* lse_g,
                                            void* delta_g, int B, int T, int H, int pad, float scale, void* stream) {
#define CALL(DD) \
  launch_prep<__nv_bfloat16, DD>(q, dout, o, lse, cos_t, sin_t, qs_g, lse_g, delta_g, B, T, H, pad, scale, stream)
  WINDOWED_HEAD_DIMS(CALL)
#undef CALL
}

extern "C" int flash_bwd_dq_bf16(int D, const void* k, const void* v, const void* dout, const void* qs_g,
                                 const void* lse_g, const void* delta_g, const void* cos_t, const void* sin_t,
                                 void* dq, int B, int T, int S, int H, int pad, int window, float scale,
                                 void* stream) {
#define CALL(DD)                                                                                                  \
  launch_dq<__nv_bfloat16, DD, false>(k, v, dout, qs_g, lse_g, delta_g, cos_t, sin_t, dq, B, T, S, H, pad, window, \
                                      scale, KeyFrame{0, 0, S}, stream)
  WINDOWED_HEAD_DIMS(CALL)
#undef CALL
}

extern "C" int flash_bwd_dkv_bf16(int D, const void* k, const void* v, const void* dout, const void* qs_g,
                                  const void* lse_g, const void* delta_g, void* dk, void* dv, int B, int T, int S,
                                  int H, int pad, int window, void* stream) {
#define CALL(DD)                                                                                            \
  launch_dkv<__nv_bfloat16, DD, false>(k, v, dout, qs_g, lse_g, delta_g, dk, dv, B, T, S, H, pad, window, \
                                       KeyFrame{0, 0, S}, stream)
  WINDOWED_HEAD_DIMS(CALL)
#undef CALL
}

// The halo pair, on the scratch of the pre-pass without tables: k and v are
// the slab (B, T + window, D); window even, the shard [g0, g0 + T) inside a
// song of t_global frames (checked by the wrapper).
extern "C" int halo_bwd_dq_bf16(int D, const void* k, const void* v, const void* dout, const void* qs_g,
                                const void* lse_g, const void* delta_g, void* dq, int B, int T, int H, int pad,
                                int window, int g0, int t_global, float scale, void* stream) {
#define CALL(DD)                                                                                                \
  launch_dq<__nv_bfloat16, DD, true>(k, v, dout, qs_g, lse_g, delta_g, nullptr, nullptr, dq, B, T, T + window, H, \
                                     pad, window, scale, halo_frame(T, window, g0, t_global), stream)
  WINDOWED_HEAD_DIMS(CALL)
#undef CALL
}

extern "C" int halo_bwd_dkv_bf16(int D, const void* k, const void* v, const void* dout, const void* qs_g,
                                 const void* lse_g, const void* delta_g, void* dk, void* dv, int B, int T, int H,
                                 int pad, int window, int g0, int t_global, void* stream) {
#define CALL(DD)                                                                                                \
  launch_dkv<__nv_bfloat16, DD, true>(k, v, dout, qs_g, lse_g, delta_g, dk, dv, B, T, T + window, H, pad, window, \
                                      halo_frame(T, window, g0, t_global), stream)
  WINDOWED_HEAD_DIMS(CALL)
#undef CALL
}
