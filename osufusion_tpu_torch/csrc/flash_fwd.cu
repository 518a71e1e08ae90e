// The entry points of the flash forward (K1) and of its halo instance (K4)
// at bf16 operands. The kernel and its design are flash_fwd.cuh's; the
// other operand type's entry points (fp16: flash_fwd_f16.cu) are a library of
// their own, so that the two compile side by side.

#include "flash_fwd.cuh"

// q (B, T, H, D), k and v (B, S, D) or (B, S, Kv, D), bf16; Kv KV heads (H %
// Kv == 0, checked by the caller); cos_t and sin_t (T, D) fp32, or null for
// no rotary embedding.
extern "C" int flash_fwd_bf16(int D, const void* q, const void* k, const void* v, const void* cos_t,
                              const void* sin_t, void* o, void* lse, int B, int T, int S, int H, int Kv, int window,
                              float scale, void* stream) {
#define CALL(DD) \
  launch_fwd_single<__nv_bfloat16, DD>(q, k, v, cos_t, sin_t, o, lse, B, T, S, H, Kv, window, scale, stream)
  FWD_HEAD_DIMS(CALL)
#undef CALL
}

// The halo forward: q (B, T, H, D) already rotated, the slab k (rotated) and
// v (B, T + window, D), the Kv = 1 view of the maps; o and the LSE as
// flash_fwd_bf16 writes them. window even, the shard [g0, g0 + T) inside a
// song of t_global frames (checked by the wrapper).
extern "C" int halo_fwd_bf16(int D, const void* q, const void* k, const void* v, void* o, void* lse, int B, int T,
                             int H, int window, int g0, int t_global, float scale, void* stream) {
  const KeyFrame frame = halo_frame(T, window, g0, t_global);
#define CALL(DD)                                                                                         \
  launch_fwd<__nv_bfloat16, DD, false, false, true>(q, k, v, nullptr, nullptr, o, lse, B, T, T + window, H, 1, \
                                           window, scale, frame, stream)
  FWD_HEAD_DIMS(CALL)
#undef CALL
}
