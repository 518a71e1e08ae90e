// The entry points of the fp32 attention forward (every head dim that is a
// multiple of 64) and backward pair (D = 64 ... 512) on the tensor cores, six
// bf16 products per fp32 product, and of their split. The kernels and their
// design are flash_f32x6.cuh's.

#include "flash_f32x6.cuh"

// q (B, T, H, D) fp32, raw; k and v as their pieces (B, S, Kv, 3 D) bf16
// (f32x6_split); o like q, lse (B, T*H) fp32 or null; qs: scratch of qs's
// pieces (B * Kv, T * H / Kv, 3 D) bf16 for D > 256, else null; cos_t and
// sin_t (T, D) fp32, or null for no rotary embedding: xwide_fwd_bf16's
// arguments
extern "C" int f32x6_fwd(int D, const void* q, const void* k, const void* v, const void* cos_t, const void* sin_t,
                         void* o, void* lse, void* qs, int B, int T, int S, int H, int Kv, int window, float scale,
                         void* stream) {
  return launch_x6_fwd(q, k, v, cos_t, sin_t, o, lse, qs, B, T, S, H, Kv, D, window, scale, KeyFrame{0, 0, S},
                       stream);
}

// The halo forward: q (B, T, H, D) fp32 already rotated, the pieces of the
// slab's k (rotated) and v (B, T + window, 3 D); xwide_halo_fwd_bf16's
// arguments
extern "C" int f32x6_halo_fwd(int D, const void* q, const void* k, const void* v, void* o, void* lse, void* qs, int B,
                              int T, int H, int window, int g0, int t_global, float scale, void* stream) {
  return launch_x6_fwd(q, k, v, nullptr, nullptr, o, lse, qs, B, T, T + window, H, 1, D, window, scale,
                       halo_frame(T, window, g0, t_global), stream);
}

// out (n_rows, 3 D) bf16 = the pieces [b0 | b1 | b2] of each row of x
// (n_rows, D) fp32, x = b0 + b1 + b2 exactly; both 16-byte aligned; D a
// multiple of 64
extern "C" int f32x6_split(const void* x, void* out, long long n_rows, int D, void* stream) {
  return launch_x6_split(x, out, n_rows, D, stream);
}

// dq_acc (B*Kv, pad, D) fp32 written, or with `accumulate` added to, over the
// S keys of k and v, from the forms pre-pass's scratch (lse_g, delta_g) and
// the pieces of k and v (B, S, Kv, 3 D), of qs_g (B*Kv, T*G, 3 D) and of
// do_rows (its do_g at Kv > 1, do itself at Kv == 1); halo = 1: the halo
// slab of the shard [g0, g0 + T) of a song of t_global frames
extern "C" int f32x6_bwd_dq(int D, const void* k, const void* v, const void* qs_g, const void* do_rows,
                            const void* lse_g, const void* delta_g, void* dq_acc, int B, int T, int S, int H, int Kv,
                            int pad, int window, int halo, int g0, int t_global, int accumulate, void* stream) {
  return launch_x6_dq(k, v, qs_g, do_rows, lse_g, delta_g, dq_acc, B, T, S, H, Kv, D, pad, window,
                      xw_frame(halo, T, S, window, g0, t_global), accumulate, stream);
}

// dk and dv (B, S, Kv, D) fp32 written, or with `accumulate` added to; slab
// rows outside the song get zeros
extern "C" int f32x6_bwd_dkv(int D, const void* k, const void* v, const void* qs_g, const void* do_rows,
                             const void* lse_g, const void* delta_g, void* dk, void* dv, int B, int T, int S, int H,
                             int Kv, int pad, int window, int halo, int g0, int t_global, int accumulate,
                             void* stream) {
  return launch_x6_dkv(k, v, qs_g, do_rows, lse_g, delta_g, dk, dv, B, T, S, H, Kv, D, pad, window,
                       xw_frame(halo, T, S, window, g0, t_global), accumulate, stream);
}
