// The frame of the keys that a flash kernel runs in, and the halo frame of
// sequence-parallel training: the one copy of the edge rule for every kernel
// with a HALO instance (flash_fwd.cu's forward, flash_bwd_windowed.cu's dq and
// dk/dv), as ops/halo_attention.py::slab_bounds is for the plain versions.
//
// Key s sits at s - off on the queries' diagonal, and only keys in [lo, hi)
// exist. The single-device frame is {0, 0, S}, fixed at compile time. The
// halo frame: a rank holds T local query rows (global frames g0 .. g0 + T - 1)
// and a slab of S = T + W keys whose row s is global frame g0 - W/2 + s, so
// off = W/2 (local query t sees slab row s iff |t - (s - W/2)| <= W/2, W
// even), and the slab rows inside the song are [lo, hi) with lo = max(0, W/2 -
// g0), hi = min(S, t_global - g0 + W/2). g0 and t_global are runtime
// arguments, so one build serves every rank and level.
//
// Everything sits in an unnamed namespace, so each library gets its own copy.

#pragma once

#include <cuda_runtime.h>

namespace {

struct KeyFrame {
  int off, lo, hi;
};

// The halo frame of a launch: T local rows, an even window, the shard [g0,
// g0 + T) inside a song of t_global frames (checked by the wrapper)
inline KeyFrame halo_frame(int T, int window, int g0, int t_global) {
  const int w2 = window / 2, lo = w2 - g0, hi = t_global - g0 + w2;
  return {w2, lo > 0 ? lo : 0, hi < T + window ? hi : T + window};
}

// The keys [lo, hi) that the timesteps t_lo .. t_hi see in frame f: the keys
// within w2 of one of them on the diagonal (local), or every key, clipped to
// the keys that exist. Every real row sees at least one key (itself, or in
// the halo frame its own frame inside the song), so a block's span is never
// empty; a pad row's may be (hi <= lo).
struct KeySpan {
  int lo, hi;
};

__device__ __forceinline__ KeySpan keys_seen(const KeyFrame& f, bool local, int w2, int t_lo, int t_hi) {
  if (!local) return {f.lo, f.hi};
  return {max(f.lo, t_lo + f.off - w2), min(f.hi, t_hi + f.off + w2 + 1)};
}

}  // namespace
