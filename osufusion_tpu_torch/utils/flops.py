"""Operation counts of the attention kernels, for their roofline bounds.

A kernel is charged the (query, key) pairs its window lets it visit, not the
full T x S square: at a windowed site that is about T * (W + 1), less the
keys that the first and last W / 2 queries of a sequence lack; on a sequence
shard, the pairs of its rows, of which only the first and last shard lack
keys. This is the
count behind the ``bound_ms`` of ``chip_smoke.py``; it is not the training
step's model-FLOP count.
"""

from __future__ import annotations

import numpy as np

# matrix products of depth D per visited pair: s and o; s, dp and dq; s, dp,
# dv and dk; the fused sweep does the five once
PRODUCTS = {"forward": 2, "backward_dq": 3, "backward_dkv": 4, "backward_fused": 5}


def visited_pairs(T: int, S: int, window: int | None) -> int:
    """Pairs (t, s) with |t - s| <= window // 2, t < T, s < S; every pair when
    the window is None, negative, or covers the sequence."""
    if window is None or window < 0 or S <= window:
        return T * S
    t = np.arange(T, dtype=np.int64)
    w2 = window // 2
    return int((np.minimum(S - 1, t + w2) - np.maximum(0, t - w2) + 1).clip(min=0).sum())


def attention_flops(kernel: str, B: int, T: int, H: int, D: int, window: int | None) -> int:
    """Floating-point operations of one launch of ``kernel`` (a key of
    ``PRODUCTS``) at self-attention over T frames: 2 * D per product and pair."""
    return 2 * D * PRODUCTS[kernel] * B * H * visited_pairs(T, T, window)


def halo_visited_pairs(T: int, window: int, g0: int, t_global: int) -> int:
    """Pairs (t, s) of a sequence shard in the halo frame (``ops/halo_attention.py``):
    local query t < T against slab row s < T + window, t <= s <= t + window,
    with slab row s at global frame g0 - window/2 + s inside [0, t_global).
    Over the shards of a song they add up to ``visited_pairs`` of the song."""
    lo, hi = max(0, window // 2 - g0), min(T + window, t_global - g0 + window // 2)
    t = np.arange(T, dtype=np.int64)
    return int((np.minimum(hi - 1, t + window) - np.maximum(lo, t) + 1).clip(min=0).sum())


def halo_flops(kernel: str, B: int, T: int, H: int, D: int, window: int, g0: int, t_global: int) -> int:
    """Floating-point operations of one launch of the halo kernel ``kernel``
    (``forward``, ``backward_dq`` or ``backward_dkv``) on a shard of T frames."""
    return 2 * D * PRODUCTS[kernel] * B * H * halo_visited_pairs(T, window, g0, t_global)
