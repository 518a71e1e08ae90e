"""Operation counts: of the attention kernels, for their roofline bounds,
and of one forward of the transformer backbones, for a training step's MFU.

A kernel is charged the (query, key) pairs its window lets it visit, not the
full T x S square: at a windowed site that is about T * (W + 1), less the
keys that the first and last W / 2 queries of a sequence lack; on a sequence
shard, the pairs of its rows, of which only the first and last shard lack
keys; on a rank of the ring, the pairs of its rows against the whole song.
Every query head visits its pairs whatever the number of KV heads, so the
count is the same for MQA, GQA and full MHA (K1 and K2 in their DiT/MMDiT
form). This is the count behind the ``bound_ms`` of ``chip_smoke.py``.

``dit_fwd_flops`` and ``mmdit_fwd_flops`` are the JAX package's model-FLOP
counts (``osufusion_tpu/utils/flops.py``), kept here as a copy: matrix
products and convolutions at 2 FLOP per multiply-add, attention at 4 * T * S
* D per head (both products over every pair), elementwise work not counted.
"""

from __future__ import annotations

import numpy as np

from osufusion_tpu_torch.config import ModelConfig

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


def ring_flops(kernel: str, B: int, t_local: int, n: int, H: int, D: int) -> int:
    """Floating-point operations of one rank's ring (``ops/ring_attention.py``)
    over n shards of ``t_local`` frames: its hops together visit every pair of
    its t_local queries and the song's n * t_local keys; ``kernel`` is
    ``forward`` (K1 per hop) or ``backward_fused`` (K2's sweep per hop)."""
    return 2 * D * PRODUCTS[kernel] * B * H * t_local * t_local * n


# ------------------------------------------------- transformer backbones


def _conv(B: int, T: int, cin: int, cout: int, k: int) -> float:
    return 2.0 * B * T * cin * cout * k


def _dense(B: int, T: int, din: int, dout: int) -> float:
    return 2.0 * B * T * din * dout


def _cross_embed_flops(B: int, T: int, dim_in: int, dim_out: int, kernels=(3, 7, 15)) -> float:
    """The CrossEmbed stem at its input-width channel split (``nn/blocks.py``)."""
    ks = sorted(kernels)
    scales = [dim_in // (2**i) for i in range(1, len(ks))]
    scales = [*scales, dim_out - sum(scales)]
    if scales[-1] <= 0:  # the output-width split of small models
        scales = [dim_out // (2**i) for i in range(1, len(ks))]
        scales = [*scales, dim_out - sum(scales)]
    return sum(_conv(B, T, dim_in, s, k) for s, k in zip(scales, ks))


def dit_fwd_flops(cfg: ModelConfig, batch: int, seq: int) -> float:
    """Forward FLOPs of one DiT call (``nn/dit.py``)."""
    B, T, h = batch, seq, cfg.dim_h
    total = _cross_embed_flops(B, T, cfg.dim_in_x + cfg.dim_in_a, h, cfg.cross_embed_kernel_sizes)
    total += _dense(B, 1, cfg.dim_in_a * 2, h) + 2 * _dense(B, 1, h, h)  # audio pool + mlp
    total += 2 * _dense(B, 1, h, h)  # time mlp
    total += _dense(B, 1, cfg.dim_in_c, h) + _dense(B, 1, h, h)  # cond mlp
    per_block = (
        _dense(B, 1, h, h * 6)  # adaLN modulation
        + _dense(B, T, h, h * 3)  # to_qkv
        + 4.0 * B * cfg.attn_heads * T * T * cfg.attn_dim_head  # global MHA
        + _dense(B, T, h, h * 4)
        + _dense(B, T, h * 4, h)  # ff mult 4
    )
    total += cfg.depth * per_block
    total += _dense(B, 1, h, h * 2) + _dense(B, T, h, h)  # final adaLN + linear
    total += _dense(B, T, h, cfg.dim_in_x)  # postprocess
    return total


def mmdit_fwd_flops(cfg: ModelConfig, batch: int, seq: int) -> float:
    """Forward FLOPs of one MMDiT call (``nn/mmdit.py``)."""
    B, T, h, p = batch, seq, cfg.dim_h, cfg.patch_size
    Tp = -(-T // p)  # tokens per stream
    S = 2 * Tp  # packed joint sequence
    kv = max(cfg.attn_kv_heads, 2)
    total = _conv(B, Tp, cfg.dim_in_x, h, p) + _conv(B, Tp, cfg.dim_in_a, h, p)  # patch embeds
    total += _dense(B, 1, cfg.dim_in_a * 2, h) + 2 * _dense(B, 1, h, h * 4)  # audio pool + FF
    total += 2 * _dense(B, 1, h, h * 4)  # time FF (4h inner both legs)
    total += _dense(B, 1, cfg.dim_in_c, h) + 2 * _dense(B, 1, h, h * 4)  # cond in + FF
    q_dim = cfg.attn_heads * cfg.attn_dim_head
    kv_dim = kv * cfg.attn_dim_head
    per_block = (
        2 * _dense(B, 1, h, h * 6)  # modulation_x + modulation_a
        + 2 * (_dense(B, Tp, h, q_dim) + 2 * _dense(B, Tp, h, kv_dim))  # q/k/v both streams
        + 4.0 * B * cfg.attn_heads * S * S * cfg.attn_dim_head  # joint global attention
        + 2 * _dense(B, Tp, q_dim, h)  # attn_out_x / attn_out_a
        + 2 * (_dense(B, Tp, h, h * 4) + _dense(B, Tp, h * 4, h))  # mlp_x / mlp_a
    )
    total += cfg.depth * per_block
    total += _dense(B, 1, h, h * 2) + _dense(B, Tp, h, p * h)  # final adaLN + linear
    total += _dense(B, T, h, cfg.dim_in_x)  # out
    return total
