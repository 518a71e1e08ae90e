"""Attention dispatch and the plain grouped-query attention
(``osufusion_tpu/ops/attention.py``).

``sdpa`` sends a CUDA tensor to the hand-written flash-forward kernel and a
CPU tensor to the plain version; there is no other branch. ``gqa_attention``
is that plain version's math: KV heads stay un-repeated, logits and softmax
are float32, and queries are taken in chunks so a full-song sequence never
materialises a (B, H, T, S) logits tensor.
"""

from __future__ import annotations

import torch

from osufusion_tpu_torch.ops.flash_attention import flash_attention, flash_attention_reference

# queries per chunk of the plain path: bounds its logits to
# (B, H, QUERY_CHUNK, keys) however long the sequence is
QUERY_CHUNK = 1024


def sdpa(
    q: torch.Tensor,  # (B, T, H, D), unrotated
    k: torch.Tensor,  # (B, S, Kv, D), unrotated
    v: torch.Tensor,  # (B, S, Kv, D)
    window: int | None,
    rope: tuple,  # (cos, sin) tables (T, D)
) -> torch.Tensor:
    """Rotary-embedded attention, optionally windowed (each query sees keys
    within +/- window/2). Returns (B, T, H, D) in q's dtype."""
    if q.is_cuda:
        return flash_attention(q, k, v, window, rope)
    return flash_attention_reference(q, k, v, window, rope)


def gqa_attention(
    q: torch.Tensor,  # (B, T, H, D)
    k: torch.Tensor,  # (B, S, Kv, D)
    v: torch.Tensor,  # (B, S, Kv, D)
    window: int | None = None,
) -> torch.Tensor:
    """Grouped-query scaled-dot-product attention. Returns (B, T, H, D).

    Key s is attended by query t iff |t - s| <= window // 2 (when the window
    is shorter than the sequence). Each query chunk only looks at the keys its
    window can reach, which changes no result: the others carry zero weight.
    """
    B, T, H, D = q.shape
    S, Kv = k.shape[1], k.shape[2]
    if H % Kv:
        raise ValueError(f"heads {H} not divisible by kv_heads {Kv}")
    G = H // Kv
    scale = D**-0.5
    w2 = window // 2 if window is not None and S > window else None

    out = torch.empty_like(q)
    for t0 in range(0, T, QUERY_CHUNK):
        t1 = min(T, t0 + QUERY_CHUNK)
        s0, s1 = (0, S) if w2 is None else (max(0, t0 - w2), min(S, t1 + w2))
        qg = q[:, t0:t1].reshape(B, t1 - t0, Kv, G, D)
        kc, vc = k[:, s0:s1], v[:, s0:s1]
        logits = torch.einsum("btkgd,bskd->bkgts", qg.float(), kc.float()) * scale
        if w2 is not None:
            rows = torch.arange(t0, t1, device=q.device)[:, None]
            cols = torch.arange(s0, s1, device=q.device)[None, :]
            logits = logits.masked_fill((rows - cols).abs() > w2, -1e30)
        probs = torch.softmax(logits, dim=-1)
        o = torch.einsum("bkgts,bskd->btkgd", probs.to(v.dtype), vc)
        out[:, t0:t1] = o.reshape(B, t1 - t0, H, D).to(q.dtype)
    return out
