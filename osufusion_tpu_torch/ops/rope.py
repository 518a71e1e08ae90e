"""Rotary position embedding with length interpolation
(``osufusion_tpu/ops/rope.py``).

Positions are rescaled by ``scale_base / seq_len`` so any sequence length maps
onto the trained context span; the tables are float32 whatever the activation
dtype, and are cast to the activation dtype before the multiply.
"""

from __future__ import annotations

import torch


def rope_tables(seq_len: int, dim: int, scale_base: float, theta: float = 10000.0, device=None):
    """cos/sin tables, each (seq_len, dim), float32, length-interpolated."""
    inv_freq = 1.0 / (theta ** (torch.arange(0, dim, 2, dtype=torch.float32, device=device) / dim))
    t = torch.arange(seq_len, dtype=torch.float32, device=device) * (scale_base / seq_len)
    freqs = torch.outer(t, inv_freq)
    emb = torch.cat([freqs, freqs], dim=-1)
    return emb.cos(), emb.sin()


def rotate_half(x: torch.Tensor) -> torch.Tensor:
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([-x2, x1], dim=-1)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x: (B, T, H, D) or (B, T, D); the tables are cast to x's dtype."""
    if x.ndim == 4:  # broadcast tables over heads
        cos = cos[None, :, None, :]
        sin = sin[None, :, None, :]
    cos = cos.to(x.dtype)
    sin = sin.to(x.dtype)
    return x * cos + rotate_half(x) * sin


def unapply_rope(g: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """The adjoint of ``apply_rope``: a gradient in the rotated frame back
    into the raw frame, ``g cos - rotate_half(g sin)``."""
    if g.ndim == 4:
        cos = cos[None, :, None, :]
        sin = sin[None, :, None, :]
    cos = cos.to(g.dtype)
    sin = sin.to(g.dtype)
    return g * cos - rotate_half(g * sin)
