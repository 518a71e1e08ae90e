"""The MMDiT backbone (``osufusion_tpu/nn/mmdit.py``): an SD3-style
two-stream multimodal diffusion transformer, channel-last (B, T, C) at its
public call.

Each stream (the osu! signal x, the spectrogram a) is cut into patches by a
strided convolution; every block modulates both streams with its own
adaLN-Zero, projects each to queries, keys and values with its own weights
(GQA with ``max(attn_kv_heads, 2)`` KV heads, per-head QK RMSNorm, no
positional encoding), and runs ONE global attention over the packed [audio;
osu] sequence, then each stream's output projection and feed-forward. A final
adaLN layer projects the osu stream back to ``patch`` frames per token
(unpatchify) and a zero-initialised dense gives the output. Lengths that are
not a multiple of the patch are padded with the pad values of x and a, and
cropped back.

On the GPU the packed attention runs the flash kernels in their GQA form
(``ops/flash_attention.py``, K1 and K2 with one grid row per (batch, KV head)
and no rotary tables). ``cfg.remat`` rematerialises whole blocks.

Under a sequence shard (``--mesh-seq``) each rank holds its frames and packs
its own [audio; osu] tokens; the joint attention runs the ring
(``parallel/ring.py``) over every rank's packed tokens. Attention without
positional terms gives each query the same output under any order of the
keys, so this equals the attention over the whole song's packing. The pooled
audio statistics are sums over the group. The padding to whole patches
belongs to the whole song: a shard must hold a multiple of the patch, else
the forward raises.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from osufusion_tpu_torch.config import ModelConfig
from osufusion_tpu_torch.nn.blocks import remat, sinusoidal_embedding
from osufusion_tpu_torch.nn.dit import (
    DiTFeedForward,
    MultiHeadRMSNorm,
    check_width,
    init_dense,
    layer_norm,
    modulate,
    pooled_audio,
)
from osufusion_tpu_torch.nn.unet import A_PAD_VALUE, X_PAD_VALUE
from osufusion_tpu_torch.ops.attention import sdpa
from osufusion_tpu_torch.parallel.sequence import active_shard


class PatchEmbedding(nn.Module):
    """(B, T, C) -> (B, T / patch, dim_emb): a convolution whose kernel and
    stride are the patch."""

    def __init__(self, dim_in: int, dim_emb: int, patch_size: int) -> None:
        super().__init__()
        self.patch_size = patch_size
        self.Conv_0 = nn.Conv1d(dim_in, dim_emb, patch_size, stride=patch_size)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.shape[1] % self.patch_size:
            raise ValueError(f"sequence length {x.shape[1]} is not a multiple of the patch size {self.patch_size}")
        return self.Conv_0(x.transpose(1, 2)).transpose(1, 2)


class JointAttention(nn.Module):
    """Per-stream q/k/v projections and QK RMSNorms, one attention over the
    packed [audio; osu] sequence. Returns (osu output, audio output), each
    (B, T_stream, heads * dim_head). ``self.sdpa`` is the attention function,
    ``ops.attention.sdpa``; a check that wants the plain version on the GPU
    sets it on the module."""

    def __init__(self, dim: int, dim_head: int, heads: int, kv_heads: int) -> None:
        super().__init__()
        self.dim_head, self.heads, self.kv_heads = dim_head, heads, kv_heads
        self.sdpa = sdpa
        for stream in ("x", "a"):
            self.add_module(f"to_q_{stream}", nn.Linear(dim, dim_head * heads, bias=False))
            self.add_module(f"to_k_{stream}", nn.Linear(dim, dim_head * kv_heads, bias=False))
            self.add_module(f"to_v_{stream}", nn.Linear(dim, dim_head * kv_heads, bias=False))
        for stream in ("x", "a"):
            self.add_module(f"q_{stream}_norm", MultiHeadRMSNorm(dim_head, heads))
            self.add_module(f"k_{stream}_norm", MultiHeadRMSNorm(dim_head, kv_heads))

    def _qkv(self, h: torch.Tensor, stream: str):
        B, T, _ = h.shape
        q = getattr(self, f"to_q_{stream}")(h).reshape(B, T, self.heads, self.dim_head)
        k = getattr(self, f"to_k_{stream}")(h).reshape(B, T, self.kv_heads, self.dim_head)
        v = getattr(self, f"to_v_{stream}")(h).reshape(B, T, self.kv_heads, self.dim_head)
        return getattr(self, f"q_{stream}_norm")(q), getattr(self, f"k_{stream}_norm")(k), v

    def forward(self, x: torch.Tensor, a: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        B, Tx, _ = x.shape
        Ta = a.shape[1]
        q, k, v = (torch.cat(pair, dim=1) for pair in zip(self._qkv(a, "a"), self._qkv(x, "x")))  # audio first
        out = self.sdpa(q, k, v, None, None)
        inner = self.heads * self.dim_head
        return out[:, Ta:].reshape(B, Tx, inner), out[:, :Ta].reshape(B, Ta, inner)


class MMDiTBlock(nn.Module):
    """Two streams, each with its own adaLN-Zero modulation, output projection
    and feed-forward, around one joint attention."""

    def __init__(self, dim_h: int, dim_head: int, heads: int, kv_heads: int, mult: int = 4) -> None:
        super().__init__()
        self.modulation_x = nn.Linear(dim_h, dim_h * 6)
        self.modulation_a = nn.Linear(dim_h, dim_h * 6)
        self.attn = JointAttention(dim_h, dim_head, heads, kv_heads)
        self.attn_out_x = nn.Linear(heads * dim_head, dim_h, bias=False)
        self.attn_out_a = nn.Linear(heads * dim_head, dim_h, bias=False)
        self.mlp_x = DiTFeedForward(dim_h, mult)
        self.mlp_a = DiTFeedForward(dim_h, mult)

    def forward(self, x: torch.Tensor, a: torch.Tensor, c: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        c = F.silu(c)
        s_at_x, sc_at_x, g_at_x, s_ff_x, sc_ff_x, g_ff_x = self.modulation_x(c).chunk(6, dim=-1)
        s_at_a, sc_at_a, g_at_a, s_ff_a, sc_ff_a, g_ff_a = self.modulation_a(c).chunk(6, dim=-1)
        attn_x, attn_a = self.attn(modulate(layer_norm(x), s_at_x, sc_at_x), modulate(layer_norm(a), s_at_a, sc_at_a))
        x = x + g_at_x[:, None, :] * self.attn_out_x(attn_x)
        a = a + g_at_a[:, None, :] * self.attn_out_a(attn_a)
        x = x + g_ff_x[:, None, :] * self.mlp_x(modulate(layer_norm(x), s_ff_x, sc_ff_x))
        a = a + g_ff_a[:, None, :] * self.mlp_a(modulate(layer_norm(a), s_ff_a, sc_ff_a))
        return x, a


class MMDiT(nn.Module):
    """x (B, T, 6), a (B, T, 96) raw spectrogram, t (B,), c (B, 5), cond_mask
    (B,) bool. Returns (B, T, 6) float32; the UNet's call surface
    (``audio_encoded`` is accepted and ignored). Computes in the dtype of its
    parameters."""

    def __init__(self, cfg: ModelConfig) -> None:
        super().__init__()
        check_width(cfg, "MMDiT")
        self.cfg = cfg
        h, p = cfg.dim_h, cfg.patch_size
        self.feature_extractor_a = nn.Linear(cfg.dim_in_a * 2, h)
        self.mlp_a = DiTFeedForward(h, 4)
        self.emb_x = PatchEmbedding(cfg.dim_in_x, h, p)
        self.emb_a = PatchEmbedding(cfg.dim_in_a, h, p)
        self.mlp_time = DiTFeedForward(h, 4)
        self.mlp_cond_in = nn.Linear(cfg.dim_in_c, h)
        self.mlp_cond = DiTFeedForward(h, 4)
        self.null_cond = nn.Parameter(torch.zeros(h))  # drawn by reset_parameters
        kv_heads = max(cfg.attn_kv_heads, 2)
        for i in range(cfg.depth):
            self.add_module(f"block_{i}", MMDiTBlock(h, cfg.attn_dim_head, cfg.attn_heads, kv_heads))
        self.final_modulation = nn.Linear(h, h * 2)
        self.final_linear = nn.Linear(h, p * h)
        self.out = nn.Linear(h, cfg.dim_in_x)
        self.reset_parameters()

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        """Draw every parameter as the JAX package's ``init`` does: the
        audio-statistics and conditioning input layers ``normal(0.02)``, the
        modulations, the final projection and the output zero, every other
        kernel (patch embeddings included) ``xavier_uniform``; biases zero,
        RMSNorm gammas one, ``null_cond`` from N(0, 1)."""
        blocks = [getattr(self, f"block_{i}") for i in range(self.cfg.depth)]
        init_dense([m for m in self.modules() if isinstance(m, (nn.Linear, nn.Conv1d))], "xavier", generator)
        init_dense([self.feature_extractor_a, self.mlp_cond_in], "normal", generator)
        init_dense([*(m for b in blocks for m in (b.modulation_x, b.modulation_a)), self.final_modulation,
                    self.final_linear, self.out], "zeros", generator)
        for m in self.modules():
            if isinstance(m, MultiHeadRMSNorm):
                m.gamma.fill_(1.0)
        self.null_cond.normal_(generator=generator)

    @property
    def dtype(self) -> torch.dtype:
        return self.null_cond.dtype

    def forward(self, x: torch.Tensor, a: torch.Tensor, t: torch.Tensor, c: torch.Tensor,
                cond_mask: Optional[torch.Tensor] = None, audio_encoded: bool = False) -> torch.Tensor:
        B, n, _ = x.shape
        p = self.cfg.patch_size
        pad_len = (p - n % p) % p
        if pad_len and active_shard() is not None:
            raise ValueError(f"a sequence shard of {n} frames is not a multiple of the patch size {p}: the song must "
                             "split into shards of whole patches")
        x, a = x.to(self.dtype), a.to(self.dtype)
        h_a = self.mlp_a(self.feature_extractor_a(pooled_audio(a)))
        if pad_len:
            x = F.pad(x, (0, 0, 0, pad_len), value=X_PAD_VALUE)
            a = F.pad(a, (0, 0, 0, pad_len), value=A_PAD_VALUE)
        x_tok, a_tok = self.emb_x(x), self.emb_a(a)
        t_emb = self.mlp_time(sinusoidal_embedding(t, self.cfg.dim_h).to(self.dtype))
        c_emb = self.mlp_cond(self.mlp_cond_in(c.to(self.dtype)))
        if cond_mask is not None:
            c_emb = torch.where(cond_mask[:, None], c_emb, self.null_cond.to(c_emb.dtype))
        cond = c_emb + t_emb + h_a
        for i in range(self.cfg.depth):
            block = getattr(self, f"block_{i}")
            x_tok, a_tok = remat(block, x_tok, a_tok, cond) if self.cfg.remat else block(x_tok, a_tok, cond)
        shift, scale = self.final_modulation(F.silu(cond)).chunk(2, dim=-1)
        h = self.final_linear(modulate(layer_norm(x_tok), shift, scale))
        h = h.reshape(B, h.shape[1] * p, self.cfg.dim_h)  # unpatchify
        return self.out(h)[:, :n, :].float()
