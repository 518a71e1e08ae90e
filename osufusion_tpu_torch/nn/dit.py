"""The DiT backbone (``osufusion_tpu/nn/dit.py``): a flat diffusion
transformer with adaLN-Zero conditioning, channel-last (B, T, C) at its
public call.

The input is the channel concat [x; a] through a CrossEmbed stem; the
conditioning vector is the difficulty MLP + the time MLP + pooled audio
statistics (mean and unbiased std over time, then an MLP); each block is
adaLN-Zero 6-way modulation around full multi-head attention (H == Kv) with
per-head QK RMSNorm and no positional encoding, and a feed-forward; a final
adaLN layer and a zero-initialised projection give the output. The attention
output feeds the residual stream without a projection, so ``heads x
dim_head`` must equal ``dim_h``.

Every attention site is global: on the GPU it runs the flash kernels in their
full-MHA form (``ops/flash_attention.py``, K1 and K2 with one KV head per
query head and no rotary tables). Under a sequence shard (``--mesh-seq``)
each rank holds its frames: the sites run the ring attention
(``parallel/ring.py``), the stem's convolutions exchange halos and the pooled
audio statistics are sums over the group. ``cfg.remat`` rematerialises whole
blocks, as ``nn.remat(DiTBlock)`` does; ``remat_mode`` is not read, as in the
JAX package.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from osufusion_tpu_torch.config import ModelConfig
from osufusion_tpu_torch.nn.blocks import CrossEmbedLayer, FeedForward, lecun_normal_, remat, sinusoidal_embedding
from osufusion_tpu_torch.ops.attention import sdpa
from osufusion_tpu_torch.parallel.sequence import active_shard, all_reduce_sum

LN_EPS = 1e-6


def modulate(x: torch.Tensor, shift: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return x * (1 + scale[:, None, :]) + shift[:, None, :]


def layer_norm(x: torch.Tensor) -> torch.Tensor:
    """flax ``LayerNorm(use_bias=False, use_scale=False, epsilon=1e-6)``."""
    return F.layer_norm(x, x.shape[-1:], eps=LN_EPS)


def check_width(cfg: ModelConfig, backbone: str) -> None:
    """The attention output feeds the residual stream unprojected: refuse a
    config whose heads x dim_head is not dim_h."""
    if cfg.attn_heads * cfg.attn_dim_head != cfg.dim_h:
        raise ValueError(f"{backbone} requires attn_heads*attn_dim_head == dim_h ({cfg.attn_heads}*{cfg.attn_dim_head} "
                         f"!= {cfg.dim_h}): the attention output feeds the residual stream without a projection")


def pooled_audio(a: torch.Tensor) -> torch.Tensor:
    """(B, T, C) -> (B, 2C): the mean and the unbiased standard deviation over
    time, statistics in fp32, in a's dtype. Under a sequence shard a holds
    this rank's frames and the statistics are the whole song's, from sums over
    the group in two passes (the mean, then the squared deviations from it),
    as ``var(ddof=1)`` takes them."""
    af = a.float()
    shard = active_shard()
    if shard is None:
        mean, var = af.mean(dim=1), af.var(dim=1, correction=1)
    else:
        n = af.shape[1] * shard.count
        mean = all_reduce_sum(af.sum(dim=1), shard) / n
        var = all_reduce_sum((af - mean[:, None]).square().sum(dim=1), shard) / (n - 1)
    return torch.cat([mean, torch.sqrt(var + 1e-12)], dim=-1).to(a.dtype)


def init_dense(layers, kind: str, generator: Optional[torch.Generator]) -> None:
    """Draw the kernels of ``layers`` (``nn.Linear`` / ``nn.Conv1d``) as flax's
    ``kind`` initialiser does (``xavier``: ``xavier_uniform``; ``normal``:
    ``normal(0.02)``; ``zeros``; ``lecun``: ``lecun_normal``); biases zero."""
    with torch.no_grad():
        for layer in layers:
            if kind == "xavier":
                nn.init.xavier_uniform_(layer.weight, generator=generator)
            elif kind == "normal":
                nn.init.normal_(layer.weight, std=0.02, generator=generator)
            elif kind == "lecun":
                lecun_normal_(layer.weight, generator)
            else:
                layer.weight.zero_()
            if layer.bias is not None:
                layer.bias.zero_()


class MultiHeadRMSNorm(nn.Module):
    """Per-head RMS norm over the head dim with a learned (heads, dim) gamma,
    in fp32: x / ||x|| * gamma * sqrt(dim)."""

    def __init__(self, dim: int, heads: int) -> None:
        super().__init__()
        self.dim = dim
        self.gamma = nn.Parameter(torch.ones(heads, dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:  # (B, T, H, D)
        xf = x.float()
        normed = xf / torch.sqrt(xf.square().sum(dim=-1, keepdim=True) + 1e-12)
        return (normed * self.gamma.float() * self.dim**0.5).to(x.dtype)


class DiTAttention(nn.Module):
    """Full multi-head self-attention with per-head QK RMSNorm and no
    positional encoding; no output projection. ``self.sdpa`` is the attention
    function, ``ops.attention.sdpa``; a check that wants the plain version on
    the GPU sets it on the module."""

    def __init__(self, dim: int, heads: int, dim_head: int) -> None:
        super().__init__()
        self.heads, self.dim_head = heads, dim_head
        self.sdpa = sdpa
        self.to_qkv = nn.Linear(dim, heads * dim_head * 3, bias=False)
        self.q_norm = MultiHeadRMSNorm(dim_head, heads)
        self.k_norm = MultiHeadRMSNorm(dim_head, heads)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, T, _ = x.shape
        q, k, v = (t.reshape(B, T, self.heads, self.dim_head) for t in self.to_qkv(x).chunk(3, dim=-1))
        out = self.sdpa(self.q_norm(q), self.k_norm(k), v, None, None)
        return out.reshape(B, T, self.heads * self.dim_head)


class DiTFeedForward(FeedForward):
    """Dense (x mult) -> SiLU -> Dense; its kernels are xavier-uniform."""

    def __init__(self, dim: int, mult: int = 4) -> None:
        super().__init__(dim, mult)


class DiTBlock(nn.Module):
    """adaLN-Zero: a 6-way modulation of the conditioning vector shifts,
    scales and gates the attention and the feed-forward residuals."""

    def __init__(self, dim_h: int, heads: int, dim_head: int, mult: int = 4) -> None:
        super().__init__()
        self.modulation = nn.Linear(dim_h, dim_h * 6)
        self.attn = DiTAttention(dim_h, heads, dim_head)
        self.ff = DiTFeedForward(dim_h, mult)

    def forward(self, x: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
        s_msa, sc_msa, g_msa, s_ff, sc_ff, g_ff = self.modulation(F.silu(c)).chunk(6, dim=-1)
        x = x + g_msa[:, None, :] * self.attn(modulate(layer_norm(x), s_msa, sc_msa))
        return x + g_ff[:, None, :] * self.ff(modulate(layer_norm(x), s_ff, sc_ff))


class DiTFinalLayer(nn.Module):
    """adaLN shift/scale, then a dense projection."""

    def __init__(self, dim_h: int, dim_out: int) -> None:
        super().__init__()
        self.modulation = nn.Linear(dim_h, dim_h * 2)
        self.linear = nn.Linear(dim_h, dim_out)

    def forward(self, x: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
        shift, scale = self.modulation(F.silu(c)).chunk(2, dim=-1)
        return self.linear(modulate(layer_norm(x), shift, scale))


class DiT(nn.Module):
    """x (B, T, 6), a (B, T, 96) raw spectrogram, t (B,), c (B, 5), cond_mask
    (B,) bool. Returns (B, T, 6) float32; the UNet's call surface
    (``audio_encoded`` is accepted and ignored: DiT reads the raw spectrogram
    at every call). Computes in the dtype of its parameters."""

    def __init__(self, cfg: ModelConfig) -> None:
        super().__init__()
        check_width(cfg, "DiT")
        self.cfg = cfg
        h = cfg.dim_h
        self.preprocess = CrossEmbedLayer(cfg.dim_in_x + cfg.dim_in_a, h, cfg.cross_embed_kernel_sizes)
        self.feature_extractor_a = nn.Linear(cfg.dim_in_a * 2, h)
        self.mlp_audio_0 = nn.Linear(h, h)
        self.mlp_audio_1 = nn.Linear(h, h)
        self.mlp_time_0 = nn.Linear(h, h, bias=False)
        self.mlp_time_1 = nn.Linear(h, h, bias=False)
        self.mlp_cond_0 = nn.Linear(cfg.dim_in_c, h)
        self.mlp_cond_1 = nn.Linear(h, h)
        self.null_cond = nn.Parameter(torch.zeros(h))  # drawn by reset_parameters
        for i in range(cfg.depth):
            self.add_module(f"block_{i}", DiTBlock(h, cfg.attn_heads, cfg.attn_dim_head))
        self.final = DiTFinalLayer(h, h)
        self.postprocess = nn.Linear(h, cfg.dim_in_x, bias=False)
        self.reset_parameters()

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        """Draw every parameter as the JAX package's ``init`` does: the stem's
        convs ``lecun_normal``, the conditioning MLPs ``normal(0.02)``, the
        modulations and the output projection zero, every other kernel
        ``xavier_uniform``; biases zero, RMSNorm gammas one, ``null_cond`` from
        N(0, 1)."""
        blocks = [getattr(self, f"block_{i}") for i in range(self.cfg.depth)]
        init_dense([m for m in self.modules() if isinstance(m, nn.Linear)], "xavier", generator)
        init_dense([getattr(self.preprocess, f"Conv_{i}") for i in range(self.preprocess.n)], "lecun", generator)
        init_dense([self.feature_extractor_a, self.mlp_audio_0, self.mlp_audio_1, self.mlp_time_0, self.mlp_time_1,
                    self.mlp_cond_0, self.mlp_cond_1], "normal", generator)
        init_dense([*(b.modulation for b in blocks), self.final.modulation, self.postprocess], "zeros", generator)
        for m in self.modules():
            if isinstance(m, MultiHeadRMSNorm):
                m.gamma.fill_(1.0)
        self.null_cond.normal_(generator=generator)

    @property
    def dtype(self) -> torch.dtype:
        return self.null_cond.dtype

    def forward(self, x: torch.Tensor, a: torch.Tensor, t: torch.Tensor, c: torch.Tensor,
                cond_mask: Optional[torch.Tensor] = None, audio_encoded: bool = False) -> torch.Tensor:
        n = x.shape[1]
        x, a = x.to(self.dtype), a.to(self.dtype)
        h = self.preprocess(torch.cat([x, a], dim=-1))
        h_a = self.feature_extractor_a(pooled_audio(a))
        h_a = self.mlp_audio_1(F.silu(self.mlp_audio_0(h_a)))
        t_emb = sinusoidal_embedding(t, self.cfg.dim_h).to(self.dtype)
        t_emb = self.mlp_time_1(F.silu(self.mlp_time_0(t_emb)))
        c_emb = self.mlp_cond_1(F.silu(self.mlp_cond_0(c.to(self.dtype))))
        if cond_mask is not None:
            c_emb = torch.where(cond_mask[:, None], c_emb, self.null_cond.to(c_emb.dtype))
        cond = c_emb + t_emb + h_a
        for i in range(self.cfg.depth):
            block = getattr(self, f"block_{i}")
            h = remat(block, h, cond) if self.cfg.remat else block(h, cond)
        out = self.postprocess(self.final(h, cond))
        return out[:, :n, :].float()
