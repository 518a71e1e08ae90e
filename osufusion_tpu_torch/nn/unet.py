"""The production denoiser (``osufusion_tpu/nn/unet.py``): a 1-D UNet with
transformer blocks and a parallel audio-encoder down-stack, conditioned on
time and difficulty, channel-last (B, T, C) at its public calls.

``encode_audio`` is a separate call, so a sampler encodes the spectrogram once
per generation. Conditioning is an explicit boolean ``cond_mask``: rows where
it is False take the learned ``null_cond`` (CFG's unconditional branch).
Serving runs no rematerialisation, so the JAX package's remat plans have no
counterpart here.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from osufusion_tpu_torch.config import ModelConfig
from osufusion_tpu_torch.nn.blocks import (
    CondEmbedding,
    CrossEmbedLayer,
    Downsample,
    ParallelConvOut,
    ResidualBlock,
    TimeEmbedding,
    TransformerBlock,
    Upsample,
    conv_cl,
)

X_PAD_VALUE = -1.0
A_PAD_VALUE = -23.0


class UNetBlock(nn.Module):
    """init resnet -> N x (resnet -> transformer) -> down/up sampler.
    ``dim_x`` is the width of the incoming x (an up block's x arrives
    concatenated with its skip). Returns (sampled_x, pre_sample_x)."""

    def __init__(self, dim_x: int, dim_in: int, dim_out: int, dim_cond: Optional[int], layer_idx: int,
                 num_layers: int, num_blocks: int, down_block: bool, cfg: ModelConfig, context_len: int) -> None:
        super().__init__()
        self.num_blocks = num_blocks
        self.init_resnet = ResidualBlock(dim_x, dim_in, dim_cond)
        for i in range(num_blocks):
            self.add_module(f"resnet_{i}", ResidualBlock(dim_in, dim_in, dim_cond))
            self.add_module(f"transformer_{i}", TransformerBlock(
                dim_in, attn_dim_head=cfg.attn_dim_head, attn_heads=cfg.attn_heads,
                attn_kv_heads=cfg.attn_kv_heads, attn_context_len=context_len, attn_local=cfg.attn_local,
            ))
        if layer_idx < num_layers - 1:
            self.sampler = (Downsample if down_block else Upsample)(dim_in, dim_out)
        else:
            self.sampler = ParallelConvOut(dim_in, dim_out)

    def forward(self, x: torch.Tensor, t: Optional[torch.Tensor] = None,
                c: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
        x = self.init_resnet(x, t, c)
        for i in range(self.num_blocks):
            x = getattr(self, f"resnet_{i}")(x, t, c)
            x = getattr(self, f"transformer_{i}")(x)
        return self.sampler(x), x


class AudioEncoder(nn.Module):
    """Parallel down-stack for the spectrogram: the UNet's down topology with
    no time/condition embedding. Its attention context is pinned to 4096 at
    level 0 whatever the config says, as in the JAX package."""

    AUDIO_ATTN_CONTEXT_LEN = 4096

    def __init__(self, cfg: ModelConfig) -> None:
        super().__init__()
        dims_h = (cfg.dim_h, *[cfg.dim_h * m for m in cfg.dim_h_mult])
        n = len(cfg.dim_h_mult)
        self.n = n
        self.init_conv = CrossEmbedLayer(cfg.dim_in_a, cfg.dim_h, cfg.cross_embed_kernel_sizes)
        for i in range(n):
            self.add_module(f"layer_{i}", UNetBlock(
                dims_h[i], dims_h[i], dims_h[i + 1], None, i, n, cfg.num_layer_blocks[i], True, cfg,
                self.AUDIO_ATTN_CONTEXT_LEN // (2**i),
            ))

    def forward(self, a: torch.Tensor) -> torch.Tensor:
        x = self.init_conv(a)
        for i in range(self.n):
            x, _ = getattr(self, f"layer_{i}")(x)
        return x


class UNet(nn.Module):
    """x (B, T, 6), a (B, T, 96) or pre-encoded (B, T/2^(depth-1), dim_h*mult[-1]),
    t (B,), c (B, 5), cond_mask (B,) bool. Returns (B, T, 6) float32.

    The module computes in the dtype of its parameters (``cfg.compute_dtype``
    once moved there); norms and softmaxes take their statistics in fp32."""

    def __init__(self, cfg: ModelConfig) -> None:
        super().__init__()
        self.cfg = cfg
        dim_emb = cfg.dim_h * 4
        dims_h = (cfg.dim_h, *[cfg.dim_h * m for m in cfg.dim_h_mult])
        n = len(cfg.dim_h_mult)
        self.n = n

        self.init_x = CrossEmbedLayer(cfg.dim_in_x, cfg.dim_h, cfg.cross_embed_kernel_sizes)
        self.audio_encoder = AudioEncoder(cfg)
        self.time_mlp = TimeEmbedding(dim_emb)
        self.cond_mlp = CondEmbedding(cfg.dim_in_c, dim_emb)
        self.null_cond = nn.Parameter(torch.randn(dim_emb))

        dim_cond = 2 * dim_emb
        for i in range(n):
            self.add_module(f"down_{i}", UNetBlock(
                dims_h[i], dims_h[i], dims_h[i + 1], dim_cond, i, n, cfg.num_layer_blocks[i], True, cfg,
                cfg.attn_context_len // (2**i),
            ))
        top = dims_h[-1]
        bottleneck_ctx = cfg.attn_context_len // (2 ** (n - 1))
        self.middle_resnet1 = ResidualBlock(2 * top, top, dim_cond)  # x concat audio features
        for i in range(cfg.num_middle_transformers):
            self.add_module(f"middle_transformer_{i}", TransformerBlock(
                top, attn_dim_head=cfg.attn_dim_head, attn_heads=cfg.attn_heads,
                attn_kv_heads=cfg.attn_kv_heads, attn_context_len=bottleneck_ctx, attn_local=cfg.attn_local,
            ))
        self.middle_resnet2 = ResidualBlock(top, top, dim_cond)

        blocks_rev = tuple(reversed(cfg.num_layer_blocks))
        for i in range(n):
            dim_in, dim_out = dims_h[n - i], dims_h[n - 1 - i]
            self.add_module(f"up_{i}", UNetBlock(
                dim_in + dim_out, dim_in, dim_out, dim_cond, i, n, blocks_rev[i], False, cfg,
                cfg.attn_context_len // (2 ** (n - i - 1)),
            ))

        self.final_resnet = ResidualBlock(2 * cfg.dim_h, cfg.dim_h, dim_cond)
        self.final_conv = nn.Conv1d(cfg.dim_h, cfg.dim_in_x, 1)
        nn.init.zeros_(self.final_conv.weight)
        nn.init.zeros_(self.final_conv.bias)

    @property
    def dtype(self) -> torch.dtype:
        return self.null_cond.dtype

    def _pad_len(self, n: int) -> int:
        mult = 2**self.n
        return (mult - n % mult) % mult

    def encode_audio(self, a: torch.Tensor) -> torch.Tensor:
        """(B, T, 96) spectrogram -> bottleneck features (B, T/2^(d-1), top_dim).
        Pads T to a multiple of 2^depth with the silence value first."""
        pad_len = self._pad_len(a.shape[1])
        if pad_len:
            a = F.pad(a, (0, 0, 0, pad_len), value=A_PAD_VALUE)
        return self.audio_encoder(a.to(self.dtype))

    def forward(self, x: torch.Tensor, a: torch.Tensor, t: torch.Tensor, c: torch.Tensor,
                cond_mask: Optional[torch.Tensor] = None, audio_encoded: bool = False) -> torch.Tensor:
        n = x.shape[1]
        pad_len = self._pad_len(n)
        if pad_len:
            x = F.pad(x, (0, 0, 0, pad_len), value=X_PAD_VALUE)
        x = x.to(self.dtype)
        a_enc = a if audio_encoded else self.encode_audio(a)

        x = self.init_x(x)
        r = x
        t_emb = self.time_mlp(t)
        c_emb = self.cond_mlp(c.to(self.dtype))
        if cond_mask is not None:
            c_emb = torch.where(cond_mask[:, None], c_emb, self.null_cond.to(c_emb.dtype))

        skips = []
        for i in range(self.n):
            x, skip = getattr(self, f"down_{i}")(x, t_emb, c_emb)
            skips.append(skip)

        x = torch.cat([x, a_enc.to(x.dtype)], dim=-1)
        x = self.middle_resnet1(x, t_emb, c_emb)
        for i in range(self.cfg.num_middle_transformers):
            x = getattr(self, f"middle_transformer_{i}")(x)
        x = self.middle_resnet2(x, t_emb, c_emb)

        for i, skip in enumerate(reversed(skips)):
            x = torch.cat([x, skip], dim=-1)
            x, _ = getattr(self, f"up_{i}")(x, t_emb, c_emb)

        x = torch.cat([x, r], dim=-1)
        x = self.final_resnet(x, t_emb, c_emb)
        out = conv_cl(self.final_conv, x)
        return out[:, :n, :].float()
