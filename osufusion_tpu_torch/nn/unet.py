"""The production denoiser (``osufusion_tpu/nn/unet.py``): a 1-D UNet with
transformer blocks and a parallel audio-encoder down-stack, conditioned on
time and difficulty, channel-last (B, T, C) at its public calls.

``encode_audio`` is a separate call, so a sampler encodes the spectrogram once
per generation. Conditioning is an explicit boolean ``cond_mask``: rows where
it is False take the learned ``null_cond`` (CFG's unconditional branch).

Rematerialisation follows the JAX package's plans (``cfg.remat``,
``cfg.remat_mode``) through ``torch.utils.checkpoint``: ``block`` wraps each
UNet block whole, so the backward runs the attention forward kernel again;
``save-attn-out`` wraps it whole too but keeps each attention's output and LSE
(a checkpoint policy), so the backward re-runs the projections and
convolutions and never the attention forward; ``save-attn`` wraps the resnets
and feed-forwards one by one and leaves the attention modules outside, so
everything the attention saved serves the backward; ``ff`` and ``resnet`` wrap
only those; ``resnet-dots`` wraps the resnets and keeps the outputs of their
convolutions and matrix products. ``mixed`` gives each width level its own
mode (``cfg.remat_level_modes``; ``down_i``, the audio stack's ``layer_i`` and
the up block of the same width share level i), and ``cfg.audio_remat_mode``
overrides the audio stack's as a whole.

Under a sequence shard (``parallel/sequence.py``) x and a hold this rank's
frames of the song. The song's length must then be a multiple of the shard
count times 2^depth, so that no level's shard is cut and nothing is padded:
one rank cannot pad the song's end for the others.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from osufusion_tpu_torch.config import ModelConfig
from osufusion_tpu_torch.nn.blocks import (
    KEEP_ATTENTION_OUTPUTS,
    KEEP_DOTS,
    CondEmbedding,
    CrossEmbedLayer,
    Downsample,
    GroupNorm1,
    ParallelConvOut,
    ResidualBlock,
    TimeEmbedding,
    TransformerBlock,
    Upsample,
    conv_cl,
    remat,
)
from osufusion_tpu_torch.parallel.sequence import active_shard

X_PAD_VALUE = -1.0
A_PAD_VALUE = -23.0
# standard deviation of a unit normal truncated at +/- 2 (the constant flax's
# variance_scaling divides by)
TRUNCATED_STD = 0.87962566103423978


REMAT_MODES = ("none", "block", "save-attn", "save-attn-out", "ff", "resnet", "resnet-dots")


def level_remat_mode(cfg: ModelConfig, level: int, audio: bool = False) -> str:
    """The remat mode at width level ``level`` (0 = widest). Under
    ``remat_mode="mixed"`` it is ``remat_level_modes[level]`` (missing entries
    repeat the last); every other mode holds for all levels. The audio stack
    (``audio=True``) takes ``cfg.audio_remat_mode`` when that is set."""
    if not cfg.remat:
        return "none"
    if audio and cfg.audio_remat_mode:
        mode = cfg.audio_remat_mode
    elif cfg.remat_mode != "mixed":
        mode = cfg.remat_mode
    else:
        modes = cfg.remat_level_modes or ("save-attn",)
        mode = modes[min(level, len(modes) - 1)]
    if mode not in REMAT_MODES:
        raise ValueError(f"unknown remat mode: {mode!r}")
    return mode


def _remat_plan(cfg: ModelConfig, level: int = 0, audio: bool = False) -> Tuple[str, str]:
    """(how the whole block is wrapped, inner mode) at width level ``level``.
    The first is "none", "block" or "save-attn-out"; inner is "none", "inner"
    (resnets and FFs: save-attn), "ff", "resnet" or "resnet-dots"."""
    mode = level_remat_mode(cfg, level, audio)
    if mode in ("block", "save-attn-out"):
        return mode, "none"
    return "none", {"save-attn": "inner"}.get(mode, mode)


class UNetBlock(nn.Module):
    """init resnet -> N x (resnet -> transformer) -> down/up sampler.
    ``dim_x`` is the width of the incoming x (an up block's x arrives
    concatenated with its skip). Returns (sampled_x, pre_sample_x).
    ``remat_plan`` is ``_remat_plan``'s pair."""

    BLOCK_POLICY = {"block": None, "save-attn-out": KEEP_ATTENTION_OUTPUTS}

    def __init__(self, dim_x: int, dim_in: int, dim_out: int, dim_cond: Optional[int], layer_idx: int,
                 num_layers: int, num_blocks: int, down_block: bool, cfg: ModelConfig, context_len: int,
                 remat_plan: Tuple[str, str] = ("none", "none")) -> None:
        super().__init__()
        self.num_blocks = num_blocks
        self.remat_block, inner = remat_plan
        self.remat_resnets = inner in ("inner", "resnet", "resnet-dots")
        self.resnet_policy = KEEP_DOTS if inner == "resnet-dots" else None
        self.init_resnet = ResidualBlock(dim_x, dim_in, dim_cond)
        for i in range(num_blocks):
            self.add_module(f"resnet_{i}", ResidualBlock(dim_in, dim_in, dim_cond))
            self.add_module(f"transformer_{i}", TransformerBlock(
                dim_in, attn_dim_head=cfg.attn_dim_head, attn_heads=cfg.attn_heads,
                attn_kv_heads=cfg.attn_kv_heads, attn_context_len=context_len, attn_local=cfg.attn_local,
                remat_ff=inner in ("inner", "ff"),
            ))
        if layer_idx < num_layers - 1:
            self.sampler = (Downsample if down_block else Upsample)(dim_in, dim_out)
        else:
            self.sampler = ParallelConvOut(dim_in, dim_out)

    def forward(self, x: torch.Tensor, t: Optional[torch.Tensor] = None,
                c: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
        if self.remat_block != "none":
            return remat(self._forward, x, t, c, policy=self.BLOCK_POLICY[self.remat_block])
        return self._forward(x, t, c)

    def _resnet(self, block: ResidualBlock, x, t, c) -> torch.Tensor:
        return remat(block, x, t, c, policy=self.resnet_policy) if self.remat_resnets else block(x, t, c)

    def _forward(self, x, t, c) -> Tuple[torch.Tensor, torch.Tensor]:
        x = self._resnet(self.init_resnet, x, t, c)
        for i in range(self.num_blocks):
            x = self._resnet(getattr(self, f"resnet_{i}"), x, t, c)
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
                self.AUDIO_ATTN_CONTEXT_LEN // (2**i), _remat_plan(cfg, i, audio=True),
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
        self.null_cond = nn.Parameter(torch.zeros(dim_emb))  # drawn by reset_parameters

        dim_cond = 2 * dim_emb
        for i in range(n):
            self.add_module(f"down_{i}", UNetBlock(
                dims_h[i], dims_h[i], dims_h[i + 1], dim_cond, i, n, cfg.num_layer_blocks[i], True, cfg,
                cfg.attn_context_len // (2**i), _remat_plan(cfg, i),
            ))
        top = dims_h[-1]
        bottleneck_ctx = cfg.attn_context_len // (2 ** (n - 1))
        self.middle_resnet1 = ResidualBlock(2 * top, top, dim_cond)  # x concat audio features
        # the middle follows the narrowest level's inner plan: its resnets are
        # never rematerialised, its feed-forwards under save-attn and ff
        mid_inner = _remat_plan(cfg, n - 1)[1]
        for i in range(cfg.num_middle_transformers):
            self.add_module(f"middle_transformer_{i}", TransformerBlock(
                top, attn_dim_head=cfg.attn_dim_head, attn_heads=cfg.attn_heads,
                attn_kv_heads=cfg.attn_kv_heads, attn_context_len=bottleneck_ctx, attn_local=cfg.attn_local,
                remat_ff=mid_inner in ("inner", "ff"),
            ))
        self.middle_resnet2 = ResidualBlock(top, top, dim_cond)

        blocks_rev = tuple(reversed(cfg.num_layer_blocks))
        for i in range(n):
            # up block i sits at width level n - 1 - i (the last is the widest)
            dim_in, dim_out = dims_h[n - i], dims_h[n - 1 - i]
            self.add_module(f"up_{i}", UNetBlock(
                dim_in + dim_out, dim_in, dim_out, dim_cond, i, n, blocks_rev[i], False, cfg,
                cfg.attn_context_len // (2 ** (n - i - 1)), _remat_plan(cfg, n - 1 - i),
            ))

        self.final_resnet = ResidualBlock(2 * cfg.dim_h, cfg.dim_h, dim_cond)
        self.final_conv = nn.Conv1d(cfg.dim_h, cfg.dim_in_x, 1)
        self.reset_parameters()

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        """Draw every parameter as the JAX package's ``init`` does: conv and
        dense kernels from flax's ``lecun_normal`` (a normal truncated at two
        standard deviations and rescaled to variance 1 / fan_in, fan_in =
        kernel size x input channels), biases zero, norms at (1, 0),
        ``null_cond`` from N(0, 1), the final conv zero."""
        for module in self.modules():
            if isinstance(module, (nn.Conv1d, nn.Linear)):
                fan_in = module.weight[0].numel()
                std = fan_in**-0.5 / TRUNCATED_STD
                nn.init.trunc_normal_(module.weight, std=std, a=-2 * std, b=2 * std, generator=generator)
                if module.bias is not None:
                    module.bias.zero_()
            elif isinstance(module, (nn.LayerNorm, GroupNorm1)):
                module.weight.fill_(1.0)
                module.bias.zero_()
        self.null_cond.normal_(generator=generator)
        self.final_conv.weight.zero_()

    @property
    def dtype(self) -> torch.dtype:
        return self.null_cond.dtype

    def _pad_len(self, n: int) -> int:
        """Frames to pad a sequence of n frames with; under a sequence shard n
        is this rank's and the answer is 0, or a ValueError."""
        mult = 2**self.n
        shard = active_shard()
        if shard is None:
            return (mult - n % mult) % mult
        if n % mult:
            raise ValueError(f"a sequence-sharded song of {n * shard.count} frames must be a multiple of "
                             f"{shard.count} shards x 2^{self.n} = {shard.count * mult} frames")
        return 0

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
