"""UNet building blocks (``osufusion_tpu/nn/blocks.py``), channel-last (B, T, C)
at every public forward.

Submodules carry the JAX package's parameter names (``Dense_0``, ``Conv_0``,
``GroupNorm_0``, ``FiLMBlock_1``, ``to_q`` ...), so a JAX checkpoint maps onto
a ``state_dict`` by renaming leaves and transposing kernels
(``utils/convert.py``). ``MatmulConv`` becomes ``nn.Conv1d``: its shifted-matmul
form exists only for the TPU's matrix unit. Input widths the flax modules infer
at first call are constructor arguments here.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from osufusion_tpu_torch.ops.attention import sdpa
from osufusion_tpu_torch.ops.rope import rope_tables


def conv_cl(conv: nn.Conv1d, x: torch.Tensor) -> torch.Tensor:
    """Apply a (B, C, T) convolution to channel-last x."""
    return conv(x.transpose(1, 2)).transpose(1, 2)


def sinusoidal_embedding(t: torch.Tensor, dim: int, theta: float = 10000.0) -> torch.Tensor:
    """(B,) timesteps -> (B, dim) sinusoidal embedding (fp32)."""
    half_dim = dim // 2
    emb = math.log(theta) / (half_dim - 1)
    emb = torch.exp(torch.arange(half_dim, dtype=torch.float32, device=t.device) * -emb)
    emb = t.float()[:, None] * emb[None, :]
    return torch.cat([emb.sin(), emb.cos()], dim=-1)


class TimeEmbedding(nn.Module):
    """Sinusoidal embedding -> 2-layer MLP."""

    def __init__(self, dim_emb: int) -> None:
        super().__init__()
        self.dim_emb = dim_emb
        self.Dense_0 = nn.Linear(dim_emb, dim_emb)
        self.Dense_1 = nn.Linear(dim_emb, dim_emb)

    def forward(self, t: torch.Tensor) -> torch.Tensor:
        x = sinusoidal_embedding(t, self.dim_emb).to(self.Dense_0.weight.dtype)
        return self.Dense_1(F.silu(self.Dense_0(x)))


class CondEmbedding(nn.Module):
    """Conditioning-vector MLP."""

    def __init__(self, dim_in: int, dim_emb: int) -> None:
        super().__init__()
        self.Dense_0 = nn.Linear(dim_in, dim_emb)
        self.Dense_1 = nn.Linear(dim_emb, dim_emb)

    def forward(self, c: torch.Tensor) -> torch.Tensor:
        return self.Dense_1(F.silu(self.Dense_0(c)))


class CrossEmbedLayer(nn.Module):
    """Multi-kernel parallel conv stem. Channels split by the INPUT width
    (``dim_in // 2**i``, the rest to the widest kernel), falling back to the
    output width when that leaves the last kernel no channels; kernel sizes
    sorted, padding k // 2."""

    def __init__(self, dim_in: int, dim_out: int, kernel_sizes: Sequence[int] = (3, 7, 15)) -> None:
        super().__init__()
        kernel_sizes = sorted(kernel_sizes)
        n = len(kernel_sizes)
        dim_scales = [dim_in // (2**i) for i in range(1, n)]
        dim_scales = [*dim_scales, dim_out - sum(dim_scales)]
        if dim_scales[-1] <= 0:
            dim_scales = [dim_out // (2**i) for i in range(1, n)]
            dim_scales = [*dim_scales, dim_out - sum(dim_scales)]
        self.n = n
        for idx, (kernel, dim_scale) in enumerate(zip(kernel_sizes, dim_scales)):
            self.add_module(f"Conv_{idx}", nn.Conv1d(dim_in, dim_scale, kernel, padding=kernel // 2))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xt = x.transpose(1, 2)
        return torch.cat([getattr(self, f"Conv_{i}")(xt) for i in range(self.n)], dim=1).transpose(1, 2)


class Downsample(nn.Module):
    """Reflect-pad one frame on the right, then a VALID stride-2 conv3."""

    def __init__(self, dim_in: int, dim_out: int) -> None:
        super().__init__()
        self.Conv_0 = nn.Conv1d(dim_in, dim_out, 3, stride=2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.Conv_0(F.pad(x.transpose(1, 2), (0, 1), mode="reflect")).transpose(1, 2)


class Upsample(nn.Module):
    """Nearest x2, then conv3."""

    def __init__(self, dim_in: int, dim_out: int) -> None:
        super().__init__()
        self.Conv_0 = nn.Conv1d(dim_in, dim_out, 3, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return conv_cl(self.Conv_0, x.repeat_interleave(2, dim=1))


class ParallelConvOut(nn.Module):
    """Sum of conv3 and conv1 (the last level's sampler)."""

    def __init__(self, dim_in: int, dim_out: int) -> None:
        super().__init__()
        self.Conv_0 = nn.Conv1d(dim_in, dim_out, 3, padding=1)
        self.Conv_1 = nn.Conv1d(dim_in, dim_out, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xt = x.transpose(1, 2)
        return (self.Conv_0(xt) + self.Conv_1(xt)).transpose(1, 2)


class GlobalContext(nn.Module):
    """Softmax-pooled global context (softmax over T in fp32) -> bottleneck
    MLP -> sigmoid gate (B, 1, dim_out)."""

    def __init__(self, dim: int, dim_out: int, reduction: int = 2, dim_min: int = 8) -> None:
        super().__init__()
        inner = max(dim_min, dim_out // reduction)
        self.Dense_0 = nn.Linear(dim, 1)
        self.Dense_1 = nn.Linear(dim, inner)
        self.Dense_2 = nn.Linear(inner, dim_out)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = torch.softmax(self.Dense_0(x).float(), dim=1).to(x.dtype)  # (B, T, 1)
        pooled = torch.einsum("btc,btk->bkc", x, w)  # (B, 1, C)
        return torch.sigmoid(self.Dense_2(F.silu(self.Dense_1(pooled))))


class SqueezeExcite(nn.Module):
    """Average-pool squeeze-excite gate."""

    def __init__(self, dim: int, dim_out: int, reduction: int = 2, dim_min: int = 8) -> None:
        super().__init__()
        inner = max(dim_min, dim_out // reduction)
        self.Dense_0 = nn.Linear(dim, inner)
        self.Dense_1 = nn.Linear(inner, dim_out)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        pooled = x.mean(dim=1, keepdim=True)
        return torch.sigmoid(self.Dense_1(F.silu(self.Dense_0(pooled))))


class GroupNorm1(nn.Module):
    """GroupNorm with one group on channel-last (B, T, C): statistics over T
    and C together, in fp32 (flax ``GroupNorm(num_groups=1)``). Written as
    whole-tensor reductions because ``nn.GroupNorm`` with one group gives the
    GPU only B rows to work on: at the serving shape it took more than half
    of each UNet call (PERF.md)."""

    def __init__(self, dim: int, eps: float = 1e-5) -> None:
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        var, mean = torch.var_mean(xf, dim=(1, 2), correction=0, keepdim=True)
        y = (xf - mean) * torch.rsqrt(var + self.eps) * self.weight.float() + self.bias.float()
        return y.to(x.dtype)


class FiLMBlock(nn.Module):
    """conv3 -> GroupNorm(1) over (T, C) -> scale-shift FiLM -> SiLU."""

    def __init__(self, dim_in: int, dim_out: int) -> None:
        super().__init__()
        self.Conv_0 = nn.Conv1d(dim_in, dim_out, 3, padding=1)
        self.GroupNorm_0 = GroupNorm1(dim_out)

    def forward(self, x: torch.Tensor, scale_shift: Optional[Tuple[torch.Tensor, torch.Tensor]] = None) -> torch.Tensor:
        h = self.GroupNorm_0(conv_cl(self.Conv_0, x))
        if scale_shift is not None:
            scale, shift = scale_shift
            h = h * (scale[:, None, :] + 1) + shift[:, None, :]
        return F.silu(h)


class ResidualBlock(nn.Module):
    """Two FiLM blocks + squeeze-excite gate + skip. ``dim_cond`` is the width
    of the concatenated time/condition embeddings, None without them."""

    def __init__(self, dim_in: int, dim_out: int, dim_cond: Optional[int] = None, use_gca: bool = True) -> None:
        super().__init__()
        self.Dense_0 = nn.Linear(dim_cond, dim_out * 2) if dim_cond is not None else None
        self.FiLMBlock_0 = FiLMBlock(dim_in, dim_out)
        self.FiLMBlock_1 = FiLMBlock(dim_out, dim_out)
        self.gate_name = "GlobalContext_0" if use_gca else "SqueezeExcite_0"
        self.add_module(self.gate_name, (GlobalContext if use_gca else SqueezeExcite)(dim_out, dim_out))
        self.Conv_0 = nn.Conv1d(dim_in, dim_out, 1) if dim_in != dim_out else None

    def forward(self, x: torch.Tensor, t: Optional[torch.Tensor] = None, c: Optional[torch.Tensor] = None) -> torch.Tensor:
        scale_shift = None
        if self.Dense_0 is not None and (t is not None or c is not None):
            emb = self.Dense_0(F.silu(torch.cat([e for e in (t, c) if e is not None], dim=-1)))
            scale_shift = emb.chunk(2, dim=-1)
        h = self.FiLMBlock_0(x, scale_shift)
        h = self.FiLMBlock_1(h)
        h = h * getattr(self, self.gate_name)(h)
        if self.Conv_0 is not None:
            x = conv_cl(self.Conv_0, x)
        return h + x


class Attention(nn.Module):
    """Pre-LN MQA/GQA self-attention with length-rescaled RoPE. The residual
    adds the attention output to the NORMALIZED input, as the JAX block does.
    The window (= context_len) engages only when T > context_len."""

    def __init__(self, dim: int, dim_head: int = 64, heads: int = 16, kv_heads: int = 1,
                 context_len: int = 4096, local: bool = True) -> None:
        super().__init__()
        self.dim_head, self.heads, self.kv_heads = dim_head, heads, kv_heads
        self.context_len, self.local = context_len, local
        self.LayerNorm_0 = nn.LayerNorm(dim, eps=1e-5)
        self.to_q = nn.Linear(dim, dim_head * heads, bias=False)
        self.to_kv = nn.Linear(dim, dim_head * kv_heads * 2, bias=False)
        self.to_out = nn.Linear(dim_head * heads, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, T, _ = x.shape
        x = self.LayerNorm_0(x)
        q = self.to_q(x).view(B, T, self.heads, self.dim_head)
        k, v = self.to_kv(x).chunk(2, dim=-1)
        k = k.reshape(B, T, self.kv_heads, self.dim_head)
        v = v.reshape(B, T, self.kv_heads, self.dim_head)
        rope = rope_tables(T, self.dim_head, scale_base=self.context_len, device=x.device)
        window = self.context_len if (self.local and T > self.context_len) else None
        out = sdpa(q, k, v, window, rope)
        return x + self.to_out(out.reshape(B, T, self.heads * self.dim_head))


class FeedForward(nn.Module):
    """Dense -> SiLU -> Dense."""

    def __init__(self, dim: int, mult: int = 2) -> None:
        super().__init__()
        self.Dense_0 = nn.Linear(dim, dim * mult)
        self.Dense_1 = nn.Linear(dim * mult, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.Dense_1(F.silu(self.Dense_0(x)))


class TransformerBlock(nn.Module):
    """Attention (inner residual), then the FF residual."""

    def __init__(self, dim: int, ff_mult: int = 2, attn_dim_head: int = 64, attn_heads: int = 16,
                 attn_kv_heads: int = 1, attn_context_len: int = 4096, attn_local: bool = True) -> None:
        super().__init__()
        self.attn = Attention(dim, attn_dim_head, attn_heads, attn_kv_heads, attn_context_len, attn_local)
        self.ff = FeedForward(dim, ff_mult)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.attn(x)
        return self.ff(x) + x
