"""UNet building blocks (``osufusion_tpu/nn/blocks.py``), channel-last (B, T, C)
at every public forward.

Submodules carry the JAX package's parameter names (``Dense_0``, ``Conv_0``,
``GroupNorm_0``, ``FiLMBlock_1``, ``to_q`` ...), so a JAX checkpoint maps onto
a ``state_dict`` by renaming leaves and transposing kernels
(``utils/convert.py``). ``MatmulConv`` becomes ``nn.Conv1d``: its shifted-matmul
form exists only for the TPU's matrix unit. Input widths the flax modules infer
at first call are constructor arguments here.

Under a sequence shard (``parallel/sequence.py``) the modules hold this rank's
frames, and the steps that cross a shard boundary are written out, each exact
against the one-device op: a padding convolution exchanges k // 2 frames with
the neighbours and pads nothing; ``Downsample`` takes one frame from the right
neighbour and reflects only at the song's end; GroupNorm's statistics,
GlobalContext's softmax over T and the squeeze-excite mean are sums over the
group; attention uses the song's length for its RoPE tables and its window.
"""

from __future__ import annotations

import functools
import math
from typing import Callable, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint, create_selective_checkpoint_contexts

from osufusion_tpu_torch.ops.attention import sdpa
from osufusion_tpu_torch.ops.rope import rope_tables
from osufusion_tpu_torch.parallel.sequence import active_shard, all_reduce_max, all_reduce_sum, exchange_halo

# Rematerialisation policies (``jax.checkpoint``'s ``policy``): the outputs of
# the listed operations are kept from the forward, everything else is computed
# again in the backward. They see what the dispatcher sees, which is why the
# attention is a ``torch.library.custom_op``.
# ``save_only_these_names("flash_o", "flash_lse")``: the attention's o, LSE and
# rotated k stay (the halo op's o and LSE at a sequence-sharded site), so the
# backward never runs the attention forward again
KEEP_ATTENTION_OUTPUTS = functools.partial(
    create_selective_checkpoint_contexts,
    [torch.ops.osufusion_tpu_torch.flash_attention.default, torch.ops.osufusion_tpu_torch.halo_attention.default])
# ``dots_saveable``: convolutions (matrix products in the JAX package) and matrix products
_aten = torch.ops.aten
KEEP_DOTS = functools.partial(
    create_selective_checkpoint_contexts,
    [_aten.convolution.default, _aten.mm.default, _aten.addmm.default, _aten.bmm.default])


def remat(module: Callable, *args, policy: Optional[Callable] = None):
    """Call ``module`` under rematerialisation (``jax.checkpoint`` in the JAX
    package): its activations are dropped after the forward and recomputed in
    the backward, except what ``policy`` (one of the above) keeps.
    Non-reentrant, so an argument may be None; no RNG state is kept, because
    no module draws random numbers. Without a gradient it is a plain call."""
    if not torch.is_grad_enabled():
        return module(*args)
    kwargs = {} if policy is None else {"context_fn": policy}
    return checkpoint(module, *args, use_reentrant=False, preserve_rng_state=False, **kwargs)


def conv_cl(conv: nn.Conv1d, x: torch.Tensor) -> torch.Tensor:
    """Apply a (B, C, T) convolution to channel-last x. Under a sequence
    shard a padding convolution takes its padding from the neighbours."""
    shard = active_shard()
    pad = conv.padding[0]
    if shard is None or pad == 0:
        return conv(x.transpose(1, 2)).transpose(1, 2)
    return valid_conv(conv, exchange_halo(x, pad, pad, shard))


def valid_conv(conv: nn.Conv1d, x: torch.Tensor) -> torch.Tensor:
    """``conv`` without its padding on channel-last x."""
    return F.conv1d(x.transpose(1, 2), conv.weight, conv.bias, conv.stride).transpose(1, 2)


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
        convs = [getattr(self, f"Conv_{i}") for i in range(self.n)]
        shard = active_shard()
        if shard is None:
            xt = x.transpose(1, 2)
            return torch.cat([conv(xt) for conv in convs], dim=1).transpose(1, 2)
        # one exchange of the widest kernel's halo serves every kernel
        halo = max(conv.padding[0] for conv in convs)
        xe = exchange_halo(x, halo, halo, shard)
        cut = [halo - conv.padding[0] for conv in convs]
        return torch.cat([valid_conv(conv, xe[:, c : xe.shape[1] - c]) for conv, c in zip(convs, cut)], dim=-1)


class Downsample(nn.Module):
    """Reflect-pad one frame on the right, then a VALID stride-2 conv3."""

    def __init__(self, dim_in: int, dim_out: int) -> None:
        super().__init__()
        self.Conv_0 = nn.Conv1d(dim_in, dim_out, 3, stride=2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        shard = active_shard()
        if shard is None:
            return self.Conv_0(F.pad(x.transpose(1, 2), (0, 1), mode="reflect")).transpose(1, 2)
        if x.shape[1] % 2:
            raise ValueError(f"a sequence shard of {x.shape[1]} frames cannot be halved")
        x_ext = exchange_halo(x, 0, 1, shard)  # every rank sends its first frame left
        if shard.index == shard.count - 1:
            # the song's end reflects; the exchange stays in the graph, so that its
            # backward, which takes the left neighbour's gradient, runs here too
            x_ext = torch.cat([x_ext[:, :-1], x[:, -2:-1]], dim=1)
        return valid_conv(self.Conv_0, x_ext)


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
        return conv_cl(self.Conv_0, x) + conv_cl(self.Conv_1, x)


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
        logits = self.Dense_0(x).float()  # (B, T, 1)
        shard = active_shard()
        if shard is None:
            w = torch.softmax(logits, dim=1).to(x.dtype)
            pooled = torch.einsum("btc,btk->bkc", x, w)  # (B, 1, C)
        else:  # the softmax over the song's frames, and the pooled sum, over the group
            e = torch.exp(logits - all_reduce_max(logits.amax(dim=1, keepdim=True), shard))
            w = (e / all_reduce_sum(e.sum(dim=1, keepdim=True), shard)).to(x.dtype)
            part = torch.einsum("btc,btk->bkc", x, w)
            pooled = all_reduce_sum(part.float(), shard).to(part.dtype)
        return torch.sigmoid(self.Dense_2(F.silu(self.Dense_1(pooled))))


class SqueezeExcite(nn.Module):
    """Average-pool squeeze-excite gate."""

    def __init__(self, dim: int, dim_out: int, reduction: int = 2, dim_min: int = 8) -> None:
        super().__init__()
        inner = max(dim_min, dim_out // reduction)
        self.Dense_0 = nn.Linear(dim, inner)
        self.Dense_1 = nn.Linear(inner, dim_out)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        shard = active_shard()
        if shard is None:
            pooled = x.mean(dim=1, keepdim=True)
        else:
            total = all_reduce_sum(x.float().sum(dim=1, keepdim=True), shard)
            pooled = (total / (x.shape[1] * shard.count)).to(x.dtype)
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
        shard = active_shard()
        if shard is None:
            var, mean = torch.var_mean(xf, dim=(1, 2), correction=0, keepdim=True)
        else:  # two passes over the group, as var_mean's own numerics: the mean, then centred squares
            n = xf.shape[1] * xf.shape[2] * shard.count
            mean = all_reduce_sum(xf.sum(dim=(1, 2), keepdim=True), shard) / n
            var = all_reduce_sum((xf - mean).square().sum(dim=(1, 2), keepdim=True), shard) / n
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
    The window (= context_len) engages only when T > context_len, T the
    song's length (under a sequence shard, every shard's frames together).
    ``self.sdpa`` is the attention function, ``ops.attention.sdpa``; a check
    that wants the plain version on the GPU sets it on the module."""

    def __init__(self, dim: int, dim_head: int = 64, heads: int = 16, kv_heads: int = 1,
                 context_len: int = 4096, local: bool = True) -> None:
        super().__init__()
        self.dim_head, self.heads, self.kv_heads = dim_head, heads, kv_heads
        self.context_len, self.local = context_len, local
        self.sdpa = sdpa
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
        shard = active_shard()
        t_song = T * shard.count if shard is not None else T
        rope = rope_tables(t_song, self.dim_head, scale_base=self.context_len, device=x.device)
        window = self.context_len if (self.local and t_song > self.context_len) else None
        out = self.sdpa(q, k, v, window, rope)
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
    """Attention (inner residual), then the FF residual. ``remat_ff``
    rematerialises the feed-forward alone; the attention module stays outside,
    so its kernel's saved output and LSE serve the backward."""

    def __init__(self, dim: int, ff_mult: int = 2, attn_dim_head: int = 64, attn_heads: int = 16,
                 attn_kv_heads: int = 1, attn_context_len: int = 4096, attn_local: bool = True,
                 remat_ff: bool = False) -> None:
        super().__init__()
        self.remat_ff = remat_ff
        self.attn = Attention(dim, attn_dim_head, attn_heads, attn_kv_heads, attn_context_len, attn_local)
        self.ff = FeedForward(dim, ff_mult)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.attn(x)
        return (remat(self.ff, x) if self.remat_ff else self.ff(x)) + x
