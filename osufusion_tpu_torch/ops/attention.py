"""Attention dispatch and the plain grouped-query attention
(``osufusion_tpu/ops/attention.py``).

``sdpa`` sends a CUDA tensor to the hand-written flash kernels (MQA, GQA and
full MHA, with or without rotary tables), and so it does every self-attention
site on the CPU that needs a gradient: both go through ``flash_attention``
(a windowed site with several KV heads once per KV head) and
``flash_attention_op``, which runs the kernels' plain versions on CPU tensors,
so one route serves both devices and a rematerialisation policy that keeps
the op's outputs is the same on both. Any other CPU tensor takes the plain
forward with native autograd. On the card the form rule
(``ops/flash_forms.py::attention_form``, on the operands' dtype and head dim)
decides first, before any launch or gather: bf16 with D = 64, 128, 192 or 256
runs the wgmma kernels forward and at global sites backward (the windowed
backward pair at D > 64 runs the forms kernels); fp32 and fp16 operands at
any of those head dims the forms kernels, and a head dim above 256 that is a
multiple of 64 their chunked instance; a head dim that is not a multiple of
64 runs what the JAX package runs there, rope and then the plain grouped
attention with native autograd (the XLA einsum of
``osufusion_tpu/ops/attention.py``, which no Pallas kernel computes). The CPU
route takes every form, as before.
Under a sequence shard (``parallel/sequence.py``) a windowed site that the
halo kernels take runs them on this rank's frames, once per KV head on that
head's query heads (as ``osufusion_tpu/parallel/sequence.py`` splits a GQA
site); a global site that the ring takes (``parallel/ring.py``: the window
off or covering the song, shards of a multiple of 64 frames) runs the ring
attention, every KV head at once, as ``osufusion_tpu/ops/attention.py`` routes
it; only a site that neither takes gathers the whole sequence, attends as on
one device and keeps this rank's rows, which is what GSPMD does in the JAX
package where no sharded kernel applies.
``gqa_attention`` is the plain forward's math: KV heads stay un-repeated,
logits and softmax are float32, and queries are taken in chunks so a
full-song sequence never materialises a (B, H, T, S) logits tensor.
"""

from __future__ import annotations

import torch

from osufusion_tpu_torch.ops.flash_attention import flash_attention, flash_attention_reference, needs_gradient
from osufusion_tpu_torch.ops.flash_forms import attention_form
from osufusion_tpu_torch.ops.rope import apply_rope
from osufusion_tpu_torch.parallel.ring import ring_attention, ring_available
from osufusion_tpu_torch.parallel.sequence import (
    active_shard,
    all_gather_frames,
    frames_of,
    seq_parallel_available,
    sequence_parallel_attention,
)

# queries per chunk of the plain path: bounds its logits to
# (B, H, QUERY_CHUNK, keys) however long the sequence is
QUERY_CHUNK = 1024


def sdpa(
    q: torch.Tensor,  # (B, T, H, D), unrotated
    k: torch.Tensor,  # (B, S, Kv, D), unrotated
    v: torch.Tensor,  # (B, S, Kv, D)
    window: int | None,
    rope: tuple | None = None,  # (cos, sin) tables (T, D), or None: no rotary embedding (DiT, MMDiT)
) -> torch.Tensor:
    """Attention, rotary-embedded when given tables, optionally windowed (each
    query sees keys within +/- window/2). Returns (B, T, H, D) in q's dtype.
    Under a sequence shard q, k and v hold this rank's frames and the tables
    cover the whole song. On the card an operand dtype that no kernel takes
    raises here, before any launch or gather."""
    if q.is_cuda:
        attention_form(q.dtype, q.shape[-1])
    shard = active_shard()
    if shard is None:
        return _local_sdpa(q, k, v, window, rope)
    if seq_parallel_available(q.shape[1], window, q.shape[-1], shard.count):
        cos, sin = (frames_of(t, shard, dim=0).float() for t in rope)
        q_rot = apply_rope(q.float(), cos, sin).to(q.dtype)
        k_rot = apply_rope(k.float(), cos, sin).to(k.dtype)
        kv, G = k.shape[2], q.shape[2] // k.shape[2]
        heads = [sequence_parallel_attention(q_rot[:, :, g * G : (g + 1) * G], k_rot[:, :, g], v[:, :, g], window, shard)
                 for g in range(kv)]
        return heads[0] if kv == 1 else torch.cat(heads, dim=2)
    B, T, H, D = q.shape
    if ring_available(T * shard.count, k.shape[1] * shard.count, D, window, shard.count, H, k.shape[2]):
        return ring_attention(q, k, v, rope, shard)
    whole = (all_gather_frames(t, shard) for t in (q, k, v))
    return frames_of(_local_sdpa(*whole, window, rope), shard)


def _local_sdpa(q, k, v, window, rope) -> torch.Tensor:
    """Attention over the whole sequence at hand: one device's, or the song
    that a shard has gathered."""
    if q.is_cuda and attention_form(q.dtype, q.shape[-1]) == "xla":
        return xla_attention(q, k, v, window, rope)
    if q.is_cuda or (needs_gradient(q, k, v) and k.shape[1] == q.shape[1]):
        return flash_attention(q, k, v, window, rope)
    return flash_attention_reference(q, k, v, window, rope)


def xla_attention(q, k, v, window, rope) -> torch.Tensor:
    """A site whose head dim no kernel tiles, on the card: what the JAX
    package runs there (``osufusion_tpu/ops/attention.py:93-97``), rope on q
    and k, then ``gqa_attention`` with native autograd. No Pallas kernel
    computes this route, so none of the port's kernels does."""
    if rope is not None:
        q, k = apply_rope(q, *rope), apply_rope(k, *rope)
    return gqa_attention(q, k, v, window=window)


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
