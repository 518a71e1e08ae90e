"""Sequence parallelism (``osufusion_tpu/parallel/sequence.py``): the frame
axis of a batch sharded over the processes of a ``seq`` group, for full-song
training on cards too small for a whole song.

Rank i of n holds frames [i T, (i + 1) T) of every activation of the UNet
(T = T_global / n at each level). In the JAX package GSPMD partitions every
layer along that axis; here the few steps that cross a shard boundary are
written out, each exact against its one-device op:

- ``exchange_halo``: a rank's edge frames to its neighbours, zeros at the
  song's ends. Convolutions exchange k // 2 frames and pad nothing; windowed
  attention exchanges W / 2 frames of k and v (``sequence_parallel_attention``,
  the halo kernels of ``ops/halo_attention.py``).
- ``all_reduce_sum``: the sums behind GroupNorm's statistics, GlobalContext's
  softmax over T, the squeeze-excite mean and the loss.
- ``all_gather_frames``: the whole sequence, at an attention site that
  neither the halo path nor the ring (``parallel/ring.py``) can serve (what
  GSPMD does there in the JAX package).

Every one of them is differentiable, under one convention: the objective is
the sum of the rank-local scalars that each rank calls ``backward`` on. The
backward of a sum over the group is then the sum of the gradients over the
group, and the backward of the exchange sends each halo's gradient home and
adds it to the rows it came from (the song's ends drop theirs, as the
transpose of the JAX package's non-wrapping ``ppermute`` does).

``sequence_sharding(shard)`` makes a shard the ambient one, as
``jax.sharding.set_mesh`` does for the JAX step (``train/loop.py``), and the
modules read it with ``active_shard()``. It is a process-wide setting, not a
``ContextVar``: the autograd engine runs CUDA backward passes, and with them
the rematerialised forwards of ``torch.utils.checkpoint``, on threads of its
own, which must see it too. Every rank must run the same collectives in the
same order, recomputation included, which the identical graphs of the ranks
give.

The collectives run on the group's backend: NCCL takes CUDA tensors; gloo
takes host tensors, so a CUDA tensor goes through host memory.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import Optional

import torch
import torch.distributed as dist

from osufusion_tpu_torch.ops.halo_attention import halo_flash_attention


@dataclass(frozen=True)
class SeqShard:
    """This process's place on the ``seq`` axis: ``index`` of ``count``
    shards of the frame axis, and the group of all of them."""

    group: dist.ProcessGroup
    index: int
    count: int

    def g0(self, t_local: int) -> int:
        """The global frame of this shard's first local frame."""
        return self.index * t_local

    def peer(self, index: int) -> int:
        """The global rank of shard ``index``."""
        return dist.get_global_rank(self.group, index)

    def staged(self, t: torch.Tensor) -> bool:
        """Does a collective on t go through host memory (gloo on a CUDA tensor)?"""
        return t.is_cuda and dist.get_backend(self.group) == dist.Backend.GLOO


_ACTIVE: Optional[SeqShard] = None


@contextlib.contextmanager
def sequence_sharding(shard: Optional[SeqShard]):
    """Make ``shard`` the ambient one for the block (None: one device)."""
    global _ACTIVE
    previous, _ACTIVE = _ACTIVE, shard
    try:
        yield shard
    finally:
        _ACTIVE = previous


def active_shard() -> Optional[SeqShard]:
    """The ambient shard when the frame axis is split over more than one
    process, else None."""
    return _ACTIVE if _ACTIVE is not None and _ACTIVE.count > 1 else None


# ------------------------------------------------------------- collectives


def all_reduce_(t: torch.Tensor, shard: SeqShard, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """All-reduce t over the group in place (not differentiable); returns t."""
    if shard.staged(t):
        host = t.cpu()
        dist.all_reduce(host, op, group=shard.group)
        t.copy_(host)
    else:
        dist.all_reduce(t, op, group=shard.group)
    return t


def _p2p(shard: SeqShard, sends: list, recvs: list) -> list:
    """Post every (tensor, shard index) of ``sends`` and ``recvs`` at once and
    wait for them; returns the received tensors, on the device they were
    given on."""
    staged = [shard.staged(t) for t, _ in sends + recvs]
    ops = [dist.P2POp(dist.isend, (t.contiguous().cpu() if s else t.contiguous()), shard.peer(i), group=shard.group)
           for (t, i), s in zip(sends, staged)]
    buffers = [(torch.empty(t.shape, dtype=t.dtype) if s else t) for (t, _), s in zip(recvs, staged[len(sends):])]
    ops += [dist.P2POp(dist.irecv, b, shard.peer(i), group=shard.group) for b, (_, i) in zip(buffers, recvs)]
    if ops:
        for work in dist.batch_isend_irecv(ops):
            work.wait()
    return [b.to(t.device) if b is not t else t for b, (t, _) in zip(buffers, recvs)]


class _ExchangeHalo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, left: int, right: int, shard: SeqShard):
        ctx.frame = (left, right, shard)
        B, T = x.shape[:2]
        i, n = shard.index, shard.count
        from_left = x.new_zeros((B, left, *x.shape[2:]))
        from_right = x.new_zeros((B, right, *x.shape[2:]))
        sends, recvs = [], []
        if left and i + 1 < n:
            sends.append((x[:, T - left:], i + 1))
        if right and i > 0:
            sends.append((x[:, :right], i - 1))
        if left and i > 0:
            recvs.append((from_left, i - 1))
        if right and i + 1 < n:
            recvs.append((from_right, i + 1))
        got = iter(_p2p(shard, sends, recvs))
        if left and i > 0:
            from_left = next(got)
        if right and i + 1 < n:
            from_right = next(got)
        return torch.cat([from_left, x, from_right], dim=1)

    @staticmethod
    def backward(ctx, g):
        left, right, shard = ctx.frame
        i, n = shard.index, shard.count
        T = g.shape[1] - left - right
        grad = g[:, left : left + T].clone()
        sends, recvs = [], []
        if left and i > 0:  # my left halo was my left neighbour's tail
            sends.append((g[:, :left], i - 1))
        if right and i + 1 < n:  # my right halo was my right neighbour's head
            sends.append((g[:, left + T :], i + 1))
        if left and i + 1 < n:
            recvs.append((g.new_empty((g.shape[0], left, *g.shape[2:])), i + 1))
        if right and i > 0:
            recvs.append((g.new_empty((g.shape[0], right, *g.shape[2:])), i - 1))
        got = iter(_p2p(shard, sends, recvs))
        if left and i + 1 < n:
            grad[:, T - left :] += next(got)
        if right and i > 0:
            grad[:, :right] += next(got)
        return grad, None, None, None


def exchange_halo(x: torch.Tensor, left: int, right: int, shard: SeqShard) -> torch.Tensor:
    """(B, T, ...) -> (B, left + T + right, ...): the left neighbour's last
    ``left`` frames, x, the right neighbour's first ``right`` frames; zeros
    beyond the song's ends. A halo reaches one neighbour only, so it may not
    be longer than a shard."""
    if max(left, right) > x.shape[1]:
        raise ValueError(f"a halo of {max(left, right)} frames is longer than the shard's {x.shape[1]}: "
                         "use fewer sequence shards")
    return _ExchangeHalo.apply(x, left, right, shard)


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, shard: SeqShard):
        ctx.shard = shard
        return all_reduce_(x.clone(), shard)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_(g.clone(), ctx.shard), None


def all_reduce_sum(x: torch.Tensor, shard: SeqShard) -> torch.Tensor:
    """The sum of x over the group, on every rank; differentiable."""
    return _AllReduceSum.apply(x, shard)


def all_reduce_max(x: torch.Tensor, shard: SeqShard) -> torch.Tensor:
    """The largest x over the group, on every rank; not differentiable (a
    softmax's shift)."""
    return all_reduce_(x.detach().clone(), shard, dist.ReduceOp.MAX)


class _AllGatherFrames(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, shard: SeqShard):
        ctx.shard = shard
        parts = [torch.empty_like(x) for _ in range(shard.count)]
        if shard.staged(x):
            host = [p.cpu() for p in parts]
            dist.all_gather(host, x.contiguous().cpu(), group=shard.group)
            parts = [h.to(x.device) for h in host]
        else:
            dist.all_gather(parts, x.contiguous(), group=shard.group)
        return torch.cat(parts, dim=1)

    @staticmethod
    def backward(ctx, g):
        shard = ctx.shard
        T = g.shape[1] // shard.count
        return all_reduce_(g.clone(), shard)[:, shard.g0(T) : shard.g0(T) + T].contiguous(), None


def all_gather_frames(x: torch.Tensor, shard: SeqShard) -> torch.Tensor:
    """(B, T, ...) -> (B, count * T, ...): every shard's frames in order, on
    every rank; differentiable (the backward sums each rank's gradient and
    keeps this shard's rows)."""
    return _AllGatherFrames.apply(x, shard)


def frames_of(x: torch.Tensor, shard: SeqShard, dim: int = 1) -> torch.Tensor:
    """This shard's frames of a whole-sequence tensor, along ``dim``."""
    T = x.shape[dim] // shard.count
    return x.narrow(dim, shard.g0(T), T)


# ------------------------------------------------------------- attention


def seq_parallel_available(t_local: int, window: Optional[int], head_dim: int, count: int) -> bool:
    """Can the halo kernels serve a site of ``t_local`` frames a shard? An
    engaged, even window shorter than the song whose halo reaches one
    neighbour only (``t_local >= window / 2``), a head dim that is a multiple
    of 64, as the JAX package's rule (a form that no kernel instance takes
    raises before, in ``ops/attention.py::sdpa``). The kernels take MQA, so a
    site with several KV heads runs them once per KV head
    (``ops/attention.py``); they take any ``t_local`` and ``t_local + window``
    (they mask their ragged tiles). A site they cannot serve gathers the
    sequence."""
    return (
        count > 1 and window is not None and window % 2 == 0 and 0 < window < t_local * count
        and t_local >= window // 2 and head_dim % 64 == 0
    )


def sequence_parallel_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, window: int,
                                shard: SeqShard) -> torch.Tensor:
    """Windowed MQA attention of this rank's frames: q (B, T, H, D) and k
    (B, T, D) already rotated with the global tables, v (B, T, D). k and v
    trade W / 2 frames with each neighbour in one exchange, then the halo
    kernels (their plain versions on CPU tensors) run. Returns (B, T, H, D)."""
    T, D = q.shape[1], q.shape[-1]
    w2 = window // 2
    kv = exchange_halo(torch.cat([k, v], dim=-1), w2, w2, shard)
    return halo_flash_attention(q, kv[..., :D], kv[..., D:], window, shard.g0(T), T * shard.count)
