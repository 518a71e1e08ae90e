"""Ring attention over a sequence shard (``osufusion_tpu/parallel/ring.py``):
exact global attention at a site whose every query needs every key (a window
that is off or covers the song), the regime that the halo path
(``parallel/sequence.py``) cannot serve. Every DiT and MMDiT layer is such a
site, and so are the UNet's sites whose level is no longer than its context.
Without the ring such a site gathers the whole sequence on every rank, and
per-rank memory grows as the song.

The chunks of keys and values rotate round the group, one hop per step, while
each rank keeps its queries (``ops/ring_attention.py``: K1 per hop with an
exact merge of the LSEs, K2's sweep per hop with travelling dk and dv). The
rotation is an asynchronous form of ``parallel/sequence.py::_p2p``: the next
hop's send and receive are posted before the hop's kernels and waited for
after them, so that over NCCL the transfer hides under the kernels; over gloo
a CUDA tensor is staged through host memory, which synchronises.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

from osufusion_tpu_torch.ops.ring_attention import register_rotation, ring_attention_op
from osufusion_tpu_torch.parallel.sequence import SeqShard, frames_of

# rows a shard's chunk must be a multiple of: the smallest block of the JAX
# package's kernels (``_pick_block``'s floor), kept as the ring's rule
RING_ROWS = 64


def ring_available(t: int, s: int, d: int, window: Optional[int], n: int, h: int = 1, kv: int = 1) -> bool:
    """Can the ring serve a self-attention site of t frames (the whole song)
    split over n shards? The JAX package's rules: n > 1, t == s, t % n == 0,
    head dim 64 (the port's kernels take no other), the window off or
    covering the song, and a shard of a multiple of ``RING_ROWS`` frames.
    The JAX package also refuses a full-MHA site (h == kv) whose shard does
    not split into a timestep fold, a tiling rule of the TPU kernel; the port
    has no fold, so h and kv are accepted for the same signature and not
    read."""
    if n <= 1 or t != s or t % n or d != 64:
        return False
    if window is not None and window < t:
        return False
    return (t // n) % RING_ROWS == 0


class _Transfer:
    """A posted send and receive; ``wait()`` returns the received tensor on
    the device the sent one was on."""

    def __init__(self, works: list, buffer: torch.Tensor, device: torch.device) -> None:
        self.works, self.buffer, self.device = works, buffer, device

    def wait(self) -> torch.Tensor:
        for work in self.works:
            work.wait()
        return self.buffer.to(self.device)


class ShardRotation:
    """The ring's rotation over a shard's group: ``start(t, tag)`` sends t to
    the next shard and receives the previous shard's into a new buffer."""

    def __init__(self, shard: SeqShard) -> None:
        self.shard, self.count = shard, shard.count

    def start(self, t: torch.Tensor, tag: int) -> _Transfer:
        shard = self.shard
        staged = shard.staged(t)
        send = t.cpu() if staged else t  # the copy to host waits for the kernels that wrote t
        buffer = torch.empty(t.shape, dtype=t.dtype, device="cpu" if staged else t.device)
        nxt, prev = (shard.index + 1) % shard.count, (shard.index - 1) % shard.count
        works = dist.batch_isend_irecv([
            dist.P2POp(dist.isend, send, shard.peer(nxt), group=shard.group, tag=tag),
            dist.P2POp(dist.irecv, buffer, shard.peer(prev), group=shard.group, tag=tag),
        ])
        return _Transfer(works, buffer, t.device)


# id(shard) -> (shard, rotation id): the shard is kept, so its id is not reused
_ROTATION_IDS: dict[int, tuple] = {}


def _rotation_id(shard: SeqShard) -> int:
    if id(shard) not in _ROTATION_IDS:
        _ROTATION_IDS[id(shard)] = (shard, register_rotation(ShardRotation(shard)))
    return _ROTATION_IDS[id(shard)][1]


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, rope: Optional[tuple],
                   shard: SeqShard) -> torch.Tensor:
    """Global attention of this rank's frames against the whole song: q (B,
    T, H, D), k and v (B, T, Kv, D) unrotated, the song's tables ``rope``
    (cos, sin), each (t_global, D), or None. Returns (B, T, H, D). Every rank
    of the shard's group must call it at the same site, and run its backward."""
    B, T, H, D = q.shape
    cos, sin = (None, None) if rope is None else (frames_of(t, shard, dim=0).float().contiguous() for t in rope)
    if k.shape[2] == 1:  # MQA: the kernels' (B, T, D) form
        k, v = k.reshape(B, T, D), v.reshape(B, T, D)
    return ring_attention_op(q.contiguous(), k.contiguous(), v.contiguous(), cos, sin, _rotation_id(shard))[0]
