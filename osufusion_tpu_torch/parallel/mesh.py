"""The (data, seq, model) process layout (``osufusion_tpu/parallel/mesh.py``).

The JAX package reshapes its device list to (data, seq, model) and names the
axes; GSPMD places the collectives. Here each process is one device of that
layout, in the same order (rank = (d * seq + s) * model + m), and holds one
``torch.distributed`` group per axis: the processes that differ from it only
along that axis. Training takes ``seq`` > 1 only; ``data`` and ``model`` stay
1 until data and tensor parallelism are ported (ROADMAP.md, queue 1).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch.distributed as dist

from osufusion_tpu_torch.parallel.sequence import SeqShard

AXES = ("data", "seq", "model")


@dataclass(frozen=True)
class Mesh:
    shape: dict  # axis -> size
    coords: dict  # axis -> this process's index along it
    groups: dict = field(default_factory=dict)  # axis -> group of this process along it (sizes > 1)

    def seq_shard(self) -> Optional[SeqShard]:
        """This process's place on the ``seq`` axis; None when it has one shard."""
        if self.shape["seq"] == 1:
            return None
        return SeqShard(self.groups["seq"], self.coords["seq"], self.shape["seq"])


def make_mesh(data: int = -1, model: int = 1, seq: int = 1) -> Mesh:
    """The layout over every process of the default group (one process when
    none is initialised); ``data=-1`` takes what ``model * seq`` leaves.
    Every process must call it, with the same sizes: each axis group is made
    collectively, in the same order everywhere."""
    n = dist.get_world_size() if dist.is_initialized() else 1
    if data == -1:
        if n % (model * seq):
            raise ValueError(f"{n} processes are not divisible by model * seq = {model * seq}")
        data = n // (model * seq)
    if data * seq * model != n:
        raise ValueError(f"a {data} x {seq} x {model} (data, seq, model) layout needs {data * seq * model} processes, "
                         f"this run has {n}")
    shape = dict(zip(AXES, (data, seq, model)))
    layout = np.arange(n).reshape(data, seq, model)
    rank = dist.get_rank() if dist.is_initialized() else 0
    coords = dict(zip(AXES, (int(c) for c in np.unravel_index(rank, layout.shape))))
    groups = {}
    for axis_index, axis in enumerate(AXES):
        if shape[axis] == 1:
            continue
        lines = np.moveaxis(layout, axis_index, -1).reshape(-1, shape[axis])
        for line in lines:
            group = dist.new_group([int(r) for r in line])
            if rank in line:
                groups[axis] = group
    return Mesh(shape, coords, groups)
