"""Multi-process training (``osufusion_tpu/parallel/distributed.py``): one
process per GPU, joined by ``torch.distributed``.

The JAX package starts one process per host and lets ``jax.distributed``
find the others. The PyTorch idiom is one process per GPU, which torchrun
starts and describes in the environment (``RANK``, ``WORLD_SIZE``,
``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``)::

    torchrun --nproc-per-node 2 -m osufusion_tpu_torch.trainer --mesh-seq 2 ...

The JAX package's launch surface works too, with the process id as the global
rank: ``--coordinator host:port --num-processes N --process-id i``, or
``OSUFUSION_COORDINATOR`` / ``OSUFUSION_NUM_PROCESSES`` / ``OSUFUSION_PROCESS_ID``;
these win over torchrun's variables. One process: nothing is initialised.

The backend is NCCL where every process of a host has a card of its own, and
gloo otherwise: on the CPU, or with more processes than cards on a host (NCCL
refuses two ranks on one card). The collectives of ``parallel/sequence.py``
stage CUDA tensors through host memory for gloo.
"""

from __future__ import annotations

import datetime
import os
from typing import Optional

import torch
import torch.distributed as dist


def _env_int(name: str) -> Optional[int]:
    value = os.environ.get(name)
    return int(value) if value not in (None, "") else None


def launch_settings(coordinator: Optional[str] = None, num_processes: Optional[int] = None,
                    process_id: Optional[int] = None) -> Optional[dict]:
    """The ``init_process_group`` arguments (init_method, world_size, rank)
    that the flags, the OSUFUSION_* variables or torchrun's variables ask for,
    in that order; None for a run of one process."""
    coordinator = coordinator or os.environ.get("OSUFUSION_COORDINATOR")
    num_processes = num_processes if num_processes is not None else _env_int("OSUFUSION_NUM_PROCESSES")
    process_id = process_id if process_id is not None else _env_int("OSUFUSION_PROCESS_ID")
    if num_processes is not None and num_processes > 1:
        if coordinator is None or process_id is None:
            raise ValueError("a multi-process launch needs --coordinator host:port and --process-id with --num-processes")
        if not 0 <= process_id < num_processes:
            raise ValueError(f"--process-id {process_id} outside 0..{num_processes - 1}")
        return {"init_method": f"tcp://{coordinator}", "world_size": num_processes, "rank": process_id}
    world = _env_int("WORLD_SIZE")
    if world is not None and world > 1:
        return {"init_method": "env://", "world_size": world, "rank": _env_int("RANK") or 0}
    return None


def local_rank() -> int:
    """This process's index among those of its host: torchrun's
    ``LOCAL_RANK``, else the global rank."""
    value = _env_int("LOCAL_RANK")
    return value if value is not None else process_index()


def local_device() -> torch.device:
    """The card of this process: ``cuda:LOCAL_RANK``, shared round-robin when
    a host runs more processes than it has cards."""
    return torch.device("cuda", local_rank() % torch.cuda.device_count())


def default_backend() -> str:
    """NCCL where every process of the host has a card of its own, else gloo."""
    per_host = _env_int("LOCAL_WORLD_SIZE") or 1
    return "nccl" if torch.cuda.is_available() and torch.cuda.device_count() >= per_host else "gloo"


def maybe_initialize(coordinator: Optional[str] = None, num_processes: Optional[int] = None,
                     process_id: Optional[int] = None, backend: Optional[str] = None,
                     timeout: Optional[datetime.timedelta] = None) -> bool:
    """Initialise the default process group when a multi-process launch is
    asked for (``launch_settings``); True when a group exists afterwards. A
    second call, or a run of one process, changes nothing. ``backend``
    defaults to ``default_backend()``; NCCL first binds the process to its
    card."""
    if dist.is_initialized():
        return True
    settings = launch_settings(coordinator, num_processes, process_id)
    if settings is None:
        return False
    backend = backend or default_backend()
    if backend == "nccl":
        torch.cuda.set_device(local_device())
    kwargs = {} if timeout is None else {"timeout": timeout}
    dist.init_process_group(backend, **settings, **kwargs)
    return True


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def is_main_process() -> bool:
    """The gate of host-side effects: checkpoints, metrics, the final export."""
    return process_index() == 0


def barrier() -> None:
    """Wait for every process; nothing in a run of one."""
    if dist.is_initialized():
        dist.barrier()
