"""The training loop (``osufusion_tpu/train/loop.py``): AdamW with a
linear-warmup half-cosine schedule, gradient accumulation, optional clipping,
grad-norm telemetry, checkpoints with pruning and resume; on one device, or
sequence-parallel over the processes of a ``seq`` group.

What differs from the JAX package, and why:

- The step is eager PyTorch: micro-batches run in a Python loop and their
  gradients add up in ``.grad``, where the JAX step scans them inside one
  compiled program.
- The optimizer is ``torch.optim.AdamW`` with optax's ``adamw`` defaults
  (betas 0.9/0.999, eps 1e-8 outside the root, weight decay 1e-4; PyTorch's
  own default decay is 1e-2). The learning rate is written into the optimizer
  before every step from ``make_lr_schedule``. Clipping scales the gradients
  by ``max_norm / max(norm, max_norm)`` before AdamW, as
  ``optax.clip_by_global_norm`` does; the reported ``grad_norm`` is the norm
  before clipping.
- Precision: ``mixed_precision="bf16"`` keeps float32 parameters and moments
  and runs the forward under autocast (``models/base.py``); ``full_bf16``
  holds parameters, gradients and moments in bf16; ``"no"`` is float32
  throughout. fp16 (static loss scale) and fp8 are not ported and raise.
- Random draws come from a ``torch.Generator`` on the training device that
  the state carries, where the JAX state carries a PRNG key.
- A checkpoint is one ``torch.save`` file per step,
  ``checkpoints/<step>/state.pt``, holding parameters, optimizer state, step
  and generator state; the JAX package writes Orbax directories. The data
  position file is the JAX package's ``{"epoch", "index"}`` json.
- Sequence parallelism (``--mesh-seq N``) is eager too: every rank of the
  ``seq`` group takes its frames of the same padded batch (the JAX step's
  ``batch_shardings``), runs the loss and its backward under the ambient
  shard (the JAX step's ``set_mesh``; ``parallel/sequence.py``), and sums its
  gradients over the group, so that every rank holds the whole loss's
  gradient and clips and steps the same. Data and tensor parallelism, and
  optimizer-state sharding, are not ported.
"""

from __future__ import annotations

import json
import math
import shutil
from dataclasses import dataclass
from pathlib import Path
from typing import Callable, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from osufusion_tpu_torch.config import Config
from osufusion_tpu_torch.models.base import GenerativeModel
from osufusion_tpu_torch.parallel.sequence import SeqShard, all_reduce_, frames_of, sequence_sharding

# optax.adamw's defaults
ADAMW_BETAS = (0.9, 0.999)
ADAMW_EPS = 1e-8
ADAMW_WEIGHT_DECAY = 1e-4


@dataclass
class TrainState:
    step: int
    params: nn.Module  # the denoiser: UNet, DiT or MMDiT
    optimizer: torch.optim.Optimizer
    generator: torch.Generator  # on the parameters' device


def make_lr_schedule(cfg: Config) -> Callable[[int], float]:
    """step -> learning rate: 0 at step 0, linear to ``lr`` at
    ``warmup_steps``, then a half cosine to 0 at
    ``max(total_steps, warmup_steps + 1)``
    (``optax.warmup_cosine_decay_schedule``)."""
    peak, warmup = cfg.train.lr, cfg.train.warmup_steps
    decay = max(cfg.train.total_steps, warmup + 1) - warmup

    def schedule(step: int) -> float:
        if step < warmup:
            return peak * step / warmup
        count = min(step - warmup, decay)
        return peak * 0.5 * (1.0 + math.cos(math.pi * count / decay))

    return schedule


def check_supported(cfg: Config) -> None:
    """Raise for the training options whose feature is not ported."""
    if cfg.train.opt_moments != "dtype":
        raise NotImplementedError(
            f"--opt-moments {cfg.train.opt_moments} is not ported yet (ROADMAP.md, queue 1: train/quant_opt.py)")
    if cfg.train.mixed_precision == "fp16":
        raise NotImplementedError("fp16 training with its static loss scale is not ported yet (ROADMAP.md, queue 1, item 4)")
    if cfg.train.mixed_precision == "fp8" or cfg.model.quant != "none":
        raise NotImplementedError("fp8 training is not ported yet (ROADMAP.md, queue 1: ops/quant.py)")
    if cfg.train.mixed_precision not in ("no", "bf16"):
        raise ValueError(f"unknown mixed precision mode: {cfg.train.mixed_precision!r}")
    if cfg.train.mesh_model != 1:
        raise NotImplementedError(
            "tensor parallelism (--mesh-model) is not ported yet (ROADMAP.md, queue 1: parallel/mesh.py param_shardings)")
    if cfg.train.mesh_data not in (-1, 1):
        raise NotImplementedError(
            "data parallelism (--mesh-data) with ZeRO-1 is not ported yet (ROADMAP.md, queue 1, item 5)")
    if cfg.train.mesh_seq < 1:
        raise ValueError(f"--mesh-seq must be at least 1, got {cfg.train.mesh_seq}")
    if cfg.train.mesh_seq > 1 and cfg.model.backbone != "unet":
        raise NotImplementedError(
            f"--mesh-seq {cfg.train.mesh_seq} with the {cfg.model.backbone!r} backbone: its global attention sites take "
            "the ring attention (K6), which is not ported yet (ROADMAP.md, queue 2, K6)")


def make_optimizer(cfg: Config, params: nn.Module) -> torch.optim.Optimizer:
    # the learning rate is set from the schedule before every step
    return torch.optim.AdamW(params.parameters(), lr=0.0, betas=ADAMW_BETAS, eps=ADAMW_EPS,
                             weight_decay=ADAMW_WEIGHT_DECAY)


def init_state(model: GenerativeModel, cfg: Config, device) -> TrainState:
    """A fresh state on ``device``: parameters drawn from ``cfg.train.seed``,
    in bf16 under ``full_bf16`` and float32 otherwise; the generator seeded
    with the same seed."""
    check_supported(cfg)
    dtype = torch.bfloat16 if cfg.train.full_bf16 else torch.float32
    params = model.init_params(cfg.train.seed, device=device, dtype=dtype).train()
    generator = torch.Generator(device=device).manual_seed(cfg.train.seed)
    return TrainState(step=0, params=params, optimizer=make_optimizer(cfg, params), generator=generator)


def global_norm(grads: Sequence[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares over every gradient, in float32."""
    return torch.linalg.vector_norm(torch.stack([torch.linalg.vector_norm(g.float()) for g in grads]))


def shard_frames(batch, shard: SeqShard, multiple: int):
    """This shard's frames of the frame axis (the last) of x and a; c and
    orig_len whole. The padded length must split into ``shard.count`` shards
    of a multiple of ``multiple`` (2^depth) frames each."""
    x, a, c, orig_len = batch
    n = x.shape[-1]
    if n % (shard.count * multiple):
        raise ValueError(f"a batch of {n} frames does not split into {shard.count} sequence shards of a multiple of "
                         f"{multiple} frames: pad it to a multiple of {shard.count * multiple}")
    return frames_of(x, shard, dim=-1), frames_of(a, shard, dim=-1), c, orig_len


def sum_gradients(params: nn.Module, shard: SeqShard) -> None:
    """Sum every gradient over the group in place, in fp32."""
    for p in params.parameters():
        if p.grad is not None:
            summed = all_reduce_(p.grad.float(), shard)
            if summed is not p.grad:
                p.grad.copy_(summed)


def make_train_step(model: GenerativeModel, cfg: Config, shard: Optional[SeqShard] = None):
    """Build ``step(state, batch, draws=None) -> metrics``.

    ``batch`` is (x, a, c, orig_len) as numpy arrays or tensors, (B, ...) or,
    with gradient accumulation, (accum, B, ...). The state is updated in
    place. ``metrics`` holds float32 scalars ``loss`` (mean over micro-batches),
    ``grad_norm`` (before clipping) and ``lr`` (the rate this step used).
    ``draws``, one (noise, t, cond_mask) per micro-batch, replaces the
    generator's draws: the tests use it to hold both packages to the same
    random numbers. With ``shard`` every rank of its group passes the same
    whole batch (and draws) and takes its frames."""
    check_supported(cfg)
    schedule = make_lr_schedule(cfg)
    accum = max(1, cfg.train.gradient_accumulation_steps)
    clip = cfg.train.clip_grad_norm

    def step(state: TrainState, batch, draws=None) -> dict:
        params = state.params
        device = params.null_cond.device
        batch = tuple(torch.as_tensor(b).to(device) for b in batch)
        if cfg.train.gradient_accumulation_steps <= 1:
            batch = tuple(b[None] for b in batch)
        if batch[0].shape[0] != accum:
            raise ValueError(f"batch holds {batch[0].shape[0]} micro-batches, expected {accum}")

        state.optimizer.zero_grad(set_to_none=True)
        loss_sum = torch.zeros((), device=device)
        with sequence_sharding(shard):
            for i in range(accum):
                x, a, c, orig_len = (b[i] for b in batch)
                if shard is not None:
                    x, a, c, orig_len = shard_frames((x, a, c, orig_len), shard, 2 ** len(model.model_cfg.dim_h_mult))
                if draws is None:
                    loss = model.loss(params, state.generator, x, a, c, orig_len)
                else:
                    noise, t, cond_mask = draws[i]
                    if shard is not None:
                        noise = frames_of(noise, shard, dim=-1)
                    loss = model.loss_from_draws(params, x, a, c, orig_len, noise, t, cond_mask)
                (loss / accum).backward()
                loss_sum += loss.detach()
        if shard is not None:
            sum_gradients(params, shard)
        for p in params.parameters():
            if p.grad is None:  # a leaf the loss does not reach (MMDiT's last audio stream): optax still decays it
                p.grad = torch.zeros_like(p)

        grads = [p.grad for p in params.parameters()]
        grad_norm = global_norm(grads)
        if clip > 0:
            torch._foreach_mul_(grads, (clip / grad_norm.clamp(min=clip)).to(grads[0].dtype))
        lr = schedule(state.step)
        for group in state.optimizer.param_groups:
            group["lr"] = lr
        state.optimizer.step()
        state.step += 1
        return {"loss": loss_sum / accum, "grad_norm": grad_norm, "lr": torch.tensor(lr)}

    return step


# --------------------------------------------------------------- checkpoints


def _checkpoint_root(project_dir: Path) -> Path:
    return Path(project_dir) / "checkpoints"


def checkpoint_steps(project_dir: Path) -> list[int]:
    """Steps that have a complete checkpoint, ascending."""
    root = _checkpoint_root(project_dir)
    if not root.exists():
        return []
    return sorted(int(p.name) for p in root.iterdir() if p.name.isdigit() and (p / "state.pt").exists())


def save_checkpoint(project_dir: Path, state: TrainState, max_to_keep: int) -> Path:
    """Write ``checkpoints/<step>/state.pt`` (through a temporary name, so a
    run cut short leaves no half-written checkpoint) and prune to the
    ``max_to_keep`` newest."""
    out = _checkpoint_root(project_dir) / str(state.step)
    out.mkdir(parents=True, exist_ok=True)
    tmp = out / "state.pt.tmp"
    torch.save(
        {
            "step": state.step,
            "params": state.params.state_dict(),
            "optimizer": state.optimizer.state_dict(),
            "generator": state.generator.get_state(),
        },
        tmp,
    )
    tmp.replace(out / "state.pt")
    if max_to_keep > 0:
        for old in checkpoint_steps(project_dir)[:-max_to_keep]:
            shutil.rmtree(_checkpoint_root(project_dir) / str(old))
    return out


def restore_checkpoint(project_dir: Path, state: TrainState, step: Optional[int] = None) -> TrainState:
    """Load the checkpoint of ``step`` (the latest without it) into ``state``."""
    steps = checkpoint_steps(project_dir)
    if not steps:
        raise FileNotFoundError(f"no checkpoint under {_checkpoint_root(project_dir)}")
    step = steps[-1] if step is None else step
    device = state.params.null_cond.device
    saved = torch.load(_checkpoint_root(project_dir) / str(step) / "state.pt", map_location=device, weights_only=True)
    state.params.load_state_dict(saved["params"])
    state.optimizer.load_state_dict(saved["optimizer"])
    state.generator.set_state(saved["generator"].cpu())
    state.step = int(saved["step"])
    return state


def _data_state_path(project_dir: Path) -> Path:
    return Path(project_dir) / "data_state.json"


def save_data_state(project_dir: Path, step: int, pipeline) -> None:
    """Persist the input pipeline's resume position next to the checkpoint.
    Positional randomness (``train/data.py``) makes ``{"epoch", "index"}``
    the full data-order state; the stripe layout is recorded as the JAX
    package records it (one process here)."""
    st = {"step": step, **pipeline.state(), "shard_id": pipeline.shard_id, "num_shards": pipeline.num_shards}
    _data_state_path(project_dir).write_text(json.dumps(st))


def load_data_state(project_dir: Path, current_step: int) -> Optional[dict]:
    """Resume position saved at ``current_step``, or None (fresh data order)
    if absent or recorded at a different step. A file written by a
    multi-process run raises: its stripe does not transfer."""
    p = _data_state_path(project_dir)
    if not p.exists():
        return None
    st = json.loads(p.read_text())
    layout = (int(st.get("shard_id", 0)), int(st.get("num_shards", 1)))
    if layout != (0, 1):
        raise RuntimeError(
            f"data-state file {p} was saved by process {layout[0]} of {layout[1]}; this run is one process: "
            "delete the data_state*.json files to restart the data order")
    if st.get("step") != current_step:
        return None
    return {"epoch": int(st["epoch"]), "index": int(st["index"])}


def stack_micro_batches(batch: Tuple[np.ndarray, ...], accum: int) -> Tuple[np.ndarray, ...]:
    """(accum * B, ...) arrays -> (accum, B, ...), as the step takes them."""
    return tuple(b.reshape(accum, b.shape[0] // accum, *b.shape[1:]) for b in batch)
