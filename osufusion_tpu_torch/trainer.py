"""Pretraining CLI on one GPU, flag for flag the JAX package's ``trainer.py``:

    python -m osufusion_tpu_torch.trainer --dummy-dataset --segment-length 2048 \\
        --full-bf16 --total-steps 6 --warmup-steps 2 --project-dir runs/smoke

and at full-song length (dummy samples of 16384 to 65536 frames, padded to
65536, where every attention site is windowed), under the per-level plan:

    python -m osufusion_tpu_torch.trainer --dummy-dataset --segment-length 32768 \\
        --batch-size 1 --full-bf16 --gradient-checkpointing \\
        --gradient-checkpointing-mode mixed --total-steps 4 --project-dir runs/fullsong

``train(cfg)`` builds the model, resumes a checkpoint if asked, streams
batches from ``train/data.py``, steps ``train/loop.py``, saves and prunes
checkpoints with the data position beside them, and at the end writes
``model.safetensors`` under the flax names, so the result serves in this
package (``serve.load_model``) and in the JAX package alike.

The DiT and MMDiT backbones train through the same loop (``--model-depth``,
``--model-attn-heads`` and ``--model-attn-kv-heads`` size them; heads x 64
must equal ``--model-dim``):

    python -m osufusion_tpu_torch.trainer --model-backbone dit --model-attn-heads 8 \
        --dummy-dataset --segment-length 2048 --full-bf16 --total-steps 6 --project-dir runs/dit

and the UNet sequence-parallel over N processes, one per GPU
(``parallel/sequence.py``; the padded length must be a multiple of N x
2^depth):

    torchrun --standalone --nproc-per-node 2 -m osufusion_tpu_torch.trainer \
        --mesh-seq 2 --dummy-dataset --segment-length 32768 --batch-size 1 \
        --full-bf16 --gradient-checkpointing --gradient-checkpointing-mode mixed

The JAX package's multi-host flags (``--coordinator``, ``--num-processes``,
``--process-id``, the process id being the global rank) or torchrun's
environment reach ``parallel/distributed.py::maybe_initialize``. Rank 0 writes
the checkpoints, the data position, the metrics and the final export.

Flags whose feature is not ported raise ``NotImplementedError`` naming the
ROADMAP.md queue item: ``--model-type rectified-flow``, ``--mixed-precision
fp16|fp8``, ``--opt-moments int8``, ``--mesh-data`` and ``--mesh-model`` above
1, ``--mesh-seq`` above 1 with ``dit`` or ``mmdit`` (the ring attention, K6),
and the periodic sample (``--sample-audio``). Every remat mode of ``--gradient-checkpointing-mode`` runs,
``mixed`` with ``--gradient-checkpointing-levels`` included; the audio stack's
override is ``model.audio_remat_mode`` of the config, which has no flag, as in
the JAX package.

One difference in behaviour: dummy batches are always padded to the mode's
longest length (2 x ``--segment-length``), which the JAX trainer does only in
multi-host runs, so every step of a smoke run has the same shape and step
times compare; ``orig_len`` still varies, so the masked loss is exercised.
"""

from __future__ import annotations

import time
from argparse import ArgumentParser
from pathlib import Path
from typing import Optional

import torch

from osufusion_tpu_torch.config import Config, DiffusionConfig, ModelConfig, TrainConfig
from osufusion_tpu_torch.models import build_model
from osufusion_tpu_torch.parallel.distributed import (
    barrier,
    is_main_process,
    local_device,
    maybe_initialize,
    process_count,
)
from osufusion_tpu_torch.parallel.mesh import make_mesh
from osufusion_tpu_torch.train import data as D
from osufusion_tpu_torch.train.loop import (
    check_supported,
    init_state,
    load_data_state,
    make_train_step,
    restore_checkpoint,
    save_checkpoint,
    save_data_state,
    stack_micro_batches,
)
from osufusion_tpu_torch.utils.convert import jax_flat_from_state_dict
from osufusion_tpu_torch.utils.logging import MetricLogger
from osufusion_tpu_torch.utils.serialization import save_safetensors


def save_model_safetensors(params, path: Path) -> None:
    """Final weight export, float32 under the JAX package's names and layouts."""
    save_safetensors(jax_flat_from_state_dict(params.state_dict()), path)


def train(cfg: Config, device: Optional[str] = None) -> list[dict]:
    """Run the loop to ``cfg.train.total_steps`` on ``device`` (without it the
    GPU of this process, ``parallel/distributed.py::local_device``; a CPU only
    when asked, with gloo between processes). Under torchrun (or after
    ``maybe_initialize``) every process runs this, one shard each of
    ``--mesh-seq``. Returns each step's metrics ({"step", "loss", "grad_norm",
    "lr", "seconds"}) for callers that check a run; the CLI ignores them."""
    check_supported(cfg)
    if cfg.train.sample_audio is not None:
        raise NotImplementedError(
            "the periodic sample during training is not ported yet (ROADMAP.md, queue 1, item 1: sample_step with models/dpm.py)")
    mode = cfg.train.dataset_mode
    bucket = min(D.BUCKET, max(64, cfg.train.segment_length))
    pad_to = D.process_invariant_pad(mode, cfg.train.segment_length, cfg.train.max_length) if mode == "dummy" else None
    multiple = cfg.train.mesh_seq * 2 ** len(cfg.model.dim_h_mult)
    if pad_to is not None and cfg.train.mesh_seq > 1 and (-(-pad_to // bucket) * bucket) % multiple:
        raise ValueError(f"batches of {-(-pad_to // bucket) * bucket} frames do not split into --mesh-seq "
                         f"{cfg.train.mesh_seq} shards of a multiple of 2^{len(cfg.model.dim_h_mult)} frames: "
                         f"the padded length must be a multiple of {multiple}")
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("training runs on an NVIDIA GPU; none is visible (pass device='cpu' to run on the CPU)")
        device = local_device()
        torch.cuda.set_device(device)
    maybe_initialize(backend="gloo" if str(device) == "cpu" else None)
    if process_count() != cfg.train.mesh_seq:
        raise ValueError(f"--mesh-seq {cfg.train.mesh_seq} runs one process per shard, this run has {process_count()} "
                         f"(data parallelism over more is not ported, ROADMAP.md queue 1, item 5): "
                         f"torchrun --nproc-per-node {cfg.train.mesh_seq} -m osufusion_tpu_torch.trainer ...")
    shard = make_mesh(data=1, model=1, seq=cfg.train.mesh_seq).seq_shard()
    main = is_main_process()
    say = print if main else (lambda *args, **kwargs: None)

    say("Initializing...")
    project_dir = Path(cfg.train.project_dir)
    if main:
        project_dir.mkdir(parents=True, exist_ok=True)
        cfg.save(project_dir / "config.json")

    model = build_model(cfg.model, cfg.diffusion)
    state = init_state(model, cfg, device)
    n_params = sum(p.numel() for p in state.params.parameters())
    say(f"model: {cfg.diffusion.objective} dim_h={cfg.model.dim_h} ({n_params / 1e6:.1f}M params) on {device}"
        + (f", sequence-parallel over {shard.count} processes" if shard is not None else ""))
    step_fn = make_train_step(model, cfg, shard)

    if cfg.train.resume is not None:
        state = restore_checkpoint(project_dir, state)
        if cfg.train.reset_steps:
            state.step = 0
        say(f"resumed at step {state.step}")

    say("Loading dataset...")
    paths = sorted(Path(cfg.train.dataset_dir).rglob("*.map.npz")) if mode != "dummy" else []
    if cfg.train.max_length > 0 and paths:
        paths = D.filter_dataset(paths, cfg.train.max_length)
    dataset = D.make_dataset(
        mode, paths, seed=cfg.train.seed, segment_length=cfg.train.segment_length,
        segment_sr=cfg.train.segment_sr, sample_density=cfg.train.sample_density,
    )
    accum = max(1, cfg.train.gradient_accumulation_steps)
    data_state = load_data_state(project_dir, current_step=state.step) if cfg.train.resume else None
    batches = D.DataPipeline(
        dataset, cfg.train.batch_size * accum, bucket=bucket, num_workers=cfg.train.num_workers,
        start=data_state, pad_to=pad_to,
    )

    logger = MetricLogger(project_dir) if main else None
    losses: list[float] = []
    history: list[dict] = []
    say("Training...")
    t_last = time.time()
    while state.step < cfg.train.total_steps:
        batch = next(batches)
        if accum > 1:
            batch = stack_micro_batches(batch, accum)
        metrics = step_fn(state, batch)
        # reading the metrics waits for the device, as the JAX loop's float() does
        loss, norm, lr = float(metrics["loss"]), float(metrics["grad_norm"]), float(metrics["lr"])
        losses.append(loss)
        if len(losses) > max(1, cfg.train.save_every):
            losses.pop(0)
        avg_loss = sum(losses) / len(losses)

        dt = time.time() - t_last
        t_last = time.time()
        say(f"step {state.step} loss={loss:.5f} avg={avg_loss:.5f} norm={norm:.4f} lr={lr:.2e} ({dt:.2f}s)", flush=True)
        history.append({"step": state.step, "loss": loss, "grad_norm": norm, "lr": lr, "seconds": dt})
        if main:
            logger.log({"loss": loss, "total_norm": norm, "lr": lr}, step=state.step)

        if cfg.train.save_every > 0 and state.step % cfg.train.save_every == 0:
            if main:  # every rank holds the same state
                logger.log({"save_loss": avg_loss}, step=state.step)
                save_checkpoint(project_dir, state, cfg.train.max_num_checkpoints)
                save_data_state(project_dir, state.step, batches)
            barrier()

    if main:
        save_model_safetensors(state.params, project_dir / "model.safetensors")
        logger.close()
    barrier()
    say("Done.")
    return history


def _parser() -> ArgumentParser:
    p = ArgumentParser()
    p.add_argument("--project-dir", type=str, default="runs/default")
    p.add_argument("--dataset-dir", type=str, default="data")
    p.add_argument("--model-type", type=str, default="diffusion", choices=["diffusion", "rectified-flow"])
    p.add_argument("--resume", type=str, default=None)
    p.add_argument("--reset-steps", action="store_true")
    p.add_argument("--full-sequence", action="store_true")
    p.add_argument("--random-length", action="store_true")
    p.add_argument("--dummy-dataset", action="store_true")
    p.add_argument("--max-length", type=int, default=0)
    p.add_argument("--segment-length", type=int, default=4096)
    p.add_argument("--no-segment-sr", action="store_true", help="skip per-crop star-rating recompute")
    p.add_argument("--sample-density", type=float, default=1.0)
    p.add_argument("--mixed-precision", type=str, default="bf16", choices=["no", "fp16", "bf16", "fp8"])
    p.add_argument("--full-bf16", action="store_true")
    p.add_argument("--opt-moments", type=str, default="dtype", choices=["dtype", "int8"])
    p.add_argument("--gradient-checkpointing", action="store_true")
    p.add_argument(
        "--gradient-checkpointing-mode",
        choices=["block", "save-attn", "save-attn-out", "ff", "resnet", "resnet-dots", "mixed"],
        default="save-attn",
        help="remat granularity when --gradient-checkpointing is on (block = whole UNet blocks, the attention "
        "kernel runs again in the backward; save-attn-out = whole blocks, but each attention's output and LSE "
        "stay; save-attn = resnets and FFs, everything the attention saved stays; ff = FFs only; resnet = "
        "resnets only; resnet-dots = resnets, the outputs of their convolutions and matrix products stay; "
        "mixed = a mode per width level from --gradient-checkpointing-levels)",
    )
    p.add_argument(
        "--gradient-checkpointing-levels", type=str, default="save-attn-out,block,block,block",
        help='comma-separated modes for mode "mixed", widest level first; missing entries repeat the last',
    )
    p.add_argument("--gradient-accumulation-steps", type=int, default=1)
    p.add_argument("--clip-grad-norm", type=float, default=0.0)
    p.add_argument("--model-dim", type=int, default=512)
    p.add_argument("--model-backbone", type=str, default="unet", choices=["unet", "dit", "mmdit"])
    p.add_argument("--model-attn-heads", type=int, default=16)
    p.add_argument("--model-attn-kv-heads", type=int, default=1)
    p.add_argument("--model-depth", type=int, default=12)
    p.add_argument("--lr", type=float, default=1e-5)
    p.add_argument("--batch-size", type=int, default=4)
    p.add_argument("--num-workers", type=int, default=2)
    p.add_argument("--total-steps", type=int, default=1_000_000)
    p.add_argument("--save-every", type=int, default=1000)
    p.add_argument("--max-num-checkpoints", type=int, default=5)
    p.add_argument("--warmup-steps", type=int, default=1000)
    p.add_argument("--sample-every", type=int, default=1000)
    p.add_argument("--sample-audio", type=str, default=None)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--mesh-data", type=int, default=-1)
    p.add_argument("--mesh-model", type=int, default=1)
    p.add_argument("--mesh-seq", type=int, default=1)
    p.add_argument("--coordinator", type=str, default=None, help="host:port of process 0")
    p.add_argument("--num-processes", type=int, default=None)
    p.add_argument("--process-id", type=int, default=None)
    return p


def parse_args(argv=None) -> Config:
    """The run's configuration from the command line (the launch flags are
    ``main``'s)."""
    return config_from_args(_parser().parse_args(argv))


def config_from_args(args) -> Config:
    if args.dummy_dataset:
        mode = "dummy"
    elif args.full_sequence:
        mode = "full-sequence"
    elif args.random_length:
        mode = "random-length"
    else:
        mode = "subsequence"

    dtype = {"no": "float32", "fp16": "float16", "bf16": "bfloat16", "fp8": "bfloat16"}[args.mixed_precision]
    model = ModelConfig(
        dim_h=args.model_dim,
        backbone=args.model_backbone,
        depth=args.model_depth,
        attn_heads=args.model_attn_heads,
        attn_kv_heads=args.model_attn_kv_heads,
        dtype=dtype,
        quant="fp8" if args.mixed_precision == "fp8" else "none",
        remat=args.gradient_checkpointing,
        remat_mode=args.gradient_checkpointing_mode,
        remat_level_modes=tuple(args.gradient_checkpointing_levels.split(",")),
    )
    diffusion = DiffusionConfig(objective=args.model_type)
    train_cfg = TrainConfig(
        project_dir=args.project_dir,
        dataset_dir=args.dataset_dir,
        model_type=args.model_type,
        resume=args.resume,
        reset_steps=args.reset_steps,
        dataset_mode=mode,
        max_length=args.max_length,
        segment_length=args.segment_length,
        segment_sr=not args.no_segment_sr,
        sample_density=args.sample_density,
        mixed_precision=args.mixed_precision,
        full_bf16=args.full_bf16,
        opt_moments=args.opt_moments,
        gradient_checkpointing=args.gradient_checkpointing,
        gradient_accumulation_steps=args.gradient_accumulation_steps,
        clip_grad_norm=args.clip_grad_norm,
        lr=args.lr,
        batch_size=args.batch_size,
        num_workers=args.num_workers,
        total_steps=args.total_steps,
        save_every=args.save_every,
        max_num_checkpoints=args.max_num_checkpoints,
        warmup_steps=args.warmup_steps,
        sample_every=args.sample_every,
        sample_audio=args.sample_audio,
        seed=args.seed,
        mesh_data=args.mesh_data,
        mesh_model=args.mesh_model,
        mesh_seq=args.mesh_seq,
    )
    return Config(model=model, diffusion=diffusion, train=train_cfg)


def main(argv=None) -> None:
    """The CLI: join the other processes (the launch flags or torchrun's
    environment), then train."""
    args = _parser().parse_args(argv)
    maybe_initialize(args.coordinator, args.num_processes, args.process_id)
    train(config_from_args(args))


if __name__ == "__main__":
    main()
