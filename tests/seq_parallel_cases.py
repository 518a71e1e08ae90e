"""What each rank of tests/test_torch_seq_parallel.py runs: a gloo group of n
processes on the CPU, one shard of the frame axis each. Every case makes its
inputs from a seed, so the test process can make the same ones and compute the
one-process result. Imports no JAX: each rank is a fresh interpreter."""

from __future__ import annotations

import datetime
import traceback

import numpy as np
import torch
import torch.distributed as dist

from osufusion_tpu_torch.config import Config, DiffusionConfig, ModelConfig, TrainConfig
from osufusion_tpu_torch.models import build_model
from osufusion_tpu_torch.nn import blocks
from osufusion_tpu_torch.ops.attention import sdpa
from osufusion_tpu_torch.ops.rope import rope_tables
from osufusion_tpu_torch.parallel.mesh import make_mesh
from osufusion_tpu_torch.parallel.sequence import exchange_halo, frames_of, sequence_sharding
from osufusion_tpu_torch.train import loop

# the JAX package's tiny UNet of test_seq_parallel_train_step_matches_dp: T = 256
# against a context of 64, so every trunk site is windowed (halo kernels) and
# the audio stack's sites, pinned to a context of 4096, are global (gathered)
TINY_UNET = dict(dim_h=32, dim_h_mult=(1, 2), num_layer_blocks=(1, 1), num_middle_transformers=1, attn_dim_head=64,
                 attn_heads=2, attn_kv_heads=1, attn_context_len=64, dtype="float32")
MIXED = dict(remat=True, remat_mode="mixed", remat_level_modes=("save-attn-out", "block"))
B, T_SONG = 2, 256
HALO = (2, 3)  # left, right


def seeded(seed: int, *shape) -> torch.Tensor:
    return torch.from_numpy(np.random.default_rng(seed).standard_normal(shape).astype(np.float32))


def exchange_inputs(n: int, t_local: int = 6):
    """x (B, n * t_local, 3) and, per shard, the weights of its extended output."""
    x = seeded(1, B, n * t_local, 3)
    weights = [seeded(10 + i, B, t_local + sum(HALO), 3) for i in range(n)]
    return x, weights


def attention_inputs(n: int, kv: int = 1):
    """q, do (1, T, 2 kv, D) and k, v (1, T, kv, D): two query heads a KV head."""
    T, H, D = T_SONG, 2 * kv, 64
    q, k, v, do = seeded(2, 1, T, H, D), seeded(3, 1, T, kv, D), seeded(4, 1, T, kv, D), seeded(5, 1, T, H, D)
    return q, k, v, do


# (name, window, scale_base of the tables, KV heads): windowed through the halo
# kernels, with one KV head and with two (run once per KV head); global, gathered
ATTENTION_SITES = (("halo", 64, 64.0, 1), ("halo-gqa", 64, 64.0, 2), ("global", None, 256.0, 1))


def block_modules(seed: int = 0):
    """Every UNet block with a cross-shard step, seeded alike on every rank;
    name -> (module, input width)."""
    torch.manual_seed(seed)
    mods = {
        "cross_embed": (blocks.CrossEmbedLayer(6, 16), 6),
        "film": (blocks.FiLMBlock(8, 8), 8),
        "global_context": (blocks.GlobalContext(8, 8), 8),
        "squeeze_excite": (blocks.SqueezeExcite(8, 8), 8),
        "downsample": (blocks.Downsample(8, 12), 8),
        "upsample": (blocks.Upsample(8, 6), 8),
        "parallel_conv_out": (blocks.ParallelConvOut(8, 6), 8),
        "group_norm": (blocks.GroupNorm1(8), 8),
    }
    with torch.no_grad():  # norms away from (1, 0), so their gradients are checked too
        for module, _ in mods.values():
            for name, p in module.named_parameters():
                if p.ndim == 1:
                    p.add_(torch.randn(p.shape) * 0.1)
    return mods


def block_inputs(name: str, width: int, n: int):
    """x and the weights of the output, whose length the samplers change."""
    T = 16 * n
    t_out = {"downsample": T // 2, "upsample": 2 * T}.get(name, T)
    return seeded(20 + len(name), B, T, width) * 2 + 0.5, seeded(40 + len(name), B, t_out, 1)


def unet_config(**model_kw) -> Config:
    return Config(model=ModelConfig(**{**TINY_UNET, **model_kw}), diffusion=DiffusionConfig(),
                  train=TrainConfig(total_steps=10, warmup_steps=2, lr=1e-3, batch_size=B))


def unet_batch_and_draws():
    rng = np.random.default_rng(0)
    batch = (rng.uniform(-1, 1, (B, 6, T_SONG)).astype(np.float32), rng.normal(-10, 1, (B, 96, T_SONG)).astype(np.float32),
             rng.uniform(-1, 1, (B, 5)).astype(np.float32), np.array([T_SONG, T_SONG - 70], np.int32))
    draws = [(torch.from_numpy(rng.standard_normal((B, 6, T_SONG)).astype(np.float32)),
              torch.from_numpy(rng.integers(0, 1000, B)), torch.tensor([True, False]))]
    return batch, draws


def unet_step(cfg: Config, shard=None):
    """One AdamW step of the tiny UNet (seeded weights, the final conv made
    random so every gradient behind it is nonzero); returns (loss, grad_norm,
    state_dict after the step)."""
    model = build_model(cfg.model, cfg.diffusion)
    params = model.init_params(seed=3, device="cpu", dtype=torch.float32).train()
    with torch.no_grad():
        params.final_conv.weight.normal_(0, 0.2, generator=torch.Generator().manual_seed(1))
    state = loop.TrainState(1, params, loop.make_optimizer(cfg, params), torch.Generator().manual_seed(0))
    batch, draws = unet_batch_and_draws()
    metrics = loop.make_train_step(model, cfg, shard)(state, batch, draws=draws)
    return float(metrics["loss"]), float(metrics["grad_norm"]), {k: v.clone() for k, v in params.state_dict().items()}


# ------------------------------------------------------------------ per rank


def case_exchange(shard):
    x, weights = exchange_inputs(shard.count)
    local = frames_of(x, shard).clone().requires_grad_(True)
    y = exchange_halo(local, *HALO, shard)
    (y * weights[shard.index]).sum().backward()
    return {"y": y.detach(), "grad": local.grad}


def case_attention(shard):
    """Per site: o, dq, dk, dv of this rank's frames, and the number of
    halo-kernel calls (``sequence_parallel_attention``) the site made."""
    from osufusion_tpu_torch.ops import attention

    halo = attention.sequence_parallel_attention
    calls = []

    def counted(*args):
        calls.append(1)
        return halo(*args)

    attention.sequence_parallel_attention = counted
    out = {}
    try:
        for name, window, base, kv in ATTENTION_SITES:
            q, k, v, do = attention_inputs(shard.count, kv)
            leaves = [frames_of(t, shard).clone().requires_grad_(True) for t in (q, k, v)]
            calls.clear()
            with sequence_sharding(shard):
                o = sdpa(*leaves, window, rope_tables(T_SONG, 64, scale_base=base))
                o.backward(frames_of(do, shard))
            out[name] = (o.detach(), *(t.grad for t in leaves), len(calls))
    finally:
        attention.sequence_parallel_attention = halo
    return out


def case_blocks(shard):
    out = {}
    for name, (module, width) in block_modules().items():
        x, g = (frames_of(t, shard) for t in block_inputs(name, width, shard.count))
        x = x.clone().requires_grad_(True)
        with sequence_sharding(shard):
            y = module(x)  # the gates' (B, 1, C) is the same on every rank
            (y * g).sum().backward()
        out[name] = (y.detach(), x.grad, {p: t.grad for p, t in module.named_parameters()})
    return out


def case_unet(shard, **model_kw):
    loss, norm, params = unet_step(unet_config(**model_kw), shard)
    return {"loss": loss, "grad_norm": norm, "params": params if shard.index == 0 else None,
            "checksum": float(sum(v.double().sum() for v in params.values()))}


def trainer_config(project_dir: str, mesh_seq: int, steps: int, resume=None) -> Config:
    """The trainer on dummy samples of 64 to 256 frames padded to 256, with a
    save after every step."""
    return Config(model=ModelConfig(**TINY_UNET), diffusion=DiffusionConfig(),
                  train=TrainConfig(project_dir=project_dir, dataset_mode="dummy", segment_length=128, batch_size=2,
                                    total_steps=steps, warmup_steps=1, lr=1e-3, save_every=1, num_workers=1,
                                    mesh_seq=mesh_seq, resume=resume))


def case_trainer(shard, project_dir: str):
    """``trainer.train`` for one step with a save, then resumed for a second."""
    from osufusion_tpu_torch.trainer import train

    history = train(trainer_config(project_dir, shard.count, 1), device="cpu")
    history += train(trainer_config(project_dir, shard.count, 2, resume="latest"), device="cpu")
    return history


CASES = {
    "exchange": case_exchange,
    "attention": case_attention,
    "blocks": case_blocks,
    "unet": case_unet,
    "unet-mixed": lambda shard: case_unet(shard, **MIXED),
    "trainer": case_trainer,
}


def to_numpy(value):
    """Tensors inside dicts and tuples as numpy arrays: sent by value, so
    they outlive the rank's process (a tensor would go as a handle to its
    memory)."""
    if isinstance(value, torch.Tensor):
        return value.detach().numpy()
    if isinstance(value, dict):
        return {k: to_numpy(v) for k, v in value.items()}
    if isinstance(value, (tuple, list)):
        return type(value)(to_numpy(v) for v in value)
    return value


def rank_main(rank: int, n: int, store: str, case: str, queue, *args) -> None:
    """Join the group through ``store``, run ``case`` on this rank's shard
    (with ``args``) and put (rank, traceback or None, result) on ``queue``."""
    torch.set_num_threads(1)
    try:
        dist.init_process_group("gloo", init_method=f"file://{store}", world_size=n, rank=rank,
                                timeout=datetime.timedelta(seconds=60))
        shard = make_mesh(data=1, model=1, seq=n).seq_shard()
        queue.put((rank, None, to_numpy(CASES[case](shard, *args))))
    except Exception:  # reported to the test process, which fails on it
        queue.put((rank, traceback.format_exc(), None))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()

