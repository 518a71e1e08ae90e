"""fp16 training (``--mixed-precision fp16``) against the JAX package's: one
optimizer step from the same seeded weights with the same random draws, the
forward at float16 and the JAX package's static loss scale of 4096 on the
loss, divided back out of the gradients in fp32. At a crop length every
attention site is global; above the model's context every trunk site is
windowed, and under the gradient the port runs the plain windowed pair on
fp16 operands there (``ops/flash_attention.py``), which the card replaces by
the fp16 instances of K3a / K3b. On the CPU at a tiny width."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from osufusion_tpu.config import Config as JConfig
from osufusion_tpu.config import DiffusionConfig as JDiffusionConfig
from osufusion_tpu.config import ModelConfig as JModelConfig
from osufusion_tpu.config import TrainConfig as JTrainConfig
from osufusion_tpu.models import build_model as jax_build_model
from osufusion_tpu.parallel import make_mesh
from osufusion_tpu.train import loop as jax_loop
from osufusion_tpu.utils.serialization import flatten_params
from osufusion_tpu_torch.config import Config, DiffusionConfig, ModelConfig, TrainConfig
from osufusion_tpu_torch.models import build_model
from osufusion_tpu_torch.nn.unet import UNet
from osufusion_tpu_torch.train import loop
from osufusion_tpu_torch.utils.convert import jax_flat_from_state_dict, state_dict_from_jax
from tests.adam_check import assert_adam_step_matches
from tests.torch_helpers import random_variables

torch.set_num_threads(2)

# a context of 64 frames: a crop of 64 keeps every site global, 128 makes every trunk site windowed
TINY = dict(dim_h=32, dim_h_mult=(1, 2), num_layer_blocks=(1, 1), num_middle_transformers=1, attn_dim_head=16,
            attn_heads=4, attn_context_len=64, dtype="float16")
TRAIN = dict(total_steps=10, warmup_steps=2, lr=1e-3, batch_size=4, mixed_precision="fp16")
B = 4


def _batch(seed: int, n: int):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-1, 1, (B, 6, n)).astype(np.float32)
    a = rng.normal(-10, 1, (B, 96, n)).astype(np.float32)
    c = rng.uniform(-1, 1, (B, 5)).astype(np.float32)
    orig_len = rng.integers(n // 2, n + 1, (B,)).astype(np.int32)
    return x, a, c, orig_len


def _start(jcfg):
    """The JAX package's model and seeded random variables for it (every leaf random, so every gradient is
    live at step 0)."""
    jmodel = jax_build_model(jcfg.model, jcfg.diffusion)
    args = (jnp.zeros((1, 32, 6)), jnp.zeros((1, 32, 96)), jnp.zeros((1,)), jnp.zeros((1, 5)), jnp.ones((1,), bool))
    return jmodel, random_variables(jmodel.unet, *args, seed=4)


def _torch_state(cfg, start: dict):
    """The port's model and a fresh train state whose weights are ``start``, carried across."""
    model = build_model(cfg.model, cfg.diffusion)
    params = UNet(cfg.model)
    params.load_state_dict(state_dict_from_jax(start))
    params.train()
    return model, loop.TrainState(0, params, loop.make_optimizer(cfg, params), torch.Generator().manual_seed(0))


def _jax_draws(rng_step, n: int):
    """The draws ``make_train_step`` hands to the loss (no accumulation)."""
    k_noise, k_t, k_drop = jax.random.split(rng_step, 3)
    noise = np.asarray(jax.random.normal(k_noise, (B, n, 6), jnp.float32)).transpose(0, 2, 1).copy()
    t = np.array(jax.random.randint(k_t, (B,), 0, 1000))
    mask = np.array(jax.random.bernoulli(k_drop, 0.5, (B,)))
    return [(torch.from_numpy(noise), torch.from_numpy(t), torch.from_numpy(mask))]


# Tolerances. Both packages run the forward at float16 (the JAX package's flax modules in float16, the port
# under autocast) and round at different points: flax rounds every layer's input and output to fp16, autocast
# only the inputs and outputs of the ops it lists, so the two forwards differ by some units of fp16's last
# place (2^-11 = 4.9e-4) per layer. The loss, a mean over ~1500 squared errors, agrees to 2e-3 relative; the
# gradient, whose every term passes the whole backward at fp16, to 2e-2 in its norm. Per entry, Adam's first
# moment after the two steps is held to the same 2e-2 of its root mean square over the model, plus 1e-1 of the
# entry (fp16 keeps 11 bits; the two steps' moments read at most 3.3e-2 of that mean square apart). Adam turns
# each moment entry into an update of about the learning rate whatever its size, so a parameter whose
# reference moment stands clear of that bound (same sign on both sides) is held to 1.1 x lr (Adam's
# bias-corrected ratio, whose size stays near 1), and one whose moment lies within it may have flipped and is
# allowed 2.2 x lr, two opposite updates of at most 1.1 x lr each (``tests/adam_check.py``). These bounds catch an update of the wrong sign or size: the
# mean over every entry, held to 10 % of the rate, and the loss and grad_norm above are the checks with
# teeth. Adam's update is the same at any scale of the gradient, so the loss scale itself is checked apart
# (``test_fp16_step_scales_the_loss``).
LOSS_RTOL = 2e-3
GRAD_NORM_RTOL = 2e-2
MOMENT_RTOL = 1e-1
PARAM_ATOL = 1.1  # times the rate: Adam's bias-corrected ratio, whose size stays near 1
PARAM_MEAN_TOL = 0.1  # times the rate


def _first_moments(jstate, state) -> tuple[dict, dict]:
    """Adam's first moment of every parameter in both packages, keyed as ``flatten_params`` keys them."""
    adam = [s for s in jax.tree_util.tree_leaves(jstate.opt_state, is_leaf=lambda s: hasattr(s, "mu"))
            if hasattr(s, "mu")]
    assert len(adam) == 1
    named = dict(state.params.named_parameters())
    return (jax_flat_from_state_dict({k: state.optimizer.state[p]["exp_avg"] for k, p in named.items()}),
            {k: np.asarray(v) for k, v in flatten_params(adam[0].mu).items()})


@pytest.mark.parametrize("n", [64, 128], ids=["crop-global", "windowed"])
def test_fp16_step_matches_jax(n):
    """Two steps from step 0, each held to the JAX package's (loss and
    grad_norm); the parameters after the second, the first step that moves
    them (optax evaluates the schedule on its own count, 0 at the first
    update, whose rate is 0)."""
    jcfg = JConfig(model=JModelConfig(**TINY), diffusion=JDiffusionConfig(), train=JTrainConfig(**TRAIN))
    cfg = Config(model=ModelConfig(**TINY), diffusion=DiffusionConfig(), train=TrainConfig(**TRAIN))
    jmodel, variables = _start(jcfg)
    start = {name: np.array(value, copy=True) for name, value in flatten_params(variables).items()}

    tx = jax_loop.make_optimizer(jcfg)
    jstate = jax_loop.TrainState(step=jnp.zeros((), jnp.int32), params=variables, opt_state=tx.init(variables),
                                 rng=jax.random.PRNGKey(11))
    jstep = jax_loop.make_train_step(jmodel, jcfg, make_mesh(data=1, model=1, devices=jax.devices()[:1]))

    model, state = _torch_state(cfg, start)
    assert all(p.dtype == torch.float32 for p in state.params.parameters())  # fp32 weights, the forward at fp16
    step = loop.make_train_step(model, cfg)

    for i in range(2):
        batch = _batch(30 + i, n)
        _, rng_step = jax.random.split(jstate.rng)
        draws = _jax_draws(rng_step, n)
        jstate, jmetrics = jstep(jstate, batch)
        metrics = step(state, batch, draws=draws)
        assert np.isfinite(float(metrics["loss"])) and np.isfinite(float(metrics["grad_norm"]))
        # the reported loss is the unscaled one, as the JAX step reports it
        assert float(metrics["loss"]) == pytest.approx(float(jmetrics["loss"]), rel=LOSS_RTOL), f"loss, step {i}"
        assert float(metrics["grad_norm"]) == pytest.approx(float(jmetrics["grad_norm"]), rel=GRAD_NORM_RTOL), \
            f"grad_norm, step {i}"
    lr = float(jmetrics["lr"])  # the second step's rate, the only one that moved the parameters
    want = {name: np.asarray(value) for name, value in flatten_params(jstate.params).items()}
    got = jax_flat_from_state_dict(state.params.state_dict())
    mu_got, mu_want = _first_moments(jstate, state)
    mu_rms = float(np.sqrt(np.mean(np.concatenate([m.ravel() for m in mu_want.values()]) ** 2)))
    assert_adam_step_matches(got, want, mu_got, mu_want, dict(atol=GRAD_NORM_RTOL * mu_rms, rtol=MOMENT_RTOL),
                             dict(atol=PARAM_ATOL * lr, rtol=0), PARAM_ATOL * lr)
    diffs = [np.abs(got[name] - value).ravel() for name, value in want.items()]
    moved = [np.abs(value - start[name]).ravel() for name, value in want.items()]
    assert np.concatenate(diffs).mean() < PARAM_MEAN_TOL * lr
    assert np.concatenate(moved).mean() > 0.5 * lr  # the step moved the parameters
    assert state.step == int(jstate.step) == 2


def test_fp16_step_scales_the_loss():
    """The backward of an fp16 step runs on 4096 x the loss, and the step divides the scale back out before
    the norm: a hook on every leaf records the gradient that the backward hands it, beside the same step
    from the same weights and draws without the scale (``mixed_precision="no"``, the same float16 forward).
    The recorded norms differ by the scale, within fp16's rounding of the backward (GRAD_NORM_RTOL); the
    loss is the same to the bit, and grad_norm is of the unscaled loss in both."""
    cfg = Config(model=ModelConfig(**TINY), diffusion=DiffusionConfig(), train=TrainConfig(**TRAIN))
    plain = dataclasses.replace(cfg, train=dataclasses.replace(cfg.train, mixed_precision="no"))
    _, variables = _start(JConfig(model=JModelConfig(**TINY), diffusion=JDiffusionConfig(), train=JTrainConfig(**TRAIN)))
    start = {name: np.array(value, copy=True) for name, value in flatten_params(variables).items()}
    n = 64
    batch = _batch(40, n)
    g = torch.Generator().manual_seed(5)
    draws = [(torch.randn((B, 6, n), generator=g), torch.randint(0, 1000, (B,), generator=g),
              torch.rand((B,), generator=g) < 0.5)]
    seen, metrics = {}, {}
    for label, c in (("fp16", cfg), ("unscaled", plain)):
        model, state = _torch_state(c, start)
        norms = []
        for p in state.params.parameters():
            p.register_hook(lambda grad, norms=norms: norms.append(torch.linalg.vector_norm(grad.detach().float())))
        metrics[label] = loop.make_train_step(model, c)(state, batch, draws=draws)
        seen[label] = float(torch.linalg.vector_norm(torch.stack(norms)))
        assert len(norms) == len(list(state.params.parameters()))
    assert seen["fp16"] / seen["unscaled"] == pytest.approx(loop.FP16_LOSS_SCALE, rel=GRAD_NORM_RTOL)
    assert loop.FP16_LOSS_SCALE == 4096  # the JAX package's static scale
    assert float(metrics["fp16"]["loss"]) == float(metrics["unscaled"]["loss"])
    assert float(metrics["fp16"]["grad_norm"]) == pytest.approx(float(metrics["unscaled"]["grad_norm"]),
                                                                rel=GRAD_NORM_RTOL)
