"""The port's diffusion loss and its gradients against the JAX package's:
``masked_mse``, ``add_noise``, ``DiffusionModel.loss`` with the same random
draws, and ``jax.grad`` against ``.grad`` leaf by leaf; fp32 on the CPU at a
tiny width, weights random everywhere (a fresh model's final conv is zero,
which would zero every gradient behind it)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from osufusion_tpu.config import DiffusionConfig as JDiffusionConfig
from osufusion_tpu.config import ModelConfig as JModelConfig
from osufusion_tpu.models import build_model as jax_build_model
from osufusion_tpu.models import ddim as jax_ddim
from osufusion_tpu.models.base import masked_mse as jax_masked_mse
from osufusion_tpu.utils.serialization import flatten_params
from osufusion_tpu_torch.config import DiffusionConfig, ModelConfig
from osufusion_tpu_torch.models import build_model, ddim
from osufusion_tpu_torch.models.base import masked_mse
from osufusion_tpu_torch.nn.unet import UNet
from osufusion_tpu_torch.utils.convert import jax_flat_from_state_dict
from tests.torch_helpers import load_jax_params, random_variables

# the sizes here are tiny, and the suite runs several workers at once: a few
# threads each keep them from fighting over the cores
torch.set_num_threads(2)

TINY = dict(
    dim_h=32, dim_h_mult=(1, 2), num_layer_blocks=(1, 1), num_middle_transformers=1,
    attn_heads=2, attn_context_len=64, dtype="float32",
)
B, N = 2, 90  # padded to 92 inside the UNet; longer than the context, so the trunk's level 0 is windowed
# fp32 through ~30 layers forward and back: summation order differs between
# XLA and PyTorch (convs, norms, softmax), ~1e-5 relative on the loss and
# ~1e-4 on gradient leaves that sum over B*N frames
LOSS_TOL = 1e-5
GRAD_RTOL, GRAD_ATOL = 2e-3, 2e-5


def test_masked_mse_matches_jax():
    rng = np.random.default_rng(0)
    pred, target = rng.standard_normal((2, 2, 17, 6)).astype(np.float32)
    for orig_len in (None, np.array([17, 5], np.int32), np.array([0, 0], np.int32)):
        want = jax_masked_mse(jnp.asarray(pred), jnp.asarray(target), None if orig_len is None else jnp.asarray(orig_len))
        got = masked_mse(torch.from_numpy(pred), torch.from_numpy(target), None if orig_len is None else torch.from_numpy(orig_len))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-7)


def test_add_noise_matches_jax():
    rng = np.random.default_rng(1)
    x, noise = rng.standard_normal((2, 3, 11, 6)).astype(np.float32)
    t = np.array([0, 500, 999])
    want = jax_ddim.add_noise(jnp.asarray(x), jnp.asarray(noise), jnp.asarray(t), jax_ddim.alphas_cumprod(1000))
    got = ddim.add_noise(torch.from_numpy(x), torch.from_numpy(noise), torch.from_numpy(t), ddim.alphas_cumprod(1000))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-7)


@pytest.fixture(scope="module")
def setup():
    """Both models with the same weights, one batch, and the JAX loss and
    gradients (jitted once) with and without ``orig_len``."""
    jmodel = jax_build_model(JModelConfig(**TINY), JDiffusionConfig())
    args = (jnp.zeros((1, 32, 6)), jnp.zeros((1, 32, 96)), jnp.zeros((1,)), jnp.zeros((1, 5)), jnp.ones((1,), bool))
    variables = random_variables(jmodel.unet, *args, seed=2)
    rng = np.random.default_rng(3)
    x = rng.standard_normal((B, 6, N)).astype(np.float32)
    a = rng.normal(-10.0, 3.0, (B, 96, N)).astype(np.float32)
    c = rng.uniform(-1, 1, (B, 5)).astype(np.float32)
    orig_len = np.array([N, 61], np.int32)
    key = jax.random.PRNGKey(7)
    # the draws of osufusion_tpu.models.diffusion.DiffusionModel.loss, which works channel-last
    k_noise, k_t, k_drop = jax.random.split(key, 3)
    noise = np.asarray(jax.random.normal(k_noise, (B, N, 6), jnp.float32)).transpose(0, 2, 1)
    t = np.asarray(jax.random.randint(k_t, (B,), 0, 1000))
    cond_mask = np.asarray(jax.random.bernoulli(k_drop, 0.5, (B,)))
    value_and_grad = jax.jit(jax.value_and_grad(jmodel.loss), static_argnames=())
    want = {
        "masked": value_and_grad(variables, key, jnp.asarray(x), jnp.asarray(a), jnp.asarray(c), jnp.asarray(orig_len)),
        "plain": value_and_grad(variables, key, jnp.asarray(x), jnp.asarray(a), jnp.asarray(c), None),
    }
    batch = tuple(torch.from_numpy(v) for v in (x, a, c))
    draws = (torch.from_numpy(noise.copy()), torch.from_numpy(np.array(t)), torch.from_numpy(np.array(cond_mask)))
    return variables, batch, torch.from_numpy(orig_len), draws, want


def _port_loss_and_grads(variables, batch, orig_len, draws, **model_kw):
    model = build_model(ModelConfig(**TINY, **model_kw), DiffusionConfig())
    params = load_jax_params(UNet(model.model_cfg), variables).train()
    loss = model.loss_from_draws(params, *batch, orig_len, *draws)
    loss.backward()
    grads = jax_flat_from_state_dict({name: p.grad for name, p in params.named_parameters()})
    return loss.item(), grads


@pytest.mark.parametrize("case", ["masked", "plain"])
def test_loss_and_gradients_match_jax(setup, case):
    variables, batch, orig_len, draws, want = setup
    loss, grads = _port_loss_and_grads(variables, batch, orig_len if case == "masked" else None, draws)
    want_loss, want_grads = want[case]
    assert loss == pytest.approx(float(want_loss), rel=LOSS_TOL)
    want_flat = flatten_params(want_grads)
    assert set(grads) == set(want_flat)
    scale = max(np.abs(v).max() for v in want_flat.values())
    for name, value in want_flat.items():
        # a leaf with tiny gradients is held to the tolerance of the largest leaf's scale
        np.testing.assert_allclose(grads[name], value, rtol=GRAD_RTOL, atol=GRAD_ATOL * max(1.0, scale), err_msg=name)


@pytest.mark.parametrize("mode", ["block", "save-attn", "ff", "resnet"])
def test_remat_modes_leave_the_gradients_unchanged(setup, mode):
    variables, batch, orig_len, draws, _ = setup
    loss0, grads0 = _port_loss_and_grads(variables, batch, orig_len, draws)
    loss1, grads1 = _port_loss_and_grads(variables, batch, orig_len, draws, remat=True, remat_mode=mode)
    assert loss1 == loss0
    for name, value in grads0.items():
        # the same operations in the same order, run twice: equal to the last bit or nearly
        np.testing.assert_allclose(grads1[name], value, rtol=1e-6, atol=1e-8, err_msg=name)


@pytest.mark.parametrize("mode", ["save-attn-out", "resnet-dots", "mixed"])
def test_unported_remat_modes_raise(mode):
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        UNet(ModelConfig(**TINY, remat=True, remat_mode=mode))


@pytest.mark.parametrize("kw", [
    dict(remat_mode="mixed", remat_level_modes=("block", "save-attn")),  # every level ported: per-level plans wait all the same
    dict(remat_mode="save-attn", audio_remat_mode="block"),
], ids=["mixed-ported-levels", "audio-override"])
def test_per_level_remat_plans_raise(kw):
    with pytest.raises(NotImplementedError, match="item 10a"):
        UNet(ModelConfig(**TINY, remat=True, **kw))


def test_public_loss_draws_from_the_generator(setup):
    """Same generator state, same loss; the draws depend on the generator alone."""
    variables, batch, orig_len, _, _ = setup
    model = build_model(ModelConfig(**TINY), DiffusionConfig())
    params = load_jax_params(UNet(model.model_cfg), variables)
    before = torch.random.get_rng_state()
    losses = [model.loss(params, torch.Generator().manual_seed(s), *batch, orig_len).item() for s in (0, 0, 1)]
    assert losses[0] == losses[1] != losses[2]
    assert np.isfinite(losses).all()
    assert torch.equal(before, torch.random.get_rng_state())
