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


def test_loss_and_gradients_at_a_windowed_length_match_jax(setup):
    """Four times the attention context (256 frames against 64, and 128
    against 32 at level 1): every trunk site is windowed, so the port's
    gradients come from the plain windowed dq / dkv versions; the JAX package
    runs its windowed attention as it does on the CPU. The plan is ``mixed``,
    which changes no gradient."""
    variables = setup[0]
    n = 4 * TINY["attn_context_len"]
    rng = np.random.default_rng(11)
    x = rng.standard_normal((1, 6, n)).astype(np.float32)
    a = rng.normal(-10.0, 3.0, (1, 96, n)).astype(np.float32)
    c = rng.uniform(-1, 1, (1, 5)).astype(np.float32)
    orig_len = np.array([n - 37], np.int32)
    key = jax.random.PRNGKey(5)
    k_noise, k_t, k_drop = jax.random.split(key, 3)
    noise = np.asarray(jax.random.normal(k_noise, (1, n, 6), jnp.float32)).transpose(0, 2, 1)
    draws = (torch.from_numpy(noise.copy()), torch.from_numpy(np.array(jax.random.randint(k_t, (1,), 0, 1000))),
             torch.from_numpy(np.array(jax.random.bernoulli(k_drop, 0.5, (1,)))))
    jmodel = jax_build_model(JModelConfig(**TINY), JDiffusionConfig())
    want_loss, want_grads = jax.jit(jax.value_and_grad(jmodel.loss))(
        variables, key, jnp.asarray(x), jnp.asarray(a), jnp.asarray(c), jnp.asarray(orig_len))
    loss, grads = _port_loss_and_grads(variables, tuple(torch.from_numpy(v) for v in (x, a, c)), torch.from_numpy(orig_len),
                                       draws, remat=True, remat_mode="mixed")
    assert loss == pytest.approx(float(want_loss), rel=LOSS_TOL)
    want_flat = flatten_params(want_grads)
    scale = max(np.abs(v).max() for v in want_flat.values())
    for name, value in want_flat.items():
        np.testing.assert_allclose(grads[name], value, rtol=GRAD_RTOL, atol=GRAD_ATOL * max(1.0, scale), err_msg=name)


def test_loss_and_gradients_at_head_dim_128_and_a_windowed_length_match_jax():
    """The tiny UNet with ``attn_dim_head=128`` (the head dim of the whole-song
    bf16/128 path, whose windowed sites run K3a / K3b's instances at 128 on
    the card) at four times its attention context, so every trunk site is
    windowed: the port's loss and every gradient leaf in fp32, through the
    plain windowed versions at D = 128, against the JAX package's with the
    same weights (``utils/convert.py``'s names) and draws, with the
    tolerances of the D = 64 tests above."""
    cfg = dict(TINY, attn_dim_head=128)
    n = 4 * cfg["attn_context_len"]
    jmodel = jax_build_model(JModelConfig(**cfg), JDiffusionConfig())
    args = (jnp.zeros((1, 32, 6)), jnp.zeros((1, 32, 96)), jnp.zeros((1,)), jnp.zeros((1, 5)), jnp.ones((1,), bool))
    variables = random_variables(jmodel.unet, *args, seed=12)
    rng = np.random.default_rng(13)
    x = rng.standard_normal((1, 6, n)).astype(np.float32)
    a = rng.normal(-10.0, 3.0, (1, 96, n)).astype(np.float32)
    c = rng.uniform(-1, 1, (1, 5)).astype(np.float32)
    orig_len = np.array([n - 21], np.int32)
    key = jax.random.PRNGKey(9)
    k_noise, k_t, k_drop = jax.random.split(key, 3)
    noise = np.asarray(jax.random.normal(k_noise, (1, n, 6), jnp.float32)).transpose(0, 2, 1)
    draws = (torch.from_numpy(noise.copy()), torch.from_numpy(np.array(jax.random.randint(k_t, (1,), 0, 1000))),
             torch.from_numpy(np.array(jax.random.bernoulli(k_drop, 0.5, (1,)))))
    want_loss, want_grads = jax.jit(jax.value_and_grad(jmodel.loss))(
        variables, key, jnp.asarray(x), jnp.asarray(a), jnp.asarray(c), jnp.asarray(orig_len))
    model = build_model(ModelConfig(**cfg), DiffusionConfig())
    params = load_jax_params(UNet(model.model_cfg), variables).train()
    loss = model.loss_from_draws(params, *(torch.from_numpy(v) for v in (x, a, c)), torch.from_numpy(orig_len), *draws)
    loss.backward()
    grads = jax_flat_from_state_dict({name: p.grad for name, p in params.named_parameters()})
    assert loss.item() == pytest.approx(float(want_loss), rel=LOSS_TOL)
    want_flat = flatten_params(want_grads)
    assert set(grads) == set(want_flat)
    scale = max(np.abs(v).max() for v in want_flat.values())
    for name, value in want_flat.items():
        np.testing.assert_allclose(grads[name], value, rtol=GRAD_RTOL, atol=GRAD_ATOL * max(1.0, scale), err_msg=name)


REMAT_CASES = {
    "block": dict(remat_mode="block"),
    "save-attn": dict(remat_mode="save-attn"),
    "ff": dict(remat_mode="ff"),
    "resnet": dict(remat_mode="resnet"),
    "save-attn-out": dict(remat_mode="save-attn-out"),
    "resnet-dots": dict(remat_mode="resnet-dots"),
    "mixed": dict(remat_mode="mixed"),  # the default levels: save-attn-out at level 0 and 1 (there are two here)
    "mixed-audio-block": dict(remat_mode="mixed", audio_remat_mode="block"),
    "mixed-short-levels": dict(remat_mode="mixed", remat_level_modes=("resnet-dots",)),  # the last entry repeats
    "mixed-per-level": dict(remat_mode="mixed", remat_level_modes=("save-attn-out", "block")),
}


@pytest.mark.parametrize("mode", list(REMAT_CASES))
def test_remat_modes_leave_the_gradients_unchanged(setup, mode):
    variables, batch, orig_len, draws, _ = setup
    loss0, grads0 = _port_loss_and_grads(variables, batch, orig_len, draws)
    loss1, grads1 = _port_loss_and_grads(variables, batch, orig_len, draws, remat=True, **REMAT_CASES[mode])
    assert loss1 == loss0
    for name, value in grads0.items():
        # the same operations in the same order, run twice: equal to the last bit or nearly
        np.testing.assert_allclose(grads1[name], value, rtol=1e-6, atol=1e-8, err_msg=name)


def test_remat_plan_per_level():
    """``level_remat_mode`` and ``_remat_plan`` as the JAX package resolves
    them: one mode for all levels, ``mixed`` per level with the last entry
    repeating, the audio stack's override, and nothing without ``remat``."""
    from osufusion_tpu.nn.unet import level_remat_mode as jax_level_remat_mode
    from osufusion_tpu_torch.nn.unet import _remat_plan, level_remat_mode

    cases = [
        dict(remat=False, remat_mode="mixed"),
        dict(remat=True, remat_mode="save-attn"),
        dict(remat=True, remat_mode="mixed"),
        dict(remat=True, remat_mode="mixed", remat_level_modes=("save-attn-out", "resnet-dots")),
        dict(remat=True, remat_mode="mixed", remat_level_modes=()),
        dict(remat=True, remat_mode="block", audio_remat_mode="save-attn-out"),
    ]
    for kw in cases:
        for level in range(4):
            for audio in (False, True):
                want = jax_level_remat_mode(JModelConfig(**kw), level, audio=audio)
                assert level_remat_mode(ModelConfig(**kw), level, audio=audio) == want, (kw, level, audio)
    mixed = ModelConfig(remat=True, remat_mode="mixed")
    assert [_remat_plan(mixed, i) for i in range(4)] == [("save-attn-out", "none")] * 2 + [("block", "none")] * 2
    assert _remat_plan(ModelConfig(remat=True, remat_mode="save-attn")) == ("none", "inner")
    assert _remat_plan(ModelConfig(remat=True, remat_mode="resnet-dots"), 3) == ("none", "resnet-dots")
    for kw in (dict(remat_mode="save-attn-in"), dict(remat_mode="mixed", remat_level_modes=("block", "mixed")),
               dict(remat_mode="block", audio_remat_mode="all")):
        with pytest.raises(ValueError, match="unknown remat mode"):
            UNet(ModelConfig(**TINY, remat=True, **kw))


# attention sites of the tiny UNet: one transformer in each of the two audio,
# down and up blocks, and one in the middle
SITES = 7


@pytest.mark.parametrize("mode,again", [
    ("none", 0), ("save-attn", 0), ("save-attn-out", 0), ("resnet-dots", 0),
    ("block", 6),  # every site inside a UNet block runs again in the backward; the middle one is in no block
    ("mixed-per-level", 3),  # level 1 is block: its audio, down and up sites run again
], ids=lambda v: str(v))
def test_attention_forwards_per_step_follow_the_remat_plan(setup, monkeypatch, mode, again):
    """Under ``save-attn-out`` the policy keeps each attention's outputs, so a
    loss and its backward run the attention forward once per site, as without
    rematerialisation; under ``block`` the backward runs it again."""
    from osufusion_tpu_torch.ops import flash_attention as fa

    calls = []
    forward = fa.flash_fwd_lse_reference
    monkeypatch.setattr(fa, "flash_fwd_lse_reference", lambda *args: calls.append(args[-1]) or forward(*args))
    variables, batch, orig_len, draws, _ = setup
    kw = {} if mode == "none" else dict(remat=True, **REMAT_CASES.get(mode, dict(remat_mode=mode)))
    _port_loss_and_grads(variables, batch, orig_len, draws, **kw)
    assert len(calls) == SITES + again
    # N = 90 frames (46 at level 1) is longer than the trunk's context at both levels: those sites are
    # windowed; the audio stack's context is pinned to 4096, so its sites are global
    assert sorted(set(calls)) == [-1, TINY["attn_context_len"] // 2, TINY["attn_context_len"]]


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
