"""The port's UNet, audio encoder and DDIM sampler against the JAX package at
a tiny width, fp32 on the CPU, with the same seeded weights and inputs.

At T=250 (padded to 252) every trunk level is longer than its attention
context (64 at level 0, 32 below), so every trunk site is windowed; the audio
stack's context is pinned to 4096, so its sites are global."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from osufusion_tpu.config import DiffusionConfig as JDiffusionConfig
from osufusion_tpu.config import ModelConfig as JModelConfig
from osufusion_tpu.models import build_model as jax_build_model
from osufusion_tpu_torch.config import DiffusionConfig, ModelConfig
from osufusion_tpu_torch.models import build_model
from osufusion_tpu_torch.models import ddim
from osufusion_tpu_torch.nn.unet import UNet
from tests.torch_helpers import load_jax_params, random_variables

# the sizes here are tiny, and the suite runs several workers at once: a few
# threads each keep them from fighting over the cores
torch.set_num_threads(2)

TINY = dict(
    dim_h=96, dim_h_mult=(1, 2), num_layer_blocks=(1, 1), num_middle_transformers=1,
    attn_heads=2, attn_context_len=64, dtype="float32",
)
# fp32 through ~30 layers: summation-order differences (convs, norms, the
# online vs one-shot softmax) compound to ~1e-5 relative
TOL = 2e-4
B, N = 2, 250


@pytest.fixture(scope="module")
def pair():
    """(jax model, jax params, torch model, torch UNet) with the same weights."""
    jmodel = jax_build_model(JModelConfig(**TINY), JDiffusionConfig())
    args = (jnp.zeros((1, 32, 6)), jnp.zeros((1, 32, 96)), jnp.zeros((1,)), jnp.zeros((1, 5)), jnp.ones((1,), bool))
    variables = random_variables(jmodel.unet, *args, seed=0)
    tmodel = build_model(ModelConfig(**TINY), DiffusionConfig())
    return jmodel, variables, tmodel, load_jax_params(UNet(tmodel.model_cfg), variables)


@pytest.fixture(scope="module")
def jax_forward(pair):
    """The JAX UNet forward, compiled once for all mask cases (eager flax
    dispatch of the same graph takes twice as long on the CPU)."""
    return jax.jit(pair[0].unet.apply)


def _inputs(seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, N, 6)).astype(np.float32)
    a = rng.normal(-10.0, 3.0, (B, N, 96)).astype(np.float32)
    t = rng.uniform(0, 999, (B,)).astype(np.float32)
    c = rng.uniform(-1, 1, (B, 5)).astype(np.float32)
    return x, a, t, c


@pytest.mark.parametrize("cond_mask", [None, [True, False], [False, False]], ids=["no-mask", "mixed", "all-null"])
def test_unet_forward_matches_jax(pair, jax_forward, cond_mask):
    _, variables, _, unet = pair
    x, a, t, c = _inputs(0)
    jmask = None if cond_mask is None else jnp.asarray(cond_mask)
    want = np.asarray(jax_forward(variables, *map(jnp.asarray, (x, a, t, c)), jmask))
    tmask = None if cond_mask is None else torch.tensor(cond_mask)
    with torch.no_grad():
        got = unet(*map(torch.from_numpy, (x, a, t, c)), tmask)
    assert got.dtype == torch.float32 and got.shape == (B, N, 6)
    np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=TOL)


def test_encode_audio_matches_jax(pair):
    from osufusion_tpu.nn.unet import UNet as JUNet

    jmodel, variables, _, unet = pair
    a = _inputs(1)[1]
    encode = jax.jit(lambda v, a: jmodel.unet.apply(v, a, method=JUNet.encode_audio))
    want = np.asarray(encode(variables, jnp.asarray(a)))
    with torch.no_grad():
        got = unet.encode_audio(torch.from_numpy(a))
    assert got.shape == want.shape == (B, 126, 192)
    np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=TOL)


def test_ddim_sample_matches_jax(pair):
    """3 DDIM steps at CFG 2.0 from the same initial noise."""
    jmodel, variables, tmodel, unet = pair
    _, a, _, c = _inputs(2)
    x0 = np.random.default_rng(3).standard_normal((B, 6, N)).astype(np.float32)
    a_cf = np.ascontiguousarray(a.transpose(0, 2, 1))
    want = np.asarray(jmodel.sample(variables, jnp.asarray(a_cf), jnp.asarray(c), x=jnp.asarray(x0),
                                    cond_scale=2.0, sampling_timesteps=3))
    got = tmodel.sample(unet, torch.from_numpy(a_cf), torch.from_numpy(c), x=torch.from_numpy(x0),
                        cond_scale=2.0, sampling_timesteps=3)
    assert got.shape == (B, 6, N)
    np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=TOL)


def test_dpmpp_sample_matches_jax(pair):
    """4 DPM-Solver++(2M) steps at CFG 2.0 from the same initial noise: the
    first-order first step, two second-order middle steps and the
    first-order last step."""
    jmodel, variables, tmodel, unet = pair
    _, a, _, c = _inputs(5)
    x0 = np.random.default_rng(6).standard_normal((B, 6, N)).astype(np.float32)
    a_cf = np.ascontiguousarray(a.transpose(0, 2, 1))
    want = np.asarray(jmodel.sample(variables, jnp.asarray(a_cf), jnp.asarray(c), x=jnp.asarray(x0),
                                    cond_scale=2.0, sampling_timesteps=4, method="dpmpp-2m"))
    got = tmodel.sample(unet, torch.from_numpy(a_cf), torch.from_numpy(c), x=torch.from_numpy(x0),
                        cond_scale=2.0, sampling_timesteps=4, method="dpmpp-2m")
    assert got.shape == (B, 6, N) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=TOL)


def test_ddim_schedule_matches_jax():
    from osufusion_tpu.models import ddim as jddim

    np.testing.assert_array_equal(ddim.alphas_cumprod(1000).numpy(), np.asarray(jddim.alphas_cumprod(1000)))
    np.testing.assert_array_equal(ddim.ddim_timesteps(1000, 50), jddim.ddim_timesteps(1000, 50))
    rng = np.random.default_rng(4)
    x, eps = rng.standard_normal((2, 2, 8, 6)).astype(np.float32)
    acp = ddim.alphas_cumprod(1000)
    for t, t_prev in ((980, 960), (20, 0), (0, -1)):
        want = np.asarray(jddim.ddim_step(jnp.asarray(x), jnp.asarray(eps), t, t_prev, jnp.asarray(acp.numpy())))
        got = ddim.ddim_step(torch.from_numpy(x), torch.from_numpy(eps), t, t_prev, acp)
        np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=1e-6)


def test_ddim_step_keeps_a_bf16_eps_in_fp32_as_the_jax_package_does():
    """Serving in bf16 hands the step a bf16 eps and an fp32 x. jnp promotes
    sqrt(1 - a_t) * eps to fp32 (acp[t] is an fp32 array there, not a weak
    scalar); the port's step must not round that product to bf16 either, so
    the two agree to fp32 rounding."""
    from osufusion_tpu.models import ddim as jddim

    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 8, 6)).astype(np.float32)
    eps = torch.from_numpy(rng.standard_normal((2, 8, 6)).astype(np.float32)).to(torch.bfloat16)
    acp = ddim.alphas_cumprod(1000)
    for t, t_prev in ((980, 960), (500, 480), (20, 0), (0, -1)):
        want = np.asarray(jddim.ddim_step(jnp.asarray(x), jnp.asarray(eps.float().numpy()).astype(jnp.bfloat16), t,
                                          t_prev, jnp.asarray(acp.numpy())))
        got = ddim.ddim_step(torch.from_numpy(x), eps, t, t_prev, acp)
        assert got.dtype == torch.float32 and want.dtype == np.float32
        np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=1e-6)


def test_unported_options_raise():
    with pytest.raises(NotImplementedError):
        build_model(ModelConfig(**TINY), DiffusionConfig(objective="rectified-flow"))
    with pytest.raises(ValueError, match="unknown backbone"):
        build_model(ModelConfig(**{**TINY, "backbone": "vit"}), DiffusionConfig())
    model = build_model(ModelConfig(**TINY), DiffusionConfig())
    with pytest.raises(ValueError, match="unknown sampling method"):
        model.sample(None, torch.zeros(1, 96, 8), torch.zeros(1, 5), x=torch.zeros(1, 6, 8), method="euler")


def test_init_params_draws_as_the_jax_package_does():
    """Fresh parameters follow flax's initialisers: every conv and dense
    kernel a truncated normal of variance 1 / fan_in (fan_in = kernel size x
    input channels), biases zero, norms at (1, 0), ``null_cond`` ~ N(0, 1),
    the final conv zero; seeded, and the global RNG is left alone."""
    model = build_model(ModelConfig(**TINY), DiffusionConfig())
    before = torch.random.get_rng_state()
    params = model.init_params(seed=0, device="cpu")
    assert torch.equal(before, torch.random.get_rng_state())
    again, other = model.init_params(seed=0, device="cpu"), model.init_params(seed=1, device="cpu")
    checked = 0
    for (name, p), q, r in zip(params.named_parameters(), again.parameters(), other.parameters()):
        assert torch.equal(p, q), name
        if name.startswith("final_conv"):
            assert not p.any(), name
        elif name == "null_cond":
            # 384 draws: the sample standard deviation is within 4 sigma = 15 % of 1
            assert abs(p.std().item() - 1.0) < 0.15 and abs(p.mean().item()) < 0.25
            assert not torch.equal(p, r)
        elif p.ndim >= 2:
            fan_in = p[0].numel()
            limit = 2 * fan_in**-0.5 / 0.87962566103423978
            assert p.abs().max().item() <= limit * (1 + 1e-6), name  # truncated at two sigma of the wider normal
            if p.numel() >= 4096:  # enough draws for 5 %: the sample std of n draws scatters by ~0.6 / sqrt(n)
                assert p.std().item() == pytest.approx(fan_in**-0.5, rel=0.05), name
                checked += 1
            assert not torch.equal(p, r), name
        elif name.endswith("bias"):
            assert not p.any(), name
        else:  # LayerNorm / GroupNorm scale
            assert (p == 1).all(), name
    assert checked > 20
    # the same statistic on the JAX package's own init, kernel by kernel
    jmodel = jax_build_model(JModelConfig(**TINY), JDiffusionConfig())
    from osufusion_tpu.utils.serialization import flatten_params
    from osufusion_tpu_torch.utils.convert import jax_flat_from_state_dict

    want = flatten_params(jmodel.init_params(jax.random.PRNGKey(0)))
    got = jax_flat_from_state_dict(params.state_dict())
    assert set(got) == set(want)
    for name, value in want.items():
        value = np.asarray(value)
        assert got[name].shape == value.shape, name
        if name.endswith("kernel") and value.size >= 4096 and "final_conv" not in name:
            assert got[name].std() == pytest.approx(value.std(), rel=0.08), name
        elif name.endswith(("bias", "scale")):
            np.testing.assert_array_equal(got[name], value, err_msg=name)
