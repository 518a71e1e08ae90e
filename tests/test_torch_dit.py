"""The port's DiT and MMDiT backbones against the JAX package's at a tiny
width, fp32 on the CPU, with the same seeded weights (``state_dict_from_jax``)
and inputs: the forward with and without the null-cond (CFG) branch, an MMDiT
length that is not a multiple of the patch, the diffusion loss and every
parameter's gradient (with and without block rematerialisation), the flax
draws of ``init_params``, the ``model.safetensors`` that ``train`` writes,
and the width refusal.

Under a gradient the attention on the CPU is ``flash_attention_op`` with the
plain versions of K1 and K2 in their full-MHA (DiT) and GQA (MMDiT) forms;
the JAX package runs its XLA attention on the CPU."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from osufusion_tpu.config import DiffusionConfig as JDiffusionConfig
from osufusion_tpu.config import ModelConfig as JModelConfig
from osufusion_tpu.models import build_model as jax_build_model
from osufusion_tpu.utils.serialization import flatten_params
from osufusion_tpu.utils.serialization import load_safetensors as jax_load_safetensors
from osufusion_tpu_torch.config import Config, DiffusionConfig, ModelConfig, TrainConfig
from osufusion_tpu_torch.models import build_model
from osufusion_tpu_torch.models.base import denoiser_class
from osufusion_tpu_torch.ops import flash_attention as fa
from osufusion_tpu_torch.serve import load_model
from osufusion_tpu_torch.trainer import train
from osufusion_tpu_torch.utils.convert import jax_flat_from_state_dict
from tests.torch_helpers import load_jax_params, random_variables

# the sizes here are tiny, and the suite runs several workers at once: a few
# threads each keep them from fighting over the cores
torch.set_num_threads(2)

# 4 heads of 8: DiT's sites are full MHA (H == Kv == 4); MMDiT's are GQA with
# max(1, 2) = 2 KV heads, two query heads each
TINY = dict(dim_h=32, attn_heads=4, attn_dim_head=8, depth=2, patch_size=4, dtype="float32")
BACKBONES = ["dit", "mmdit"]
B, N = 2, 64
# fp32 through two blocks: the port and XLA sum in other orders (the online
# softmax of the plain kernels vs one softmax, convolutions, norms), ~1e-6
# relative on the output; 1e-5 relative L2 is the bound
FWD_TOL = 1e-5
SAMPLE_TOL = 1e-4
# the loss and gradients: ~1e-6 relative on the loss, ~1e-5 on gradient leaves
# that sum over B * N frames
LOSS_TOL = 1e-5
GRAD_RTOL, GRAD_ATOL = 2e-3, 2e-5


def _inputs(n: int, seed: int = 0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, n, 6)).astype(np.float32)
    a = rng.normal(-10.0, 3.0, (B, n, 96)).astype(np.float32)
    t = np.array([10.0, 900.0], np.float32)
    c = rng.uniform(-1, 1, (B, 5)).astype(np.float32)
    return x, a, t, c


def _rel(got, want) -> float:
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


@pytest.fixture(scope="module", params=BACKBONES)
def pair(request):
    """(backbone, jax model, variables, torch model, torch module) with the
    same random weights (every kernel, bias, gamma and null_cond random)."""
    backbone = request.param
    jmodel = jax_build_model(JModelConfig(backbone=backbone, **TINY), JDiffusionConfig())
    args = (jnp.zeros((1, 32, 6)), jnp.zeros((1, 32, 96)), jnp.zeros((1,)), jnp.zeros((1, 5)), jnp.ones((1,), bool))
    variables = random_variables(jmodel.unet, *args, seed=4)
    model = build_model(ModelConfig(backbone=backbone, **TINY), DiffusionConfig())
    net = load_jax_params(denoiser_class(model.model_cfg)(model.model_cfg), variables)
    return backbone, jmodel, variables, model, net


@pytest.mark.parametrize("n", [N, 62], ids=["aligned", "unaligned"])
@pytest.mark.parametrize("cond", ["cond", "null-cond"])
def test_forward_matches_jax(pair, cond, n):
    """The forward; "null-cond" mixes a conditional and an unconditional row
    (the CFG batch); 62 frames is no multiple of MMDiT's patch of 4, so x and
    a are padded with their pad values and the output cropped."""
    backbone, jmodel, variables, _, net = pair
    x, a, t, c = _inputs(n)
    mask = np.array([True, cond == "cond"])
    want = np.asarray(jmodel.unet.apply(variables, *(jnp.asarray(v) for v in (x, a, t, c, mask))))
    with torch.no_grad():
        got = net(*(torch.from_numpy(v) for v in (x, a, t, c, mask))).numpy()
    assert got.shape == want.shape == (B, n, 6)
    assert _rel(got, want) < FWD_TOL


def test_dpmpp_sample_matches_jax(pair):
    """4 DPM-Solver++(2M) steps at CFG 2.0 from the same initial noise (the
    first-order first and last steps, two second-order steps between): eight
    forwards, each within FWD_TOL, through an update whose x0 extrapolation
    weights a step's difference by up to 1 + w1 < 2; SAMPLE_TOL is ten
    forwards' worth."""
    backbone, jmodel, variables, model, net = pair
    _, a, _, c = _inputs(N, seed=2)
    a_cf = np.ascontiguousarray(a.transpose(0, 2, 1))
    x0 = np.random.default_rng(3).standard_normal((B, 6, N)).astype(np.float32)
    want = np.asarray(jmodel.sample(variables, jnp.asarray(a_cf), jnp.asarray(c), x=jnp.asarray(x0), cond_scale=2.0,
                                    sampling_timesteps=4, method="dpmpp-2m"))
    got = model.sample(net, torch.from_numpy(a_cf), torch.from_numpy(c), x=torch.from_numpy(x0), cond_scale=2.0,
                       sampling_timesteps=4, method="dpmpp-2m").numpy()
    assert got.shape == want.shape == (B, 6, N)
    assert _rel(got, want) < SAMPLE_TOL


@pytest.fixture(scope="module")
def jax_loss(pair):
    """The JAX loss and gradients (jitted once) on one batch, with the draws
    that its ``DiffusionModel.loss`` makes from the key."""
    backbone, jmodel, variables, _, _ = pair
    x, a, _, c = (v.transpose(0, 2, 1) if v.ndim == 3 else v for v in _inputs(N, seed=1))
    orig_len = np.array([N, 41], np.int32)
    key = jax.random.PRNGKey(7)
    k_noise, k_t, k_drop = jax.random.split(key, 3)
    noise = np.asarray(jax.random.normal(k_noise, (B, N, 6), jnp.float32)).transpose(0, 2, 1)
    t = np.asarray(jax.random.randint(k_t, (B,), 0, 1000))
    cond_mask = np.asarray(jax.random.bernoulli(k_drop, 0.5, (B,)))
    want = jax.jit(jax.value_and_grad(jmodel.loss))(variables, key, *(jnp.asarray(v) for v in (x, a, c, orig_len)))
    batch = tuple(torch.from_numpy(np.ascontiguousarray(v)) for v in (x, a, c, orig_len))
    draws = tuple(torch.from_numpy(np.array(v)) for v in (noise, t, cond_mask))
    return batch, draws, want


@pytest.mark.parametrize("remat", [False, True], ids=["plain", "remat"])
def test_loss_and_gradients_match_jax(pair, jax_loss, monkeypatch, remat):
    """The diffusion loss and every parameter's gradient; under ``remat``
    (whole blocks, as ``nn.remat`` does) the gradients are the same and the
    backward runs each site's attention forward again."""
    backbone, _, variables, _, _ = pair
    batch, draws, (want_loss, want_grads) = jax_loss
    calls = []
    forward = fa.flash_fwd_lse_reference
    monkeypatch.setattr(fa, "flash_fwd_lse_reference", lambda *args: calls.append(args) or forward(*args))
    model = build_model(ModelConfig(backbone=backbone, remat=remat, **TINY), DiffusionConfig())
    net = load_jax_params(denoiser_class(model.model_cfg)(model.model_cfg), variables).train()
    loss = model.loss_from_draws(net, *batch, *draws)
    loss.backward()
    assert loss.item() == pytest.approx(float(want_loss), rel=LOSS_TOL)
    # the last MMDiT block's audio-stream output feeds nothing: its leaves get no
    # gradient in PyTorch and zeros in JAX
    grads = jax_flat_from_state_dict({name: torch.zeros_like(p) if p.grad is None else p.grad
                                      for name, p in net.named_parameters()})
    want_flat = flatten_params(want_grads)
    assert set(grads) == set(want_flat)
    scale = max(np.abs(v).max() for v in want_flat.values())
    for name, value in want_flat.items():
        # a leaf with tiny gradients is held to the tolerance of the largest leaf's scale
        np.testing.assert_allclose(grads[name], value, rtol=GRAD_RTOL, atol=GRAD_ATOL * max(1.0, scale), err_msg=name)
    # one attention forward per block, two under remat; the k each saw is (B, T, Kv, D)
    assert len(calls) == TINY["depth"] * (2 if remat else 1)
    kv = TINY["attn_heads"] if backbone == "dit" else 2
    assert all(args[1].shape[2] == kv and args[3] is None for args in calls)


def test_init_params_draws_as_flax_draws(pair):
    """Fresh parameters follow flax's initialisers, leaf by leaf against the
    JAX package's own init: zero leaves (modulations, output projections,
    biases) zero, RMSNorm gammas one, kernels of the same spread (xavier
    uniform, normal(0.02), the stem's lecun normal), ``null_cond`` ~ N(0, 1);
    seeded, and the global RNG is left alone."""
    backbone, jmodel, _, model, _ = pair
    before = torch.random.get_rng_state()
    params = model.init_params(seed=0, device="cpu")
    assert torch.equal(before, torch.random.get_rng_state())
    again, other = model.init_params(seed=0, device="cpu"), model.init_params(seed=1, device="cpu")
    for (name, p), q, r in zip(params.named_parameters(), again.parameters(), other.parameters()):
        assert torch.equal(p, q), name
        assert torch.equal(p, r) == (not p.any() or bool((p == 1).all())), name
    want = flatten_params(jmodel.init_params(jax.random.PRNGKey(0)))
    got = jax_flat_from_state_dict(params.state_dict())
    assert set(got) == set(want)
    checked = 0
    for name, value in want.items():
        value = np.asarray(value)
        assert got[name].shape == value.shape, name
        if not value.any() or (value == 1).all():
            np.testing.assert_array_equal(got[name], value, err_msg=name)
        elif value.size >= 1024:  # the sample std of n draws scatters by ~0.6 / sqrt(n) relative
            assert got[name].std() == pytest.approx(value.std(), rel=0.1), name
            assert np.abs(got[name]).max() <= 1.5 * np.abs(value).max(), name
            checked += 1
        else:
            assert got[name].any(), name
    assert checked >= 10


def test_trained_checkpoint_serves_in_jax(pair, tmp_path):
    """``train(cfg, device="cpu")`` on dummy data, 2 steps across a save and a
    resume: the ``model.safetensors`` it writes loads into the JAX package and
    gives the port's output (through ``serve.load_model``)."""
    backbone, _, _, _, _ = pair
    cfg = Config(model=ModelConfig(backbone=backbone, **TINY), diffusion=DiffusionConfig(),
                 train=TrainConfig(project_dir=str(tmp_path), dataset_mode="dummy", segment_length=32, batch_size=2,
                                   total_steps=1, save_every=1, num_workers=1, warmup_steps=1, lr=1e-3))
    history = train(cfg, device="cpu")
    history += train(dataclasses.replace(cfg, train=dataclasses.replace(cfg.train, total_steps=2, resume="latest")),
                     device="cpu")
    assert [h["step"] for h in history] == [1, 2]
    path = tmp_path / "model.safetensors"
    variables = jax_load_safetensors(path)
    jmodel = jax_build_model(JModelConfig(backbone=backbone, **TINY), JDiffusionConfig())
    model, params = load_model(path, device="cpu")
    assert type(params) is denoiser_class(model.model_cfg) and model.model_cfg.backbone == backbone
    x, a, t, c = _inputs(40, seed=2)
    mask = np.array([True, False])
    want = np.asarray(jmodel.unet.apply(variables, *(jnp.asarray(v) for v in (x, a, t, c, mask))))
    with torch.no_grad():
        got = params(*(torch.from_numpy(v) for v in (x, a, t, c, mask))).numpy()
    assert np.abs(want).max() > 0  # the step moved the zero-initialised output layer
    assert _rel(got, want) < FWD_TOL


@pytest.mark.parametrize("backbone", BACKBONES)
def test_width_must_be_heads_times_dim_head(backbone):
    """The attention output feeds the residual stream unprojected: both
    packages refuse heads x dim_head != dim_h."""
    cfg = dict(TINY, attn_heads=2)
    with pytest.raises(ValueError, match="attn_heads\\*attn_dim_head == dim_h"):
        build_model(ModelConfig(backbone=backbone, **cfg), DiffusionConfig()).init_params()
    jmodel = jax_build_model(JModelConfig(backbone=backbone, **cfg), JDiffusionConfig())
    with pytest.raises(AssertionError, match="attn_heads\\*attn_dim_head == dim_h"):
        jmodel.init_params(jax.random.PRNGKey(0))


def test_trainer_flags_reach_the_model_config():
    """``--model-backbone``, ``--model-depth``, ``--model-attn-heads`` and
    ``--model-attn-kv-heads`` size the transformer, as in the root trainer."""
    from osufusion_tpu_torch.trainer import parse_args

    cfg = parse_args(["--model-backbone", "mmdit", "--model-depth", "3", "--model-attn-heads", "8",
                      "--model-attn-kv-heads", "4", "--gradient-checkpointing"])
    m = cfg.model
    assert (m.backbone, m.depth, m.attn_heads, m.attn_kv_heads, m.remat) == ("mmdit", 3, 8, 4, True)
