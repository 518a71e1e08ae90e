"""A windowed attention site with more than one KV head, under a gradient:
the port runs it once per KV head on that head's query heads, as the JAX
package's ``flash_attention`` does, so the windowed dq / dkv pair (MQA with
rotary tables) serves it. On the CPU that route runs the plain versions; here
it is held to the JAX package's Pallas kernels in interpret mode, alone and
inside a UNet with two KV heads trained at four times its attention context,
where the model reaches the same route through ``ops/attention.py::sdpa``.
fp32, small shapes."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from osufusion_tpu.config import DiffusionConfig as JDiffusionConfig
from osufusion_tpu.config import ModelConfig as JModelConfig
from osufusion_tpu.models import build_model as jax_build_model
from osufusion_tpu.ops import pallas_attention as pa
from osufusion_tpu.ops.rope import rope_tables as jax_rope_tables
from osufusion_tpu.utils.serialization import flatten_params
from osufusion_tpu_torch.config import DiffusionConfig, ModelConfig
from osufusion_tpu_torch.models import build_model
from osufusion_tpu_torch.nn.unet import UNet
from osufusion_tpu_torch.ops import attention
from osufusion_tpu_torch.ops import flash_attention as fa
from osufusion_tpu_torch.ops.rope import rope_tables
from osufusion_tpu_torch.utils.convert import jax_flat_from_state_dict
from tests.torch_helpers import load_jax_params, random_variables

# the sizes here are small, and the suite runs several workers at once: a few
# threads each keep them from fighting over the cores
torch.set_num_threads(2)

D = 64
# fp32 both sides; the plain versions and the Pallas kernels sum the same
# products in different orders (one pass per query chunk vs an online softmax
# by KV block): ~1e-6 relative on o, ~1e-5 on gradients that sum W*G terms
ATOL, RTOL = 5e-5, 5e-4


@pytest.mark.parametrize("Kv", [2, 4])
def test_windowed_gqa_site_matches_jax_kernel(Kv, monkeypatch):
    """T = 128 against a window of 32, 4 query heads on 2 or 4 KV heads:
    forward and the three gradients, and one plain forward per KV head (the
    per-head route)."""
    T, H, window = 128, 4, 32
    rng = np.random.default_rng(40 + Kv)
    q, k, v, do = (rng.standard_normal(s).astype(np.float32) for s in ((1, T, H, D), (1, T, Kv, D), (1, T, Kv, D), (1, T, H, D)))
    calls = []
    plain = fa.flash_fwd_lse_reference
    monkeypatch.setattr(fa, "flash_fwd_lse_reference", lambda *a: calls.append(a[1].shape) or plain(*a))
    leaves = [torch.from_numpy(x).requires_grad_(True) for x in (q, k, v)]
    out = fa.flash_attention(*leaves, window, rope_tables(T, D, scale_base=float(T)))
    out.backward(torch.from_numpy(do))
    assert calls == [(1, T, D)] * Kv  # MQA operands, once per KV head
    tables = jax_rope_tables(T, D, scale_base=float(T))
    with pltpu.force_tpu_interpret_mode():
        want_o, vjp = jax.vjp(lambda q, k, v: pa.flash_attention(q, k, v, window, tables), *map(jnp.asarray, (q, k, v)))
        want = vjp(jnp.asarray(do))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want_o), atol=ATOL, rtol=RTOL, err_msg="o")
    for name, got, ref in zip(("dq", "dk", "dv"), leaves, want):
        assert got.grad.shape == got.shape
        np.testing.assert_allclose(got.grad.numpy(), np.asarray(ref), atol=ATOL, rtol=RTOL, err_msg=name)


# a UNet of one level whose attention has 4 query heads on 2 KV heads, at
# four times its context (256 frames against 64), so every site is a windowed
# GQA site. fp32 through ~30 layers forward and back:
# summation order differs between XLA and PyTorch, ~1e-5 relative on the loss
# and ~1e-4 on gradient leaves that sum over the frames
TINY_GQA = dict(dim_h=32, dim_h_mult=(1,), num_layer_blocks=(1,), num_middle_transformers=1,
                attn_heads=4, attn_kv_heads=2, attn_context_len=64, dtype="float32")
LOSS_TOL = 1e-5
GRAD_RTOL, GRAD_ATOL = 2e-3, 2e-5


def test_unet_with_two_kv_heads_trains_at_a_windowed_length_like_jax(monkeypatch):
    """Loss and every gradient against the JAX package, and the route: each
    windowed site runs one plain forward per KV head on MQA operands."""
    jmodel = jax_build_model(JModelConfig(**TINY_GQA), JDiffusionConfig())
    args = (jnp.zeros((1, 32, 6)), jnp.zeros((1, 32, 96)), jnp.zeros((1,)), jnp.zeros((1, 5)), jnp.ones((1,), bool))
    variables = random_variables(jmodel.unet, *args, seed=9)
    n = 4 * TINY_GQA["attn_context_len"]
    rng = np.random.default_rng(12)
    x = rng.standard_normal((1, 6, n)).astype(np.float32)
    a = rng.normal(-10.0, 3.0, (1, 96, n)).astype(np.float32)
    c = rng.uniform(-1, 1, (1, 5)).astype(np.float32)
    orig_len = np.array([n - 21], np.int32)
    key = jax.random.PRNGKey(6)
    # the draws of osufusion_tpu.models.diffusion.DiffusionModel.loss, which works channel-last
    k_noise, k_t, k_drop = jax.random.split(key, 3)
    noise = np.asarray(jax.random.normal(k_noise, (1, n, 6), jnp.float32)).transpose(0, 2, 1)
    draws = (torch.from_numpy(noise.copy()), torch.from_numpy(np.array(jax.random.randint(k_t, (1,), 0, 1000))),
             torch.from_numpy(np.array(jax.random.bernoulli(k_drop, 0.5, (1,)))))
    want_loss, want_grads = jax.jit(jax.value_and_grad(jmodel.loss))(
        variables, key, jnp.asarray(x), jnp.asarray(a), jnp.asarray(c), jnp.asarray(orig_len))

    model = build_model(ModelConfig(**TINY_GQA), DiffusionConfig())
    params = load_jax_params(UNet(model.model_cfg), variables).train()
    sites, forwards = [], []
    site, plain = attention.flash_attention, fa.flash_fwd_lse_reference

    def counted_site(q, k, v, window, rope):
        sites.append((k.shape[2], window is not None and k.shape[1] > window))
        return site(q, k, v, window, rope)

    monkeypatch.setattr(attention, "flash_attention", counted_site)
    monkeypatch.setattr(fa, "flash_fwd_lse_reference", lambda *a: forwards.append(a[1].dim()) or plain(*a))
    loss = model.loss_from_draws(params, *(torch.from_numpy(v) for v in (x, a, c)), torch.from_numpy(orig_len), *draws)
    loss.backward()
    windowed = sum(w for _, w in sites)
    assert windowed > 0 and all(kv == 2 for kv, _ in sites)
    assert forwards.count(3) == 2 * windowed  # (B, T, D): MQA operands, once per KV head
    assert forwards.count(4) == len(sites) - windowed  # a global site keeps the grouped form
    grads = jax_flat_from_state_dict({name: p.grad for name, p in params.named_parameters()})
    assert loss.item() == pytest.approx(float(want_loss), rel=LOSS_TOL)
    want_flat = flatten_params(want_grads)
    assert set(grads) == set(want_flat)
    scale = max(np.abs(v).max() for v in want_flat.values())
    for name, value in want_flat.items():
        np.testing.assert_allclose(grads[name], value, rtol=GRAD_RTOL, atol=GRAD_ATOL * max(1.0, scale), err_msg=name)
