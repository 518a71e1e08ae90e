"""Every UNet building block of the PyTorch port against its flax counterpart
in the JAX package: the same (perturbed) parameters through
``state_dict_from_jax``, the same seeded numpy inputs, fp32 on the CPU."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from osufusion_tpu.nn import blocks as jb
from osufusion_tpu_torch.nn import blocks as tb
from tests.torch_helpers import load_jax_params, random_variables

# the sizes here are tiny, and the suite runs several workers at once: a few
# threads each keep them from fighting over the cores
torch.set_num_threads(2)

# fp32 on both sides; the differences are summation order (conv as shifted
# matmuls vs cuDNN/MKL, one-pass vs two-pass norm variance), ~1e-6 relative
TOL = 1e-4
B, T = 2, 48


def _arr(rng, shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


# name -> (flax module, torch module, function of a numpy Generator giving the inputs)
def _cases():
    emb = 32  # width of each of the t / c embeddings
    return {
        "TimeEmbedding": (jb.TimeEmbedding(32), tb.TimeEmbedding(32), lambda r: [r.uniform(0, 999, (B,)).astype(np.float32)]),
        "CondEmbedding": (jb.CondEmbedding(32), tb.CondEmbedding(5, 32), lambda r: [_arr(r, (B, 5))]),
        "CrossEmbedLayer-signal": (jb.CrossEmbedLayer(40), tb.CrossEmbedLayer(6, 40), lambda r: [_arr(r, (B, T, 6))]),
        "CrossEmbedLayer-audio": (jb.CrossEmbedLayer(80), tb.CrossEmbedLayer(96, 80), lambda r: [_arr(r, (B, T, 96))]),
        "CrossEmbedLayer-fallback": (jb.CrossEmbedLayer(32), tb.CrossEmbedLayer(96, 32), lambda r: [_arr(r, (B, T, 96))]),
        "Downsample": (jb.Downsample(24), tb.Downsample(16, 24), lambda r: [_arr(r, (B, T, 16))]),
        "Downsample-wide": (jb.Downsample(24), tb.Downsample(64, 24), lambda r: [_arr(r, (B, T, 64))]),
        "Upsample": (jb.Upsample(24), tb.Upsample(64, 24), lambda r: [_arr(r, (B, T, 64))]),
        "ParallelConvOut": (jb.ParallelConvOut(24), tb.ParallelConvOut(64, 24), lambda r: [_arr(r, (B, T, 64))]),
        "GlobalContext": (jb.GlobalContext(16), tb.GlobalContext(16, 16), lambda r: [_arr(r, (B, T, 16))]),
        "SqueezeExcite": (jb.SqueezeExcite(16), tb.SqueezeExcite(16, 16), lambda r: [_arr(r, (B, T, 16))]),
        "FiLMBlock": (jb.FiLMBlock(24), tb.FiLMBlock(16, 24), lambda r: [_arr(r, (B, T, 16)), (_arr(r, (B, 24)), _arr(r, (B, 24)))]),
        "ResidualBlock": (
            jb.ResidualBlock(24), tb.ResidualBlock(16, 24, 2 * emb),
            lambda r: [_arr(r, (B, T, 16)), _arr(r, (B, emb)), _arr(r, (B, emb))],
        ),
        "ResidualBlock-se-same-width": (
            jb.ResidualBlock(64, use_gca=False), tb.ResidualBlock(64, 64, 2 * emb, use_gca=False),
            lambda r: [_arr(r, (B, T, 64)), _arr(r, (B, emb)), _arr(r, (B, emb))],
        ),
        "ResidualBlock-no-cond": (jb.ResidualBlock(24, has_time_cond=False), tb.ResidualBlock(16, 24), lambda r: [_arr(r, (B, T, 16))]),
        "Attention-windowed": (
            jb.Attention(dim_head=64, heads=4, kv_heads=1, context_len=16),
            tb.Attention(32, dim_head=64, heads=4, kv_heads=1, context_len=16), lambda r: [_arr(r, (B, T, 32))],
        ),
        "Attention-global-gqa": (
            jb.Attention(dim_head=64, heads=4, kv_heads=2, context_len=64),
            tb.Attention(32, dim_head=64, heads=4, kv_heads=2, context_len=64), lambda r: [_arr(r, (B, T, 32))],
        ),
        "FeedForward": (jb.FeedForward(32), tb.FeedForward(32), lambda r: [_arr(r, (B, T, 32))]),
        "TransformerBlock": (
            jb.TransformerBlock(32, attn_heads=2, attn_context_len=16),
            tb.TransformerBlock(32, attn_heads=2, attn_context_len=16), lambda r: [_arr(r, (B, T, 32))],
        ),
    }


CASES = _cases()


def _to_jax(x):
    return tuple(_to_jax(e) for e in x) if isinstance(x, tuple) else jnp.asarray(x)


def _to_torch(x):
    return tuple(_to_torch(e) for e in x) if isinstance(x, tuple) else torch.from_numpy(x)


@pytest.mark.parametrize("name", list(CASES))
def test_block_matches_flax(name):
    flax_mod, torch_mod, make_inputs = CASES[name]
    inputs = make_inputs(np.random.default_rng(len(name)))
    jax_inputs = [_to_jax(x) for x in inputs]
    variables = random_variables(flax_mod, *jax_inputs, seed=1)
    want = np.asarray(jax.jit(flax_mod.apply)(variables, *jax_inputs))
    with torch.no_grad():
        got = load_jax_params(torch_mod, variables)(*[_to_torch(x) for x in inputs]).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)


def test_sinusoidal_embedding_matches_flax():
    t = np.random.default_rng(0).uniform(0, 999, (5,)).astype(np.float32)
    want = np.asarray(jb.sinusoidal_embedding(jnp.asarray(t), 64))
    np.testing.assert_allclose(tb.sinusoidal_embedding(torch.from_numpy(t), 64).numpy(), want, atol=TOL, rtol=TOL)
