"""The port's attention (``sdpa``'s plain path, which CPU tensors take) against the
JAX package's Pallas flash kernel, run in TPU interpret mode as
tests/test_pallas_attention.py runs it, with fused RoPE, windowed and global."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from osufusion_tpu.ops import pallas_attention as pa
from osufusion_tpu.ops.rope import rope_tables as jax_rope_tables
from osufusion_tpu_torch.ops import flash_attention as fa
from osufusion_tpu_torch.ops.attention import gqa_attention, sdpa
from osufusion_tpu_torch.ops.rope import apply_rope, rope_tables

# exact mode: both sides fp32 with fp32 softmax; only the summation order
# differs (online exp2 softmax over KV blocks vs one softmax per row)
EXACT_TOL = 2e-5
# inference mode: the TPU kernel keeps its logits and probabilities in bf16
# (its `fast` path) against the port's fp32 softmax: bf16-level error
FAST_TOL = 2e-2


def _qkv(B, T, H, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in ((B, T, H, 64), (B, T, 1, 64), (B, T, 1, 64))]


CASES = [(2, 256, 4, 128, 256.0), (1, 512, 16, 256, 64.0), (2, 256, 4, None, 256.0), (1, 256, 2, 512, 128.0)]


@pytest.mark.parametrize("B,T,H,window,scale_base", CASES)
def test_flash_attention_matches_pallas(B, T, H, window, scale_base):
    q, k, v = _qkv(B, T, H, seed=T + H)
    with pltpu.force_tpu_interpret_mode():
        want = pa.flash_attention(*map(jnp.asarray, (q, k, v)), window=window, rope=jax_rope_tables(T, 64, scale_base))
    got = sdpa(*map(torch.from_numpy, (q, k, v)), window, rope_tables(T, 64, scale_base))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=EXACT_TOL, rtol=EXACT_TOL)


def test_flash_attention_matches_pallas_inference_mode():
    """The serving-path form of the TPU kernel: fused RoPE, windowed, bf16 logits."""
    B, T, H, window = 1, 1024, 16, 512
    q, k, v = _qkv(B, T, H, seed=7)
    tables = jax_rope_tables(T, 64, 512.0)
    with pltpu.force_tpu_interpret_mode():
        with pa.inference_attention():
            want = pa.flash_attention(*(jnp.asarray(x, jnp.bfloat16) for x in (q, k, v)), window=window, rope=tables)
    bf16 = [torch.from_numpy(x).to(torch.bfloat16).float() for x in (q, k, v)]
    got = sdpa(*bf16, window, rope_tables(T, 64, 512.0))
    err = np.abs(got.numpy() - np.asarray(want, np.float32)).max()
    assert err < FAST_TOL, f"max abs err {err}"


def test_rope_tables_match_jax():
    cos, sin = rope_tables(300, 64, scale_base=128.0)
    jcos, jsin = jax_rope_tables(300, 64, 128.0)
    np.testing.assert_allclose(cos.numpy(), np.asarray(jcos), atol=1e-6)
    np.testing.assert_allclose(sin.numpy(), np.asarray(jsin), atol=1e-6)


def test_cpu_tensors_take_the_plain_path():
    """A CPU tensor never reaches the kernel: sdpa equals the plain version
    and the launch count does not move."""
    q, k, v = map(torch.from_numpy, _qkv(1, 96, 4, seed=3))
    rope = rope_tables(96, 64, 32.0)
    before = fa.flash_fwd.launches
    out = sdpa(q, k, v, 32, rope)
    assert fa.flash_fwd.launches == before
    ref = gqa_attention(apply_rope(q, *rope), apply_rope(k, *rope), v, window=32)
    torch.testing.assert_close(out, ref, atol=0, rtol=0)


def test_kernel_wrapper_refuses_cpu_tensors():
    """Only sdpa falls back to the plain version; the kernel's wrapper raises."""
    q, k, v = map(torch.from_numpy, _qkv(1, 64, 2, seed=6))
    with pytest.raises(ValueError, match="CUDA"):
        fa.flash_attention(q, k, v, None, rope_tables(64, 64, 64.0))


def test_window_covering_sequence_equals_global():
    q, k, v = map(torch.from_numpy, _qkv(1, 64, 2, seed=4))
    torch.testing.assert_close(gqa_attention(q, k, v, window=64), gqa_attention(q, k, v), atol=0, rtol=0)
    assert not torch.allclose(gqa_attention(q, k, v, window=16), gqa_attention(q, k, v), atol=1e-3)


@pytest.mark.parametrize("window", [24, None])
def test_query_chunks_change_nothing(monkeypatch, window):
    """Chunking the queries (and slicing each chunk's keys to its window)
    gives the one-chunk result."""
    from osufusion_tpu_torch.ops import attention

    q, k, v = map(torch.from_numpy, _qkv(2, 200, 4, seed=5))
    whole = gqa_attention(q, k, v, window=window)
    monkeypatch.setattr(attention, "QUERY_CHUNK", 48)
    torch.testing.assert_close(gqa_attention(q, k, v, window=window), whole, atol=1e-6, rtol=1e-6)
