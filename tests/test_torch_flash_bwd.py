"""The plain versions of the port's training attention kernels (forward with
the base-2 LSE, fused backward) against the JAX package's Pallas kernels run
in interpret mode on the CPU, and against torch autograd; fp32, tiny shapes.

The CUDA kernels themselves are held against these plain versions on a GPU
(tests/test_torch_kernels.py, chip_smoke.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from osufusion_tpu.ops import pallas_attention as pa
from osufusion_tpu.ops.rope import rope_tables as jax_rope_tables
from osufusion_tpu_torch.ops import flash_attention as fa
from osufusion_tpu_torch.ops.attention import sdpa
from osufusion_tpu_torch.ops.rope import apply_rope, rope_tables, unapply_rope

# the sizes here are tiny, and the suite runs several workers at once: a few
# threads each keep them from fighting over the cores
torch.set_num_threads(2)

B, T, H, D = 2, 256, 4, 64
# fp32 both sides; the kernels and the plain versions sum the same products
# in different orders (online softmax by KV block vs one pass): ~1e-6 relative
# on o, and ~1e-5 on gradients that sum T*H terms
ATOL, RTOL = 5e-5, 5e-4


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(0)
    q = rng.standard_normal((B, T, H, D)).astype(np.float32)
    k = rng.standard_normal((B, T, 1, D)).astype(np.float32)
    v = rng.standard_normal((B, T, 1, D)).astype(np.float32)
    do = rng.standard_normal((B, T, H, D)).astype(np.float32)
    return q, k, v, do


@pytest.fixture(scope="module")
def plain(inputs):
    """The port's plain forward (o, lse2) and backward (dq, dk, dv in the raw
    frames) on the module's inputs, with a KV tile shorter than the sequence
    so the tile loop runs more than once."""
    q, k, v, do = (torch.from_numpy(x) for x in inputs)
    cos, sin = rope_tables(T, D, scale_base=float(T))
    k_rot = apply_rope(k.reshape(B, T, D), cos, sin)
    chunk, fa.REFERENCE_CHUNK = fa.REFERENCE_CHUNK, 96
    try:
        o, lse = fa.flash_fwd_lse_reference(q, k_rot, v.reshape(B, T, D), cos, sin)
        dq, dk_rot, dv = fa.flash_bwd_reference(q, k_rot, v.reshape(B, T, D), o, lse, do, cos, sin)
    finally:
        fa.REFERENCE_CHUNK = chunk
    return o, lse, dq, unapply_rope(dk_rot, cos, sin), dv


def test_forward_and_lse_match_jax_kernel(inputs, plain):
    q, k, v, _ = (jnp.asarray(x) for x in inputs)
    cos, sin = jax_rope_tables(T, D, scale_base=float(T))
    scale = D**-0.5 * pa.LOG2E
    bq, bk, fold = pa._choose_blocks(T, T, H)
    bq = pa._pick_block(T, max(64, 1024 // H))
    q_tables = (jnp.repeat(cos * scale, fold, axis=0), jnp.repeat(sin * scale, fold, axis=0))
    k_rot = pa._rotate_rank3(k.reshape(B, T, D), cos, sin)
    with pltpu.force_tpu_interpret_mode():
        o, lse = pa._flash_fwd(q, k_rot, v.reshape(B, T, D), fold, bq, bk, None, fast=False, rope=q_tables, dense=False)
    np.testing.assert_allclose(plain[0].numpy(), np.asarray(o), atol=ATOL, rtol=RTOL)
    # both are the base-2 LSE of q_rot k_rot^T * D^-0.5 * log2(e), flat (B, T*H) in t-major order
    np.testing.assert_allclose(plain[1].numpy(), np.asarray(lse).reshape(B, T * H), atol=ATOL, rtol=RTOL)


def test_backward_matches_jax_vjp(inputs, plain):
    q, k, v, do = (jnp.asarray(x) for x in inputs)
    tables = jax_rope_tables(T, D, scale_base=float(T))
    with pltpu.force_tpu_interpret_mode():
        _, vjp = jax.vjp(lambda q, k, v: pa.flash_attention(q, k, v, None, tables), q, k, v)
        dq, dk, dv = vjp(do)
    np.testing.assert_allclose(plain[2].numpy(), np.asarray(dq), atol=ATOL, rtol=RTOL, err_msg="dq")
    np.testing.assert_allclose(plain[3].numpy(), np.asarray(dk).reshape(B, T, D), atol=ATOL, rtol=RTOL, err_msg="dk")
    np.testing.assert_allclose(plain[4].numpy(), np.asarray(dv).reshape(B, T, D), atol=ATOL, rtol=RTOL, err_msg="dv")


def test_backward_matches_torch_autograd(inputs, plain):
    q, k, v, do = (torch.from_numpy(x).requires_grad_(True) for x in inputs)
    rope = rope_tables(T, D, scale_base=float(T))
    out = fa.flash_attention_reference(q, k, v, None, rope)
    out.backward(do.detach())
    np.testing.assert_allclose(plain[0].numpy(), out.detach().numpy(), atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(plain[2].numpy(), q.grad.numpy(), atol=ATOL, rtol=RTOL, err_msg="dq")
    np.testing.assert_allclose(plain[3].numpy(), k.grad.reshape(B, T, D).numpy(), atol=ATOL, rtol=RTOL, err_msg="dk")
    np.testing.assert_allclose(plain[4].numpy(), v.grad.reshape(B, T, D).numpy(), atol=ATOL, rtol=RTOL, err_msg="dv")


def test_planted_lse_fault_shows_in_every_gradient(inputs, plain):
    """The fault chip_smoke.py plants in the plain backward (an LSE off by
    0.05 in base 2) scales p by 2^-0.05, so it moves dq, dk and dv by 3.4 %."""
    q, k, v, do = (torch.from_numpy(x) for x in inputs)
    cos, sin = rope_tables(T, D, scale_base=float(T))
    k_rot = apply_rope(k.reshape(B, T, D), cos, sin)
    dq, dk_rot, dv = fa.flash_bwd_reference(q, k_rot, v.reshape(B, T, D), plain[0], plain[1] + 0.05, do, cos, sin)
    for got, ref in ((dq, plain[2]), (unapply_rope(dk_rot, cos, sin), plain[3]), (dv, plain[4])):
        assert ((got - ref).norm() / ref.norm()).item() == pytest.approx(1 - 2**-0.05, rel=0.05)


def test_function_and_wrappers_raise_on_cpu_tensors(inputs):
    q, k, v, do = (torch.from_numpy(x) for x in inputs)
    cos, sin = rope_tables(T, D, scale_base=float(T))
    with pytest.raises(ValueError, match="CUDA"):
        fa.flash_fwd(q.bfloat16(), k.reshape(B, T, D).bfloat16(), v.reshape(B, T, D).bfloat16(), cos, sin, -1, D**-0.5,
                     return_lse=True)
    with pytest.raises(ValueError, match="CUDA"):
        fa.flash_bwd(q.bfloat16(), k.reshape(B, T, D).bfloat16(), v.reshape(B, T, D).bfloat16(), q.bfloat16(),
                     torch.zeros(B, T * H), do.bfloat16(), cos, sin, D**-0.5)
    with pytest.raises(ValueError, match="CUDA"):
        fa.flash_attention(q, k, v, None, (cos, sin))


def test_cpu_dispatch_keeps_native_autograd(inputs):
    """On the CPU sdpa is differentiable by autograd, at a windowed site too:
    through the plain versions of the kernels for MQA self-attention, through
    the plain forward otherwise."""
    q, k, v, _ = (torch.from_numpy(x).requires_grad_(True) for x in inputs)
    out = sdpa(q, k, v, 64, rope_tables(T, D, scale_base=64.0))
    out.sum().backward()
    assert all(t.grad is not None and torch.isfinite(t.grad).all() for t in (q, k, v))
    q, k, v, _ = (torch.from_numpy(x).requires_grad_(True) for x in inputs)
    out = sdpa(q, k.repeat(1, 1, 2, 1), v.repeat(1, 1, 2, 1), 64, rope_tables(T, D, scale_base=64.0))  # two KV heads
    out.sum().backward()
    assert all(t.grad is not None and torch.isfinite(t.grad).all() for t in (q, k, v))
