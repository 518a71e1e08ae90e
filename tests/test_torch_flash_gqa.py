"""The plain versions of the port's attention kernels in their grouped forms
(K1 forward with its base-2 LSE, K2 fused backward; k and v (B, S, Kv, D))
against the JAX package's Pallas ``flash_attention`` run in interpret mode on
the CPU: full MHA (H == Kv, which the TPU kernel runs under its timestep
fold) and GQA (H = 8, Kv = 2, the MMDiT form), D = 64, with and without
rotary tables (DiT and MMDiT have none); fp32, small shapes.

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
from osufusion_tpu_torch.ops.rope import apply_rope, rope_tables, unapply_rope
from osufusion_tpu_torch.utils.flops import attention_flops

# the sizes here are small, and the suite runs several workers at once: a few
# threads each keep them from fighting over the cores
torch.set_num_threads(2)

D = 64
# fp32 both sides; the plain versions and the Pallas kernels sum the same
# products in different orders (one pass per query chunk vs an online softmax
# by KV block): ~1e-6 relative on o, ~1e-5 on gradients that sum T*G terms
ATOL, RTOL = 5e-5, 5e-4
# (B, T, H, Kv): full MHA at a length the TPU kernel folds timesteps at, and
# MMDiT's grouping
SHAPES = [(1, 512, 4, 4), (2, 256, 8, 2)]
CASES = [(*shape, rope) for shape in SHAPES for rope in (False, True)]
IDS = [f"B{b}-T{t}-H{h}-Kv{kv}-{'rope' if rope else 'norope'}" for b, t, h, kv, rope in CASES]


def _inputs(B, T, H, Kv):
    rng = np.random.default_rng(T + H + Kv)
    return tuple(rng.standard_normal(s).astype(np.float32) for s in ((B, T, H, D), (B, T, Kv, D), (B, T, Kv, D), (B, T, H, D)))


def _plain(inputs, rope: bool):
    """The port's plain forward (o, lse2) and backward (dq, dk, dv in the raw
    frames), with a KV chunk shorter than the sequence so the chunk loop runs
    more than once."""
    q, k, v, do = (torch.from_numpy(x) for x in inputs)
    T = q.shape[1]
    cos, sin = rope_tables(T, D, scale_base=float(T)) if rope else (None, None)
    k_rot = apply_rope(k, cos, sin) if rope else k
    saved, fa.REFERENCE_CHUNK = fa.REFERENCE_CHUNK, 96
    try:
        o, lse = fa.flash_fwd_lse_reference(q, k_rot, v, cos, sin)
        dq, dk_rot, dv = fa.flash_bwd_reference(q, k_rot, v, o, lse, do, cos, sin)
    finally:
        fa.REFERENCE_CHUNK = saved
    return o, lse, dq, unapply_rope(dk_rot, cos, sin) if rope else dk_rot, dv


def _exact_lse2(q, k, H, Kv, rope: bool):
    """The base-2 log-sum-exp of each (t, h) row's logits in float64, flat
    (B, T*H) in t-major order: query head h against KV head h // (H / Kv)."""
    T = q.shape[1]
    if rope:
        cos, sin = (t.double().numpy() for t in rope_tables(T, D, scale_base=float(T)))
        rot = lambda x: x * cos[None, :, None] + np.concatenate([-x[..., D // 2:], x[..., : D // 2]], -1) * sin[None, :, None]  # noqa: E731
        q, k = rot(q.astype(np.float64)), rot(k.astype(np.float64))
    kh = np.repeat(k.astype(np.float64), H // Kv, axis=2)  # head h reads KV head h // G
    s = np.einsum("bthd,bshd->bths", q, kh) * D**-0.5 * np.log2(np.e)
    m = s.max(-1, keepdims=True)
    return (m + np.log2(np.exp2(s - m).sum(-1, keepdims=True)))[..., 0].reshape(q.shape[0], -1)


@pytest.mark.parametrize("B,T,H,Kv,rope", CASES, ids=IDS)
def test_grouped_forward_and_lse_match_jax_kernel(B, T, H, Kv, rope):
    inputs = _inputs(B, T, H, Kv)
    o, lse = _plain(inputs, rope)[:2]
    q, k, v, _ = (jnp.asarray(x) for x in inputs)
    if H == Kv:
        assert pa._choose_tfold(T, T)[2] > 1, "the shape no longer exercises the TPU kernel's timestep fold"
    tables = jax_rope_tables(T, D, scale_base=float(T)) if rope else None
    with pltpu.force_tpu_interpret_mode():
        want = pa.flash_attention(q, k, v, None, tables)
    np.testing.assert_allclose(o.numpy(), np.asarray(want), atol=ATOL, rtol=RTOL)
    assert lse.shape == (B, T * H)
    np.testing.assert_allclose(lse.numpy(), _exact_lse2(inputs[0], inputs[1], H, Kv, rope), atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("B,T,H,Kv,rope", CASES, ids=IDS)
def test_grouped_backward_matches_jax_vjp(B, T, H, Kv, rope):
    inputs = _inputs(B, T, H, Kv)
    _, _, dq, dk, dv = _plain(inputs, rope)
    q, k, v, do = (jnp.asarray(x) for x in inputs)
    tables = jax_rope_tables(T, D, scale_base=float(T)) if rope else None
    with pltpu.force_tpu_interpret_mode():
        _, vjp = jax.vjp(lambda q, k, v: pa.flash_attention(q, k, v, None, tables), q, k, v)
        want = vjp(do)
    for name, got, ref in zip(("dq", "dk", "dv"), (dq, dk, dv), want):
        assert got.shape == ref.shape, name
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL, rtol=RTOL, err_msg=name)


@pytest.mark.parametrize("B,T,H,Kv", SHAPES, ids=[f"H{h}-Kv{kv}" for _, _, h, kv in SHAPES])
def test_planted_faults_lie_above_the_chip_bound(B, T, H, Kv):
    """The faults chip_smoke.py plants in the plain versions: query head h
    read against the wrong KV head (h % Kv instead of h // G for GQA; at full
    MHA, where the two agree, the next head) moves o far past the kernels'
    1e-2 relative L2 bound; an LSE off by 0.05 in base 2 scales p by 2^-0.05,
    so it moves dq, dk and dv by 3.4 %."""
    q, k, v, do = (torch.from_numpy(x) for x in _inputs(B, T, H, Kv))
    o, lse = fa.flash_fwd_lse_reference(q, k, v, None, None)
    G = H // Kv
    wrong = torch.arange(H) % Kv if G > 1 else (torch.arange(H) + 1) % H
    o_fault = fa.flash_fwd_lse_reference(q, k[:, :, wrong], v[:, :, wrong], None, None)[0]
    assert ((o_fault - o).norm() / o.norm()).item() > 0.1
    refs = fa.flash_bwd_reference(q, k, v, o, lse, do, None, None)
    faults = fa.flash_bwd_reference(q, k, v, o, lse + 0.05, do, None, None)
    for got, ref in zip(faults, refs):
        assert ((got - ref).norm() / ref.norm()).item() == pytest.approx(1 - 2**-0.05, rel=0.05)


def test_grouped_op_on_the_cpu_passes_opcheck():
    """``flash_attention_op`` with (B, T, Kv, D) keys and no tables: its fake
    and autograd registrations agree with the plain versions."""
    q, k, v, _ = (torch.from_numpy(x) for x in _inputs(1, 64, 8, 2))
    torch.library.opcheck(fa.flash_attention_op, (q.requires_grad_(True), k, v, None, None, -1))
    o, lse, k_rot = fa.flash_attention_op(q, k, v, None, None, -1)
    assert lse.shape == (1, 64 * 8) and k_rot.numel() == 0 and not lse.requires_grad


def test_flops_count_every_query_head():
    """Every query head visits every pair at a global site whatever Kv: the
    bound of K1 and K2 in their grouped forms is H x T x S pairs."""
    assert attention_flops("forward", 4, 4096, 8, 64, None) == 2 * 64 * 2 * 4 * 8 * 4096 * 4096
    assert attention_flops("backward_fused", 4, 2048, 8, 64, None) == 2 * 64 * 5 * 4 * 8 * 2048 * 2048


def test_wrappers_raise_on_what_the_kernels_do_not_take():
    """A CPU tensor, heads that do not split into the KV heads, one table
    without the other; and a windowed grouped site under a gradient has no
    backward kernel (on the GPU it raises before any work; here the grouped
    wrappers refuse)."""
    q, k, v, do = (torch.from_numpy(x).bfloat16() for x in _inputs(1, 64, 8, 2))
    cos, sin = rope_tables(64, D, scale_base=64.0)
    with pytest.raises(ValueError, match="CUDA"):
        fa.flash_fwd(q, k, v, None, None, -1, D**-0.5, return_lse=True)
    with pytest.raises(ValueError, match="KV heads"):
        fa.flash_fwd(q, k[:, :, :1].expand(-1, -1, 3, -1).contiguous(), v[:, :, :1].expand(-1, -1, 3, -1).contiguous(),
                     None, None, -1, D**-0.5)
    with pytest.raises(ValueError, match="both"):
        fa.flash_bwd(q, k, v, q, torch.zeros(1, 64 * 8), do, cos, None, D**-0.5)
    with pytest.raises(ValueError, match="K3"):
        fa.flash_bwd_dq(q, k, v, q, torch.zeros(1, 64 * 8), do, cos, sin, 32, D**-0.5)
