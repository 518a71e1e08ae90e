"""The attention forms beside bf16 at head dim 64, on the CPU: the form rule
(``ops/flash_forms.py::attention_form`` and, per wrapper, ``kernel_form``),
which decides on the card between the wgmma kernels, the forms kernels, their
chunked instance and the JAX package's XLA route; ``sdpa`` in fp32 at D = 32
(the XLA route) and D = 128 (a forms kernel's form) against the JAX
package's ``sdpa`` as its own tests run it on the CPU (the XLA einsum, and
for D = 128 the Pallas kernel in interpret mode); the plain forward, dq and
dkv at D = 128 against the Pallas kernels in interpret mode, and the plain
forward and backward at fp16 / D = 64 and at fp32 and bf16 / D = 320 (the
forms kernels' fp16 and chunked instances) against ``pa.flash_attention``
in interpret mode; and the halo rule at D = 128 against the JAX package's.

The forms kernels themselves are held against these plain versions on a GPU
(tests/test_torch_kernels.py, chip_smoke.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from osufusion_tpu.ops import pallas_attention as pa
from osufusion_tpu.ops.attention import sdpa as jax_sdpa
from osufusion_tpu.ops.rope import rope_tables as jax_rope_tables
from osufusion_tpu.parallel.sequence import seq_parallel_available as jax_seq_parallel_available
from osufusion_tpu_torch.ops import flash_attention as fa
from osufusion_tpu_torch.ops.attention import sdpa
from osufusion_tpu_torch.ops.flash_forms import FORMS_HEAD_DIMS, WIDE_WGMMA, attention_form, kernel_form
from osufusion_tpu_torch.ops.rope import apply_rope, rope_tables, unapply_rope
from osufusion_tpu_torch.parallel.sequence import seq_parallel_available

# the sizes here are tiny, and the suite runs several workers at once: a few
# threads each keep them from fighting over the cores
torch.set_num_threads(2)

# fp32 both sides: the same products summed in another order (online softmax
# by KV block against one softmax per row, or chunked einsums), ~1e-6
# relative on o and ~1e-5 on gradients that sum T * H terms, as in
# tests/test_torch_flash_windowed.py
ATOL, RTOL = 5e-5, 5e-4


# every wrapper that chooses between a wgmma entry point and a forms one
WRAPPERS = ("flash_fwd", "halo_fwd", "flash_bwd", "flash_bwd_prep", "flash_bwd_sweep", "flash_bwd_post",
            "flash_bwd_dq", "flash_bwd_dkv", "halo_bwd_dq", "halo_bwd_dkv", "ring_merge")


def _expected_form(who, dtype, D):
    if D % 64:
        return "xla"
    if D > 256:
        return "chunked"
    if dtype == torch.bfloat16 and (D == 64 or who in WIDE_WGMMA):
        return "hopper"
    return "forms"


FORM_DTYPES = [torch.float32, torch.bfloat16, torch.float16]
FORM_DIMS = [16, 32, 48, 64, 96, 128, 192, 256, 320, 512]


@pytest.mark.parametrize("D", FORM_DIMS)
@pytest.mark.parametrize("dtype", FORM_DTYPES, ids=["fp32", "bf16", "fp16"])
def test_attention_form_table(dtype, D):
    """The JAX package runs Pallas at any dtype and a head dim that is a
    multiple of 64, XLA at every other head dim; on the card the port runs
    the XLA route where D % 64 != 0 and a kernel everywhere else, nothing
    raising: per wrapper, the wgmma kernels at bf16 with D = 64, and with D =
    128, 192, 256 for the forward, the global backward's sweep and the
    windowed pair with its halo instances (K1, K2, K3a / K3b, K5a / K5b); the
    forms kernels at fp32 and fp16, and at bf16 with D > 64 for the ring's
    merge and the global backward's pre-pass and post-pass; the chunked forms
    instance at every dtype above D = 256."""
    assert attention_form(dtype, D) == _expected_form("flash_fwd", dtype, D)
    for who in WRAPPERS:
        if D % 64:
            with pytest.raises(ValueError, match="no kernel takes head dim"):
                kernel_form(who, dtype, D)
        else:
            assert kernel_form(who, dtype, D) == _expected_form(who, dtype, D), who
    assert FORMS_HEAD_DIMS == (64, 128, 192, 256)
    assert WIDE_WGMMA == {"flash_fwd", "halo_fwd", "flash_bwd", "flash_bwd_sweep", "flash_bwd_dq", "flash_bwd_dkv",
                          "halo_bwd_dq", "halo_bwd_dkv"}
    # no wrapper at bf16 with D <= 256 is left on the forms bodies but the merge and the global pre- and post-pass
    if dtype == torch.bfloat16 and D in (128, 192, 256):
        assert {who for who in WRAPPERS if kernel_form(who, dtype, D) == "forms"} == {
            "flash_bwd_prep", "flash_bwd_post", "ring_merge"}


def _qkv(T, H, D, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in ((1, T, H, D), (1, T, 1, D), (1, T, 1, D), (1, T, H, D))]


# (D, window): the XLA route and a forms kernel's form, windowed and global
SDPA_CASES = [(32, 64), (32, None), (128, 64), (128, None)]


@pytest.mark.parametrize("grad", [False, True], ids=["forward", "gradient"])
@pytest.mark.parametrize("D,window", SDPA_CASES, ids=[f"D{d}-{'W' + str(w) if w else 'global'}" for d, w in SDPA_CASES])
def test_sdpa_in_fp32_matches_the_jax_package(D, window, grad):
    """``sdpa`` on CPU tensors in fp32 (every form through the plain
    versions) against the JAX package's ``sdpa``: at D = 32 its XLA route,
    which is what the port runs on the card; at D = 128 its Pallas kernel in
    interpret mode. With ``grad``, the gradients of q, k and v too."""
    T, H, scale_base = 256, 4, 128.0
    q, k, v, do = _qkv(T, H, D, seed=D + (window or 0))
    tables = jax_rope_tables(T, D, scale_base)
    backend = "pallas" if D % 64 == 0 else "auto"

    def jax_attention(q, k, v):
        return jax_sdpa(q, k, v, backend=backend, window=window, rope=tables)

    with pltpu.force_tpu_interpret_mode():
        if grad:
            want, vjp = jax.vjp(jax_attention, *map(jnp.asarray, (q, k, v)))
            want_grads = vjp(jnp.asarray(do))
        else:
            want = jax_attention(*map(jnp.asarray, (q, k, v)))
    leaves = [torch.from_numpy(x).requires_grad_(grad) for x in (q, k, v)]
    got = sdpa(*leaves, window, rope_tables(T, D, scale_base))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=ATOL, rtol=RTOL)
    if grad:
        got.backward(torch.from_numpy(do))
        for name, leaf, g in zip("qkv", leaves, want_grads):
            np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(g), atol=ATOL, rtol=RTOL, err_msg=f"d{name}")


# (T, window, H) at D = 128: a window inside the sequence, and a global site
D128_GEOMETRIES = [(256, 128, 2), (256, None, 2)]
D128_IDS = ["T256-W128", "T256-global"]


def _plain_d128(inputs, T, window):
    """The port's plain forward (o, lse2) and backward (dq, dk, dv in the raw
    frames) at D = 128, with the window as the kernels take it."""
    D = 128
    q, k, v, do = (torch.from_numpy(x) for x in inputs)
    k, v = k.reshape(1, T, D), v.reshape(1, T, D)
    w = -1 if window is None else window
    cos, sin = rope_tables(T, D, scale_base=float(T))
    k_rot = apply_rope(k, cos, sin)
    o, lse = fa.flash_fwd_lse_reference(q, k_rot, v, cos, sin, w)
    dq = fa.flash_bwd_dq_reference(q, k_rot, v, o, lse, do, cos, sin, w)
    dk_rot, dv = fa.flash_bwd_dkv_reference(q, k_rot, v, o, lse, do, cos, sin, w)
    return o, lse, dq, unapply_rope(dk_rot, cos, sin), dv


@pytest.mark.parametrize("T,window,H", D128_GEOMETRIES, ids=D128_IDS)
def test_plain_forward_at_d128_matches_the_pallas_kernel(T, window, H):
    D = 128
    inputs = _qkv(T, H, D, seed=T + H)
    o, lse = _plain_d128(inputs, T, window)[:2]
    q, k, v, _ = (jnp.asarray(x) for x in inputs)
    cos, sin = jax_rope_tables(T, D, scale_base=float(T))
    scale = D**-0.5 * pa.LOG2E
    _, bk, fold = pa._choose_blocks(T, T, H)
    bq = pa._pick_block(T, max(64, 1024 // H))
    q_tables = (jnp.repeat(cos * scale, fold, axis=0), jnp.repeat(sin * scale, fold, axis=0))
    k_rot = pa._rotate_rank3(k.reshape(1, T, D), cos, sin)
    with pltpu.force_tpu_interpret_mode():
        want_o, want_lse = pa._flash_fwd(q, k_rot, v.reshape(1, T, D), fold, bq, bk, window, fast=False, rope=q_tables,
                                         dense=False)
    np.testing.assert_allclose(o.numpy(), np.asarray(want_o), atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(want_lse).reshape(1, T * H), atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("T,window,H", D128_GEOMETRIES, ids=D128_IDS)
def test_plain_backward_at_d128_matches_the_pallas_vjp(T, window, H):
    D = 128
    inputs = _qkv(T, H, D, seed=T + H)
    _, _, dq, dk, dv = _plain_d128(inputs, T, window)
    q, k, v, do = (jnp.asarray(x) for x in inputs)
    tables = jax_rope_tables(T, D, scale_base=float(T))
    with pltpu.force_tpu_interpret_mode():
        _, vjp = jax.vjp(lambda q, k, v: pa.flash_attention(q, k, v, window, tables), q, k, v)
        want_dq, want_dk, want_dv = vjp(do)
    np.testing.assert_allclose(dq.numpy(), np.asarray(want_dq), atol=ATOL, rtol=RTOL, err_msg="dq")
    np.testing.assert_allclose(dk.numpy(), np.asarray(want_dk).reshape(1, T, D), atol=ATOL, rtol=RTOL, err_msg="dk")
    np.testing.assert_allclose(dv.numpy(), np.asarray(want_dv).reshape(1, T, D), atol=ATOL, rtol=RTOL, err_msg="dv")


# (t, window, d, n): the halo path's sites at head dims the forms kernels take, and two that no kernel tiles
SEQ_CASES = [(4096, 512, 128, 4), (2048, 1024, 128, 4), (1024, 512, 128, 4), (4096, None, 128, 4),
             (4096, 4096, 128, 2), (4096, 512, 192, 2), (4096, 512, 256, 4), (4096, 512, 96, 4), (4096, 512, 32, 2)]


@pytest.mark.parametrize("t,window,d,n", SEQ_CASES)
def test_seq_parallel_available_keeps_the_jax_rule_at_wider_heads(t, window, d, n):
    """The halo rule takes a head dim that is a multiple of 64, as the JAX
    package's does; the port's arguments are a shard's frames and the head
    dim."""
    assert seq_parallel_available(t // n, window, d, n) == jax_seq_parallel_available(t, t, d, window, n)


# (dtype, D, window): the forms kernels' fp16 instance at D = 64 and their chunked instance (D > 256) in fp32
# and bf16, and the windowed pair's bf16 instances at D = 192 and 256 (K3a / K3b), each windowed and global
WIDE_CASES = [(torch.float16, 64, 64), (torch.float16, 64, None), (torch.float32, 320, 64),
              (torch.float32, 320, None), (torch.bfloat16, 320, 64), (torch.bfloat16, 320, None),
              (torch.bfloat16, 192, 64), (torch.bfloat16, 192, None), (torch.bfloat16, 256, 64),
              (torch.bfloat16, 256, None)]
_JNP = {torch.float16: jnp.float16, torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}
# Against Pallas in the operands' dtype. fp32 as ATOL / RTOL. fp16 and bf16: the Pallas kernel rounds P to
# the operands' dtype before P V (and dS before its products), where the plain version keeps fp32, and its
# outputs are rounded to that dtype: a relative error of a few units of the dtype's last place, 2^-11 = 4.9e-4
# for fp16's 10-bit mantissa and 2^-8 = 3.9e-3 for bf16's 7-bit one, summed over a row's terms, so 1e-3
# relative (with 1e-3 absolute) for fp16 and 2e-2 for bf16.
WIDE_TOLS = {torch.float32: (ATOL, RTOL), torch.float16: (1e-3, 1e-3), torch.bfloat16: (2e-2, 2e-2)}


@pytest.mark.parametrize("dtype,D,window", WIDE_CASES,
                         ids=[f"{str(dt).split('.')[1]}-D{d}-{'W' + str(w) if w else 'global'}" for dt, d, w in WIDE_CASES])
def test_plain_versions_at_fp16_and_wide_heads_match_the_pallas_kernel(dtype, D, window):
    """The plain forward (o) and backward (dq, dk, dv in the raw frames) of
    operands in ``dtype`` at head dim ``D``, computed in fp32, against the JAX
    package's ``pa.flash_attention`` and its vjp on the same operands in that
    dtype, in interpret mode: the functions that the forms kernels' fp16 and
    chunked instances, and the windowed pair's bf16 instances at D = 192 and
    256, hold on the card."""
    T, H = 128, 2
    atol, rtol = WIDE_TOLS[dtype]
    rounded = [torch.from_numpy(x).to(dtype) for x in _qkv(T, H, D, seed=D + (window or 0))]
    q, k, v, do = rounded
    k, v = k.reshape(1, T, D), v.reshape(1, T, D)
    w = -1 if window is None else window
    cos, sin = rope_tables(T, D, scale_base=float(T))
    k_rot = apply_rope(k.float(), cos, sin).to(dtype)
    o, lse = fa.flash_fwd_lse_reference(q, k_rot, v, cos, sin, w)
    dq = fa.flash_bwd_dq_reference(q, k_rot, v, o, lse, do, cos, sin, w)
    dk_rot, dv = fa.flash_bwd_dkv_reference(q, k_rot, v, o, lse, do, cos, sin, w)
    dk = unapply_rope(dk_rot, cos, sin)
    jq, jk, jv, jdo = (jnp.asarray(x.float().numpy()).astype(_JNP[dtype]) for x in rounded)
    tables = jax_rope_tables(T, D, scale_base=float(T))
    with pltpu.force_tpu_interpret_mode():
        want_o, vjp = jax.vjp(lambda q, k, v: pa.flash_attention(q, k, v, window, tables), jq, jk, jv)
        want_dq, want_dk, want_dv = vjp(jdo)
    for name, got, want in (("o", o, want_o), ("dq", dq, want_dq), ("dk", dk, want_dk), ("dv", dv, want_dv)):
        want = np.asarray(want.astype(jnp.float32)).reshape(got.shape)
        np.testing.assert_allclose(got.numpy(), want, atol=atol, rtol=rtol, err_msg=name)
