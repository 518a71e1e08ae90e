"""The plain versions of the port's windowed training attention (forward with
the base-2 LSE, ``flash_bwd_dq``, ``flash_bwd_dkv``) against the JAX
package's Pallas kernels run in interpret mode on the CPU, and against torch
autograd; fp32, small shapes, at the window geometries that
tests/test_pallas_attention.py guards.

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
from osufusion_tpu_torch.utils.flops import attention_flops, visited_pairs

# the sizes here are small, and the suite runs several workers at once: a few
# threads each keep them from fighting over the cores
torch.set_num_threads(2)

D = 64
# fp32 both sides; the kernels and the plain versions sum the same products
# in different orders (online softmax by KV block vs one pass per query
# chunk): ~1e-6 relative on o, and ~1e-5 on gradients that sum W*H terms
ATOL, RTOL = 5e-5, 5e-4
# (T, window, H): the plain window; 16 heads, where the JAX kernel's q and kv
# blocks are unequal; the bottleneck's window 512 against one and two
# neighbouring kv blocks; a window that covers the sequence (the global path)
GEOMETRIES = [(512, 256, 4), (512, 128, 16), (1024, 512, 16), (2048, 512, 2), (256, 4096, 2)]
IDS = [f"T{t}-W{w}-H{h}" for t, w, h in GEOMETRIES]


def _inputs(T, H):
    rng = np.random.default_rng(T + H)
    return tuple(rng.standard_normal(shape).astype(np.float32) for shape in ((1, T, H, D), (1, T, 1, D), (1, T, 1, D), (1, T, H, D)))


def _plain(inputs, T, window, chunk=96):
    """The port's plain forward (o, lse2) and backward (dq, dk, dv in the raw
    frames) with the window as the kernels take it (-1 when it covers the
    sequence), in query chunks shorter than the window's reach so that the
    chunk loop and its key spans are exercised."""
    q, k, v, do = (torch.from_numpy(x) for x in inputs)
    k, v = k.reshape(1, T, D), v.reshape(1, T, D)
    window = -1 if T <= window else window
    cos, sin = rope_tables(T, D, scale_base=float(min(T, 512)))
    k_rot = apply_rope(k, cos, sin)
    saved, fa.REFERENCE_CHUNK = fa.REFERENCE_CHUNK, chunk
    try:
        o, lse = fa.flash_fwd_lse_reference(q, k_rot, v, cos, sin, window)
        dq = fa.flash_bwd_dq_reference(q, k_rot, v, o, lse, do, cos, sin, window)
        dk_rot, dv = fa.flash_bwd_dkv_reference(q, k_rot, v, o, lse, do, cos, sin, window)
    finally:
        fa.REFERENCE_CHUNK = saved
    return o, lse, dq, unapply_rope(dk_rot, cos, sin), dv


@pytest.mark.parametrize("T,window,H", GEOMETRIES, ids=IDS)
def test_windowed_forward_and_lse_match_jax_kernel(T, window, H):
    inputs = _inputs(T, H)
    o, lse = _plain(inputs, T, window)[:2]
    q, k, v, _ = (jnp.asarray(x) for x in inputs)
    cos, sin = jax_rope_tables(T, D, scale_base=float(min(T, 512)))
    scale = D**-0.5 * pa.LOG2E
    _, bk, fold = pa._choose_blocks(T, T, H)
    bq = pa._pick_block(T, max(64, 1024 // H))
    q_tables = (jnp.repeat(cos * scale, fold, axis=0), jnp.repeat(sin * scale, fold, axis=0))
    k_rot = pa._rotate_rank3(k.reshape(1, T, D), cos, sin)
    with pltpu.force_tpu_interpret_mode():
        want_o, want_lse = pa._flash_fwd(q, k_rot, v.reshape(1, T, D), fold, bq, bk, None if T <= window else window,
                                         fast=False, rope=q_tables, dense=False)
    np.testing.assert_allclose(o.numpy(), np.asarray(want_o), atol=ATOL, rtol=RTOL)
    # both are the base-2 LSE of the window's logits, flat (B, T*H) in t-major order
    np.testing.assert_allclose(lse.numpy(), np.asarray(want_lse).reshape(1, T * H), atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("T,window,H", GEOMETRIES, ids=IDS)
def test_windowed_backward_matches_jax_vjp(T, window, H):
    inputs = _inputs(T, H)
    _, _, dq, dk, dv = _plain(inputs, T, window)
    q, k, v, do = (jnp.asarray(x) for x in inputs)
    tables = jax_rope_tables(T, D, scale_base=float(min(T, 512)))
    with pltpu.force_tpu_interpret_mode():
        _, vjp = jax.vjp(lambda q, k, v: pa.flash_attention(q, k, v, window, tables), q, k, v)
        want_dq, want_dk, want_dv = vjp(do)
    np.testing.assert_allclose(dq.numpy(), np.asarray(want_dq), atol=ATOL, rtol=RTOL, err_msg="dq")
    np.testing.assert_allclose(dk.numpy(), np.asarray(want_dk).reshape(1, T, D), atol=ATOL, rtol=RTOL, err_msg="dk")
    np.testing.assert_allclose(dv.numpy(), np.asarray(want_dv).reshape(1, T, D), atol=ATOL, rtol=RTOL, err_msg="dv")


@pytest.mark.parametrize("T,window,H", [(300, 64, 3), (256, 33, 4), (200, 0, 2), (128, 4096, 2)],
                         ids=["T300-W64", "odd-window", "window-0", "covers-sequence"])
def test_windowed_plain_versions_match_torch_autograd(T, window, H):
    """Against autograd through ``flash_attention_reference``, at lengths that
    no block size divides, an odd window (the integer half: 16 keys a side)
    and a window of one key."""
    inputs = _inputs(T, H)
    o, _, dq, dk, dv = _plain(inputs, T, window)
    q, k, v, do = (torch.from_numpy(x).requires_grad_(True) for x in inputs)
    rope = rope_tables(T, D, scale_base=float(min(T, 512)))
    out = fa.flash_attention_reference(q, k, v, window, rope)
    out.backward(do.detach())
    np.testing.assert_allclose(o.numpy(), out.detach().numpy(), atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(dq.numpy(), q.grad.numpy(), atol=ATOL, rtol=RTOL, err_msg="dq")
    np.testing.assert_allclose(dk.numpy(), k.grad.reshape(1, T, D).numpy(), atol=ATOL, rtol=RTOL, err_msg="dk")
    np.testing.assert_allclose(dv.numpy(), v.grad.reshape(1, T, D).numpy(), atol=ATOL, rtol=RTOL, err_msg="dv")


@pytest.mark.parametrize("window", [64, None], ids=["windowed", "global"])
def test_differentiable_op_on_the_cpu_is_the_plain_versions(window):
    """``flash_attention`` under a gradient on CPU tensors goes through
    ``flash_attention_op``: forward and backward equal autograd through the
    plain forward, and the op passes torch's own registration checks."""
    T, H = 200, 3
    rope = rope_tables(T, D, scale_base=64.0)
    leaves = [torch.from_numpy(x).requires_grad_(True) for x in _inputs(T, H)[:3]]
    do = torch.from_numpy(_inputs(T, H)[3])
    out = fa.flash_attention(*leaves, window, rope)
    out.backward(do)
    ref_leaves = [t.detach().clone().requires_grad_(True) for t in leaves]
    ref = fa.flash_attention_reference(*ref_leaves, window, rope)
    ref.backward(do)
    np.testing.assert_allclose(out.detach().numpy(), ref.detach().numpy(), atol=ATOL, rtol=RTOL)
    for got, want in zip(leaves, ref_leaves):
        assert got.grad.shape == got.shape
        np.testing.assert_allclose(got.grad.numpy(), want.grad.numpy(), atol=ATOL, rtol=RTOL)
    q, k, v = (t.detach() for t in leaves)
    o, lse, k_rot = fa.flash_attention_op(q.requires_grad_(True), k.reshape(1, T, D), v.reshape(1, T, D), *rope, window or -1)
    assert o.requires_grad and not lse.requires_grad and not k_rot.requires_grad and lse.shape == (1, T * H)
    torch.library.opcheck(fa.flash_attention_op, (q, k.reshape(1, T, D), v.reshape(1, T, D), *rope, window or -1),
                          test_utils=("test_schema", "test_faketensor", "test_autograd_registration"))


@pytest.mark.parametrize("fault,expected", [("window", None), ("lse", 1 - 2**-0.05)])
def test_planted_faults_show_in_every_gradient(fault, expected):
    """The two faults chip_smoke.py plants in the plain backward. A window one
    key short on each side drops 2 of a query's W + 1 pairs: about
    sqrt(2 / (W + 1)) of each gradient (the dropped pairs are not average
    ones, so within a factor of two). An LSE off by 0.05 in base 2 scales p,
    hence all three gradients, by 2^-0.05: 3.4 %."""
    T, window, H = 512, 64, 4
    inputs = _inputs(T, H)
    o, lse, dq, dk, dv = _plain(inputs, T, window)
    q, k, v, do = (torch.from_numpy(x) for x in inputs)
    cos, sin = rope_tables(T, D, scale_base=float(min(T, 512)))
    k_rot = apply_rope(k.reshape(1, T, D), cos, sin)
    args = (q, k_rot, v.reshape(1, T, D), o, lse + 0.05 if fault == "lse" else lse, do, cos, sin, window - 2 if fault == "window" else window)
    dk_rot, dv_f = fa.flash_bwd_dkv_reference(*args)
    for got, ref in ((fa.flash_bwd_dq_reference(*args), dq), (unapply_rope(dk_rot, cos, sin), dk), (dv_f, dv)):
        moved = ((got - ref).norm() / ref.norm()).item()
        if fault == "lse":
            assert moved == pytest.approx(expected, rel=0.05)
        else:
            assert 0.5 * (2 / (window + 1)) ** 0.5 < moved < 2 * (2 / (window + 1)) ** 0.5


def test_visited_pairs_and_flops_count_the_window():
    """The count behind the kernels' roofline bounds: the pairs inside the
    window, brute force at a small size, and its closed forms."""
    for T, window in ((50, 8), (50, 9), (64, 0), (10, 64), (33, None), (40, -1)):
        if window is None or window < 0 or T <= window:
            want = T * T
        else:
            want = sum(abs(t - s) <= window // 2 for t in range(T) for s in range(T))
        assert visited_pairs(T, T, window) == want, (T, window)
    T, W = 65536, 4096
    assert visited_pairs(T, T, W) == T * (W + 1) - (W // 2) * (W // 2 + 1)
    assert attention_flops("forward", 1, T, 16, 64, W) == 4 * 64 * 16 * visited_pairs(T, T, W)
    assert attention_flops("backward_dq", 2, 100, 4, 64, None) == 2 * 3 * 2 * 64 * 4 * 100 * 100
    assert attention_flops("backward_dkv", 1, 100, 4, 64, 200) * 5 == attention_flops("backward_fused", 1, 100, 4, 64, None) * 4


def test_kernel_wrappers_raise_on_cpu_tensors():
    T, H = 128, 4
    q, k, v, do = (torch.from_numpy(x).bfloat16() for x in _inputs(T, H))
    k, v = k.reshape(1, T, D), v.reshape(1, T, D)
    cos, sin = rope_tables(T, D, scale_base=64.0)
    stats = torch.zeros(1, T * H)
    with pytest.raises(ValueError, match="CUDA"):
        fa.flash_fwd(q, k, v, cos, sin, 64, D**-0.5, return_lse=True)
    with pytest.raises(ValueError, match="CUDA"):
        fa.flash_bwd_dq(q, k, v, q, stats, do, cos, sin, 64, D**-0.5)
    prep = fa.WindowedPrep(q.reshape(1, T * H, D), torch.zeros(1, T * H), torch.zeros(1, T * H))
    with pytest.raises(ValueError, match="CUDA"):
        fa.flash_bwd_dkv(k, v, do, prep, 64)
    with pytest.raises(ValueError, match="CUDA"):  # without a gradient the entry point is the forward kernel alone
        fa.flash_attention(q, k[:, :, None], v[:, :, None], 64, (cos, sin))
