"""The fp32 attention backward on the tensor cores (``csrc/flash_f32x6.cuh``)
on the CPU: the exact split of an fp32 value into three bf16 pieces
(``flash_attention.f32x6_split_reference``, the plain version of the
kernels' split), the six bf16 products per fp32 product emulated in torch in
the kernels' order of terms, the dq and dk/dv pair so emulated against the
JAX package's fp32 backward (``pa.flash_attention``'s vjp in interpret mode,
as its own tests run it on the CPU), and the form rule that sends every fp32
backward wrapper at D = 64 ... 256 to the pair.

The kernels themselves run only on a GPU: tests/test_torch_kernels.py and
chip_smoke.py hold them to the plain fp32 versions there."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from osufusion_tpu.ops import pallas_attention as pa
from osufusion_tpu.ops.rope import rope_tables as jax_rope_tables
from osufusion_tpu_torch.ops import flash_attention as fa
from osufusion_tpu_torch.ops.flash_forms import (F32X6_WRAPPERS, FORMS_HEAD_DIMS, WIDE_WGMMA, kernel_form,
                                                 route)
from osufusion_tpu_torch.ops.rope import apply_rope, rope_tables, unapply_rope

torch.set_num_threads(2)

# the values the split must take apart exactly: x = b0 + b1 + b2 in fp32. "tiny" stays above 2^-102, below which
# the third piece (2^-16 of x) would fall under bf16's smallest normal and lose bits
SPLIT_CASES = {
    "random": lambda rng: rng.standard_normal(4096),
    "large": lambda rng: rng.uniform(-1.0, 1.0, 4096) * 1e37,
    "tiny": lambda rng: rng.choice([-1.0, 1.0], 4096) * rng.uniform(1.0, 10.0, 4096) * 1e-30,
    "zero": lambda rng: np.zeros(4096),
    "negative": lambda rng: -np.abs(rng.standard_normal(4096)) * 10.0 ** rng.integers(-20, 20, 4096),
}


@pytest.mark.parametrize("case", sorted(SPLIT_CASES))
def test_split_is_exact(case):
    """b0 = rn(x), b1 = rn(x - b0), b2 = x - b0 - b1, all bf16: their sum in
    fp32 is x to the bit, b2 needs no rounding, and each piece is at most
    half a bf16 place of the one before (so the six products with i + j <= 2
    keep everything above 2^-24 of a product)."""
    x = torch.from_numpy(SPLIT_CASES[case](np.random.default_rng(7)).astype(np.float32)).reshape(64, 64)
    pieces = fa.f32x6_split_reference(x)
    assert pieces.dtype == torch.bfloat16 and pieces.shape == (64, 192)
    b0, b1, b2 = (p.float() for p in pieces.split(64, dim=-1))
    assert torch.equal((b0 + b1) + b2, x)
    assert torch.equal(b2, (x - b0) - b1)  # the last piece is the exact rest
    assert (b1.abs() <= b0.abs() * 2**-8).all() and (b2.abs() <= b1.abs() * 2**-8).all()


# the kernels' order of the six products of one 64-wide chunk of the contraction: X (the resident operand, or
# the fragments in registers) piece i times Y (the streamed one) piece j, grouped by Y's piece, small terms first
ORDER = ((0, 2), (1, 1), (0, 1), (2, 0), (1, 0), (0, 0))


def x6_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a (..., M, K) @ b (..., N, K)^T as the kernels compute it: both split
    into their three bf16 pieces, and per 64-wide chunk of K the six products
    of ORDER added in turn into one fp32 accumulator."""
    K = a.shape[-1]
    pieces_a, pieces_b = (fa.f32x6_split_reference(x).float() for x in (a, b))
    acc = torch.zeros((*a.shape[:-1], b.shape[-2]), dtype=torch.float32)
    for c in range(0, K, 64):
        for i, j in ORDER:
            x, y = pieces_a[..., i * K + c:i * K + c + 64], pieces_b[..., j * K + c:j * K + c + 64]
            acc = acc + x @ y.transpose(-1, -2)
    return acc


def test_six_products_are_as_exact_as_fp32():
    """A 128 x 1024 x 96 product: the six bf16 products (emulated) against
    fp64 within 1e-6 relative L2, as close as fp32's own product; one bf16
    product lands at ~1e-3."""
    rng = np.random.default_rng(3)
    a, b = (torch.from_numpy(rng.standard_normal(s).astype(np.float32)) for s in ((128, 1024), (96, 1024)))
    want = a.double() @ b.double().T
    rel = lambda got: ((got.double() - want).norm() / want.norm()).item()
    assert rel(x6_mm(a, b)) < 1e-6 and rel(a @ b.T) < 1e-6
    assert rel(a.bfloat16().float() @ b.bfloat16().float().T) > 1e-4


def _pair_emulated(q, k, v, o, lse, do, cos, sin, window):
    """The dq and dk/dv kernels' arithmetic on an MQA site (B, T, H, D) with
    rotary tables, every product through ``x6_mm``: dq in the raw frame, and
    dk (un-rotated here) and dv."""
    B, T, H, D = q.shape
    qs = fa._scaled_rotated_q(q, cos, sin).reshape(B, T * H, D)  # group rows: timestep r // H
    k_rot = apply_rope(k, cos, sin)
    rows_t = torch.arange(T * H) // H
    keys = torch.arange(T)
    seen = torch.ones(T * H, T, dtype=torch.bool) if window < 0 else (rows_t[:, None] - keys).abs() <= window // 2
    dof = do.reshape(B, T * H, D)
    p = torch.where(seen, torch.exp2(x6_mm(qs, k_rot) - lse[..., None]), 0.0)
    delta = (dof * o.reshape(B, T * H, D)).sum(-1, keepdim=True)
    ds = p * (x6_mm(dof, v) - delta)
    dq = unapply_rope((x6_mm(ds, k_rot.transpose(1, 2)) * D**-0.5).reshape(B, T, H, D), cos, sin)
    dk_rot = x6_mm(ds.transpose(1, 2), qs.transpose(1, 2)) * fa.LN2
    dv = x6_mm(p.transpose(1, 2), dof.transpose(1, 2))
    return dq, unapply_rope(dk_rot, cos, sin), dv


# (D, window) at T = 256, H = 2: global and windowed at the two narrowest head dims of the pair
PAIR_CASES = [(64, None), (64, 128), (128, None), (128, 128)]
# against the JAX package's fp32 backward: both sides as exact as fp32, summed in other orders, ~6e-7 at these
# sizes; the bound lies below what the products without their three smallest terms give (X3's four products:
# ~6.5e-6), so it holds the pair to all six
PAIR_REL_TOL = 2e-6


@pytest.mark.parametrize("D,window", PAIR_CASES, ids=[f"D{d}-{'W' + str(w) if w else 'global'}" for d, w in PAIR_CASES])
def test_six_product_pair_matches_the_jax_fp32_backward(D, window):
    """The pair's arithmetic (``_pair_emulated``: six bf16 products per fp32
    product, in the kernels' order) against the JAX package's fp32
    ``pa.flash_attention`` vjp in interpret mode on the same seeded inputs:
    dq, dk and dv within PAIR_REL_TOL relative L2, which tells six products
    from four."""
    T, H = 256, 2
    rng = np.random.default_rng(D + (window or 0))
    q, k, v, do = (rng.standard_normal(s).astype(np.float32) for s in ((1, T, H, D), (1, T, 1, D), (1, T, 1, D),
                                                                        (1, T, H, D)))
    tables = jax_rope_tables(T, D, scale_base=float(T))
    with pltpu.force_tpu_interpret_mode():
        _, vjp = jax.vjp(lambda q, k, v: pa.flash_attention(q, k, v, window, tables), *map(jnp.asarray, (q, k, v)))
        want = vjp(jnp.asarray(do))
    tq, tk, tv, tdo = (torch.from_numpy(x) for x in (q, k, v, do))
    tk, tv = tk.reshape(1, T, D), tv.reshape(1, T, D)
    cos, sin = rope_tables(T, D, scale_base=float(T))
    w = -1 if window is None else window
    o, lse = fa.flash_fwd_lse_reference(tq, apply_rope(tk, cos, sin), tv, cos, sin, w)
    got = _pair_emulated(tq, tk, tv, o, lse, tdo, cos, sin, w)
    for name, g, ref in zip(("dq", "dk", "dv"), got, want):
        ref = torch.from_numpy(np.array(ref)).reshape(g.shape)
        rel = ((g - ref).norm() / ref.norm()).item()
        assert rel < PAIR_REL_TOL, f"{name}: rel L2 {rel:.3e}"


@pytest.mark.parametrize("D", FORMS_HEAD_DIMS)
def test_fp32_backward_wrappers_route_to_the_six_product_pair(D):
    """At fp32 with D = 64 ... 256 every backward wrapper of the form rule
    (the global backward, the ring's sweep, the windowed and the halo pair)
    takes csrc/flash_f32x6.cuh's pair, and nothing else does: the forwards
    stay on the forms bodies, and so do the pre-pass, post-pass and merge;
    bf16 and fp16 never take it, nor fp32 above 256 (the chunked instance)."""
    assert F32X6_WRAPPERS == WIDE_WGMMA - {"flash_fwd", "halo_fwd"}
    t = torch.empty((1, 1, 1, D), dtype=torch.float32)
    wrappers = sorted(WIDE_WGMMA | {"flash_bwd_prep", "flash_bwd_post", "ring_merge"})
    assert {who for who in wrappers if route(who, t) == "f32x6"} == F32X6_WRAPPERS
    assert {who for who in wrappers if kernel_form(who, torch.float32, D) == "hopper"} == F32X6_WRAPPERS
    assert {who for who in wrappers if route(who, t) == "forms"} == set(wrappers) - F32X6_WRAPPERS
    for dtype in (torch.bfloat16, torch.float16):
        assert not any(route(who, t.to(dtype)) == "f32x6" for who in wrappers)
    wide = torch.empty((1, 1, 1, D + 256), dtype=torch.float32)
    assert all(route(who, wide) == "forms" and kernel_form(who, torch.float32, D + 256) != "hopper"
               for who in F32X6_WRAPPERS)
    assert fa.scratch_sweeps("f32x6") == (fa.f32x6_bwd_dq, fa.f32x6_bwd_dkv)


def test_pair_refuses_scratch_without_pieces():
    """The pair reads the pieces of qs and do, which ``scratch_prep`` adds
    for the route "f32x6": a scratch without them is refused before any
    check of the operands or launch."""
    B, T, H, D = 1, 64, 2, 64
    f32 = torch.float32
    prep = fa.GlobalPrep(torch.zeros((B, T * H, D)), torch.zeros((B, T, H, D)), torch.zeros((B, 64 * 2)),
                         torch.zeros((B, 64 * 2)), torch.zeros((B, 64 * 2, D)), (B, T, H, 1))
    assert prep.pieces is None
    k = torch.zeros((B, T, D), dtype=f32)
    with pytest.raises(ValueError, match="no pieces"):
        fa.f32x6_bwd_dq(k, k, prep, -1, None, False)
    with pytest.raises(ValueError, match="no pieces"):
        fa.f32x6_bwd_dkv(k, k, prep, k.clone(), k.clone(), -1, None, False)
