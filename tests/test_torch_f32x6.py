"""The fp32 attention forward and backward on the tensor cores
(``csrc/flash_f32x6.cuh``) on the CPU: the exact split of an fp32 value into
three bf16 pieces (``flash_attention.f32x6_split_reference``, the plain
version of the kernels' split), the six bf16 products per fp32 product
emulated in torch in the kernels' order of terms, the forward and the dq and
dk/dv pair so emulated against the JAX package's fp32 forward and backward
(``pa._flash_fwd`` and ``pa.flash_attention``'s vjp in interpret mode, as its
own tests run them on the CPU), and the form rule that sends every fp32
forward wrapper at every head dim, and every backward wrapper at D = 64 ...
512, to these kernels.

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
from osufusion_tpu_torch.ops.flash_forms import (BACKWARD_WRAPPERS, WGMMA_HEAD_DIMS, WIDE_WGMMA, XWIDE_HEAD_DIMS,
                                                 kernel_form, route)
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


def x6_mm(a: torch.Tensor, b: torch.Tensor, acc: torch.Tensor | None = None, chunk: int = 64) -> torch.Tensor:
    """a (..., M, K) @ b (..., N, K)^T as the kernels compute it: both split
    into their three bf16 pieces, and per ``chunk``-wide chunk of K (a 64-wide
    atom, or the forward's key tile in P V) the six products of ORDER added in
    turn into one fp32 accumulator (zeros, or ``acc``)."""
    K = a.shape[-1]
    pieces_a, pieces_b = (fa.f32x6_split_reference(x).float() for x in (a, b))
    if acc is None:
        acc = torch.zeros((*a.shape[:-1], b.shape[-2]), dtype=torch.float32)
    for c in range(0, K, chunk):
        e = min(c + chunk, K)  # a last chunk of fewer keys: the kernels' tile padded with zeros
        for i, j in ORDER:
            x, y = pieces_a[..., i * K + c:i * K + e], pieces_b[..., j * K + c:j * K + e]
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


# (D, window) at T = 256, H = 2: global and windowed at the two narrowest head dims of the pair, and above 256
# (one resident piece of the rows, dk/dv in two column chunks) at the narrowest and the widest
PAIR_CASES = [(64, None), (64, 128), (128, None), (128, 128), (320, None), (512, None), (320, 128)]
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


# the forward kernel's constants (csrc/flash_f32x6.cuh): rows of a block (XW_ROWS), the keys that O's accumulator
# takes before its sum goes to device memory (X6_FLUSH_TILES tiles of 64), and its key tile at a head dim: 128
# up to X6_FWD_WIDE_MAX_D, 64 above
ROWS, FLUSH_KEYS, WIDE_MAX_D = 64, 8 * 64, 128


def _key_tile(D: int) -> int:
    return 128 if D <= WIDE_MAX_D else 64


def _kernel_qs(q, cos, sin):
    """qs of an MQA site (B, T, H, D) as the forward kernel stages it: each
    (d, d + D / 2) pair rotated with every product rounded alone (or, without
    tables, only scaled), times the fp32 scale fp32(D^-0.5) * fp32(log2 e)."""
    D = q.shape[-1]
    qscale = float(np.float32(np.float32(D**-0.5) * np.float32(fa.LOG2E)))
    a, h = q[..., :D // 2], q[..., D // 2:]
    if cos is None:
        return torch.cat([a * qscale, h * qscale], dim=-1)
    c, s = cos[None, :, None], sin[None, :, None]
    lo = (a * c[..., :D // 2] - h * s[..., :D // 2]) * qscale
    hi = (h * c[..., D // 2:] + a * s[..., D // 2:]) * qscale
    return torch.cat([lo, hi], dim=-1)


def _forward_emulated(q, k_rot, v, cos, sin, window, flush_tiles=None):
    """The forward kernel's arithmetic on an MQA site (B, T, H, D): per block
    of 64 group rows (row r: timestep r // H) the key tiles (``_key_tile``)
    from the first key the block sees, S = qs K^T (six terms a 64-wide atom of
    D) and O += P V (six terms over the tile's keys) through ``x6_mm`` in the
    kernel's order of terms, the online softmax in the exp2 domain, and O's
    accumulator flushed into the running o (rescaled to the current base)
    each ``flush_tiles`` tiles (the kernel's: FLUSH_KEYS keys). Returns (o (B,
    T, H, D), lse2 (B, T*H))."""
    B, T, H, D = q.shape
    tile = _key_tile(D)
    flush_tiles = flush_tiles or FLUSH_KEYS // tile
    qs = _kernel_qs(q, cos, sin).reshape(B, T * H, D)
    w2 = window // 2
    o = torch.empty((B, T * H, D))
    lse = torch.empty((B, T * H))
    for r0 in range(0, T * H, ROWS):
        rows = torch.arange(r0, min(r0 + ROWS, T * H))
        t = rows // H
        lo, hi = (0, T) if window < 0 else (max(0, int(t[0]) - w2), min(T, int(t[-1]) + w2 + 1))
        m = torch.full((B, len(rows), 1), -torch.inf)
        l = torch.zeros((B, len(rows), 1))
        acc, o_run, held = torch.zeros((B, len(rows), D)), torch.zeros((B, len(rows), D)), torch.ones((B, len(rows), 1))
        for it, s0 in enumerate(range(lo, hi, tile)):
            if it > 0 and it % flush_tiles == 0:
                o_run, acc, held = o_run * held + acc, torch.zeros_like(acc), torch.ones_like(held)
            keys = torch.arange(s0, min(s0 + tile, hi))
            seen = torch.ones(len(rows), len(keys), dtype=torch.bool) if window < 0 else \
                (t[:, None] - keys[None, :]).abs() <= w2
            s = torch.where(seen, x6_mm(qs[:, rows], k_rot[:, keys]), -torch.inf)
            mx = torch.maximum(m, s.amax(-1, keepdim=True))
            base = torch.where(mx == -torch.inf, 0.0, mx)
            corr = torch.exp2(m - base)
            p = torch.exp2(s - base)
            l, m, held = l * corr + p.sum(-1, keepdim=True), mx, held * corr
            acc = x6_mm(p, v[:, keys].transpose(1, 2), acc * corr, chunk=tile)
        o[:, rows] = (o_run * held + acc) / l
        lse[:, rows] = (m + torch.log2(l))[..., 0]
    return o.reshape(B, T, H, D), lse


# (D, window, tables) at T = 256, H = 2: global and windowed, with rotary tables and without, at the two
# narrowest head dims (128-key tiles); above 256 (qs's pieces from a pre-pass, O's atoms on both warpgroups) at
# the narrowest and the widest head dim that one block holds, and at the first whose O columns go in two chunks
FWD_CASES = [(D, w, tables) for D in (64, 128) for w in (None, 96) for tables in (True, False)] + [
    (320, None, True), (320, 96, False), (512, None, False), (512, 96, True), (576, None, True)]
FWD_IDS = [f"D{d}-{'W' + str(w) if w else 'global'}-{'tables' if t else 'plain'}" for d, w, t in FWD_CASES]
# against the JAX package's fp32 forward: both as exact as fp32, summed in other orders
FWD_REL_TOL, FWD_LSE_TOL = 1e-5, 1e-5


@pytest.mark.parametrize("D,window,tables", FWD_CASES, ids=FWD_IDS)
def test_six_product_forward_matches_the_jax_fp32_forward(D, window, tables):
    """The forward's arithmetic (``_forward_emulated``: six bf16 products per
    fp32 product in the kernel's order and key tile, O's accumulator flushed
    each FLUSH_KEYS keys) against the JAX package's fp32 ``pa._flash_fwd`` in
    interpret mode on the same seeded inputs: o within 1e-5 relative L2 and
    the base-2 LSE within 1e-5, also with a flush after every tile (at T =
    256 a block sees at most two tiles, fewer than the kernel flushes after);
    the emulated qs is the forms pre-pass's plain qs bit for bit."""
    T, H = 256, 2
    rng = np.random.default_rng(D + (window or 0) + tables)
    q, k, v = (rng.standard_normal(s).astype(np.float32) for s in ((1, T, H, D), (1, T, D), (1, T, D)))
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    cos, sin = rope_tables(T, D, scale_base=float(T)) if tables else (None, None)
    k_rot = apply_rope(tk, cos, sin) if tables else tk
    runs = [_forward_emulated(tq, k_rot, tv, cos, sin, -1 if window is None else window, flush)
            for flush in (None, 1)]
    qscale = float(np.float32(np.float32(D**-0.5) * np.float32(fa.LOG2E)))
    plain_qs = (apply_rope(tq, cos, sin) if tables else tq) * qscale  # the pre-pass's (flash_forms.cu's qs_pair)
    assert torch.equal(_kernel_qs(tq, cos, sin), plain_qs)
    scale = D**-0.5 * pa.LOG2E
    _, bk, fold = pa._choose_blocks(T, T, H)
    bq = pa._pick_block(T, max(64, 1024 // H))
    if tables:
        jcos, jsin = jax_rope_tables(T, D, scale_base=float(T))
        rope = (jnp.repeat(jcos * scale, fold, axis=0), jnp.repeat(jsin * scale, fold, axis=0))
        jq, jk = jnp.asarray(q), pa._rotate_rank3(jnp.asarray(k), jcos, jsin)
    else:
        rope, jq, jk = None, jnp.asarray(q) * scale, jnp.asarray(k)
    with pltpu.force_tpu_interpret_mode():
        want_o, want_lse = pa._flash_fwd(jq, jk, jnp.asarray(v), fold, bq, bk, window, fast=False, rope=rope,
                                         dense=False)
    want_o = torch.from_numpy(np.array(want_o)).reshape(tq.shape)
    want_lse = torch.from_numpy(np.array(want_lse)).reshape(1, T * H)
    for o, lse in runs:
        rel = ((o - want_o).norm() / want_o.norm()).item()
        assert rel < FWD_REL_TOL, f"o: rel L2 {rel:.3e}"
        assert (lse - want_lse).abs().max().item() < FWD_LSE_TOL


@pytest.mark.parametrize("D", WGMMA_HEAD_DIMS + XWIDE_HEAD_DIMS)
def test_fp32_backward_wrappers_route_to_the_six_product_pair(D):
    """At fp32 with D = 64 ... 512 every backward wrapper of the form rule
    (the global backward, the ring's sweep, the windowed and the halo pair)
    takes csrc/flash_f32x6.cuh's pair, and every forward (``flash_fwd``, the
    ring's hops through it, and ``halo_fwd``) its forward, above 256 on the
    pieces of qs that the entry point writes into ``fwd_scratch`` first;
    nothing else does: the pre-pass, post-pass and merge stay on the forms
    bodies, and above 512 the forwards alone take it, every backward wrapper
    the chunked dq and dk/dv; bf16 and fp16 never take it."""
    assert BACKWARD_WRAPPERS == WIDE_WGMMA - {"flash_fwd", "halo_fwd"}
    t = torch.empty((1, 1, 1, D), dtype=torch.float32)
    wrappers = sorted(WIDE_WGMMA | {"flash_bwd_prep", "flash_bwd_post", "ring_merge"})
    assert {who for who in wrappers if route(who, t) == "f32x6"} == WIDE_WGMMA
    assert {who for who in wrappers if kernel_form(who, torch.float32, D) == "hopper"} == WIDE_WGMMA
    assert {who for who in wrappers if route(who, t) == "forms"} == set(wrappers) - WIDE_WGMMA
    assert not any(kernel_form(who, torch.float32, D) == "chunked" for who in wrappers)
    for dtype in (torch.bfloat16, torch.float16):
        assert not any(route(who, t.to(dtype)) == "f32x6" for who in wrappers)
    scratch = fa.fwd_scratch("f32x6", torch.empty((2, 8, 4, D)), 2)
    assert (scratch is None) == (D <= 256)
    assert scratch is None or (scratch.shape, scratch.dtype) == ((4, 16, 3 * D), torch.bfloat16)
    for wide_d in (576, 1024):
        wide = torch.empty((1, 1, 1, wide_d), dtype=torch.float32)
        assert {who for who in WIDE_WGMMA if route(who, wide) == "f32x6"} == {"flash_fwd", "halo_fwd"}
        assert all(route(who, wide) == "forms" and kernel_form(who, torch.float32, wide_d) == "chunked"
                   for who in BACKWARD_WRAPPERS)
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
