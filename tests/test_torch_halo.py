"""The plain versions of the port's halo attention (the forward with its LSE,
dq and dk/dv of one sequence shard against its halo-extended keys) against
the JAX package's ``halo_flash_attention`` and its ``jax.vjp``, run in Pallas
interpret mode on the CPU as tests/test_sequence_parallel.py runs them; their
composition over the shards of a song against the port's single-device
windowed attention; the op's registration; the planted faults that
chip_smoke.py relies on. fp32, small shapes.

The CUDA kernels themselves are held against these plain versions on a GPU
(tests/test_torch_kernels.py, chip_smoke.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from jax.experimental.pallas import tpu as pltpu

from osufusion_tpu.ops import pallas_attention as pa
from osufusion_tpu_torch.ops import flash_attention as fa
from osufusion_tpu_torch.ops import halo_attention as ha
from osufusion_tpu_torch.ops.rope import apply_rope, rope_tables
from osufusion_tpu_torch.utils.flops import halo_flops, halo_visited_pairs, visited_pairs

torch.set_num_threads(2)

D, H, T_LOCAL, SHARDS = 64, 2, 128, 4
T_SONG = T_LOCAL * SHARDS
# the JAX package's own tolerances for this path (tests/test_sequence_parallel.py)
FWD_TOL = 2e-5
GRAD_ATOL, GRAD_RTOL = 5e-5, 5e-4
# the bound chip_smoke.py holds the kernels to; a planted fault must lie above it
CHIP_REL_TOL = 1e-2
# W = 256 at four shards of 128 is the largest halo (W / 2 = T_local), the JAX test's edge case
CASES = [(w, s) for w in (128, 256) for s in (0, 1, SHARDS - 1)]
IDS = [f"W{w}-shard{s}" for w, s in CASES]


def _inputs(window, seed, d=D):
    """q (rotated), a slab k / v with random values in the rows outside the
    song too (both packages must ignore them), and do, at head dim ``d``."""
    rng = np.random.default_rng(seed)
    shapes = ((1, T_LOCAL, H, d), (1, T_LOCAL + window, d), (1, T_LOCAL + window, d), (1, T_LOCAL, H, d))
    return tuple(rng.standard_normal(s).astype(np.float32) for s in shapes)


def _plain(q, k, v, do, window, g0, t_global=T_SONG):
    q, k, v, do = (torch.from_numpy(x) for x in (q, k, v, do))
    saved, fa.REFERENCE_CHUNK = fa.REFERENCE_CHUNK, 48  # chunks shorter than a shard, so the chunk loop runs
    try:
        o, lse = ha.halo_fwd_reference(q, k, v, window, g0, t_global)
        dq = ha.halo_bwd_dq_reference(q, k, v, o, lse, do, window, g0, t_global)
        dk, dv = ha.halo_bwd_dkv_reference(q, k, v, o, lse, do, window, g0, t_global)
    finally:
        fa.REFERENCE_CHUNK = saved
    return o, lse, dq, dk, dv


def _check_against_jax(window, shard, d):
    q, k, v, do = _inputs(window, seed=window + shard, d=d)
    g0 = shard * T_LOCAL
    o, _, dq, dk, dv = _plain(q, k, v, do, window, g0)
    with pltpu.force_tpu_interpret_mode():
        want_o, vjp = jax.vjp(lambda q, k, v: pa.halo_flash_attention(q, k, v, window, jnp.int32(g0), T_SONG),
                              *(jnp.asarray(x) for x in (q, k, v)))
        want = vjp(jnp.asarray(do))
    np.testing.assert_allclose(o.numpy(), np.asarray(want_o), atol=FWD_TOL, rtol=FWD_TOL)
    for name, got, ref in zip(("dq", "dk", "dv"), (dq, dk, dv), want):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=GRAD_ATOL, rtol=GRAD_RTOL, err_msg=name)


@pytest.mark.parametrize("window,shard", CASES, ids=IDS)
def test_halo_plain_versions_match_jax_kernels(window, shard):
    _check_against_jax(window, shard, D)


@pytest.mark.parametrize("window,shard", CASES, ids=IDS)
def test_halo_plain_versions_match_jax_kernels_at_head_dim_128(window, shard):
    """The same at D = 128, the head dim whose halo backward runs K5a / K5b's
    instances at 128 on the card (and the halo forward K1's)."""
    _check_against_jax(window, shard, 128)


@pytest.mark.parametrize("shards", [2, 4])
def test_shards_compose_to_the_single_device_window(shards):
    """Rotate q and k with the song's tables, cut each shard's slab from the
    zero-padded k and v as the exchange delivers it, run the op per shard:
    o and the gradients of q, k and v equal ``flash_attention_op`` on the
    whole song."""
    T, window = 256, 64
    rng = np.random.default_rng(shards)
    q, k, v, do = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
                   for s in ((1, T, H, D), (1, T, 1, D), (1, T, 1, D), (1, T, H, D)))
    rope = rope_tables(T, D, scale_base=float(window))
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    want = fa.flash_attention(*leaves, window, rope)
    want.backward(do)
    halo = [t.clone().requires_grad_(True) for t in (q, k, v)]
    q_rot, k_rot = apply_rope(halo[0], *rope), apply_rope(halo[1][:, :, 0], *rope)
    w2, t_local = window // 2, T // shards
    k_pad, v_pad = (F.pad(t, (0, 0, w2, w2)) for t in (k_rot, halo[2][:, :, 0]))
    got = torch.cat([ha.halo_flash_attention(q_rot[:, g0 : g0 + t_local], k_pad[:, g0 : g0 + t_local + window],
                                             v_pad[:, g0 : g0 + t_local + window], window, g0, T)
                     for g0 in range(0, T, t_local)], dim=1)
    got.backward(do)
    np.testing.assert_allclose(got.detach().numpy(), want.detach().numpy(), atol=FWD_TOL, rtol=FWD_TOL)
    for name, a, b in zip("qkv", halo, leaves):
        np.testing.assert_allclose(a.grad.numpy(), b.grad.numpy(), atol=GRAD_ATOL, rtol=GRAD_RTOL, err_msg=f"d{name}")


def test_halo_op_registration():
    q, k, v, _ = (torch.from_numpy(x) for x in _inputs(128, seed=0))
    o, lse = ha.halo_attention_op(q.requires_grad_(True), k, v, 128, 0, T_SONG)
    assert o.requires_grad and not lse.requires_grad and lse.shape == (1, T_LOCAL * H)
    torch.library.opcheck(ha.halo_attention_op, (q, k, v, 128, T_LOCAL, T_SONG),
                          test_utils=("test_schema", "test_faketensor", "test_autograd_registration"))


@pytest.mark.parametrize("fault", ["window-short", "key-past-the-start", "key-past-the-end"])
def test_planted_faults_lie_above_the_chip_bound(fault):
    """The faults chip_smoke.py plants in the plain version, measured as it
    measures them: a window one key short on each side (every row, every
    output), and one key outside the song admitted at its start or end (the
    rows whose window reaches that key: o and dq), each above the relative L2
    bound that the kernels are held to."""
    window, shard = 128, {"window-short": 1, "key-past-the-start": 0, "key-past-the-end": SHARDS - 1}[fault]
    inputs = _inputs(window, seed=7)
    g0 = shard * T_LOCAL
    ref = _plain(*inputs, window, g0)
    if fault == "window-short":  # the same frame, one slab row less on each side
        q, k, v, do = inputs
        bad = _plain(q, k[:, 1:-1], v[:, 1:-1], do, window - 2, g0)
        for got, want in zip((bad[0], bad[2], *bad[3:]), (ref[0], ref[2], *(r[:, 1:-1] for r in ref[3:]))):
            assert ((got - want).norm() / want.norm()).item() > CHIP_REL_TOL
        return
    if fault == "key-past-the-start":  # the slab's lower bound one row early
        bad, rows = _plain(*inputs, window, g0 + 1), slice(0, window // 2)
    else:
        bad, rows = _plain(*inputs, window, g0, T_SONG + 1), slice(T_LOCAL - window // 2, T_LOCAL)
    for i in (0, 2):  # o and dq
        got, want = bad[i][:, rows], ref[i][:, rows]
        assert ((got - want).norm() / want.norm()).item() > CHIP_REL_TOL
    lo, hi = ha.slab_bounds(T_LOCAL, window, g0, T_SONG)
    outside = slice(lo - 1, lo) if shard == 0 else slice(hi, hi + 1)
    assert not ref[3][:, outside].any() and bad[3][:, outside].abs().sum() > 0  # dk of the admitted key


def test_halo_visited_pairs_and_flops():
    """Brute force at a small size; the shards' pairs add up to the song's."""
    for T, window, g0, t_global in ((16, 8, 0, 64), (16, 8, 16, 64), (16, 8, 48, 64), (10, 20, 0, 10), (12, 6, 24, 36)):
        lo, hi = ha.slab_bounds(T, window, g0, t_global)
        want = sum(t <= s <= t + window and lo <= s < hi for t in range(T) for s in range(T + window))
        assert halo_visited_pairs(T, window, g0, t_global) == want
    for shards in (2, 4):
        t_local = 65536 // shards
        pairs = [halo_visited_pairs(t_local, 4096, i * t_local, 65536) for i in range(shards)]
        assert sum(pairs) == visited_pairs(65536, 65536, 4096)
    assert halo_flops("backward_dkv", 1, 100, 4, 64, 20, 0, 400) == 2 * 64 * 4 * 4 * halo_visited_pairs(100, 20, 0, 400)


def test_halo_kernel_wrappers_raise_on_cpu_tensors():
    q, k, v, do = (torch.from_numpy(x).bfloat16() for x in _inputs(128, seed=1))
    stats = torch.zeros(1, T_LOCAL * H)
    with pytest.raises(ValueError, match="CUDA"):
        ha.halo_fwd(q, k, v, 128, 0, T_SONG, 0.125)
    with pytest.raises(ValueError, match="CUDA"):
        ha.halo_bwd_dq(q, k, v, q, stats, do, 128, 0, T_SONG, 0.125)
    prep = fa.WindowedPrep(q.reshape(1, T_LOCAL * H, D), stats, stats)  # T_LOCAL * H is whole 128-row blocks
    with pytest.raises(ValueError, match="CUDA"):
        ha.halo_bwd_dkv(k, v, do, prep, 128, 0, T_SONG)
