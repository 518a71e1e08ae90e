"""The hand-written CUDA flash kernels (forward, forward with its LSE, fused
global backward, each also in its grouped form for DiT and MMDiT, the
windowed dq / dkv pair, the halo forward / dq / dkv of sequence parallelism,
the forms family's instances at fp32, bf16 and fp16 with D = 64 ... 256 and
its chunked instance above, K1 and K2's instances at D = 128, 192 and 256, and
the differentiable ops that join them) against
their plain PyTorch versions, at small and production shapes and at the
edges of the Hopper kernels' tiles. Needs an NVIDIA GPU with nvcc (marked ``cuda``; skips
elsewhere). Imports no JAX, so it also runs where JAX is not installed:

    python -m pytest --noconftest tests/test_torch_kernels.py -q
"""

import copy

import numpy as np
import pytest
import torch

from osufusion_tpu_torch.ops import flash_attention as fa
from osufusion_tpu_torch.ops import flash_forms as forms
from osufusion_tpu_torch.ops import halo_attention as ha
from osufusion_tpu_torch.ops.rope import apply_rope, rope_tables, unapply_rope

# bf16 output of a softmax-weighted mean of N(0, 1) values: one bf16 rounding
# of o (~2^-9 relative) plus bf16 q/p operands inside the kernel
TOL = 2e-2


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _inputs(B, T, H, seed, device):
    rng = np.random.default_rng(seed)
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32)).to(device, torch.bfloat16)
               for s in ((B, T, H, 64), (B, T, 1, 64), (B, T, 1, 64)))
    return q, k, v, rope_tables(T, 64, scale_base=float(min(T, 512)), device=device)


@pytest.mark.cuda
@pytest.mark.parametrize(
    "B,T,H,window",
    [(2, 1024, 16, 256), (1, 1000, 16, 128), (2, 512, 3, 96), (1, 384, 16, None), (2, 200, 5, None), (1, 256, 16, 512)],
)
def test_flash_fwd_matches_plain(cuda, B, T, H, window):
    q, k, v, rope = _inputs(B, T, H, seed=T + H, device=cuda)
    before = fa.flash_fwd.launches
    out = fa.flash_attention(q, k, v, window, rope)
    torch.cuda.synchronize()
    assert fa.flash_fwd.launches == before + 1
    ref = fa.flash_attention_reference(q.float(), k.float(), v.float(), window, rope)
    assert out.dtype == torch.bfloat16 and out.shape == q.shape
    err = (out.float() - ref).abs().max().item()
    assert err < TOL, f"max abs err {err}"


@pytest.mark.cuda
def test_flash_fwd_rejects_what_it_does_not_take(cuda):
    q, k, v, rope = _inputs(1, 128, 4, seed=0, device=cuda)
    with pytest.raises(ValueError):  # q in fp32, k and v in bf16: no kernel takes mixed operands
        fa.flash_attention(q.float(), k, v, None, rope)
    with pytest.raises(ValueError):  # 4 query heads do not split into 3 KV heads
        fa.flash_attention(q, torch.cat([k, k, k], dim=2), torch.cat([v, v, v], dim=2), None, rope)
    with pytest.raises(ValueError):
        fa.flash_fwd(q, k[:, :, 0], v[:, ::2, 0], *rope, -1, 0.125)


# forward with LSE and fused backward against the fp32 plain versions on the
# same bf16 inputs: p, ds, q and do enter the tensor cores in bf16 (2^-9
# relative each), so every output carries a few 1e-3 relative L2; the LSE is a
# sum of 64 such products of magnitude ~1. bf16 rules out gradcheck.
REL_TOL = 1e-2
LSE_TOL = 2e-2
TRAIN_SHAPES = [(1, 100, 3), (2, 192, 5), (2, 512, 16), (4, 4096, 16)]


def _train_inputs(B, T, H, device):
    g = torch.Generator(device=device).manual_seed(T + H)
    q, do = (torch.randn((B, T, H, 64), generator=g, device=device).to(torch.bfloat16) for _ in range(2))
    k, v = (torch.randn((B, T, 64), generator=g, device=device).to(torch.bfloat16) for _ in range(2))
    return q, k, v, do, rope_tables(T, 64, scale_base=float(T), device=device)


def _rel(x, ref):
    return ((x.float() - ref).norm() / ref.norm()).item()


@pytest.mark.cuda
@pytest.mark.parametrize("B,T,H", TRAIN_SHAPES)
def test_flash_fwd_with_lse_and_flash_bwd_match_plain(cuda, B, T, H):
    q, k, v, do, (cos, sin) = _train_inputs(B, T, H, cuda)
    k_rot = apply_rope(k.float(), cos, sin).to(torch.bfloat16)
    launches = (fa.flash_fwd.lse_launches, fa.flash_bwd.launches)
    o, lse = fa.flash_fwd(q, k_rot, v, cos, sin, -1, 0.125, return_lse=True)
    dq, dk, dv = fa.flash_bwd(q, k_rot, v, o, lse, do, cos, sin, 0.125)
    torch.cuda.synchronize()
    assert (fa.flash_fwd.lse_launches, fa.flash_bwd.launches) == (launches[0] + 1, launches[1] + 1)
    o_ref, lse_ref = fa.flash_fwd_lse_reference(q, k_rot, v, cos, sin)
    assert torch.equal(o, fa.flash_fwd(q, k_rot, v, cos, sin, -1, 0.125))  # the LSE store changes nothing else
    assert _rel(o, o_ref) < REL_TOL and (lse - lse_ref).abs().max().item() < LSE_TOL
    assert dq.dtype == torch.bfloat16 and dk.dtype == dv.dtype == torch.float32
    for name, got, ref in zip(("dq", "dk", "dv"), (dq, dk, dv), fa.flash_bwd_reference(q, k_rot, v, o_ref, lse_ref, do, cos, sin)):
        assert torch.isfinite(got).all() and _rel(got, ref) < REL_TOL, f"{name}: rel L2 {_rel(got, ref)}"


@pytest.mark.cuda
def test_function_gradients_match_autograd_through_plain(cuda):
    B, T, H = 2, 320, 16
    q, k, v, do, rope = _train_inputs(B, T, H, cuda)
    leaves = [t.clone().requires_grad_(True) for t in (q, k[:, :, None], v[:, :, None])]
    out = fa.flash_attention(*leaves, None, rope)
    out.backward(do)
    ref_leaves = [t.detach().float().requires_grad_(True) for t in leaves]
    fa.flash_attention_reference(*ref_leaves, None, rope).backward(do.float())
    for name, got, ref in zip(("dq", "dk", "dv"), leaves, ref_leaves):
        assert got.grad.dtype == torch.bfloat16 and got.grad.shape == got.shape
        assert _rel(got.grad, ref.grad) < REL_TOL, f"{name}: rel L2 {_rel(got.grad, ref.grad)}"
    # the op hands out its LSE and the rotated k, and takes no gradient for them
    o, lse, k_rot = fa.flash_attention_op(leaves[0], k, v, *rope, -1)
    assert lse.shape == (B, T * H) and not lse.requires_grad and not k_rot.requires_grad and o.requires_grad


# (B, T, H, window): a window whose edges cut KV tiles and 128-row blocks at
# H = 3 and 5, a short last block, T not a multiple of 64, and the production
# head count; then the edges of the Hopper pair: T = 4000 (dq's last 128-key
# tile and dkv's last 64-key block hold 32 keys), T = 4097 at H = 7 (one key
# in the last tile, T*H no multiple of the 64-row tile or of the 128-row
# block), and a window wider than the song (every tile is at its first or last
# key tile)
WINDOWED_SHAPES = [(2, 200, 3, 32), (1, 333, 5, 100), (2, 1024, 16, 256), (1, 2048, 16, 128), (1, 4000, 16, 512),
                   (1, 4097, 7, 256), (2, 130, 3, 512)]


def _windowed_backward(q, k_rot, v, o, lse, do, cos, sin, window):
    dq, prep = fa.flash_bwd_dq(q, k_rot, v, o, lse, do, cos, sin, window, 0.125)
    return (dq, *fa.flash_bwd_dkv(k_rot, v, do, prep, window)), prep


@pytest.mark.cuda
@pytest.mark.parametrize("B,T,H,window", WINDOWED_SHAPES)
def test_windowed_forward_with_lse_and_split_backward_match_plain(cuda, B, T, H, window):
    q, k, v, do, _ = _train_inputs(B, T, H, cuda)
    cos, sin = rope_tables(T, 64, scale_base=float(window), device=cuda)
    k_rot = fa.rotated_k(k, cos, sin)
    before = (fa.flash_fwd.lse_launches, fa.flash_bwd_dq.launches, fa.flash_bwd_dkv.launches, fa.flash_bwd.launches)
    o, lse = fa.flash_fwd(q, k_rot, v, cos, sin, window, 0.125, return_lse=True)
    (dq, dk, dv), prep = _windowed_backward(q, k_rot, v, o, lse, do, cos, sin, window)
    torch.cuda.synchronize()
    after = (fa.flash_fwd.lse_launches, fa.flash_bwd_dq.launches, fa.flash_bwd_dkv.launches, fa.flash_bwd.launches)
    assert after == (before[0] + 1, before[1] + 1, before[2] + 1, before[3])
    o_ref, lse_ref = fa.flash_fwd_lse_reference(q, k_rot, v, cos, sin, window)
    assert torch.equal(o, fa.flash_fwd(q, k_rot, v, cos, sin, window, 0.125))  # the LSE store changes nothing else
    assert _rel(o, o_ref) < REL_TOL and (lse - lse_ref).abs().max().item() < LSE_TOL
    # the pre-pass: qs with the forward's bits, delta, and the LSE padded to whole 128-row blocks
    rows, pad = T * H, prep.lse.shape[1]
    assert pad % 128 == 0 and pad - 128 < rows <= pad
    assert torch.equal(prep.qs, fa._scaled_rotated_q(q, cos, sin).to(torch.bfloat16).reshape(B, rows, 64))
    assert torch.equal(prep.lse[:, :rows], lse) and bool((prep.lse[:, rows:] == torch.inf).all())
    assert (prep.delta[:, :rows] - (do.float() * o.float()).sum(-1).reshape(B, -1)).abs().max().item() < 1e-3
    assert not prep.delta[:, rows:].any()
    assert dq.dtype == torch.bfloat16 and dk.dtype == dv.dtype == torch.float32
    refs = (fa.flash_bwd_dq_reference(q, k_rot, v, o_ref, lse_ref, do, cos, sin, window),
            *fa.flash_bwd_dkv_reference(q, k_rot, v, o_ref, lse_ref, do, cos, sin, window))
    for name, got, ref in zip(("dq", "dk", "dv"), (dq, dk, dv), refs):
        assert torch.isfinite(got).all() and _rel(got, ref) < REL_TOL, f"{name}: rel L2 {_rel(got, ref)}"
        # the song's first and last key tiles (dk, dv) and row blocks (dq) on their own
        for edge in (slice(0, 128), slice(max(0, T - 128), T)):
            assert _rel(got[:, edge], ref[:, edge]) < REL_TOL, f"{name} at {edge}: rel L2 {_rel(got[:, edge], ref[:, edge])}"
    # no atomics anywhere in the pair: a second launch repeats every bit
    again, _ = _windowed_backward(q, k_rot, v, o, lse, do, cos, sin, window)
    assert all(torch.equal(a, b) for a, b in zip((dq, dk, dv), again))


@pytest.mark.cuda
@pytest.mark.parametrize("T,W", [(16384, 1024), (8192, 512)])
def test_windowed_backward_at_the_narrow_levels(cuda, T, W):
    """The whole-song path's two narrowest levels (B = 1, H = 16), where the
    dkv kernel has the fewest blocks (256 and 128 of 64 keys), against the
    plain versions."""
    B, H = 1, 16
    q, k, v, do, _ = _train_inputs(B, T, H, cuda)
    cos, sin = rope_tables(T, 64, scale_base=float(W), device=cuda)
    k_rot = fa.rotated_k(k, cos, sin)
    o, lse = fa.flash_fwd(q, k_rot, v, cos, sin, W, 0.125, return_lse=True)
    refs = (fa.flash_bwd_dq_reference(q, k_rot, v, o, lse, do, cos, sin, W),
            *fa.flash_bwd_dkv_reference(q, k_rot, v, o, lse, do, cos, sin, W))
    grads, _ = _windowed_backward(q, k_rot, v, o, lse, do, cos, sin, W)
    for name, got, ref in zip(("dq", "dk", "dv"), grads, refs):
        assert _rel(got, ref) < REL_TOL, f"{name}: rel L2 {_rel(got, ref)}"


@pytest.mark.cuda
def test_split_backward_at_a_global_site_matches_the_fused_kernel(cuda):
    """window = -1 sweeps every key: the pair then computes what ``flash_bwd`` does."""
    q, k, v, do, (cos, sin) = _train_inputs(2, 320, 16, cuda)
    k_rot = fa.rotated_k(k, cos, sin)
    o, lse = fa.flash_fwd(q, k_rot, v, cos, sin, -1, 0.125, return_lse=True)
    fused = fa.flash_bwd(q, k_rot, v, o, lse, do, cos, sin, 0.125)
    split, _ = _windowed_backward(q, k_rot, v, o, lse, do, cos, sin, -1)
    for name, got, ref in zip(("dq", "dk", "dv"), split, fused):
        assert _rel(got, ref.float()) < REL_TOL, f"{name}: rel L2 {_rel(got, ref.float())}"


@pytest.mark.cuda
def test_windowed_site_under_a_gradient_runs_the_split_kernels(cuda):
    B, T, H, window = 2, 320, 16, 64
    q, k, v, do, _ = _train_inputs(B, T, H, cuda)
    rope = rope_tables(T, 64, scale_base=float(window), device=cuda)
    leaves = [t.clone().requires_grad_(True) for t in (q, k[:, :, None], v[:, :, None])]
    before = (fa.flash_fwd.lse_launches, fa.flash_bwd_dq.launches, fa.flash_bwd_dkv.launches, fa.flash_bwd.launches)
    fa.flash_attention(*leaves, window, rope).backward(do)
    after = (fa.flash_fwd.lse_launches, fa.flash_bwd_dq.launches, fa.flash_bwd_dkv.launches, fa.flash_bwd.launches)
    assert after == (before[0] + 1, before[1] + 1, before[2] + 1, before[3])
    ref_leaves = [t.detach().float().requires_grad_(True) for t in leaves]
    fa.flash_attention_reference(*ref_leaves, window, rope).backward(do.float())
    for name, got, ref in zip(("dq", "dk", "dv"), leaves, ref_leaves):
        assert got.grad.dtype == torch.bfloat16 and got.grad.shape == got.shape
        assert _rel(got.grad, ref.grad) < REL_TOL, f"{name}: rel L2 {_rel(got.grad, ref.grad)}"
    # a window that covers the sequence is the global path: the fused backward
    fa.flash_attention(*leaves, T, rope).backward(do)
    assert fa.flash_bwd.launches == before[3] + 1 and fa.flash_bwd_dq.launches == before[1] + 1


@pytest.mark.cuda
def test_windowed_backward_rejects_what_it_does_not_take(cuda):
    q, k, v, do, (cos, sin) = _train_inputs(1, 128, 4, cuda)
    stats = torch.zeros((1, 128 * 4), device=cuda)
    prep = fa.WindowedPrep(q.reshape(1, 128 * 4, 64), stats, stats)
    with pytest.raises(ValueError, match="CUDA"):
        fa.flash_bwd_dq(q.cpu(), k.cpu(), v.cpu(), q.cpu(), stats.cpu(), do.cpu(), cos.cpu(), sin.cpu(), 32, 0.125)
    with pytest.raises(ValueError, match="CUDA"):
        fa.flash_bwd_dkv(k, v, do, prep._replace(delta=stats.cpu()), 32)
    with pytest.raises(ValueError, match="bfloat16"):
        fa.flash_bwd_dq(q, k, v, q, stats, do.float(), cos, sin, 32, 0.125)
    with pytest.raises(ValueError, match="float32"):
        fa.flash_bwd_dkv(k, v, do, prep._replace(delta=stats.bfloat16()), 32)
    with pytest.raises(ValueError, match="shapes"):  # the LSE not padded to whole 128-row blocks
        fa.flash_bwd_dkv(k, v, do, prep._replace(lse=stats[:, :-1]), 32)
    with pytest.raises(ValueError, match="window"):
        fa.flash_bwd_dq(q, k, v, q, stats, do, cos, sin, -2, 0.125)
    with pytest.raises(ValueError, match="window"):
        fa.flash_bwd_dkv(k, v, do, prep, -2)
    with pytest.raises(ValueError, match="window"):
        fa.flash_fwd(q, k, v, cos, sin, -2, 0.125, return_lse=True)


@pytest.mark.cuda
def test_flash_bwd_rejects_what_it_does_not_take(cuda):
    q, k, v, do, (cos, sin) = _train_inputs(1, 128, 4, cuda)
    lse = torch.zeros((1, 128 * 4), device=cuda)
    with pytest.raises(ValueError):
        fa.flash_bwd(q, k, v, q, lse, do.float(), cos, sin, 0.125)
    with pytest.raises(ValueError):
        fa.flash_bwd(q, k, v, q, lse[:, :-1], do, cos, sin, 0.125)
    with pytest.raises(ValueError):
        fa.flash_bwd(q, k, v, q, lse, do.transpose(1, 2).contiguous().transpose(1, 2), cos, sin, 0.125)


# (B, T_local, H, window, shards, shard): the first, an interior and the last
# of four shards; the largest halo (window / 2 == T_local); a window that no
# tile divides at H = 3 and a T_local that is no multiple of 64; one shard
# that is the whole song; a first and a last shard whose halo holds whole
# 64-key dk/dv blocks outside the song (window / 2 of 256 and 192 slab rows),
# the last with T_local * H no multiple of the pre-pass's 128-row padding
HALO_CASES = [(1, 256, 16, 128, 4, s) for s in range(4)] + [
    (1, 128, 16, 256, 4, 0), (1, 128, 16, 256, 4, 3), (2, 200, 3, 100, 3, 1), (2, 200, 3, 100, 3, 2),
    (1, 300, 5, 64, 1, 0), (1, 384, 16, 512, 4, 0), (2, 424, 5, 384, 4, 3),
]


def _halo_inputs(B, T, H, window, device, seed):
    g = torch.Generator(device=device).manual_seed(seed)
    q, do = (torch.randn((B, T, H, 64), generator=g, device=device).to(torch.bfloat16) for _ in range(2))
    # slab rows outside the song hold random values too: the kernels must not look at them
    k, v = (torch.randn((B, T + window, 64), generator=g, device=device).to(torch.bfloat16) for _ in range(2))
    return q, k, v, do


@pytest.mark.cuda
@pytest.mark.parametrize("B,T,H,window,shards,shard", HALO_CASES)
def test_halo_kernels_match_plain(cuda, B, T, H, window, shards, shard):
    q, k, v, do = _halo_inputs(B, T, H, window, cuda, seed=T + shard)
    frame = (window, shard * T, shards * T)
    before = (ha.halo_fwd.launches, ha.halo_bwd_dq.launches, ha.halo_bwd_dkv.launches)
    o, lse = ha.halo_fwd(q, k, v, *frame, 0.125)
    dq, prep = ha.halo_bwd_dq(q, k, v, o, lse, do, *frame, 0.125)
    dk, dv = ha.halo_bwd_dkv(k, v, do, prep, *frame)
    torch.cuda.synchronize()
    assert (ha.halo_fwd.launches, ha.halo_bwd_dq.launches, ha.halo_bwd_dkv.launches) == tuple(n + 1 for n in before)
    o_ref, lse_ref = ha.halo_fwd_reference(q, k, v, *frame)
    assert _rel(o, o_ref) < REL_TOL and (lse - lse_ref).abs().max().item() < LSE_TOL
    assert dq.dtype == torch.bfloat16 and dk.dtype == dv.dtype == torch.float32
    refs = (ha.halo_bwd_dq_reference(q, k, v, o_ref, lse_ref, do, *frame),
            *ha.halo_bwd_dkv_reference(q, k, v, o_ref, lse_ref, do, *frame))
    for name, got, ref in zip(("dq", "dk", "dv"), (dq, dk, dv), refs):
        assert torch.isfinite(got).all() and _rel(got, ref) < REL_TOL, f"{name}: rel L2 {_rel(got, ref)}"
    lo, hi = ha.slab_bounds(T, *frame)
    for grad in (dk, dv):  # the slab rows outside the song get no gradient at all
        assert not grad[:, :lo].any() and not grad[:, hi:].any()
    dq2, prep2 = ha.halo_bwd_dq(q, k, v, o, lse, do, *frame, 0.125)
    dk2, dv2 = ha.halo_bwd_dkv(k, v, do, prep2, *frame)
    assert torch.equal(dq, dq2) and torch.equal(dk, dk2) and torch.equal(dv, dv2)


# (B, T_local, H, window, shards, shard) whose slab holds rows outside the song
# at its start, at its end, at both (one shard is the whole song), and with
# T_local * H no multiple of the forward's 128-row blocks
SLAB_GARBAGE_CASES = [(1, 256, 16, 128, 4, 0), (1, 256, 16, 128, 4, 3), (1, 300, 5, 64, 1, 0), (2, 424, 5, 384, 4, 3)]
GARBAGE = 30.0


@pytest.mark.cuda
@pytest.mark.parametrize("B,T,H,window,shards,shard", SLAB_GARBAGE_CASES)
def test_halo_kernels_ignore_large_slab_rows_outside_the_song(cuda, B, T, H, window, shards, shard):
    """The slab rows outside the song hold real memory (TMA zero-fills only
    past the slab): filled with a large value, a kernel that reads one of
    them misses the plain version by far more than the bound."""
    q, k, v, do = _halo_inputs(B, T, H, window, cuda, seed=7 + shard)
    frame = (window, shard * T, shards * T)
    lo, hi = ha.slab_bounds(T, *frame)
    assert lo > 0 or hi < T + window
    for t in (k, v):
        t[:, :lo] = GARBAGE
        t[:, hi:] = GARBAGE
    o, lse = ha.halo_fwd(q, k, v, *frame, 0.125)
    dq, prep = ha.halo_bwd_dq(q, k, v, o, lse, do, *frame, 0.125)
    dk, dv = ha.halo_bwd_dkv(k, v, do, prep, *frame)
    torch.cuda.synchronize()
    o_ref, lse_ref = ha.halo_fwd_reference(q, k, v, *frame)
    assert torch.isfinite(o).all() and torch.isfinite(lse).all()
    assert _rel(o, o_ref) < REL_TOL and (lse - lse_ref).abs().max().item() < LSE_TOL
    dq_ref = ha.halo_bwd_dq_reference(q, k, v, o_ref, lse_ref, do, *frame)
    assert _rel(dq, dq_ref) < REL_TOL, f"dq: rel L2 {_rel(dq, dq_ref)}"
    for grad in (dk, dv):
        assert not grad[:, :lo].any() and not grad[:, hi:].any()
    # the frame (window, window / 2, T + window) admits every slab row: the fault this case must catch
    o_all, _ = ha.halo_fwd_reference(q, k, v, window, window // 2, T + window)
    assert _rel(o_all, o_ref) > 10 * REL_TOL


@pytest.mark.cuda
def test_halo_op_under_a_gradient_runs_the_halo_kernels(cuda):
    B, T, H, window = 1, 256, 16, 128
    q, k, v, do = _halo_inputs(B, T, H, window, cuda, seed=5)
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    before = (ha.halo_fwd.launches, ha.halo_bwd_dq.launches, ha.halo_bwd_dkv.launches)
    ha.halo_flash_attention(*leaves, window, T, 4 * T).backward(do)
    assert (ha.halo_fwd.launches, ha.halo_bwd_dq.launches, ha.halo_bwd_dkv.launches) == tuple(n + 1 for n in before)
    ref_leaves = [t.detach().float().requires_grad_(True) for t in leaves]
    ha.halo_fwd_reference(*ref_leaves, window, T, 4 * T)[0].backward(do.float())  # autograd through the plain forward
    for name, got, ref in zip(("dq", "dk", "dv"), leaves, ref_leaves):
        assert got.grad.dtype == torch.bfloat16 and got.grad.shape == got.shape
        assert _rel(got.grad, ref.grad) < REL_TOL, f"{name}: rel L2 {_rel(got.grad, ref.grad)}"


@pytest.mark.cuda
def test_halo_kernels_reject_what_they_do_not_take(cuda):
    q, k, v, do = _halo_inputs(1, 128, 4, 64, cuda, seed=0)
    stats = torch.zeros((1, 128 * 4), device=cuda)
    with pytest.raises(ValueError, match="CUDA"):
        ha.halo_fwd(q.cpu(), k.cpu(), v.cpu(), 64, 0, 256, 0.125)
    with pytest.raises(ValueError, match="bfloat16"):
        ha.halo_bwd_dq(q, k, v, q, stats, do.float(), 64, 0, 256, 0.125)
    prep = fa.WindowedPrep(q.reshape(1, 128 * 4, 64), stats, stats)
    with pytest.raises(ValueError, match="float32"):
        ha.halo_bwd_dkv(k, v, do, prep._replace(delta=stats.bfloat16()), 64, 0, 256)
    with pytest.raises(ValueError, match="shapes"):  # the LSE not padded to whole 128-row blocks
        ha.halo_bwd_dkv(k, v, do, prep._replace(lse=stats[:, :-1]), 64, 0, 256)
    with pytest.raises(ValueError, match="shapes"):
        ha.halo_fwd(q, k[:, :-2], v[:, :-2], 64, 0, 256, 0.125)
    with pytest.raises(ValueError, match="even"):
        ha.halo_fwd(q, k[:, :-1], v[:, :-1], 63, 0, 256, 0.125)
    with pytest.raises(ValueError, match="inside the song"):
        ha.halo_fwd(q, k, v, 64, 200, 256, 0.125)


# the grouped forms of K1 and K2 (k, v (B, T, Kv, D)): (B, T, H, Kv, rope):
# DiT's full MHA with a ragged last block, MMDiT's G = 4, an odd group, G = 2
# with rotary tables, and a length no tile divides
GROUPED_SHAPES = [(2, 200, 4, 4, False), (1, 333, 8, 2, False), (2, 256, 6, 3, True), (1, 1000, 8, 8, False),
                  (2, 512, 8, 2, True)]


def _grouped_inputs(B, T, H, Kv, rope, device):
    g = torch.Generator(device=device).manual_seed(T + H + Kv)
    q, do = (torch.randn((B, T, H, 64), generator=g, device=device).to(torch.bfloat16) for _ in range(2))
    k, v = (torch.randn((B, T, Kv, 64), generator=g, device=device).to(torch.bfloat16) for _ in range(2))
    tables = rope_tables(T, 64, scale_base=float(T), device=device) if rope else (None, None)
    return q, k, v, do, tables


@pytest.mark.cuda
@pytest.mark.parametrize("B,T,H,Kv,rope", GROUPED_SHAPES)
def test_grouped_forward_with_lse_and_backward_match_plain(cuda, B, T, H, Kv, rope):
    q, k, v, do, (cos, sin) = _grouped_inputs(B, T, H, Kv, rope, cuda)
    k_rot = fa.rotated_k(k, cos, sin) if rope else k
    launches = (fa.flash_fwd.lse_launches, fa.flash_bwd.launches)
    o, lse = fa.flash_fwd(q, k_rot, v, cos, sin, -1, 0.125, return_lse=True)
    dq, dk, dv = fa.flash_bwd(q, k_rot, v, o, lse, do, cos, sin, 0.125)
    torch.cuda.synchronize()
    assert (fa.flash_fwd.lse_launches, fa.flash_bwd.launches) == (launches[0] + 1, launches[1] + 1)
    o_ref, lse_ref = fa.flash_fwd_lse_reference(q, k_rot, v, cos, sin)
    assert torch.equal(o, fa.flash_fwd(q, k_rot, v, cos, sin, -1, 0.125))  # the LSE store changes nothing else
    assert _rel(o, o_ref) < REL_TOL and (lse - lse_ref).abs().max().item() < LSE_TOL
    assert dq.dtype == torch.bfloat16 and dk.dtype == dv.dtype == torch.float32 and dk.shape == k.shape
    for name, got, ref in zip(("dq", "dk", "dv"), (dq, dk, dv), fa.flash_bwd_reference(q, k_rot, v, o_ref, lse_ref, do, cos, sin)):
        assert torch.isfinite(got).all() and _rel(got, ref) < REL_TOL, f"{name}: rel L2 {_rel(got, ref)}"


@pytest.mark.cuda
def test_grouped_windowed_forward_matches_plain(cuda):
    """Serving a UNet with two KV heads: the windowed forward in its grouped form."""
    q, k, v, _, rope = _grouped_inputs(2, 1024, 16, 2, True, cuda)
    out = fa.flash_attention(q, k, v, 256, rope)
    ref = fa.flash_attention_reference(q.float(), k.float(), v.float(), 256, rope)
    assert _rel(out, ref) < REL_TOL


@pytest.mark.cuda
def test_dit_site_under_a_gradient_runs_the_grouped_kernels(cuda):
    """A DiT site (H == Kv, no tables) through ``flash_attention`` under
    autograd: one forward with its LSE and one fused backward, the gradients
    those of autograd through the plain forward; a windowed grouped site
    without tables runs once per KV head through the windowed pair, with
    identity tables."""
    q, k, v, do, _ = _grouped_inputs(2, 320, 8, 8, False, cuda)
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    before = (fa.flash_fwd.lse_launches, fa.flash_bwd.launches)
    fa.flash_attention(*leaves, None, None).backward(do)
    assert (fa.flash_fwd.lse_launches, fa.flash_bwd.launches) == (before[0] + 1, before[1] + 1)
    ref_leaves = [t.detach().float().requires_grad_(True) for t in leaves]
    fa.flash_attention_reference(*ref_leaves, None, None).backward(do.float())
    for name, got, ref in zip(("dq", "dk", "dv"), leaves, ref_leaves):
        assert got.grad.dtype == torch.bfloat16 and got.grad.shape == got.shape
        assert _rel(got.grad, ref.grad) < REL_TOL, f"{name}: rel L2 {_rel(got.grad, ref.grad)}"
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    before = (fa.flash_fwd.lse_launches, fa.flash_bwd_dq.launches, fa.flash_bwd_dkv.launches, fa.flash_bwd.launches)
    fa.flash_attention(*leaves, 128, None).backward(do)
    after = (fa.flash_fwd.lse_launches, fa.flash_bwd_dq.launches, fa.flash_bwd_dkv.launches, fa.flash_bwd.launches)
    assert after == (before[0] + 8, before[1] + 8, before[2] + 8, before[3])
    ref_leaves = [t.detach().float().requires_grad_(True) for t in leaves]
    fa.flash_attention_reference(*ref_leaves, 128, None).backward(do.float())
    for name, got, ref in zip(("dq", "dk", "dv"), leaves, ref_leaves):
        assert _rel(got.grad, ref.grad) < REL_TOL, f"windowed {name}: rel L2 {_rel(got.grad, ref.grad)}"


@pytest.mark.cuda
@pytest.mark.parametrize("Kv", [2, 4])
def test_windowed_gqa_site_under_a_gradient_runs_per_kv_head(cuda, Kv):
    """A UNet site with Kv > 1 and rotary tables, windowed, under autograd: one
    windowed forward with its LSE, one dq and one dkv per KV head."""
    B, T, H, window = 1, 1024, 16, 256
    q, k, v, do, rope = _grouped_inputs(B, T, H, Kv, True, cuda)
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    before = (fa.flash_fwd.lse_launches, fa.flash_bwd_dq.launches, fa.flash_bwd_dkv.launches)
    out = fa.flash_attention(*leaves, window, rope)
    out.backward(do)
    assert (fa.flash_fwd.lse_launches, fa.flash_bwd_dq.launches, fa.flash_bwd_dkv.launches) == tuple(n + Kv for n in before)
    ref_leaves = [t.detach().float().requires_grad_(True) for t in leaves]
    ref = fa.flash_attention_reference(*ref_leaves, window, rope)
    ref.backward(do.float())
    assert _rel(out, ref.detach()) < REL_TOL
    for name, got, want in zip(("dq", "dk", "dv"), leaves, ref_leaves):
        assert got.grad.shape == got.shape and _rel(got.grad, want.grad) < REL_TOL, f"{name}: {_rel(got.grad, want.grad)}"


# the edges of the Hopper forward and backward (128-key KV tiles, 128-row
# forward blocks, 64-row backward tiles): (B, T, H, Kv, rope): lengths past a
# whole tile (T = 4000, 4097: the last KV tile holds 32 or 1 key), MQA with
# and without tables, full MHA, and a group of G = 3 heads that no tile divides
EDGE_SHAPES = [(1, 4000, 16, 1, True), (1, 4097, 16, 1, False), (2, 4097, 8, 8, False), (1, 1000, 12, 4, False),
               (2, 600, 12, 4, True)]


@pytest.mark.cuda
@pytest.mark.parametrize("B,T,H,Kv,rope", EDGE_SHAPES)
def test_forward_and_backward_at_tile_edges_match_plain(cuda, B, T, H, Kv, rope):
    q, k, v, do, (cos, sin) = _grouped_inputs(B, T, H, Kv, rope, cuda)
    if Kv == 1:
        k, v = k[:, :, 0].contiguous(), v[:, :, 0].contiguous()
    k_rot = fa.rotated_k(k, cos, sin) if rope else k
    o, lse = fa.flash_fwd(q, k_rot, v, cos, sin, -1, 0.125, return_lse=True)
    dq, dk, dv = fa.flash_bwd(q, k_rot, v, o, lse, do, cos, sin, 0.125)
    torch.cuda.synchronize()
    o_ref, lse_ref = fa.flash_fwd_lse_reference(q, k_rot, v, cos, sin)
    assert torch.equal(o, fa.flash_fwd(q, k_rot, v, cos, sin, -1, 0.125))
    assert _rel(o, o_ref) < REL_TOL and (lse - lse_ref).abs().max().item() < LSE_TOL
    for name, got, ref in zip(("dq", "dk", "dv"), (dq, dk, dv), fa.flash_bwd_reference(q, k_rot, v, o_ref, lse_ref, do, cos, sin)):
        assert got.shape == ref.shape and torch.isfinite(got).all() and _rel(got, ref) < REL_TOL, f"{name}: {_rel(got, ref)}"


@pytest.mark.cuda
@pytest.mark.parametrize("rope", [True, False], ids=["tables", "no-tables"])
def test_windowed_forward_at_a_narrow_level_matches_plain(cuda, rope):
    """Forms (a) and (d) at the whole-song path's narrowest level (T = 8192,
    W = 512): the forward alone and with its LSE, and with tables the LSE fed
    to the windowed pair (dq, dkv) against the plain versions."""
    B, T, H, W = 1, 8192, 16, 512
    q, k, v, do, _ = _train_inputs(B, T, H, cuda)
    cos, sin = rope_tables(T, 64, scale_base=float(W), device=cuda) if rope else (None, None)
    k_rot = fa.rotated_k(k, cos, sin) if rope else k
    o, lse = fa.flash_fwd(q, k_rot, v, cos, sin, W, 0.125, return_lse=True)
    assert torch.equal(o, fa.flash_fwd(q, k_rot, v, cos, sin, W, 0.125))
    o_ref, lse_ref = fa.flash_fwd_lse_reference(q, k_rot, v, cos, sin, W)
    assert _rel(o, o_ref) < REL_TOL and (lse - lse_ref).abs().max().item() < LSE_TOL
    if not rope:
        return
    (dq, dk, dv), _ = _windowed_backward(q, k_rot, v, o, lse, do, cos, sin, W)
    refs = (fa.flash_bwd_dq_reference(q, k_rot, v, o_ref, lse_ref, do, cos, sin, W),
            *fa.flash_bwd_dkv_reference(q, k_rot, v, o_ref, lse_ref, do, cos, sin, W))
    for name, got, ref in zip(("dq", "dk", "dv"), (dq, dk, dv), refs):
        assert torch.isfinite(got).all() and _rel(got, ref) < REL_TOL, f"{name}: rel L2 {_rel(got, ref)}"


# the ring (K6): K2's entry points apart, the merge, and the ring over n shards
# as threads of this process (``LocalRing``); (B, T, H, Kv, tables)
RING_SPLIT_SHAPES = [(2, 256, 16, 1, True), (1, 333, 8, 2, False), (2, 200, 4, 4, False)]


def _mqa(x, Kv):
    return x[:, :, 0].contiguous() if Kv == 1 else x


@pytest.mark.cuda
@pytest.mark.parametrize("B,T,H,Kv,rope", RING_SPLIT_SHAPES)
def test_split_backward_entry_points_match_the_one_call(cuda, B, T, H, Kv, rope):
    """The pre-pass, a storing sweep and the post-pass give the one-call
    backward's dk and dv bit for bit (dq up to the order of its atomics); a
    second, accumulating sweep over the same keys doubles dk and dv exactly."""
    q, k, v, do, (cos, sin) = _grouped_inputs(B, T, H, Kv, rope, cuda)
    k, v = _mqa(k, Kv), _mqa(v, Kv)
    k_rot = fa.rotated_k(k, cos, sin) if rope else k
    o, lse = fa.flash_fwd(q, k_rot, v, cos, sin, -1, 0.125, return_lse=True)
    dq, dk, dv = fa.flash_bwd(q, k_rot, v, o, lse, do, cos, sin, 0.125)
    launches = (fa.flash_bwd_prep.launches, fa.flash_bwd_sweep.launches, fa.flash_bwd_post.launches)
    prep = fa.flash_bwd_prep(q, k_rot, v, o, lse, do, cos, sin, 0.125)
    dk2, dv2 = (torch.full(k.shape, float("nan"), device=cuda) for _ in range(2))  # a storing sweep overwrites
    fa.flash_bwd_sweep(k_rot, v, prep, dk2, dv2, accumulate=False)
    dq2 = fa.flash_bwd_post(prep, cos, sin, 0.125)
    torch.cuda.synchronize()
    assert (fa.flash_bwd_prep.launches, fa.flash_bwd_sweep.launches, fa.flash_bwd_post.launches) == tuple(
        n + 1 for n in launches)
    assert torch.equal(dk2, dk) and torch.equal(dv2, dv)
    assert _rel(dq2, dq.float()) < REL_TOL
    fa.flash_bwd_sweep(k_rot, v, prep, dk2, dv2, accumulate=True)
    torch.cuda.synchronize()
    assert torch.equal(dk2, 2 * dk) and torch.equal(dv2, 2 * dv)


@pytest.mark.cuda
def test_ring_merge_matches_plain(cuda):
    """Three hops folded by the kernel and by the plain merge; the last writes
    the bf16 output."""
    g = torch.Generator(device=cuda).manual_seed(5)
    B, T, H = 2, 300, 6
    parts = [(torch.randn((B, T, H, 64), generator=g, device=cuda).to(torch.bfloat16),
              torch.randn((B, T * H), generator=g, device=cuda) * 4) for _ in range(3)]
    o_acc = lse = acc_ref = lse_ref = None
    before = fa.ring_merge.launches
    for hop, (o_j, lse_j) in enumerate(parts):
        o_acc, lse, o = fa.ring_merge(o_acc, lse, o_j, lse_j, last=hop == 2)
        acc_ref, lse_ref = fa.ring_merge_reference(acc_ref, lse_ref, o_j, lse_j)
    torch.cuda.synchronize()
    assert fa.ring_merge.launches == before + 3 and o.dtype == torch.bfloat16
    assert (o.float() - acc_ref).abs().max().item() < TOL and (lse - lse_ref).abs().max().item() < 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("n,B,T,H,Kv,rope", [(2, 2, 1024, 16, 1, True), (4, 1, 1024, 8, 2, False),
                                             (4, 2, 512, 4, 4, False)])
def test_ring_over_shards_matches_its_plain_parts(cuda, n, B, T, H, Kv, rope):
    """The ring forward and backward of every shard (K1 and the merge per hop;
    the pre-pass, an accumulating sweep per hop, the post-pass) against the
    same ring through the plain parts."""
    from osufusion_tpu_torch.ops.ring_attention import LocalRing, PlainParts, ring_bwd, ring_fwd

    q, k, v, do, (cos, sin) = _grouped_inputs(B, T, H, Kv, rope, cuda)
    k, v = _mqa(k, Kv), _mqa(v, Kv)
    k_rot = fa.rotated_k(k, cos, sin) if rope else k
    t = T // n

    def run(parts):
        def rank(r, rotation):
            qr, kr, vr, dor = (x[:, r * t : (r + 1) * t].contiguous() for x in (q, k_rot, v, do))
            c, s = (None, None) if cos is None else (cos[r * t : (r + 1) * t], sin[r * t : (r + 1) * t])
            o, lse = ring_fwd(qr, kr, vr, c, s, rotation, parts)
            return (o, lse, *ring_bwd(qr, kr, vr, o, lse, dor, c, s, rotation, parts))

        results = LocalRing(n).run(rank)
        torch.cuda.synchronize()
        return [torch.cat([r[i] for r in results], dim=1) for i in range(5)]

    got, ref = run(None), run(PlainParts)
    assert got[0].dtype == got[2].dtype == torch.bfloat16 and got[3].dtype == torch.float32
    assert _rel(got[0], ref[0]) < REL_TOL and (got[1] - ref[1]).abs().max().item() < LSE_TOL
    for name, a, b in zip(("dq", "dk", "dv"), got[2:], ref[2:]):
        assert torch.isfinite(a).all() and _rel(a, b) < REL_TOL, f"{name}: rel L2 {_rel(a, b)}"


# ------------------------------------------------- forms no kernel takes, DPM++


def _kernel_launches() -> tuple:
    return (fa.flash_fwd.launches, fa.flash_bwd.launches, fa.flash_bwd_dq.launches, fa.flash_bwd_dkv.launches,
            fa.flash_bwd_prep.launches, fa.flash_bwd_sweep.launches, fa.flash_bwd_post.launches,
            fa.ring_merge.launches, ha.halo_fwd.launches, ha.halo_bwd_dq.launches, ha.halo_bwd_dkv.launches)


def _forms_launches() -> tuple:
    return (forms.forms_fwd.launches, forms.forms_bwd_prep.launches, forms.forms_bwd_dq.launches,
            forms.forms_bwd_dkv.launches, forms.forms_bwd_post.launches, forms.forms_ring_merge.launches)


# fp16 against the plain fp32 versions on the same fp16 inputs: P and dS are
# rounded to fp16 (2^-11 relative) where the bf16 kernels round to bf16
F16_REL_TOL, F16_LSE_TOL = 2e-3, 2e-3
NO_WGMMA_SITES = [(torch.float16, 64), (torch.float32, 320), (torch.bfloat16, 320)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,D", NO_WGMMA_SITES, ids=["fp16", "fp32-D320", "bf16-D320"])
@pytest.mark.parametrize("window", [256, None], ids=["windowed", "global"])
def test_site_no_kernel_takes_raises_on_the_card(cuda, dtype, D, window):
    """fp16 operands, or a head dim above 256, which the JAX package runs
    through Pallas: ``sdpa`` raises nothing and runs the forms family (its
    fp16 instance, its chunked instance above 256), forward and under a
    gradient, with the forms launch counters moving and no wgmma kernel
    launched, and matches autograd through the plain attention in fp32."""
    from osufusion_tpu_torch.ops.attention import sdpa

    B, T, H = 2, 512, 4
    rel_tol = {torch.float16: F16_REL_TOL, torch.float32: F32_REL_TOL, torch.bfloat16: REL_TOL}[dtype]
    g = torch.Generator(device=cuda).manual_seed(D)
    q, do = (torch.randn((B, T, H, D), generator=g, device=cuda).to(dtype) for _ in range(2))
    k, v = (torch.randn((B, T, 1, D), generator=g, device=cuda).to(dtype) for _ in range(2))
    rope = rope_tables(T, D, scale_base=512.0, device=cuda)
    before = _kernel_launches(), _forms_launches()
    with torch.no_grad():
        fwd = sdpa(q, k, v, window, rope)
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    out = sdpa(*leaves, window, rope)
    out.backward(do)
    torch.cuda.synchronize()
    assert _kernel_launches() == before[0]
    runs = [a - b for a, b in zip(_forms_launches(), before[1])]
    assert runs == [2, 1, 1, 1, 1, 0], runs
    ref_leaves = [t.float().requires_grad_(True) for t in (q, k, v)]
    ref = fa.flash_attention_reference(*ref_leaves, window, rope)
    ref.backward(do.float())
    assert fwd.dtype == out.dtype == dtype and _rel(fwd, ref) < rel_tol and _rel(out, ref) < rel_tol
    for name, a, b in zip("qkv", leaves, ref_leaves):
        assert torch.isfinite(a.grad).all() and _rel(a.grad, b.grad) < rel_tol, f"d{name}: {_rel(a.grad, b.grad)}"


# the DPM-16 signal through the kernels vs through the plain attention (both
# bf16 on the card): chip_smoke.py's bound for the sampled signal
SAMPLER_REL_TOL = 5e-2


@pytest.mark.cuda
def test_dpm16_through_the_kernels_matches_the_plain_attention(cuda):
    """The serving UNet (dim_h=128, bf16, weights random everywhere with the
    final conv at 1e-3 of its lecun scale, as chip_smoke.py serves it)
    samples 8192 frames with DPM-Solver++(2M) at 16 steps and CFG 2.0:
    through the kernels, one forward a site and step (and the audio stack's
    once), within SAMPLER_REL_TOL of the same sampler through the plain
    attention."""
    from osufusion_tpu_torch.config import DiffusionConfig, ModelConfig
    from osufusion_tpu_torch.models import build_model
    from osufusion_tpu_torch.nn import blocks

    model = build_model(ModelConfig(dim_h=128), DiffusionConfig())
    params = model.init_params(seed=0, device=cuda, dtype=torch.float32)
    g = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for name, p in params.named_parameters():
            if name.endswith("bias"):
                p.copy_(torch.randn(p.shape, generator=g) * 0.1)
            elif p.ndim == 1 and name.endswith("weight"):
                p.copy_(1.0 + torch.randn(p.shape, generator=g) * 0.1)
        w = params.final_conv.weight
        w.copy_(torch.randn(w.shape, generator=g) / w.shape[1] ** 0.5 * 1e-3)
    params = params.to(torch.bfloat16).eval()
    plain = copy.deepcopy(params)
    for module in plain.modules():
        if isinstance(module, blocks.Attention):
            module.sdpa = fa.flash_attention_reference
    N = 8192
    a = (torch.randn((1, 96, N), generator=g) * 3 - 10).to(cuda)
    c = (torch.rand((1, 5), generator=g) * 2 - 1).to(cuda)
    x0 = torch.randn((1, 6, N), generator=g).to(cuda)
    before = fa.flash_fwd.launches
    got = model.sample(params, a, c, x=x0, cond_scale=2.0, sampling_timesteps=16, method="dpmpp-2m")
    torch.cuda.synchronize()
    launches = fa.flash_fwd.launches - before
    ref = model.sample(plain, a, c, x=x0, cond_scale=2.0, sampling_timesteps=16, method="dpmpp-2m")
    cfg = params.cfg
    assert launches == sum(cfg.num_layer_blocks) + 16 * (2 * sum(cfg.num_layer_blocks) + cfg.num_middle_transformers)
    assert got.shape == (1, 6, N) and torch.isfinite(got).all()
    assert _rel(got, ref) < SAMPLER_REL_TOL


# ------------------------------------------------- the forms family (csrc/flash_forms.cu)

FORMS = [(dt, D) for dt in (torch.float32, torch.bfloat16) for D in (64, 128, 192, 256)]
FORMS_IDS = [f"{'fp32' if dt == torch.float32 else 'bf16'}-D{D}" for dt, D in FORMS]
# fp32 against the plain fp32 versions: the same arithmetic summed in another
# order, a few 1e-7 relative at these lengths (the bound leaves room for
# fp32's worst case over a few hundred keys); bf16: the wgmma kernels' bounds
F32_REL_TOL, F32_LSE_TOL = 1e-4, 1e-4
# (B, T, H, Kv, window, tables): MQA global with tables and a ragged last tile,
# MQA windowed with tables at a length and window no tile divides, grouped
# (G = 4) global without tables, grouped (G = 2) windowed without tables
FORMS_SITES = [(2, 200, 3, 1, -1, True), (1, 333, 4, 1, 100, True), (2, 256, 8, 2, -1, False),
               (1, 300, 6, 3, 64, False)]
FORMS_SITE_IDS = ["mqa-global", "mqa-windowed", "grouped-global", "grouped-windowed"]


def _forms_tols(dtype):
    return (F32_REL_TOL, F32_LSE_TOL) if dtype == torch.float32 else (REL_TOL, LSE_TOL)


def _forms_inputs(B, T, H, Kv, D, dtype, tables, device, seed=0):
    g = torch.Generator(device=device).manual_seed(seed)
    q, do = (torch.randn((B, T, H, D), generator=g, device=device).to(dtype) for _ in range(2))
    shape = (B, T, D) if Kv == 1 else (B, T, Kv, D)
    k, v = (torch.randn(shape, generator=g, device=device).to(dtype) for _ in range(2))
    cos, sin = rope_tables(T, D, scale_base=float(T), device=device) if tables else (None, None)
    return q, (k if cos is None else fa.rotated_k(k, cos, sin)), v, do, cos, sin


@pytest.mark.cuda
@pytest.mark.parametrize("B,T,H,Kv,window,tables", FORMS_SITES, ids=FORMS_SITE_IDS)
@pytest.mark.parametrize("dtype,D", FORMS, ids=FORMS_IDS)
def test_forms_instance_matches_plain(cuda, dtype, D, B, T, H, Kv, window, tables):
    """Every instance of the forms family through its wrappers (bf16/64 too,
    which the form rule gives the wgmma kernels): the forward with its LSE,
    then the pre-pass, dq, dk/dv and post-pass, against the plain fp32
    versions; each entry point launched once."""
    rel_tol, lse_tol = _forms_tols(dtype)
    q, k_rot, v, do, cos, sin = _forms_inputs(B, T, H, Kv, D, dtype, tables, cuda, seed=D + T)
    scale = D**-0.5
    before = _forms_launches()
    o = torch.empty_like(q)
    lse = torch.empty((B, T * H), dtype=torch.float32, device=cuda)
    forms.forms_fwd(q, k_rot, v, cos, sin, o, lse, window, scale)
    prep = forms.forms_bwd_prep(q, o, lse, do, cos, sin, Kv, scale)
    dk = torch.empty(k_rot.shape, dtype=torch.float32, device=cuda)
    dv = torch.empty_like(dk)
    forms.forms_bwd_dq(k_rot, v, prep, window, None, accumulate=False)
    forms.forms_bwd_dkv(k_rot, v, prep, dk, dv, window, None, accumulate=False)
    dq = forms.forms_bwd_post(prep, cos, sin, scale)
    torch.cuda.synchronize()
    assert [a - b for a, b in zip(_forms_launches(), before)] == [1, 1, 1, 1, 1, 0]
    o_ref, lse_ref = fa.flash_fwd_lse_reference(q, k_rot, v, cos, sin, window)
    refs = (fa.flash_bwd_dq_reference(q, k_rot, v, o_ref, lse_ref, do, cos, sin, window),
            *fa.flash_bwd_dkv_reference(q, k_rot, v, o_ref, lse_ref, do, cos, sin, window))
    assert o.dtype == dq.dtype == dtype and dk.dtype == torch.float32
    assert _rel(o, o_ref) < rel_tol and (lse - lse_ref).abs().max().item() < lse_tol
    for name, a, b in zip(("dq", "dk", "dv"), (dq, dk, dv), refs):
        assert torch.isfinite(a).all() and _rel(a, b) < rel_tol, f"{name}: rel L2 {_rel(a, b)}"


@pytest.mark.cuda
@pytest.mark.parametrize("shard", [0, 3], ids=["first", "last"])
@pytest.mark.parametrize("dtype,D", FORMS, ids=FORMS_IDS)
def test_forms_halo_instance_matches_plain(cuda, dtype, D, shard):
    """The forms instances in the halo frame, through the halo wrappers
    (forms by the operands' form; bf16/64 takes the wgmma instance there):
    the slab rows outside the song hold large values that the kernels must
    ignore, and their dk and dv are exact zeros."""
    B, T, H, W, n = 1, 256, 4, 128, 4
    rel_tol, lse_tol = _forms_tols(dtype)
    g = torch.Generator(device=cuda).manual_seed(D + shard)
    q, do = (torch.randn((B, T, H, D), generator=g, device=cuda).to(dtype) for _ in range(2))
    k, v = (torch.randn((B, T + W, D), generator=g, device=cuda).to(dtype) for _ in range(2))
    g0, t_global = shard * T, n * T
    lo, hi = ha.slab_bounds(T, W, g0, t_global)
    k[:, :lo], k[:, hi:], v[:, :lo], v[:, hi:] = 30.0, 30.0, 30.0, 30.0
    scale = D**-0.5
    o, lse = ha.halo_fwd(q, k, v, W, g0, t_global, scale)
    dq, prep = ha.halo_bwd_dq(q, k, v, o, lse, do, W, g0, t_global, scale)
    dk, dv = ha.halo_bwd_dkv(k, v, do, prep, W, g0, t_global)
    torch.cuda.synchronize()
    o_ref, lse_ref = ha.halo_fwd_reference(q, k, v, W, g0, t_global)
    refs = (ha.halo_bwd_dq_reference(q, k, v, o_ref, lse_ref, do, W, g0, t_global),
            *ha.halo_bwd_dkv_reference(q, k, v, o_ref, lse_ref, do, W, g0, t_global))
    assert _rel(o, o_ref) < rel_tol and (lse - lse_ref).abs().max().item() < lse_tol
    for name, a, b in zip(("dq", "dk", "dv"), (dq, dk, dv), refs):
        assert torch.isfinite(a).all() and _rel(a, b) < rel_tol, f"{name}: rel L2 {_rel(a, b)}"
    outside = torch.ones(T + W, dtype=torch.bool, device=cuda)
    outside[lo:hi] = False
    assert (dk[:, outside] == 0).all() and (dv[:, outside] == 0).all()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,D,Kv,rope", [(torch.float32, 64, 1, True), (torch.bfloat16, 128, 2, False),
                                             (torch.float32, 256, 4, False)], ids=["fp32-D64", "bf16-D128", "fp32-D256"])
def test_forms_ring_over_shards_matches_its_plain_parts(cuda, dtype, D, Kv, rope):
    """The ring at a form beside bf16/64: the kernel parts against the plain
    parts, over 2 shards. fp32: the forms forward, merge, pre-pass, dq and
    dk/dv sweeps storing on the first hop and adding after, post-pass. bf16
    at D = 128: K1 per hop and K2's accumulating sweep of that head dim,
    between the forms pre-pass and post-pass, with the forms merge."""
    from osufusion_tpu_torch.ops.ring_attention import LocalRing, PlainParts, ring_bwd, ring_fwd

    n, B, T, H = 2, 1, 512, 8
    rel_tol, lse_tol = _forms_tols(dtype)
    q, k_rot, v, do, cos, sin = _forms_inputs(B, n * T, H, Kv, D, dtype, rope, cuda, seed=7)

    def run(parts):
        def rank(r, rotation):
            sl = slice(r * T, (r + 1) * T)
            c, s = (None, None) if cos is None else (cos[sl].contiguous(), sin[sl].contiguous())
            qr, kr, vr, dor = (x[:, sl].contiguous() for x in (q, k_rot, v, do))
            o, lse = ring_fwd(qr, kr, vr, c, s, rotation, parts)
            return (o, lse, *ring_bwd(qr, kr, vr, o, lse, dor, c, s, rotation, parts))

        results = LocalRing(n).run(rank)
        torch.cuda.synchronize()
        return [torch.cat([r[i] for r in results], dim=1) for i in range(5)]

    before = _kernel_launches(), _forms_launches()
    got = run(None)
    kernels = [a - b for a, b in zip(_kernel_launches(), before[0])]
    wgmma = dtype == torch.bfloat16  # K1's hops (flash_fwd) and K2's sweeps (flash_bwd_sweep)
    assert kernels == [n * n * wgmma, 0, 0, 0, 0, n * n * wgmma, 0, 0, 0, 0, 0], kernels
    assert [a - b for a, b in zip(_forms_launches(), before[1])] == [
        n * n * (not wgmma), n, n * n * (not wgmma), n * n * (not wgmma), n, n * n]
    ref = run(PlainParts)
    assert got[0].dtype == got[2].dtype == dtype and got[3].dtype == torch.float32
    assert _rel(got[0], ref[0]) < rel_tol and (got[1] - ref[1]).abs().max().item() < lse_tol
    for name, a, b in zip(("dq", "dk", "dv"), got[2:], ref[2:]):
        assert torch.isfinite(a).all() and _rel(a, b) < rel_tol, f"{name}: rel L2 {_rel(a, b)}"


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,D", [(torch.float32, 64), (torch.bfloat16, 128)], ids=["fp32-D64", "bf16-D128"])
@pytest.mark.parametrize("window", [96, None], ids=["windowed", "global"])
def test_sdpa_runs_a_forms_site_through_the_forms_kernels(cuda, dtype, D, window):
    """``sdpa`` under a gradient at fp32/64 and bf16/128 on the card, against
    autograd through the plain attention in fp32. fp32: the forms kernels and
    none of the wgmma ones, forward and backward. bf16/128: K1 forward; a
    global site K2's sweep between the forms pre-pass and post-pass, a
    windowed one the forms dq / dk-dv pair."""
    from osufusion_tpu_torch.ops.attention import sdpa

    B, T, H = 2, 384, 4
    rel_tol, _ = _forms_tols(dtype)
    q, k, v, do, cos, sin = _forms_inputs(B, T, H, 2, D, dtype, True, cuda, seed=3)
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    before = _kernel_launches(), _forms_launches()
    out = sdpa(*leaves, window, (cos, sin))
    out.backward(do)
    torch.cuda.synchronize()
    # a windowed site runs per KV head (2); a global one once
    runs = 2 if window is not None else 1
    kernels = [a - b for a, b in zip(_kernel_launches(), before[0])]
    formed = [a - b for a, b in zip(_forms_launches(), before[1])]
    if dtype == torch.float32:
        assert kernels == [0] * 11 and formed == [runs] * 5 + [0]
    elif window is None:  # K1 and K2 (flash_bwd), the forms pre-pass and post-pass around the sweep
        assert kernels == [1, 1] + [0] * 9 and formed == [0, 1, 0, 0, 1, 0]
    else:  # K1 per KV head, then the forms pair
        assert kernels == [runs] + [0] * 10 and formed == [0] + [runs] * 4 + [0]
    ref_leaves = [t.float().requires_grad_(True) for t in (q, k, v)]
    ref = fa.flash_attention_reference(*ref_leaves, window, (cos, sin))
    ref.backward(do.float())
    assert out.dtype == dtype and _rel(out, ref) < rel_tol
    for name, a, b in zip("qkv", leaves, ref_leaves):
        assert a.grad.dtype == dtype and _rel(a.grad, b.grad) < rel_tol, f"d{name}: rel L2 {_rel(a.grad, b.grad)}"


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("grad", [False, True], ids=["forward", "gradient"])
def test_site_no_kernel_tiles_runs_the_xla_route_on_the_card(cuda, dtype, grad):
    """A head dim of 32 on the card: what the JAX package sends to XLA, rope
    and then the plain grouped attention with native autograd; no kernel is
    launched, and it equals the plain attention."""
    from osufusion_tpu_torch.ops.attention import sdpa

    B, T, H, D = 2, 256, 4, 32
    q, k, v, do, cos, sin = _forms_inputs(B, T, H, 1, D, dtype, False, cuda, seed=5)
    k, v = k[:, :, None], v[:, :, None]
    rope = rope_tables(T, D, scale_base=256.0, device=cuda)
    leaves = [t.clone().requires_grad_(grad) for t in (q, k, v)]
    before = _kernel_launches(), _forms_launches()
    out = sdpa(*leaves, 64, rope)
    if grad:
        out.backward(do)
    torch.cuda.synchronize()
    assert (_kernel_launches(), _forms_launches()) == before
    ref_leaves = [t.clone().requires_grad_(grad) for t in (q, k, v)]
    ref = fa.flash_attention_reference(*ref_leaves, 64, rope)
    assert torch.equal(out, ref)
    if grad:
        ref.backward(do)
        for a, b in zip(leaves, ref_leaves):
            assert torch.equal(a.grad, b.grad)


# ------------------------------------------------- K1 and K2 at D = 128, 192, 256 (bf16, wgmma)

WIDE_DIMS = [128, 192, 256]
# (B, T, H, Kv, window, tables): MQA global with tables (K1 with its LSE, K2), MQA windowed with tables (K1,
# then the forms dq / dk-dv pair), full MHA without tables (H = Kv = 4, DiT's form), GQA (G = 2) with a
# ragged last tile
WIDE_SITES = [(2, 1024, 4, 1, -1, True), (1, 1000, 4, 1, 256, True), (2, 512, 4, 4, -1, False),
              (1, 333, 8, 4, -1, False)]
WIDE_SITE_IDS = ["mqa-global", "mqa-windowed", "mha-global", "gqa-ragged"]


@pytest.mark.cuda
@pytest.mark.parametrize("B,T,H,Kv,window,tables", WIDE_SITES, ids=WIDE_SITE_IDS)
@pytest.mark.parametrize("D", WIDE_DIMS)
def test_wide_k1_and_k2_match_plain(cuda, D, B, T, H, Kv, window, tables):
    """K1 and K2's instances at head dim D through their wrappers, against the
    plain fp32 versions on the same bf16 inputs with the D = 64 kernels'
    bounds, and planted faults (the forward without its last KV tile; the
    backward from an LSE off by 0.05) above them. The forward launches K1,
    the global backward K2's sweep (``flash_bwd``), the windowed one the
    forms pair; no forms forward runs."""
    q, k_rot, v, do, cos, sin = _forms_inputs(B, T, H, Kv, D, torch.bfloat16, tables, cuda, seed=D + T)
    scale = D**-0.5
    before = _kernel_launches(), _forms_launches()
    o, lse = fa.flash_fwd(q, k_rot, v, cos, sin, window, scale, return_lse=True)
    if window < 0:
        dq, dk, dv = fa.flash_bwd(q, k_rot, v, o, lse, do, cos, sin, scale)
    else:
        dq, prep = fa.flash_bwd_dq(q, k_rot, v, o, lse, do, cos, sin, window, scale)
        dk, dv = fa.flash_bwd_dkv(k_rot, v, do, prep, window)
    torch.cuda.synchronize()
    kernels = [a - b for a, b in zip(_kernel_launches(), before[0])]
    formed = [a - b for a, b in zip(_forms_launches(), before[1])]
    assert kernels[0] == 1 and kernels[1] == (window < 0) and sum(kernels[2:]) == 0, kernels
    assert formed == ([0, 1, 0, 0, 1, 0] if window < 0 else [0, 1, 1, 1, 1, 0]), formed
    o_ref, lse_ref = fa.flash_fwd_lse_reference(q, k_rot, v, cos, sin, window)
    cut = slice(0, T - 64 if window < 0 else T)
    o_fault = fa.flash_fwd_lse_reference(q, k_rot[:, cut], v[:, cut], cos, sin, window if window < 0 else window - 32)[0]

    def plain(lse_in):
        return (fa.flash_bwd_dq_reference(q, k_rot, v, o_ref, lse_in, do, cos, sin, window),
                *fa.flash_bwd_dkv_reference(q, k_rot, v, o_ref, lse_in, do, cos, sin, window))

    refs, faults = plain(lse_ref), plain(lse_ref + 0.05)
    assert o.dtype == dq.dtype == torch.bfloat16 and dk.dtype == torch.float32
    assert _rel(o, o_ref) < REL_TOL < _rel(o_fault, o_ref)
    assert (lse - lse_ref).abs().max().item() < LSE_TOL and torch.isfinite(o).all()
    for name, a, b, fault in zip(("dq", "dk", "dv"), (dq, dk, dv), refs, faults):
        assert torch.isfinite(a).all() and _rel(a, b) < REL_TOL < _rel(fault, b), \
            f"{name}: rel L2 {_rel(a, b)}, planted fault {_rel(fault, b)}"


@pytest.mark.cuda
@pytest.mark.parametrize("shard", [0, 3], ids=["first", "last"])
@pytest.mark.parametrize("D", WIDE_DIMS)
def test_wide_halo_forward_runs_k1(cuda, D, shard):
    """The halo forward at head dim D runs K1's halo instance (``halo_fwd``),
    not the forms forward, and matches its plain version with the slab rows
    outside the song set large; a slab one row off its frame lies above the
    bound."""
    B, T, H, W, n = 1, 512, 4, 256, 4
    g = torch.Generator(device=cuda).manual_seed(D + shard)
    q = torch.randn((B, T, H, D), generator=g, device=cuda).bfloat16()
    k, v = (torch.randn((B, T + W, D), generator=g, device=cuda).bfloat16() for _ in range(2))
    g0, t_global = shard * T, n * T
    lo, hi = ha.slab_bounds(T, W, g0, t_global)
    k[:, :lo], k[:, hi:], v[:, :lo], v[:, hi:] = 30.0, 30.0, 30.0, 30.0
    before = ha.halo_fwd.launches, forms.forms_fwd.launches
    o, lse = ha.halo_fwd(q, k, v, W, g0, t_global, D**-0.5)
    torch.cuda.synchronize()
    assert (ha.halo_fwd.launches, forms.forms_fwd.launches) == (before[0] + 1, before[1])
    o_ref, lse_ref = ha.halo_fwd_reference(q, k, v, W, g0, t_global)
    shifted = ha.halo_fwd_reference(q, k.roll(1, dims=1), v.roll(1, dims=1), W, g0, t_global)[0]
    assert _rel(o, o_ref) < REL_TOL < _rel(shifted, o_ref)
    assert (lse - lse_ref).abs().max().item() < LSE_TOL


@pytest.mark.cuda
@pytest.mark.parametrize("Kv,rope", [(1, True), (2, False)], ids=["mqa-tables", "gqa"])
@pytest.mark.parametrize("D", WIDE_DIMS)
def test_wide_ring_accumulating_sweep_matches_its_plain_parts(cuda, D, Kv, rope):
    """The ring at bf16 and head dim D over 2 and 4 shards: K1 per hop, the
    forms merge, and K2's sweep of that head dim adding into the travelling
    dk and dv (and into one dq buffer) between the forms pre-pass and
    post-pass, against the plain parts; kernel sweeps that store in place of
    adding lie above the bound."""
    from osufusion_tpu_torch.ops.ring_attention import KernelParts, LocalRing, PlainParts, ring_bwd, ring_fwd

    class StoringSweeps(KernelParts):  # planted fault: every hop's sweep stores its dk and dv
        @staticmethod
        def backward_sweep(state, k, v, dk, dv, accumulate):
            fa.flash_bwd_sweep(k, v, state, dk, dv, False)

    B, T, H = 1, 512, 4
    for n in (2, 4):
        q, k_rot, v, do, cos, sin = _forms_inputs(B, n * T, H, Kv, D, torch.bfloat16, rope, cuda, seed=D + n)

        def run(parts):
            def rank(r, rotation):
                sl = slice(r * T, (r + 1) * T)
                c, s = (None, None) if cos is None else (cos[sl].contiguous(), sin[sl].contiguous())
                qr, kr, vr, dor = (x[:, sl].contiguous() for x in (q, k_rot, v, do))
                o, lse = ring_fwd(qr, kr, vr, c, s, rotation, parts)
                return (o, lse, *ring_bwd(qr, kr, vr, o, lse, dor, c, s, rotation, parts))

            results = LocalRing(n).run(rank)
            torch.cuda.synchronize()
            return [torch.cat([r[i] for r in results], dim=1) for i in range(5)]

        before = fa.flash_fwd.launches, fa.flash_bwd_sweep.launches, forms.forms_fwd.launches
        got = run(None)
        assert (fa.flash_fwd.launches - before[0], fa.flash_bwd_sweep.launches - before[1]) == (n * n, n * n)
        assert forms.forms_fwd.launches == before[2]
        ref = run(PlainParts)
        stored = run(StoringSweeps)
        assert _rel(got[0], ref[0]) < REL_TOL and (got[1] - ref[1]).abs().max().item() < LSE_TOL
        for name, a, b in zip(("dq", "dk", "dv"), got[2:], ref[2:]):
            assert torch.isfinite(a).all() and _rel(a, b) < REL_TOL, f"n={n} {name}: rel L2 {_rel(a, b)}"
        assert _rel(stored[4], ref[4]) > REL_TOL


@pytest.mark.cuda
def test_wide_whole_song_gradient_through_k1_and_the_forms_pair(cuda):
    """A whole-song site at bf16 and D = 128 under a gradient (windowed, MQA
    with tables, 16384 frames): K1 forward with its LSE feeding the forms dq
    and dk/dv kernels (through their pre-pass, which reads K1's LSE), against
    autograd through the plain attention in fp32."""
    B, T, H, D, W = 1, 16384, 4, 128, 1024
    q, k, v, do, cos, sin = _forms_inputs(B, T, H, 1, D, torch.bfloat16, False, cuda, seed=11)
    k, v = k[:, :, None], v[:, :, None]
    rope = rope_tables(T, D, scale_base=float(T), device=cuda)
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    before = _kernel_launches(), _forms_launches()
    out = fa.flash_attention(*leaves, W, rope)
    out.backward(do)
    torch.cuda.synchronize()
    kernels = [a - b for a, b in zip(_kernel_launches(), before[0])]
    assert kernels == [1] + [0] * 10, kernels
    assert [a - b for a, b in zip(_forms_launches(), before[1])] == [0, 1, 1, 1, 1, 0]
    ref_leaves = [t.float().requires_grad_(True) for t in (q, k, v)]
    ref = fa.flash_attention_reference(*ref_leaves, W, rope)
    ref.backward(do.float())
    assert _rel(out, ref) < REL_TOL
    for name, a, b in zip("qkv", leaves, ref_leaves):
        assert torch.isfinite(a.grad).all() and _rel(a.grad, b.grad) < REL_TOL, f"d{name}: {_rel(a.grad, b.grad)}"
