"""Windowed MQA attention of one sequence shard against its halo-extended
keys, the attention of sequence-parallel training (``parallel/sequence.py``):
the wrappers of its CUDA kernels, the differentiable op that joins them, and
their plain PyTorch versions.

``halo_fwd`` replaces ``osufusion_tpu/ops/pallas_attention.py::_halo_fwd_kernel``
(launched by ``_halo_flash_fwd``): the flash forward of ``csrc/flash_fwd.cu``
in the halo frame. ``halo_bwd_dq`` and ``halo_bwd_dkv`` replace
``_halo_dq_kernel`` and ``_halo_dkv_kernel`` (launched by
``_halo_flash_bwd``): the windowed backward pair of
``csrc/flash_bwd_windowed.cu`` in the halo frame, after the windowed pair's
pre-pass without tables (``flash_attention.windowed_prep``), which
``halo_bwd_dq`` launches first and which writes qs, delta and the padded LSE
once for both. The frame's numbers are computed once in C++
(``csrc/key_frame.cuh``), as ``slab_bounds`` computes them here.

The halo frame: a rank holds T local query rows, global frames g0 .. g0+T-1,
and a slab of S = T + W keys whose row s is global frame g0 - W/2 + s (the
exchange brings W/2 frames from each neighbour, zeros past the song's ends).
Local query t sees slab row s iff |t + W/2 - s| <= W/2 (the single-device
window) and 0 <= g0 - W/2 + s < t_global (inside the song). g0 and t_global
are runtime arguments, so one build serves every rank and level. q arrives
rotated (the caller applies RoPE from the global tables), k rotated and v as
the exchange delivers them; the softmax scale D^-0.5 * log2(e) is folded into
q inside, as ``halo_flash_attention`` does in the JAX package. The LSE is
base-2, flat (B, T*H) in t-major order, as ``flash_fwd`` writes it.

What bounds the kernels on an H100: compute, as at the single-device windowed
sites (each q row meets up to W + 1 keys for a few hundred bytes of traffic);
see ``csrc/flash_fwd.cu`` and ``csrc/flash_bwd_windowed.cu``. Those take bf16
operands, the forward at D = 64, 128, 192 and 256 (K1's HALO instances), the
backward pair at D = 64; every other form that a kernel takes runs the forms
family's kernels in the same frame (``ops/flash_forms.py``,
``csrc/flash_forms.cu``), chosen by each wrapper from the operands' (dtype,
D).
"""

from __future__ import annotations

import torch

from osufusion_tpu_torch.ops import flash_attention as fa
from osufusion_tpu_torch.ops import flash_forms as forms
from osufusion_tpu_torch.ops.flash_attention import (
    LN2,
    LOG2E,
    _check_launch,
    _check_operands,
    _check_prep,
    _kernel,
)


def slab_bounds(T: int, window: int, g0: int, t_global: int) -> tuple[int, int]:
    """The slab rows [lo, hi) that lie inside the song."""
    w2 = window // 2
    return max(0, w2 - g0), min(T + window, t_global - g0 + w2)


def _halo_chunks(T: int, window: int, g0: int, t_global: int, device):
    """Per chunk of ``fa.REFERENCE_CHUNK`` query rows: (rows, keys, outside),
    as ``flash_attention.forward_chunks`` takes them. ``keys`` is the slice of
    in-song slab rows that the chunk's window reaches, ``outside`` (rows, 1,
    keys) marks the pairs of that tile beyond a row's window."""
    w2 = window // 2
    lo, hi = slab_bounds(T, window, g0, t_global)
    for t0 in range(0, T, fa.REFERENCE_CHUNK):
        t1 = min(T, t0 + fa.REFERENCE_CHUNK)
        s0, s1 = max(lo, t0), min(hi, t1 + window)
        t, s = torch.arange(t0, t1, device=device), torch.arange(s0, s1, device=device)
        yield slice(t0, t1), slice(s0, s1), ((t[:, None] + w2 - s[None, :]).abs() > w2)[:, None, :]


def _scaled(q: torch.Tensor) -> torch.Tensor:
    return q.float() * (q.shape[-1] ** -0.5 * LOG2E)


def halo_fwd_reference(
    q: torch.Tensor,  # (B, T, H, D) rotated
    k: torch.Tensor,  # (B, T + window, D) rotated slab
    v: torch.Tensor,  # (B, T + window, D)
    window: int,
    g0: int,
    t_global: int,
):
    """Plain version of ``halo_fwd`` in fp32: (o (B, T, H, D), lse2 (B, T*H))."""
    return fa.forward_chunks(_scaled(q), k, v, _halo_chunks(q.shape[1], window, g0, t_global, q.device))


def _halo_backward(q, k, v, o, lse, do, window, g0, t_global):
    chunks = _halo_chunks(q.shape[1], window, g0, t_global, q.device)
    return fa.backward_chunks(_scaled(q), k, v, o, lse, do, chunks)


def halo_bwd_dq_reference(q, k, v, o, lse, do, window: int, g0: int, t_global: int) -> torch.Tensor:
    """Plain version of ``halo_bwd_dq`` in fp32: dq (B, T, H, D), in q's
    rotated frame."""
    dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    for rows, _, _, k_c, _, _, ds in _halo_backward(q, k, v, o, lse, do, window, g0, t_global):
        dq[:, rows] = torch.einsum("bths,bsd->bthd", ds, k_c) * q.shape[-1] ** -0.5
    return dq


def halo_bwd_dkv_reference(q, k, v, o, lse, do, window: int, g0: int, t_global: int):
    """Plain version of ``halo_bwd_dkv`` in fp32: (dk, dv), each (B, T +
    window, D) over the whole slab, zero at the rows outside the song."""
    dk = torch.zeros(k.shape, dtype=torch.float32, device=q.device)
    dv = torch.zeros_like(dk)
    for _, keys, qs_c, _, do_c, p, ds in _halo_backward(q, k, v, o, lse, do, window, g0, t_global):
        dv[:, keys] += torch.einsum("bths,bthd->bsd", p, do_c)
        dk[:, keys] += torch.einsum("bths,bthd->bsd", ds, qs_c)
    return dk * LN2, dv


def _check_halo(who: str, k, v, rows, stats, window: int, g0: int, t_global: int) -> tuple[int, int, int, bool]:
    """The kernels' operands: every tensor of ``rows`` (B, T, H, D), the
    first setting the shape and the dtype, k and v (B, T + window, D) in that
    dtype, every tensor of ``stats`` (B, T*H) fp32, all contiguous on the
    first row tensor's CUDA device; an even window, and a shard inside the
    song. ``rows`` and ``stats`` hold (name, tensor) pairs. Returns (B, T, H,
    whether the forms family takes the form)."""
    first = rows[0][1]
    if first.ndim != 4 or k.ndim != 3:
        raise ValueError(f"{who} wants {rows[0][0]} (B,T,H,D), k/v (B,T+window,D); got {tuple(first.shape)}, "
                         f"{tuple(k.shape)}")
    B, T, H, D = first.shape
    shapes = [(k, (B, T + window, D)), (v, (B, T + window, D)), *((t, first.shape) for _, t in rows),
              *((t, (B, T * H)) for _, t in stats)]
    if any(t.shape != shape for t, shape in shapes):
        raise ValueError(f"{who} shapes: k {tuple(k.shape)} v {tuple(v.shape)} "
                         + " ".join(f"{n} {tuple(t.shape)}" for n, t in (*rows, *stats)) + f" at window {window}")
    if window < 2 or window % 2 or not 0 <= g0 <= t_global - T:
        raise ValueError(f"{who}: window must be even and >= 2 and the shard [g0, g0 + T) inside the song; "
                         f"got window {window}, g0 {g0}, T {T}, t_global {t_global}")
    use_forms = forms.takes_forms(who, first)
    dt, f32 = first.dtype, torch.float32
    _check_operands(who, first.device, (*((n, t, dt) for n, t in rows), ("k", k, dt), ("v", v, dt),
                                        *((n, t, f32) for n, t in stats)))
    return B, T, H, use_forms


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def halo_fwd(q, k, v, window: int, g0: int, t_global: int, scale: float):
    """Launch the halo forward kernel of q's form on the current stream;
    returns (o (B, T, H, D) in q's dtype, lse2 (B, T*H) fp32). Counts the
    wgmma instance's launches in ``halo_fwd.launches``, the forms one's in
    ``flash_forms.forms_fwd.launches``."""
    B, T, H, use_forms = _check_halo("halo_fwd", k, v, (("q", q),), (), window, g0, t_global)
    o = torch.empty_like(q)
    lse = torch.empty((B, T * H), dtype=torch.float32, device=q.device)
    if use_forms:
        forms.forms_fwd(q, k, v, None, None, o, lse, window, scale, halo=(g0, t_global))
        return o, lse
    err = _kernel("halo_fwd_bf16")(q.shape[-1], q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                                   lse.data_ptr(), B, T, H, window, g0, t_global, scale, _stream(q))
    _check_launch("halo_fwd", err)
    halo_fwd.launches += 1
    return o, lse


halo_fwd.launches = 0


def halo_bwd_dq(q, k, v, o, lse, do, window: int, g0: int, t_global: int, scale: float):
    """Launch the pre-pass and the halo dq kernel of q's form on the current
    stream. Returns (dq, prep): dq (B, T, H, D) in q's dtype and rotated
    frame, written once per row (the same bits from run to run), and the
    pre-pass's scratch (``WindowedPrep``: qs = q * scale * log2(e) in bf16,
    the padded LSE, delta = rowsum(do * o); the forms family's pre-pass, dq
    kernel and post-pass leave a ``GlobalPrep``), which ``halo_bwd_dkv``
    takes. Counts the wgmma dq kernel's launches in ``halo_bwd_dq.launches``,
    the forms kernels' in ``flash_forms``."""
    B, T, H, use_forms = _check_halo("halo_bwd_dq", k, v, (("q", q), ("o", o), ("do", do)), (("lse", lse),),
                                     window, g0, t_global)
    if use_forms:
        prep = forms.forms_bwd_prep(q, o, lse, do, None, None, 1, scale)
        forms.forms_bwd_dq(k, v, prep, window, (g0, t_global), accumulate=False)
        return forms.forms_bwd_post(prep, None, None, scale), prep
    prep = fa.windowed_prep(q, o, lse, do, None, None, scale)
    dq = torch.empty_like(q)
    err = _kernel("halo_bwd_dq_bf16")(
        k.data_ptr(), v.data_ptr(), do.data_ptr(), prep.qs.data_ptr(), prep.lse.data_ptr(), prep.delta.data_ptr(),
        dq.data_ptr(), B, T, H, prep.lse.shape[1], window, g0, t_global, scale, _stream(q))
    _check_launch("halo_bwd_dq", err)
    halo_bwd_dq.launches += 1
    return dq, prep


halo_bwd_dq.launches = 0


def halo_bwd_dkv(k, v, do, prep, window: int, g0: int, t_global: int):
    """Launch the halo dk/dv kernel of do's form on the current stream, on
    ``halo_bwd_dq``'s scratch (a ``WindowedPrep``, or the forms family's
    ``GlobalPrep``; no scale: qs carries it). Returns (dk, dv), both (B, T +
    window, D) fp32 over the whole slab, halo rows included (zero outside the
    song), each row written once. Counts the wgmma kernel's launches in
    ``halo_bwd_dkv.launches``, the forms one's in ``flash_forms``."""
    B, T, H, use_forms = _check_halo("halo_bwd_dkv", k, v, (("do", do),), (), window, g0, t_global)
    dk = torch.empty(k.shape, dtype=torch.float32, device=do.device)
    dv = torch.empty_like(dk)
    if use_forms:
        forms.check_prep("halo_bwd_dkv", prep, B, T, H, 1)
        forms.forms_bwd_dkv(k, v, prep, dk, dv, window, (g0, t_global), accumulate=False)
        return dk, dv
    _check_prep("halo_bwd_dkv", prep, do.device, B, T * H)
    err = _kernel("halo_bwd_dkv_bf16")(
        k.data_ptr(), v.data_ptr(), do.data_ptr(), prep.qs.data_ptr(), prep.lse.data_ptr(), prep.delta.data_ptr(),
        dk.data_ptr(), dv.data_ptr(), B, T, H, prep.lse.shape[1], window, g0, t_global, _stream(do))
    _check_launch("halo_bwd_dkv", err)
    halo_bwd_dkv.launches += 1
    return dk, dv


halo_bwd_dkv.launches = 0


@torch.library.custom_op("osufusion_tpu_torch::halo_attention", mutates_args=())
def halo_attention_op(
    q: torch.Tensor,  # (B, T, H, D) rotated
    k: torch.Tensor,  # (B, T + window, D) rotated slab
    v: torch.Tensor,  # (B, T + window, D)
    window: int,
    g0: int,
    t_global: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Halo attention, differentiable in q, k and v. Returns (o, lse2), the
    backward's residuals beside q, k and v, so a rematerialisation policy that
    keeps this op's outputs never runs the forward again; lse2 is not
    differentiable. CUDA tensors (contiguous, of a form that a kernel takes,
    or the wrappers raise) go forward through ``halo_fwd`` and backward
    through ``halo_bwd_dq`` and ``halo_bwd_dkv``, each of which launches the
    wgmma instance or the forms one; CPU tensors through their plain
    versions."""
    if q.is_cuda:
        o, lse = halo_fwd(q, k, v, window, g0, t_global, q.shape[-1] ** -0.5)
    else:
        o, lse = halo_fwd_reference(q, k, v, window, g0, t_global)
    return o.to(q.dtype), lse


@halo_attention_op.register_fake
def _(q, k, v, window, g0, t_global):
    B, T, H, _ = q.shape
    return torch.empty_like(q), q.new_empty((B, T * H), dtype=torch.float32)


def _save_residuals(ctx, inputs, output) -> None:
    q, k, v, window, g0, t_global = inputs
    o, lse = output
    ctx.save_for_backward(q, k, v, o, lse)
    ctx.frame = (window, g0, t_global)
    ctx.mark_non_differentiable(lse)
    ctx.set_materialize_grads(False)


def _halo_backward_rule(ctx, do, _dlse):
    q, k, v, o, lse = ctx.saved_tensors
    if q.is_cuda:
        scale = q.shape[-1] ** -0.5
        do = do.contiguous()
        dq, prep = halo_bwd_dq(q, k, v, o, lse, do, *ctx.frame, scale)
        dk, dv = halo_bwd_dkv(k, v, do, prep, *ctx.frame)
    else:
        dq = halo_bwd_dq_reference(q, k, v, o, lse, do, *ctx.frame)
        dk, dv = halo_bwd_dkv_reference(q, k, v, o, lse, do, *ctx.frame)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), None, None, None


halo_attention_op.register_autograd(_halo_backward_rule, setup_context=_save_residuals)


def halo_flash_attention(q, k, v, window: int, g0: int, t_global: int) -> torch.Tensor:
    """Windowed attention of a rank's rotated q (B, T, H, D) against its
    halo-extended rotated k and v (B, T + window, D); returns o (B, T, H, D)
    in q's dtype. On CUDA tensors the kernels run (of q's form, or they
    raise), on CPU tensors their plain versions."""
    return halo_attention_op(q.contiguous(), k.contiguous(), v.contiguous(), window, g0, t_global)[0]
