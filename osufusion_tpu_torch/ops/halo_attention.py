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
see ``csrc/flash_fwd.cu`` and ``csrc/flash_bwd_windowed.cu``.
"""

from __future__ import annotations

import torch

from osufusion_tpu_torch.ops import flash_attention as fa
from osufusion_tpu_torch.ops.flash_attention import (
    HEAD_DIM,
    LN2,
    LOG2E,
    WindowedPrep,
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


def _check_halo(who: str, k, v, rows, stats, window: int, g0: int, t_global: int) -> tuple[int, int, int]:
    """The kernels' operands: every tensor of ``rows`` (B, T, H, D) bf16, the
    first setting the shape, k and v (B, T + window, D) bf16, every tensor of
    ``stats`` (B, T*H) fp32, all contiguous on the first row tensor's CUDA
    device; an even window, and a shard inside the song. ``rows`` and
    ``stats`` hold (name, tensor) pairs. Returns (B, T, H)."""
    first = rows[0][1]
    if first.ndim != 4 or k.ndim != 3:
        raise ValueError(f"{who} wants {rows[0][0]} (B,T,H,D), k/v (B,T+window,D); got {tuple(first.shape)}, "
                         f"{tuple(k.shape)}")
    B, T, H, D = first.shape
    shapes = [(k, (B, T + window, D)), (v, (B, T + window, D)), *((t, first.shape) for _, t in rows),
              *((t, (B, T * H)) for _, t in stats)]
    if D != HEAD_DIM or any(t.shape != shape for t, shape in shapes):
        raise ValueError(f"{who} shapes: k {tuple(k.shape)} v {tuple(v.shape)} "
                         + " ".join(f"{n} {tuple(t.shape)}" for n, t in (*rows, *stats))
                         + f" at window {window}; head dim must be {HEAD_DIM}")
    if window < 2 or window % 2 or not 0 <= g0 <= t_global - T:
        raise ValueError(f"{who}: window must be even and >= 2 and the shard [g0, g0 + T) inside the song; "
                         f"got window {window}, g0 {g0}, T {T}, t_global {t_global}")
    bf16, f32 = torch.bfloat16, torch.float32
    _check_operands(who, first.device, (*((n, t, bf16) for n, t in rows), ("k", k, bf16), ("v", v, bf16),
                                        *((n, t, f32) for n, t in stats)))
    return B, T, H


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def halo_fwd(q, k, v, window: int, g0: int, t_global: int, scale: float):
    """Launch the halo forward kernel on the current stream; returns (o (B, T,
    H, D) bf16, lse2 (B, T*H) fp32). Counts its launches in
    ``halo_fwd.launches``."""
    B, T, H = _check_halo("halo_fwd", k, v, (("q", q),), (), window, g0, t_global)
    o = torch.empty_like(q)
    lse = torch.empty((B, T * H), dtype=torch.float32, device=q.device)
    err = _kernel("halo_fwd_bf16")(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(),
                                   B, T, H, window, g0, t_global, scale, _stream(q))
    _check_launch("halo_fwd", err)
    halo_fwd.launches += 1
    return o, lse


halo_fwd.launches = 0


def halo_bwd_dq(q, k, v, o, lse, do, window: int, g0: int, t_global: int, scale: float):
    """Launch the pre-pass and the halo dq kernel on the current stream.
    Returns (dq, prep): dq (B, T, H, D) bf16 in q's rotated frame, written
    once per row (the same bits from run to run), and the pre-pass's scratch
    (``WindowedPrep``: qs = q * scale * log2(e) in bf16, the padded LSE,
    delta = rowsum(do * o)), which ``halo_bwd_dkv`` takes. Counts its
    launches in ``halo_bwd_dq.launches``."""
    B, T, H = _check_halo("halo_bwd_dq", k, v, (("q", q), ("o", o), ("do", do)), (("lse", lse),),
                          window, g0, t_global)
    prep = fa.windowed_prep(q, o, lse, do, None, None, scale)
    dq = torch.empty_like(q)
    err = _kernel("halo_bwd_dq_bf16")(
        k.data_ptr(), v.data_ptr(), do.data_ptr(), prep.qs.data_ptr(), prep.lse.data_ptr(), prep.delta.data_ptr(),
        dq.data_ptr(), B, T, H, prep.lse.shape[1], window, g0, t_global, scale, _stream(q))
    _check_launch("halo_bwd_dq", err)
    halo_bwd_dq.launches += 1
    return dq, prep


halo_bwd_dq.launches = 0


def halo_bwd_dkv(k, v, do, prep: WindowedPrep, window: int, g0: int, t_global: int):
    """Launch the halo dk/dv kernel on the current stream, on ``halo_bwd_dq``'s
    scratch (no scale: qs carries it). Returns (dk, dv), both (B, T + window,
    D) fp32 over the whole slab, halo rows included (zero outside the song),
    each row written once. Counts its launches in ``halo_bwd_dkv.launches``."""
    B, T, H = _check_halo("halo_bwd_dkv", k, v, (("do", do),), (), window, g0, t_global)
    _check_prep("halo_bwd_dkv", prep, do.device, B, T * H)
    dk = torch.empty(k.shape, dtype=torch.float32, device=do.device)
    dv = torch.empty_like(dk)
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
    differentiable. CUDA tensors (bf16, contiguous, or the wrappers raise) go
    forward through ``halo_fwd`` and backward through ``halo_bwd_dq`` and
    ``halo_bwd_dkv``; CPU tensors through their plain versions."""
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
    in q's dtype. On CUDA tensors the kernels run (bf16, or they raise), on
    CPU tensors their plain versions."""
    return halo_attention_op(q.contiguous(), k.contiguous(), v.contiguous(), window, g0, t_global)[0]
