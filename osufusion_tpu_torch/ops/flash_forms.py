"""The form rule of the attention sites on the card, and the wrappers of the
"forms" kernels (``csrc/flash_forms.cu``).

The JAX package runs the Pallas kernels at any operand dtype and a head dim
that is a multiple of 64 (``osufusion_tpu/ops/pallas_attention.py::
flash_attention_available``), and sends every other head dim to the XLA
einsum (``osufusion_tpu/ops/attention.py``). On the card the form is decided
per kernel, by ``kernel_form(who, dtype, head_dim)`` for the wrapper ``who``:

* ``"hopper"``: the wgmma kernels. bf16 operands with D = 64 at every wrapper;
  with D = 128, 192 or 256 at the wrappers of ``WIDE_WGMMA``, whose kernels
  are templated on D: the forward K1 (``csrc/flash_fwd.cuh``: ``flash_fwd``,
  ``halo_fwd`` and the ring's hops), the global backward's sweep K2
  (``csrc/flash_bwd_sweep.cuh``: ``flash_bwd`` and the ring's
  ``flash_bwd_sweep``) and the windowed pair with its pre-pass, K3a / K3b and
  their halo instances K5a / K5b (``csrc/flash_bwd_windowed.cuh``:
  ``flash_bwd_dq`` / ``flash_bwd_dkv``, ``halo_bwd_dq`` / ``halo_bwd_dkv``).
  fp16 operands with D = 64, 128, 192 or 256 at the same wrappers, whose
  kernels are templated on the operand type too. Above 256, bf16 and fp16 at
  the same wrappers run ``csrc/flash_xwide.cuh``, which takes the head dim at
  run time: its forward at every head dim (``FORWARD_WRAPPERS``), and with D
  in ``XWIDE_HEAD_DIMS`` (320 ... 512) its backward pair between the forms
  pre-pass and post-pass (global, the ring's sweeps, windowed and halo). fp32
  operands at the wrappers of ``WIDE_WGMMA`` run ``csrc/flash_f32x6.cuh``,
  each fp32 product as six bf16 products: its forward at every head dim, its
  dq and dk/dv pair (``BACKWARD_WRAPPERS``) with D up to 512, between the
  forms pre-pass and post-pass;
* ``"forms"``: this module's kernels, which compute in fp32 on the FMA units:
  fp32 at every D for the ring's merge and the global backward's pre-pass
  and post-pass (``flash_bwd_prep`` / ``flash_bwd_post``); fp16 at the merge,
  the pre-pass and the post-pass at every D (``flash_bwd`` at fp16 runs K2's sweep, or
  above 256 the wgmma pair, between these two); and bf16 at D > 64 at the
  merge, the pre-pass and the post-pass (``flash_bwd`` at D > 64 likewise);
* ``"chunked"``: the forms family's chunked instance of dq and dk/dv (staged
  64 columns of the head dim at a time), at the wrappers of
  ``BACKWARD_WRAPPERS`` for every type above ``XWIDE_HEAD_DIMS`` (D > 512);
* a head dim that is not a multiple of 64 raises ValueError: no kernel tiles
  it, and ``attention_form`` gives such a site ``"xla"``, the JAX package's
  XLA route (rope, then the plain grouped attention with native autograd;
  ``ops/attention.py``).

Every wrapper of ``ops/flash_attention.py`` and ``ops/halo_attention.py``
chooses its instance by one value, ``route``: its own wgmma entry point
("wgmma"), csrc/flash_xwide.cuh's ("xwide"), csrc/flash_f32x6.cuh's
("f32x6"), or the forms entry point of the same function here ("forms").
The forms family runs every
backward as K2's split does: a pre-pass (``forms_bwd_prep``: qs in the
operands' dtype, do in group-major order, the padded LSE and delta), the dq
and dk/dv kernels over the keys at hand (``forms_bwd_dq``, ``forms_bwd_dkv``,
each storing or, across the ring's hops, adding into fp32 buffers), and a
post-pass that scales and un-rotates dq (``forms_bwd_post``). Each entry
point counts its launches in ``<wrapper>.launches``.
"""

from __future__ import annotations

from typing import Optional

import torch

from osufusion_tpu_torch.ops import flash_attention as fa

# the head dims of K1, K2's sweep and the windowed pair (csrc/flash_fwd.cuh, csrc/flash_bwd_sweep.cuh,
# csrc/flash_bwd_windowed.cuh) and of the forms family's D-templated instances (csrc/flash_forms.cu's
# FORMS_DIMS); above them bf16 and fp16 run csrc/flash_xwide.cuh
WGMMA_HEAD_DIMS = (64, 128, 192, 256)
# the head dims of the backward pairs above 256 (csrc/flash_xwide.cuh, XW_MIN_D ... XW_MAX_D, at bf16 and fp16;
# csrc/flash_f32x6.cuh's above 256 at fp32); above them the chunked dq and dk/dv
XWIDE_HEAD_DIMS = (320, 384, 448, 512)
# the wrappers whose wgmma kernels take every head dim of WGMMA_HEAD_DIMS and XWIDE_HEAD_DIMS, at bf16 and at
# fp16 (each operand type's instances a library of their own: csrc/flash_fwd_f16.cu, csrc/flash_bwd_f16.cu,
# csrc/flash_bwd_windowed_f16.cu, csrc/flash_xwide_f16.cu), and at fp32 (csrc/flash_f32x6.cuh); every other
# wrapper's takes bf16 at 64
WIDE_WGMMA = frozenset({"flash_fwd", "halo_fwd", "flash_bwd", "flash_bwd_sweep", "flash_bwd_dq", "flash_bwd_dkv",
                        "halo_bwd_dq", "halo_bwd_dkv"})
# the forward wrappers of WIDE_WGMMA: their kernels take every head dim that is a multiple of 64, at every type
FORWARD_WRAPPERS = frozenset({"flash_fwd", "halo_fwd"})
# the backward wrappers of WIDE_WGMMA: the chunked dq and dk/dv above XWIDE_HEAD_DIMS
BACKWARD_WRAPPERS = WIDE_WGMMA - FORWARD_WRAPPERS
# operand dtype -> the entry points' type code
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


def kernel_form(who: str, dtype: torch.dtype, head_dim: int) -> str:
    """What the wrapper ``who`` launches on the card for ``dtype`` operands
    with head dim ``head_dim``: "hopper", "forms" or "chunked" (see the
    module's docstring). A head dim that is not a multiple of 64 raises
    ValueError, a dtype other than fp32, bf16 and fp16 NotImplementedError."""
    if head_dim <= 0 or head_dim % 64:
        raise ValueError(f"{who}: no kernel takes head dim {head_dim}; they take multiples of 64")
    if dtype not in _DTYPE_CODE:
        raise NotImplementedError(f"{who}: the attention kernels take float32, bfloat16 and float16 operands, "
                                  f"not {dtype}")
    if who not in WIDE_WGMMA:  # the merge, the pre-pass and the post-pass: D-generic forms bodies
        return "hopper" if dtype == torch.bfloat16 and head_dim == 64 else "forms"
    return "hopper" if who in FORWARD_WRAPPERS or head_dim <= XWIDE_HEAD_DIMS[-1] else "chunked"


def attention_form(dtype: torch.dtype, head_dim: int) -> str:
    """What serves the forward of an attention site of ``dtype`` operands
    with head dim ``head_dim`` on the card: "xla" for a head dim that is not
    a multiple of 64, else ``kernel_form("flash_fwd", ...)``."""
    if head_dim % 64:
        return "xla"
    return kernel_form("flash_fwd", dtype, head_dim)


def route(who: str, t: torch.Tensor) -> str:
    """The entry point by which the wrapper ``who`` serves ``t``'s (dtype,
    head dim) on the card, the one value each wrapper branches on: "wgmma"
    for its own wgmma kernel, "xwide" for csrc/flash_xwide.cuh's (the form
    "hopper" above D = 256 at bf16 and fp16; its backward runs on this
    module's pre-pass and post-pass), "f32x6" for csrc/flash_f32x6.cuh's
    forward and pair (the form "hopper" at fp32; the pair on the same
    pre-pass and post-pass), "forms" for this module's family (the chunked
    dq and dk/dv included). A head dim that no kernel tiles raises
    ValueError."""
    D = t.shape[-1]
    if kernel_form(who, t.dtype, D) != "hopper":
        return "forms"
    if t.dtype == torch.float32:
        return "f32x6"
    return "wgmma" if D <= WGMMA_HEAD_DIMS[-1] else "xwide"


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _check_aligned(who: str, *tensors: Optional[torch.Tensor]) -> None:
    """The kernels read and write 16 bytes at a time."""
    for t in tensors:
        if t is not None and t.data_ptr() % 16:
            raise ValueError(f"{who}: every operand must start on a 16-byte boundary")


def _frame(halo: Optional[tuple]) -> tuple:
    """(halo, g0, t_global) as the entry points take them: the single-device
    frame for None, else the halo slab of the shard (g0, t_global)."""
    return (0, 0, 0) if halo is None else (1, *halo)


def _kv(k: torch.Tensor) -> int:
    return 1 if k.ndim == 3 else k.shape[2]


def forms_bwd_prep(q, o, lse, do, cos, sin, kv: int, scale: float):
    """Launch the forms pre-pass on the current stream; returns its scratch as
    a ``flash_attention.GlobalPrep`` in group-major order (B * Kv, T * G,
    ...): qs (q's dtype: rope(q) * scale * log2(e), or without tables q
    scaled), do (do itself at Kv == 1), the LSE and delta padded to
    ``BWD_ROW_TILE`` rows, and an fp32 dq buffer, zeroed: K2's sweep adds
    into it, the forms dq kernel stores on its first sweep. Operands checked by the calling wrapper. Counts in
    ``forms_bwd_prep.launches``."""
    B, T, H, D = q.shape
    rows = T * (H // kv)
    pad = -(-rows // fa.BWD_ROW_TILE) * fa.BWD_ROW_TILE
    f32, dev = torch.float32, q.device
    qs_g = torch.empty((B * kv, rows, D), dtype=q.dtype, device=dev)
    lse_g = torch.empty((B * kv, pad), dtype=f32, device=dev)
    prep = fa.GlobalPrep(qs_g, torch.empty_like(qs_g) if kv > 1 else do, lse_g, torch.empty_like(lse_g),
                         torch.zeros((B * kv, pad, D), dtype=f32, device=dev), (B, T, H, kv))
    _check_aligned("forms_bwd_prep", q, o, do)
    err = fa._kernel("forms_bwd_prep")(
        _DTYPE_CODE[q.dtype], D, q.data_ptr(), do.data_ptr(), o.data_ptr(), lse.data_ptr(), fa._ptr(cos),
        fa._ptr(sin), qs_g.data_ptr(), prep.do.data_ptr() if kv > 1 else None, lse_g.data_ptr(),
        prep.delta.data_ptr(), B, T, H, kv, pad, scale, _stream(q))
    fa._check_launch("forms_bwd_prep", err)
    forms_bwd_prep.launches += 1
    return prep


forms_bwd_prep.launches = 0


def check_prep(who: str, prep, B: int, T: int, H: int, kv: int) -> None:
    """``prep`` as the forms sweeps take it: the forms pre-pass's
    ``GlobalPrep`` of a site of (B, T, H, Kv)."""
    if not isinstance(prep, fa.GlobalPrep) or prep.shape != (B, T, H, kv):
        raise ValueError(f"{who}: want the forms pre-pass's scratch of a (B, T, H, Kv) = {(B, T, H, kv)} site; got "
                         f"{type(prep).__name__} {getattr(prep, 'shape', None)}")


def _check_sweep(who: str, k, v, prep, outs=()) -> None:
    """k and v of the keys at hand as the sweeps over ``prep`` take them:
    (B, S, D) at Kv == 1, else (B, S, Kv, D), in qs's dtype; ``outs`` (k's
    shape) fp32; all contiguous on qs's device."""
    B, T, H, kv = prep.shape
    D = prep.qs.shape[-1]
    want = (B, k.shape[1], D) if kv == 1 else (B, k.shape[1], kv, D)
    if k.shape != want or v.shape != want or any(t.shape != want for t in outs):
        raise ValueError(f"{who} shapes: k {tuple(k.shape)} v {tuple(v.shape)} "
                         + " ".join(str(tuple(t.shape)) for t in outs) + f"; want {want} for {H} query heads")
    dt = prep.qs.dtype
    fa._check_operands(who, prep.qs.device, (("k", k, dt), ("v", v, dt),
                                             *((f"out{i}", t, torch.float32) for i, t in enumerate(outs))))
    _check_aligned(who, k, v, *outs)


def forms_bwd_dq(k, v, prep, window: int, halo: Optional[tuple], accumulate: bool) -> None:
    """Launch the forms dq kernel on the current stream over the keys of k and
    v: ``prep.dq_acc`` (fp32, group-major) gets ds k, stored, or with
    ``accumulate`` added to what it holds. Counts in
    ``forms_bwd_dq.launches``. bf16 and fp16 at D <= 512 have no forms dq
    (K2's sweep and the wgmma windowed pair run there, and above 256 the
    wgmma pair of csrc/flash_xwide.cuh), nor has fp32 at D <= 512 (the pair
    of csrc/flash_f32x6.cuh): RuntimeError."""
    _check_sweep("forms_bwd_dq", k, v, prep)
    B, T, H, kv = prep.shape
    err = fa._kernel("forms_bwd_dq")(
        _DTYPE_CODE[prep.qs.dtype], prep.qs.shape[-1], k.data_ptr(), v.data_ptr(), prep.qs.data_ptr(),
        prep.do.data_ptr(), prep.lse.data_ptr(), prep.delta.data_ptr(), prep.dq_acc.data_ptr(), B, T, k.shape[1], H,
        kv, prep.lse.shape[1], window, *_frame(halo), int(accumulate), _stream(k))
    fa._check_launch("forms_bwd_dq", err)
    forms_bwd_dq.launches += 1


forms_bwd_dq.launches = 0


def forms_bwd_dkv(k, v, prep, dk, dv, window: int, halo: Optional[tuple], accumulate: bool) -> None:
    """Launch the forms dk/dv kernel on the current stream over the keys of k
    and v: dk (rotated frame) and dv (k's shape, fp32) stored, or with
    ``accumulate`` added to; in the halo frame the slab rows outside the song
    get zeros. Counts in ``forms_bwd_dkv.launches``. No type has a forms dk/dv at
    D <= 512: RuntimeError."""
    _check_sweep("forms_bwd_dkv", k, v, prep, (dk, dv))
    B, T, H, kv = prep.shape
    err = fa._kernel("forms_bwd_dkv")(
        _DTYPE_CODE[prep.qs.dtype], prep.qs.shape[-1], k.data_ptr(), v.data_ptr(), prep.qs.data_ptr(),
        prep.do.data_ptr(), prep.lse.data_ptr(), prep.delta.data_ptr(), dk.data_ptr(), dv.data_ptr(), B, T,
        k.shape[1], H, kv, prep.lse.shape[1], window, *_frame(halo), int(accumulate), _stream(k))
    fa._check_launch("forms_bwd_dkv", err)
    forms_bwd_dkv.launches += 1


forms_bwd_dkv.launches = 0


def forms_bwd_post(prep, cos, sin, scale: float) -> torch.Tensor:
    """Launch the forms post-pass on the current stream: dq (B, T, H, D) in
    qs's dtype = scale * the un-rotated dq buffer (without tables only
    scaled). Counts in ``forms_bwd_post.launches``."""
    B, T, H, kv = prep.shape
    D = prep.qs.shape[-1]
    fa._check_operands("forms_bwd_post", prep.qs.device, fa._tables("forms_bwd_post", cos, sin, T, D))
    dq = torch.empty((B, T, H, D), dtype=prep.qs.dtype, device=prep.qs.device)
    err = fa._kernel("forms_bwd_post")(_DTYPE_CODE[dq.dtype], D, prep.dq_acc.data_ptr(), fa._ptr(cos), fa._ptr(sin),
                                       dq.data_ptr(), B, T, H, kv, prep.lse.shape[1], scale, _stream(dq))
    fa._check_launch("forms_bwd_post", err)
    forms_bwd_post.launches += 1
    return dq


forms_bwd_post.launches = 0


def forms_ring_merge(o_acc, lse_acc, o_j, lse_j, lse, o) -> None:
    """Launch the forms merge on the current stream, on ``ring_merge``'s
    checked and allocated operands (o_j and o in the operands' dtype). Counts
    in ``forms_ring_merge.launches``."""
    B, T, H, D = o_j.shape
    _check_aligned("forms_ring_merge", o_acc, o_j, o)
    err = fa._kernel("forms_ring_merge")(_DTYPE_CODE[o_j.dtype], D, o_acc.data_ptr(), fa._ptr(lse_acc),
                                         o_j.data_ptr(), lse_j.data_ptr(), lse.data_ptr(), fa._ptr(o), B * T * H,
                                         _stream(o_j))
    fa._check_launch("forms_ring_merge", err)
    forms_ring_merge.launches += 1


forms_ring_merge.launches = 0

