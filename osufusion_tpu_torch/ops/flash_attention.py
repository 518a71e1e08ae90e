"""MQA flash attention with fused q-RoPE: the wrappers of the CUDA kernels in
``csrc/``, the differentiable op that joins them, and their plain PyTorch
versions.

``flash_fwd`` replaces ``osufusion_tpu/ops/pallas_attention.py::_fwd_kernel``
(launched by ``_flash_fwd``): all H query heads fold into rows against one
(B, S, D) KV, q is rotated once per block with the softmax scale folded in,
and a +/- window/2 sliding window visits only the KV tiles it reaches. In its
training form (``return_lse=True``) it also returns the base-2 log-sum-exp of
its logits, flat (B, T*H) in t-major order. The backward recomputes the
probabilities from that LSE. At a global site ``flash_bwd`` replaces
``_bwd_fused_kernel`` (launched by ``_flash_bwd_fused``): the five products in
one sweep, dq accumulated with fp32 atomics, so it differs in its last bits
from run to run. At a windowed site the split pair ``flash_bwd_dq`` and
``flash_bwd_dkv`` replaces ``_dq_kernel`` and ``_dkv_kernel`` (launched by
``_flash_bwd``): no atomics, so all three gradients repeat bit for bit.

What bounds them on an H100: compute. At the serving path's level-0 site (T =
24576, W = 4096, H = 16, D = 64) each q row meets ~4k keys for 256 bytes of
q/o traffic, and each KV tile staged in shared memory serves all heads of
eight timesteps, so the arithmetic intensity is far above the ~295 FLOP/byte
ridge; the training sites (global at T = 4096 ... 512, windowed at T = 65536
... 8192) are the same. The design therefore spends its effort on the math:
every product runs on bf16 tensor cores (``mma.sync`` m16n8k16, fp32
accumulation), the softmax stays in fp32 registers in the exp2 domain, only
edge tiles are masked, and tiles are copied with ``cp.async``.

The wrappers launch the kernels for CUDA tensors and raise on anything the
kernels do not take, a CPU tensor included. ``flash_attention_op`` is the
differentiable function over them (a ``torch.library.custom_op``, so that a
rematerialisation policy can name it and keep its outputs): on CUDA tensors it
launches the kernels, on CPU tensors it runs their plain versions, which
repeat the kernels' arithmetic from the LSE in fp32.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
from pathlib import Path

import torch

from osufusion_tpu_torch.ops.rope import apply_rope, unapply_rope

HEAD_DIM = 64
LOG2E = 1.4426950408889634
LN2 = 0.6931471805599453
_CSRC = Path(__file__).resolve().parent.parent / "csrc"
# library name -> source; each becomes a shared library of its own
SOURCES = {name: _CSRC / f"{name}.cu" for name in ("flash_fwd", "flash_bwd", "flash_bwd_windowed", "flash_halo")}
# built at first use, beside the checkout: <repo>/build/osufusion_tpu_torch/
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "osufusion_tpu_torch"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC"]


def build_kernels(verbose: bool = False) -> dict[str, Path]:
    """Compile every source of ``SOURCES`` with nvcc for sm_90a into a C-ABI
    shared library of its own (named by the hash of the source and of the
    headers beside it, so an edit rebuilds), all compilers started together,
    and return {name: path}. ``verbose`` prints ptxas's register and spill
    report of each build."""
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA toolkit")
    headers = b"".join(h.read_bytes() for h in sorted(_CSRC.glob("*.cuh")))
    outs, running = {}, []
    for name, source in SOURCES.items():
        digest = hashlib.sha256(source.read_bytes() + headers).hexdigest()[:12]
        out = BUILD_DIR / f"lib{name}_{digest}.so"
        outs[name] = out
        if out.exists():
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [str(Path(CUDA_HOME) / "bin" / "nvcc"), *NVCC_FLAGS, "-Xptxas", "-v", "-o", str(tmp), str(source)]
        running.append((name, tmp, out, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    failures = []
    for name, tmp, out, proc in running:
        _, stderr = proc.communicate()
        if proc.returncode != 0:
            failures.append(f"nvcc failed on {name} ({proc.returncode}):\n{stderr}")
            continue
        if verbose:
            print(stderr.strip())
        tmp.replace(out)
    if failures:
        raise RuntimeError("\n".join(failures))
    return outs


_PTR, _INT = ctypes.c_void_p, ctypes.c_int
# C entry point -> (library, argument types)
_ENTRY_POINTS = {
    # q k v cos sin o lse | B T S H window | scale | stream
    "flash_fwd_bf16": ("flash_fwd", [_PTR] * 7 + [_INT] * 5 + [ctypes.c_float, _PTR]),
    # q k v do o lse delta cos sin dq dk dv | B T S H | scale | stream
    "flash_bwd_bf16": ("flash_bwd", [_PTR] * 12 + [_INT] * 4 + [ctypes.c_float, _PTR]),
    # q k v do o lse delta cos sin dq | B T S H window | scale | stream
    "flash_bwd_dq_bf16": ("flash_bwd_windowed", [_PTR] * 10 + [_INT] * 5 + [ctypes.c_float, _PTR]),
    # q k v do lse delta cos sin dk dv | B T S H window | scale | stream
    "flash_bwd_dkv_bf16": ("flash_bwd_windowed", [_PTR] * 10 + [_INT] * 5 + [ctypes.c_float, _PTR]),
    # q k v o lse | B T H window g0 t_global | scale | stream
    "halo_fwd_bf16": ("flash_halo", [_PTR] * 5 + [_INT] * 6 + [ctypes.c_float, _PTR]),
    # q k v do o lse delta dq | B T H window g0 t_global | scale | stream
    "halo_bwd_dq_bf16": ("flash_halo", [_PTR] * 8 + [_INT] * 6 + [ctypes.c_float, _PTR]),
    # q k v do lse delta dk dv | B T H window g0 t_global | scale | stream
    "halo_bwd_dkv_bf16": ("flash_halo", [_PTR] * 8 + [_INT] * 6 + [ctypes.c_float, _PTR]),
}


@functools.cache
def _library(name: str) -> ctypes.CDLL:
    return ctypes.CDLL(str(build_kernels()[name]))


@functools.cache
def _kernel(entry: str):
    """The C entry point ``entry`` of the library built from its source."""
    library, argtypes = _ENTRY_POINTS[entry]
    fn = getattr(_library(library), entry)
    fn.restype = ctypes.c_int
    fn.argtypes = argtypes
    return fn


def _check_operands(who: str, device, operands) -> None:
    for name, t, dtype in operands:
        if not t.is_cuda or t.device != device:
            raise ValueError(f"{who}: {name} must be a CUDA tensor on {device}, got {t.device}")
        if t.dtype != dtype:
            raise ValueError(f"{who}: {name} must be {dtype}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{who}: {name} must be contiguous")


def _check_window(who: str, window: int) -> None:
    if window < -1:
        raise ValueError(f"{who}: window must be -1 (global) or >= 0, got {window}")


def flash_fwd(
    q: torch.Tensor,  # (B, T, H, D) bf16, raw
    k: torch.Tensor,  # (B, T, D) bf16, already rotated
    v: torch.Tensor,  # (B, T, D) bf16
    cos: torch.Tensor,  # (T, D) fp32
    sin: torch.Tensor,  # (T, D) fp32
    window: int,  # -1 = global
    scale: float,
    return_lse: bool = False,
):
    """Launch the forward kernel on the current stream; returns o (B, T, H, D)
    bf16, or with ``return_lse`` (o, lse2): lse2 (B, T*H) fp32 is the base-2
    log-sum-exp of the logits q_rot k_rot^T * scale * log2(e). Counts its
    launches in ``flash_fwd.launches`` (those with the LSE also in
    ``flash_fwd.lse_launches``)."""
    if q.ndim != 4 or k.ndim != 3 or v.shape != k.shape:
        raise ValueError(f"flash_fwd wants q (B,T,H,D), k/v (B,T,D); got {tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    B, T, H, D = q.shape
    if D != HEAD_DIM or k.shape != (B, T, D) or cos.shape != (T, D) or sin.shape != (T, D):
        raise ValueError(f"flash_fwd shapes: q {tuple(q.shape)} k {tuple(k.shape)} cos {tuple(cos.shape)}; head dim must be {HEAD_DIM}")
    _check_operands("flash_fwd", q.device, (("q", q, torch.bfloat16), ("k", k, torch.bfloat16), ("v", v, torch.bfloat16),
                                            ("cos", cos, torch.float32), ("sin", sin, torch.float32)))
    _check_window("flash_fwd", window)
    o = torch.empty_like(q)
    lse = torch.empty((B, T * H), dtype=torch.float32, device=q.device) if return_lse else None
    err = _kernel("flash_fwd_bf16")(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), cos.data_ptr(), sin.data_ptr(), o.data_ptr(),
        lse.data_ptr() if return_lse else None,
        B, T, T, H, window, scale, torch.cuda.current_stream(q.device).cuda_stream,
    )
    if err:
        raise RuntimeError(f"flash_fwd kernel launch failed: CUDA error {err}")
    flash_fwd.launches += 1
    if return_lse:
        flash_fwd.lse_launches += 1
        return o, lse
    return o


flash_fwd.launches = 0
flash_fwd.lse_launches = 0


def _check_backward(who: str, q, k, v, rows, stats, cos, sin) -> tuple[int, int, int]:
    """The backward kernels' operands: q and every tensor of ``rows``
    (B, T, H, D) bf16, k and v (B, T, D) bf16, every tensor of ``stats``
    (B, T*H) fp32, the tables (T, D) fp32; all contiguous on q's CUDA device.
    ``rows`` and ``stats`` hold (name, tensor) pairs. Returns (B, T, H)."""
    if q.ndim != 4 or k.ndim != 3:
        raise ValueError(f"{who} wants q (B,T,H,D), k/v (B,T,D); got {tuple(q.shape)}, {tuple(k.shape)}")
    B, T, H, D = q.shape
    shapes = [(k, (B, T, D)), (v, (B, T, D)), (cos, (T, D)), (sin, (T, D)),
              *((t, q.shape) for _, t in rows), *((t, (B, T * H)) for _, t in stats)]
    if D != HEAD_DIM or any(t.shape != shape for t, shape in shapes):
        raise ValueError(f"{who} shapes: q {tuple(q.shape)} k {tuple(k.shape)} v {tuple(v.shape)} cos {tuple(cos.shape)} "
                         + " ".join(f"{n} {tuple(t.shape)}" for n, t in (*rows, *stats)) + f"; head dim must be {HEAD_DIM}")
    bf16, f32 = torch.bfloat16, torch.float32
    _check_operands(who, q.device, (("q", q, bf16), ("k", k, bf16), ("v", v, bf16), *((n, t, bf16) for n, t in rows),
                                    *((n, t, f32) for n, t in stats), ("cos", cos, f32), ("sin", sin, f32)))
    return B, T, H


def flash_bwd(
    q: torch.Tensor,  # (B, T, H, D) bf16, raw
    k: torch.Tensor,  # (B, T, D) bf16, already rotated
    v: torch.Tensor,  # (B, T, D) bf16
    o: torch.Tensor,  # (B, T, H, D) bf16, the forward's output
    lse: torch.Tensor,  # (B, T*H) fp32, the forward's base-2 LSE
    do: torch.Tensor,  # (B, T, H, D) bf16
    cos: torch.Tensor,  # (T, D) fp32
    sin: torch.Tensor,  # (T, D) fp32
    scale: float,
):
    """Launch the global backward kernel on the current stream. Returns
    (dq, dk_rot, dv): dq (B, T, H, D) bf16 in the raw q's frame, dk_rot
    (B, T, D) fp32 still in the rotated frame, dv (B, T, D) fp32.
    The library's entry point runs a small kernel for ``delta = rowsum(do *
    o)`` (scratch allocated here) and then the sweep; dq is accumulated by the
    sweep's atomics in a zeroed fp32 buffer and cast once. Counts its launches
    in ``flash_bwd.launches``."""
    B, T, H = _check_backward("flash_bwd", q, k, v, (("o", o), ("do", do)), (("lse", lse),), cos, sin)
    f32 = torch.float32
    delta = torch.empty((B, T * H), dtype=f32, device=q.device)
    dq = torch.zeros(q.shape, dtype=f32, device=q.device)
    dk = torch.empty(k.shape, dtype=f32, device=q.device)
    dv = torch.empty(v.shape, dtype=f32, device=q.device)
    err = _kernel("flash_bwd_bf16")(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), o.data_ptr(), lse.data_ptr(), delta.data_ptr(),
        cos.data_ptr(), sin.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        B, T, T, H, scale, torch.cuda.current_stream(q.device).cuda_stream,
    )
    if err:
        raise RuntimeError(f"flash_bwd kernel launch failed: CUDA error {err}")
    flash_bwd.launches += 1
    return dq.to(torch.bfloat16), dk, dv


flash_bwd.launches = 0


def flash_bwd_dq(
    q: torch.Tensor,  # (B, T, H, D) bf16, raw
    k: torch.Tensor,  # (B, T, D) bf16, already rotated
    v: torch.Tensor,  # (B, T, D) bf16
    o: torch.Tensor,  # (B, T, H, D) bf16, the forward's output
    lse: torch.Tensor,  # (B, T*H) fp32, the forward's base-2 LSE
    do: torch.Tensor,  # (B, T, H, D) bf16
    cos: torch.Tensor,  # (T, D) fp32
    sin: torch.Tensor,  # (T, D) fp32
    window: int,  # -1 = global
    scale: float,
):
    """Launch the windowed dq kernel on the current stream. Returns (dq,
    delta): dq (B, T, H, D) bf16 in the raw q's frame, written once per row
    (the same bits from run to run), and ``delta = rowsum(do * o)`` (B, T*H)
    fp32, which the library's entry point fills with a small kernel first and
    ``flash_bwd_dkv`` takes. Counts its launches in ``flash_bwd_dq.launches``."""
    B, T, H = _check_backward("flash_bwd_dq", q, k, v, (("o", o), ("do", do)), (("lse", lse),), cos, sin)
    _check_window("flash_bwd_dq", window)
    delta = torch.empty((B, T * H), dtype=torch.float32, device=q.device)
    dq = torch.empty_like(q)
    err = _kernel("flash_bwd_dq_bf16")(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), o.data_ptr(), lse.data_ptr(), delta.data_ptr(),
        cos.data_ptr(), sin.data_ptr(), dq.data_ptr(),
        B, T, T, H, window, scale, torch.cuda.current_stream(q.device).cuda_stream,
    )
    if err:
        raise RuntimeError(f"flash_bwd_dq kernel launch failed: CUDA error {err}")
    flash_bwd_dq.launches += 1
    return dq, delta


flash_bwd_dq.launches = 0


def flash_bwd_dkv(
    q: torch.Tensor,  # (B, T, H, D) bf16, raw
    k: torch.Tensor,  # (B, T, D) bf16, already rotated
    v: torch.Tensor,  # (B, T, D) bf16
    lse: torch.Tensor,  # (B, T*H) fp32, the forward's base-2 LSE
    delta: torch.Tensor,  # (B, T*H) fp32, rowsum(do * o) as flash_bwd_dq returns it
    do: torch.Tensor,  # (B, T, H, D) bf16
    cos: torch.Tensor,  # (T, D) fp32
    sin: torch.Tensor,  # (T, D) fp32
    window: int,  # -1 = global
    scale: float,
):
    """Launch the windowed dk/dv kernel on the current stream. Returns
    (dk_rot, dv), both (B, T, D) fp32, dk_rot still in the rotated frame.
    Counts its launches in ``flash_bwd_dkv.launches``."""
    B, T, H = _check_backward("flash_bwd_dkv", q, k, v, (("do", do),), (("lse", lse), ("delta", delta)), cos, sin)
    _check_window("flash_bwd_dkv", window)
    dk = torch.empty(k.shape, dtype=torch.float32, device=q.device)
    dv = torch.empty(v.shape, dtype=torch.float32, device=q.device)
    err = _kernel("flash_bwd_dkv_bf16")(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
        cos.data_ptr(), sin.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        B, T, T, H, window, scale, torch.cuda.current_stream(q.device).cuda_stream,
    )
    if err:
        raise RuntimeError(f"flash_bwd_dkv kernel launch failed: CUDA error {err}")
    flash_bwd_dkv.launches += 1
    return dk, dv


flash_bwd_dkv.launches = 0


def rotated_k(k: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """k (B, S, D) with the rotary embedding applied, as the kernels take it:
    k is 16x smaller than q at MQA, so it is rotated once outside, in fp32."""
    return apply_rope(k.float(), cos, sin).to(k.dtype)


@torch.library.custom_op("osufusion_tpu_torch::flash_attention", mutates_args=())
def flash_attention_op(
    q: torch.Tensor,  # (B, T, H, D) raw
    k: torch.Tensor,  # (B, T, D) raw
    v: torch.Tensor,  # (B, T, D)
    cos: torch.Tensor,  # (T, D) fp32; the tables get no gradient
    sin: torch.Tensor,
    window: int,  # -1 = global
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """MQA attention with rotary embedding, differentiable in q, k and v.
    Returns (o, lse2, k_rot): the backward's residuals beside q and v, so a
    rematerialisation policy that keeps this op's outputs never runs the
    forward again; lse2 and k_rot are not differentiable. CUDA tensors (bf16,
    contiguous, or the wrappers raise) go forward through ``flash_fwd`` with
    its LSE and backward through ``flash_bwd`` (global) or ``flash_bwd_dq`` and
    ``flash_bwd_dkv`` (windowed); CPU tensors through the plain versions of the
    same. Every cast in here is explicit, so it computes the same under
    ``torch.autocast``."""
    k_rot = rotated_k(k, cos, sin)
    if q.is_cuda:
        o, lse = flash_fwd(q, k_rot, v, cos, sin, window, q.shape[-1] ** -0.5, return_lse=True)
    else:
        o, lse = flash_fwd_lse_reference(q, k_rot, v, cos, sin, window)
    return o.to(q.dtype), lse, k_rot


@flash_attention_op.register_fake
def _(q, k, v, cos, sin, window):
    B, T, H, _ = q.shape
    return torch.empty_like(q), q.new_empty((B, T * H), dtype=torch.float32), torch.empty_like(k)


def _save_residuals(ctx, inputs, output) -> None:
    q, _, v, cos, sin, window = inputs
    o, lse, k_rot = output
    ctx.save_for_backward(q, k_rot, v, o, lse, cos, sin)
    ctx.window = window
    ctx.mark_non_differentiable(lse, k_rot)
    ctx.set_materialize_grads(False)


def _attention_backward(ctx, do, _dlse, _dk_rot):
    q, k_rot, v, o, lse, cos, sin = ctx.saved_tensors
    if q.is_cuda:
        scale = q.shape[-1] ** -0.5
        do = do.contiguous()
        if ctx.window < 0:
            dq, dk_rot, dv = flash_bwd(q, k_rot, v, o, lse, do, cos, sin, scale)
        else:
            dq, delta = flash_bwd_dq(q, k_rot, v, o, lse, do, cos, sin, ctx.window, scale)
            dk_rot, dv = flash_bwd_dkv(q, k_rot, v, lse, delta, do, cos, sin, ctx.window, scale)
    else:
        dq = flash_bwd_dq_reference(q, k_rot, v, o, lse, do, cos, sin, ctx.window)
        dk_rot, dv = flash_bwd_dkv_reference(q, k_rot, v, o, lse, do, cos, sin, ctx.window)
    dk = unapply_rope(dk_rot, cos, sin)  # adjoint of k's rotation, fp32 on the small rank-3 tensor
    return dq.to(q.dtype), dk.to(k_rot.dtype), dv.to(v.dtype), None, None, None


flash_attention_op.register_autograd(_attention_backward, setup_context=_save_residuals)


def needs_gradient(*tensors: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def flash_attention(
    q: torch.Tensor,  # (B, T, H, D), unrotated
    k: torch.Tensor,  # (B, S, Kv, D), unrotated
    v: torch.Tensor,  # (B, S, Kv, D)
    window: int | None,
    rope: tuple,  # (cos, sin) tables (T, D) fp32
) -> torch.Tensor:
    """Rotary-embedded MQA self-attention (Kv == 1, S == T, else ValueError),
    windowed to +/- window/2 when the window is shorter than the sequence.
    Under a gradient it is ``flash_attention_op``: the kernels for CUDA
    tensors, global and windowed alike, and their plain versions for CPU
    tensors. Without one it is the forward kernel alone and takes CUDA tensors
    only (bf16, D == 64)."""
    B, T, H, D = q.shape
    S, Kv = k.shape[1], k.shape[2]
    if Kv != 1 or S != T:
        raise ValueError(f"flash kernel takes MQA self-attention (Kv == 1, S == T); got Kv={Kv}, S={S}, T={T}")
    # a window that covers the whole sequence is global attention
    window = -1 if window is None or S <= window else window
    cos, sin = rope
    q, k3, v3 = q.contiguous(), k.reshape(B, S, D).contiguous(), v.reshape(B, S, D).contiguous()
    cos, sin = cos.contiguous(), sin.contiguous()
    if needs_gradient(q, k, v):
        return flash_attention_op(q, k3, v3, cos, sin, window)[0]
    if not q.is_cuda:
        raise ValueError(f"flash_attention runs the CUDA kernel; got a tensor on {q.device}")
    return flash_fwd(q, rotated_k(k3, cos, sin), v3, cos, sin, window, D**-0.5)


def flash_attention_reference(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, window: int | None, rope: tuple
) -> torch.Tensor:
    """Plain PyTorch version of ``flash_attention``: ``apply_rope`` on q and k,
    then the grouped attention math with a float32 softmax, in query chunks."""
    from osufusion_tpu_torch.ops.attention import gqa_attention

    return gqa_attention(apply_rope(q, *rope), apply_rope(k, *rope), v, window=window)


# query rows / keys per step of the plain training versions: bounds their
# logits to (B, chunk, H, keys in reach) however long the sequence is
REFERENCE_CHUNK = 512


def _scaled_rotated_q(q: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """qs = rope(q) * D^-0.5 * log2(e) in fp32: what the kernels hold (there rounded to bf16)."""
    return apply_rope(q.float(), cos, sin) * (q.shape[-1] ** -0.5 * LOG2E)


def _query_chunks(T: int, S: int, window: int, device):
    """Per chunk of REFERENCE_CHUNK query rows: (rows, keys, outside). ``keys``
    is the slice of keys the chunk's rows can reach (|t - s| <= window // 2;
    every key when window < 0) and ``outside`` (rows, 1, keys) marks the pairs
    of that tile beyond the window, None where there are none."""
    for t0 in range(0, T, REFERENCE_CHUNK):
        t1 = min(T, t0 + REFERENCE_CHUNK)
        if window < 0:
            yield slice(t0, t1), slice(0, S), None
            continue
        w2 = window // 2
        s0, s1 = max(0, t0 - w2), min(S, t1 + w2)
        t, s = torch.arange(t0, t1, device=device), torch.arange(s0, s1, device=device)
        yield slice(t0, t1), slice(s0, s1), ((t[:, None] - s[None, :]).abs() > w2)[:, None, :]


def flash_fwd_lse_reference(
    q: torch.Tensor,  # (B, T, H, D) raw
    k_rot: torch.Tensor,  # (B, S, D) already rotated
    v: torch.Tensor,  # (B, S, D)
    cos: torch.Tensor,
    sin: torch.Tensor,
    window: int = -1,
):
    """Plain version of ``flash_fwd(..., return_lse=True)`` in fp32:
    (o (B, T, H, D), lse2 (B, T*H)), the logits in the exp2 domain."""
    qs = _scaled_rotated_q(q, cos, sin)
    return forward_chunks(qs, k_rot, v, _query_chunks(q.shape[1], k_rot.shape[1], window, q.device))


def forward_chunks(qs: torch.Tensor, k: torch.Tensor, v: torch.Tensor, chunks):
    """The forward's arithmetic in fp32 over ``chunks`` of (rows, keys,
    outside), as ``_query_chunks`` yields them: o (B, T, H, D) and the base-2
    LSE (B, T*H) of the exp2-domain logits qs k^T. Every row must see a key."""
    B, T, H, D = qs.shape
    kf, vf = k.float(), v.float()
    o = torch.empty((B, T, H, D), dtype=torch.float32, device=qs.device)
    lse = torch.empty((B, T, H), dtype=torch.float32, device=qs.device)
    for rows, keys, outside in chunks:
        s2 = torch.einsum("bthd,bsd->bths", qs[:, rows], kf[:, keys])
        if outside is not None:
            s2 = s2.masked_fill(outside, -torch.inf)
        m = s2.amax(dim=-1, keepdim=True)
        p = torch.exp2(s2 - m)
        l = p.sum(dim=-1, keepdim=True)
        lse[:, rows] = (m + torch.log2(l))[..., 0]
        o[:, rows] = torch.einsum("bths,bsd->bthd", p / l, vf[:, keys])
    return o, lse.reshape(B, T * H)


def backward_chunks(qs, k, v, o, lse, do, chunks):
    """What the split backward kernels recompute, per chunk of query rows of
    ``chunks`` (as ``forward_chunks`` takes them): (rows, keys, qs, k, do, p,
    ds) with p = exp2(qs k^T - lse2), zero outside the window, and ds = p (do
    v^T - rowsum(do o)); all fp32."""
    B, T, H, D = qs.shape
    kf, vf, dof = k.float(), v.float(), do.float()
    lse3 = lse.reshape(B, T, H, 1)
    delta = (dof * o.float()).sum(dim=-1, keepdim=True)
    for rows, keys, outside in chunks:
        p = torch.exp2(torch.einsum("bthd,bsd->bths", qs[:, rows], kf[:, keys]) - lse3[:, rows])
        if outside is not None:
            p = p.masked_fill(outside, 0.0)
        ds = p * (torch.einsum("bthd,bsd->bths", dof[:, rows], vf[:, keys]) - delta[:, rows])
        yield rows, keys, qs[:, rows], kf[:, keys], dof[:, rows], p, ds


def _backward_chunks(q, k_rot, v, o, lse, do, cos, sin, window):
    """``backward_chunks`` at a self-attention site with fused q-RoPE."""
    chunks = _query_chunks(q.shape[1], k_rot.shape[1], window, q.device)
    return backward_chunks(_scaled_rotated_q(q, cos, sin), k_rot, v, o, lse, do, chunks)


def flash_bwd_dq_reference(
    q: torch.Tensor,  # (B, T, H, D) raw
    k_rot: torch.Tensor,  # (B, S, D) already rotated
    v: torch.Tensor,  # (B, S, D)
    o: torch.Tensor,  # (B, T, H, D)
    lse: torch.Tensor,  # (B, T*H) base-2
    do: torch.Tensor,  # (B, T, H, D)
    cos: torch.Tensor,
    sin: torch.Tensor,
    window: int,  # -1 = global
) -> torch.Tensor:
    """Plain version of ``flash_bwd_dq`` in fp32: dq in the raw q's frame."""
    dq_rot = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    for rows, _, _, k_c, _, _, ds in _backward_chunks(q, k_rot, v, o, lse, do, cos, sin, window):
        dq_rot[:, rows] = torch.einsum("bths,bsd->bthd", ds, k_c) * q.shape[-1] ** -0.5
    return unapply_rope(dq_rot, cos, sin)


def flash_bwd_dkv_reference(q, k_rot, v, o, lse, do, cos, sin, window: int):
    """Plain version of ``flash_bwd_dkv`` in fp32, on the operands of
    ``flash_bwd_dq_reference``: (dk_rot, still in the rotated frame, dv)."""
    dk_rot = torch.zeros(k_rot.shape, dtype=torch.float32, device=q.device)
    dv = torch.zeros_like(dk_rot)
    for _, keys, qs_c, _, do_c, p, ds in _backward_chunks(q, k_rot, v, o, lse, do, cos, sin, window):
        dv[:, keys] += torch.einsum("bths,bthd->bsd", p, do_c)
        dk_rot[:, keys] += torch.einsum("bths,bthd->bsd", ds, qs_c)
    return dk_rot * LN2, dv


def flash_bwd_reference(
    q: torch.Tensor,  # (B, T, H, D) raw
    k_rot: torch.Tensor,  # (B, S, D) already rotated
    v: torch.Tensor,  # (B, S, D)
    o: torch.Tensor,  # (B, T, H, D)
    lse: torch.Tensor,  # (B, T*H) base-2
    do: torch.Tensor,  # (B, T, H, D)
    cos: torch.Tensor,
    sin: torch.Tensor,
):
    """Plain version of ``flash_bwd`` in fp32: the kernel's arithmetic, KV tile
    by KV tile, from the LSE. Returns (dq in the raw q's frame, dk_rot, dv)."""
    B, T, H, D = q.shape
    scale = D**-0.5
    qs = _scaled_rotated_q(q, cos, sin)
    kf, vf, dof = k_rot.float(), v.float(), do.float()
    lse3 = lse.reshape(B, T, H, 1)
    delta = (dof * o.float()).sum(dim=-1, keepdim=True)
    dq_rot = torch.zeros_like(qs)
    dk_rot, dv = torch.empty_like(kf), torch.empty_like(vf)
    for s0 in range(0, kf.shape[1], REFERENCE_CHUNK):
        kt, vt = kf[:, s0 : s0 + REFERENCE_CHUNK], vf[:, s0 : s0 + REFERENCE_CHUNK]
        p = torch.exp2(torch.einsum("bthd,bsd->bths", qs, kt) - lse3)
        dv[:, s0 : s0 + REFERENCE_CHUNK] = torch.einsum("bths,bthd->bsd", p, dof)
        ds = p * (torch.einsum("bthd,bsd->bths", dof, vt) - delta)
        dk_rot[:, s0 : s0 + REFERENCE_CHUNK] = torch.einsum("bths,bthd->bsd", ds, qs) * LN2
        dq_rot += torch.einsum("bths,bsd->bthd", ds, kt) * scale
    return unapply_rope(dq_rot, cos, sin), dk_rot, dv
