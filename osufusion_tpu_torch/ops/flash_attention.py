"""MQA flash attention with fused q-RoPE: the wrappers of the CUDA kernels in
``csrc/flash_fwd.cu`` and ``csrc/flash_bwd.cu``, the ``torch.autograd.Function``
that joins them, and their plain PyTorch versions.

``flash_fwd`` replaces ``osufusion_tpu/ops/pallas_attention.py::_fwd_kernel``
(launched by ``_flash_fwd``): all H query heads fold into rows against one
(B, S, D) KV, q is rotated once per block with the softmax scale folded in,
and a +/- window/2 sliding window visits only the KV tiles it reaches. In its
training form (global, ``return_lse=True``) it also returns the base-2
log-sum-exp of its logits, flat (B, T*H) in t-major order. ``flash_bwd``
replaces ``_bwd_fused_kernel`` (launched by ``_flash_bwd_fused``): the global
backward that recomputes the probabilities from that LSE and does the five
products in one sweep; dq is accumulated with fp32 atomics, so it differs in
its last bits from run to run.

What bounds them on an H100: compute. At the serving path's level-0 site (T =
24576, W = 4096, H = 16, D = 64) each q row meets ~4k keys for 256 bytes of
q/o traffic, and each KV tile staged in shared memory serves all heads of
eight timesteps, so the arithmetic intensity is far above the ~295 FLOP/byte
ridge; the training sites (T = S = 4096 ... 512, global) are the same. The
design therefore spends its effort on the math: every product runs on bf16
tensor cores (``mma.sync`` m16n8k16, fp32 accumulation), the softmax stays in
fp32 registers in the exp2 domain, only edge tiles are masked, and tiles are
copied with ``cp.async``.

The wrappers launch the kernels for CUDA tensors and raise on anything the
kernels do not take, a CPU tensor included; ``ops.attention.sdpa`` sends CPU
tensors to ``flash_attention_reference`` (with native autograd) instead. A
CUDA tensor that needs a gradient goes through ``FlashAttentionFunction``;
at a windowed site that raises until the windowed backward kernels are ported
(ROADMAP.md, queue 2).
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
# kernel name -> source; each becomes a shared library of its own
SOURCES = {"flash_fwd": _CSRC / "flash_fwd.cu", "flash_bwd": _CSRC / "flash_bwd.cu"}
# built at first use, beside the checkout: <repo>/build/osufusion_tpu_torch/
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "osufusion_tpu_torch"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC"]


def build_kernels(verbose: bool = False) -> dict[str, Path]:
    """Compile every source of ``SOURCES`` with nvcc for sm_90a into a C-ABI
    shared library of its own (named by the source's hash, so an edited source
    rebuilds), all compilers started together, and return {name: path}.
    ``verbose`` prints ptxas's register and spill report of each build."""
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA toolkit")
    outs, running = {}, []
    for name, source in SOURCES.items():
        digest = hashlib.sha256(source.read_bytes()).hexdigest()[:12]
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


_ARGTYPES = {
    # q k v cos sin o lse | B T S H window | scale | stream
    "flash_fwd": [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5 + [ctypes.c_float, ctypes.c_void_p],
    # q k v do o lse delta cos sin dq dk dv | B T S H | scale | stream
    "flash_bwd": [ctypes.c_void_p] * 12 + [ctypes.c_int] * 4 + [ctypes.c_float, ctypes.c_void_p],
}


@functools.cache
def _kernel(name: str):
    """The C entry point ``<name>_bf16`` of the library built from ``SOURCES[name]``."""
    fn = getattr(ctypes.CDLL(str(build_kernels()[name])), f"{name}_bf16")
    fn.restype = ctypes.c_int
    fn.argtypes = _ARGTYPES[name]
    return fn


def _check_operands(who: str, device, operands) -> None:
    for name, t, dtype in operands:
        if not t.is_cuda or t.device != device:
            raise ValueError(f"{who}: {name} must be a CUDA tensor on {device}, got {t.device}")
        if t.dtype != dtype:
            raise ValueError(f"{who}: {name} must be {dtype}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{who}: {name} must be contiguous")


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
    if window < -1:
        raise ValueError(f"flash_fwd: window must be -1 (global) or >= 0, got {window}")
    o = torch.empty_like(q)
    lse = torch.empty((B, T * H), dtype=torch.float32, device=q.device) if return_lse else None
    err = _kernel("flash_fwd")(
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
    if q.ndim != 4 or k.ndim != 3:
        raise ValueError(f"flash_bwd wants q (B,T,H,D), k/v (B,T,D); got {tuple(q.shape)}, {tuple(k.shape)}")
    B, T, H, D = q.shape
    if (D != HEAD_DIM or k.shape != (B, T, D) or v.shape != k.shape or o.shape != q.shape or do.shape != q.shape
            or lse.shape != (B, T * H) or cos.shape != (T, D) or sin.shape != (T, D)):
        raise ValueError(
            f"flash_bwd shapes: q {tuple(q.shape)} k {tuple(k.shape)} v {tuple(v.shape)} o {tuple(o.shape)} "
            f"do {tuple(do.shape)} lse {tuple(lse.shape)} cos {tuple(cos.shape)}; head dim must be {HEAD_DIM}")
    bf16, f32 = torch.bfloat16, torch.float32
    _check_operands("flash_bwd", q.device, (("q", q, bf16), ("k", k, bf16), ("v", v, bf16), ("o", o, bf16), ("do", do, bf16),
                                            ("lse", lse, f32), ("cos", cos, f32), ("sin", sin, f32)))
    delta = torch.empty((B, T * H), dtype=f32, device=q.device)
    dq = torch.zeros(q.shape, dtype=f32, device=q.device)
    dk = torch.empty(k.shape, dtype=f32, device=q.device)
    dv = torch.empty(v.shape, dtype=f32, device=q.device)
    err = _kernel("flash_bwd")(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), o.data_ptr(), lse.data_ptr(), delta.data_ptr(),
        cos.data_ptr(), sin.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        B, T, T, H, scale, torch.cuda.current_stream(q.device).cuda_stream,
    )
    if err:
        raise RuntimeError(f"flash_bwd kernel launch failed: CUDA error {err}")
    flash_bwd.launches += 1
    return dq.to(bf16), dk, dv


flash_bwd.launches = 0


def rotated_k(k: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """k (B, S, D) with the rotary embedding applied, as both kernels take it:
    k is 16x smaller than q at MQA, so it is rotated once outside, in fp32."""
    return apply_rope(k.float(), cos, sin).to(k.dtype)


class FlashAttentionFunction(torch.autograd.Function):
    """Global MQA attention with rotary embedding over (q, k, v, cos, sin):
    q (B, T, H, D), k and v (B, T, D), all raw bf16 CUDA tensors; the tables
    (T, D) fp32 get no gradient. Forward rotates k and launches ``flash_fwd``
    with the LSE; backward launches ``flash_bwd`` and un-rotates dk. Returns
    (o, lse2) so that a rematerialisation policy can pin both; lse2 is not
    differentiable. Raises on anything the kernels do not take. Every cast in
    here is explicit, so it computes the same under ``torch.autocast``."""

    @staticmethod
    @torch.amp.custom_fwd(device_type="cuda")
    def forward(ctx, q, k, v, cos, sin):
        if not q.is_cuda:
            raise ValueError(f"FlashAttentionFunction runs the CUDA kernels; got a tensor on {q.device}")
        scale = q.shape[-1] ** -0.5
        k_rot = rotated_k(k, cos, sin)
        o, lse = flash_fwd(q, k_rot, v, cos, sin, -1, scale, return_lse=True)
        ctx.save_for_backward(q, k_rot, v, o, lse, cos, sin)
        ctx.scale = scale
        ctx.mark_non_differentiable(lse)
        return o, lse

    @staticmethod
    @torch.amp.custom_bwd(device_type="cuda")
    def backward(ctx, do, _dlse):
        q, k_rot, v, o, lse, cos, sin = ctx.saved_tensors
        dq, dk_rot, dv = flash_bwd(q, k_rot, v, o, lse, do.contiguous(), cos, sin, ctx.scale)
        dk = unapply_rope(dk_rot, cos, sin)  # adjoint of k's rotation, fp32 on the small rank-3 tensor
        return dq, dk.to(k_rot.dtype), dv.to(v.dtype), None, None


def require_backward_kernel(window: int | None) -> None:
    """A site that needs a gradient on the GPU must be global: the windowed
    backward kernels are not ported yet, and nothing drops to the plain
    version."""
    if window is not None:
        raise NotImplementedError(
            f"windowed attention (window {window}) has no backward kernel on the GPU yet "
            "(ROADMAP.md, queue 2: the split windowed backward kernels); train at sequence "
            "lengths no longer than the attention context"
        )


def flash_attention(
    q: torch.Tensor,  # (B, T, H, D), unrotated
    k: torch.Tensor,  # (B, S, Kv, D), unrotated
    v: torch.Tensor,  # (B, S, Kv, D)
    window: int | None,
    rope: tuple,  # (cos, sin) tables (T, D) fp32
) -> torch.Tensor:
    """Rotary-embedded MQA attention, windowed to +/- window/2 when the window
    is shorter than the sequence, on the kernels: CUDA tensors, bf16, Kv == 1,
    S == T, D == 64, else ValueError. Differentiable at global sites
    (``FlashAttentionFunction``); a windowed site under a gradient raises."""
    if not q.is_cuda:
        raise ValueError(f"flash_attention runs the CUDA kernel; got a tensor on {q.device}")
    B, T, H, D = q.shape
    S, Kv = k.shape[1], k.shape[2]
    if Kv != 1 or S != T:
        raise ValueError(f"flash kernel takes MQA self-attention (Kv == 1, S == T); got Kv={Kv}, S={S}, T={T}")
    if window is not None and S <= window:
        window = None  # the window covers the whole sequence: global attention
    cos, sin = rope
    q, k3, v3 = q.contiguous(), k.reshape(B, S, D).contiguous(), v.reshape(B, S, D).contiguous()
    cos, sin = cos.contiguous(), sin.contiguous()
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        require_backward_kernel(window)
        return FlashAttentionFunction.apply(q, k3, v3, cos, sin)[0]
    return flash_fwd(q, rotated_k(k3, cos, sin), v3, cos, sin, -1 if window is None else window, D**-0.5)


def flash_attention_reference(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, window: int | None, rope: tuple
) -> torch.Tensor:
    """Plain PyTorch version of ``flash_attention``: ``apply_rope`` on q and k,
    then the grouped attention math with a float32 softmax, in query chunks."""
    from osufusion_tpu_torch.ops.attention import gqa_attention

    return gqa_attention(apply_rope(q, *rope), apply_rope(k, *rope), v, window=window)


# query rows / keys per step of the plain training versions: bounds their
# logits to (B, chunk, H, S) however long the sequence is
REFERENCE_CHUNK = 512


def _scaled_rotated_q(q: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """qs = rope(q) * D^-0.5 * log2(e) in fp32: what the kernels hold (there rounded to bf16)."""
    return apply_rope(q.float(), cos, sin) * (q.shape[-1] ** -0.5 * LOG2E)


def flash_fwd_lse_reference(
    q: torch.Tensor,  # (B, T, H, D) raw
    k_rot: torch.Tensor,  # (B, S, D) already rotated
    v: torch.Tensor,  # (B, S, D)
    cos: torch.Tensor,
    sin: torch.Tensor,
):
    """Plain version of ``flash_fwd(..., window=-1, return_lse=True)`` in
    fp32: (o (B, T, H, D), lse2 (B, T*H)), the logits in the exp2 domain."""
    B, T, H, D = q.shape
    qs = _scaled_rotated_q(q, cos, sin)
    kf, vf = k_rot.float(), v.float()
    o = torch.empty((B, T, H, D), dtype=torch.float32, device=q.device)
    lse = torch.empty((B, T, H), dtype=torch.float32, device=q.device)
    for t0 in range(0, T, REFERENCE_CHUNK):
        s2 = torch.einsum("bthd,bsd->bths", qs[:, t0 : t0 + REFERENCE_CHUNK], kf)
        m = s2.amax(dim=-1, keepdim=True)
        p = torch.exp2(s2 - m)
        l = p.sum(dim=-1, keepdim=True)
        lse[:, t0 : t0 + REFERENCE_CHUNK] = (m + torch.log2(l))[..., 0]
        o[:, t0 : t0 + REFERENCE_CHUNK] = torch.einsum("bths,bsd->bthd", p / l, vf)
    return o, lse.reshape(B, T * H)


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
