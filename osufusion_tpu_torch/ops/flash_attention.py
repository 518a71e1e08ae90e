"""Windowed MQA flash-attention forward with fused q-RoPE: the wrapper of the
CUDA kernel in ``csrc/flash_fwd.cu`` and its plain PyTorch version.

Replaces ``osufusion_tpu/ops/pallas_attention.py::_fwd_kernel`` (launched by
``_flash_fwd``) in its forward-only serving form: all H query heads fold into
rows against one (B, S, D) KV, q is rotated once per block with the softmax
scale folded in, and a +/- window/2 sliding window visits only the KV tiles
it reaches.

What bounds it on an H100: compute. At the serving path's level-0 site (T =
24576, W = 4096, H = 16, D = 64) each q row meets ~4k keys for 256 bytes of
q/o traffic, and each KV tile staged in shared memory serves all heads of
eight timesteps, so the arithmetic intensity is far above the ~295 FLOP/byte
ridge. The design therefore spends its effort on the math: both products run
on bf16 tensor cores (``mma.sync`` m16n8k16, fp32 accumulation), the online
softmax stays in fp32 registers in the exp2 domain, only the edge tiles of the
window are masked, and the next KV tile is copied with ``cp.async`` while the
current one is in use.

The wrapper launches the kernel for a CUDA tensor and raises on anything the
kernel does not take, a CPU tensor included; ``ops.attention.sdpa`` sends CPU
tensors to ``flash_attention_reference`` instead.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
from pathlib import Path

import torch

from osufusion_tpu_torch.ops.rope import apply_rope

HEAD_DIM = 64
_SOURCE = Path(__file__).resolve().parent.parent / "csrc" / "flash_fwd.cu"
# built at first use, beside the checkout: <repo>/build/osufusion_tpu_torch/
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "osufusion_tpu_torch"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC"]


def build_kernels(verbose: bool = False) -> Path:
    """Compile ``csrc/flash_fwd.cu`` with nvcc for sm_90a into a C-ABI shared
    library (named by the source's hash, so an edited source rebuilds) and
    return its path. ``verbose`` prints ptxas's register and spill report
    when a build happens."""
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA toolkit")
    digest = hashlib.sha256(_SOURCE.read_bytes()).hexdigest()[:12]
    out = BUILD_DIR / f"libflash_fwd_{digest}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [str(Path(CUDA_HOME) / "bin" / "nvcc"), *NVCC_FLAGS, "-Xptxas", "-v", "-o", str(tmp), str(_SOURCE)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stderr}")
    if verbose:
        print(proc.stderr.strip())
    tmp.replace(out)
    return out


@functools.cache
def _library() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build_kernels()))
    lib.flash_fwd_bf16.restype = ctypes.c_int
    lib.flash_fwd_bf16.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [ctypes.c_float, ctypes.c_void_p]
    return lib


def flash_fwd(
    q: torch.Tensor,  # (B, T, H, D) bf16, raw
    k: torch.Tensor,  # (B, T, D) bf16, already rotated
    v: torch.Tensor,  # (B, T, D) bf16
    cos: torch.Tensor,  # (T, D) fp32
    sin: torch.Tensor,  # (T, D) fp32
    window: int,  # -1 = global
    scale: float,
) -> torch.Tensor:
    """Launch the kernel on the current stream; returns o (B, T, H, D) bf16.
    Counts its launches in ``flash_fwd.launches``."""
    if q.ndim != 4 or k.ndim != 3 or v.shape != k.shape:
        raise ValueError(f"flash_fwd wants q (B,T,H,D), k/v (B,T,D); got {tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    B, T, H, D = q.shape
    if D != HEAD_DIM or k.shape != (B, T, D) or cos.shape != (T, D) or sin.shape != (T, D):
        raise ValueError(f"flash_fwd shapes: q {tuple(q.shape)} k {tuple(k.shape)} cos {tuple(cos.shape)}; head dim must be {HEAD_DIM}")
    for name, t, dtype in (("q", q, torch.bfloat16), ("k", k, torch.bfloat16), ("v", v, torch.bfloat16),
                           ("cos", cos, torch.float32), ("sin", sin, torch.float32)):
        if not t.is_cuda or t.device != q.device:
            raise ValueError(f"flash_fwd: {name} must be a CUDA tensor on {q.device}, got {t.device}")
        if t.dtype != dtype:
            raise ValueError(f"flash_fwd: {name} must be {dtype}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"flash_fwd: {name} must be contiguous")
    if window < -1:
        raise ValueError(f"flash_fwd: window must be -1 (global) or >= 0, got {window}")
    o = torch.empty_like(q)
    lib = _library()
    err = lib.flash_fwd_bf16(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), cos.data_ptr(), sin.data_ptr(), o.data_ptr(),
        B, T, T, H, window, scale, torch.cuda.current_stream(q.device).cuda_stream,
    )
    if err:
        raise RuntimeError(f"flash_fwd kernel launch failed: CUDA error {err}")
    flash_fwd.launches += 1
    return o


flash_fwd.launches = 0


def flash_attention(
    q: torch.Tensor,  # (B, T, H, D), unrotated
    k: torch.Tensor,  # (B, S, Kv, D), unrotated
    v: torch.Tensor,  # (B, S, Kv, D)
    window: int | None,
    rope: tuple,  # (cos, sin) tables (T, D) fp32
) -> torch.Tensor:
    """Rotary-embedded MQA attention, windowed to +/- window/2 when the window
    is shorter than the sequence, on the kernel: CUDA tensors, bf16, Kv == 1,
    S == T, D == 64, else ValueError."""
    if not q.is_cuda:
        raise ValueError(f"flash_attention runs the CUDA kernel; got a tensor on {q.device}")
    B, T, H, D = q.shape
    S, Kv = k.shape[1], k.shape[2]
    if Kv != 1 or S != T:
        raise ValueError(f"flash kernel takes MQA self-attention (Kv == 1, S == T); got Kv={Kv}, S={S}, T={T}")
    if window is not None and S <= window:
        window = None  # the window covers the whole sequence: global attention
    cos, sin = rope
    # k is 16x smaller than q at MQA: rotate it here once, in fp32
    k_rot = apply_rope(k.reshape(B, S, D).float(), cos, sin).to(k.dtype)
    return flash_fwd(q.contiguous(), k_rot, v.reshape(B, S, D).contiguous(), cos.contiguous(), sin.contiguous(),
                     -1 if window is None else window, D**-0.5)


def flash_attention_reference(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, window: int | None, rope: tuple
) -> torch.Tensor:
    """Plain PyTorch version of ``flash_attention``: ``apply_rope`` on q and k,
    then the grouped attention math with a float32 softmax, in query chunks."""
    from osufusion_tpu_torch.ops.attention import gqa_attention

    return gqa_attention(apply_rope(q, *rope), apply_rope(k, *rope), v, window=window)
