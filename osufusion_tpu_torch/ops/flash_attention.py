"""Flash attention with fused q-RoPE: the wrappers of the CUDA kernels in
``csrc/``, the differentiable op that joins them, and their plain PyTorch
versions.

``flash_fwd`` replaces ``osufusion_tpu/ops/pallas_attention.py::_fwd_kernel``
(launched by ``_flash_fwd``): the query heads of each KV head fold into rows
against that head's keys (MQA: all H against one (B, S, D) KV; DiT's full MHA
and MMDiT's GQA: k and v (B, S, Kv, D), one block row of the grid per (batch,
KV head), where the JAX package folds timesteps), q is rotated once per block
with the softmax scale folded in (or only scaled, without tables), and a +/-
window/2 sliding window visits only the KV tiles it reaches. In its training
form (``return_lse=True``) it also returns the base-2 log-sum-exp of its
logits, flat (B, T*H) in t-major order. The backward recomputes the
probabilities from that LSE. At a global site ``flash_bwd`` replaces
``_bwd_fused_kernel`` (launched by ``_flash_bwd_fused``): the five products in
one sweep, dq accumulated with fp32 atomics, so it differs in its last bits
from run to run. At a windowed site the split pair ``flash_bwd_dq`` and
``flash_bwd_dkv`` replaces ``_dq_kernel`` and ``_dkv_kernel`` (launched by
``_flash_bwd``): the first runs the pre-pass (qs, delta, the padded LSE:
``WindowedPrep``) and the dq kernel, the second reads that scratch; no
atomics, so all three gradients repeat bit for bit. The pair takes MQA with
rotary tables; ``flash_attention`` runs a windowed GQA site once per KV
head, as the JAX package does. The ring of sequence parallelism
(``ops/ring_attention.py``) runs the global backward in its three parts
(``flash_bwd_prep``, one ``flash_bwd_sweep`` per hop that adds into the
travelling dk and dv, ``flash_bwd_post``) and merges the forward's hops with
``ring_merge`` (``csrc/ring_merge.cu``).

What bounds them on an H100: compute. At the serving path's level-0 site (T =
24576, W = 4096, H = 16, D = 64) each q row meets ~4k keys for 256 bytes of
q/o traffic, and each KV tile staged in shared memory serves all heads of
eight timesteps, so the arithmetic intensity is far above the ~295 FLOP/byte
ridge; the training sites (global at T = 4096 ... 512, windowed at T = 65536
... 8192) are the same. The forward, the global backward and the windowed
pair (``csrc/flash_fwd.cuh``, ``csrc/flash_bwd.cu`` with its sweep
``csrc/flash_bwd_sweep.cuh``, ``csrc/flash_bwd_windowed.cuh``) are built for
Hopper: tiles arrive by TMA
behind mbarriers from a producer warp or warpgroup, and warpgroups run every
product as ``wgmma`` with fp32 accumulation (``csrc/hopper.cuh``); the
softmax stays in fp32 registers in the exp2 domain and only edge tiles are
masked. Both backward paths start with one pre-pass that rotates and scales
q once (``csrc/flash_bwd_prep.cuh``). The halo kernels of sequence
parallelism (``ops/halo_attention.py``) are the same bodies in the halo frame
(``csrc/key_frame.cuh``): the forward is ``csrc/flash_fwd.cuh``'s HALO
instance, the backward the windowed pair's, behind the same pre-pass.

Those kernels take bf16 operands. The forward (K1, ``flash_fwd``, and its
halo instance), the global backward's sweep (K2, ``flash_bwd`` and the
ring's ``flash_bwd_sweep``) and the windowed pair with its pre-pass (K3a /
K3b, ``flash_bwd_dq`` / ``flash_bwd_dkv``, and its halo instances) are
templated on the head dim and take D = 64, 128, 192 and 256; at D > 64 the
global backward runs the sweep between the forms family's D-generic
pre-pass and post-pass (same scratch, dq buffer zeroed by the pre-pass). K1,
K2's sweep and the windowed pair with its pre-pass are templated on the
operand type too and take fp16 at the same head dims, each type a library of
its own (``flash_fwd_f16``, ``flash_bwd_f16``, ``flash_bwd_windowed_f16``):
at fp16 every forward is K1 (with its halo instance and the ring's hops), a
windowed backward the fp16 pair (and its halo instances), and the global
backward runs K2's sweep between the forms pre-pass and post-pass at every
D, as bf16 does above 64. Above D = 256, at bf16 and fp16, every forward (the
halo frame and the ring's hops too) is ``csrc/flash_xwide.cuh``'s forward, at
every head dim (above 512 it streams qs from a pre-pass and splits its
output's columns over blocks), and at D = 320 ... 512 every backward (global,
the ring's sweeps, windowed, halo) its dq and dk/dv pair between the forms
pre-pass and post-pass (``xwide_bwd_dq``, ``xwide_bwd_dkv``); libraries
``flash_xwide`` and ``flash_xwide_f16``. fp32 runs ``csrc/flash_f32x6.cuh``,
each fp32 product as six bf16 products on the tensor cores, on the bf16
pieces of its operands (``f32x6_split``): every forward at every head dim
(the halo frame and the ring's hops too; ``f32x6_fwd``, ``f32x6_halo_fwd``;
above 256 on the pieces of qs from a pre-pass, its output's columns split
over blocks above 512) and up to D = 512 every backward (global, the ring's
sweeps, windowed, halo) through its dq and dk/dv pair between the forms
pre-pass and post-pass (``f32x6_bwd_dq``, ``f32x6_bwd_dkv``); library
``flash_f32x6``. The ring's merge takes bf16 at D = 64. Every other form
(fp16's merge and the global backward's pre-pass and post-pass; every type's
dq and dk/dv above D = 512; bf16 at D > 64 for the merge and the global
backward's pre-pass and post-pass: ``flash_forms.kernel_form``) goes to the
forms family (``ops/flash_forms.py``, ``csrc/flash_forms.cu``): each wrapper
here chooses the entry point by the operands' (dtype, D) through
``flash_forms.route``, and the forms family runs every backward as the split
pre-pass, dq, dk/dv and post-pass.

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
from typing import NamedTuple, Optional

import torch

from osufusion_tpu_torch.ops import flash_forms as forms
from osufusion_tpu_torch.ops.rope import apply_rope, unapply_rope

# the head dim of every wgmma kernel; K1, K2's sweep and the windowed pair also take flash_forms.WGMMA_HEAD_DIMS
HEAD_DIM = 64
LOG2E = 1.4426950408889634
LN2 = 0.6931471805599453
_CSRC = Path(__file__).resolve().parent.parent / "csrc"
# library name -> source; each becomes a shared library of its own (K1's, K2's sweep's and the windowed
# pair's one a type)
SOURCES = {name: _CSRC / f"{name}.cu" for name in ("flash_fwd", "flash_fwd_f16", "flash_bwd", "flash_bwd_f16",
                                                   "flash_bwd_windowed", "flash_bwd_windowed_f16", "ring_merge",
                                                   "flash_forms", "flash_xwide", "flash_xwide_f16", "flash_f32x6")}
# built at first use, beside the checkout: <repo>/build/osufusion_tpu_torch/
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "osufusion_tpu_torch"
# query rows per tile of the global backward's sweep (csrc/flash_bwd.cu, BM):
# its group-major scratch is padded to a multiple of it
BWD_ROW_TILE = 64
# the windowed pre-pass pads its LSE and delta to a multiple of this many rows
# (csrc/flash_bwd_windowed.cuh, ROW_PAD): a whole number of the dq kernel's
# blocks at every head dim (128 rows a block, 64 at D = 256)
WINDOWED_ROW_PAD = 128
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
    # D | q k v cos sin o lse | B T S H Kv window | scale | stream
    "flash_fwd_bf16": ("flash_fwd", [_INT] + [_PTR] * 7 + [_INT] * 6 + [ctypes.c_float, _PTR]),
    "flash_fwd_f16": ("flash_fwd_f16", [_INT] + [_PTR] * 7 + [_INT] * 6 + [ctypes.c_float, _PTR]),
    # q k v do o lse cos sin | qs_g do_g lse_g delta_g dq_acc | dq dk dv | B T S H Kv | scale | stream
    "flash_bwd_bf16": ("flash_bwd", [_PTR] * 16 + [_INT] * 5 + [ctypes.c_float, _PTR]),
    # q do o lse cos sin | qs_g do_g lse_g delta_g dq_acc | B T H Kv | scale | stream
    "flash_bwd_prep_bf16": ("flash_bwd", [_PTR] * 11 + [_INT] * 4 + [ctypes.c_float, _PTR]),
    # D | k v qs_g do_rows lse_g delta_g dq_acc dk dv | B T S H Kv accumulate | stream
    "flash_bwd_sweep_bf16": ("flash_bwd", [_INT] + [_PTR] * 9 + [_INT] * 6 + [_PTR]),
    "flash_bwd_sweep_f16": ("flash_bwd_f16", [_INT] + [_PTR] * 9 + [_INT] * 6 + [_PTR]),
    # dq_acc cos sin dq | B T H Kv | scale | stream
    "flash_bwd_post_bf16": ("flash_bwd", [_PTR] * 4 + [_INT] * 4 + [ctypes.c_float, _PTR]),
    # o_acc lse_acc o_j lse_j lse_out o | rows | stream
    "ring_merge_bf16": ("ring_merge", [_PTR] * 6 + [_INT, _PTR]),
    # D | q do o lse cos sin | qs_g lse_g delta_g | B T H pad | scale | stream
    "flash_bwd_windowed_prep_bf16": ("flash_bwd_windowed", [_INT] + [_PTR] * 9 + [_INT] * 4 + [ctypes.c_float, _PTR]),
    "flash_bwd_windowed_prep_f16": ("flash_bwd_windowed_f16", [_INT] + [_PTR] * 9 + [_INT] * 4 + [ctypes.c_float, _PTR]),
    # D | k v do qs_g lse_g delta_g cos sin dq | B T S H pad window | scale | stream
    "flash_bwd_dq_bf16": ("flash_bwd_windowed", [_INT] + [_PTR] * 9 + [_INT] * 6 + [ctypes.c_float, _PTR]),
    "flash_bwd_dq_f16": ("flash_bwd_windowed_f16", [_INT] + [_PTR] * 9 + [_INT] * 6 + [ctypes.c_float, _PTR]),
    # D | k v do qs_g lse_g delta_g dk dv | B T S H pad window | stream
    "flash_bwd_dkv_bf16": ("flash_bwd_windowed", [_INT] + [_PTR] * 8 + [_INT] * 6 + [_PTR]),
    "flash_bwd_dkv_f16": ("flash_bwd_windowed_f16", [_INT] + [_PTR] * 8 + [_INT] * 6 + [_PTR]),
    # D | q k v o lse | B T H window g0 t_global | scale | stream
    "halo_fwd_bf16": ("flash_fwd", [_INT] + [_PTR] * 5 + [_INT] * 6 + [ctypes.c_float, _PTR]),
    "halo_fwd_f16": ("flash_fwd_f16", [_INT] + [_PTR] * 5 + [_INT] * 6 + [ctypes.c_float, _PTR]),
    # D | k v do qs_g lse_g delta_g dq | B T H pad window g0 t_global | scale | stream
    "halo_bwd_dq_bf16": ("flash_bwd_windowed", [_INT] + [_PTR] * 7 + [_INT] * 7 + [ctypes.c_float, _PTR]),
    "halo_bwd_dq_f16": ("flash_bwd_windowed_f16", [_INT] + [_PTR] * 7 + [_INT] * 7 + [ctypes.c_float, _PTR]),
    # D | k v do qs_g lse_g delta_g dk dv | B T H pad window g0 t_global | stream
    "halo_bwd_dkv_bf16": ("flash_bwd_windowed", [_INT] + [_PTR] * 8 + [_INT] * 7 + [_PTR]),
    "halo_bwd_dkv_f16": ("flash_bwd_windowed_f16", [_INT] + [_PTR] * 8 + [_INT] * 7 + [_PTR]),
    # above head dim 256 (csrc/flash_xwide.cuh): the forward as flash_fwd_* and halo_fwd_* take it, and the
    # scratch of its qs above 512 (``fwd_scratch``) after the LSE
    "xwide_fwd_bf16": ("flash_xwide", [_INT] + [_PTR] * 8 + [_INT] * 6 + [ctypes.c_float, _PTR]),
    "xwide_fwd_f16": ("flash_xwide_f16", [_INT] + [_PTR] * 8 + [_INT] * 6 + [ctypes.c_float, _PTR]),
    "xwide_halo_fwd_bf16": ("flash_xwide", [_INT] + [_PTR] * 6 + [_INT] * 6 + [ctypes.c_float, _PTR]),
    "xwide_halo_fwd_f16": ("flash_xwide_f16", [_INT] + [_PTR] * 6 + [_INT] * 6 + [ctypes.c_float, _PTR]),
    # the pair on the forms scratch, as forms_bwd_dq and forms_bwd_dkv take it without the type code
    # D | k v qs_g do_rows lse_g delta_g dq_acc | B T S H Kv pad window halo g0 t_global accumulate | stream
    "xwide_bwd_dq_bf16": ("flash_xwide", [_INT] + [_PTR] * 7 + [_INT] * 11 + [_PTR]),
    "xwide_bwd_dq_f16": ("flash_xwide_f16", [_INT] + [_PTR] * 7 + [_INT] * 11 + [_PTR]),
    # D | k v qs_g do_rows lse_g delta_g dk dv | B T S H Kv pad window halo g0 t_global accumulate | stream
    "xwide_bwd_dkv_bf16": ("flash_xwide", [_INT] + [_PTR] * 8 + [_INT] * 11 + [_PTR]),
    "xwide_bwd_dkv_f16": ("flash_xwide_f16", [_INT] + [_PTR] * 8 + [_INT] * 11 + [_PTR]),
    # fp32 on the tensor cores (csrc/flash_f32x6.cu): the forward as xwide_fwd_* and xwide_halo_fwd_* take it,
    # q and o fp32, k and v as their bf16 pieces, the scratch of qs's pieces above 256; the pair on the forms
    # scratch as the xwide pair takes it, k v qs_g do_rows as their pieces; and the split that makes them: x out |
    # rows D | stream
    "f32x6_fwd": ("flash_f32x6", [_INT] + [_PTR] * 8 + [_INT] * 6 + [ctypes.c_float, _PTR]),
    "f32x6_halo_fwd": ("flash_f32x6", [_INT] + [_PTR] * 6 + [_INT] * 6 + [ctypes.c_float, _PTR]),
    "f32x6_split": ("flash_f32x6", [_PTR] * 2 + [ctypes.c_longlong, _INT, _PTR]),
    "f32x6_bwd_dq": ("flash_f32x6", [_INT] + [_PTR] * 7 + [_INT] * 11 + [_PTR]),
    "f32x6_bwd_dkv": ("flash_f32x6", [_INT] + [_PTR] * 8 + [_INT] * 11 + [_PTR]),
    # the forms family (csrc/flash_forms.cu): each entry point takes the type code and D first
    # q do o lse cos sin | qs_g do_g lse_g delta_g | B T H Kv pad | scale | stream
    "forms_bwd_prep": ("flash_forms", [_INT] * 2 + [_PTR] * 10 + [_INT] * 5 + [ctypes.c_float, _PTR]),
    # k v qs_g do_rows lse_g delta_g dq_acc | B T S H Kv pad window halo g0 t_global accumulate | stream
    "forms_bwd_dq": ("flash_forms", [_INT] * 2 + [_PTR] * 7 + [_INT] * 11 + [_PTR]),
    # k v qs_g do_rows lse_g delta_g dk dv | B T S H Kv pad window halo g0 t_global accumulate | stream
    "forms_bwd_dkv": ("flash_forms", [_INT] * 2 + [_PTR] * 8 + [_INT] * 11 + [_PTR]),
    # dq_acc cos sin dq | B T H Kv pad | scale | stream
    "forms_bwd_post": ("flash_forms", [_INT] * 2 + [_PTR] * 4 + [_INT] * 5 + [ctypes.c_float, _PTR]),
    # o_acc lse_acc o_j lse_j lse_out o | rows | stream
    "forms_ring_merge": ("flash_forms", [_INT] * 2 + [_PTR] * 6 + [_INT, _PTR]),
}


# operand dtype -> the suffix of the entry points of K1, K2's sweep and the windowed pair of that type
TYPE_SUFFIX = {torch.bfloat16: "bf16", torch.float16: "f16"}


def fwd_entry(frame: str, route: str, dtype: torch.dtype) -> str:
    """The forward's entry point for ``frame`` ("flash" on one device, "halo"
    in the halo slab) at ``route`` (``flash_forms.route``): K1's of the dtype
    ("wgmma"), csrc/flash_xwide.cuh's ("xwide") or csrc/flash_f32x6.cu's,
    which has one type ("f32x6")."""
    if route == "f32x6":
        return "f32x6_fwd" if frame == "flash" else "f32x6_halo_fwd"
    prefix = frame if route == "wgmma" else "xwide" if frame == "flash" else "xwide_halo"
    return f"{prefix}_fwd_{TYPE_SUFFIX[dtype]}"


def fwd_scratch(route: str, q: torch.Tensor, kv: int) -> Optional[torch.Tensor]:
    """The scratch into which the forward entry point of ``route`` writes qs
    in group-major order (B * Kv, T * H / Kv, ...) before its kernel streams
    it, at the head dims whose block does not stage and hold qs itself:
    csrc/flash_f32x6.cuh's above 256 (qs's three bf16 pieces, 3 D a row),
    csrc/flash_xwide.cuh's above 512 (qs in q's dtype); else None (K1 and
    the narrower instances stage qs from the raw q)."""
    B, T, H, D = q.shape
    if route == "f32x6" and D > forms.WGMMA_HEAD_DIMS[-1]:
        return torch.empty((B * kv, T * (H // kv), 3 * D), dtype=torch.bfloat16, device=q.device)
    if route == "xwide" and D > forms.XWIDE_HEAD_DIMS[-1]:
        return torch.empty((B * kv, T * (H // kv), D), dtype=q.dtype, device=q.device)
    return None


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


def _kv_heads(who: str, q: torch.Tensor, k: torch.Tensor) -> int:
    """The KV heads of k: (B, S, D) is MQA, (B, S, Kv, D) any H % Kv == 0."""
    if q.ndim != 4 or k.ndim not in (3, 4):
        raise ValueError(f"{who} wants q (B,T,H,D), k/v (B,T,D) or (B,T,Kv,D); got {tuple(q.shape)}, {tuple(k.shape)}")
    kv = 1 if k.ndim == 3 else k.shape[2]
    if q.shape[2] % kv:
        raise ValueError(f"{who}: {q.shape[2]} query heads do not split into {kv} KV heads")
    return kv


def _tables(who: str, cos: Optional[torch.Tensor], sin: Optional[torch.Tensor], T: int, D: int) -> tuple:
    """The rotary tables as the kernels take them: both (T, D) fp32, or both
    None (no rotary embedding). Returns the operand checks they need."""
    if (cos is None) != (sin is None):
        raise ValueError(f"{who}: cos and sin are both tables or both None")
    if cos is None:
        return ()
    if cos.shape != (T, D) or sin.shape != (T, D):
        raise ValueError(f"{who}: tables must be ({T}, {D}); got {tuple(cos.shape)}, {tuple(sin.shape)}")
    return (("cos", cos, torch.float32), ("sin", sin, torch.float32))


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _check_launch(who: str, err: int) -> None:
    """Raise on what a TMA kernel's entry point returned: a cudaError_t, or
    minus the CUresult of a tensor map that failed to encode."""
    if err < 0:
        raise RuntimeError(f"{who}: a TMA tensor map failed to encode (CUresult {-err})")
    if err:
        raise RuntimeError(f"{who} kernel launch failed: CUDA error {err}")


def flash_fwd(
    q: torch.Tensor,  # (B, T, H, D), raw
    k: torch.Tensor,  # (B, T, D) or (B, T, Kv, D), q's dtype, already rotated
    v: torch.Tensor,  # k's shape and dtype
    cos: Optional[torch.Tensor],  # (T, D) fp32, or None: no rotary embedding
    sin: Optional[torch.Tensor],  # (T, D) fp32, or None
    window: int,  # -1 = global
    scale: float,
    return_lse: bool = False,
):
    """Launch the forward kernel of q's route (``flash_forms.route``: K1
    at bf16 or fp16 with D = 64, 128, 192 or 256, csrc/flash_xwide.cuh's
    forward at every head dim above 256, csrc/flash_f32x6.cuh's at fp32 at
    every head dim, on the pieces of k and v that ``f32x6_split`` makes here)
    on the current stream; returns o (B, T, H, D) in q's dtype, or with
    ``return_lse`` (o, lse2): lse2 (B, T*H) fp32 is the base-2 log-sum-exp of
    the logits q_rot k_rot^T * scale * log2(e), query head h against KV head h
    // (H / Kv). Counts its launches in ``flash_fwd.launches`` (those with
    the LSE also in ``flash_fwd.lse_launches``, those of the grouped form, Kv
    > 1, in ``flash_fwd.grouped_launches``, those above D = 256 at bf16 and
    fp16 in ``flash_fwd.xwide_launches``, those at fp32 in
    ``flash_fwd.f32x6_launches``, and of these two those whose qs the entry
    point writes first into ``fwd_scratch``, fp32 above 256 and every type
    above 512, in ``flash_fwd.streamed_launches``)."""
    kv = _kv_heads("flash_fwd", q, k)
    B, T, H, D = q.shape
    if v.shape != k.shape or k.shape[:2] != (B, T) or k.shape[-1] != D:
        raise ValueError(f"flash_fwd shapes: q {tuple(q.shape)} k {tuple(k.shape)} v {tuple(v.shape)}")
    route = forms.route("flash_fwd", q)
    tables = _tables("flash_fwd", cos, sin, T, D)
    _check_operands("flash_fwd", q.device, (("q", q, q.dtype), ("k", k, q.dtype), ("v", v, q.dtype), *tables))
    _check_window("flash_fwd", window)
    o = torch.empty_like(q)
    lse = torch.empty((B, T * H), dtype=torch.float32, device=q.device) if return_lse else None
    if route == "f32x6":
        forms._check_aligned("flash_fwd", q, o)
        k, v = f32x6_split(k), f32x6_split(v)
    qs = fwd_scratch(route, q, kv)
    err = _kernel(fwd_entry("flash", route, q.dtype))(
        D, q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(cos), _ptr(sin), o.data_ptr(), _ptr(lse),
        *(() if route == "wgmma" else (_ptr(qs),)), B, T, T, H, kv, window, scale,
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    _check_launch("flash_fwd", err)
    flash_fwd.launches += 1
    flash_fwd.grouped_launches += kv > 1
    flash_fwd.xwide_launches += route == "xwide"
    flash_fwd.f32x6_launches += route == "f32x6"
    flash_fwd.streamed_launches += qs is not None
    if return_lse:
        flash_fwd.lse_launches += 1
        return o, lse
    return o


flash_fwd.launches = 0
flash_fwd.lse_launches = 0
flash_fwd.grouped_launches = 0  # of them, the grouped form (Kv > 1: DiT, MMDiT)
flash_fwd.xwide_launches = 0  # of them, csrc/flash_xwide.cuh's forward (D > 256)
flash_fwd.f32x6_launches = 0  # of them, csrc/flash_f32x6.cuh's forward (fp32)
flash_fwd.streamed_launches = 0  # of those two, the instances that stream qs (fwd_scratch: fp32 > 256, D > 512)


def _check_backward(who: str, q, k, v, rows, stats, cos, sin, grouped: bool = False) -> tuple[int, int, int, int, str]:
    """The backward kernels' operands: q and every tensor of ``rows``
    (B, T, H, D), k and v (B, T, D) (``grouped``: or (B, T, Kv, D)), all in
    q's dtype, every tensor of ``stats`` (B, T*H) fp32, the tables (T, D) fp32
    (``grouped``: or both None); all contiguous on q's CUDA device. ``rows``
    and ``stats`` hold (name, tensor) pairs. Returns (B, T, H, Kv, q's route:
    ``flash_forms.route``)."""
    kv = _kv_heads(who, q, k)
    if not grouped and (k.ndim != 3 or cos is None):
        raise ValueError(f"{who} (K3a/K3b) takes MQA (k (B,T,D)) with rotary tables; got k {tuple(k.shape)}, "
                         f"tables {'none' if cos is None else 'given'} (flash_attention runs a windowed GQA site "
                         "per KV head, with identity tables where it has none)")
    B, T, H, D = q.shape
    shapes = [(v, k.shape), *((t, q.shape) for _, t in rows), *((t, (B, T * H)) for _, t in stats)]
    if k.shape[:2] != (B, T) or k.shape[-1] != D or any(t.shape != shape for t, shape in shapes):
        raise ValueError(f"{who} shapes: q {tuple(q.shape)} k {tuple(k.shape)} v {tuple(v.shape)} "
                         + " ".join(f"{n} {tuple(t.shape)}" for n, t in (*rows, *stats)))
    route = forms.route(who, q)
    tables = _tables(who, cos, sin, T, D)
    dt, f32 = q.dtype, torch.float32
    _check_operands(who, q.device, (("q", q, dt), ("k", k, dt), ("v", v, dt), *((n, t, dt) for n, t in rows),
                                    *((n, t, f32) for n, t in stats), *tables))
    return B, T, H, kv, route


def flash_bwd(
    q: torch.Tensor,  # (B, T, H, D), raw
    k: torch.Tensor,  # (B, T, D) or (B, T, Kv, D), q's dtype, already rotated
    v: torch.Tensor,  # k's shape and dtype
    o: torch.Tensor,  # (B, T, H, D), the forward's output
    lse: torch.Tensor,  # (B, T*H) fp32, the forward's base-2 LSE
    do: torch.Tensor,  # (B, T, H, D)
    cos: Optional[torch.Tensor],  # (T, D) fp32, or None: no rotary embedding
    sin: Optional[torch.Tensor],  # (T, D) fp32, or None
    scale: float,
):
    """Launch the global backward of q's form on the current stream. Returns
    (dq, dk_rot, dv): dq (B, T, H, D) in q's dtype and the raw q's frame,
    dk_rot (k's shape) fp32 still in the rotated frame, dv (k's shape) fp32.
    The wgmma library's entry point runs a pre-pass (qs, delta and the LSE in
    group-major order, into scratch allocated here), the sweep, whose dq
    atomics accumulate in an fp32 buffer, and a post-pass that un-rotates,
    scales and casts dq; it counts its launches in ``flash_bwd.launches``
    (those of the grouped form, Kv > 1, also in ``flash_bwd.grouped_launches``).
    At D > 64 (bf16), and at fp16 at every D, the sweep of q's type and head
    dim runs between the forms pre-pass and post-pass (counted in
    ``flash_forms``), the whole still one ``flash_bwd.launches``; at D = 320
    ... 512 that sweep is csrc/flash_xwide.cuh's dq and dk/dv pair
    (``xwide_bwd_dq``, ``xwide_bwd_dkv``). fp32 at D <= 512 runs the forms
    pre-pass, the split of its qs and do, csrc/flash_f32x6.cuh's pair and the
    forms post-pass, each counted on its own wrapper and not in
    ``flash_bwd.launches``. The forms family (every type above D = 512) runs
    its pre-pass, dq, dk/dv and post-pass kernels, each counted in
    ``flash_forms``."""
    B, T, H, kv, route = _check_backward("flash_bwd", q, k, v, (("o", o), ("do", do)), (("lse", lse),), cos, sin,
                                         grouped=True)
    if forms.route("flash_bwd_prep", q) == "forms":  # every form but bf16 at D = 64: the forms pre-pass and post-pass
        prep = scratch_prep(route, q, o, lse, do, cos, sin, kv, scale)
        dk = torch.empty(k.shape, dtype=torch.float32, device=q.device)
        dv = torch.empty_like(dk)
        _launch_sweep(route, "flash_bwd", k, v, prep, dk, dv, accumulate=False)
        wgmma = route in ("wgmma", "xwide")
        flash_bwd.launches += wgmma
        flash_bwd.grouped_launches += wgmma and kv > 1
        return forms.forms_bwd_post(prep, cos, sin, scale), dk, dv
    f32, dev = torch.float32, q.device
    rows = T * (H // kv)  # rows of one KV group
    pad = -(-rows // BWD_ROW_TILE) * BWD_ROW_TILE
    qs_g = torch.empty((B * kv, rows, HEAD_DIM), dtype=torch.bfloat16, device=dev)
    do_g = torch.empty_like(qs_g) if kv > 1 else None  # at MQA do is already in group-major order
    lse_g = torch.empty((B * kv, pad), dtype=f32, device=dev)
    delta_g = torch.empty_like(lse_g)
    dq_acc = torch.empty((B * kv, pad, HEAD_DIM), dtype=f32, device=dev)
    dq = torch.empty_like(q)
    dk = torch.empty(k.shape, dtype=f32, device=dev)
    dv = torch.empty(v.shape, dtype=f32, device=dev)
    err = _kernel("flash_bwd_bf16")(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), o.data_ptr(), lse.data_ptr(), _ptr(cos), _ptr(sin),
        qs_g.data_ptr(), _ptr(do_g), lse_g.data_ptr(), delta_g.data_ptr(), dq_acc.data_ptr(),
        dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        B, T, T, H, kv, scale, torch.cuda.current_stream(dev).cuda_stream,
    )
    _check_launch("flash_bwd", err)
    flash_bwd.launches += 1
    flash_bwd.grouped_launches += kv > 1
    return dq, dk, dv


flash_bwd.launches = 0
flash_bwd.grouped_launches = 0  # of them, the grouped form (Kv > 1)


class GlobalPrep(NamedTuple):
    """What the global backward's pre-pass writes (``flash_bwd_prep``) and its
    sweeps (``flash_bwd_sweep``) and post-pass (``flash_bwd_post``) read, in
    group-major order (B * Kv, T * G, ...), G = H / Kv: qs (in q's dtype,
    rotated and scaled by ``scale * log2(e)``), do (do itself at Kv == 1,
    which is already in that order), lse and delta (fp32, padded to
    ``BWD_ROW_TILE`` rows with +inf and 0), the fp32 dq buffer that every
    sweep adds into (the wgmma sweep's atomics; the forms dq kernel stores on
    the first sweep), and the site's (B, T, H, Kv); for the sweeps of
    csrc/flash_f32x6.cuh also ``pieces``, the bf16 pieces of qs and do
    (``f32x6_pieces``), else None."""

    qs: torch.Tensor
    do: torch.Tensor
    lse: torch.Tensor
    delta: torch.Tensor
    dq_acc: torch.Tensor
    shape: tuple
    pieces: Optional[tuple] = None


def flash_bwd_prep(
    q: torch.Tensor,  # (B, T, H, D), raw
    k: torch.Tensor,  # (B, T, D) or (B, T, Kv, D), q's dtype: the site's own keys (for their shape)
    v: torch.Tensor,  # k's shape and dtype
    o: torch.Tensor,  # (B, T, H, D), the forward's output
    lse: torch.Tensor,  # (B, T*H) fp32, the forward's base-2 LSE
    do: torch.Tensor,  # (B, T, H, D)
    cos: Optional[torch.Tensor],  # (T, D) fp32, or None: no rotary embedding
    sin: Optional[torch.Tensor],
    scale: float,
) -> GlobalPrep:
    """Launch the global backward's pre-pass of q's form on the current
    stream: qs, do and the LSE in group-major order, delta = rowsum(do * o),
    and the dq buffer zeroed. Counts the wgmma pre-pass's launches (bf16 at
    D = 64) in ``flash_bwd_prep.launches``, the forms one's (every other form;
    K2's sweep of a head dim above 64 reads it) in
    ``flash_forms.forms_bwd_prep.launches``; at fp32 with D <= 512 the
    scratch holds the pieces of qs and do too (``scratch_prep``)."""
    B, T, H, kv, route = _check_backward("flash_bwd_prep", q, k, v, (("o", o), ("do", do)), (("lse", lse),), cos,
                                         sin, grouped=True)
    if route == "forms":  # with the pieces of qs and do where the sweeps are csrc/flash_f32x6.cuh's
        return scratch_prep(forms.route("flash_bwd_sweep", q), q, o, lse, do, cos, sin, kv, scale)
    f32, dev = torch.float32, q.device
    rows = T * (H // kv)
    pad = -(-rows // BWD_ROW_TILE) * BWD_ROW_TILE
    qs_g = torch.empty((B * kv, rows, HEAD_DIM), dtype=torch.bfloat16, device=dev)
    lse_g = torch.empty((B * kv, pad), dtype=f32, device=dev)
    prep = GlobalPrep(qs_g, torch.empty_like(qs_g) if kv > 1 else do, lse_g, torch.empty_like(lse_g),
                      torch.empty((B * kv, pad, HEAD_DIM), dtype=f32, device=dev), (B, T, H, kv))
    err = _kernel("flash_bwd_prep_bf16")(
        q.data_ptr(), do.data_ptr(), o.data_ptr(), lse.data_ptr(), _ptr(cos), _ptr(sin), qs_g.data_ptr(),
        prep.do.data_ptr() if kv > 1 else None, lse_g.data_ptr(), prep.delta.data_ptr(), prep.dq_acc.data_ptr(),
        B, T, H, kv, scale, torch.cuda.current_stream(dev).cuda_stream,
    )
    _check_launch("flash_bwd_prep", err)
    flash_bwd_prep.launches += 1
    return prep


flash_bwd_prep.launches = 0


def _launch_sweep(route: str, who: str, k, v, prep: GlobalPrep, dk, dv, accumulate: bool) -> None:
    """Launch the global backward's sweep of ``route`` over the keys of k and
    v into ``prep.dq_acc`` and dk, dv: K2's sweep of qs's operand type (bf16
    or fp16) and head dim ("wgmma", checked here), or the dq and dk/dv
    kernels on the forms pre-pass's scratch (``scratch_sweeps``: "forms",
    "xwide", "f32x6"), whose dq kernel stores into ``prep.dq_acc`` (or with
    ``accumulate`` adds)."""
    if route != "wgmma":
        dq_kernel, dkv_kernel = scratch_sweeps(route)
        dq_kernel(k, v, prep, -1, None, accumulate)
        dkv_kernel(k, v, prep, dk, dv, -1, None, accumulate)
        return
    B, T, H, kv = prep.shape
    D = prep.qs.shape[-1]
    if k.shape != v.shape or k.shape[0] != B or k.ndim != (3 if kv == 1 else 4) or (kv > 1 and k.shape[2] != kv) \
            or k.shape[-1] != D or dk.shape != k.shape or dv.shape != k.shape:
        raise ValueError(f"{who} shapes: k {tuple(k.shape)} v {tuple(v.shape)} dk {tuple(dk.shape)} dv {tuple(dv.shape)}; "
                         f"want (B={B}, S, {'' if kv == 1 else f'{kv}, '}{D}) for {H} query heads")
    dev, dt, f32 = prep.qs.device, prep.qs.dtype, torch.float32
    _check_operands(who, dev, (("k", k, dt), ("v", v, dt), ("dk", dk, f32), ("dv", dv, f32)))
    err = _kernel(f"flash_bwd_sweep_{TYPE_SUFFIX[dt]}")(
        D, k.data_ptr(), v.data_ptr(), prep.qs.data_ptr(), prep.do.data_ptr(), prep.lse.data_ptr(),
        prep.delta.data_ptr(), prep.dq_acc.data_ptr(), dk.data_ptr(), dv.data_ptr(), B, T, k.shape[1], H, kv,
        int(accumulate), torch.cuda.current_stream(dev).cuda_stream,
    )
    _check_launch(who, err)


def flash_bwd_sweep(
    k: torch.Tensor,  # (B, S, D) or (B, S, Kv, D), qs's dtype, already rotated: the chunk of keys that is here
    v: torch.Tensor,  # k's shape and dtype
    prep: GlobalPrep,  # flash_bwd_prep's scratch
    dk: torch.Tensor,  # k's shape, fp32: the chunk's dk_rot (rotated frame)
    dv: torch.Tensor,  # k's shape, fp32
    accumulate: bool,
) -> None:
    """Launch the global backward's sweep over the keys of k and v on the
    current stream: dq adds into ``prep.dq_acc`` (the wgmma sweep's atomics;
    the forms dq kernel stores there unless ``accumulate``); dk and dv are
    stored, or with ``accumulate`` added into what they hold. Counts the
    wgmma sweep's launches (any head dim; above 256 csrc/flash_xwide.cuh's
    dq and dk/dv, each also in its own counter) in
    ``flash_bwd_sweep.launches``; the forms family launches its dq and dk/dv
    kernels, counted in ``flash_forms``, and fp32 at D <= 512
    csrc/flash_f32x6.cuh's, counted in ``f32x6_bwd_dq`` and
    ``f32x6_bwd_dkv``."""
    route = forms.route("flash_bwd_sweep", prep.qs)
    _launch_sweep(route, "flash_bwd_sweep", k, v, prep, dk, dv, accumulate)
    flash_bwd_sweep.launches += route in ("wgmma", "xwide")


flash_bwd_sweep.launches = 0


def _launch_scratch_pair(who: str, entry: str, operands: tuple, prep: GlobalPrep, outs, window: int,
                         halo: Optional[tuple], accumulate: bool) -> None:
    """Launch ``entry``, a dq or dk/dv kernel on the forms pre-pass's scratch
    with ``forms_bwd_dq``'s or ``forms_bwd_dkv``'s arguments without the type
    code, on ``operands`` (k, v, qs rows, do rows, as the kernel reads them)
    into ``outs`` (dq: the scratch's fp32 dq buffer; dk/dv: (dk, dv))."""
    B, T, H, kv = prep.shape
    err = _kernel(entry)(
        prep.qs.shape[-1], *(t.data_ptr() for t in operands), prep.lse.data_ptr(), prep.delta.data_ptr(),
        *(t.data_ptr() for t in outs), B, T, operands[0].shape[1], H, kv, prep.lse.shape[1], window,
        *forms._frame(halo), int(accumulate), torch.cuda.current_stream(operands[0].device).cuda_stream)
    _check_launch(who, err)


def _launch_xwide_pair(who: str, k, v, prep: GlobalPrep, outs, window: int, halo: Optional[tuple],
                       accumulate: bool) -> None:
    """Launch ``who`` (csrc/flash_xwide.cuh's dq or dk/dv kernel) of qs's
    operand type over the keys of k and v on the forms pre-pass's scratch."""
    forms._check_sweep(who, k, v, prep, () if who == "xwide_bwd_dq" else outs)
    _launch_scratch_pair(who, f"{who}_{TYPE_SUFFIX[prep.qs.dtype]}", (k, v, prep.qs, prep.do), prep, outs, window,
                         halo, accumulate)


def xwide_bwd_dq(k, v, prep: GlobalPrep, window: int, halo: Optional[tuple], accumulate: bool) -> None:
    """Launch csrc/flash_xwide.cuh's dq kernel of qs's operand type (bf16 or
    fp16, D = 320 ... 512) on the current stream over the keys of k and v, on
    the forms pre-pass's scratch: ``prep.dq_acc`` (fp32, group-major) gets ds
    k, stored, or with ``accumulate`` added to what it holds (the forms
    post-pass scales and un-rotates it); ``forms_bwd_dq``'s arguments.
    ``halo`` (g0, t_global): the halo slab's frame. Counts in
    ``xwide_bwd_dq.launches``; the calling wrapper counts its own."""
    _launch_xwide_pair("xwide_bwd_dq", k, v, prep, (prep.dq_acc,), window, halo, accumulate)
    xwide_bwd_dq.launches += 1


xwide_bwd_dq.launches = 0


def xwide_bwd_dkv(k, v, prep: GlobalPrep, dk, dv, window: int, halo: Optional[tuple], accumulate: bool) -> None:
    """Launch csrc/flash_xwide.cuh's dk/dv kernel of qs's operand type on the
    current stream over the keys of k and v, on the forms pre-pass's scratch:
    dk (rotated frame) and dv (k's shape, fp32) stored, or with
    ``accumulate`` added to; in the halo frame the slab rows outside the song
    get zeros; ``forms_bwd_dkv``'s arguments. Counts in
    ``xwide_bwd_dkv.launches``; the calling wrapper counts its own."""
    _launch_xwide_pair("xwide_bwd_dkv", k, v, prep, (dk, dv), window, halo, accumulate)
    xwide_bwd_dkv.launches += 1


xwide_bwd_dkv.launches = 0


def f32x6_split(x: torch.Tensor) -> torch.Tensor:
    """Launch csrc/flash_f32x6.cuh's split on the current stream: the bf16
    pieces of x (..., D) fp32, contiguous, D a multiple of 64, as rows (...,
    3 D) [b0 | b1 | b2] with x = b0 + b1 + b2 exactly (``f32x6_split_reference``
    is its plain version). Counts in ``f32x6_split.launches``."""
    D = x.shape[-1]
    _check_operands("f32x6_split", x.device, (("x", x, torch.float32),))
    forms._check_aligned("f32x6_split", x)
    out = torch.empty((*x.shape[:-1], 3 * D), dtype=torch.bfloat16, device=x.device)
    err = _kernel("f32x6_split")(x.data_ptr(), out.data_ptr(), x.numel() // D, D,
                                 torch.cuda.current_stream(x.device).cuda_stream)
    _check_launch("f32x6_split", err)
    f32x6_split.launches += 1
    return out


f32x6_split.launches = 0


def f32x6_split_reference(x: torch.Tensor) -> torch.Tensor:
    """Plain version of ``f32x6_split``: b0 = x rounded to bf16 (to nearest
    even), b1 = the rest rounded, b2 = what is left, exact in bf16; (...,
    3 D) bf16."""
    x = x.float()
    b0 = x.to(torch.bfloat16)
    r = x - b0.float()
    b1 = r.to(torch.bfloat16)
    return torch.cat([b0, b1, (r - b1.float()).to(torch.bfloat16)], dim=-1)


def f32x6_pieces(prep: GlobalPrep) -> GlobalPrep:
    """``prep`` with the bf16 pieces of its qs and do (``f32x6_split``), which
    csrc/flash_f32x6.cuh's pair reads in their place."""
    return prep._replace(pieces=(f32x6_split(prep.qs), f32x6_split(prep.do)))


def scratch_prep(route: str, q, o, lse, do, cos, sin, kv: int, scale: float) -> GlobalPrep:
    """The forms pre-pass's scratch for the sweeps of ``route``
    (``scratch_sweeps``): with the pieces of qs and do for "f32x6"."""
    prep = forms.forms_bwd_prep(q, o, lse, do, cos, sin, kv, scale)
    return f32x6_pieces(prep) if route == "f32x6" else prep


def _launch_f32x6_pair(who: str, k, v, prep: GlobalPrep, outs, window: int, halo: Optional[tuple],
                       accumulate: bool) -> None:
    """Launch ``who`` (csrc/flash_f32x6.cuh's dq or dk/dv kernel) over the keys
    of k and v, split here, on the forms pre-pass's scratch with its pieces."""
    if prep.pieces is None:
        raise ValueError(f"{who}: the scratch holds no pieces of qs and do (scratch_prep with route 'f32x6')")
    forms._check_sweep(who, k, v, prep, () if who == "f32x6_bwd_dq" else outs)
    _launch_scratch_pair(who, who, (f32x6_split(k), f32x6_split(v), *prep.pieces), prep, outs, window, halo,
                         accumulate)


def f32x6_bwd_dq(k, v, prep: GlobalPrep, window: int, halo: Optional[tuple], accumulate: bool) -> None:
    """Launch csrc/flash_f32x6.cuh's dq kernel (fp32, D = 64 ... 512, each
    product as six bf16 products) on the current stream over the keys of k
    and v, on the forms pre-pass's scratch with the pieces of qs and do
    (``scratch_prep``): ``prep.dq_acc`` (fp32, group-major) gets ds k, stored,
    or with ``accumulate`` added to what it holds (the forms post-pass scales
    and un-rotates it); ``forms_bwd_dq``'s arguments. Splits k and v first.
    Counts in ``f32x6_bwd_dq.launches``, those above D = 256 (the instance
    with one piece of qs and do resident) also in ``wide_launches``."""
    _launch_f32x6_pair("f32x6_bwd_dq", k, v, prep, (prep.dq_acc,), window, halo, accumulate)
    f32x6_bwd_dq.launches += 1
    f32x6_bwd_dq.wide_launches += prep.qs.shape[-1] > forms.WGMMA_HEAD_DIMS[-1]


f32x6_bwd_dq.launches = 0
f32x6_bwd_dq.wide_launches = 0  # of them, D = 320 ... 512


def f32x6_bwd_dkv(k, v, prep: GlobalPrep, dk, dv, window: int, halo: Optional[tuple], accumulate: bool) -> None:
    """Launch csrc/flash_f32x6.cuh's dk/dv kernel on the current stream over
    the keys of k and v, on the forms pre-pass's scratch with its pieces: dk
    (rotated frame) and dv (k's shape, fp32) stored, or with ``accumulate``
    added to; in the halo frame the slab rows outside the song get zeros;
    ``forms_bwd_dkv``'s arguments. Splits k and v first. Counts in
    ``f32x6_bwd_dkv.launches``, those above D = 256 (the instance with one
    piece of k and v resident, its columns in two chunks) also in
    ``wide_launches``."""
    _launch_f32x6_pair("f32x6_bwd_dkv", k, v, prep, (dk, dv), window, halo, accumulate)
    f32x6_bwd_dkv.launches += 1
    f32x6_bwd_dkv.wide_launches += prep.qs.shape[-1] > forms.WGMMA_HEAD_DIMS[-1]


f32x6_bwd_dkv.launches = 0
f32x6_bwd_dkv.wide_launches = 0  # of them, D = 320 ... 512


def scratch_sweeps(route: str) -> tuple:
    """(dq, dk/dv) of ``route`` on the forms pre-pass's scratch, both with
    ``forms_bwd_dq``'s and ``forms_bwd_dkv``'s arguments: the forms family's
    ("forms"), csrc/flash_xwide.cuh's ("xwide") or csrc/flash_f32x6.cuh's
    ("f32x6", on ``scratch_prep``'s pieces)."""
    return {"forms": (forms.forms_bwd_dq, forms.forms_bwd_dkv), "xwide": (xwide_bwd_dq, xwide_bwd_dkv),
            "f32x6": (f32x6_bwd_dq, f32x6_bwd_dkv)}[route]


def flash_bwd_post(
    prep: GlobalPrep,
    cos: Optional[torch.Tensor],  # (T, D) fp32, the pre-pass's tables, or None
    sin: Optional[torch.Tensor],
    scale: float,
) -> torch.Tensor:
    """Launch the global backward's post-pass on the current stream, after the
    last sweep: dq (B, T, H, D) in qs's dtype = scale * the un-rotated dq
    buffer, in the raw q's frame. Counts the wgmma post-pass's launches (bf16
    at D = 64) in ``flash_bwd_post.launches``, the forms one's (every other
    form; it serves K2's sweep of a head dim above 64 too) in
    ``flash_forms``."""
    if forms.route("flash_bwd_post", prep.qs) == "forms":
        return forms.forms_bwd_post(prep, cos, sin, scale)
    B, T, H, kv = prep.shape
    dev = prep.qs.device
    _check_operands("flash_bwd_post", dev, _tables("flash_bwd_post", cos, sin, T, HEAD_DIM))
    dq = torch.empty((B, T, H, HEAD_DIM), dtype=torch.bfloat16, device=dev)
    err = _kernel("flash_bwd_post_bf16")(prep.dq_acc.data_ptr(), _ptr(cos), _ptr(sin), dq.data_ptr(), B, T, H, kv,
                                         scale, torch.cuda.current_stream(dev).cuda_stream)
    _check_launch("flash_bwd_post", err)
    flash_bwd_post.launches += 1
    return dq


flash_bwd_post.launches = 0


def ring_merge(
    o_acc: Optional[torch.Tensor],  # (B, T, H, D) fp32, or None on the first hop
    lse_acc: Optional[torch.Tensor],  # (B, T*H) fp32, or None on the first hop
    o_j: torch.Tensor,  # (B, T, H, D): this hop's output, normalised over its chunk of keys
    lse_j: torch.Tensor,  # (B, T*H) fp32: this hop's base-2 LSE
    last: bool,
):
    """Launch the ring's merge of o_j's form on the current stream
    (``csrc/ring_merge.cu``, or the forms instance): the exact fold of one
    hop's partial into the accumulators. Returns (o_acc, lse, o): o_acc
    updated in place (allocated on the first hop; not written on the last),
    lse a new (B, T*H) fp32 tensor, and on the ``last`` hop o, the merged
    output in o_j's dtype (else None). Counts the wgmma form's launches in
    ``ring_merge.launches``, the forms one's in ``flash_forms``."""
    who = "ring_merge"
    B, T, H, D = o_j.shape
    if lse_j.shape != (B, T * H) or (o_acc is None) != (lse_acc is None) or (
            o_acc is not None and (o_acc.shape != o_j.shape or lse_acc.shape != lse_j.shape)):
        raise ValueError(f"{who} shapes: o_j {tuple(o_j.shape)} lse_j {tuple(lse_j.shape)} o_acc "
                         f"{None if o_acc is None else tuple(o_acc.shape)} lse_acc "
                         f"{None if lse_acc is None else tuple(lse_acc.shape)}; both accumulators or neither")
    use_forms = forms.route(who, o_j) == "forms"
    f32 = torch.float32
    accumulators = () if o_acc is None else (("o_acc", o_acc, f32), ("lse_acc", lse_acc, f32))
    _check_operands(who, o_j.device, (("o_j", o_j, o_j.dtype), ("lse_j", lse_j, f32), *accumulators))
    first = o_acc is None
    if first:
        o_acc = torch.empty(o_j.shape, dtype=f32, device=o_j.device)
    lse = torch.empty_like(lse_j)
    o = torch.empty_like(o_j) if last else None
    if use_forms:
        forms.forms_ring_merge(o_acc, lse_acc, o_j, lse_j, lse, o)
        return o_acc, lse, o
    err = _kernel("ring_merge_bf16")(o_acc.data_ptr(), None if first else lse_acc.data_ptr(), o_j.data_ptr(),
                                     lse_j.data_ptr(), lse.data_ptr(), _ptr(o), B * T * H,
                                     torch.cuda.current_stream(o_j.device).cuda_stream)
    _check_launch(who, err)
    ring_merge.launches += 1
    return o_acc, lse, o


ring_merge.launches = 0


def ring_merge_reference(o_acc: Optional[torch.Tensor], lse_acc: Optional[torch.Tensor], o_j: torch.Tensor,
                         lse_j: torch.Tensor):
    """Plain version of ``ring_merge`` in fp32: (o_acc, lse), the merged
    output (B, T, H, D) and LSE (B, T*H); on the first hop (accumulators None)
    o_j and lse_j themselves."""
    if o_acc is None:
        return o_j.float(), lse_j.float()
    B, T, H, _ = o_j.shape
    m = torch.maximum(lse_acc, lse_j)
    lse = m + torch.log2(torch.exp2(lse_acc - m) + torch.exp2(lse_j - m))
    w_acc, w_j = (torch.exp2(part - lse).reshape(B, T, H, 1) for part in (lse_acc, lse_j))
    return o_acc * w_acc + o_j.float() * w_j, lse


class WindowedPrep(NamedTuple):
    """What the windowed pair's pre-pass writes (``windowed_prep``) and
    ``flash_bwd_dkv`` (or the halo pair's ``halo_bwd_dkv``) reads: qs (B, T*H,
    D) in the operands' dtype (bf16 or fp16), the raw q rotated (or, without tables, the rotated q as it came)
    and scaled by ``scale * log2(e)`` with the forward's arithmetic; lse and
    delta (B, pad) fp32, pad = T*H rounded up to ``WINDOWED_ROW_PAD``, the pad
    rows +inf and 0."""

    qs: torch.Tensor
    lse: torch.Tensor
    delta: torch.Tensor


def _windowed_pad(rows: int) -> int:
    return -(-rows // WINDOWED_ROW_PAD) * WINDOWED_ROW_PAD


def _check_prep(who: str, prep: WindowedPrep, device, dtype, B: int, rows: int, D: int) -> None:
    """The pre-pass scratch as the dk/dv kernels of ``dtype`` operands take
    it: qs (B, rows, D) of ``dtype``, lse and delta (B, rows padded to
    ``WINDOWED_ROW_PAD``) fp32, all contiguous on ``device``."""
    pad = _windowed_pad(rows)
    shapes = ((prep.qs, (B, rows, D)), (prep.lse, (B, pad)), (prep.delta, (B, pad)))
    if any(t.shape != shape for t, shape in shapes):
        raise ValueError(f"{who} shapes: qs {tuple(prep.qs.shape)} lse {tuple(prep.lse.shape)} delta "
                         f"{tuple(prep.delta.shape)}; want qs {(B, rows, D)}, lse and delta {(B, pad)}")
    _check_operands(who, device, (("qs", prep.qs, dtype), ("lse", prep.lse, torch.float32),
                                  ("delta", prep.delta, torch.float32)))


def windowed_prep(
    q: torch.Tensor,  # (B, T, H, D) bf16 or fp16, raw
    o: torch.Tensor,  # (B, T, H, D) q's dtype, the forward's output
    lse: torch.Tensor,  # (B, T*H) fp32, the forward's base-2 LSE
    do: torch.Tensor,  # (B, T, H, D) q's dtype
    cos: Optional[torch.Tensor],  # (T, D) fp32, or None: q arrives rotated (the halo pair)
    sin: Optional[torch.Tensor],  # (T, D) fp32, or None
    scale: float,
) -> WindowedPrep:
    """Launch the windowed pair's pre-pass of q's dtype and head dim on the
    current stream (the first launch of ``flash_bwd_dq``, and without tables of
    ``halo_bwd_dq``): one sweep over the rows that writes qs once, delta =
    rowsum(do * o) and the padded LSE; no fp32 dq buffer. Operands as those
    wrappers take them, checked there."""
    B, T, H, D = q.shape
    pad = _windowed_pad(T * H)
    prep = WindowedPrep(torch.empty((B, T * H, D), dtype=q.dtype, device=q.device),
                        torch.empty((B, pad), dtype=torch.float32, device=q.device),
                        torch.empty((B, pad), dtype=torch.float32, device=q.device))
    err = _kernel(f"flash_bwd_windowed_prep_{TYPE_SUFFIX[q.dtype]}")(
        D, q.data_ptr(), do.data_ptr(), o.data_ptr(), lse.data_ptr(), _ptr(cos), _ptr(sin),
        prep.qs.data_ptr(), prep.lse.data_ptr(), prep.delta.data_ptr(),
        B, T, H, pad, scale, torch.cuda.current_stream(q.device).cuda_stream,
    )
    _check_launch("windowed_prep", err)
    return prep


def flash_bwd_dq(
    q: torch.Tensor,  # (B, T, H, D), raw
    k: torch.Tensor,  # (B, T, D), q's dtype, already rotated
    v: torch.Tensor,  # (B, T, D), q's dtype
    o: torch.Tensor,  # (B, T, H, D), the forward's output
    lse: torch.Tensor,  # (B, T*H) fp32, the forward's base-2 LSE
    do: torch.Tensor,  # (B, T, H, D)
    cos: torch.Tensor,  # (T, D) fp32
    sin: torch.Tensor,  # (T, D) fp32
    window: int,  # -1 = global
    scale: float,
):
    """Launch the windowed pre-pass and the dq kernel of q's form (K3a at bf16
    or fp16 with D = 64, 128, 192 or 256; with D = 320 ... 512 the forms
    pre-pass, csrc/flash_xwide.cuh's dq kernel and the forms post-pass; at
    fp32 with D <= 512 the same with csrc/flash_f32x6.cuh's) on the current
    stream. Returns (dq, prep):
    dq (B, T, H, D) in q's dtype and the raw q's frame, written once per row
    (the same bits from run to run), and
    the pre-pass's scratch, which ``flash_bwd_dkv`` takes (``WindowedPrep``:
    qs, the padded LSE, delta; the forms family's pre-pass, dq kernel and
    post-pass leave a ``GlobalPrep``, as do the forms pre-pass and post-pass
    around the wgmma dq kernels above 256 and at fp32). Counts the wgmma dq
    kernel's launches in ``flash_bwd_dq.launches`` (the fp32 pair's in
    ``f32x6_bwd_dq.launches`` alone), the forms kernels' in
    ``flash_forms``."""
    B, T, H, _, route = _check_backward("flash_bwd_dq", q, k, v, (("o", o), ("do", do)), (("lse", lse),), cos,
                                        sin)
    _check_window("flash_bwd_dq", window)
    if route != "wgmma":  # the forms pre-pass and post-pass around the forms, xwide or f32x6 dq kernel
        prep = scratch_prep(route, q, o, lse, do, cos, sin, 1, scale)
        scratch_sweeps(route)[0](k, v, prep, window, None, accumulate=False)
        flash_bwd_dq.launches += route == "xwide"
        return forms.forms_bwd_post(prep, cos, sin, scale), prep
    prep = windowed_prep(q, o, lse, do, cos, sin, scale)
    dq = torch.empty_like(q)
    err = _kernel(f"flash_bwd_dq_{TYPE_SUFFIX[q.dtype]}")(
        q.shape[-1], k.data_ptr(), v.data_ptr(), do.data_ptr(), prep.qs.data_ptr(), prep.lse.data_ptr(),
        prep.delta.data_ptr(), cos.data_ptr(), sin.data_ptr(), dq.data_ptr(),
        B, T, T, H, prep.lse.shape[1], window, scale, torch.cuda.current_stream(q.device).cuda_stream,
    )
    _check_launch("flash_bwd_dq", err)
    flash_bwd_dq.launches += 1
    return dq, prep


flash_bwd_dq.launches = 0


def flash_bwd_dkv(
    k: torch.Tensor,  # (B, T, D), do's dtype, already rotated
    v: torch.Tensor,  # (B, T, D), do's dtype
    do: torch.Tensor,  # (B, T, H, D)
    prep,  # flash_bwd_dq's scratch: a WindowedPrep, or the forms family's GlobalPrep
    window: int,  # -1 = global
):
    """Launch the windowed dk/dv kernel of do's form on the current stream.
    Returns (dk_rot, dv), both (B, T, D) fp32, dk_rot still in the rotated
    frame, each row written once. Counts the wgmma kernel's launches in
    ``flash_bwd_dkv.launches`` (the fp32 pair's in ``f32x6_bwd_dkv.launches``
    alone), the forms one's in ``flash_forms``."""
    who = "flash_bwd_dkv"
    if do.ndim != 4 or k.ndim != 3:
        raise ValueError(f"{who} (K3b) takes MQA: k (B,T,D), do (B,T,H,D); got k {tuple(k.shape)}, do {tuple(do.shape)}")
    B, T, H, D = do.shape
    if k.shape != (B, T, D) or v.shape != (B, T, D):
        raise ValueError(f"{who} shapes: k {tuple(k.shape)} v {tuple(v.shape)} do {tuple(do.shape)}")
    route = forms.route(who, do)
    f32 = torch.float32
    _check_operands(who, do.device, (("do", do, do.dtype), ("k", k, do.dtype), ("v", v, do.dtype)))
    _check_window(who, window)
    dk = torch.empty(k.shape, dtype=f32, device=do.device)
    dv = torch.empty(v.shape, dtype=f32, device=do.device)
    if route != "wgmma":  # on the forms pre-pass's scratch
        forms.check_prep(who, prep, B, T, H, 1)
        scratch_sweeps(route)[1](k, v, prep, dk, dv, window, None, accumulate=False)
        flash_bwd_dkv.launches += route == "xwide"
        return dk, dv
    _check_prep(who, prep, do.device, do.dtype, B, T * H, D)
    err = _kernel(f"flash_bwd_dkv_{TYPE_SUFFIX[do.dtype]}")(
        D, k.data_ptr(), v.data_ptr(), do.data_ptr(), prep.qs.data_ptr(), prep.lse.data_ptr(), prep.delta.data_ptr(),
        dk.data_ptr(), dv.data_ptr(), B, T, T, H, prep.lse.shape[1], window,
        torch.cuda.current_stream(do.device).cuda_stream,
    )
    _check_launch(who, err)
    flash_bwd_dkv.launches += 1
    return dk, dv


flash_bwd_dkv.launches = 0


def rotated_k(k: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """k (B, S, D) or (B, S, Kv, D) with the rotary embedding applied, as the
    kernels take it: k is H / Kv times smaller than q, so it is rotated once
    outside, in fp32."""
    return apply_rope(k.float(), cos, sin).to(k.dtype)


@torch.library.custom_op("osufusion_tpu_torch::flash_attention", mutates_args=())
def flash_attention_op(
    q: torch.Tensor,  # (B, T, H, D) raw
    k: torch.Tensor,  # (B, T, D) (MQA) or (B, T, Kv, D), raw
    v: torch.Tensor,  # k's shape
    cos: Optional[torch.Tensor],  # (T, D) fp32, or None: no rotary embedding; the tables get no gradient
    sin: Optional[torch.Tensor],
    window: int,  # -1 = global
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Self-attention, with rotary embedding when given tables, differentiable
    in q, k and v. Returns (o, lse2, k_rot): the backward's residuals beside q
    and v, so a rematerialisation policy that keeps this op's outputs never
    runs the forward again; lse2 and k_rot are not differentiable, and k_rot
    is empty without tables (the backward then keeps k itself). CUDA tensors
    (contiguous, of a form that a kernel takes, or the wrappers raise) go
    forward through ``flash_fwd`` with its LSE and backward through
    ``flash_bwd`` (global) or ``flash_bwd_dq`` and ``flash_bwd_dkv``
    (windowed, MQA with tables), each of which launches the wgmma kernel or
    the forms kernels by the operands' form; CPU tensors through the plain
    versions of the same. Every cast in here is explicit, so it computes the
    same under ``torch.autocast``."""
    k_rot = k if cos is None else rotated_k(k, cos, sin)
    if q.is_cuda:
        o, lse = flash_fwd(q, k_rot, v, cos, sin, window, q.shape[-1] ** -0.5, return_lse=True)
    else:
        o, lse = flash_fwd_lse_reference(q, k_rot, v, cos, sin, window)
    return o.to(q.dtype), lse, k.new_empty(0) if cos is None else k_rot


@flash_attention_op.register_fake
def _(q, k, v, cos, sin, window):
    B, T, H, _ = q.shape
    return (torch.empty_like(q), q.new_empty((B, T * H), dtype=torch.float32),
            k.new_empty(0) if cos is None else torch.empty_like(k))


def _save_residuals(ctx, inputs, output) -> None:
    q, k, v, cos, sin, window = inputs
    o, lse, k_rot = output
    ctx.save_for_backward(q, k if cos is None else k_rot, v, o, lse, cos, sin)
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
            dq, prep = flash_bwd_dq(q, k_rot, v, o, lse, do, cos, sin, ctx.window, scale)
            dk_rot, dv = flash_bwd_dkv(k_rot, v, do, prep, ctx.window)
    else:
        dq = flash_bwd_dq_reference(q, k_rot, v, o, lse, do, cos, sin, ctx.window)
        dk_rot, dv = flash_bwd_dkv_reference(q, k_rot, v, o, lse, do, cos, sin, ctx.window)
    # adjoint of k's rotation, fp32 on the small tensor
    dk = dk_rot if cos is None else unapply_rope(dk_rot, cos, sin)
    return dq.to(q.dtype), dk.to(k_rot.dtype), dv.to(v.dtype), None, None, None


flash_attention_op.register_autograd(_attention_backward, setup_context=_save_residuals)


def needs_gradient(*tensors: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def flash_attention(
    q: torch.Tensor,  # (B, T, H, D), unrotated
    k: torch.Tensor,  # (B, S, Kv, D), unrotated
    v: torch.Tensor,  # (B, S, Kv, D)
    window: int | None,
    rope: Optional[tuple],  # (cos, sin) tables (T, D) fp32, or None: no rotary embedding
) -> torch.Tensor:
    """Self-attention (S == T, H % Kv == 0, else ValueError) with rotary
    embedding when given tables, windowed to +/- window/2 when the window is
    shorter than the sequence. Query head h reads KV head h // (H / Kv): MQA,
    GQA and full MHA alike. Under a gradient it is ``flash_attention_op``: the
    kernels for CUDA tensors and their plain versions for CPU tensors. The
    windowed backward kernels take MQA with rotary tables, so a windowed site
    with Kv > 1 runs, on both devices, once per KV head on that head's query
    heads (as ``osufusion_tpu/ops/pallas_attention.py::flash_attention`` does)
    and a windowed site without tables gets identity tables (cos = 1, sin =
    0, which rotate exactly). Without a gradient it is the forward kernel alone
    and takes CUDA tensors only, of a form that a kernel takes
    (``flash_forms.attention_form``)."""
    B, T, H, D = q.shape
    S, Kv = k.shape[1], k.shape[2]
    if S != T or H % Kv:
        raise ValueError(f"flash kernels take self-attention with H % Kv == 0; got H={H}, Kv={Kv}, S={S}, T={T}")
    # a window that covers the whole sequence is global attention
    window = -1 if window is None or S <= window else window
    grad = needs_gradient(q, k, v)
    if grad and window >= 0 and Kv > 1:
        G = H // Kv
        return torch.cat([flash_attention(q[:, :, g * G : (g + 1) * G], k[:, :, g : g + 1], v[:, :, g : g + 1], window, rope)
                          for g in range(Kv)], dim=2)
    if grad and window >= 0 and rope is None:
        rope = (torch.ones((T, D), dtype=torch.float32, device=q.device),
                torch.zeros((T, D), dtype=torch.float32, device=q.device))
    cos, sin = (None, None) if rope is None else (t.contiguous() for t in rope)
    q = q.contiguous()
    k_in, v_in = (k.reshape(B, S, D), v.reshape(B, S, D)) if Kv == 1 else (k, v)
    k_in, v_in = k_in.contiguous(), v_in.contiguous()
    if grad:
        return flash_attention_op(q, k_in, v_in, cos, sin, window)[0]
    if not q.is_cuda:
        raise ValueError(f"flash_attention runs the CUDA kernel; got a tensor on {q.device}")
    k_rot = k_in if rope is None else rotated_k(k_in, cos, sin)
    return flash_fwd(q, k_rot, v_in, cos, sin, window, D**-0.5)


def flash_attention_reference(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, window: int | None, rope: Optional[tuple]
) -> torch.Tensor:
    """Plain PyTorch version of ``flash_attention``: ``apply_rope`` on q and k
    (when given tables), then the grouped attention math with a float32
    softmax, in query chunks; the function of the JAX package's XLA route,
    ``ops/attention.py::xla_attention``."""
    from osufusion_tpu_torch.ops.attention import xla_attention

    return xla_attention(q, k, v, window, rope)


# query rows / keys per step of the plain training versions: bounds their
# logits to (B, chunk, H, keys in reach) however long the sequence is
REFERENCE_CHUNK = 512


def _scaled_rotated_q(q: torch.Tensor, cos: Optional[torch.Tensor], sin: Optional[torch.Tensor]) -> torch.Tensor:
    """qs = rope(q) * D^-0.5 * log2(e) in fp32 (without tables, q * D^-0.5 *
    log2(e)): what the kernels hold (there rounded to bf16)."""
    qf = q.float() if cos is None else apply_rope(q.float(), cos, sin)
    return qf * (q.shape[-1] ** -0.5 * LOG2E)


def _unrotated(g: torch.Tensor, cos: Optional[torch.Tensor], sin: Optional[torch.Tensor]) -> torch.Tensor:
    return g if cos is None else unapply_rope(g, cos, sin)


# The plain versions at Kv > 1 (k of shape (B, S, Kv, D)): each KV head and
# its group of G = H / Kv query heads is an MQA problem of its own, so the
# group is folded into the batch, (B, T, H, ...) -> (B * Kv, T, G, ...), the
# MQA arithmetic runs, and the result is unfolded. Query head h = kv * G + j.
def _fold_heads(x: torch.Tensor, kv: int) -> torch.Tensor:
    B, T, H, *rest = x.shape
    return x.reshape(B, T, kv, H // kv, *rest).transpose(1, 2).reshape(B * kv, T, H // kv, *rest)


def _unfold_heads(x: torch.Tensor, kv: int) -> torch.Tensor:
    BK, T, G, *rest = x.shape
    return x.reshape(BK // kv, kv, T, G, *rest).transpose(1, 2).reshape(BK // kv, T, kv * G, *rest).contiguous()


def _fold_keys(k: torch.Tensor) -> torch.Tensor:
    B, S, kv, D = k.shape
    return k.transpose(1, 2).reshape(B * kv, S, D)


def _unfold_keys(k: torch.Tensor, kv: int) -> torch.Tensor:
    BK, S, D = k.shape
    return k.reshape(BK // kv, kv, S, D).transpose(1, 2).contiguous()


def _fold_stats(lse: torch.Tensor, kv: int, T: int) -> torch.Tensor:
    B = lse.shape[0]
    return _fold_heads(lse.reshape(B, T, -1), kv).reshape(B * kv, -1)


def _unfold_stats(lse: torch.Tensor, kv: int, T: int) -> torch.Tensor:
    return _unfold_heads(lse.reshape(lse.shape[0], T, -1), kv).reshape(lse.shape[0] // kv, -1)


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
    k_rot: torch.Tensor,  # (B, S, D) or (B, S, Kv, D), already rotated
    v: torch.Tensor,  # k_rot's shape
    cos: Optional[torch.Tensor],  # (T, D), or None: no rotary embedding
    sin: Optional[torch.Tensor],
    window: int = -1,
):
    """Plain version of ``flash_fwd(..., return_lse=True)`` in fp32:
    (o (B, T, H, D), lse2 (B, T*H)), the logits in the exp2 domain."""
    T, kv = q.shape[1], 1 if k_rot.ndim == 3 else k_rot.shape[2]
    if k_rot.ndim == 4:
        q, k_rot, v = _fold_heads(q, kv), _fold_keys(k_rot), _fold_keys(v)
    o, lse = forward_chunks(_scaled_rotated_q(q, cos, sin), k_rot, v, _query_chunks(T, k_rot.shape[1], window, q.device))
    return (_unfold_heads(o, kv), _unfold_stats(lse, kv, T)) if kv > 1 else (o, lse)


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


def _grouped_backward(fn, q, k_rot, v, o, lse, do, cos, sin, *args):
    """``fn`` (a plain backward of MQA operands) at Kv = k_rot.shape[2] KV
    heads, by folding each group into the batch: its outputs, dq in q's layout
    and dk, dv in k_rot's."""
    kv, T = k_rot.shape[2], q.shape[1]
    out = fn(_fold_heads(q, kv), _fold_keys(k_rot), _fold_keys(v), _fold_heads(o, kv), _fold_stats(lse, kv, T),
             _fold_heads(do, kv), cos, sin, *args)
    return tuple(_unfold_heads(x, kv) if x.ndim == 4 else _unfold_keys(x, kv) for x in out)


def flash_bwd_dq_reference(
    q: torch.Tensor,  # (B, T, H, D) raw
    k_rot: torch.Tensor,  # (B, S, D) or (B, S, Kv, D), already rotated
    v: torch.Tensor,  # k_rot's shape
    o: torch.Tensor,  # (B, T, H, D)
    lse: torch.Tensor,  # (B, T*H) base-2
    do: torch.Tensor,  # (B, T, H, D)
    cos: Optional[torch.Tensor],  # (T, D), or None: no rotary embedding
    sin: Optional[torch.Tensor],
    window: int,  # -1 = global
) -> torch.Tensor:
    """Plain version of ``flash_bwd_dq`` in fp32: dq in the raw q's frame."""
    if k_rot.ndim == 4:
        return _grouped_backward(lambda *a: (flash_bwd_dq_reference(*a),), q, k_rot, v, o, lse, do, cos, sin, window)[0]
    dq_rot = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    for rows, _, _, k_c, _, _, ds in _backward_chunks(q, k_rot, v, o, lse, do, cos, sin, window):
        dq_rot[:, rows] = torch.einsum("bths,bsd->bthd", ds, k_c) * q.shape[-1] ** -0.5
    return _unrotated(dq_rot, cos, sin)


def flash_bwd_dkv_reference(q, k_rot, v, o, lse, do, cos, sin, window: int):
    """Plain version of ``flash_bwd_dkv`` in fp32, on the operands of
    ``flash_bwd_dq_reference``: (dk_rot, still in the rotated frame, dv)."""
    if k_rot.ndim == 4:
        return _grouped_backward(flash_bwd_dkv_reference, q, k_rot, v, o, lse, do, cos, sin, window)
    dk_rot = torch.zeros(k_rot.shape, dtype=torch.float32, device=q.device)
    dv = torch.zeros_like(dk_rot)
    for _, keys, qs_c, _, do_c, p, ds in _backward_chunks(q, k_rot, v, o, lse, do, cos, sin, window):
        dv[:, keys] += torch.einsum("bths,bthd->bsd", p, do_c)
        dk_rot[:, keys] += torch.einsum("bths,bthd->bsd", ds, qs_c)
    return dk_rot * LN2, dv


def flash_bwd_reference(
    q: torch.Tensor,  # (B, T, H, D) raw
    k_rot: torch.Tensor,  # (B, S, D) or (B, S, Kv, D), already rotated
    v: torch.Tensor,  # k_rot's shape
    o: torch.Tensor,  # (B, T, H, D)
    lse: torch.Tensor,  # (B, T*H) base-2
    do: torch.Tensor,  # (B, T, H, D)
    cos: Optional[torch.Tensor],  # (T, D), or None: no rotary embedding
    sin: Optional[torch.Tensor],
):
    """Plain version of ``flash_bwd`` in fp32: the kernel's arithmetic, KV tile
    by KV tile, from the LSE. Returns (dq in the raw q's frame, dk_rot, dv)."""
    if k_rot.ndim == 4:
        return _grouped_backward(flash_bwd_reference, q, k_rot, v, o, lse, do, cos, sin)
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
    return _unrotated(dq_rot, cos, sin), dk_rot, dv
