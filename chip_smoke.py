"""Smoke run of the PyTorch port (``osufusion_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printed as it ends (with the seconds since the start); any
failure raises and the exit code is not 0:

1. Device: name, power limit, versions; build the flash kernels from
   ``osufusion_tpu_torch/csrc`` with nvcc for sm_90a, all sources at once.
2. Forward kernel vs its plain PyTorch version at the serving path's attention
   shapes (B=2 under CFG, H=16, D=64, bf16): relative L2 and largest error
   against their bounds, a planted fault that the bound must catch,
   CUDA-event times, and at the level-0 shape rope +
   ``scaled_dot_product_attention`` under a dense band mask as a yardstick.
3. Training kernels at the T=4096 training path's four shapes (B=4, H=16,
   D=64, global, T = 4096 ... 512): the forward with its LSE and the fused
   backward (dq, dk, dv) vs their plain fp32 versions, a planted fault (an LSE
   off by 0.05) above the bound, CUDA-event times, and rope +
   ``scaled_dot_product_attention`` as a yardstick that the port never calls.
4. Windowed training kernels at the full-song path's four shapes (B=1, H=16,
   D=64, (T, W) = (65536, 4096) ... (8192, 512)): the windowed forward with
   its LSE and the split backward (``flash_bwd_dq`` with its pre-pass,
   ``flash_bwd_dkv``) vs their plain fp32 versions, two planted faults (a
   window one key short, an LSE off by 0.05) above the bounds, the gradients
   bit-identical across two launches, CUDA-event times (the pre-pass alone
   too), and at the level-0 shape rope +
   ``scaled_dot_product_attention`` under a dense band mask, forward and
   backward, as the yardstick.
5. The full-width UNet (dim_h=128, default config, seeded weights) forward at
   B=1, T=8192: bf16 on the GPU through the kernel vs fp32 on the CPU through
   the plain path.
6. Serving: ``generate_beatmap`` on synthesized songs (180 s with DDIM-50 and
   CFG 2.0; 60 s with two samples), each an ``.osz`` holding the returned
   ``.osu`` texts with hit objects, with the kernel launched once per
   attention site of the path; then the sampled signal through the kernels
   vs through the plain attention vs a denoiser that predicts zero.
7. Gradient checks at the training width (dim_h=512, weights random
   everywhere): loss and backward in bf16 through the kernels vs float32
   through the plain versions, both on the GPU, at T=4096 (every site global)
   and at T=16384 (every site windowed).
8. Training: ``osufusion_tpu_torch.trainer.train`` on the dummy dataset at
   dim_h=512, B=4, T=4096, full bf16, 4 steps without rematerialisation
   with a save and a resume half way, and 4 under ``save-attn``; launches per
   step counted; then the ``model.safetensors`` it wrote is loaded by
   ``serve.load_model`` and serves a 60 s song.
9. Full-song training: the same trainer at dim_h=512, B=1, T=65536, full bf16,
   4 steps under the ``mixed`` remat plan with a save and a resume half way,
   then 2 steps each under ``save-attn-out``, ``block`` and no
   rematerialisation: s/step, peak memory, and the launches per step that
   each plan implies (every site windowed: none of the global backward).
10. Halo kernels, the attention of sequence-parallel training, at each
    rank's shapes for a T=65536 song (B=1, H=16, D=64, bf16): (shards, T_local,
    W) = (4, 16384, 4096), (4, 2048, 512) and (2, 32768, 4096), each at the
    first, an interior and the last shard: the forward with its LSE, dq (with
    the pre-pass it shares with dk/dv) and dk/dv over the slab vs their plain
    fp32 versions, dk/dv exactly zero at the
    slab rows outside the song, two planted faults above the bound (a window
    one key short; one key past the song's start or end admitted, over the rows
    that see it), the gradients bit-identical across two launches, CUDA-event
    times (the pre-pass alone too), and at level 0
    ``scaled_dot_product_attention`` under a dense
    (T_local, T_local + W) band-and-bounds mask, forward and backward, as the
    yardstick.
11. Composition: the four shards of a T=65536, W=4096 song, each slab cut
    from the song's rotated k and v with zeros past the ends as the exchange
    delivers them, through the halo kernels; o and dq joined, each slab's dk
    and dv added back onto its rows; against the single-card windowed kernels
    (forward with LSE, dq, dkv) on the whole song.
12. Sequence-parallel training: ``trainer.train`` in two processes under
    torchrun's environment (``--mesh-seq 2``), each holding half of the frames
    of the full-song cell (dim_h=512, B=1, T=65536, full bf16, ``mixed``): one
    step, a save, a resume, a second step; s/step, peak memory and launches
    per rank, and step 1's loss against phase 9's one-card trainer at the same
    seed. Before it, each rank runs one windowed site with two KV heads (T =
    65536, W = 4096, H = 16) through ``ops.attention.sdpa`` on its frames:
    forward and backward against the one-card ``flash_attention``, with the
    halo kernels launched once per KV head. One card per process over NCCL
    where two or more are visible; with one card both processes share it over
    gloo, whose collectives go through host memory.

13. Grouped kernels, the attention of the DiT and MMDiT backbones (D=64,
    bf16, no rotary tables): the forward with its LSE and the fused backward
    in their grouped form (k, v (B, T, Kv, D)) vs their plain fp32 versions at
    DiT's training site (B=4, T=4096, H=Kv=8), MMDiT's packed site (B=4,
    T=2048, H=8, Kv=2), a ragged length (B=4, T=4000, H=Kv=8), and, forward
    only, a DiT serving a 180 s song under CFG (B=2, T=24576, H=Kv=8): two
    planted faults above the bound (query head h against the wrong KV head:
    h % Kv instead of h // G, at full MHA the next head; an LSE off by 0.05),
    CUDA-event times, the bound, and ``scaled_dot_product_attention`` with
    ``enable_gqa``, forward and backward, as the yardstick.
14. Gradient checks of DiT and MMDiT at dim_h=512, depth 12, B=2, T=4096
    (weights random everywhere): bf16 through the kernels vs fp32 through the
    plain versions, both on the GPU.
15. DiT and MMDiT training: ``trainer.train`` on the dummy dataset at
    dim_h=512, depth 12, 8 heads, B=4, T=4096, full bf16, 4 steps with a save
    and a resume half way, without and with ``--gradient-checkpointing``:
    s/step, peak memory, MFU, and the grouped kernels' launches per step.
16. DiT serving: the ``model.safetensors`` the DiT trainer wrote, loaded by
    ``serve.load_model``, serves a 60 s song (DDIM-50, CFG 2.0) to an ``.osz``
    that parses; the grouped forward runs without its LSE once per site and
    step.

17. Whole-song training of a UNet with two KV heads (``attn_kv_heads=2``,
    dim_h=512, B=1, T=65536, full bf16, ``mixed``, 2 steps): every site is a
    windowed GQA site, run once per KV head through the windowed forward with
    its LSE and the windowed dq / dkv pair: 2 x 39 launches of each of the
    pair per step, and a finite loss.

The line before the last is a JSON record of the kernels; the last line is
``{"ok": true, "device": {...}}``. Without a CUDA device the script exits
non-zero before printing either.
"""

from __future__ import annotations

import copy
import dataclasses
import io
import json
import re
import statistics
import subprocess
import sys
import tempfile
import time
import zipfile
from pathlib import Path

import numpy as np
import torch

# kernel vs plain (an fp32 softmax on the same bf16 inputs), per shape. The
# kernel rounds its output and its q/p operands to bf16 (2^-9 relative):
# relative L2 error ||out - ref|| / ||ref|| of a few 1e-3. A window one key
# short drops 2 of W+1 keys per query, about sqrt(2 / (W+1)) relative L2
# (2.2e-2 at W = 4096); the script checks that each shape's planted fault
# lies above REL_TOL, so the bound can catch it. ABS_TOL bounds the largest
# single error, which a fault confined to a few rows shows first.
REL_TOL = 1e-2
ABS_TOL = 1e-2
# the yardstick call rotates q and k in bf16 before its own bf16 products: two
# more roundings than the kernel, so it is held to twice the bound
LIBRARY_REL_TOL = 2e-2
FAULT_TILE = 64  # keys in the kernel's KV tile: the global shape's planted fault drops the last one
# bf16 UNet on the GPU vs fp32 UNet on the CPU: relative L2 error of the
# output. Every layer rounds its activations to bf16 (~4e-3 relative); over
# ~100 layers with residual paths that compounds to ~1e-2
UNET_REL_TOL = 5e-2
ATTN_SHAPES = [(24576, 4096), (12288, 2048), (6144, 1024), (3072, 512), (4096, None)]
# the training kernels vs their plain fp32 versions on the same bf16 inputs.
# Forward: o as above; the LSE is a sum of 64 products of bf16-rounded q (2^-9
# relative) with logits of a few units, so a few 1e-3 absolute. Backward: p,
# ds, q and do enter the tensor cores in bf16, so each of dq, dk, dv carries a
# few 1e-3 relative L2; the largest single error is bounded relative to the
# gradient's largest entry. The planted fault shifts the LSE by LSE_FAULT in
# base 2, which scales p, hence all three gradients, by 2^-0.05 (3.4e-2).
LSE_TOL = 2e-2
BWD_REL_TOL = 1e-2
BWD_ABS_TOL = 1e-2  # times the reference gradient's largest magnitude
LSE_FAULT = 0.05
TRAIN_B, TRAIN_SHAPES = 4, (4096, 2048, 1024, 512)
# the full-song training path's sites, B=1: (T, window) per level. A window one
# key short on each side drops 2 of a query's W+1 pairs, about sqrt(2 / (W+1))
# of each gradient's relative L2 (2.2e-2 at W = 4096): above BWD_REL_TOL
FULLSONG_SHAPES = ((65536, 4096), (32768, 2048), (16384, 1024), (8192, 512))
# bf16 loss and gradients through the kernels vs fp32 through the plain
# versions at dim_h=512: every layer rounds activations and gradients to bf16,
# which compounds over ~100 layers each way
GRAD_REL_TOL = 1e-1
LOSS_REL_TOL = 2e-2
# the served UNet's final conv, as a share of its lecun scale (serving_weights)
SERVE_FINAL_SCALE = 1e-3
# the sampled signal through the kernels vs through the plain attention, both
# bf16 on the GPU, after 50 DDIM steps: the two attentions differ by a few 1e-3
# per site, which the clipped x0 prediction at the noisiest steps amplifies; and
# the least distance of either from the trajectory of a denoiser that predicts
# zero, so that the first is small against the denoiser's own contribution
SAMPLER_REL_TOL = 5e-2
SAMPLER_MIN_EFFECT = 2e-1
QUEUE_CYCLES = 40_000_000  # ~20 ms at the H100's 1.98 GHz: longer than the host takes to queue a timed run
PEAK_FLOPS = 989e12  # H100 SXM, dense bf16
PEAK_BYTES = 3.35e12  # H100 SXM, HBM3
SR = 22050
# a .osu hit object line: x,y,time,type,hitsound[,...]
HIT_OBJECT = re.compile(r"^-?\d+(\.\d+)?,-?\d+(\.\d+)?,\d+(\.\d+)?,\d+,\d+")


_T0 = time.perf_counter()


def _log(msg: str) -> None:
    print(f"{msg} [{time.perf_counter() - _T0:.0f} s]", flush=True)


def _cuda_ms(fn, n: int) -> float:
    """Mean milliseconds per call of fn over n calls on the card, from CUDA
    events. The calls are queued behind a kernel that sleeps for QUEUE_CYCLES,
    so the events bracket the card's work and not the host's enqueueing of it:
    at a narrow shape a wrapper can take longer on the host than its kernel
    on the card."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(QUEUE_CYCLES)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def phase_device() -> tuple[str, str]:
    import torch.distributed  # noqa: F401  (the port's parallel package needs it)

    from torch.utils.cpp_extension import CUDA_HOME

    from osufusion_tpu_torch.ops.flash_attention import build_kernels

    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"], capture_output=True, text=True, check=True
    ).stdout.strip().splitlines()[0]
    nvcc = subprocess.run([str(Path(CUDA_HOME) / "bin" / "nvcc"), "--version"], capture_output=True, text=True, check=True)
    _log(f"[device] {name}; torch {torch.__version__}; CUDA {torch.version.cuda}; "
         f"nvcc {nvcc.stdout.strip().splitlines()[-1]}; count {torch.cuda.device_count()}")
    _log(f"[device] nvidia-smi: {smi}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _log("[device] fp32 matmul and cuDNN conv TF32: off")
    t0 = time.perf_counter()
    libs = build_kernels(verbose=True)
    _log(f"[build] {', '.join(lib.name for lib in libs.values())} (nvcc, sm_90a) ready in {time.perf_counter() - t0:.2f} s")
    return name, smi


def _bound(flops: float, nbytes: float) -> tuple[float, str]:
    """The least milliseconds the card could take, and what sets it."""
    by_ops, by_bytes = flops / PEAK_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
    return (by_ops, "operations") if by_ops >= by_bytes else (by_bytes, "bytes")


def _attn_bytes(B: int, T: int, H: int, D: int, big: int, small: int, stats: int) -> int:
    """Bytes of ``big`` (B,T,H,D) and ``small`` (B,T,D) bf16 tensors, ``stats``
    (B,T,H) fp32 vectors and the two (T,D) fp32 tables, each moved once."""
    return B * T * H * D * 2 * big + B * T * D * 2 * small + B * T * H * 4 * stats + 2 * T * D * 4


def _rel(x: torch.Tensor, ref: torch.Tensor) -> float:
    return ((x.float() - ref).norm() / ref.norm()).item()


def phase_kernel() -> dict:
    import torch.nn.functional as F

    from osufusion_tpu_torch.ops import flash_attention as fa
    from osufusion_tpu_torch.ops.attention import gqa_attention
    from osufusion_tpu_torch.ops.rope import apply_rope, rope_tables
    from osufusion_tpu_torch.utils.flops import attention_flops

    B, H, D = 2, 16, 64
    worst, level0, failures = 0.0, None, []
    for i, (T, window) in enumerate(ATTN_SHAPES):
        g = torch.Generator(device="cuda").manual_seed(100 + i)
        q = torch.randn((B, T, H, D), generator=g, device="cuda").to(torch.bfloat16)
        k = torch.randn((B, T, 1, D), generator=g, device="cuda").to(torch.bfloat16)
        v = torch.randn((B, T, 1, D), generator=g, device="cuda").to(torch.bfloat16)
        rope = rope_tables(T, D, scale_base=float(window or T), device="cuda")
        out = fa.flash_attention(q, k, v, window, rope)
        torch.cuda.synchronize()
        qf, kf, vf = q.float(), k.float(), v.float()
        ref = fa.flash_attention_reference(qf, kf, vf, window, rope)
        err, rel = (out.float() - ref).abs().max().item(), _rel(out, ref)
        # planted fault, in the plain version: a window one key short on each
        # side, or (global) the last KV tile dropped
        if window is None:
            fault = gqa_attention(apply_rope(qf, *rope), apply_rope(kf, *rope)[:, :-FAULT_TILE], vf[:, :-FAULT_TILE])
        else:
            fault = fa.flash_attention_reference(qf, kf, vf, window - 2, rope)
        fault_rel = _rel(fault, ref)
        del ref, fault, qf, kf, vf
        k_rot = fa.rotated_k(k.reshape(B, T, D), *rope)
        v3 = v.reshape(B, T, D).contiguous()
        plain_ms = _cuda_ms(lambda: fa.flash_attention_reference(q, k, v, window, rope), 3)
        kernel_ms = _cuda_ms(lambda: fa.flash_fwd(q, k_rot, v3, *rope, -1 if window is None else window, D**-0.5), 20)
        plain_ms2 = _cuda_ms(lambda: fa.flash_attention_reference(q, k, v, window, rope), 3)
        flops = attention_flops("forward", B, T, H, D, window)
        tflops = flops / (kernel_ms * 1e-3) / 1e12
        _log(f"[kernel] T={T} window={window}: rel L2 err {rel:.3e} (tol {REL_TOL}; planted fault {fault_rel:.3e}); "
             f"max abs err {err:.3e} (tol {ABS_TOL}); kernel {kernel_ms:.3f} ms ({tflops:.1f} TFLOP/s); "
             f"plain bf16 {plain_ms:.3f} / {plain_ms2:.3f} ms")
        if not (rel < REL_TOL and err < ABS_TOL and torch.isfinite(out).all()):
            failures.append(f"T={T} window={window}: rel L2 {rel:.3e}, max abs {err:.3e}")
        if not fault_rel > REL_TOL:
            failures.append(f"T={T} window={window}: planted fault {fault_rel:.3e} would pass REL_TOL {REL_TOL}")
        worst = max(worst, err)
        if level0 is None:
            w2 = window // 2
            bound_ms, bound_by = _bound(flops, _attn_bytes(B, T, H, D, 2, 2, 0))
            # yardstick only: rope on q and k, then PyTorch's fused attention under a dense
            # (T, T) band mask, which visits every tile, the masked ones too
            idx = torch.arange(T, device="cuda", dtype=torch.int32)
            band = (idx[:, None] - idx[None, :]).abs() <= w2

            def library():
                qr, kr = apply_rope(q, *rope).transpose(1, 2), apply_rope(k, *rope).transpose(1, 2)
                return F.scaled_dot_product_attention(qr, kr, v.transpose(1, 2), attn_mask=band, enable_gqa=True).transpose(1, 2)

            lib_rel, library_ms = _rel(library(), out.float()), _cuda_ms(library, 3)
            _log(f"[kernel] T={T} window={window}: rope+SDPA with a band mask {library_ms:.3f} ms, vs kernel rel L2 {lib_rel:.1e}; "
                 f"bound {bound_ms:.3f} ms by {bound_by}")
            if not lib_rel < LIBRARY_REL_TOL:
                failures.append(f"T={T} window={window}: rope+SDPA with a band mask differs from the kernel by {lib_rel:.3e}")
            del idx, band
            level0 = {"ms": kernel_ms, "plain_ms": min(plain_ms, plain_ms2), "bound_ms": bound_ms, "bound_by": bound_by,
                      "library_ms": library_ms}
        del q, k, v, out, k_rot, v3
        torch.cuda.empty_cache()
    if failures:
        raise AssertionError("kernel vs plain: " + "; ".join(failures))
    return {"max_abs_err": worst, **level0}


def phase_train_kernels() -> tuple[dict, dict]:
    """K1 with its LSE and K2 vs their plain versions; returns their records
    at the level-0 shape (errors: the worst over the four shapes)."""
    import torch.nn.functional as F

    from osufusion_tpu_torch.ops import flash_attention as fa
    from osufusion_tpu_torch.ops.rope import apply_rope, rope_tables
    from osufusion_tpu_torch.utils.flops import attention_flops

    B, H, D = TRAIN_B, 16, 64
    scale = D**-0.5
    failures, fwd_rec, bwd_rec, fwd_worst, bwd_worst = [], None, None, 0.0, 0.0
    for i, T in enumerate(TRAIN_SHAPES):
        g = torch.Generator(device="cuda").manual_seed(200 + i)
        q, do = (torch.randn((B, T, H, D), generator=g, device="cuda").to(torch.bfloat16) for _ in range(2))
        k, v = (torch.randn((B, T, D), generator=g, device="cuda").to(torch.bfloat16) for _ in range(2))
        cos, sin = rope_tables(T, D, scale_base=float(T), device="cuda")
        k_rot = fa.rotated_k(k, cos, sin)

        o, lse = fa.flash_fwd(q, k_rot, v, cos, sin, -1, scale, return_lse=True)
        dq, dk, dv = fa.flash_bwd(q, k_rot, v, o, lse, do, cos, sin, scale)
        torch.cuda.synchronize()
        o_ref, lse_ref = fa.flash_fwd_lse_reference(q, k_rot, v, cos, sin)
        refs = fa.flash_bwd_reference(q, k_rot, v, o_ref, lse_ref, do, cos, sin)
        faults = fa.flash_bwd_reference(q, k_rot, v, o_ref, lse_ref + LSE_FAULT, do, cos, sin)

        o_rel, o_err = _rel(o, o_ref), (o.float() - o_ref).abs().max().item()
        lse_err = (lse - lse_ref).abs().max().item()
        fwd_worst = max(fwd_worst, o_err)
        if not (o_rel < REL_TOL and o_err < ABS_TOL and lse_err < LSE_TOL and torch.isfinite(lse).all()):
            failures.append(f"forward T={T}: o rel L2 {o_rel:.3e}, max abs {o_err:.3e}, lse max abs {lse_err:.3e}")
        parts = []
        for name, got, ref, fault in zip(("dq", "dk", "dv"), (dq, dk, dv), refs, faults):
            rel, err, top = _rel(got, ref), (got.float() - ref).abs().max().item(), ref.abs().max().item()
            fault_rel = _rel(fault, ref)
            bwd_worst = max(bwd_worst, err)
            parts.append(f"{name} rel L2 {rel:.3e} max abs {err:.3e} of {top:.2f} (fault {fault_rel:.3e})")
            if not (rel < BWD_REL_TOL and err < BWD_ABS_TOL * top and torch.isfinite(got).all()):
                failures.append(f"backward T={T}: {name} rel L2 {rel:.3e}, max abs {err:.3e} of {top:.3e}")
            if not fault_rel > BWD_REL_TOL:
                failures.append(f"backward T={T}: planted fault in {name} {fault_rel:.3e} would pass {BWD_REL_TOL}")
        del o_ref, lse_ref, refs, faults

        fwd_ms = _cuda_ms(lambda: fa.flash_fwd(q, k_rot, v, cos, sin, -1, scale, return_lse=True), 20)
        bwd_ms = _cuda_ms(lambda: fa.flash_bwd(q, k_rot, v, o, lse, do, cos, sin, scale), 10)
        fwd_plain_ms = _cuda_ms(lambda: fa.flash_fwd_lse_reference(q, k_rot, v, cos, sin), 2)
        bwd_plain_ms = _cuda_ms(lambda: fa.flash_bwd_reference(q, k_rot, v, o, lse, do, cos, sin), 2)

        # yardstick only: rope on q and k, then PyTorch's fused attention and its backward
        def library_forward(q_in, k_in, v_in):
            qr = apply_rope(q_in, cos, sin).transpose(1, 2)
            kr = apply_rope(k_in, cos, sin)[:, None]
            return F.scaled_dot_product_attention(qr, kr, v_in[:, None], enable_gqa=True).transpose(1, 2)

        lib_fwd_ms = _cuda_ms(lambda: library_forward(q, k, v), 10)
        leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
        lib_out = library_forward(*leaves)
        lib_bwd_ms = _cuda_ms(lambda: torch.autograd.grad(lib_out, leaves, do, retain_graph=True), 10)
        lib_rel = _rel(lib_out, o.float())
        del lib_out, leaves

        fwd_bound, fwd_by = _bound(attention_flops("forward", B, T, H, D, None), _attn_bytes(B, T, H, D, 2, 2, 1))
        bwd_bound, bwd_by = _bound(attention_flops("backward_fused", B, T, H, D, None),
                                   _attn_bytes(B, T, H, D, 4, 4, 1))  # q o do dq; k v dk dv; lse
        _log(f"[train kernels] T={T}: forward o rel L2 {o_rel:.3e} max abs {o_err:.3e}, lse max abs {lse_err:.3e} "
             f"(tol {LSE_TOL}); backward {'; '.join(parts)} (tol {BWD_REL_TOL})")
        _log(f"[train kernels] T={T}: forward {fwd_ms:.3f} ms (bound {fwd_bound:.3f} by {fwd_by}; plain {fwd_plain_ms:.3f}; "
             f"rope+SDPA {lib_fwd_ms:.3f}, vs kernel rel L2 {lib_rel:.1e}); backward {bwd_ms:.3f} ms (bound {bwd_bound:.3f} "
             f"by {bwd_by}; plain {bwd_plain_ms:.3f}; rope+SDPA backward {lib_bwd_ms:.3f})")
        if fwd_rec is None:
            fwd_rec = {"ms": fwd_ms, "plain_ms": fwd_plain_ms, "bound_ms": fwd_bound, "bound_by": fwd_by, "library_ms": lib_fwd_ms}
            bwd_rec = {"ms": bwd_ms, "plain_ms": bwd_plain_ms, "bound_ms": bwd_bound, "bound_by": bwd_by, "library_ms": lib_bwd_ms}
        del q, k, v, do, o, lse, dq, dk, dv, k_rot
        torch.cuda.empty_cache()
    if failures:
        raise AssertionError("training kernels vs plain: " + "; ".join(failures))
    return {"max_abs_err": fwd_worst, **fwd_rec}, {"max_abs_err": bwd_worst, **bwd_rec}


def phase_windowed_kernels() -> tuple[dict, dict, dict]:
    """K1 windowed with its LSE and the split backward pair vs their plain
    versions at the full-song path's shapes; returns the three records at the
    level-0 shape (errors: the worst over the four shapes)."""
    import torch.nn.functional as F

    from osufusion_tpu_torch.ops import flash_attention as fa
    from osufusion_tpu_torch.ops.rope import apply_rope, rope_tables
    from osufusion_tpu_torch.utils.flops import attention_flops

    B, H, D = 1, 16, 64
    scale = D**-0.5
    failures, records, worst = [], None, {"fwd": 0.0, "dq": 0.0, "dkv": 0.0}
    for i, (T, W) in enumerate(FULLSONG_SHAPES):
        g = torch.Generator(device="cuda").manual_seed(300 + i)
        q, do = (torch.randn((B, T, H, D), generator=g, device="cuda").to(torch.bfloat16) for _ in range(2))
        k, v = (torch.randn((B, T, D), generator=g, device="cuda").to(torch.bfloat16) for _ in range(2))
        cos, sin = rope_tables(T, D, scale_base=float(W), device="cuda")
        k_rot = fa.rotated_k(k, cos, sin)

        def backward():
            dq, prep = fa.flash_bwd_dq(q, k_rot, v, o, lse, do, cos, sin, W, scale)
            return (dq, *fa.flash_bwd_dkv(k_rot, v, do, prep, W))

        o, lse = fa.flash_fwd(q, k_rot, v, cos, sin, W, scale, return_lse=True)
        grads = backward()
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in zip(grads, backward())):
            failures.append(f"T={T} W={W}: dq, dk or dv differ between two launches on the same inputs")

        def plain_backward(window, lse_in):
            return (fa.flash_bwd_dq_reference(q, k_rot, v, o_ref, lse_in, do, cos, sin, window),
                    *fa.flash_bwd_dkv_reference(q, k_rot, v, o_ref, lse_in, do, cos, sin, window))

        o_ref, lse_ref = fa.flash_fwd_lse_reference(q, k_rot, v, cos, sin, W)
        refs = plain_backward(W, lse_ref)
        # planted faults, in the plain version: a window one key short on each side; an LSE off by LSE_FAULT
        short, shifted = plain_backward(W - 2, lse_ref), plain_backward(W, lse_ref + LSE_FAULT)
        o_short = fa.flash_fwd_lse_reference(q, k_rot, v, cos, sin, W - 2)[0]

        o_rel, o_err = _rel(o, o_ref), (o.float() - o_ref).abs().max().item()
        lse_err, o_fault = (lse - lse_ref).abs().max().item(), _rel(o_short, o_ref)
        worst["fwd"] = max(worst["fwd"], o_err)
        if not (o_rel < REL_TOL and o_err < ABS_TOL and lse_err < LSE_TOL and torch.isfinite(lse).all()):
            failures.append(f"forward T={T} W={W}: o rel L2 {o_rel:.3e}, max abs {o_err:.3e}, lse max abs {lse_err:.3e}")
        if not o_fault > REL_TOL:
            failures.append(f"forward T={T} W={W}: planted fault {o_fault:.3e} would pass {REL_TOL}")
        parts = []
        for name, got, ref, f_short, f_lse in zip(("dq", "dk", "dv"), grads, refs, short, shifted):
            rel, err, top = _rel(got, ref), (got.float() - ref).abs().max().item(), ref.abs().max().item()
            rel_short, rel_lse = _rel(f_short, ref), _rel(f_lse, ref)
            key = "dq" if name == "dq" else "dkv"
            worst[key] = max(worst[key], err)
            parts.append(f"{name} rel L2 {rel:.3e} max abs {err:.3e} of {top:.2f} (faults: window {rel_short:.3e}, lse {rel_lse:.3e})")
            if not (rel < BWD_REL_TOL and err < BWD_ABS_TOL * top and torch.isfinite(got).all()):
                failures.append(f"backward T={T} W={W}: {name} rel L2 {rel:.3e}, max abs {err:.3e} of {top:.3e}")
            if not min(rel_short, rel_lse) > BWD_REL_TOL:
                failures.append(f"backward T={T} W={W}: planted faults in {name} {rel_short:.3e}, {rel_lse:.3e} would pass {BWD_REL_TOL}")
        del o_ref, refs, short, shifted, o_short, grads

        fwd_ms = _cuda_ms(lambda: fa.flash_fwd(q, k_rot, v, cos, sin, W, scale, return_lse=True), 20)
        prep = fa.flash_bwd_dq(q, k_rot, v, o, lse, do, cos, sin, W, scale)[1]
        prep_ms = _cuda_ms(lambda: fa.windowed_prep(q, o, lse, do, cos, sin, scale), 10)
        dq_ms = _cuda_ms(lambda: fa.flash_bwd_dq(q, k_rot, v, o, lse, do, cos, sin, W, scale), 10)  # the pre-pass included
        dkv_ms = _cuda_ms(lambda: fa.flash_bwd_dkv(k_rot, v, do, prep, W), 10)
        fwd_plain_ms = _cuda_ms(lambda: fa.flash_fwd_lse_reference(q, k_rot, v, cos, sin, W), 1)
        dq_plain_ms = _cuda_ms(lambda: fa.flash_bwd_dq_reference(q, k_rot, v, o, lse_ref, do, cos, sin, W), 1)
        dkv_plain_ms = _cuda_ms(lambda: fa.flash_bwd_dkv_reference(q, k_rot, v, o, lse_ref, do, cos, sin, W), 1)
        bounds = {
            "fwd": _bound(attention_flops("forward", B, T, H, D, W), _attn_bytes(B, T, H, D, 2, 2, 1)),  # q o; k v; lse
            # q o do dq, qs out; k v; lse in, lse delta out
            "dq": _bound(attention_flops("backward_dq", B, T, H, D, W), _attn_bytes(B, T, H, D, 5, 2, 3)),
            "dkv": _bound(attention_flops("backward_dkv", B, T, H, D, W), _attn_bytes(B, T, H, D, 2, 6, 2)),  # qs do; k v, dk dv in fp32; lse delta
        }
        _log(f"[windowed kernels] T={T} W={W}: forward o rel L2 {o_rel:.3e} max abs {o_err:.3e} (fault {o_fault:.3e}), lse max abs "
             f"{lse_err:.3e}; backward {'; '.join(parts)}; two launches bit-identical")
        _log(f"[windowed kernels] T={T} W={W}: forward with LSE {fwd_ms:.3f} ms (bound {bounds['fwd'][0]:.3f} by {bounds['fwd'][1]}; "
             f"plain {fwd_plain_ms:.3f}); dq {dq_ms:.3f} ms with its pre-pass {prep_ms:.3f} ms (bound {bounds['dq'][0]:.3f} by "
             f"{bounds['dq'][1]}; plain {dq_plain_ms:.3f}); dkv {dkv_ms:.3f} ms (bound {bounds['dkv'][0]:.3f} "
             f"by {bounds['dkv'][1]}; plain {dkv_plain_ms:.3f})")
        if records is None:
            # yardstick only: rope on q and k, then PyTorch's fused attention under a dense (T, T)
            # band mask, and its backward; both visit every tile, the masked ones too
            idx = torch.arange(T, device="cuda", dtype=torch.int32)
            band = (idx[:, None] - idx[None, :]).abs() <= W // 2
            leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]

            def library(q_in, k_in, v_in):
                qr = apply_rope(q_in, cos, sin).transpose(1, 2)
                kr = apply_rope(k_in, cos, sin)[:, None]
                return F.scaled_dot_product_attention(qr, kr, v_in[:, None], attn_mask=band, enable_gqa=True).transpose(1, 2)

            with torch.no_grad():
                lib_fwd_ms = _cuda_ms(lambda: library(q, k, v), 2)
            lib_out = library(*leaves)
            lib_rel = _rel(lib_out, o.float())
            lib_bwd_ms = _cuda_ms(lambda: torch.autograd.grad(lib_out, leaves, do, retain_graph=True), 2)
            _log(f"[windowed kernels] T={T} W={W}: rope+SDPA with a band mask forward {lib_fwd_ms:.3f} ms, vs kernel rel L2 "
                 f"{lib_rel:.1e}; its backward {lib_bwd_ms:.3f} ms (the pair: {dq_ms + dkv_ms:.3f} ms)")
            if not lib_rel < LIBRARY_REL_TOL:
                failures.append(f"T={T} W={W}: rope+SDPA with a band mask differs from the kernel by {lib_rel:.3e}")
            del idx, band, leaves, lib_out
            # the one library backward yields dq, dk and dv: each kernel of the pair is set beside the whole of it
            records = [
                {"ms": fwd_ms, "plain_ms": fwd_plain_ms, "library_ms": lib_fwd_ms},
                {"ms": dq_ms, "plain_ms": dq_plain_ms, "library_ms": lib_bwd_ms},
                {"ms": dkv_ms, "plain_ms": dkv_plain_ms, "library_ms": lib_bwd_ms},
            ]
            for rec, key in zip(records, ("fwd", "dq", "dkv")):
                rec["bound_ms"], rec["bound_by"] = bounds[key]
        del q, k, v, do, o, lse, lse_ref, prep, k_rot
        torch.cuda.empty_cache()
    if failures:
        raise AssertionError("windowed training kernels vs plain: " + "; ".join(failures))
    return tuple({"max_abs_err": worst[key], **rec} for rec, key in zip(records, ("fwd", "dq", "dkv")))


def build_unet_pair():
    """The default config at dim_h=128: seeded fp32 weights on the CPU and a
    bf16 copy on the GPU. final_conv is zero at init; it gets seeded weights
    so the output depends on everything before it. Returns (serving model,
    CPU UNet, its GPU copy)."""
    from osufusion_tpu_torch.config import Config, ModelConfig
    from osufusion_tpu_torch.models import build_model

    cfg = Config(model=ModelConfig(dim_h=128, dtype="float32"))
    model = build_model(cfg.model, cfg.diffusion)
    cpu = model.init_params(seed=0, device="cpu")
    g = torch.Generator().manual_seed(1)
    with torch.no_grad():
        cpu.final_conv.weight.copy_(torch.randn(cpu.final_conv.weight.shape, generator=g) / 128**0.5)
        cpu.final_conv.bias.copy_(torch.randn(cpu.final_conv.bias.shape, generator=g) * 0.1)
    gpu = copy.deepcopy(cpu).to("cuda", torch.bfloat16)
    serve_model = build_model(ModelConfig(dim_h=128), cfg.diffusion)  # bf16 compute, as served
    return serve_model, cpu, gpu


def phase_unet(cpu, gpu) -> None:
    from osufusion_tpu_torch.ops import flash_attention as fa

    rng = np.random.default_rng(0)
    T = 8192
    x = torch.from_numpy(rng.standard_normal((1, T, 6)).astype(np.float32))
    a = torch.from_numpy(rng.normal(-10.0, 3.0, (1, T, 96)).astype(np.float32))
    t = torch.tensor([500.0])
    c = torch.from_numpy(rng.uniform(-1, 1, (1, 5)).astype(np.float32))
    mask = torch.tensor([True])
    before = fa.flash_fwd.launches
    with torch.inference_mode():
        t0 = time.perf_counter()
        out_gpu = gpu(x.cuda(), a.cuda(), t.cuda(), c.cuda(), mask.cuda()).cpu()
        gpu_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        out_cpu = cpu(x, a, t, c, mask)
        cpu_s = time.perf_counter() - t0
    n_sites = fa.flash_fwd.launches - before
    rel = ((out_gpu - out_cpu).norm() / out_cpu.norm()).item()
    _log(f"[unet] dim_h=128 B=1 T={T}: {n_sites} kernel launches; GPU bf16 {gpu_s:.2f} s (first call), "
         f"CPU fp32 {cpu_s:.2f} s; relative L2 error {rel:.3e} (bound {UNET_REL_TOL}); "
         f"output std {out_cpu.std().item():.3f}")
    if out_gpu.shape != (1, T, 6) or not torch.isfinite(out_gpu).all():
        raise AssertionError(f"UNet output on the GPU: shape {tuple(out_gpu.shape)} or non-finite values")
    expected = 3 * sum(gpu.cfg.num_layer_blocks) + gpu.cfg.num_middle_transformers  # audio, down, up + middle
    if n_sites != expected:
        raise AssertionError(f"UNet forward launched the kernel {n_sites} times, expected {expected}")
    if not rel < UNET_REL_TOL:
        raise AssertionError(f"UNet GPU vs CPU relative error {rel} >= {UNET_REL_TOL}")


def synth_song(path: Path, seconds: float, seed: int) -> None:
    """Clicks on a 120-BPM grid plus a few tones and a little noise."""
    rng = np.random.default_rng(seed)
    n = int(seconds * SR)
    tt = np.arange(n) / SR
    y = 0.02 * rng.standard_normal(n)
    for f in rng.uniform(110.0, 880.0, 3):
        y += 0.1 * np.sin(2 * np.pi * f * tt)
    click = np.hanning(2 * 441)[441:] * np.sin(2 * np.pi * 1500.0 * np.arange(441) / SR)
    for beat in np.arange(0.5, seconds - 0.1, 0.5):
        i = int(beat * SR)
        y[i : i + 441] += 0.6 * click
    from scipy.io import wavfile

    wavfile.write(path, SR, (np.clip(y, -1.0, 1.0) * 32767).astype(np.int16))


def check_osz(data: bytes, osu_texts: list[str], n_maps: int) -> list[int]:
    """The .osz holds the n_maps returned .osu texts, each with at least one
    hit object line (x,y,time,type,...) under [HitObjects], the last section."""
    with zipfile.ZipFile(io.BytesIO(data)) as z:
        stored = sorted(z.read(n).decode() for n in z.namelist() if n.endswith(".osu"))
    if len(osu_texts) != n_maps or stored != sorted(osu_texts):
        raise AssertionError(f".osz holds {len(stored)} .osu files, returned {len(osu_texts)}, expected {n_maps}")
    hits = []
    for text in osu_texts:
        if not text.startswith("osu file format v14") or "[HitObjects]" not in text:
            raise AssertionError("a generated .osu lacks its header or [HitObjects]")
        lines = text.split("[HitObjects]", 1)[1].strip().splitlines()
        for line in lines:
            if not HIT_OBJECT.match(line):
                raise AssertionError(f"malformed hit object line: {line!r}")
        hits.append(len(lines))
    if min(hits) < 1:
        raise AssertionError(f"a generated map has no hit objects: {hits}")
    return hits


def serving_weights(model):
    """The UNet that the serving phases serve: seeded weights, random
    everywhere, with the final conv drawn at SERVE_FINAL_SCALE of its lecun
    scale, so the sampled signal depends on the whole denoiser, the CFG mix
    and the kernels (``phase_sampler_check`` holds it to that). At the full
    lecun scale an untrained denoiser saturates the DDIM trajectory to one
    sign per channel, and the decoder takes no map with fewer than two
    onsets."""
    params = model.init_params(seed=0, device="cuda", dtype=torch.float32)
    randomize_everywhere(params, seed=1)
    with torch.no_grad():
        params.final_conv.weight.mul_(SERVE_FINAL_SCALE)
    return params.to(model.model_cfg.compute_dtype).eval()


def phase_serve(model, params) -> int:
    """Serve two requests; returns the kernel launches of both."""
    from osufusion_tpu_torch.ops import flash_attention as fa
    from osufusion_tpu_torch.serve import LENGTH_BUCKET, generate_beatmap

    cfg = params.cfg
    steps = 50
    per_call = 2 * sum(cfg.num_layer_blocks) + cfg.num_middle_transformers
    expected = sum(cfg.num_layer_blocks) + steps * per_call  # audio stack once, then every step
    total = 0
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        for label, seconds, n_samples in (("a", 180.0, 1), ("b", 60.0, 2)):
            wav = tmp / f"song_{label}.wav"
            synth_song(wav, seconds, seed=ord(label))
            fa.flash_fwd.launches = 0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            data, osu_texts = generate_beatmap(model, params, wav, title=f"smoke {label}", num_samples=n_samples,
                                       sampling_timesteps=steps, cond_scale=2.0, seed=0)
            latency = time.perf_counter() - t0
            launches = fa.flash_fwd.launches
            total += launches
            hits = check_osz(data, osu_texts, n_samples)
            frames = 1 + int(seconds * SR) // 176
            padded = -(-frames // LENGTH_BUCKET) * LENGTH_BUCKET
            _log(f"[serve {label}] {seconds:.0f} s song, {frames} frames (padded {padded}), DDIM-{steps}, CFG 2.0, "
                 f"num_samples={n_samples}: {latency:.3f} s end to end; {len(data)} byte .osz; hit objects {hits}; "
                 f"kernel launches {launches} (expected {expected})")
            if launches != expected:
                raise AssertionError(f"request {label}: {launches} kernel launches, expected {expected}")
    return total


def phase_sampler_latency(model, params) -> None:
    """The sampler alone on the 180 s cell (what the JAX package's bench
    measures as fullsong_gen_latency_ddim50_cfg), twice."""
    g = torch.Generator().manual_seed(0)
    frames = 24576
    a = (torch.randn((1, 96, frames), generator=g) * 3 - 10).cuda()
    c = (torch.rand((1, 5), generator=g) * 2 - 1).cuda()
    times = []
    for seed in (1, 2):
        x0 = torch.randn((1, 6, frames), generator=torch.Generator().manual_seed(seed)).cuda()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = model.sample(params, a, c, x=x0, cond_scale=2.0, sampling_timesteps=50)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        if not torch.isfinite(out).all():
            raise AssertionError("sampler output has non-finite values")
    _log(f"[sampler] 24576 frames, DDIM-50, CFG 2.0, B=1: {times[0]:.3f} s, {times[1]:.3f} s per map")


def phase_sampler_check(model, params, workdir: Path) -> None:
    """The sampler's output is the denoiser's: on a 60 s song (8192 padded
    frames, DDIM-50, CFG 2.0) the signal sampled through the kernels agrees
    with the one sampled through the plain attention on the GPU, and both lie
    far from the trajectory of a denoiser that predicts zero."""
    import torch.nn.functional as F

    from osufusion_tpu_torch.audio import load_audio
    from osufusion_tpu_torch.nn import blocks
    from osufusion_tpu_torch.nn.unet import A_PAD_VALUE
    from osufusion_tpu_torch.ops import flash_attention as fa
    from osufusion_tpu_torch.serve import LENGTH_BUCKET

    wav = workdir / "song_check.wav"
    synth_song(wav, 60.0, seed=ord("b"))
    spec = load_audio(wav, device="cuda")
    a = F.pad(spec, (0, LENGTH_BUCKET - spec.shape[-1]), value=A_PAD_VALUE)[None]
    c = torch.zeros((1, 5), device="cuda")
    x0 = torch.randn((1, 6, LENGTH_BUCKET), generator=torch.Generator().manual_seed(0)).cuda()
    plain, zero = copy.deepcopy(params), copy.deepcopy(params)
    for module in plain.modules():
        if isinstance(module, blocks.Attention):
            module.sdpa = fa.flash_attention_reference
    with torch.no_grad():
        zero.final_conv.weight.zero_()
        zero.final_conv.bias.zero_()
    before = fa.flash_fwd.launches
    signals = [model.sample(p, a, c, x=x0, cond_scale=2.0, sampling_timesteps=50) for p in (params, plain, zero)]
    launches = fa.flash_fwd.launches - before
    through_kernels, through_plain, zero_eps = signals
    rel_plain, rel_zero = _rel(through_kernels, through_plain), _rel(through_kernels, zero_eps)
    flipped = ((through_kernels > 0) != (zero_eps > 0)).float().mean().item()
    _log(f"[sampler check] {LENGTH_BUCKET} frames, DDIM-50, CFG 2.0: signal through the kernels vs through the plain attention "
         f"rel L2 {rel_plain:.3e} (bound {SAMPLER_REL_TOL}); vs a zero-predicting denoiser {rel_zero:.3e} (at least "
         f"{SAMPLER_MIN_EFFECT}), {flipped:.2%} of the signs differ; kernel launches {launches}")
    if not all(torch.isfinite(x).all() for x in signals):
        raise AssertionError("sampler check: non-finite signal")
    if not (rel_plain < SAMPLER_REL_TOL and rel_zero > SAMPLER_MIN_EFFECT):
        raise AssertionError(f"sampler check: kernels vs plain {rel_plain:.3e}, vs zero-predicting {rel_zero:.3e}")


def randomize_everywhere(unet, seed: int) -> None:
    """Make every parameter random: biases N(0, 0.1), norm scales 1 + N(0, 0.1),
    a lecun-scaled final conv. A fresh model's final conv is zero, so every
    gradient behind it would be zero too."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in unet.named_parameters():
            if name.endswith("bias"):
                p.copy_(torch.randn(p.shape, generator=g) * 0.1)
            elif p.ndim == 1 and name.endswith("weight"):
                p.copy_(1.0 + torch.randn(p.shape, generator=g) * 0.1)
        w = unet.final_conv.weight
        w.copy_(torch.randn(w.shape, generator=g) / w.shape[1] ** 0.5)


def _reset_launches(fa) -> None:
    fa.flash_fwd.launches = fa.flash_fwd.lse_launches = fa.flash_bwd.launches = 0
    fa.flash_fwd.grouped_launches = fa.flash_bwd.grouped_launches = 0
    fa.flash_bwd_dq.launches = fa.flash_bwd_dkv.launches = 0


def _launches(fa) -> dict:
    """Launches since ``_reset_launches``, by kernel form."""
    return {"forward": fa.flash_fwd.launches - fa.flash_fwd.lse_launches, "forward_lse": fa.flash_fwd.lse_launches,
            "backward_fused": fa.flash_bwd.launches, "backward_dq": fa.flash_bwd_dq.launches,
            "backward_dkv": fa.flash_bwd_dkv.launches, "forward_grouped": fa.flash_fwd.grouped_launches,
            "backward_grouped": fa.flash_bwd.grouped_launches}


def _flat_grads(unet, only=None) -> torch.Tensor:
    return torch.cat([p.grad.float().flatten() for n, p in unet.named_parameters() if only is None or only(n)])


def phase_grad_check(B: int, T: int) -> None:
    """dim_h=512: bf16 through the kernels vs fp32 through the plain versions
    (under block remat, which changes no gradient and keeps the fp32 logits
    of only one block alive), both on the GPU. At T=4096 every attention site
    is global, at T=16384 every one is windowed."""
    from osufusion_tpu_torch.config import DiffusionConfig, ModelConfig
    from osufusion_tpu_torch.models import build_model
    from osufusion_tpu_torch.nn import blocks
    from osufusion_tpu_torch.nn.unet import UNetBlock
    from osufusion_tpu_torch.ops import flash_attention as fa

    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal((B, 6, T)).astype(np.float32)).cuda()
    a = torch.from_numpy(rng.normal(-10.0, 3.0, (B, 96, T)).astype(np.float32)).cuda()
    c = torch.from_numpy(rng.uniform(-1, 1, (B, 5)).astype(np.float32)).cuda()
    orig_len = torch.tensor([T, T - 700][:B], device="cuda")
    noise = torch.from_numpy(rng.standard_normal((B, 6, T)).astype(np.float32)).cuda()
    t = torch.tensor([100, 700][:B], device="cuda")
    cond_mask = torch.tensor([True, False][:B], device="cuda")

    model32 = build_model(ModelConfig(dim_h=512, dtype="float32", remat=True, remat_mode="block"), DiffusionConfig())
    ref = model32.init_params(seed=5, device="cpu")
    randomize_everywhere(ref, seed=6)
    model16 = build_model(ModelConfig(dim_h=512), DiffusionConfig())
    net = model16.init_params(seed=0, device="cpu")
    net.load_state_dict(ref.state_dict())
    ref, net = ref.cuda().train(), net.cuda().train()

    def run(model, params):
        params.zero_grad(set_to_none=True)
        loss = model.loss_from_draws(params, x, a, c, orig_len, noise, t, cond_mask)
        loss.backward()
        torch.cuda.synchronize()
        return loss.item()

    _reset_launches(fa)
    loss16 = run(model16, net)
    launches = _launches(fa)
    g16 = _flat_grads(net)
    is_attn = lambda n: ".attn.to_" in n
    g16_attn = _flat_grads(net, is_attn)
    # the plain versions on the GPU: every attention module is handed the plain function, and the
    # bf16 model too now runs under block remat, or its fp32 logits of all 39 sites would stay alive
    for module in (*net.modules(), *ref.modules()):
        if isinstance(module, blocks.Attention):
            module.sdpa = fa.flash_attention_reference
        elif isinstance(module, UNetBlock):
            module.remat_block = "block"
    loss16_plain = run(model16, net)
    g16_plain = _flat_grads(net)
    loss32 = run(model32, ref)
    g32, g32_attn = _flat_grads(ref), _flat_grads(ref, is_attn)
    rel_all = ((g16 - g32).norm() / g32.norm()).item()
    rel_attn = ((g16_attn - g32_attn).norm() / g32_attn.norm()).item()
    rel_plain = ((g16_plain - g32).norm() / g32.norm()).item()
    rel_loss = abs(loss16 - loss32) / abs(loss32)
    _log(f"[grad check] dim_h=512 B={B} T={T}: loss bf16/kernels {loss16:.6f}, bf16/plain {loss16_plain:.6f}, fp32/plain {loss32:.6f} "
         f"(rel {rel_loss:.3e}, bound {LOSS_REL_TOL}); gradient rel L2 vs fp32/plain: bf16/kernels {rel_all:.3e}, attention "
         f"projections alone {rel_attn:.3e} (bound {GRAD_REL_TOL}); bf16/plain {rel_plain:.3e} (bf16's own share); "
         f"|grad| {g32.norm().item():.3e}; launches {launches}")
    if not (np.isfinite(loss16) and torch.isfinite(g16).all()):
        raise AssertionError("gradient check: non-finite loss or gradient through the kernels")
    if not (rel_loss < LOSS_REL_TOL and rel_all < GRAD_REL_TOL and rel_attn < GRAD_REL_TOL):
        raise AssertionError(f"gradient check: loss rel {rel_loss:.3e}, gradient rel L2 {rel_all:.3e}, attention {rel_attn:.3e}")
    sites = 3 * sum(net.cfg.num_layer_blocks) + net.cfg.num_middle_transformers
    windowed = T > net.cfg.attn_context_len
    expected = {"forward": 0, "forward_lse": sites, "backward_fused": 0 if windowed else sites,
                "backward_dq": sites if windowed else 0, "backward_dkv": sites if windowed else 0,
                "forward_grouped": 0, "backward_grouped": 0}
    if launches != expected:
        raise AssertionError(f"gradient check launched {launches}, expected {expected}")


def _train_with_resume(cfg, steps: int, label: str, final: str = "final_conv/kernel") -> tuple[list[dict], dict, float]:
    """``trainer.train`` for ``steps`` steps, across a save and a resume half
    way when ``cfg.train.save_every`` says so; checks the steps, the losses
    and that ``final``, a zero-initialised leaf of the output layer, moved.
    Returns (history, launches, peak GiB)."""
    from osufusion_tpu_torch.ops import flash_attention as fa
    from osufusion_tpu_torch.trainer import train
    from osufusion_tpu_torch.utils.serialization import load_safetensors

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    _reset_launches(fa)
    history = train(cfg)
    if cfg.train.total_steps < steps:
        history += train(dataclasses.replace(cfg, train=dataclasses.replace(cfg.train, total_steps=steps, resume="latest")))
    torch.cuda.synchronize()
    launches, peak = _launches(fa), torch.cuda.max_memory_allocated() / 2**30
    if [h["step"] for h in history] != list(range(1, steps + 1)):
        raise AssertionError(f"{label}: steps {[h['step'] for h in history]}, expected 1..{steps} across the resume")
    if not all(np.isfinite(h["loss"]) and np.isfinite(h["grad_norm"]) for h in history):
        raise AssertionError(f"{label}: non-finite loss or grad_norm")
    if not all(h["grad_norm"] > 0 for h in history[1:]):
        raise AssertionError(f"{label}: grad_norm not positive after step 1")
    trained = load_safetensors(Path(cfg.train.project_dir) / "model.safetensors")
    if not np.abs(trained[f"params/{final}"]).max() > 0:
        raise AssertionError(f"{label}: the output layer's {final} did not move from zero")
    return history, launches, peak


def phase_train(workdir: Path) -> tuple[int, int]:
    """The trainer at the production cell, 4 steps per remat mode, without
    remat across a save and a resume half way; returns (forward-with-LSE,
    backward) launches."""
    from osufusion_tpu_torch.config import Config, ModelConfig, TrainConfig

    steps, half = 4, 2
    totals = [0, 0]
    for remat in ("none", "save-attn"):
        resume = remat == "none"  # one resume is enough: each save writes 1279 M parameters and their AdamW state
        cfg = Config(
            model=ModelConfig(dim_h=512, remat=remat != "none", remat_mode="save-attn"),
            # dummy samples are 1024..4096 frames at this segment length, padded to 4096
            train=TrainConfig(project_dir=str(workdir / f"train_{remat}"), dataset_mode="dummy", segment_length=2048,
                              batch_size=4, full_bf16=True, total_steps=half if resume else steps, warmup_steps=2,
                              save_every=half if resume else 0, num_workers=2, seed=0),
        )
        sites = 3 * sum(cfg.model.num_layer_blocks) + cfg.model.num_middle_transformers
        history, launches, peak = _train_with_resume(cfg, steps, f"train {remat}")
        totals[0] += launches["forward_lse"]
        totals[1] += launches["backward_fused"]
        seconds = [h["seconds"] for h in history[1:]]
        _log(f"[train {remat}] dim_h=512 B=4 T=4096 full bf16, {steps} steps{f' (save and resume at {half})' if resume else ''}: "
             f"loss {[round(h['loss'], 4) for h in history]}; grad_norm {[round(h['grad_norm'], 4) for h in history]}; "
             f"{statistics.median(seconds):.4f} s/step (median of steps 2..{steps}: {[round(x, 4) for x in seconds]}); "
             f"peak memory {peak:.2f} GiB; launches over {steps} steps {launches} (sites {sites})")
        expected = {"forward": 0, "forward_lse": sites * steps, "backward_fused": sites * steps, "backward_dq": 0, "backward_dkv": 0,
                    "forward_grouped": 0, "backward_grouped": 0}
        if launches != expected:
            raise AssertionError(f"train {remat}: launches {launches}, expected {expected}")
    return totals[0], totals[1]


# remat plan -> (steps, attention forwards that its backward runs again, per
# step). Levels 2 and 3 are ``block`` under ``mixed`` with the default levels:
# their 18 sites (audio, down and up stacks) run again; under ``block`` all 36
# sites inside UNet blocks do. The three middle transformers are in no block.
FULLSONG_PLANS = {"mixed": (4, 18), "save-attn-out": (2, 0), "block": (2, 36), "none": (2, 0)}
FULLSONG_T = 65536


def _fullsong_config(plan: str, project_dir: Path, steps: int, save_every: int, mesh_seq: int = 1):
    """The full-song cell under remat plan ``plan``, to ``steps`` steps."""
    from osufusion_tpu_torch.config import Config, ModelConfig, TrainConfig

    return Config(
        model=ModelConfig(dim_h=512, remat=plan != "none", remat_mode=plan if plan != "none" else "save-attn"),
        # dummy samples are 16384..65536 frames at this segment length, padded to 65536
        train=TrainConfig(project_dir=str(project_dir), dataset_mode="dummy", segment_length=FULLSONG_T // 2,
                          batch_size=1, full_bf16=True, total_steps=steps, warmup_steps=2, save_every=save_every,
                          num_workers=2, seed=0, mesh_seq=mesh_seq),
    )


def phase_fullsong_train(workdir: Path) -> tuple[dict, list]:
    """The trainer at the full-song cell (dim_h=512, B=1, T=65536, full bf16,
    every attention site windowed) under each plan of FULLSONG_PLANS, ``mixed``
    with a save and a resume half way; returns ``mixed``'s launches and
    losses."""
    losses, mixed_launches = {}, None
    for plan, (steps, again) in FULLSONG_PLANS.items():
        resume = plan == "mixed"
        cfg = _fullsong_config(plan, workdir / f"fullsong_{plan}", steps // 2 if resume else steps,
                               steps // 2 if resume else 0)
        sites = 3 * sum(cfg.model.num_layer_blocks) + cfg.model.num_middle_transformers
        history, launches, peak = _train_with_resume(cfg, steps, f"full-song {plan}")
        losses[plan] = [h["loss"] for h in history]
        _log(f"[full-song {plan}] dim_h=512 B=1 T={FULLSONG_T} full bf16, {steps} steps"
             f"{' (save and resume at ' + str(steps // 2) + ')' if resume else ''}: "
             f"loss {[round(x, 4) for x in losses[plan]]}; grad_norm {[round(h['grad_norm'], 4) for h in history]}; "
             f"s/step {[round(h['seconds'], 4) for h in history]}; peak memory {peak:.2f} GiB; "
             f"launches over {steps} steps {launches} (sites {sites}, {again} run again per step)")
        expected = {"forward": 0, "forward_lse": (sites + again) * steps, "backward_fused": 0,
                    "backward_dq": sites * steps, "backward_dkv": sites * steps, "forward_grouped": 0, "backward_grouped": 0}
        if launches != expected:
            raise AssertionError(f"full-song {plan}: launches {launches}, expected {expected}")
        if resume:
            mixed_launches = launches
    # the same seed gives every plan the same batches and draws, and a plan changes no arithmetic
    for plan, values in losses.items():
        for got, want in zip(values, losses["mixed"]):
            if abs(got - want) > 5e-4 * abs(want):
                raise AssertionError(f"full-song {plan}: loss {values} differs from mixed's {losses['mixed']}")
    return mixed_launches, losses["mixed"]


def phase_gqa_fullsong_train(workdir: Path) -> dict:
    """The full-song cell with two KV heads (``--model-attn-kv-heads 2``):
    every site is a windowed GQA site, which the op runs once per KV head
    through the windowed forward with its LSE and the windowed dq / dkv pair.
    2 steps under ``mixed``; returns the launches."""
    kv, steps = 2, 2
    cfg = _fullsong_config("mixed", workdir / "fullsong_gqa", steps, 0)
    cfg = dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, attn_kv_heads=kv))
    sites = 3 * sum(cfg.model.num_layer_blocks) + cfg.model.num_middle_transformers
    again = FULLSONG_PLANS["mixed"][1]
    history, launches, peak = _train_with_resume(cfg, steps, "full-song GQA")
    _log(f"[full-song GQA] dim_h=512 B=1 T={FULLSONG_T} attn_kv_heads={kv} full bf16 mixed, {steps} steps: "
         f"loss {[round(h['loss'], 4) for h in history]}; grad_norm {[round(h['grad_norm'], 4) for h in history]}; "
         f"s/step {[round(h['seconds'], 4) for h in history]}; peak memory {peak:.2f} GiB; launches {launches} "
         f"(sites {sites}, {again} run again per step, each once per KV head)")
    expected = {"forward": 0, "forward_lse": (sites + again) * kv * steps, "backward_fused": 0,
                "backward_dq": sites * kv * steps, "backward_dkv": sites * kv * steps, "forward_grouped": 0,
                "backward_grouped": 0}
    if launches != expected:
        raise AssertionError(f"full-song GQA: launches {launches}, expected {expected}")
    return launches


# the halo kernels' shapes for a T=65536 song: (shards, T_local, W) at level 0
# of four and of two shards and at level 3 of four; each at its first, second
# and last shard
HALO_SONG = 65536
HALO_SHAPES = ((4, 16384, 4096), (4, 2048, 512), (2, 32768, 4096))


def _halo_bytes(T: int, S: int, H: int, D: int, rows: int, slabs: int, stats: int, f32_slabs: int = 0) -> int:
    """Bytes of ``rows`` (T, H, D) and ``slabs`` (S, D) bf16 tensors,
    ``f32_slabs`` (S, D) fp32 ones and ``stats`` (T, H) fp32 vectors, B=1,
    each moved once."""
    return T * H * D * 2 * rows + S * D * (2 * slabs + 4 * f32_slabs) + T * H * 4 * stats


def phase_halo_kernels() -> tuple[dict, dict, dict]:
    """K4, K5a (with the pre-pass it shares with K5b) and K5b vs their plain
    versions at every shard of HALO_SHAPES; returns their records at the
    four-shard level-0 second shard (errors: the worst over every case)."""
    import torch.nn.functional as F

    from osufusion_tpu_torch.ops import flash_attention as fa
    from osufusion_tpu_torch.ops import halo_attention as ha
    from osufusion_tpu_torch.utils.flops import halo_flops

    H, D = 16, 64
    scale = D**-0.5
    failures, records, worst = [], None, {"fwd": 0.0, "dq": 0.0, "dkv": 0.0}
    for shards, T, W in HALO_SHAPES:
        t_song = T * shards
        for shard in sorted({0, 1, shards - 1}):
            g0 = shard * T
            frame = (W, g0, t_song)
            label = f"{shards} shards, T_local={T} W={W} shard {shard}"
            g = torch.Generator(device="cuda").manual_seed(400 + shard + T)
            q, do = (torch.randn((1, T, H, D), generator=g, device="cuda").to(torch.bfloat16) for _ in range(2))
            # the slab rows outside the song hold random values: the kernels must not look at them
            k, v = (torch.randn((1, T + W, D), generator=g, device="cuda").to(torch.bfloat16) for _ in range(2))

            def backward():
                dq, prep = ha.halo_bwd_dq(q, k, v, o, lse, do, *frame, scale)
                return (dq, *ha.halo_bwd_dkv(k, v, do, prep, *frame))

            o, lse = ha.halo_fwd(q, k, v, *frame, scale)
            grads = backward()
            torch.cuda.synchronize()
            if not all(torch.equal(a, b) for a, b in zip(grads, backward())):
                failures.append(f"{label}: dq, dk or dv differ between two launches on the same inputs")

            def plain(k_in, v_in, window, g0_in, song):
                o_p, lse_p = ha.halo_fwd_reference(q, k_in, v_in, window, g0_in, song)
                return (o_p, lse_p, ha.halo_bwd_dq_reference(q, k_in, v_in, o_p, lse_p, do, window, g0_in, song),
                        *ha.halo_bwd_dkv_reference(q, k_in, v_in, o_p, lse_p, do, window, g0_in, song))

            o_ref, lse_ref, *refs = plain(k, v, *frame)
            # planted faults, in the plain version: a window one key short on each side (the same
            # frame, one slab row less each side); one key outside the song admitted at its start or end
            short = plain(k[:, 1:-1], v[:, 1:-1], W - 2, g0, t_song)
            short_rel = [_rel(short[0], o_ref), _rel(short[2], refs[0]),
                         _rel(short[3], refs[1][:, 1:-1]), _rel(short[4], refs[2][:, 1:-1])]
            del short
            o_rel, o_err = _rel(o, o_ref), (o.float() - o_ref).abs().max().item()
            lse_err = (lse - lse_ref).abs().max().item()
            worst["fwd"] = max(worst["fwd"], o_err)
            if not (o_rel < REL_TOL and o_err < ABS_TOL and lse_err < LSE_TOL and torch.isfinite(lse).all()):
                failures.append(f"forward {label}: o rel L2 {o_rel:.3e}, max abs {o_err:.3e}, lse max abs {lse_err:.3e}")
            parts = []
            for name, got, ref in zip(("dq", "dk", "dv"), grads, refs):
                rel, err, top = _rel(got, ref), (got.float() - ref).abs().max().item(), ref.abs().max().item()
                key = "dq" if name == "dq" else "dkv"
                worst[key] = max(worst[key], err)
                parts.append(f"{name} rel L2 {rel:.3e} max abs {err:.3e} of {top:.2f}")
                if not (rel < BWD_REL_TOL and err < BWD_ABS_TOL * top and torch.isfinite(got).all()):
                    failures.append(f"backward {label}: {name} rel L2 {rel:.3e}, max abs {err:.3e} of {top:.3e}")
            lo, hi = ha.slab_bounds(T, *frame)
            if any(t[:, :lo].any() or t[:, hi:].any() for t in grads[1:]):
                failures.append(f"{label}: dk or dv not zero at the slab rows outside the song [{lo}, {hi})")
            if not min(short_rel) > REL_TOL:
                failures.append(f"{label}: planted short window {short_rel} would pass {REL_TOL}")
            edge = ""
            if shard in (0, shards - 1):
                # admit the key just outside the song; measured over the rows whose window reaches it
                bad = plain(k, v, W, g0 + 1, t_song) if shard == 0 else plain(k, v, W, g0, t_song + 1)
                rows = slice(0, W // 2) if shard == 0 else slice(T - W // 2, T)
                edge_rel = [_rel(bad[0][:, rows], o_ref[:, rows]), _rel(bad[2][:, rows], refs[0][:, rows])]
                kernel_rel = [_rel(o[:, rows], o_ref[:, rows]), _rel(grads[0][:, rows], refs[0][:, rows])]
                edge = (f"; edge rows: kernel o/dq rel L2 {kernel_rel[0]:.3e}/{kernel_rel[1]:.3e}, planted key past the "
                        f"song {edge_rel[0]:.3e}/{edge_rel[1]:.3e}")
                del bad
                if not max(kernel_rel) < REL_TOL:
                    failures.append(f"{label}: the rows at the song's edge err by {kernel_rel}")
                if not min(edge_rel) > REL_TOL:
                    failures.append(f"{label}: planted key past the song's edge {edge_rel} would pass {REL_TOL}")

            fwd_ms = _cuda_ms(lambda: ha.halo_fwd(q, k, v, *frame, scale), 20)
            prep = ha.halo_bwd_dq(q, k, v, o, lse, do, *frame, scale)[1]
            prep_ms = _cuda_ms(lambda: fa.windowed_prep(q, o, lse, do, None, None, scale), 10)
            dq_ms = _cuda_ms(lambda: ha.halo_bwd_dq(q, k, v, o, lse, do, *frame, scale), 10)  # the pre-pass included
            dkv_ms = _cuda_ms(lambda: ha.halo_bwd_dkv(k, v, do, prep, *frame), 10)
            fwd_plain_ms = _cuda_ms(lambda: ha.halo_fwd_reference(q, k, v, *frame), 1)
            dq_plain_ms = _cuda_ms(lambda: ha.halo_bwd_dq_reference(q, k, v, o, lse_ref, do, *frame), 1)
            dkv_plain_ms = _cuda_ms(lambda: ha.halo_bwd_dkv_reference(q, k, v, o, lse_ref, do, *frame), 1)
            S = T + W
            # q o; k v; lse / q o do dq, qs out; k v; lse in, lse delta out / qs do; k v; lse delta; dk dv in fp32
            bounds = {
                "fwd": _bound(halo_flops("forward", 1, T, H, D, *frame), _halo_bytes(T, S, H, D, 2, 2, 1)),
                "dq": _bound(halo_flops("backward_dq", 1, T, H, D, *frame), _halo_bytes(T, S, H, D, 5, 2, 3)),
                "dkv": _bound(halo_flops("backward_dkv", 1, T, H, D, *frame), _halo_bytes(T, S, H, D, 2, 2, 2, f32_slabs=2)),
            }
            _log(f"[halo kernels] {label}: forward o rel L2 {o_rel:.3e} max abs {o_err:.3e}, lse max abs {lse_err:.3e}; "
                 f"backward {'; '.join(parts)}; planted short window {', '.join(f'{x:.3e}' for x in short_rel)}{edge}; "
                 f"slab rows outside the song zero; two launches bit-identical")
            _log(f"[halo kernels] {label}: forward {fwd_ms:.3f} ms (bound {bounds['fwd'][0]:.3f} by {bounds['fwd'][1]}; plain "
                 f"{fwd_plain_ms:.3f}); dq {dq_ms:.3f} ms with its pre-pass {prep_ms:.3f} ms (bound "
                 f"{bounds['dq'][0]:.3f}; plain {dq_plain_ms:.3f}); dkv {dkv_ms:.3f} ms (bound {bounds['dkv'][0]:.3f}; "
                 f"plain {dkv_plain_ms:.3f})")
            if W == 4096 and shard == 1:
                # yardstick only: PyTorch's fused attention on the same rotated inputs under a dense
                # (T_local, T_local + W) band-and-bounds mask, and its backward; both visit every tile
                t_idx = torch.arange(T, device="cuda")[:, None]
                s_idx = torch.arange(S, device="cuda")[None, :]
                mask = (s_idx >= t_idx) & (s_idx <= t_idx + W) & (s_idx >= lo) & (s_idx < hi)
                leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]

                def library(q_in, k_in, v_in):
                    return F.scaled_dot_product_attention(q_in.transpose(1, 2), k_in[:, None], v_in[:, None],
                                                          attn_mask=mask, enable_gqa=True).transpose(1, 2)

                with torch.no_grad():
                    lib_fwd_ms = _cuda_ms(lambda: library(q, k, v), 2)
                lib_out = library(*leaves)
                lib_rel = _rel(lib_out, o.float())
                lib_bwd_ms = _cuda_ms(lambda: torch.autograd.grad(lib_out, leaves, do, retain_graph=True), 2)
                _log(f"[halo kernels] {label}: SDPA with a band-and-bounds mask forward {lib_fwd_ms:.3f} ms, vs kernel rel L2 "
                     f"{lib_rel:.1e}; its backward {lib_bwd_ms:.3f} ms (dq + dkv: {dq_ms + dkv_ms:.3f} ms)")
                if not lib_rel < LIBRARY_REL_TOL:
                    failures.append(f"{label}: SDPA with a band-and-bounds mask differs from the kernel by {lib_rel:.3e}")
                del mask, leaves, lib_out, t_idx, s_idx
                if shards == 4:
                    # the one library backward yields dq, dk and dv: each kernel of the pair is set beside the whole of it
                    records = {"fwd": {"ms": fwd_ms, "plain_ms": fwd_plain_ms, "library_ms": lib_fwd_ms},
                               "dq": {"ms": dq_ms, "plain_ms": dq_plain_ms, "library_ms": lib_bwd_ms},
                               "dkv": {"ms": dkv_ms, "plain_ms": dkv_plain_ms, "library_ms": lib_bwd_ms}}
                    for key, rec in records.items():
                        rec["bound_ms"], rec["bound_by"] = bounds[key]
            del q, k, v, do, o, lse, grads, o_ref, lse_ref, refs, prep
            torch.cuda.empty_cache()
    if failures:
        raise AssertionError("halo kernels vs plain: " + "; ".join(failures))
    return tuple({"max_abs_err": worst[key], **records[key]} for key in ("fwd", "dq", "dkv"))


def phase_halo_composition() -> None:
    """The halo kernels over the four shards of a song against the
    single-card windowed kernels on the whole song."""
    import torch.nn.functional as F

    from osufusion_tpu_torch.ops import flash_attention as fa
    from osufusion_tpu_torch.ops import halo_attention as ha
    from osufusion_tpu_torch.ops.rope import apply_rope, rope_tables, unapply_rope

    T, W, shards, H, D = HALO_SONG, 4096, 4, 16, 64
    scale, w2, t_local = D**-0.5, W // 2, T // shards
    g = torch.Generator(device="cuda").manual_seed(500)
    q, do = (torch.randn((1, T, H, D), generator=g, device="cuda").to(torch.bfloat16) for _ in range(2))
    k, v = (torch.randn((1, T, D), generator=g, device="cuda").to(torch.bfloat16) for _ in range(2))
    cos, sin = rope_tables(T, D, scale_base=float(W), device="cuda")
    k_rot = fa.rotated_k(k, cos, sin)
    o, lse = fa.flash_fwd(q, k_rot, v, cos, sin, W, scale, return_lse=True)
    dq, prep = fa.flash_bwd_dq(q, k_rot, v, o, lse, do, cos, sin, W, scale)
    dk, dv = fa.flash_bwd_dkv(k_rot, v, do, prep, W)

    q_rot = apply_rope(q.float(), cos, sin).to(torch.bfloat16)
    k_pad, v_pad = (F.pad(t, (0, 0, w2, w2)) for t in (k_rot, v))  # the exchange's zeros past the ends
    o_parts, lse_parts, dq_parts = [], [], []
    dk_slab = torch.zeros((1, T + W, D), device="cuda")
    dv_slab = torch.zeros_like(dk_slab)
    for g0 in range(0, T, t_local):
        frame = (W, g0, T)
        q_s, do_s = q_rot[:, g0 : g0 + t_local].contiguous(), do[:, g0 : g0 + t_local].contiguous()
        k_s, v_s = k_pad[:, g0 : g0 + t_local + W].contiguous(), v_pad[:, g0 : g0 + t_local + W].contiguous()
        o_s, lse_s = ha.halo_fwd(q_s, k_s, v_s, *frame, scale)
        dq_s, prep_s = ha.halo_bwd_dq(q_s, k_s, v_s, o_s, lse_s, do_s, *frame, scale)
        dk_s, dv_s = ha.halo_bwd_dkv(k_s, v_s, do_s, prep_s, *frame)
        o_parts.append(o_s)
        lse_parts.append(lse_s)
        dq_parts.append(dq_s)
        dk_slab[:, g0 : g0 + t_local + W] += dk_s  # each slab's gradient back onto its home rows
        dv_slab[:, g0 : g0 + t_local + W] += dv_s
    torch.cuda.synchronize()
    got = {"o": torch.cat(o_parts, dim=1), "dq": unapply_rope(torch.cat(dq_parts, dim=1).float(), cos, sin),
           "dk": dk_slab[:, w2 : w2 + T], "dv": dv_slab[:, w2 : w2 + T]}
    rels = {name: _rel(got[name], want.float()) for name, want in (("o", o), ("dq", dq), ("dk", dk), ("dv", dv))}
    lse_err = (torch.cat(lse_parts, dim=1) - lse).abs().max().item()
    outside = max(t.abs().max().item() for t in (dk_slab[:, :w2], dk_slab[:, w2 + T :], dv_slab[:, :w2], dv_slab[:, w2 + T :]))
    _log(f"[halo composition] {shards} shards of T={T} W={W} through the halo kernels vs the single-card windowed kernels: "
         f"rel L2 {', '.join(f'{n} {r:.3e}' for n, r in rels.items())} (bound {REL_TOL}); lse max abs {lse_err:.3e}; "
         f"dk, dv past the song's ends {outside:.1e}")
    if not (max(rels.values()) < REL_TOL and lse_err < LSE_TOL and outside == 0.0):
        raise AssertionError(f"halo composition: rel L2 {rels}, lse max abs {lse_err:.3e}, dk/dv past the ends {outside}")


SEQ_SHARDS = 2


def _free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def _halo_counts(ha, reset: bool = False) -> dict:
    if reset:
        ha.halo_fwd.launches = ha.halo_bwd_dq.launches = ha.halo_bwd_dkv.launches = 0
    return {"halo_fwd": ha.halo_fwd.launches, "halo_bwd_dq": ha.halo_bwd_dq.launches, "halo_bwd_dkv": ha.halo_bwd_dkv.launches}


# a windowed GQA site of the whole song under the sequence shard: (T, W, H, Kv)
SEQ_GQA_SITE = (HALO_SONG, 4096, 16, 2)


def _seq_gqa_site(shard) -> dict:
    """One windowed site with two KV heads through ``ops.attention.sdpa`` on
    this rank's frames, forward and backward, against the one-card
    ``flash_attention`` on the whole song (seeded alike on every rank):
    relative L2 of o, dq, dk, dv on this rank's frames, and the halo
    kernels' launches (once per KV head)."""
    from osufusion_tpu_torch.ops import halo_attention as ha
    from osufusion_tpu_torch.ops.attention import sdpa
    from osufusion_tpu_torch.ops.flash_attention import flash_attention
    from osufusion_tpu_torch.ops.rope import rope_tables
    from osufusion_tpu_torch.parallel.sequence import frames_of, sequence_sharding

    T, W, H, kv = SEQ_GQA_SITE
    g = torch.Generator(device="cuda").manual_seed(700)
    q, do = (torch.randn((1, T, H, 64), generator=g, device="cuda").to(torch.bfloat16) for _ in range(2))
    k, v = (torch.randn((1, T, kv, 64), generator=g, device="cuda").to(torch.bfloat16) for _ in range(2))
    rope = rope_tables(T, 64, scale_base=float(W), device="cuda")
    whole = [t.clone().requires_grad_(True) for t in (q, k, v)]
    o = flash_attention(*whole, W, rope)
    o.backward(do)
    want = [frames_of(t, shard).float() for t in (o.detach(), *(x.grad for x in whole))]
    del whole, o
    local = [frames_of(t, shard).clone().requires_grad_(True) for t in (q, k, v)]
    _halo_counts(ha, reset=True)
    with sequence_sharding(shard):
        o = sdpa(*local, W, rope)
        o.backward(frames_of(do, shard))
    torch.cuda.synchronize()
    launches = _halo_counts(ha)
    got = (o.detach(), *(x.grad for x in local))
    return {"launches": launches, "rel": {n: _rel(a, b) for n, a, b in zip(("o", "dq", "dk", "dv"), got, want)}}


def _seq_rank(rank: int, port: int, project_dir: str, results) -> None:
    """One process of phase 12, in torchrun's environment: a windowed GQA
    site (``_seq_gqa_site``); then every count set to 0, ``trainer.train``
    for one step with a save, again from the checkpoint for a second step,
    the counts read; (rank, error, result) put on ``results``."""
    import os
    import traceback

    os.environ.update({"MASTER_ADDR": "localhost", "MASTER_PORT": str(port), "WORLD_SIZE": str(SEQ_SHARDS),
                       "RANK": str(rank), "LOCAL_RANK": str(rank), "LOCAL_WORLD_SIZE": str(SEQ_SHARDS)})
    try:
        import torch.distributed as dist

        from osufusion_tpu_torch.ops import flash_attention as fa
        from osufusion_tpu_torch.ops import halo_attention as ha
        from osufusion_tpu_torch.parallel.distributed import local_device, maybe_initialize
        from osufusion_tpu_torch.parallel.mesh import make_mesh
        from osufusion_tpu_torch.trainer import train

        cfg = _fullsong_config("mixed", Path(project_dir), steps=1, save_every=1, mesh_seq=SEQ_SHARDS)
        torch.cuda.set_device(local_device())
        maybe_initialize()
        gqa = _seq_gqa_site(make_mesh(data=1, model=1, seq=SEQ_SHARDS).seq_shard())
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        _reset_launches(fa)
        _halo_counts(ha, reset=True)
        history = train(cfg)
        history += train(dataclasses.replace(cfg, train=dataclasses.replace(cfg.train, total_steps=2, resume="latest")))
        torch.cuda.synchronize()
        launches = {**_halo_counts(ha), **_launches(fa)}
        results.put((rank, None, {"history": history, "launches": launches, "backend": dist.get_backend(), "gqa": gqa,
                                  "device": str(local_device()), "peak": torch.cuda.max_memory_allocated() / 2**30}))
        dist.destroy_process_group()
    except Exception:  # reported to the parent, which fails on it
        results.put((rank, traceback.format_exc(), None))


def phase_seq_train(workdir: Path, one_card_losses: list) -> dict:
    """Sequence-parallel training in SEQ_SHARDS processes (phase 12); returns
    rank 0's launches over its two steps."""
    import multiprocessing
    import queue as queue_module

    cfg = _fullsong_config("mixed", workdir / "seq", steps=1, save_every=1, mesh_seq=SEQ_SHARDS)
    sites = 3 * sum(cfg.model.num_layer_blocks) + cfg.model.num_middle_transformers
    steps, again = 2, FULLSONG_PLANS["mixed"][1]
    expected = {"halo_fwd": (sites + again) * steps, "halo_bwd_dq": sites * steps, "halo_bwd_dkv": sites * steps,
                "forward": 0, "forward_lse": 0, "backward_fused": 0, "backward_dq": 0, "backward_dkv": 0,
                "forward_grouped": 0, "backward_grouped": 0}
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    port = _free_port()
    torch.cuda.empty_cache()
    procs = [ctx.Process(target=_seq_rank, args=(r, port, str(workdir / "seq"), results)) for r in range(SEQ_SHARDS)]
    for p in procs:
        p.start()
    got, deadline = {}, time.monotonic() + 900
    try:
        while len(got) < SEQ_SHARDS:
            try:
                rank, error, value = results.get(timeout=5)
            except queue_module.Empty:
                if time.monotonic() > deadline or any(p.exitcode is not None and r not in got for r, p in enumerate(procs)):
                    raise AssertionError(f"sequence-parallel training: ranks {sorted(set(range(SEQ_SHARDS)) - set(got))} "
                                         f"did not report (exit codes {[p.exitcode for p in procs]})") from None
                continue
            if error is not None:
                raise AssertionError(f"sequence-parallel rank {rank}:\n{error}")
            got[rank] = value
    finally:
        for p in procs:
            p.join(timeout=120)
            if p.is_alive():
                p.terminate()
                p.join()
    T, W, H, kv = SEQ_GQA_SITE
    for rank, r in sorted(got.items()):
        gqa = r["gqa"]
        _log(f"[seq train] rank {rank}: a windowed site with {kv} KV heads (T={T} W={W} H={H}) under the shard vs one-card "
             f"flash_attention: rel L2 {', '.join(f'{n} {x:.3e}' for n, x in gqa['rel'].items())} (bound {REL_TOL}); "
             f"halo launches {gqa['launches']} (once per KV head)")
        if gqa["launches"] != {"halo_fwd": kv, "halo_bwd_dq": kv, "halo_bwd_dkv": kv}:
            raise AssertionError(f"sequence-parallel rank {rank}: the GQA site launched {gqa['launches']}, expected {kv} of each")
        if not max(gqa["rel"].values()) < REL_TOL:
            raise AssertionError(f"sequence-parallel rank {rank}: the GQA site differs from one card by {gqa['rel']}")
    for rank, r in sorted(got.items()):
        history = r["history"]
        _log(f"[seq train] rank {rank} of {SEQ_SHARDS} on {r['device']} ({r['backend']}; {torch.cuda.device_count()} card(s) "
             f"visible): dim_h=512 B=1 T={FULLSONG_T} ({FULLSONG_T // SEQ_SHARDS} frames a rank) full bf16 mixed, 2 steps "
             f"(save and resume at 1): loss {[round(h['loss'], 5) for h in history]}; grad_norm "
             f"{[round(h['grad_norm'], 4) for h in history]}; s/step {[round(h['seconds'], 3) for h in history]}; "
             f"peak memory {r['peak']:.2f} GiB; launches over 2 steps {r['launches']} (expected {expected})")
        if [h["step"] for h in history] != [1, 2]:
            raise AssertionError(f"sequence-parallel rank {rank}: steps {[h['step'] for h in history]}, expected [1, 2]")
        if not all(np.isfinite(h["loss"]) and np.isfinite(h["grad_norm"]) and h["grad_norm"] > 0 for h in history):
            raise AssertionError(f"sequence-parallel rank {rank}: non-finite or zero loss or grad_norm {history}")
        if r["launches"] != expected:
            raise AssertionError(f"sequence-parallel rank {rank}: launches {r['launches']}, expected {expected}")
    losses = [[(h["loss"], h["grad_norm"]) for h in r["history"]] for r in got.values()]
    if any(x != losses[0] for x in losses):
        raise AssertionError(f"the sequence-parallel ranks report different losses or norms: {losses}")
    rel = abs(losses[0][0][0] - one_card_losses[0]) / abs(one_card_losses[0])
    _log(f"[seq train] step 1 loss {losses[0][0][0]:.6f} vs one card {one_card_losses[0]:.6f} (phase 9, same seed and batch): "
         f"rel {rel:.3e} (bound {LOSS_REL_TOL})")
    if not rel < LOSS_REL_TOL:
        raise AssertionError(f"sequence-parallel step 1 loss {losses[0][0][0]} vs one card {one_card_losses[0]}")
    return got[0]["launches"]


def phase_serve_trained(workdir: Path) -> None:
    """Close the loop: the checkpoint the trainer wrote serves a 60 s song."""
    from osufusion_tpu_torch.serve import generate_beatmap, load_model

    model, params = load_model(workdir / "train_save-attn" / "model.safetensors")
    wav = workdir / "song_c.wav"
    synth_song(wav, 60.0, seed=ord("c"))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    data, osu_texts = generate_beatmap(model, params, wav, title="smoke c", sampling_timesteps=50, cond_scale=2.0, seed=0)
    latency = time.perf_counter() - t0
    hits = check_osz(data, osu_texts, 1)
    _log(f"[serve trained] dim_h={params.cfg.dim_h} checkpoint from the trainer, 60 s song, DDIM-50, CFG 2.0: "
         f"{latency:.3f} s end to end; {len(data)} byte .osz; hit objects {hits}")


# the grouped forms of K1 and K2 (DiT, MMDiT; D=64, no rotary tables): (label,
# B, T, H, Kv, with the backward). DiT's training site; MMDiT's packed [audio;
# osu] site (4096 frames in patches of 4: 1024 tokens a stream); a length no
# tile divides; a DiT serving a 180 s song (24576 padded frames) under CFG
GROUPED_SHAPES = (("DiT train", 4, 4096, 8, 8, True), ("MMDiT train", 4, 2048, 8, 2, True),
                  ("ragged", 4, 4000, 8, 8, True), ("DiT serve", 2, 24576, 8, 8, False))
# the transformer cells: dim_h=512, depth 12, heads of 64, B=4, T=4096 (the
# JAX package's bench cells); MMDiT with 2 KV heads and patches of 4
TRANSFORMER = dict(dim_h=512, depth=12, attn_heads=8, attn_kv_heads=2, patch_size=4)


def _grouped_bytes(B: int, T: int, H: int, Kv: int, D: int, rows: int, keys: int, f32_keys: int, stats: int) -> int:
    """Bytes of ``rows`` (B,T,H,D) and ``keys`` (B,T,Kv,D) bf16 tensors,
    ``f32_keys`` (B,T,Kv,D) fp32 ones and ``stats`` (B,T,H) fp32 vectors, each
    moved once (no tables)."""
    return B * T * H * D * 2 * rows + B * T * Kv * D * (2 * keys + 4 * f32_keys) + B * T * H * 4 * stats


def phase_grouped_kernels() -> tuple[dict, dict, dict]:
    """K1 and K2 in their grouped form vs their plain versions at
    GROUPED_SHAPES; returns the records of the forward with its LSE and of the
    backward at DiT's training site, and of the forward without its LSE at the
    serving site (errors: the worst over the shapes)."""
    import torch.nn.functional as F

    from osufusion_tpu_torch.ops import flash_attention as fa
    from osufusion_tpu_torch.utils.flops import attention_flops

    D = 64
    scale = D**-0.5
    failures, records, worst = [], {}, {"fwd": 0.0, "bwd": 0.0}
    for i, (label, B, T, H, Kv, backward) in enumerate(GROUPED_SHAPES):
        g = torch.Generator(device="cuda").manual_seed(600 + i)
        q, do = (torch.randn((B, T, H, D), generator=g, device="cuda").to(torch.bfloat16) for _ in range(2))
        k, v = (torch.randn((B, T, Kv, D), generator=g, device="cuda").to(torch.bfloat16) for _ in range(2))
        G = H // Kv
        # planted fault: query head h against KV head h % Kv instead of h // G (at full MHA, where the
        # two agree, against the next head)
        wrong = torch.arange(H, device="cuda") % Kv if G > 1 else (torch.arange(H, device="cuda") + 1) % H
        where = f"{label} (B={B} T={T} H={H} Kv={Kv})"

        o, lse = fa.flash_fwd(q, k, v, None, None, -1, scale, return_lse=True)
        torch.cuda.synchronize()
        o_ref, lse_ref = fa.flash_fwd_lse_reference(q, k, v, None, None)
        o_fault = fa.flash_fwd_lse_reference(q, k[:, :, wrong], v[:, :, wrong], None, None)[0]
        o_rel, o_err = _rel(o, o_ref), (o.float() - o_ref).abs().max().item()
        lse_err, head_fault = (lse - lse_ref).abs().max().item(), _rel(o_fault, o_ref)
        del o_fault
        worst["fwd"] = max(worst["fwd"], o_err)
        if not (o_rel < REL_TOL and o_err < ABS_TOL and lse_err < LSE_TOL and torch.isfinite(lse).all()):
            failures.append(f"forward {where}: o rel L2 {o_rel:.3e}, max abs {o_err:.3e}, lse max abs {lse_err:.3e}")
        if not head_fault > REL_TOL:
            failures.append(f"forward {where}: planted head fault {head_fault:.3e} would pass {REL_TOL}")
        parts = []
        if backward:
            dq, dk, dv = fa.flash_bwd(q, k, v, o, lse, do, None, None, scale)
            torch.cuda.synchronize()
            refs = fa.flash_bwd_reference(q, k, v, o_ref, lse_ref, do, None, None)
            faults = fa.flash_bwd_reference(q, k, v, o_ref, lse_ref + LSE_FAULT, do, None, None)
            for name, got, ref, fault in zip(("dq", "dk", "dv"), (dq, dk, dv), refs, faults):
                rel, err, top = _rel(got, ref), (got.float() - ref).abs().max().item(), ref.abs().max().item()
                fault_rel = _rel(fault, ref)
                worst["bwd"] = max(worst["bwd"], err)
                parts.append(f"{name} rel L2 {rel:.3e} max abs {err:.3e} of {top:.2f} (lse fault {fault_rel:.3e})")
                if not (rel < BWD_REL_TOL and err < BWD_ABS_TOL * top and torch.isfinite(got).all()):
                    failures.append(f"backward {where}: {name} rel L2 {rel:.3e}, max abs {err:.3e} of {top:.3e}")
                if not fault_rel > BWD_REL_TOL:
                    failures.append(f"backward {where}: planted lse fault in {name} {fault_rel:.3e} would pass {BWD_REL_TOL}")
            del refs, faults, dq, dk, dv
        del o_ref, lse_ref
        _log(f"[grouped kernels] {where}: forward o rel L2 {o_rel:.3e} max abs {o_err:.3e} (head fault {head_fault:.3e}), "
             f"lse max abs {lse_err:.3e}" + (f"; backward {'; '.join(parts)}" if parts else ""))

        # times: the forward as the path runs it (with its LSE in training, without in serving)
        fwd_ms = _cuda_ms(lambda: fa.flash_fwd(q, k, v, None, None, -1, scale, return_lse=backward), 10)
        fwd_plain_ms = _cuda_ms(lambda: fa.flash_fwd_lse_reference(q, k, v, None, None), 2)
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))  # yardstick only, never called by the port
        with torch.no_grad():
            lib_fwd_ms = _cuda_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt, enable_gqa=True), 10)
        fwd_bound = _bound(attention_flops("forward", B, T, H, D, None),
                           _grouped_bytes(B, T, H, Kv, D, 2, 2, 0, 1 if backward else 0))  # q o; k v; lse
        line = (f"[grouped kernels] {where}: forward{' with LSE' if backward else ''} {fwd_ms:.3f} ms (bound "
                f"{fwd_bound[0]:.3f} by {fwd_bound[1]}; plain {fwd_plain_ms:.3f}; SDPA {lib_fwd_ms:.3f})")
        rec = {"fwd": {"ms": fwd_ms, "plain_ms": fwd_plain_ms, "bound_ms": fwd_bound[0], "bound_by": fwd_bound[1],
                       "library_ms": lib_fwd_ms}}
        if backward:
            bwd_ms = _cuda_ms(lambda: fa.flash_bwd(q, k, v, o, lse, do, None, None, scale), 10)
            bwd_plain_ms = _cuda_ms(lambda: fa.flash_bwd_reference(q, k, v, o, lse, do, None, None), 2)
            leaves = [x.detach().clone().requires_grad_(True) for x in (qt, kt, vt)]
            lib_out = F.scaled_dot_product_attention(*leaves, enable_gqa=True)
            lib_rel = _rel(lib_out.transpose(1, 2), o.float())
            dot = do.transpose(1, 2)
            lib_bwd_ms = _cuda_ms(lambda: torch.autograd.grad(lib_out, leaves, dot, retain_graph=True), 10)
            del lib_out, leaves
            bwd_bound = _bound(attention_flops("backward_fused", B, T, H, D, None),
                               _grouped_bytes(B, T, H, Kv, D, 4, 2, 2, 1))  # q o do dq; k v; dk dv in fp32; lse
            line += (f"; backward {bwd_ms:.3f} ms (bound {bwd_bound[0]:.3f} by {bwd_bound[1]}; plain {bwd_plain_ms:.3f}; "
                     f"SDPA backward {lib_bwd_ms:.3f}); SDPA vs kernel rel L2 {lib_rel:.1e}")
            if not lib_rel < LIBRARY_REL_TOL:
                failures.append(f"{where}: SDPA differs from the kernel by {lib_rel:.3e}")
            rec["bwd"] = {"ms": bwd_ms, "plain_ms": bwd_plain_ms, "bound_ms": bwd_bound[0], "bound_by": bwd_bound[1],
                          "library_ms": lib_bwd_ms}
        _log(line)
        if label == "DiT train":
            records["fwd_lse"], records["bwd"] = rec["fwd"], rec["bwd"]
        elif label == "DiT serve":
            records["fwd"] = rec["fwd"]
        del q, k, v, do, o, lse, qt, kt, vt
        torch.cuda.empty_cache()
    if failures:
        raise AssertionError("grouped kernels vs plain: " + "; ".join(failures))
    return ({"max_abs_err": worst["fwd"], **records["fwd_lse"]}, {"max_abs_err": worst["bwd"], **records["bwd"]},
            {"max_abs_err": worst["fwd"], **records["fwd"]})


def randomize_transformer(net, seed: int) -> None:
    """Make every parameter of a DiT or MMDiT random: biases N(0, 0.1),
    RMSNorm gammas 1 + N(0, 0.1), and the kernels that start at zero (the
    adaLN modulations, the output layers) N(0, 0.5 / fan_in): a fresh model's
    zero gates would zero every attention gradient."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in net.named_parameters():
            if name.endswith("bias"):
                p.copy_(torch.randn(p.shape, generator=g) * 0.1)
            elif name.endswith("gamma"):
                p.copy_(1.0 + torch.randn(p.shape, generator=g) * 0.1)
            elif p.ndim >= 2 and not p.any():
                p.copy_(torch.randn(p.shape, generator=g) * 0.5 / p[0].numel() ** 0.5)


def phase_transformer_grad_check(backbone: str, B: int = 2, T: int = 4096) -> None:
    """DiT or MMDiT at the training width: loss and backward in bf16 through
    the kernels vs fp32 through the plain versions (under block remat, which
    keeps the fp32 logits of one block alive), both on the GPU."""
    from osufusion_tpu_torch.config import DiffusionConfig, ModelConfig
    from osufusion_tpu_torch.models import build_model
    from osufusion_tpu_torch.ops import flash_attention as fa

    rng = np.random.default_rng(7)
    x = torch.from_numpy(rng.standard_normal((B, 6, T)).astype(np.float32)).cuda()
    a = torch.from_numpy(rng.normal(-10.0, 3.0, (B, 96, T)).astype(np.float32)).cuda()
    c = torch.from_numpy(rng.uniform(-1, 1, (B, 5)).astype(np.float32)).cuda()
    orig_len = torch.tensor([T, T - 700][:B], device="cuda")
    noise = torch.from_numpy(rng.standard_normal((B, 6, T)).astype(np.float32)).cuda()
    t = torch.tensor([100, 700][:B], device="cuda")
    cond_mask = torch.tensor([True, False][:B], device="cuda")

    model32 = build_model(ModelConfig(backbone=backbone, dtype="float32", remat=True, **TRANSFORMER), DiffusionConfig())
    ref = model32.init_params(seed=5, device="cpu")
    randomize_transformer(ref, seed=6)
    model16 = build_model(ModelConfig(backbone=backbone, **TRANSFORMER), DiffusionConfig())
    net = model16.init_params(seed=0, device="cpu")
    net.load_state_dict(ref.state_dict())
    ref, net = ref.cuda().train(), net.cuda().train()
    for module in ref.modules():
        if hasattr(module, "sdpa"):
            module.sdpa = fa.flash_attention_reference

    def run(model, params):
        params.zero_grad(set_to_none=True)
        loss = model.loss_from_draws(params, x, a, c, orig_len, noise, t, cond_mask)
        loss.backward()
        torch.cuda.synchronize()
        return loss.item(), torch.cat([(p.grad if p.grad is not None else torch.zeros_like(p)).float().flatten()
                                       for p in params.parameters()])

    _reset_launches(fa)
    loss16, g16 = run(model16, net)
    launches = _launches(fa)
    loss32, g32 = run(model32, ref)
    rel_all = ((g16 - g32).norm() / g32.norm()).item()
    rel_loss = abs(loss16 - loss32) / abs(loss32)
    depth = TRANSFORMER["depth"]
    _log(f"[grad check {backbone}] dim_h=512 depth {depth} B={B} T={T}: loss bf16/kernels {loss16:.6f}, fp32/plain "
         f"{loss32:.6f} (rel {rel_loss:.3e}, bound {LOSS_REL_TOL}); gradient rel L2 {rel_all:.3e} (bound {GRAD_REL_TOL}); "
         f"|grad| {g32.norm().item():.3e}; launches {launches}")
    if not (np.isfinite(loss16) and torch.isfinite(g16).all()):
        raise AssertionError(f"gradient check {backbone}: non-finite loss or gradient through the kernels")
    if not (rel_loss < LOSS_REL_TOL and rel_all < GRAD_REL_TOL):
        raise AssertionError(f"gradient check {backbone}: loss rel {rel_loss:.3e}, gradient rel L2 {rel_all:.3e}")
    expected = {"forward": 0, "forward_lse": depth, "backward_fused": depth, "backward_dq": 0, "backward_dkv": 0,
                "forward_grouped": depth, "backward_grouped": depth}
    if launches != expected:
        raise AssertionError(f"gradient check {backbone} launched {launches}, expected {expected}")


def phase_transformer_train(backbone: str, workdir: Path) -> dict:
    """The trainer at the transformer cell, 4 steps with a save and a resume
    half way, without and with block remat; returns the launches of both runs
    together."""
    from osufusion_tpu_torch.config import Config, ModelConfig, TrainConfig
    from osufusion_tpu_torch.utils.flops import dit_fwd_flops, mmdit_fwd_flops

    steps, half, B, T = 4, 2, 4, 4096
    flops = {"dit": dit_fwd_flops, "mmdit": mmdit_fwd_flops}[backbone]
    totals = {}
    for remat in (False, True):
        cfg = Config(
            model=ModelConfig(backbone=backbone, remat=remat, **TRANSFORMER),
            # dummy samples are 1024..4096 frames at this segment length, padded to 4096
            train=TrainConfig(project_dir=str(workdir / f"{backbone}_{'remat' if remat else 'none'}"), dataset_mode="dummy",
                              segment_length=T // 2, batch_size=B, full_bf16=True, total_steps=half, warmup_steps=2,
                              save_every=half, num_workers=2, seed=0),
        )
        # MMDiT's output layer and the projection before it both start at zero: only the last bias can move
        history, launches, peak = _train_with_resume(cfg, steps, f"train {backbone}",
                                                     final="out/bias" if backbone == "mmdit" else "postprocess/kernel")
        seconds = [h["seconds"] for h in history[1:]]
        s_step = statistics.median(seconds)
        mfu = 3 * flops(cfg.model, B, T) / s_step / PEAK_FLOPS
        depth = cfg.model.depth
        again = depth if remat else 0
        _log(f"[train {backbone} {'remat' if remat else 'none'}] dim_h=512 depth {depth} B={B} T={T} full bf16, {steps} steps "
             f"(save and resume at {half}): loss {[round(h['loss'], 4) for h in history]}; grad_norm "
             f"{[round(h['grad_norm'], 4) for h in history]}; {s_step:.4f} s/step (median of steps 2..{steps}: "
             f"{[round(x, 4) for x in seconds]}); MFU {mfu:.4f} (3 x {flops(cfg.model, B, T) / 1e12:.3f} TFLOP a step "
             f"at {PEAK_FLOPS / 1e12:.0f} TFLOP/s); peak memory {peak:.2f} GiB; launches over {steps} steps {launches}")
        expected = {"forward": 0, "forward_lse": (depth + again) * steps, "backward_fused": depth * steps,
                    "backward_dq": 0, "backward_dkv": 0, "forward_grouped": (depth + again) * steps,
                    "backward_grouped": depth * steps}
        if launches != expected:
            raise AssertionError(f"train {backbone}: launches {launches}, expected {expected}")
        for key, n in launches.items():
            totals[key] = totals.get(key, 0) + n
    return totals


def phase_serve_dit(workdir: Path) -> int:
    """The DiT checkpoint the trainer wrote serves a 60 s song; returns the
    grouped forward's launches."""
    from osufusion_tpu_torch.ops import flash_attention as fa
    from osufusion_tpu_torch.serve import generate_beatmap, load_model

    model, params = load_model(workdir / "dit_none" / "model.safetensors")
    steps = 50
    wav = workdir / "song_d.wav"
    synth_song(wav, 60.0, seed=ord("d"))
    _reset_launches(fa)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    data, osu_texts = generate_beatmap(model, params, wav, title="smoke d", sampling_timesteps=steps, cond_scale=2.0, seed=0)
    latency = time.perf_counter() - t0
    launches = _launches(fa)
    hits = check_osz(data, osu_texts, 1)
    expected = {"forward": params.cfg.depth * steps, "forward_lse": 0, "backward_fused": 0, "backward_dq": 0,
                "backward_dkv": 0, "forward_grouped": params.cfg.depth * steps, "backward_grouped": 0}
    _log(f"[serve dit] {type(params).__name__} dim_h={params.cfg.dim_h} depth {params.cfg.depth} checkpoint from the "
         f"trainer, 60 s song, DDIM-{steps}, CFG 2.0: {latency:.3f} s end to end; {len(data)} byte .osz; hit objects "
         f"{hits}; launches {launches}")
    if launches != expected:
        raise AssertionError(f"serve dit: launches {launches}, expected {expected}")
    return launches["forward_grouped"]



def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this run needs an NVIDIA GPU", file=sys.stderr)
        return 1
    name, smi = phase_device()
    kernel = phase_kernel()
    fwd_lse, bwd = phase_train_kernels()
    fwd_lse_windowed, bwd_dq, bwd_dkv = phase_windowed_kernels()
    halo_fwd, halo_dq, halo_dkv = phase_halo_kernels()
    phase_halo_composition()
    model, cpu, gpu = build_unet_pair()
    phase_unet(cpu, gpu)
    del cpu
    del gpu
    served = serving_weights(model)
    launches = phase_serve(model, served)
    phase_sampler_latency(model, served)
    with tempfile.TemporaryDirectory() as tmp:
        phase_sampler_check(model, served, Path(tmp))
    del model, served
    for B, T in ((2, 4096), (1, 16384)):
        torch.cuda.empty_cache()
        phase_grad_check(B, T)
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        lse_launches, bwd_launches = phase_train(Path(tmp))
        phase_serve_trained(Path(tmp))
    with tempfile.TemporaryDirectory() as tmp:
        fullsong, fullsong_losses = phase_fullsong_train(Path(tmp))
    with tempfile.TemporaryDirectory() as tmp:
        seq = phase_seq_train(Path(tmp), fullsong_losses)
    grouped_fwd_lse, grouped_bwd, grouped_fwd = phase_grouped_kernels()
    for backbone in ("dit", "mmdit"):
        torch.cuda.empty_cache()
        phase_transformer_grad_check(backbone)
    grouped_train = {}
    with tempfile.TemporaryDirectory() as tmp:
        for backbone in ("dit", "mmdit"):
            for key, n in phase_transformer_train(backbone, Path(tmp)).items():
                grouped_train[key] = grouped_train.get(key, 0) + n
        grouped_serve = phase_serve_dit(Path(tmp))
    with tempfile.TemporaryDirectory() as tmp:
        phase_gqa_fullsong_train(Path(tmp))
    if any(m in sys.modules for m in ("jax", "flax", "optax", "osufusion_tpu")):
        raise AssertionError("the port imported jax or the JAX package")
    _log(f"[device] nvidia-smi: {smi}")  # again here, so that the end of the output names the card too
    fwd_source = {"route": "cuda", "source": "osufusion_tpu_torch/csrc/flash_fwd.cu",
                  "replaces": "osufusion_tpu/ops/pallas_attention.py:208"}
    windowed_source = {"route": "cuda", "source": "osufusion_tpu_torch/csrc/flash_bwd_windowed.cu"}
    halo_source = {"route": "cuda", "source": "osufusion_tpu_torch/csrc/flash_halo.cu"}  # K4; K5a/K5b: windowed_source
    print(json.dumps({"kernels": [
        {"name": "flash_fwd", **fwd_source, "launches": launches, **kernel},
        {"name": "flash_fwd_lse", **fwd_source, "launches": lse_launches, **fwd_lse},
        {"name": "flash_bwd", "route": "cuda", "source": "osufusion_tpu_torch/csrc/flash_bwd.cu",
         "replaces": "osufusion_tpu/ops/pallas_attention.py:575", "launches": bwd_launches, **bwd},
        {"name": "flash_fwd_lse_windowed", **fwd_source, "launches": fullsong["forward_lse"], **fwd_lse_windowed},
        {"name": "flash_bwd_dq", **windowed_source, "replaces": "osufusion_tpu/ops/pallas_attention.py:435",
         "launches": fullsong["backward_dq"], **bwd_dq},
        {"name": "flash_bwd_dkv", **windowed_source, "replaces": "osufusion_tpu/ops/pallas_attention.py:507",
         "launches": fullsong["backward_dkv"], **bwd_dkv},
        {"name": "halo_fwd", **halo_source, "replaces": "osufusion_tpu/ops/pallas_attention.py:938",
         "launches": seq["halo_fwd"], **halo_fwd},
        {"name": "halo_bwd_dq", **windowed_source, "replaces": "osufusion_tpu/ops/pallas_attention.py:1054",
         "launches": seq["halo_bwd_dq"], **halo_dq},
        {"name": "halo_bwd_dkv", **windowed_source, "replaces": "osufusion_tpu/ops/pallas_attention.py:1099",
         "launches": seq["halo_bwd_dkv"], **halo_dkv},
        {"name": "flash_fwd_grouped", **fwd_source, "launches": grouped_serve, **grouped_fwd},
        {"name": "flash_fwd_lse_grouped", **fwd_source, "launches": grouped_train["forward_grouped"], **grouped_fwd_lse},
        {"name": "flash_bwd_grouped", "route": "cuda", "source": "osufusion_tpu_torch/csrc/flash_bwd.cu",
         "replaces": "osufusion_tpu/ops/pallas_attention.py:575", "launches": grouped_train["backward_grouped"],
         **grouped_bwd},
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
