"""Smoke run of the PyTorch port (``osufusion_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printed as it ends (with the seconds since the start); any
failure raises and the exit code is not 0:

1. Device: name, power limit, versions; build the flash kernels from
   ``osufusion_tpu_torch/csrc`` with nvcc for sm_90a, all sources at once;
   ptxas's report, one line per kernel instance (registers, bytes spilled),
   failing on any spill or any C7512 (wgmma serialised) warning.
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
   CFG 2.0; 60 s with two samples; the 180 s song with DPM-16), each an
   ``.osz`` holding the returned ``.osu`` texts with hit objects, with the
   kernel launched once per attention site of the path; then the sampler
   alone on the 180 s cell (DDIM-50, then DPM-16: phase 20), and the sampled
   signal through the kernels vs through the plain attention vs a denoiser
   that predicts zero (DDIM-50, then DPM-16: phase 21).
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
18. The ring (K6), the global attention of sequence-parallel training, at
    DiT's site (B=4, T_local=2048, H=Kv=8), MMDiT's (B=4, 1024 packed
    tokens a rank, H=8, Kv=2) and the UNet crop's level 0 (B=4,
    T_local=2048, H=16, Kv=1, rotary tables), each over 2 and 4 shards of
    one sequence run as threads of this process (``LocalRing``): every
    shard's ring forward (K1 per hop and ``ring_merge``) and backward (one
    pre-pass, an accumulating sweep per hop, one post-pass) against the same
    ring through the plain parts, two planted faults above the bounds (the
    second hop left out of the merge; the second sweep storing instead of
    adding); at 2 shards one rank's forward and backward, the merge, one
    sweep, the pre-pass and the post-pass timed alone, the bound, and
    ``scaled_dot_product_attention`` of the rank's queries against the
    gathered keys as the yardstick.
19. Ring training: ``trainer.train`` in two processes (``--mesh-seq 2``,
    sharing the card over gloo where there is one) for DiT and MMDiT at
    phase 15's cell and the UNet at phase 8's (dim_h=512, B=4, T=4096, every
    site global), each one step with a save and a resume for a second: step
    1's loss against the one-card trainer's (phases 8 and 15), the ranks
    alike, the ring's launches per step as the sites imply (K1 and the merge
    twice a site, the pre-pass and the post-pass once, the sweep twice), no
    whole-sequence gather, peak memory per rank.

20. DPM-Solver++(2M) latency: the 180 s cell of phase 6's sampler (B=1, 24576
    frames, CFG 2.0, two seeded runs) at DPM-16 right after DDIM-50, in the
    same process on the same weights: s/map of both, and K1's launches per
    map held to the audio stack once plus one a site and step.
21. DPM check: the signal at DPM-16 on the 60 s song through the kernels vs
    through the plain attention vs a zero-predicting denoiser (phase 6's
    bounds), and, with no bound, DPM-16's and DDIM-8's distances from
    DDIM-50 from the same noise.
22. DPM request: ``python -m osufusion_tpu_torch.inference --sampler dpmpp-2m
    --steps 16`` in a process of its own on the serving weights saved as
    ``model.safetensors`` with their ``config.json``; the ``.osz`` parses.
23. The forms family (``csrc/flash_forms.cu``: fp32 or bf16 operands, D = 64
    ... 256, every form but bf16 at 64), phase by phase:
    (f) what still raises, before any launch or gather: fp16 operands and
    D = 320 through ``ops.attention.sdpa`` raise NotImplementedError naming
    ROADMAP.md's queue 2 "forms"; a D = 32 site runs the XLA route (rope and
    the plain attention), launches no kernel and equals the plain attention;
    a refused window raises ValueError, a failed wgmma or forms launch
    RuntimeError.
    Kernel level: every (body, operand type, D) instance, forward with its
    LSE, pre-pass, dq, dk/dv and post-pass, against its plain fp32 version at
    B=2, T=4096, H=16 (global, tables), fp32/64 and bf16/128 also windowed
    (B=1, T=16384, W=2048) and grouped (B=2, T=2048, H=8, Kv=2); planted
    faults (the last key tile dropped or a window one key short; an LSE off
    by 0.05) above the bounds (fp32: summation order only; bf16: phase 3's);
    CUDA-event times beside the bound (fp32 FLOP at 67 TFLOP/s, bf16 at 989),
    the plain version and rope + SDPA.
    (b) and (c): fp32 serving and bf16 serving of a UNet with
    attn_dim_head=128, each the 180 s song through ``generate_beatmap`` at
    DPM-16, CFG 2.0 (444 forms forwards a map, no wgmma launch), the sampler
    alone on the 180 s cell (s/map), and phase 21's signal check at 8192
    frames. (d) the gradients of a dim_h=512 UNet of one block a level (13
    sites, B=2, T=4096) through the forms kernels at fp32/64 and bf16/128
    against fp32 through the plain versions. (e) the shard forms at kernel
    level: the halo instances at phase 10's rank shape (B=1, T_local=16384,
    W=4096, the second of four shards) and the ring over two shards as
    threads at phase 18's UNet and DiT rank shapes, fp32/64 and bf16/128,
    each with planted faults. (a) fp32 crop training: ``trainer.train`` with
    ``mixed_precision="no"`` at dim_h=512, B=4, T=4096, 2 steps: 39 forms
    forwards, pre-passes, dq, dk/dv and post-passes a step, no wgmma launch.

The line before the last is a JSON record of the kernels; the last line is
``{"ok": true, "device": {...}}``. Without a CUDA device the script exits
non-zero before printing either.
"""

from __future__ import annotations

import contextlib
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
# DPM-Solver++(2M) at 16 steps: the sampler the JAX package's README recommends
# for serving, the steps of its cell fullsong_gen_latency_dpmpp-2m16_cfg
DPM_STEPS = 16
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
    report = io.StringIO()
    with contextlib.redirect_stdout(report):
        libs = build_kernels(verbose=True)
    print(report.getvalue(), end="", flush=True)
    _log(f"[build] {', '.join(lib.name for lib in libs.values())} (nvcc, sm_90a) ready in {time.perf_counter() - t0:.2f} s")
    _check_ptxas(report.getvalue())
    return name, smi


# the template arguments that the kernels of ``csrc/`` take, as the Itanium ABI mangles them: a bool, an
# int (a head dim), and the forms family's operand types float, __nv_bfloat16 and __half
_TEMPLATE_ARG = r"Lb[01]E|Li\d+E|f|13__nv_bfloat16|6__half"


def _kernel_name(mangled: str) -> str:
    """A kernel's name with its template arguments, from ptxas's mangled one."""
    found = re.search(rf"([a-z][a-z_]*_kernel)(I(?:{_TEMPLATE_ARG})+E)?", mangled)
    if found is None:
        return mangled
    names = {"Lb0E": "false", "Lb1E": "true", "f": "float", "13__nv_bfloat16": "bf16", "6__half": "fp16"}
    args = [names.get(a, a[2:-1]) for a in re.findall(_TEMPLATE_ARG, (found.group(2) or "")[1:-1])]
    return found.group(1) + (f"<{', '.join(args)}>" if args else "")


def _check_ptxas(report: str) -> None:
    """One line per kernel instance from ptxas's report (registers,
    spills); raise on any spill or any C7512 (wgmma serialised) warning.
    Libraries already built leave no report to read."""
    instances = []
    for chunk in report.split("Compiling entry function '")[1:]:
        name = _kernel_name(chunk.split("'", 1)[0])
        regs = re.search(r"Used (\d+) registers", chunk)
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", chunk)
        instances.append((name, int(regs.group(1)) if regs else -1, sum(map(int, spill.groups())) if spill else -1))
    if not instances:
        _log("[build] ptxas: no report (the libraries were built before this run)")
        return
    _log("[build] ptxas: " + "; ".join(f"{n} {r} registers, {b} B spilled" for n, r, b in instances))
    serialised = sorted({_kernel_name(m) for m in re.findall(r"C7512\).*?function '(\S+?)'", report)})
    spilled = [n for n, _, b in instances if b != 0]
    if spilled or "C7512" in report:
        raise AssertionError(f"ptxas: spills in {spilled}; C7512 (wgmma serialised): "
                             f"{serialised or ('in a kernel' if 'C7512' in report else 'none')}")


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


def _unet_sites(cfg) -> int:
    return 3 * sum(cfg.num_layer_blocks) + cfg.num_middle_transformers  # audio, down, up + middle


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
    expected = _unet_sites(gpu.cfg)
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


def _sampler_name(method: str, steps: int) -> str:
    return f"{'DPM' if method == 'dpmpp-2m' else 'DDIM'}-{steps}"


def _map_launches(model, cfg, method: str, steps: int) -> int:
    """K1's launches for one map: the audio stack once, then every site of
    the CFG-doubled UNet call once a step (a DPM grid can be shorter than
    ``steps`` where timesteps collapse)."""
    from osufusion_tpu_torch.models.dpm import dpmpp_timesteps

    calls = len(dpmpp_timesteps(steps, model.acp.numpy())) if method == "dpmpp-2m" else steps
    return sum(cfg.num_layer_blocks) + calls * (2 * sum(cfg.num_layer_blocks) + cfg.num_middle_transformers)


def phase_serve(model, params) -> int:
    """Serve three requests through ``generate_beatmap``: a 180 s song at
    DDIM-50, a 60 s song with two samples, and the 180 s song at DPM-16;
    returns the kernel launches of all three."""
    from osufusion_tpu_torch.ops import flash_attention as fa
    from osufusion_tpu_torch.serve import LENGTH_BUCKET, generate_beatmap

    total = 0
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        for label, seconds, n_samples, sampler, steps in (("a", 180.0, 1, "ddim", 50), ("b", 60.0, 2, "ddim", 50),
                                                           ("a", 180.0, 1, "dpmpp-2m", DPM_STEPS)):
            wav = tmp / f"song_{label}.wav"
            synth_song(wav, seconds, seed=ord(label))
            expected = _map_launches(model, params.cfg, sampler, steps)
            fa.flash_fwd.launches = 0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            data, osu_texts = generate_beatmap(model, params, wav, title=f"smoke {label}", num_samples=n_samples,
                                               sampling_timesteps=steps, sampler=sampler, cond_scale=2.0, seed=0)
            latency = time.perf_counter() - t0
            launches = fa.flash_fwd.launches
            total += launches
            hits = check_osz(data, osu_texts, n_samples)
            frames = 1 + int(seconds * SR) // 176
            padded = -(-frames // LENGTH_BUCKET) * LENGTH_BUCKET
            name = _sampler_name(sampler, steps)
            _log(f"[serve {label}] {seconds:.0f} s song, {frames} frames (padded {padded}), {name}, CFG 2.0, "
                 f"num_samples={n_samples}: {latency:.3f} s end to end; {len(data)} byte .osz; hit objects {hits}; "
                 f"kernel launches {launches} (expected {expected})")
            if launches != expected:
                raise AssertionError(f"request {label} ({name}): {launches} kernel launches, expected {expected}")
    return total


def phase_sampler_latency(model, params, method: str = "ddim", steps: int = 50) -> list[float]:
    """The sampler alone on the 180 s cell, twice, as the JAX package's bench
    measures it (fullsong_gen_latency_ddim50_cfg; at DPM-16
    fullsong_gen_latency_dpmpp-2m16_cfg): B=1, 24576 frames, CFG 2.0, K1's
    launches per map counted and held to ``_map_launches``. Returns the
    seconds per map of the two runs."""
    from osufusion_tpu_torch.ops import flash_attention as fa

    g = torch.Generator().manual_seed(0)
    frames = 24576
    a = (torch.randn((1, 96, frames), generator=g) * 3 - 10).cuda()
    c = (torch.rand((1, 5), generator=g) * 2 - 1).cuda()
    expected = _map_launches(model, params.cfg, method, steps)
    times, launches = [], []
    for seed in (1, 2):
        x0 = torch.randn((1, 6, frames), generator=torch.Generator().manual_seed(seed)).cuda()
        torch.cuda.synchronize()
        fa.flash_fwd.launches = 0
        t0 = time.perf_counter()
        out = model.sample(params, a, c, x=x0, cond_scale=2.0, sampling_timesteps=steps, method=method)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        launches.append(fa.flash_fwd.launches)
        if not torch.isfinite(out).all():
            raise AssertionError("sampler output has non-finite values")
    _log(f"[sampler] 24576 frames, {_sampler_name(method, steps)}, CFG 2.0, B=1: {times[0]:.3f} s, {times[1]:.3f} s "
         f"per map; K1 launches per map {launches} (expected {expected})")
    if launches != [expected] * 2:
        raise AssertionError(f"sampler {_sampler_name(method, steps)}: K1 launches per map {launches}, expected {expected}")
    return times


def check_song(workdir: Path) -> tuple:
    """The sampler checks' inputs: a 60 s song's spectrogram padded to 8192
    frames, a neutral context, seeded noise; all on the GPU."""
    import torch.nn.functional as F

    from osufusion_tpu_torch.audio import load_audio
    from osufusion_tpu_torch.nn.unet import A_PAD_VALUE
    from osufusion_tpu_torch.serve import LENGTH_BUCKET

    wav = workdir / "song_check.wav"
    synth_song(wav, 60.0, seed=ord("b"))
    spec = load_audio(wav, device="cuda")
    a = F.pad(spec, (0, LENGTH_BUCKET - spec.shape[-1]), value=A_PAD_VALUE)[None]
    c = torch.zeros((1, 5), device="cuda")
    x0 = torch.randn((1, 6, LENGTH_BUCKET), generator=torch.Generator().manual_seed(0)).cuda()
    return a, c, x0


def phase_sampler_check(model, params, song: tuple, method: str = "ddim", steps: int = 50) -> torch.Tensor:
    """The sampler's output is the denoiser's: on a 60 s song (``check_song``:
    8192 padded frames, CFG 2.0) the signal sampled through the kernels agrees
    with the one sampled through the plain attention on the GPU, and both lie
    far from the trajectory of a denoiser that predicts zero. Returns the
    signal through the kernels."""
    from osufusion_tpu_torch.nn import blocks
    from osufusion_tpu_torch.ops import flash_attention as fa
    from osufusion_tpu_torch.ops import flash_forms as forms

    a, c, x0 = song
    plain, zero = copy.deepcopy(params), copy.deepcopy(params)
    for module in plain.modules():
        if isinstance(module, blocks.Attention):
            module.sdpa = fa.flash_attention_reference
    with torch.no_grad():
        zero.final_conv.weight.zero_()
        zero.final_conv.bias.zero_()
    before = fa.flash_fwd.launches + forms.forms_fwd.launches
    signals = [model.sample(p, a, c, x=x0, cond_scale=2.0, sampling_timesteps=steps, method=method)
               for p in (params, plain, zero)]
    launches = fa.flash_fwd.launches + forms.forms_fwd.launches - before
    through_kernels, through_plain, zero_eps = signals
    rel_plain, rel_zero = _rel(through_kernels, through_plain), _rel(through_kernels, zero_eps)
    flipped = ((through_kernels > 0) != (zero_eps > 0)).float().mean().item()
    name = _sampler_name(method, steps)
    _log(f"[sampler check] {a.shape[-1]} frames, {name}, CFG 2.0: signal through the kernels vs through the plain "
         f"attention rel L2 {rel_plain:.3e} (bound {SAMPLER_REL_TOL}); vs a zero-predicting denoiser {rel_zero:.3e} (at "
         f"least {SAMPLER_MIN_EFFECT}), {flipped:.2%} of the signs differ; kernel launches {launches}")
    if not all(torch.isfinite(x).all() for x in signals):
        raise AssertionError(f"sampler check {name}: non-finite signal")
    if not (rel_plain < SAMPLER_REL_TOL and rel_zero > SAMPLER_MIN_EFFECT):
        raise AssertionError(f"sampler check {name}: kernels vs plain {rel_plain:.3e}, vs zero-predicting {rel_zero:.3e}")
    return through_kernels


def phase_dpm_check(model, params, song: tuple, ddim50: torch.Tensor) -> None:
    """``phase_sampler_check`` at DPM-16 on the same song and noise, then the
    control of ``tests/test_samplers.py::test_dpm16_matches_ddim50_decoded_maps``
    with no bound: how far DPM-16 and DDIM-8 (through the kernels) lie from
    DDIM-50 (``ddim50``, the DDIM check's signal)."""
    dpm16 = phase_sampler_check(model, params, song, "dpmpp-2m", DPM_STEPS)
    a, c, x0 = song
    ddim8 = model.sample(params, a, c, x=x0, cond_scale=2.0, sampling_timesteps=8)
    _log(f"[dpm check] {a.shape[-1]} frames, CFG 2.0, the same noise, through the kernels (no bound): DPM-{DPM_STEPS} vs "
         f"DDIM-50 rel L2 {_rel(dpm16, ddim50):.3e}, max abs {(dpm16 - ddim50).abs().max().item():.3e}; DDIM-8 vs DDIM-50 "
         f"rel L2 {_rel(ddim8, ddim50):.3e}, max abs {(ddim8 - ddim50).abs().max().item():.3e}")
    if not torch.isfinite(ddim8).all():
        raise AssertionError("dpm check: non-finite DDIM-8 signal")


def phase_dpm_request(model, params, workdir: Path) -> None:
    """One request through the command line, ``python -m
    osufusion_tpu_torch.inference --sampler dpmpp-2m --steps 16``, in a
    process of its own, serving ``params`` saved as the trainer saves a
    checkpoint (``model.safetensors`` with its ``config.json``) on a 180 s
    song; the .osz must parse."""
    from osufusion_tpu_torch.config import Config
    from osufusion_tpu_torch.trainer import save_model_safetensors

    Config(model=params.cfg, diffusion=model.cfg).save(workdir / "config.json")
    save_model_safetensors(params, workdir / "model.safetensors")
    wav, osz = workdir / "song_request.wav", workdir / "request.osz"
    synth_song(wav, 180.0, seed=ord("a"))
    cmd = [sys.executable, "-m", "osufusion_tpu_torch.inference", "--model-path", str(workdir / "model.safetensors"),
           "--audio", str(wav), "--output", str(osz), "--sampler", "dpmpp-2m", "--steps", str(DPM_STEPS),
           "--cfg-scale", "2.0"]
    t0 = time.perf_counter()
    done = subprocess.run(cmd, cwd=Path(__file__).resolve().parent, capture_output=True, text=True, timeout=300)
    seconds = time.perf_counter() - t0
    if done.returncode != 0:
        raise AssertionError(f"dpm request: the command exited {done.returncode}:\n{done.stderr[-4000:]}")
    data = osz.read_bytes()
    with zipfile.ZipFile(io.BytesIO(data)) as z:
        texts = [z.read(n).decode() for n in z.namelist() if n.endswith(".osu")]
    hits = check_osz(data, texts, 1)
    _log(f"[dpm request] python -m osufusion_tpu_torch.inference --sampler dpmpp-2m --steps {DPM_STEPS}, 180 s song, "
         f"CFG 2.0, a {params.cfg.dim_h}-wide UNet from model.safetensors + config.json: {seconds:.3f} s for the whole "
         f"process (start, CUDA context, load, sample, decode); {len(data)} byte .osz; hit objects {hits}; "
         f"{done.stdout.strip().splitlines()[-1]}")


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
    sites = _unet_sites(net.cfg)
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


def phase_train(workdir: Path) -> tuple[int, int, tuple]:
    """The trainer at the production cell, 4 steps per remat mode, without
    remat across a save and a resume half way; returns (forward-with-LSE,
    backward) launches and step 1's (loss, grad_norm) without remat."""
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
        sites = _unet_sites(cfg.model)
        history, launches, peak = _train_with_resume(cfg, steps, f"train {remat}")
        first = (history[0]["loss"], history[0]["grad_norm"]) if remat == "none" else first
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
    return totals[0], totals[1], first


# a CUDA error code that a failed launch returns (cudaErrorLaunchFailure)
LAUNCH_FAILURE = 719


def _all_launches(fa, ha) -> tuple:
    """Every kernel's launch counter, those of sequence parallelism too."""
    return (fa.flash_fwd.launches, fa.flash_bwd.launches, fa.flash_bwd_dq.launches, fa.flash_bwd_dkv.launches,
            fa.flash_bwd_prep.launches, fa.flash_bwd_sweep.launches, fa.flash_bwd_post.launches,
            fa.ring_merge.launches, ha.halo_fwd.launches, ha.halo_bwd_dq.launches, ha.halo_bwd_dkv.launches)


# the forms instances of csrc/flash_forms.cu, (operand dtype, head dim): fp32, bf16 and fp16 at D = 64 ...
# 256, and the chunked instance at bf16/320; the main paths run fp32/64 (fp32 training and serving) and
# bf16/128's pre-pass and post-pass around K2's sweep. The bf16 forward, dq and
# dk/dv at D <= 256 exist as instances too, though the form rule gives the forward and the global backward
# at those forms to the wgmma kernels: they are checked and timed through the forms wrappers directly.
FORMS_INSTANCES = ([(dt, D) for dt in (torch.float32, torch.bfloat16, torch.float16) for D in (64, 128, 192, 256)]
                   + [(torch.bfloat16, 320)])
FORMS_MAIN = ((torch.float32, 64), (torch.bfloat16, 128))
# fp32 instances vs their plain fp32 versions on the same inputs: the same arithmetic (every rounding to the
# operand type is the identity), summed in another order: over 4096 keys of O(1) terms fp32's worst case is
# ~4096 * 2^-24 = 2.4e-4 relative, its typical error a few 1e-7. The planted faults (the last key tile
# dropped: ~0.1; an LSE off by LSE_FAULT: 3.4e-2) lie orders of magnitude above. bf16 instances take the
# D = 64 kernels' bounds (REL_TOL, ABS_TOL, LSE_TOL, BWD_REL_TOL, BWD_ABS_TOL).
FORMS_F32_REL_TOL = 1e-4
FORMS_F32_ABS_TOL = 1e-4  # of o absolutely, of a gradient times its largest magnitude
FORMS_F32_LSE_TOL = 1e-4
PEAK_FP32_FLOPS = 67e12  # H100 SXM, fp32 on the FMA units (NVIDIA's data sheet)
# the kernel-level site: the crop path's level 0 (B=4, T=4096, H=16, global, tables) at half its batch
FORMS_SITE = (2, 4096, 16)
# the main instances' extra sites: windowed MQA with tables, grouped without tables
FORMS_WINDOWED = (1, 16384, 16, 2048)
FORMS_GROUPED = (2, 2048, 8, 2)


def _dtype_name(dtype) -> str:
    return {torch.float32: "fp32", torch.bfloat16: "bf16", torch.float16: "fp16"}[dtype]


def _forms_tols(dtype) -> tuple:
    """(o rel L2, o max abs, lse max abs, gradient rel L2, gradient max abs as a share of its largest)."""
    if dtype == torch.float32:
        return FORMS_F32_REL_TOL, FORMS_F32_ABS_TOL, FORMS_F32_LSE_TOL, FORMS_F32_REL_TOL, FORMS_F32_ABS_TOL
    return REL_TOL, ABS_TOL, LSE_TOL, BWD_REL_TOL, BWD_ABS_TOL


def _forms_bound(flops: float, nbytes: float, dtype) -> tuple[float, str]:
    """The least milliseconds the card could take: fp32 operations at the FMA rate, bf16 at the tensor cores'."""
    peak = PEAK_FP32_FLOPS if dtype == torch.float32 else PEAK_FLOPS
    by_ops, by_bytes = flops / peak * 1e3, nbytes / PEAK_BYTES * 1e3
    return (by_ops, "operations") if by_ops >= by_bytes else (by_bytes, "bytes")


def _forms_counts(reset: bool = False) -> dict:
    """The forms entry points' launch counters (set to 0 first with ``reset``)."""
    from osufusion_tpu_torch.ops import flash_forms as forms

    fns = {"fwd": forms.forms_fwd, "prep": forms.forms_bwd_prep, "dq": forms.forms_bwd_dq, "dkv": forms.forms_bwd_dkv,
           "post": forms.forms_bwd_post, "merge": forms.forms_ring_merge}
    if reset:
        for fn in fns.values():
            fn.launches = 0
    return {name: fn.launches for name, fn in fns.items()}


def _attention_inputs(B: int, T: int, H: int, Kv: int, tables: bool, seed: int, D: int = 64,
                      dtype=torch.bfloat16):
    """q, do (B, T, H, D), k_rot, k and v ((B, T, D) at Kv = 1, else (B, T, Kv, D)) in ``dtype`` on the card,
    k_rot rotated with the song's tables (T, D) fp32, or k itself without them (None)."""
    from osufusion_tpu_torch.ops import flash_attention as fa
    from osufusion_tpu_torch.ops.rope import rope_tables

    g = torch.Generator(device="cuda").manual_seed(seed)
    q, do = (torch.randn((B, T, H, D), generator=g, device="cuda").to(dtype) for _ in range(2))
    kv_shape = (B, T, D) if Kv == 1 else (B, T, Kv, D)
    k, v = (torch.randn(kv_shape, generator=g, device="cuda").to(dtype) for _ in range(2))
    cos, sin = rope_tables(T, D, scale_base=float(T), device="cuda") if tables else (None, None)
    return q, (k if cos is None else fa.rotated_k(k, cos, sin)), k, v, do, cos, sin


def _forms_call(q, k_rot, v, do, cos, sin, window: int):
    """One site through the forms instance of q's (dtype, D), directly through its wrappers: (o, lse), then
    the backward's (dq, dk_rot, dv) from them, and the pre-pass's scratch."""
    from osufusion_tpu_torch.ops import flash_forms as forms

    B, T, H, D = q.shape
    kv = 1 if k_rot.ndim == 3 else k_rot.shape[2]
    scale = D**-0.5
    o = torch.empty_like(q)
    lse = torch.empty((B, T * H), dtype=torch.float32, device="cuda")
    forms.forms_fwd(q, k_rot, v, cos, sin, o, lse, window, scale)
    prep = forms.forms_bwd_prep(q, o, lse, do, cos, sin, kv, scale)
    dk = torch.empty(k_rot.shape, dtype=torch.float32, device="cuda")
    dv = torch.empty_like(dk)
    forms.forms_bwd_dq(k_rot, v, prep, window, None, accumulate=False)
    forms.forms_bwd_dkv(k_rot, v, prep, dk, dv, window, None, accumulate=False)
    return o, lse, forms.forms_bwd_post(prep, cos, sin, scale), dk, dv, prep


def _forms_hold(where: str, got: tuple, q, k_rot, v, do, cos, sin, window: int, failures: list) -> tuple[float, str]:
    """Hold one site's forward and backward (``_forms_call``'s first five) to the plain fp32 versions, with
    planted faults (forward: the last FAULT_TILE keys dropped, or a window one key short; backward: an LSE off
    by LSE_FAULT) that must land above the bounds. Returns (the largest error, a log line)."""
    from osufusion_tpu_torch.ops import flash_attention as fa

    o_rel_tol, o_abs_tol, lse_tol, g_rel_tol, g_abs_tol = _forms_tols(q.dtype)
    o, lse, dq, dk, dv = got
    o_ref, lse_ref = fa.flash_fwd_lse_reference(q, k_rot, v, cos, sin, window)
    if window < 0:
        o_fault = fa.flash_fwd_lse_reference(q, k_rot[:, :-FAULT_TILE], v[:, :-FAULT_TILE], cos, sin)[0]
    else:
        o_fault = fa.flash_fwd_lse_reference(q, k_rot, v, cos, sin, window - 2)[0]

    def plain_backward(lse_in):
        return (fa.flash_bwd_dq_reference(q, k_rot, v, o_ref, lse_in, do, cos, sin, window),
                *fa.flash_bwd_dkv_reference(q, k_rot, v, o_ref, lse_in, do, cos, sin, window))

    refs, faults = plain_backward(lse_ref), plain_backward(lse_ref + LSE_FAULT)
    o_rel, o_err = _rel(o, o_ref), (o.float() - o_ref).abs().max().item()
    lse_err, o_fault_rel = (lse - lse_ref).abs().max().item(), _rel(o_fault, o_ref)
    worst = o_err
    if not (o_rel < o_rel_tol and o_err < o_abs_tol and lse_err < lse_tol and torch.isfinite(o).all()):
        failures.append(f"forward {where}: o rel L2 {o_rel:.3e}, max abs {o_err:.3e}, lse max abs {lse_err:.3e}")
    if not o_fault_rel > o_rel_tol:
        failures.append(f"forward {where}: planted fault {o_fault_rel:.3e} would pass {o_rel_tol}")
    parts = [f"o rel L2 {o_rel:.3e} max abs {o_err:.3e} (fault {o_fault_rel:.3e}), lse max abs {lse_err:.3e}"]
    for name, a, b, fault in zip(("dq", "dk", "dv"), (dq, dk, dv), refs, faults):
        rel, err, top = _rel(a, b), (a.float() - b).abs().max().item(), b.abs().max().item()
        fault_rel = _rel(fault, b)
        worst = max(worst, err)
        parts.append(f"{name} rel L2 {rel:.3e} max abs {err:.3e} of {top:.2f} (fault {fault_rel:.3e})")
        if not (rel < g_rel_tol and err < g_abs_tol * top and torch.isfinite(a).all()):
            failures.append(f"backward {where}: {name} rel L2 {rel:.3e}, max abs {err:.3e} of {top:.3e}")
        if not fault_rel > g_rel_tol:
            failures.append(f"backward {where}: planted fault in {name} {fault_rel:.3e} would pass {g_rel_tol}")
    return worst, "; ".join(parts) + f" (bounds {o_rel_tol:g}, {g_rel_tol:g})"


def phase_forms_kernels() -> dict:
    """Every forms instance against its plain fp32 version at FORMS_SITE (global, MQA, tables) with planted
    faults above the bounds, timed by CUDA events beside its bound, its plain version and rope + SDPA; the
    main instances also at FORMS_WINDOWED and FORMS_GROUPED. Returns {(dtype, D): {body: record}} for the
    bodies fwd, dq, dkv and the helpers prep, post, merge."""
    import torch.nn.functional as F

    from osufusion_tpu_torch.ops import flash_attention as fa
    from osufusion_tpu_torch.ops import flash_forms as forms
    from osufusion_tpu_torch.ops.rope import apply_rope, unapply_rope
    from osufusion_tpu_torch.utils.flops import attention_flops

    failures, records = [], {}
    for i, (dt, D) in enumerate(FORMS_INSTANCES):
        name, size = f"{_dtype_name(dt)}/{D}", torch.finfo(dt).bits // 8
        sites = [("global", (*FORMS_SITE, 1), -1, True)]
        if (dt, D) in FORMS_MAIN:
            B_w, T_w, H_w, W = FORMS_WINDOWED
            sites += [("windowed", (B_w, T_w, H_w, 1), W, True), ("grouped", FORMS_GROUPED, -1, False)]
        worst = 0.0
        for j, (label, (B, T, H, Kv), window, tables) in enumerate(sites):
            q, k_rot, k, v, do, cos, sin = _attention_inputs(B, T, H, Kv, tables, 1300 + 10 * i + j, D, dt)
            got = _forms_call(q, k_rot, v, do, cos, sin, window)
            torch.cuda.synchronize()
            err, line = _forms_hold(f"{name} {label}", got[:5], q, k_rot, v, do, cos, sin, window, failures)
            worst = max(worst, err)
            _log(f"[forms kernels] {name} {label} B={B} T={T} H={H} Kv={Kv}{f' W={window}' if window >= 0 else ''}: {line}")
            if label != "global":
                del q, k_rot, k, v, do, got
                continue
            o, lse, _, _, _, prep = got
            scale = D**-0.5
            ms = {
                "fwd": _cuda_ms(lambda: forms.forms_fwd(q, k_rot, v, cos, sin, torch.empty_like(q), lse, -1, scale), 3),
                "prep": _cuda_ms(lambda: forms.forms_bwd_prep(q, o, lse, do, cos, sin, 1, scale), 5),
                "dq": _cuda_ms(lambda: forms.forms_bwd_dq(k_rot, v, prep, -1, None, accumulate=False), 3),
                "dkv": _cuda_ms(lambda: forms.forms_bwd_dkv(k_rot, v, prep, torch.empty(k.shape, device="cuda"),
                                                            torch.empty(k.shape, device="cuda"), -1, None, False), 3),
                "post": _cuda_ms(lambda: forms.forms_bwd_post(prep, cos, sin, scale), 5),
            }
            o_acc, lse_acc = o.float(), lse.clone()
            ms["merge"] = _cuda_ms(lambda: forms.forms_ring_merge(o_acc, lse_acc, o, lse, torch.empty_like(lse), None), 5)
            plain = {
                "fwd": _cuda_ms(lambda: fa.flash_fwd_lse_reference(q, k_rot, v, cos, sin), 1),
                "dq": _cuda_ms(lambda: fa.flash_bwd_dq_reference(q, k_rot, v, o, lse, do, cos, sin, -1), 1),
                "dkv": _cuda_ms(lambda: fa.flash_bwd_dkv_reference(q, k_rot, v, o, lse, do, cos, sin, -1), 1),
                "merge": _cuda_ms(lambda: fa.ring_merge_reference(o_acc, lse_acc, o, lse), 3),
                "prep": _cuda_ms(lambda: (fa._scaled_rotated_q(q, cos, sin).to(dt), (do.float() * o.float()).sum(-1)), 3),
                "post": _cuda_ms(lambda: (unapply_rope(prep.dq_acc[:, : T * H].reshape(B, T, H, D), cos, sin)
                                          * scale).to(dt), 3),
            }

            # yardstick only: rope on q and k, then PyTorch's fused attention and its backward
            def library(q_in, k_in, v_in):
                qr = apply_rope(q_in, cos, sin).transpose(1, 2)
                kr = apply_rope(k_in, cos, sin)[:, None]
                return F.scaled_dot_product_attention(qr, kr, v_in[:, None], enable_gqa=True).transpose(1, 2)

            with torch.no_grad():
                lib_fwd_ms = _cuda_ms(lambda: library(q, k, v), 3)
            leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
            lib_out = library(*leaves)
            lib_bwd_ms = _cuda_ms(lambda: torch.autograd.grad(lib_out, leaves, do, retain_graph=True), 3)
            del leaves, lib_out
            rows_bytes, keys_bytes, stats = B * T * H * D * size, B * T * D * size, B * T * H * 4
            bounds = {
                "fwd": _forms_bound(attention_flops("forward", B, T, H, D, None), 2 * rows_bytes + 2 * keys_bytes + stats, dt),
                "dq": _forms_bound(attention_flops("backward_dq", B, T, H, D, None),  # qs do; k v; lse delta; dq fp32
                                   2 * rows_bytes + 2 * keys_bytes + 2 * stats + B * T * H * D * 4, dt),
                "dkv": _forms_bound(attention_flops("backward_dkv", B, T, H, D, None),  # qs do; k v; lse delta; dk dv fp32
                                    2 * rows_bytes + 2 * keys_bytes + 2 * stats + 2 * B * T * D * 4, dt),
                # q do o; lse; qs; lse delta
                "prep": _forms_bound(B * T * H * D * 3, 4 * rows_bytes + 3 * stats, dt),
                "post": _forms_bound(B * T * H * D * 3, B * T * H * D * 4 + rows_bytes + 2 * T * D * 4, dt),  # dq_acc; dq; tables
                "merge": _forms_bound(B * T * H * (4 * D + 10), B * T * H * D * 8 + rows_bytes + 3 * stats, dt),
            }
            library_ms = {"fwd": lib_fwd_ms, "dq": lib_bwd_ms, "dkv": lib_bwd_ms}
            records[(dt, D)] = {
                body: {"max_abs_err": err, "ms": ms[body],
                       "plain_ms": plain[body], "bound_ms": bounds[body][0], "bound_by": bounds[body][1],
                       "library_ms": library_ms.get(body)} for body in ms}
            _log(f"[forms kernels] {name} B={B} T={T} H={H} global: "
                 + "; ".join(f"{body} {ms[body]:.3f} ms (bound {bounds[body][0]:.3f} by {bounds[body][1]}, "
                             f"{bounds[body][0] / ms[body]:.1%}; plain {plain[body]:.3f})" for body in ms)
                 + f"; rope+SDPA forward {lib_fwd_ms:.3f}, backward {lib_bwd_ms:.3f} ms")
            del q, k_rot, k, v, do, got, o, lse, prep, o_acc, lse_acc
            torch.cuda.empty_cache()
        for rec in records[(dt, D)].values():
            rec["max_abs_err"] = worst
    if failures:
        raise AssertionError("forms kernels vs plain: " + "; ".join(failures))
    return records


# (f): the sites that only the forms family takes: fp16 at every head dim of the forms
# instances, and each operand dtype at head dims above 256 (the chunked instance); (dtype, D, window)
FORMS_NEW_SITES = ([(torch.float16, D, 256) for D in (64, 128, 192, 256)]
                   + [(dt, D, -1) for dt in (torch.float32, torch.bfloat16, torch.float16) for D in (320, 512)])
# fp16 against fp32 plain on the same fp16 inputs: P and dS rounded to fp16 (2^-11 relative) where bf16 rounds
# to 2^-8; the planted faults (an LSE off by LSE_FAULT, the last key tile dropped) lie far above
FORMS_F16_REL_TOL = 2e-3


def phase_forms_raise() -> None:
    """(f) Every form that the JAX package runs now runs a kernel on the card: through ``ops.attention.sdpa``
    under a gradient, fp16 operands at D = 64 ... 256 (windowed) and fp32, bf16 and fp16 at D = 320 and 512
    (global: the chunked instance) raise nothing, launch the forms forward, pre-pass, dq, dk/dv and
    post-pass once each (and no wgmma kernel), and hold o and the gradients to autograd through the plain
    attention in fp32, with a planted fault (the keys of the last tile dropped) above the bound. A site whose
    head dim is not a multiple of 64 (D = 32) launches no kernel and equals the plain attention, as the JAX
    package sends it to XLA. A bf16, D = 64 site whose window the wrapper refuses raises ValueError; a wgmma or
    forms launch that fails raises RuntimeError."""
    from osufusion_tpu_torch.ops import flash_attention as fa
    from osufusion_tpu_torch.ops import halo_attention as ha
    from osufusion_tpu_torch.ops.attention import sdpa
    from osufusion_tpu_torch.ops.rope import rope_tables

    B, T, H = 1, 1024, 4
    gen = torch.Generator(device="cuda").manual_seed(0)
    raised, expected, failures = [], [], []

    def site(dtype, D):
        q = torch.randn((B, T, H, D), generator=gen, device="cuda").to(dtype)
        k, v = (torch.randn((B, T, 1, D), generator=gen, device="cuda").to(dtype) for _ in range(2))
        return q, k, v, rope_tables(T, D, scale_base=512.0, device="cuda")

    def call(dtype, D, window, error):
        expected.append(error.__name__)
        try:
            sdpa(*site(dtype, D)[:3], window, site(dtype, D)[3])
        except error as e:
            raised.append((error.__name__, str(e)))

    def counts():
        return _all_launches(fa, ha), _forms_counts()

    held = []
    for dt, D, window in FORMS_NEW_SITES:
        tol = {torch.float32: FORMS_F32_REL_TOL, torch.bfloat16: BWD_REL_TOL, torch.float16: FORMS_F16_REL_TOL}[dt]
        q, k, v, rope = site(dt, D)
        do = torch.randn((B, T, H, D), generator=gen, device="cuda").to(dt)
        w = None if window < 0 else window
        before = counts()
        leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
        out = sdpa(*leaves, w, rope)
        out.backward(do)
        torch.cuda.synchronize()
        moved = _all_launches(fa, ha) != before[0]
        runs = {name: n - before[1][name] for name, n in _forms_counts().items()}
        ref_leaves = [t.float().requires_grad_(True) for t in (q, k, v)]
        ref = fa.flash_attention_reference(*ref_leaves, w, rope)
        ref.backward(do.float())
        if w is None:  # planted fault: the values of the last key tile left out of P V
            v_cut = v.float().clone()
            v_cut[:, T - FAULT_TILE:] = 0.0
            fault = fa.flash_attention_reference(q.float(), k.float(), v_cut, None, rope)
        else:  # a window two keys short
            fault = fa.flash_attention_reference(q.float(), k.float(), v.float(), w - 2, rope)
        rels = [_rel(out, ref)] + [_rel(a.grad, b.grad) for a, b in zip(leaves, ref_leaves)]
        fault_rel = _rel(fault, ref)
        name = f"{_dtype_name(dt)}/{D}{'' if w is None else f' W={w}'}"
        held.append(f"{name}: o {rels[0]:.2e}, dq {rels[1]:.2e}, dk {rels[2]:.2e}, dv {rels[3]:.2e} (fault "
                    f"{fault_rel:.2e}), forms {runs}")
        if moved or runs != {"fwd": 1, "prep": 1, "dq": 1, "dkv": 1, "post": 1, "merge": 0}:
            failures.append(f"{name}: forms launches {runs}, wgmma launches moved {moved}")
        if not (max(rels) < tol and torch.isfinite(out).all() and all(torch.isfinite(t.grad).all() for t in leaves)):
            failures.append(f"{name}: rel L2 o, dq, dk, dv {rels} above {tol}")
        if not fault_rel > tol:
            failures.append(f"{name}: planted fault {fault_rel:.3e} would pass {tol}")
        del q, k, v, do, leaves, out, ref_leaves, ref, fault
    _log(f"[forms raise] sites that raised before, through ops.attention.sdpa under a gradient (B={B}, T={T}, "
         f"H={H}) vs fp32 plain autograd: " + "; ".join(held))
    before = counts()
    q, k, v, rope = site(torch.bfloat16, 32)
    xla = sdpa(q, k, v, 256, rope)
    xla_rel = _rel(xla, fa.flash_attention_reference(q, k, v, 256, rope).float())
    no_launch_xla = counts() == before
    call(torch.bfloat16, 64, -2, ValueError)  # a window the wrapper refuses
    kernel = fa._kernel
    fa._kernel = lambda entry: (lambda *args: LAUNCH_FAILURE)
    try:
        call(torch.bfloat16, 64, 256, RuntimeError)
        call(torch.float32, 64, 256, RuntimeError)
        call(torch.bfloat16, 128, 256, RuntimeError)
    finally:
        fa._kernel = kernel
    _log(f"[forms raise] bf16/32 (the XLA route) vs plain rel L2 {xla_rel:.1e}, no launch: {no_launch_xla}; raised "
         f"{raised}")
    if [name for name, _ in raised] != expected or not no_launch_xla or xla_rel != 0.0:
        failures.append(f"raised {raised}, expected {expected}; no launch {no_launch_xla}; D=32 vs plain {xla_rel:.3e}")
    if failures:
        raise AssertionError("forms raise: " + "; ".join(failures))


# K1 and K2 at the head dims above 64: bf16, D = 128, 192, 256, at the forms site (FORMS_SITE: B=2,
# T=4096, H=16, MQA, global, tables), against the plain versions with the D = 64 kernels' bounds
WIDE_DIMS = (128, 192, 256)


def phase_wide_kernels() -> dict:
    """K1 with its LSE and the whole global backward (the forms pre-pass, K2's sweep, the forms post-pass) at
    D = 128, 192 and 256 against their plain fp32 versions with planted faults above the D = 64 kernels'
    bounds (the forward without its last key tile; the backward from an LSE off by LSE_FAULT), each timed by
    CUDA events beside its bound, its plain version and rope + SDPA (forward; backward by autograd), and the
    sweep alone beside its share of the bound; then K1 and K2 at D = 128 at the paths' own sites
    (WIDE_PATH_SITES) against plain with the same bounds. Returns {D: {"fwd": record, "bwd": record}} of the
    forms site."""
    import torch.nn.functional as F

    from osufusion_tpu_torch.ops import flash_attention as fa
    from osufusion_tpu_torch.ops.rope import apply_rope
    from osufusion_tpu_torch.utils.flops import attention_flops

    t_phase = time.perf_counter()
    B, T, H = FORMS_SITE
    failures, records = [], {}
    for i, D in enumerate(WIDE_DIMS):
        scale = D**-0.5
        q, k_rot, k, v, do, cos, sin = _attention_inputs(B, T, H, 1, True, 1700 + i, D)
        o, lse = fa.flash_fwd(q, k_rot, v, cos, sin, -1, scale, return_lse=True)
        dq, dk, dv = fa.flash_bwd(q, k_rot, v, o, lse, do, cos, sin, scale)
        torch.cuda.synchronize()
        o_ref, lse_ref = fa.flash_fwd_lse_reference(q, k_rot, v, cos, sin)
        o_fault = fa.flash_fwd_lse_reference(q, k_rot[:, :-FAULT_TILE], v[:, :-FAULT_TILE], cos, sin)[0]
        refs = fa.flash_bwd_reference(q, k_rot, v, o_ref, lse_ref, do, cos, sin)
        faults = fa.flash_bwd_reference(q, k_rot, v, o_ref, lse_ref + LSE_FAULT, do, cos, sin)
        o_rel, o_err = _rel(o, o_ref), (o.float() - o_ref).abs().max().item()
        lse_err, o_fault_rel = (lse - lse_ref).abs().max().item(), _rel(o_fault, o_ref)
        if not (o_rel < REL_TOL and o_err < ABS_TOL and lse_err < LSE_TOL and torch.isfinite(o).all()
                and o_fault_rel > REL_TOL):
            failures.append(f"K1 D={D}: o rel L2 {o_rel:.3e}, max abs {o_err:.3e}, lse {lse_err:.3e}, fault {o_fault_rel:.3e}")
        parts, bwd_err = [], 0.0
        for name, got, ref, fault in zip(("dq", "dk", "dv"), (dq, dk, dv), refs, faults):
            rel, err, top = _rel(got, ref), (got.float() - ref).abs().max().item(), ref.abs().max().item()
            fault_rel = _rel(fault, ref)
            bwd_err = max(bwd_err, err)
            parts.append(f"{name} rel L2 {rel:.3e} max abs {err:.3e} of {top:.2f} (fault {fault_rel:.3e})")
            if not (rel < BWD_REL_TOL and err < BWD_ABS_TOL * top and torch.isfinite(got).all() and fault_rel > BWD_REL_TOL):
                failures.append(f"K2 D={D}: {name} rel L2 {rel:.3e}, max abs {err:.3e} of {top:.3e}, fault {fault_rel:.3e}")
        del o_ref, lse_ref, o_fault, refs, faults, dq, dk, dv
        fwd_ms = _cuda_ms(lambda: fa.flash_fwd(q, k_rot, v, cos, sin, -1, scale, return_lse=True), 10)
        bwd_ms = _cuda_ms(lambda: fa.flash_bwd(q, k_rot, v, o, lse, do, cos, sin, scale), 5)
        prep = fa.flash_bwd_prep(q, k_rot, v, o, lse, do, cos, sin, scale)
        dk_s, dv_s = torch.empty(k_rot.shape, device="cuda"), torch.empty(k_rot.shape, device="cuda")
        sweep_ms = _cuda_ms(lambda: fa.flash_bwd_sweep(k_rot, v, prep, dk_s, dv_s, False), 5)
        del prep, dk_s, dv_s
        fwd_plain_ms = _cuda_ms(lambda: fa.flash_fwd_lse_reference(q, k_rot, v, cos, sin), 1)
        bwd_plain_ms = _cuda_ms(lambda: fa.flash_bwd_reference(q, k_rot, v, o, lse, do, cos, sin), 1)

        # yardstick only: rope on q and k, then PyTorch's fused attention and its backward
        def library(q_in, k_in, v_in):
            qr = apply_rope(q_in, cos, sin).transpose(1, 2)
            kr = apply_rope(k_in, cos, sin)[:, None]
            return F.scaled_dot_product_attention(qr, kr, v_in[:, None], enable_gqa=True).transpose(1, 2)

        with torch.no_grad():
            lib_fwd_ms = _cuda_ms(lambda: library(q, k, v), 5)
        leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
        lib_out = library(*leaves)
        lib_bwd_ms = _cuda_ms(lambda: torch.autograd.grad(lib_out, leaves, do, retain_graph=True), 5)
        del leaves, lib_out
        fwd_bound = _bound(attention_flops("forward", B, T, H, D, None), _attn_bytes(B, T, H, D, 2, 2, 1))
        bwd_bound = _bound(attention_flops("backward_fused", B, T, H, D, None), _attn_bytes(B, T, H, D, 4, 4, 1))
        records[D] = {
            "fwd": {"max_abs_err": o_err, "ms": fwd_ms, "plain_ms": fwd_plain_ms, "bound_ms": fwd_bound[0],
                    "bound_by": fwd_bound[1], "library_ms": lib_fwd_ms},
            "bwd": {"max_abs_err": bwd_err, "ms": bwd_ms, "plain_ms": bwd_plain_ms, "bound_ms": bwd_bound[0],
                    "bound_by": bwd_bound[1], "library_ms": lib_bwd_ms},
        }
        _log(f"[wide kernels] D={D} B={B} T={T} H={H} global, tables: forward o rel L2 {o_rel:.3e} max abs {o_err:.3e} "
             f"(fault {o_fault_rel:.3e}), lse max abs {lse_err:.3e}; backward {'; '.join(parts)} (bounds {REL_TOL}, "
             f"{BWD_REL_TOL})")
        _log(f"[wide kernels] D={D}: K1 {fwd_ms:.3f} ms (bound {fwd_bound[0]:.3f} by {fwd_bound[1]}, "
             f"{fwd_bound[0] / fwd_ms:.1%}; plain {fwd_plain_ms:.3f}; rope+SDPA {lib_fwd_ms:.3f}); whole backward "
             f"{bwd_ms:.3f} ms, of it K2's sweep {sweep_ms:.3f} (bound {bwd_bound[0]:.3f} by {bwd_bound[1]}, "
             f"{bwd_bound[0] / bwd_ms:.1%} whole, {bwd_bound[0] / sweep_ms:.1%} the sweep; plain {bwd_plain_ms:.3f}; "
             f"rope+SDPA backward {lib_bwd_ms:.3f})")
        del q, k_rot, k, v, do, cos, sin, o, lse
        torch.cuda.empty_cache()
    for i, (label, B, T, H, Kv, window, tables) in enumerate(WIDE_PATH_SITES):
        _wide_path_site(label, B, T, H, Kv, window, tables, 1750 + i, failures)
        torch.cuda.empty_cache()
    if failures:
        raise AssertionError("wide kernels vs plain: " + "; ".join(failures))
    _log(f"[wide kernels] phase {time.perf_counter() - t_phase:.1f} s")
    return records


# the sites at which the paths of phase 23 run K1 and K2 at D = 128: (label, B, T, H, Kv, window, tables).
# (g) the DiT step's grouped site (4 heads of 128, H = Kv, no tables; K1 with its LSE and K2); (c) the
# serving UNet's level 0 under CFG (24576 frames, the level's window, MQA with tables; K1 without its LSE)
WIDE_PATH_SITES = (("DiT (g)", 4, 4096, 4, 4, -1, False), ("serving (c)", 2, 24576, 16, 1, 4096, True))


def _wide_path_site(label: str, B: int, T: int, H: int, Kv: int, window: int, tables: bool, seed: int,
                    failures: list) -> None:
    """K1 (and at a global site K2) at D = 128 at one of WIDE_PATH_SITES against the plain fp32 versions, with
    the bounds and planted faults of ``phase_wide_kernels`` (a windowed forward's fault: the window one key
    short on each side), and K1 timed by CUDA events."""
    from osufusion_tpu_torch.ops import flash_attention as fa

    D = 128
    scale = D**-0.5
    where = f"{label} D={D} B={B} T={T} H={H} Kv={Kv} {'global' if window < 0 else f'W={window}'}"
    q, k_rot, k, v, do, cos, sin = _attention_inputs(B, T, H, Kv, tables, seed, D)
    del k
    if window < 0:
        o, lse = fa.flash_fwd(q, k_rot, v, cos, sin, window, scale, return_lse=True)
        grads = fa.flash_bwd(q, k_rot, v, o, lse, do, cos, sin, scale)
        fault_k, fault_v, fault_w = k_rot[:, :-FAULT_TILE], v[:, :-FAULT_TILE], window
    else:  # serving: no LSE, no backward
        o, lse, grads = fa.flash_fwd(q, k_rot, v, cos, sin, window, scale), None, ()
        fault_k, fault_v, fault_w = k_rot, v, window - 2
    torch.cuda.synchronize()
    o_ref, lse_ref = fa.flash_fwd_lse_reference(q, k_rot, v, cos, sin, window)
    o_fault = fa.flash_fwd_lse_reference(q, fault_k, fault_v, cos, sin, fault_w)[0]
    o_rel, o_err, o_fault_rel = _rel(o, o_ref), (o.float() - o_ref).abs().max().item(), _rel(o_fault, o_ref)
    lse_err = 0.0 if lse is None else (lse - lse_ref).abs().max().item()
    del o_fault
    if not (o_rel < REL_TOL and o_err < ABS_TOL and lse_err < LSE_TOL and torch.isfinite(o).all()
            and o_fault_rel > REL_TOL):
        failures.append(f"K1 {where}: o rel L2 {o_rel:.3e}, max abs {o_err:.3e}, lse {lse_err:.3e}, fault {o_fault_rel:.3e}")
    parts = []
    if grads:
        refs = fa.flash_bwd_reference(q, k_rot, v, o_ref, lse_ref, do, cos, sin)
        faults = fa.flash_bwd_reference(q, k_rot, v, o_ref, lse_ref + LSE_FAULT, do, cos, sin)
        for name, got, ref, fault in zip(("dq", "dk", "dv"), grads, refs, faults):
            rel, err, top = _rel(got, ref), (got.float() - ref).abs().max().item(), ref.abs().max().item()
            fault_rel = _rel(fault, ref)
            parts.append(f"{name} rel L2 {rel:.3e} max abs {err:.3e} of {top:.2f} (fault {fault_rel:.3e})")
            if not (rel < BWD_REL_TOL and err < BWD_ABS_TOL * top and torch.isfinite(got).all() and fault_rel > BWD_REL_TOL):
                failures.append(f"K2 {where}: {name} rel L2 {rel:.3e}, max abs {err:.3e} of {top:.3e}, fault {fault_rel:.3e}")
        del refs, faults
    del o_ref, lse_ref, grads
    fwd_ms = _cuda_ms(lambda: fa.flash_fwd(q, k_rot, v, cos, sin, window, scale, return_lse=window < 0), 5)
    _log(f"[wide kernels] {where}: forward o rel L2 {o_rel:.3e} max abs {o_err:.3e} (fault {o_fault_rel:.3e}), lse max "
         f"abs {lse_err:.3e}; backward {'; '.join(parts) or 'none on this path'} (bounds {REL_TOL}, {BWD_REL_TOL}); "
         f"K1 {fwd_ms:.3f} ms")


def phase_wide_dit_train(workdir: Path) -> dict:
    """A bf16 DiT crop step at a head dim of 128 (dim_h=512, 4 heads of 128, depth 12, B=4, T=4096, full
    bf16): ``trainer.train`` for 2 steps, K1 (c) with its LSE and K2 (c) at D = 128 once a layer and step,
    no forms forward, dq or dk/dv. Returns the wgmma launches."""
    from osufusion_tpu_torch.config import Config, ModelConfig, TrainConfig
    from osufusion_tpu_torch.ops import flash_attention as fa
    from osufusion_tpu_torch.ops import halo_attention as ha

    t_phase = time.perf_counter()
    steps, B, T = 2, 4, 4096
    model = dict(TRANSFORMER, attn_heads=4, attn_dim_head=128)
    cfg = Config(model=ModelConfig(backbone="dit", **model),
                 train=TrainConfig(project_dir=str(workdir / "dit_d128"), dataset_mode="dummy", segment_length=T // 2,
                                   batch_size=B, full_bf16=True, total_steps=steps, warmup_steps=2, save_every=0,
                                   num_workers=2, seed=0))
    others = _all_launches(fa, ha)[4:]
    _forms_counts(reset=True)
    history, launches, peak = _train_with_resume(cfg, steps, "train dit D=128", final="postprocess/kernel")
    counts = _forms_counts()
    depth = cfg.model.depth
    _log(f"[wide dit train] DiT dim_h=512, 4 heads of 128, depth {depth}, B={B} T={T} full bf16, {steps} steps: loss "
         f"{[round(h['loss'], 4) for h in history]}; {[round(h['seconds'], 4) for h in history]} s/step; peak memory "
         f"{peak:.2f} GiB; launches {launches}; forms launches {counts}; phase {time.perf_counter() - t_phase:.1f} s")
    expected = {"forward": 0, "forward_lse": depth * steps, "backward_fused": depth * steps, "backward_dq": 0,
                "backward_dkv": 0, "forward_grouped": depth * steps, "backward_grouped": depth * steps}
    if launches != expected or _all_launches(fa, ha)[4:] != others:
        raise AssertionError(f"wide dit train: launches {launches}, expected {expected}")
    _forms_launch_check("wide dit train", {b: counts[b] for b in ("fwd", "dq", "dkv")}, {"fwd": 0, "dq": 0, "dkv": 0},
                        False)
    return launches


def _forms_launch_check(label: str, counts: dict, expected: dict, hopper_moved: bool) -> None:
    if counts != expected or hopper_moved:
        raise AssertionError(f"{label}: forms launches {counts}, expected {expected}; wgmma launches moved: {hopper_moved}")


def phase_forms_serve(model_cfg, workdir: Path) -> int:
    """(b) and (c): serving a form beside bf16/64 (a float32 config; a bf16 UNet with attn_dim_head=128),
    seeded random weights as phase 6's: the 180 s song through ``generate_beatmap`` at DPM-16 and CFG 2.0
    (444 forwards a map: fp32 the forms forward and no wgmma launch; bf16/128 K1 at D = 128 and no forms
    launch), the sampler alone on the 180 s cell (s/map), and at 8192 frames the signal through the kernels
    held to the plain attention's (phase 21's bounds). Returns the forwards of the request and the sampler
    run (forms forwards at fp32, K1's at bf16/128)."""
    from osufusion_tpu_torch.config import DiffusionConfig
    from osufusion_tpu_torch.models import build_model
    from osufusion_tpu_torch.ops import flash_attention as fa
    from osufusion_tpu_torch.ops import halo_attention as ha
    from osufusion_tpu_torch.serve import generate_beatmap

    label = f"{model_cfg.dtype} D={model_cfg.attn_dim_head}"
    model = build_model(model_cfg, DiffusionConfig())
    params = serving_weights(model)
    expected = _map_launches(model, params.cfg, "dpmpp-2m", DPM_STEPS)
    wav = workdir / "song_forms.wav"
    synth_song(wav, 180.0, seed=ord("a"))
    wide = model_cfg.dtype == "bfloat16"  # K1 takes bf16 at D = 128
    hopper = _all_launches(fa, ha)
    _forms_counts(reset=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    data, osu_texts = generate_beatmap(model, params, wav, title="smoke forms", num_samples=1,
                                       sampling_timesteps=DPM_STEPS, sampler="dpmpp-2m", cond_scale=2.0, seed=0)
    latency = time.perf_counter() - t0
    request = _forms_counts()
    k1_request = fa.flash_fwd.launches - hopper[0]
    hits = check_osz(data, osu_texts, 1)
    g = torch.Generator().manual_seed(0)
    frames = 24576
    a = (torch.randn((1, 96, frames), generator=g) * 3 - 10).cuda()
    c = (torch.rand((1, 5), generator=g) * 2 - 1).cuda()
    x0 = torch.randn((1, 6, frames), generator=torch.Generator().manual_seed(1)).cuda()
    _forms_counts(reset=True)
    between = _all_launches(fa, ha)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = model.sample(params, a, c, x=x0, cond_scale=2.0, sampling_timesteps=DPM_STEPS, method="dpmpp-2m")
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    sampler = _forms_counts()
    after = _all_launches(fa, ha)
    k1_sampler = after[0] - between[0]
    _log(f"[forms serve] {label}: 180 s song, DPM-{DPM_STEPS}, CFG 2.0 through generate_beatmap {latency:.3f} s end to "
         f"end, hit objects {hits}, forms launches {request}, K1 launches {k1_request}; the sampler alone on 24576 "
         f"frames {seconds:.3f} s/map, forms launches {sampler}, K1 launches {k1_sampler} (expected {expected} "
         f"forwards a map)")
    if wide:  # K1 serves every site, nothing else launches
        want = {"fwd": 0, "prep": 0, "dq": 0, "dkv": 0, "post": 0, "merge": 0}
        others = [a - b for a, b in zip(after[1:], hopper[1:])]
        moved = k1_request != expected or k1_sampler != expected or any(others)
    else:
        want = {"fwd": expected, "prep": 0, "dq": 0, "dkv": 0, "post": 0, "merge": 0}
        moved = after != hopper
    _forms_launch_check(f"forms serve {label} request", request, want, moved)
    _forms_launch_check(f"forms serve {label} sampler", sampler, want, moved)
    if not torch.isfinite(out).all():
        raise AssertionError(f"forms serve {label}: non-finite sampled signal")
    del a, c, x0, out
    phase_sampler_check(model, params, check_song(workdir), "dpmpp-2m", DPM_STEPS)
    return k1_request + k1_sampler if wide else request["fwd"] + sampler["fwd"]


def _forms_unet(dim_head: int, dtype: str, remat: bool = False):
    """A dim_h=512 UNet of one block a level and one middle transformer (13 attention sites)."""
    from osufusion_tpu_torch.config import DiffusionConfig, ModelConfig
    from osufusion_tpu_torch.models import build_model

    cfg = ModelConfig(dim_h=512, num_layer_blocks=(1, 1, 1, 1), num_middle_transformers=1, attn_dim_head=dim_head,
                      dtype=dtype, remat=remat, remat_mode="block")
    return build_model(cfg, DiffusionConfig())


# fp32 loss and gradients through the forms kernels vs through the plain versions, both fp32 on the card:
# the two differ in summation order at 13 attention sites, and cuDNN's fp32 convolutions (no TF32) sum
# their gradients in an order of their own as well
FORMS_GRAD_F32_REL_TOL = 1e-3


def phase_forms_grad_check(dtype: str, dim_head: int, B: int = 2, T: int = 4096) -> dict:
    """(d) Gradients at a form beside bf16/64: the reduced UNet (``_forms_unet``) at B=2, T=4096 (every
    site global), weights random everywhere, in ``dtype`` with ``dim_head`` through the kernels against
    float32 through the plain versions on the card. fp32: the forms forward, pre-pass, dq, dk/dv and
    post-pass a site, and no wgmma kernel; bf16 at D = 128: K1 with its LSE and K2 a site (the forms
    pre-pass and post-pass around K2's sweep), no forms forward, dq or dk/dv. Returns the launches by
    entry point (the forms ones, and K1's and K2's as "k1", "k2")."""
    from osufusion_tpu_torch.nn import blocks
    from osufusion_tpu_torch.nn.unet import UNetBlock
    from osufusion_tpu_torch.ops import flash_attention as fa
    from osufusion_tpu_torch.ops import halo_attention as ha

    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal((B, 6, T)).astype(np.float32)).cuda()
    a = torch.from_numpy(rng.normal(-10.0, 3.0, (B, 96, T)).astype(np.float32)).cuda()
    c = torch.from_numpy(rng.uniform(-1, 1, (B, 5)).astype(np.float32)).cuda()
    orig_len = torch.tensor([T, T - 700][:B], device="cuda")
    noise = torch.from_numpy(rng.standard_normal((B, 6, T)).astype(np.float32)).cuda()
    t = torch.tensor([100, 700][:B], device="cuda")
    cond_mask = torch.tensor([True, False][:B], device="cuda")
    model32 = _forms_unet(dim_head, "float32", remat=True)
    ref = model32.init_params(seed=5, device="cpu")
    randomize_everywhere(ref, seed=6)
    model = _forms_unet(dim_head, dtype)
    net = model.init_params(seed=0, device="cpu")
    net.load_state_dict(ref.state_dict())
    ref, net = ref.cuda().train(), net.cuda().train()
    for module in ref.modules():
        if isinstance(module, blocks.Attention):
            module.sdpa = fa.flash_attention_reference

    def run(m, params):
        params.zero_grad(set_to_none=True)
        loss = m.loss_from_draws(params, x, a, c, orig_len, noise, t, cond_mask)
        loss.backward()
        torch.cuda.synchronize()
        return loss.item()

    hopper = _all_launches(fa, ha)
    _forms_counts(reset=True)
    loss = run(model, net)
    counts = _forms_counts()
    wgmma = [a - b for a, b in zip(_all_launches(fa, ha), hopper)]
    moved = any(wgmma)
    loss32 = run(model32, ref)
    g, g32 = _flat_grads(net), _flat_grads(ref)
    is_attn = lambda n: ".attn.to_" in n
    rel_all = ((g - g32).norm() / g32.norm()).item()
    rel_attn = ((_flat_grads(net, is_attn) - _flat_grads(ref, is_attn)).norm() / _flat_grads(ref, is_attn).norm()).item()
    rel_loss = abs(loss - loss32) / abs(loss32)
    f32 = dtype == "float32"
    grad_tol, loss_tol = (FORMS_GRAD_F32_REL_TOL, FORMS_GRAD_F32_REL_TOL) if f32 else (GRAD_REL_TOL, LOSS_REL_TOL)
    sites = _unet_sites(net.cfg)
    _log(f"[forms grad check] {dtype} D={dim_head}, dim_h=512, 13 sites, B={B} T={T}: loss through the forms kernels "
         f"{loss:.6f}, fp32 plain {loss32:.6f} (rel {rel_loss:.3e}, bound {loss_tol}); gradient rel L2 {rel_all:.3e}, "
         f"attention projections alone {rel_attn:.3e} (bound {grad_tol}); forms launches {counts}")
    if not (np.isfinite(loss) and torch.isfinite(g).all()):
        raise AssertionError(f"forms grad check {dtype} D={dim_head}: non-finite loss or gradient")
    if not (rel_loss < loss_tol and rel_all < grad_tol and rel_attn < grad_tol):
        raise AssertionError(f"forms grad check {dtype} D={dim_head}: loss rel {rel_loss:.3e}, gradient rel L2 "
                             f"{rel_all:.3e}, attention {rel_attn:.3e}")
    if f32:
        _forms_launch_check(f"forms grad check {dtype} D={dim_head}", counts,
                            {"fwd": sites, "prep": sites, "dq": sites, "dkv": sites, "post": sites, "merge": 0}, moved)
        return counts
    # K1 with its LSE (flash_fwd) and K2 (flash_bwd) once a site, nothing else of the wgmma family
    _forms_launch_check(f"forms grad check {dtype} D={dim_head}", counts,
                        {"fwd": 0, "prep": sites, "dq": 0, "dkv": 0, "post": sites, "merge": 0},
                        wgmma != [sites, sites] + [0] * 9)
    return {**counts, "k1": wgmma[0], "k2": wgmma[1]}


def phase_forms_train(workdir: Path) -> dict:
    """(a) fp32 crop training: ``trainer.train`` with ``mixed_precision="no"`` (float32 throughout) at
    dim_h=512, B=4, T=4096, dummy data, 2 steps, every site global, no rematerialisation: one forms forward,
    pre-pass, dq, dk/dv and post-pass a site and step, no wgmma launch. Returns the forms launches."""
    from osufusion_tpu_torch.config import Config, ModelConfig, TrainConfig
    from osufusion_tpu_torch.ops import flash_attention as fa
    from osufusion_tpu_torch.ops import halo_attention as ha

    steps = 2
    cfg = Config(model=ModelConfig(dim_h=512, dtype="float32"),
                 train=TrainConfig(project_dir=str(workdir / "train_fp32"), dataset_mode="dummy", segment_length=2048,
                                   batch_size=4, mixed_precision="no", total_steps=steps, warmup_steps=2, save_every=0,
                                   num_workers=2, seed=0))
    sites = _unet_sites(cfg.model)
    # _train_with_resume sets K1-K3's counters to 0 and returns their launches; the others must not move
    others = _all_launches(fa, ha)[4:]
    _forms_counts(reset=True)
    history, launches, peak = _train_with_resume(cfg, steps, "forms train fp32")
    counts = _forms_counts()
    _log(f"[forms train] fp32 (mixed precision no) dim_h=512 B=4 T=4096, {steps} steps: loss "
         f"{[round(h['loss'], 4) for h in history]}; grad_norm {[round(h['grad_norm'], 4) for h in history]}; "
         f"{[round(h['seconds'], 4) for h in history]} s/step; peak memory {peak:.2f} GiB; forms launches {counts} "
         f"(sites {sites}); wgmma launches {launches}")
    _forms_launch_check("forms train fp32", counts, {"fwd": sites * steps, "prep": sites * steps, "dq": sites * steps,
                                                      "dkv": sites * steps, "post": sites * steps, "merge": 0},
                        _all_launches(fa, ha)[4:] != others or any(launches.values()))
    return counts


def phase_forms() -> tuple[dict, dict, dict, dict]:
    """Phase 23, the forms family and the wide heads on the card: (f) fp16 and D > 256 against plain,
    the kernel-level checks and times of every forms instance and of K1 and K2 at D = 128 ... 256, (b) and
    (c) serving, (d) gradients, (g) the bf16 DiT step at D = 128, (e) the shard forms, (a) fp32 crop
    training. Returns the forms kernel records and, by main instance, each forms entry point's launches on
    the paths driven through the port's entry points ((a), (b) or (c), (d)); then K1's and K2's records by
    head dim and their launches at D = 128 on (c), (d) and (g)."""
    from osufusion_tpu_torch.config import ModelConfig

    t0 = time.perf_counter()
    phase_forms_raise()
    _log(f"[forms] (f) {time.perf_counter() - t0:.1f} s")
    records = phase_forms_kernels()
    wide_records = phase_wide_kernels()
    runs = {inst: [] for inst in FORMS_MAIN}
    wide = {"fwd": 0, "bwd": 0}
    with tempfile.TemporaryDirectory() as tmp:
        for inst, cfg in zip(FORMS_MAIN, (ModelConfig(dim_h=128, dtype="float32"), ModelConfig(dim_h=128, attn_dim_head=128))):
            torch.cuda.empty_cache()
            served = phase_forms_serve(cfg, Path(tmp))
            if inst[0] == torch.bfloat16:  # K1 at D = 128 serves this one
                wide["fwd"] += served
                runs[inst].append({"fwd": 0})
            else:
                runs[inst].append({"fwd": served})
    for (dt, D) in FORMS_MAIN:
        torch.cuda.empty_cache()
        counts = phase_forms_grad_check(str(dt).split(".")[1], D)
        wide["fwd"] += counts.pop("k1", 0)
        wide["bwd"] += counts.pop("k2", 0)
        runs[(dt, D)].append(counts)
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        dit = phase_wide_dit_train(Path(tmp))
    wide["fwd"] += dit["forward_lse"]
    wide["bwd"] += dit["backward_fused"]
    torch.cuda.empty_cache()
    shards = phase_forms_shards()  # kernel level: its launches are not the paths'
    for inst in FORMS_MAIN:
        records[inst]["merge"]["max_abs_err"] = shards["merge_err"][inst]
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        runs[FORMS_MAIN[0]].append(phase_forms_train(Path(tmp)))
    launches = {inst: {body: sum(r.get(body, 0) for r in rs) for body in ("fwd", "prep", "dq", "dkv", "post", "merge")}
                for inst, rs in runs.items()}
    _log(f"[forms] launches on paths (a)-(d) by instance: "
         + "; ".join(f"{_dtype_name(dt)}/{D} {n}" for (dt, D), n in launches.items())
         + f"; K1 and K2 at D = 128 on (c), (d) and (g): {wide}")
    if not (wide["fwd"] > 0 and wide["bwd"] > 0):
        raise AssertionError(f"K1 or K2 at D = 128 launched no time on the paths: {wide}")
    return records, launches, wide_records, {128: wide}


# the Pallas body each forms entry point stands in for (osufusion_tpu/ops/pallas_attention.py): the forward
# (_fwd_kernel; also _halo_fwd_kernel :938 and the ring's hops), dq (_dq_kernel; also :1054, :575), dk/dv
# (_dkv_kernel; also :1099, :575), the pre- and post-pass around the fused backward, the ring's merge
FORMS_REPLACES = {"fwd": 208, "dq": 435, "dkv": 507, "prep": 575, "post": 575, "merge": 1310}


def _forms_json(records: dict, launches: dict) -> list:
    """The kernels line's forms entries: every instance's forward, dq and dk/dv, and the main instances'
    pre-pass, post-pass and merge, with their launches on paths (a)-(d) (0 where no path runs the
    instance: the merge runs in the ring alone, which phase 23 drives at kernel level only)."""
    entries = []
    for (dt, D), bodies in records.items():
        for body, rec in bodies.items():
            if body in ("prep", "post", "merge") and (dt, D) not in FORMS_MAIN:
                continue
            entries.append({"name": f"forms_{body}_{_dtype_name(dt)}_d{D}", "route": "cuda",
                            "source": "osufusion_tpu_torch/csrc/flash_forms.cu",
                            "replaces": f"osufusion_tpu/ops/pallas_attention.py:{FORMS_REPLACES[body]}",
                            "launches": launches.get((dt, D), {}).get(body, 0), **rec})
    return entries


def _wide_json(records: dict, launches: dict) -> list:
    """The kernels line's entries of K1 and K2 at D = 128, 192, 256 (phase 23's kernel records), with their
    launches on the paths of phase 23 ((c) serving, (d) gradients, (g) the DiT step; no path reaches D = 192
    or 256)."""
    entries = []
    for D, rec in records.items():
        n = launches.get(D, {"fwd": 0, "bwd": 0})
        entries.append({"name": f"flash_fwd_lse_d{D}", "route": "cuda", "source": "osufusion_tpu_torch/csrc/flash_fwd.cu",
                        "replaces": "osufusion_tpu/ops/pallas_attention.py:208", "launches": n["fwd"], **rec["fwd"]})
        entries.append({"name": f"flash_bwd_d{D}", "route": "cuda", "source": "osufusion_tpu_torch/csrc/flash_bwd.cu",
                        "replaces": "osufusion_tpu/ops/pallas_attention.py:575", "launches": n["bwd"], **rec["bwd"]})
    return entries


# (e): phase 10's rank shape (B=1, 16384 frames a rank, W=4096, the second of four shards) and phase 18's
# UNet and DiT rank shapes over two shards
FORMS_HALO = (1, 16384, 16, 4096, 4, 1)
FORMS_RING = (("UNet", 4, 2048, 16, 1, True), ("DiT", 4, 2048, 8, 8, False))


def phase_forms_shards() -> dict:
    """(e) The shard forms at kernel level, with no process group, for each main instance: the halo forward,
    dq and dk/dv at FORMS_HALO against their plain versions, the slab's rows outside the song random
    (planted faults: the slab one key off its frame, an LSE off by LSE_FAULT), and the ring over two shards as ``LocalRing``
    threads at FORMS_RING against its plain parts (planted faults: the second hop left out of the merge, the
    second sweep storing). Returns the forms launches and the ring's largest error of o (the merge's
    output), each by instance."""
    from osufusion_tpu_torch.ops import flash_attention as fa
    from osufusion_tpu_torch.ops import halo_attention as ha
    from osufusion_tpu_torch.ops import ring_attention as ra

    drop_hop, store_once = _ring_faults()
    failures, launches, merge_err = [], {}, {}
    for i, (dt, D) in enumerate(FORMS_MAIN):
        name, scale = f"{_dtype_name(dt)}/{D}", D**-0.5
        o_rel_tol, o_abs_tol, lse_tol, g_rel_tol, g_abs_tol = _forms_tols(dt)
        _forms_counts(reset=True)
        B, T, H, W, n, shard = FORMS_HALO
        g0, t_global = shard * T, n * T
        g = torch.Generator(device="cuda").manual_seed(1400 + i)
        q, do = (torch.randn((B, T, H, D), generator=g, device="cuda").to(dt) for _ in range(2))
        k, v = (torch.randn((B, T + W, D), generator=g, device="cuda").to(dt) for _ in range(2))
        o, lse = ha.halo_fwd(q, k, v, W, g0, t_global, scale)
        dq, prep = ha.halo_bwd_dq(q, k, v, o, lse, do, W, g0, t_global, scale)
        dk, dv = ha.halo_bwd_dkv(k, v, do, prep, W, g0, t_global)
        torch.cuda.synchronize()
        o_ref, lse_ref = ha.halo_fwd_reference(q, k, v, W, g0, t_global)
        # planted forward fault: the slab one key off its frame
        o_shift = ha.halo_fwd_reference(q, k.roll(1, dims=1), v.roll(1, dims=1), W, g0, t_global)[0]
        refs = (ha.halo_bwd_dq_reference(q, k, v, o_ref, lse_ref, do, W, g0, t_global),
                *ha.halo_bwd_dkv_reference(q, k, v, o_ref, lse_ref, do, W, g0, t_global))
        faults = (ha.halo_bwd_dq_reference(q, k, v, o_ref, lse_ref + LSE_FAULT, do, W, g0, t_global),
                  *ha.halo_bwd_dkv_reference(q, k, v, o_ref, lse_ref + LSE_FAULT, do, W, g0, t_global))
        where = f"halo {name} B={B} T_local={T} W={W} shard {shard + 1} of {n}"
        o_rel, lse_err, shift_rel = _rel(o, o_ref), (lse - lse_ref).abs().max().item(), _rel(o_shift, o_ref)
        if not (o_rel < o_rel_tol and lse_err < lse_tol and torch.isfinite(o).all() and shift_rel > o_rel_tol):
            failures.append(f"{where}: o rel L2 {o_rel:.3e}, lse max abs {lse_err:.3e}, planted fault {shift_rel:.3e}")
        parts = [f"o rel L2 {o_rel:.3e} (slab shifted {shift_rel:.3e}), lse max abs {lse_err:.3e}"]
        for part, a, b, fault in zip(("dq", "dk", "dv"), (dq, dk, dv), refs, faults):
            rel, fault_rel = _rel(a, b), _rel(fault, b)
            parts.append(f"{part} rel L2 {rel:.3e} (fault {fault_rel:.3e})")
            if not (rel < g_rel_tol and torch.isfinite(a).all() and fault_rel > g_rel_tol):
                failures.append(f"{where}: {part} rel L2 {rel:.3e}, planted fault {fault_rel:.3e}")
        halo_ms = _cuda_ms(lambda: ha.halo_fwd(q, k, v, W, g0, t_global, scale), 2)
        halo_bwd_ms = _cuda_ms(lambda: ha.halo_bwd_dkv(k, v, do, ha.halo_bwd_dq(q, k, v, o, lse, do, W, g0, t_global,
                                                                                scale)[1], W, g0, t_global), 2)
        _log(f"[forms shards] {where}: {'; '.join(parts)}; forward {halo_ms:.3f} ms, backward {halo_bwd_ms:.3f} ms")
        del q, do, k, v, o, lse, dq, prep, dk, dv, o_ref, lse_ref, o_shift, refs, faults
        for j, (label, B, t, H, Kv, tables) in enumerate(FORMS_RING):
            q, k_rot, _, v, do, cos, sin = _attention_inputs(B, 2 * t, H, Kv, tables, 1500 + 10 * i + j, D, dt)
            got = _ring_over(q, k_rot, v, do, cos, sin, 2)
            ref = _ring_over(q, k_rot, v, do, cos, sin, 2, ra.PlainParts)
            hop_fault = _rel(_ring_over(q, k_rot, v, do, cos, sin, 2, drop_hop)[0], ref[0])
            sweep_faults = _ring_over(q, k_rot, v, do, cos, sin, 2, store_once)[3:]
            where = f"ring {name} {label} B={B} T_local={t} H={H} Kv={Kv} over 2 shards"
            o_rel, o_err = _rel(got[0], ref[0]), (got[0].float() - ref[0]).abs().max().item()
            lse_err = (got[1] - ref[1]).abs().max().item()
            merge_err[(dt, D)] = max(merge_err.get((dt, D), 0.0), o_err)
            if not (o_rel < o_rel_tol and o_err < o_abs_tol and lse_err < lse_tol and hop_fault > o_rel_tol):
                failures.append(f"{where}: o rel L2 {o_rel:.3e}, max abs {o_err:.3e}, lse {lse_err:.3e}, "
                                f"planted dropped hop {hop_fault:.3e}")
            parts = [f"o rel L2 {o_rel:.3e} max abs {o_err:.3e} (dropped hop {hop_fault:.3e}), lse max abs {lse_err:.3e}"]
            for part, a, b in zip(("dq", "dk", "dv"), got[2:], ref[2:]):
                rel = _rel(a, b)
                parts.append(f"{part} rel L2 {rel:.3e}")
                if not (rel < g_rel_tol and torch.isfinite(a).all()):
                    failures.append(f"{where}: {part} rel L2 {rel:.3e}")
            for part, fault, b in zip(("dk", "dv"), sweep_faults, ref[3:]):
                if not _rel(fault, b) > g_rel_tol:
                    failures.append(f"{where}: planted stored sweep in {part} {_rel(fault, b):.3e} would pass")
            _log(f"[forms shards] {where}: {'; '.join(parts)}")
            del q, k_rot, v, do, got, ref, sweep_faults
            torch.cuda.empty_cache()
        launches[(dt, D)] = _forms_counts()
        _log(f"[forms shards] {name}: forms launches {launches[(dt, D)]}")
    if failures:
        raise AssertionError("forms shards: " + "; ".join(failures))
    return {"launches": launches, "merge_err": merge_err}


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
        sites = _unet_sites(cfg.model)
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
    sites = _unet_sites(cfg.model)
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
    sites = _unet_sites(cfg.model)
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


def phase_transformer_train(backbone: str, workdir: Path) -> tuple[dict, tuple]:
    """The trainer at the transformer cell, 4 steps with a save and a resume
    half way, without and with block remat; returns the launches of both runs
    together and step 1's (loss, grad_norm) without remat."""
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
        first = (history[0]["loss"], history[0]["grad_norm"]) if not remat else first
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
    return totals, first


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


# the ring (K6; phase 18): (label, B, T_local, H, Kv, rotary tables) at DiT's
# site, MMDiT's (1024 packed tokens a rank) and the UNet crop's level 0, each
# emulated over n = 2 and n = 4 shards of one sequence of n x T_local frames;
# times at n = 2, the shards of phase 19
RING_SHAPES = (("DiT", 4, 2048, 8, 8, False), ("MMDiT", 4, 1024, 8, 2, False),
               ("UNet crop level 0", 4, 2048, 16, 1, True))
RING_HOPS = (2, 4)
RING_TIMED_HOPS = 2


class _Ready:
    """A transfer that has arrived."""

    def __init__(self, value) -> None:
        self.value = value

    def wait(self):
        return self.value


class _ChunkRotation:
    """One rank's rotation over chunks of keys and values already on the
    card, to time that rank alone: the next chunk at each hop; the travelling
    gradients come back as they went. One per ring call."""

    def __init__(self, chunks: list, rank: int) -> None:
        self.chunks, self.rank, self.count, self.hop = chunks, rank, len(chunks), 0

    def start(self, t: torch.Tensor, tag: int) -> _Ready:
        from osufusion_tpu_torch.ops.ring_attention import KV_TAG

        if tag != KV_TAG:
            return _Ready(t)
        self.hop += 1
        return _Ready(self.chunks[(self.rank - self.hop) % self.count])


def _ring_faults():
    """The plain parts with a planted fault each: the second hop's partial
    left out of the merge; the second sweep storing its dk and dv instead of
    adding them."""
    from osufusion_tpu_torch.ops.ring_attention import PlainParts

    class DropHop(PlainParts):
        def __init__(self) -> None:
            self.hop = 0

        def merge(self, o_acc, lse_acc, o_j, lse_j, last):
            self.hop += 1
            if self.hop == 2:
                return o_acc, lse_acc, o_acc if last else None
            return super().merge(o_acc, lse_acc, o_j, lse_j, last)

    class StoreOnce(PlainParts):
        def __init__(self) -> None:
            self.hop = 0

        def backward_sweep(self, state, k, v, dk, dv, accumulate):
            self.hop += 1
            super().backward_sweep(state, k, v, dk, dv, accumulate and self.hop != 2)

    return DropHop, StoreOnce


def _ring_over(q, k_rot, v, do, cos, sin, n: int, parts=None) -> list:
    """The ring forward and backward of every one of n shards of the
    sequence, as threads of this process (``LocalRing``), with the kernels
    or, given ``parts`` (a class), its parts: (o, lse, dq, dk_rot, dv), the
    shards' rows joined."""
    from osufusion_tpu_torch.ops.ring_attention import LocalRing, ring_bwd, ring_fwd

    t = q.shape[1] // n

    def rows(x, r):
        return None if x is None else x.narrow(0 if x.ndim == 2 else 1, r * t, t).contiguous()

    def rank(r, rotation):
        own = parts() if parts is not None else None
        qr, kr, vr, dor, c, s = (rows(x, r) for x in (q, k_rot, v, do, cos, sin))
        o, lse = ring_fwd(qr, kr, vr, c, s, rotation, own)
        return (o, lse, *ring_bwd(qr, kr, vr, o, lse, dor, c, s, rotation, own))

    results = LocalRing(n).run(rank)
    torch.cuda.synchronize()
    return [torch.cat([r[i] for r in results], dim=1) for i in range(5)]


def phase_ring_kernels() -> dict:
    """The ring's kernels at RING_SHAPES over RING_HOPS shards against the
    ring's plain parts, planted faults above the bounds, and per-rank times
    at RING_TIMED_HOPS; returns DiT's records by part (the errors: the worst
    over the shapes)."""
    import torch.nn.functional as F

    from osufusion_tpu_torch.ops import flash_attention as fa
    from osufusion_tpu_torch.ops import ring_attention as ra
    from osufusion_tpu_torch.ops.rope import apply_rope
    from osufusion_tpu_torch.utils.flops import attention_flops, ring_flops

    D, scale = 64, 64**-0.5
    drop_hop, store_once = _ring_faults()
    failures, records = [], {}
    worst = {"fwd": 0.0, "bwd": 0.0, "merge": 0.0, "sweep": 0.0}
    for i, (label, B, t, H, Kv, tables) in enumerate(RING_SHAPES):
        for n in RING_HOPS:
            where = f"{label} (B={B} T_local={t} H={H} Kv={Kv}{' tables' if tables else ''}) over {n} shards"
            q, k_rot, _, v, do, cos, sin = _attention_inputs(B, n * t, H, Kv, tables, seed=800 + 10 * i + n)
            got = _ring_over(q, k_rot, v, do, cos, sin, n)
            ref = _ring_over(q, k_rot, v, do, cos, sin, n, ra.PlainParts)
            o_fault = _ring_over(q, k_rot, v, do, cos, sin, n, drop_hop)[0]
            bwd_fault = _ring_over(q, k_rot, v, do, cos, sin, n, store_once)[2:]
            o_rel, o_err = _rel(got[0], ref[0]), (got[0].float() - ref[0]).abs().max().item()
            lse_err, hop_fault = (got[1] - ref[1]).abs().max().item(), _rel(o_fault, ref[0])
            worst["fwd"] = max(worst["fwd"], o_err)
            if not (o_rel < REL_TOL and o_err < ABS_TOL and lse_err < LSE_TOL and torch.isfinite(got[0]).all()):
                failures.append(f"forward {where}: o rel L2 {o_rel:.3e}, max abs {o_err:.3e}, lse max abs {lse_err:.3e}")
            if not hop_fault > REL_TOL:
                failures.append(f"forward {where}: planted dropped hop {hop_fault:.3e} would pass {REL_TOL}")
            parts = []
            for name, a, b, fault in zip(("dq", "dk", "dv"), got[2:], ref[2:], bwd_fault):
                rel, err, top = _rel(a, b), (a.float() - b).abs().max().item(), b.abs().max().item()
                fault_rel = _rel(fault, b)
                worst["bwd"] = max(worst["bwd"], err)
                parts.append(f"{name} rel L2 {rel:.3e} max abs {err:.3e} of {top:.2f} (stored sweep {fault_rel:.3e})")
                if not (rel < BWD_REL_TOL and err < BWD_ABS_TOL * top and torch.isfinite(a).all()):
                    failures.append(f"backward {where}: {name} rel L2 {rel:.3e}, max abs {err:.3e} of {top:.3e}")
                if name != "dq" and not fault_rel > BWD_REL_TOL:
                    failures.append(f"backward {where}: planted stored sweep in {name} {fault_rel:.3e} would pass "
                                    f"{BWD_REL_TOL}")
            _log(f"[ring kernels] {where}: forward o rel L2 {o_rel:.3e} max abs {o_err:.3e} (dropped hop {hop_fault:.3e}), "
                 f"lse max abs {lse_err:.3e}; backward {'; '.join(parts)}")
            del got, ref, o_fault, bwd_fault
            if n != RING_TIMED_HOPS:
                del q, k_rot, v, do
                torch.cuda.empty_cache()
                continue

            # rank 0 of n alone, its chunks on the card; then each part alone
            def rows(x, r):
                return None if x is None else x.narrow(0 if x.ndim == 2 else 1, r * t, t).contiguous()

            chunks = [torch.stack([rows(k_rot, r), rows(v, r)]) for r in range(n)]
            q0, k0, v0, do0, c0, s0 = (rows(x, 0) for x in (q, k_rot, v, do, cos, sin))
            o0, lse0 = ra.ring_fwd(q0, k0, v0, c0, s0, _ChunkRotation(chunks, 0))
            fwd_ms = _cuda_ms(lambda: ra.ring_fwd(q0, k0, v0, c0, s0, _ChunkRotation(chunks, 0)), 10)
            bwd_ms = _cuda_ms(lambda: ra.ring_bwd(q0, k0, v0, o0, lse0, do0, c0, s0, _ChunkRotation(chunks, 0)), 10)
            fwd_plain_ms = _cuda_ms(lambda: ra.ring_fwd(q0, k0, v0, c0, s0, _ChunkRotation(chunks, 0), ra.PlainParts), 2)
            bwd_plain_ms = _cuda_ms(lambda: ra.ring_bwd(q0, k0, v0, o0, lse0, do0, c0, s0, _ChunkRotation(chunks, 0),
                                                        ra.PlainParts), 2)
            # the merge of hop 1 into hop 0's accumulators, and K2's parts on chunk 1, alone
            o_a, lse_a = fa.flash_fwd(q0, k0, v0, c0, s0, -1, scale, return_lse=True)
            o_j, lse_j = fa.flash_fwd(q0, rows(k_rot, 1), rows(v, 1), c0, s0, -1, scale, return_lse=True)
            acc = fa.ring_merge(None, None, o_a, lse_a, False)[:2]
            merged = fa.ring_merge(acc[0].clone(), acc[1], o_j, lse_j, True)[2]
            merged_ref = fa.ring_merge_reference(*fa.ring_merge_reference(None, None, o_a, lse_a), o_j, lse_j)[0]
            merge_err = (merged.float() - merged_ref).abs().max().item()
            merge_ms = _cuda_ms(lambda: fa.ring_merge(acc[0], acc[1], o_j, lse_j, False), 20)
            merge_plain_ms = _cuda_ms(lambda: fa.ring_merge_reference(acc[0], acc[1], o_j, lse_j), 5)
            prep = fa.flash_bwd_prep(q0, k0, v0, o0, lse0, do0, c0, s0, scale)
            dk, dv = (torch.empty(k0.shape, dtype=torch.float32, device="cuda") for _ in range(2))
            fa.flash_bwd_sweep(rows(k_rot, 1), rows(v, 1), prep, dk, dv, False)
            sweep_dq = fa.flash_bwd_post(prep, c0, s0, scale)
            sweep_ref = fa.flash_bwd_reference(q0, rows(k_rot, 1), rows(v, 1), o0, lse0, do0, c0, s0)
            # per gradient: (largest error, largest magnitude of the plain gradient)
            sweep_errs = [((a.float() - b).abs().max().item(), b.abs().max().item())
                          for a, b in zip((sweep_dq, dk, dv), sweep_ref)]
            sweep_err = max(err for err, _ in sweep_errs)
            prep_ms = _cuda_ms(lambda: fa.flash_bwd_prep(q0, k0, v0, o0, lse0, do0, c0, s0, scale), 20)
            sweep_ms = _cuda_ms(lambda: fa.flash_bwd_sweep(rows(k_rot, 1), rows(v, 1), prep, dk, dv, True), 10)
            post_ms = _cuda_ms(lambda: fa.flash_bwd_post(prep, c0, s0, scale), 20)
            # the plain pre-pass (qs, delta) and post-pass (scale, un-rotate, cast) on (B, t, H, D) rows
            prep_plain_ms = _cuda_ms(lambda: (fa._scaled_rotated_q(q0, c0, s0).to(torch.bfloat16),
                                              (do0.float() * o0.float()).sum(dim=-1)), 5)
            dq_rows = sweep_ref[0].float()
            post_plain_ms = _cuda_ms(lambda: fa._unrotated(dq_rows * scale, c0, s0).to(torch.bfloat16), 5)
            sweep_plain_ms = _cuda_ms(lambda: fa.flash_bwd_reference(q0, rows(k_rot, 1), rows(v, 1), o0, lse0, do0,
                                                                     c0, s0), 2)
            worst["merge"], worst["sweep"] = max(worst["merge"], merge_err), max(worst["sweep"], sweep_err)
            if not merge_err < ABS_TOL:
                failures.append(f"merge {where}: max abs {merge_err:.3e} against the plain merge")
            if not all(err < BWD_ABS_TOL * top for err, top in sweep_errs):
                failures.append(f"sweep {where}: (max abs, largest) {sweep_errs} against the plain gradients")

            # the yardstick: SDPA of this rank's queries against the gathered keys, never called by the port
            q_rot = q0 if c0 is None else apply_rope(q0.float(), c0, s0).to(torch.bfloat16)
            k_all = k_rot if Kv > 1 else k_rot[:, :, None]
            v_all = v if Kv > 1 else v[:, :, None]
            leaves = [x.transpose(1, 2).detach().clone().requires_grad_(True) for x in (q_rot, k_all, v_all)]
            with torch.no_grad():
                lib_fwd_ms = _cuda_ms(lambda: F.scaled_dot_product_attention(*leaves, enable_gqa=True), 10)
            lib_out = F.scaled_dot_product_attention(*leaves, enable_gqa=True)
            lib_rel = _rel(lib_out.transpose(1, 2), o0.float())
            dot = do0.transpose(1, 2)
            lib_bwd_ms = _cuda_ms(lambda: torch.autograd.grad(lib_out, leaves, dot, retain_graph=True), 10)
            del lib_out, leaves
            if not lib_rel < LIBRARY_REL_TOL:
                failures.append(f"{where}: SDPA on the gathered sequence differs from the ring by {lib_rel:.3e}")

            T, tab = n * t, 2 * t * D * 4 if tables else 0
            row, key = B * t * H * D * 2, B * T * Kv * D * 2  # one rank's rows of (B, t, H, D), the song's k or v, bf16
            stats = B * t * H * 4
            fwd_bound = _bound(ring_flops("forward", B, t, n, H, D), 2 * row + 2 * key + stats + tab)  # q o; k v; lse
            bwd_bound = _bound(ring_flops("backward_fused", B, t, n, H, D),
                               4 * row + 2 * key + 2 * key // n * 2 + stats + tab)  # q o do dq; k v; dk dv fp32; lse
            merge_bound = _bound(0, B * t * H * D * (4 + 2 + 4) + 3 * stats)  # o_acc in and out fp32, o_j; three LSEs
            sweep_bound = _bound(attention_flops("backward_fused", B, t, H, D, None),
                                 2 * row + 2 * key // n + 2 * key // n * 2 + 2 * stats + B * t * H * D * 4 * 2)
            prep_bound = _bound(0, 4 * row + stats * 3 + B * t * H * D * 4 + tab)  # q do o; qs; lse; lse delta; dq buffer
            post_bound = _bound(0, B * t * H * D * 4 + row + tab)
            _log(f"[ring kernels] {where}, rank 0 alone, ms: forward {fwd_ms:.3f} ({n} x K1 + merge; bound "
                 f"{fwd_bound[0]:.3f} by {fwd_bound[1]}; plain {fwd_plain_ms:.3f}; SDPA on the gathered keys "
                 f"{lib_fwd_ms:.3f}); backward {bwd_ms:.3f} (pre-pass, {n} sweeps, post-pass; bound {bwd_bound[0]:.3f}; "
                 f"plain {bwd_plain_ms:.3f}; SDPA backward {lib_bwd_ms:.3f}); merge {merge_ms:.4f} (bound "
                 f"{merge_bound[0]:.4f} by bytes; plain {merge_plain_ms:.4f}; max abs {merge_err:.2e}); sweep {sweep_ms:.3f} "
                 f"(bound {sweep_bound[0]:.3f}; plain one-hop backward {sweep_plain_ms:.3f}; max abs {sweep_err:.2e}, "
                 f"bound {BWD_ABS_TOL} x the largest); pre-pass {prep_ms:.4f} (bound {prep_bound[0]:.4f}); post-pass {post_ms:.4f} (bound "
                 f"{post_bound[0]:.4f}; plain pre-pass {prep_plain_ms:.4f}, post-pass {post_plain_ms:.4f}); SDPA vs ring rel L2 {lib_rel:.1e}")
            if label == "DiT":
                records = {
                    "ring_fwd": {"ms": fwd_ms, "plain_ms": fwd_plain_ms, "bound_ms": fwd_bound[0], "bound_by": fwd_bound[1],
                                 "library_ms": lib_fwd_ms},
                    "ring_bwd": {"ms": bwd_ms, "plain_ms": bwd_plain_ms, "bound_ms": bwd_bound[0], "bound_by": bwd_bound[1],
                                 "library_ms": lib_bwd_ms},
                    "ring_merge": {"ms": merge_ms, "plain_ms": merge_plain_ms, "bound_ms": merge_bound[0],
                                   "bound_by": merge_bound[1], "library_ms": None},
                    "flash_bwd_sweep": {"ms": sweep_ms, "plain_ms": sweep_plain_ms, "bound_ms": sweep_bound[0],
                                        "bound_by": sweep_bound[1], "library_ms": None},
                    "flash_bwd_prep": {"ms": prep_ms, "plain_ms": prep_plain_ms, "bound_ms": prep_bound[0],
                                       "bound_by": prep_bound[1], "library_ms": None},
                    "flash_bwd_post": {"ms": post_ms, "plain_ms": post_plain_ms, "bound_ms": post_bound[0],
                                       "bound_by": post_bound[1], "library_ms": None},
                }
            del q, k_rot, v, do, chunks, prep, dk, dv, dq_rows, sweep_ref
            torch.cuda.empty_cache()
    if failures:
        raise AssertionError("ring kernels vs plain: " + "; ".join(failures))
    errors = {"ring_fwd": worst["fwd"], "ring_bwd": worst["bwd"], "ring_merge": worst["merge"],
              "flash_bwd_sweep": worst["sweep"], "flash_bwd_prep": worst["sweep"], "flash_bwd_post": worst["sweep"]}
    return {name: {"max_abs_err": errors[name], **rec} for name, rec in records.items()}


def _ring_counts(fa, reset: bool = False) -> dict:
    """The ring's launches (K1 per hop is in ``_launches``'s forward_lse)."""
    parts = {"merge": fa.ring_merge, "prep": fa.flash_bwd_prep, "sweep": fa.flash_bwd_sweep, "post": fa.flash_bwd_post}
    if reset:
        for fn in parts.values():
            fn.launches = 0
    return {name: fn.launches for name, fn in parts.items()}


def _ring_cells(project_dir: Path) -> list:
    """Phase 19's cells, each as its one-card run is configured (phases 15
    and 8, without remat): (label, config to 1 step with a save, the global
    attention sites a step)."""
    from osufusion_tpu_torch.config import Config, ModelConfig, TrainConfig

    def train_cfg(label):
        return TrainConfig(project_dir=str(project_dir / label), dataset_mode="dummy", segment_length=2048, batch_size=4,
                           full_bf16=True, total_steps=1, warmup_steps=2, save_every=1, num_workers=2, seed=0,
                           mesh_seq=SEQ_SHARDS)

    unet = ModelConfig(dim_h=512, remat=False, remat_mode="save-attn")
    return [(b, Config(model=ModelConfig(backbone=b, remat=False, **TRANSFORMER), train=train_cfg(b)), TRANSFORMER["depth"])
            for b in ("dit", "mmdit")] + [
        ("unet", Config(model=unet, train=train_cfg("unet")), _unet_sites(unet))]


def _sharded_grad_check(backbone: str, shard, B: int = 2, T: int = 4096) -> dict:
    """Phase 14's check under the shard: DiT or MMDiT at phase 15's width
    with weights random everywhere (a fresh model's zero gates would leave
    every attention site out of the loss), its loss and every gradient in
    bf16 through the ring on this rank's frames (gradients summed over the
    group) against the same on the whole song on this card through K1 and
    K2: relative error of the loss and relative L2 of the gradients."""
    from osufusion_tpu_torch.config import DiffusionConfig, ModelConfig
    from osufusion_tpu_torch.models import build_model
    from osufusion_tpu_torch.parallel.sequence import frames_of, sequence_sharding
    from osufusion_tpu_torch.train.loop import sum_gradients

    rng = np.random.default_rng(7)
    x = torch.from_numpy(rng.standard_normal((B, 6, T)).astype(np.float32)).cuda()
    a = torch.from_numpy(rng.normal(-10.0, 3.0, (B, 96, T)).astype(np.float32)).cuda()
    c = torch.from_numpy(rng.uniform(-1, 1, (B, 5)).astype(np.float32)).cuda()
    orig_len = torch.tensor([T, T - 700][:B], device="cuda")
    noise = torch.from_numpy(rng.standard_normal((B, 6, T)).astype(np.float32)).cuda()
    t = torch.tensor([100, 700][:B], device="cuda")
    cond_mask = torch.tensor([True, False][:B], device="cuda")
    model = build_model(ModelConfig(backbone=backbone, **TRANSFORMER), DiffusionConfig())
    net = model.init_params(seed=0, device="cpu", dtype=torch.float32)
    randomize_transformer(net, seed=6)
    net = net.to("cuda", torch.bfloat16).train()

    def run(sharded: bool):
        net.zero_grad(set_to_none=True)
        with sequence_sharding(shard if sharded else None):
            xs, as_, ns = ((frames_of(v, shard, dim=-1) for v in (x, a, noise)) if sharded else (x, a, noise))
            loss = model.loss_from_draws(net, xs, as_, c, orig_len, ns, t, cond_mask)
            loss.backward()
        if sharded:
            sum_gradients(net, shard)
        torch.cuda.synchronize()
        return loss.item(), torch.cat([(p.grad if p.grad is not None else torch.zeros_like(p)).float().flatten()
                                       for p in net.parameters()])

    loss1, g1 = run(False)
    loss_s, g_s = run(True)
    return {"loss": loss_s, "one_card_loss": loss1, "loss_rel": abs(loss_s - loss1) / abs(loss1),
            "grad_rel": ((g_s - g1).norm() / g1.norm()).item(), "grad_norm": g1.norm().item()}


def _ring_rank(rank: int, port: int, project_dir: str, results) -> None:
    """One process of phase 19, in torchrun's environment: each cell of
    ``_ring_cells`` through ``trainer.train``, one step with a save and again
    from the checkpoint for a second, every count set to 0 before and read
    after, the whole-sequence gathers counted; (rank, error, results) put on
    ``results``."""
    import os
    import traceback

    os.environ.update({"MASTER_ADDR": "localhost", "MASTER_PORT": str(port), "WORLD_SIZE": str(SEQ_SHARDS),
                       "RANK": str(rank), "LOCAL_RANK": str(rank), "LOCAL_WORLD_SIZE": str(SEQ_SHARDS)})
    try:
        import torch.distributed as dist

        from osufusion_tpu_torch.ops import attention
        from osufusion_tpu_torch.ops import flash_attention as fa
        from osufusion_tpu_torch.parallel.distributed import local_device, maybe_initialize
        from osufusion_tpu_torch.parallel.mesh import make_mesh
        from osufusion_tpu_torch.trainer import train

        torch.cuda.set_device(local_device())
        maybe_initialize()
        gather = attention.all_gather_frames
        gathers = []

        def counted(*args):
            gathers.append(1)
            return gather(*args)

        attention.all_gather_frames = counted
        shard = make_mesh(data=1, model=1, seq=SEQ_SHARDS).seq_shard()
        checks = {b: _sharded_grad_check(b, shard) for b in ("dit", "mmdit")}
        out = []
        for label, cfg, _ in _ring_cells(Path(project_dir)):
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            _reset_launches(fa)
            _ring_counts(fa, reset=True)
            gathers.clear()
            history = train(cfg)
            history += train(dataclasses.replace(cfg, train=dataclasses.replace(cfg.train, total_steps=2, resume="latest")))
            torch.cuda.synchronize()
            out.append({"label": label, "history": history, "launches": {**_launches(fa), **_ring_counts(fa)},
                        "gathers": len(gathers), "peak": torch.cuda.max_memory_allocated() / 2**30})
        results.put((rank, None, {"cells": out, "checks": checks, "backend": dist.get_backend(),
                                  "device": str(local_device())}))
        dist.destroy_process_group()
    except Exception:  # reported to the parent, which fails on it
        results.put((rank, traceback.format_exc(), None))


def phase_ring_train(workdir: Path, one_card_losses: dict) -> dict:
    """Sequence-parallel training of DiT, MMDiT and the UNet crop cell over
    SEQ_SHARDS processes, every global site through the ring (phase 19):
    step 1's loss and gradient norm against the one-card trainer's
    (``one_card_losses``, label -> (loss, grad_norm) of step 1), the ranks
    alike, the ring's launches per step as the sites imply, no gather; before
    them, each rank's ``_sharded_grad_check`` of DiT and MMDiT. Returns rank
    0's ring launches over the three cells."""
    import multiprocessing
    import queue as queue_module

    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    port = _free_port()
    torch.cuda.empty_cache()
    procs = [ctx.Process(target=_ring_rank, args=(r, port, str(workdir / "ring"), results)) for r in range(SEQ_SHARDS)]
    for p in procs:
        p.start()
    got, deadline = {}, time.monotonic() + 900
    try:
        while len(got) < SEQ_SHARDS:
            try:
                rank, error, value = results.get(timeout=5)
            except queue_module.Empty:
                if time.monotonic() > deadline or any(p.exitcode is not None and r not in got for r, p in enumerate(procs)):
                    raise AssertionError(f"ring training: ranks {sorted(set(range(SEQ_SHARDS)) - set(got))} did not report "
                                         f"(exit codes {[p.exitcode for p in procs]})") from None
                continue
            if error is not None:
                raise AssertionError(f"ring training rank {rank}:\n{error}")
            got[rank] = value
    finally:
        for p in procs:
            p.join(timeout=120)
            if p.is_alive():
                p.terminate()
                p.join()
    for rank in sorted(got):
        for backbone, check in got[rank]["checks"].items():
            _log(f"[ring grad check {backbone}] rank {rank}: dim_h=512 depth {TRANSFORMER['depth']} B=2 T=4096, weights "
                 f"random everywhere, bf16: loss through the ring {check['loss']:.6f} vs one card {check['one_card_loss']:.6f} "
                 f"(rel {check['loss_rel']:.3e}, bound {LOSS_REL_TOL}); gradient rel L2 {check['grad_rel']:.3e} (bound "
                 f"{GRAD_REL_TOL}; |grad| {check['grad_norm']:.3e})")
            if not (check["loss_rel"] < LOSS_REL_TOL and check["grad_rel"] < GRAD_REL_TOL):
                raise AssertionError(f"ring grad check {backbone} rank {rank}: {check}")
    steps, totals = 2, {}
    for (label, cfg, sites), *cells in zip(_ring_cells(workdir / "ring"), *(got[r]["cells"] for r in sorted(got))):
        hops = SEQ_SHARDS * sites * steps
        grouped = hops if cfg.model.backbone != "unet" else 0
        expected = {"forward": 0, "forward_lse": hops, "backward_fused": 0, "backward_dq": 0, "backward_dkv": 0,
                    "forward_grouped": grouped, "backward_grouped": 0, "merge": hops, "prep": sites * steps,
                    "sweep": hops, "post": sites * steps}
        for rank, cell in enumerate(cells):
            history = cell["history"]
            _log(f"[ring train {label}] rank {rank} of {SEQ_SHARDS} on {got[rank]['device']} ({got[rank]['backend']}; "
                 f"{torch.cuda.device_count()} card(s) visible): dim_h=512 B=4 T=4096 ({4096 // SEQ_SHARDS} frames a rank) "
                 f"full bf16, 2 steps (save and resume at 1): loss {[round(h['loss'], 5) for h in history]}; grad_norm "
                 f"{[round(h['grad_norm'], 4) for h in history]}; s/step {[round(h['seconds'], 3) for h in history]}; "
                 f"peak memory {cell['peak']:.2f} GiB; launches over 2 steps {cell['launches']} (expected {expected}); "
                 f"whole-sequence gathers {cell['gathers']}")
            if [h["step"] for h in history] != [1, 2]:
                raise AssertionError(f"ring train {label} rank {rank}: steps {[h['step'] for h in history]}, expected [1, 2]")
            if not all(np.isfinite(h["loss"]) and np.isfinite(h["grad_norm"]) and h["grad_norm"] > 0 for h in history):
                raise AssertionError(f"ring train {label} rank {rank}: non-finite or zero loss or grad_norm {history}")
            if cell["launches"] != expected or cell["gathers"] != 0:
                raise AssertionError(f"ring train {label} rank {rank}: launches {cell['launches']}, gathers "
                                     f"{cell['gathers']}; expected {expected} and none")
        losses = [[(h["loss"], h["grad_norm"]) for h in cell["history"]] for cell in cells]
        if any(x != losses[0] for x in losses):
            raise AssertionError(f"ring train {label}: the ranks report different losses or norms: {losses}")
        (loss, norm), (loss1, norm1) = losses[0][0], one_card_losses[label]
        rel, norm_rel = abs(loss - loss1) / abs(loss1), abs(norm - norm1) / abs(norm1)
        _log(f"[ring train {label}] step 1 loss {loss:.6f} vs one card {loss1:.6f} (same seed and batch): rel {rel:.3e} "
             f"(bound {LOSS_REL_TOL}); grad_norm {norm:.5f} vs {norm1:.5f}: rel {norm_rel:.3e} (bound {GRAD_REL_TOL})")
        if not (rel < LOSS_REL_TOL and norm_rel < GRAD_REL_TOL):
            raise AssertionError(f"ring train {label}: step 1 (loss, grad_norm) {losses[0][0]} vs one card "
                                 f"{one_card_losses[label]}")
        for key in ("merge", "prep", "sweep", "post"):
            totals[key] = totals.get(key, 0) + cells[0]["launches"][key]
    return totals



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
    ddim = phase_sampler_latency(model, served)
    dpm = phase_sampler_latency(model, served, "dpmpp-2m", DPM_STEPS)
    _log(f"[sampler] DPM-{DPM_STEPS} vs DDIM-50 in this process, same weights and card: {statistics.mean(dpm):.3f} vs "
         f"{statistics.mean(ddim):.3f} s per map (mean of two), {statistics.mean(dpm) / statistics.mean(ddim):.3f}x")
    with tempfile.TemporaryDirectory() as tmp:
        song = check_song(Path(tmp))
        ddim50 = phase_sampler_check(model, served, song)
        phase_dpm_check(model, served, song, ddim50)
        phase_dpm_request(model, served, Path(tmp))
    del model, served, song, ddim50
    forms_records, forms_launches, wide_records, wide_launches = phase_forms()
    for B, T in ((2, 4096), (1, 16384)):
        torch.cuda.empty_cache()
        phase_grad_check(B, T)
    torch.cuda.empty_cache()
    one_card = {}  # step 1's (loss, grad_norm) of each cell that phase 19 runs sharded
    with tempfile.TemporaryDirectory() as tmp:
        lse_launches, bwd_launches, one_card["unet"] = phase_train(Path(tmp))
        phase_serve_trained(Path(tmp))
    with tempfile.TemporaryDirectory() as tmp:
        fullsong, fullsong_losses = phase_fullsong_train(Path(tmp))
    with tempfile.TemporaryDirectory() as tmp:
        seq = phase_seq_train(Path(tmp), fullsong_losses)
    grouped_fwd_lse, grouped_bwd, grouped_fwd = phase_grouped_kernels()
    torch.cuda.empty_cache()
    ring = phase_ring_kernels()
    for backbone in ("dit", "mmdit"):
        torch.cuda.empty_cache()
        phase_transformer_grad_check(backbone)
    grouped_train = {}
    with tempfile.TemporaryDirectory() as tmp:
        for backbone in ("dit", "mmdit"):
            launches_of, one_card[backbone] = phase_transformer_train(backbone, Path(tmp))
            for key, n in launches_of.items():
                grouped_train[key] = grouped_train.get(key, 0) + n
        grouped_serve = phase_serve_dit(Path(tmp))
    with tempfile.TemporaryDirectory() as tmp:
        ring_launches = phase_ring_train(Path(tmp), one_card)
    with tempfile.TemporaryDirectory() as tmp:
        phase_gqa_fullsong_train(Path(tmp))
    if any(m in sys.modules for m in ("jax", "flax", "optax", "osufusion_tpu")):
        raise AssertionError("the port imported jax or the JAX package")
    _log(f"[device] nvidia-smi: {smi}")  # again here, so that the end of the output names the card too
    fwd_source = {"route": "cuda", "source": "osufusion_tpu_torch/csrc/flash_fwd.cu",
                  "replaces": "osufusion_tpu/ops/pallas_attention.py:208"}
    windowed_source = {"route": "cuda", "source": "osufusion_tpu_torch/csrc/flash_bwd_windowed.cu"}
    merge_source = {"route": "cuda", "source": "osufusion_tpu_torch/csrc/ring_merge.cu",
                    "replaces": "osufusion_tpu/ops/pallas_attention.py:1310"}
    bwd_source = {"route": "cuda", "source": "osufusion_tpu_torch/csrc/flash_bwd.cu",
                  "replaces": "osufusion_tpu/ops/pallas_attention.py:1338"}
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
        {"name": "halo_fwd", **fwd_source, "replaces": "osufusion_tpu/ops/pallas_attention.py:938",
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
        # the ring: its forward (K1 per hop + the merge) and backward (pre-pass, a sweep per hop, post-pass) per
        # rank, and each of its kernels alone; a forward's launches counted by its merges, a backward's by its sweeps
        {"name": "ring_fwd", **merge_source, "launches": ring_launches["merge"], **ring["ring_fwd"]},
        {"name": "ring_bwd", **bwd_source, "launches": ring_launches["sweep"], **ring["ring_bwd"]},
        {"name": "ring_merge", **merge_source, "launches": ring_launches["merge"], **ring["ring_merge"]},
        {"name": "flash_bwd_prep", **bwd_source, "launches": ring_launches["prep"], **ring["flash_bwd_prep"]},
        {"name": "flash_bwd_sweep", **bwd_source, "launches": ring_launches["sweep"], **ring["flash_bwd_sweep"]},
        {"name": "flash_bwd_post", **bwd_source, "launches": ring_launches["post"], **ring["flash_bwd_post"]},
        *_forms_json(forms_records, forms_launches),
        *_wide_json(wide_records, wide_launches),
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
