"""Smoke run of the PyTorch port (``osufusion_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printed as it ends; any failure raises and the exit code is not 0:

1. Device: name, power limit, versions; build the flash-forward kernel from
   ``osufusion_tpu_torch/csrc`` with nvcc for sm_90a.
2. Kernel vs its plain PyTorch version at the serving path's attention shapes
   (B=2 under CFG, H=16, D=64, bf16): relative L2 and largest error against
   their bounds, a planted fault that the bound must catch, and CUDA-event
   times.
3. The full-width UNet (dim_h=128, default config, seeded weights) forward at
   B=1, T=8192: bf16 on the GPU through the kernel vs fp32 on the CPU through
   the plain path.
4. Serving: ``generate_beatmap`` on synthesized songs (180 s with DDIM-50 and
   CFG 2.0; 60 s with two samples), each an ``.osz`` holding the returned
   ``.osu`` texts with hit objects, with the kernel launched once per
   attention site of the path.

The line before the last is a JSON record of the kernel; the last line is
``{"ok": true, "device": {...}}``. Without a CUDA device the script exits
non-zero before printing either.
"""

from __future__ import annotations

import copy
import io
import json
import re
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
FAULT_TILE = 64  # keys in the kernel's KV tile: the global shape's planted fault drops the last one
# bf16 UNet on the GPU vs fp32 UNet on the CPU: relative L2 error of the
# output. Every layer rounds its activations to bf16 (~4e-3 relative); over
# ~100 layers with residual paths that compounds to ~1e-2
UNET_REL_TOL = 5e-2
ATTN_SHAPES = [(24576, 4096), (12288, 2048), (6144, 1024), (3072, 512), (4096, None)]
SR = 22050
# a .osu hit object line: x,y,time,type,hitsound[,...]
HIT_OBJECT = re.compile(r"^-?\d+(\.\d+)?,-?\d+(\.\d+)?,\d+(\.\d+)?,\d+,\d+")


def _log(msg: str) -> None:
    print(msg, flush=True)


def _cuda_ms(fn, n: int) -> float:
    """Mean milliseconds per call of fn over n calls, from CUDA events."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def phase_device() -> tuple[str, str]:
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
    lib = build_kernels(verbose=True)
    _log(f"[build] {lib.name} (nvcc, sm_90a) ready in {time.perf_counter() - t0:.2f} s")
    return name, smi


def _rel(x: torch.Tensor, ref: torch.Tensor) -> float:
    return ((x.float() - ref).norm() / ref.norm()).item()


def phase_kernel() -> dict:
    from osufusion_tpu_torch.ops import flash_attention as fa
    from osufusion_tpu_torch.ops.attention import gqa_attention
    from osufusion_tpu_torch.ops.rope import apply_rope, rope_tables

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
        k_rot = apply_rope(k.reshape(B, T, D).float(), *rope).to(torch.bfloat16)
        v3 = v.reshape(B, T, D).contiguous()
        plain_ms = _cuda_ms(lambda: fa.flash_attention_reference(q, k, v, window, rope), 3)
        kernel_ms = _cuda_ms(lambda: fa.flash_fwd(q, k_rot, v3, *rope, -1 if window is None else window, D**-0.5), 20)
        plain_ms2 = _cuda_ms(lambda: fa.flash_attention_reference(q, k, v, window, rope), 3)
        keys = T if window is None else window + 1
        tflops = 4 * B * T * H * keys * D / (kernel_ms * 1e-3) / 1e12
        _log(f"[kernel] T={T} window={window}: rel L2 err {rel:.3e} (tol {REL_TOL}; planted fault {fault_rel:.3e}); "
             f"max abs err {err:.3e} (tol {ABS_TOL}); kernel {kernel_ms:.3f} ms ({tflops:.1f} TFLOP/s); "
             f"plain bf16 {plain_ms:.3f} / {plain_ms2:.3f} ms")
        if not (rel < REL_TOL and err < ABS_TOL and torch.isfinite(out).all()):
            failures.append(f"T={T} window={window}: rel L2 {rel:.3e}, max abs {err:.3e}")
        if not fault_rel > REL_TOL:
            failures.append(f"T={T} window={window}: planted fault {fault_rel:.3e} would pass REL_TOL {REL_TOL}")
        worst = max(worst, err)
        if level0 is None:
            level0 = {"ms": kernel_ms, "plain_ms": min(plain_ms, plain_ms2)}
        del q, k, v, out, k_rot, v3
        torch.cuda.empty_cache()
    if failures:
        raise AssertionError("kernel vs plain: " + "; ".join(failures))
    return {"max_abs_err": worst, **level0}


def build_unet_pair():
    """The default config at dim_h=128: seeded fp32 weights on the CPU and a
    bf16 copy on the GPU. final_conv is zero at init; it gets seeded weights
    so the output depends on everything before it."""
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


def phase_serve(model, params) -> int:
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


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this run needs an NVIDIA GPU", file=sys.stderr)
        return 1
    name, _ = phase_device()
    kernel = phase_kernel()
    model, cpu, gpu = build_unet_pair()
    phase_unet(cpu, gpu)
    del cpu
    launches = phase_serve(model, gpu)
    phase_sampler_latency(model, gpu)
    if "jax" in sys.modules or "flax" in sys.modules:
        raise AssertionError("the port imported jax")
    print(json.dumps({"kernels": [{
        "name": "flash_fwd", "route": "cuda", "source": "osufusion_tpu_torch/csrc/flash_fwd.cu",
        "replaces": "osufusion_tpu/ops/pallas_attention.py:208", "launches": launches,
        "max_abs_err": kernel["max_abs_err"], "ms": kernel["ms"], "plain_ms": kernel["plain_ms"],
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
