"""Where the time of the PyTorch port's serving path, or of one training
step, goes on one NVIDIA GPU.

    python3 profile_torch_serve.py [--groupnorm fused|torch]
    python3 profile_torch_serve.py --train [--remat none|block|save-attn|save-attn-out|ff|resnet|resnet-dots|mixed]
        [--remat-levels save-attn-out,save-attn-out,block,block] [--batch 4] [--frames 4096] [--precision full-bf16|bf16]
        [--backbone unet|dit|mmdit]

At the serving cell (dim_h=128, default config, seeded weights; a 180 s song,
24576 padded frames; DDIM-50, CFG 2.0) it prints:

- the card's name and power limit (nvidia-smi);
- ms per UNet call at B=2 (the doubled CFG batch), by CUDA events;
- device time by kernel over one UNet call (torch.profiler), largest first,
  with the call's total device time and host time;
- s/map of the sampler, two maps;
- ms of the log-VQT of a 180 s signal on the GPU, and of the host decode of
  one map to .osu text.

``--groupnorm torch`` swaps the port's ``GroupNorm1`` for
``nn.functional.group_norm`` with one group on (B, C, T), the form it
replaced, so the two can be compared in one call.

``--train`` profiles a training cell instead (dim_h=512, default config,
seeded weights random everywhere, random batch; B=4, T=4096 unless told
otherwise: ``--batch 1 --frames 65536 --remat mixed`` is the full-song cell):
s/step by the host clock around synchronised steps, peak device memory, the
attention kernels' launches per step, device time by kernel over one step
(torch.profiler), and the device's idle share of that step. ``--backbone dit``
or ``mmdit`` profiles the transformer cell (dim_h=512, depth 12, 8 heads of
64, MMDiT with 2 KV heads; any ``--remat`` other than none rematerialises
whole blocks), with its MFU (3 x the forward's model FLOPs over the step and
989 TFLOP/s).
"""

from __future__ import annotations

import argparse
import subprocess
import time
from collections import defaultdict

import numpy as np
import torch
import torch.nn.functional as F

FRAMES = 24576  # 180 s at 125 frames/s, padded to the 8192-frame bucket
SONG_FRAMES = 22552
CALLS = 20  # UNet calls timed back to back
TOP = 15  # kernels listed


def _torch_groupnorm(self, x: torch.Tensor) -> torch.Tensor:
    return F.group_norm(x.transpose(1, 2), 1, self.weight, self.bias, self.eps).transpose(1, 2)


def _cuda_ms(fn, n: int) -> float:
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def kernel_table(fn, what: str = "one UNet call") -> float:
    """Profile one call of fn; print device time by kernel name and return
    the summed device time in ms."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        host_ms = (time.perf_counter() - t0) * 1e3
    total_us, count = defaultdict(float), defaultdict(int)
    for e in prof.events():
        # kernels and copies only: an annotation range on the device's timeline
        # (the optimizer's step) spans kernels that are counted already
        if e.device_type == DeviceType.CUDA and not getattr(e, "is_user_annotation", False):
            total_us[e.name] += e.time_range.elapsed_us()
            count[e.name] += 1
    device_ms = sum(total_us.values()) / 1e3
    print(f"[profile] {what}: {device_ms:.3f} ms of device kernels in {sum(count.values())} launches; "
          f"host {host_ms:.3f} ms (profiler on)")
    if not total_us:
        print("[profile] the profiler recorded no device time")
        return device_ms
    for name, us in sorted(total_us.items(), key=lambda kv: -kv[1])[:TOP]:
        print(f"[profile] {us / 1e3:9.3f} ms {100 * us / 1e3 / device_ms:5.1f} % {count[name]:5d}x  {name[:110]}")
    return device_ms


def profile_train(remat: str, levels: tuple, precision: str, B: int, T: int, backbone: str = "unet") -> None:
    """One training step at dim_h=512, through ``train/loop.py``."""
    from osufusion_tpu_torch.config import Config, ModelConfig, TrainConfig
    from osufusion_tpu_torch.models import build_model
    from osufusion_tpu_torch.ops import flash_attention as fa
    from osufusion_tpu_torch.train.loop import init_state, make_train_step
    from osufusion_tpu_torch.utils.flops import dit_fwd_flops, mmdit_fwd_flops

    transformer = dict(depth=12, attn_heads=8, attn_kv_heads=2) if backbone != "unet" else {}
    cfg = Config(
        model=ModelConfig(dim_h=512, backbone=backbone, remat=remat != "none",
                          remat_mode=remat if remat != "none" else "save-attn", remat_level_modes=levels, **transformer),
        train=TrainConfig(batch_size=B, full_bf16=precision == "full-bf16", lr=1e-5, warmup_steps=2, total_steps=100),
    )
    model = build_model(cfg.model, cfg.diffusion)
    state = init_state(model, cfg, "cuda")
    if backbone == "unet":
        # the final conv is zero at init, which would zero every gradient behind it
        g = torch.Generator(device="cuda").manual_seed(1)
        with torch.no_grad():
            w = state.params.final_conv.weight
            w.copy_(torch.randn(w.shape, generator=g, device="cuda") / cfg.model.dim_h**0.5)
    step = make_train_step(model, cfg)
    rng = np.random.default_rng(0)
    batch = (rng.standard_normal((B, 6, T)).astype(np.float32), rng.normal(-10.0, 3.0, (B, 96, T)).astype(np.float32),
             rng.uniform(-1, 1, (B, 5)).astype(np.float32), np.array([T, T - 500, T - 1000, T // 2][:B], np.int32))
    batch = tuple(torch.from_numpy(b).cuda() for b in batch)

    torch.cuda.reset_peak_memory_stats()
    for _ in range(2):
        step(state, batch)
    torch.cuda.synchronize()
    fa.flash_fwd.launches = fa.flash_fwd.lse_launches = fa.flash_bwd.launches = 0
    fa.flash_fwd.grouped_launches = fa.flash_bwd.grouped_launches = 0
    fa.flash_bwd_dq.launches = fa.flash_bwd_dkv.launches = 0
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        metrics = step(state, batch)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    step_s = sorted(times)[1]
    plan = f"{remat} ({','.join(levels)})" if remat == "mixed" else remat
    flops = {"dit": dit_fwd_flops, "mmdit": mmdit_fwd_flops}.get(backbone)
    mfu = f"; MFU {3 * flops(cfg.model, B, T) / step_s / 989e12:.4f}" if flops else ""
    print(f"[train] {backbone} dim_h=512 B={B} T={T} {precision} remat={plan}: {step_s:.4f} s/step (median of {times}){mfu}; "
          f"loss {float(metrics['loss']):.4f}; peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; "
          f"launches per step: forward with LSE {fa.flash_fwd.lse_launches // 3}, fused backward {fa.flash_bwd.launches // 3}, "
          f"dq {fa.flash_bwd_dq.launches // 3}, dkv {fa.flash_bwd_dkv.launches // 3}; grouped forward "
          f"{fa.flash_fwd.grouped_launches // 3}, grouped backward {fa.flash_bwd.grouped_launches // 3}")
    device_ms = kernel_table(lambda: step(state, batch), "one training step")
    print(f"[train] device busy {device_ms:.1f} ms of a {step_s * 1e3:.1f} ms step: idle share {1 - device_ms / (step_s * 1e3):.3f}")


def main() -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--groupnorm", choices=["fused", "torch"], default="fused")
    p.add_argument("--train", action="store_true", help="profile one training step instead of the serving path")
    p.add_argument("--remat", default="none",
                   choices=["none", "block", "save-attn", "save-attn-out", "ff", "resnet", "resnet-dots", "mixed"])
    p.add_argument("--remat-levels", default="save-attn-out,save-attn-out,block,block", help="per-level modes of --remat mixed")
    p.add_argument("--batch", type=int, default=4, help="--train: batch size (at most 4)")
    p.add_argument("--frames", type=int, default=4096, help="--train: sequence length")
    p.add_argument("--precision", choices=["full-bf16", "bf16"], default="full-bf16")
    p.add_argument("--backbone", choices=["unet", "dit", "mmdit"], default="unet", help="--train: the denoiser")
    args = p.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_torch_serve: needs an NVIDIA GPU")

    from osufusion_tpu_torch.codec.decode import Metadata, decode_beatmap
    from osufusion_tpu_torch.audio import frame_times
    from osufusion_tpu_torch.audio.vqt import log_vqt
    from osufusion_tpu_torch.config import Config, ModelConfig
    from osufusion_tpu_torch.models import build_model
    from osufusion_tpu_torch.nn import blocks

    if args.groupnorm == "torch":
        blocks.GroupNorm1.forward = _torch_groupnorm
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(f"[device] {smi}; torch {torch.__version__}; groupnorm {args.groupnorm}")
    if args.train:
        profile_train(args.remat, tuple(args.remat_levels.split(",")), args.precision, args.batch, args.frames,
                      args.backbone)
        return

    cfg = Config(model=ModelConfig(dim_h=128))
    model = build_model(cfg.model, cfg.diffusion)
    params = model.init_params(seed=0, device="cuda")
    g = torch.Generator().manual_seed(0)
    a = (torch.randn((1, 96, FRAMES), generator=g) * 3 - 10).cuda()
    c = (torch.rand((1, 5), generator=g) * 2 - 1).cuda()
    x = torch.randn((2, FRAMES, 6), generator=g).cuda()
    mask = torch.tensor([True, False], device="cuda")
    t = torch.tensor([500.0, 500.0], device="cuda")

    with torch.inference_mode():
        a_enc = model.encode_audio(params, a).repeat(2, 1, 1)
        c2 = c.repeat(2, 1)

        def unet_call():
            return params(x, a_enc, t, c2, mask, audio_encoded=True)

        ms = _cuda_ms(unet_call, CALLS)
        print(f"[unet] B=2 T={FRAMES}: {ms:.3f} ms per call (CUDA events, mean of {CALLS})")
        kernel_table(unet_call)

    for seed in (1, 2):
        x0 = torch.randn((1, 6, FRAMES), generator=torch.Generator().manual_seed(seed)).cuda()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = model.sample(params, a, c, x=x0, cond_scale=2.0, sampling_timesteps=50)
        torch.cuda.synchronize()
        print(f"[sampler] {FRAMES} frames, DDIM-50, CFG 2.0, B=1: {time.perf_counter() - t0:.3f} s/map")

    y = np.random.default_rng(0).standard_normal(180 * 22050).astype(np.float32) * 0.1
    vqt_ms = _cuda_ms(lambda: log_vqt(y, device="cuda"), 5)
    print(f"[audio] log-VQT of a 180 s signal: {vqt_ms:.3f} ms (host to device copy included)")

    signal = out[0, :, :SONG_FRAMES].float().cpu().numpy()
    meta = Metadata("song.wav", "t", "a", "v", 4.0, 9.0, 9.0, 5.0)
    t0 = time.perf_counter()
    decode_beatmap(meta, signal, frame_times(SONG_FRAMES), verbose=False)
    print(f"[decode] host decode of one 180 s map: {(time.perf_counter() - t0) * 1e3:.3f} ms")


if __name__ == "__main__":
    main()
