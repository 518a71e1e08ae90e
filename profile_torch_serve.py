"""Where the time of the PyTorch port's serving path goes, on one NVIDIA GPU.

    python3 profile_torch_serve.py [--groupnorm fused|torch]

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


def kernel_table(fn) -> None:
    """Profile one call of fn; print device time by kernel name."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        host_ms = (time.perf_counter() - t0) * 1e3
    total_us, count = defaultdict(float), defaultdict(int)
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            total_us[e.name] += e.time_range.elapsed_us()
            count[e.name] += 1
    device_ms = sum(total_us.values()) / 1e3
    print(f"[profile] one UNet call: {device_ms:.3f} ms of device kernels in {sum(count.values())} launches; "
          f"host {host_ms:.3f} ms (profiler on)")
    if not total_us:
        print("[profile] the profiler recorded no device time")
        return
    for name, us in sorted(total_us.items(), key=lambda kv: -kv[1])[:TOP]:
        print(f"[profile] {us / 1e3:9.3f} ms {100 * us / 1e3 / device_ms:5.1f} % {count[name]:5d}x  {name[:110]}")


def main() -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--groupnorm", choices=["fused", "torch"], default="fused")
    args = p.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_torch_serve: needs an NVIDIA GPU")

    from osufusion_tpu.codec.decode import Metadata, decode_beatmap
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
