"""Where the time of the PyTorch port's serving path, or of one training
step, goes on one NVIDIA GPU.

    python3 profile_torch_serve.py [--groupnorm fused|torch] [--dim-head 64] [--dtype bfloat16|float16|float32]
        [--sampler ddim|dpmpp-2m]
    python3 profile_torch_serve.py --train [--remat none|block|save-attn|save-attn-out|ff|resnet|resnet-dots|mixed]
        [--remat-levels save-attn-out,save-attn-out,block,block] [--batch 4] [--frames 4096]
        [--precision full-bf16|bf16|fp16|fp32] [--backbone unet|dit|mmdit] [--kv-heads 1] [--mesh-seq 1] [--dim-head 64]

At the serving cell (dim_h=128, default config, seeded weights; a 180 s song,
24576 padded frames; DDIM-50, CFG 2.0) it prints:

- the card's name and power limit (nvidia-smi);
- ms per UNet call at B=2 (the doubled CFG batch), by CUDA events;
- device time by kernel over one UNet call (torch.profiler), largest first,
  with the call's total device time and host time;
- s/map of the sampler, two maps (DDIM-50, or with ``--sampler dpmpp-2m``
  DPM-Solver++(2M) at 16 steps);
- ms of the log-VQT of a 180 s signal on the GPU, and of the host decode of
  one map to .osu text.

``--dim-head`` sets the model's ``attn_dim_head`` (a multiple of 64: 128,
192, 256 run K1 and K2's wider instances; the transformers then have
512 / dim_head heads), ``--dtype`` the serving model's parameter dtype
(float32 runs the fp32 forward, whose kernels' share of the call it prints;
float16 K1's fp16 instance).

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
989 TFLOP/s). ``--precision`` sets the step's precision: ``full-bf16``
(bf16 weights and moments), ``bf16`` or ``fp16`` (``--mixed-precision``:
float32 weights and moments, the forward under autocast at bfloat16 or
float16, fp16 with its static loss scale), or ``fp32`` (``--mixed-precision
no`` with float32 weights: every attention site in fp32, the fp32 forward
and backward pair, whose kernels' share of the step it prints).
``--kv-heads 2`` gives the UNet two KV heads (the whole-song
cell with it is ``chip_smoke.py``'s phase 17). ``--mesh-seq N`` runs the
step sequence-parallel in N processes (one card each over NCCL where N are
visible, else all on one card over gloo), every global site through the ring,
and reports rank 0's step, memory, launches (the ring's too) and kernel table.
The kernel table lists the largest kernels and every flash, halo and ring
kernel below them.
"""

from __future__ import annotations

import argparse
import dataclasses
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


# the fp32 attention's kernels by part, forms FMA bodies and six-product ones (a tree has the one or the other)
FP32_GROUPS = {"the fp32 forward (forms FMA)": ("forms_fwd_kernel",),
               "the fp32 forward (six-product)": ("x6_fwd_kernel",),
               "the fp32 backward pair (forms FMA dq, dk/dv)": ("forms_dq_kernel", "forms_dkv_kernel"),
               "the fp32 backward pair (six-product dq, dk/dv)": ("x6_dq_kernel", "x6_dkv_kernel"),
               "the split into bf16 pieces (k and v for the forward and the pair, qs and do)": ("x6_split_kernel",)}


def kernel_table(fn, what: str = "one UNet call", groups: dict = None) -> float:
    """Profile one call of fn; print device time by kernel name, and for each
    of ``groups`` (label -> substrings of kernel names) the summed time of the
    kernels whose names hold one; return the summed device time in ms."""
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
    ranked = sorted(total_us.items(), key=lambda kv: -kv[1])
    attention = [(name, us) for name, us in ranked[TOP:] if any(k in name for k in ("flash_", "halo_", "ring_"))]
    for name, us in ranked[:TOP] + attention:
        print(f"[profile] {us / 1e3:9.3f} ms {100 * us / 1e3 / device_ms:5.1f} % {count[name]:5d}x  {name[:110]}")
    for label, parts in (groups or {}).items():
        names = [name for name in total_us if any(part in name for part in parts)]
        ms = sum(total_us[name] for name in names) / 1e3
        print(f"[profile] {label}: {ms:.3f} ms {100 * ms / device_ms:.1f} % of the device time in "
              f"{sum(count[name] for name in names)} launches")
    return device_ms


def profile_train(remat: str, levels: tuple, precision: str, B: int, T: int, backbone: str = "unet",
                  kv_heads: int = 1, shard=None, dim_head: int = 64) -> None:
    """One training step at dim_h=512, through ``train/loop.py``; with
    ``shard``, this rank's part of the sequence-parallel step, reported by
    rank 0 alone (every rank runs the same steps)."""
    from osufusion_tpu_torch.config import Config, ModelConfig, TrainConfig
    from osufusion_tpu_torch.models import build_model
    from osufusion_tpu_torch.ops import flash_attention as fa
    from osufusion_tpu_torch.ops import flash_forms as forms
    from osufusion_tpu_torch.train.loop import init_state, make_train_step
    from osufusion_tpu_torch.utils.flops import dit_fwd_flops, mmdit_fwd_flops

    transformer = dict(depth=12, attn_heads=512 // dim_head, attn_kv_heads=2) if backbone != "unet" \
        else dict(attn_kv_heads=kv_heads)
    cfg = Config(
        model=ModelConfig(dim_h=512, backbone=backbone, remat=remat != "none", attn_dim_head=dim_head,
                          remat_mode=remat if remat != "none" else "save-attn", remat_level_modes=levels, **transformer),
        train=TrainConfig(batch_size=B, full_bf16=precision == "full-bf16", lr=1e-5, warmup_steps=2, total_steps=100,
                          mixed_precision={"fp16": "fp16", "fp32": "no"}.get(precision, "bf16")),
    )
    if precision in ("fp16", "fp32"):
        cfg = dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, dtype={"fp16": "float16",
                                                                                   "fp32": "float32"}[precision]))
    model = build_model(cfg.model, cfg.diffusion)
    state = init_state(model, cfg, "cuda")
    g = torch.Generator(device="cuda").manual_seed(1)
    with torch.no_grad():
        if backbone == "unet":
            # the final conv is zero at init, which would zero every gradient behind it
            w = state.params.final_conv.weight
            w.copy_(torch.randn(w.shape, generator=g, device="cuda") / cfg.model.dim_h**0.5)
        else:
            # so are the transformers' adaLN gates and output layers, which would leave the attention out of the
            # loss: the loss then depends on every site, so runs over any number of shards can be compared
            for w in state.params.parameters():
                if w.ndim >= 2 and not w.any():
                    w.copy_(torch.randn(w.shape, generator=g, device="cuda") * 0.5 / w[0].numel() ** 0.5)
    step = make_train_step(model, cfg, shard)
    report = shard is None or shard.index == 0
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
    fa.ring_merge.launches = fa.flash_bwd_prep.launches = fa.flash_bwd_sweep.launches = fa.flash_bwd_post.launches = 0
    # the forms family's dq and dk/dv and the fp32 pair on the tensor cores (a tree before it has none)
    pairs = {"forms": (forms.forms_bwd_dq, forms.forms_bwd_dkv),
             "f32x6": tuple(getattr(fa, name) for name in ("f32x6_bwd_dq", "f32x6_bwd_dkv") if hasattr(fa, name))}
    for fn in (*pairs["forms"], *pairs["f32x6"]):
        fn.launches = 0
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        metrics = step(state, batch)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    step_s = sorted(times)[1]
    if not report:
        step(state, batch)  # rank 0's profiled step
        return
    plan = f"{remat} ({','.join(levels)})" if remat == "mixed" else remat
    flops = {"dit": dit_fwd_flops, "mmdit": mmdit_fwd_flops}.get(backbone)
    mfu = f"; MFU {3 * flops(cfg.model, B, T) / step_s / 989e12:.4f}" if flops else ""
    kv = (f" kv_heads={kv_heads}" if kv_heads > 1 else "") + (f" dim_head={dim_head}" if dim_head != 64 else "")
    if shard is not None:
        mfu = ""  # the model FLOPs are the whole step's, this is one rank's share
        kv += (f" rank 0 of {shard.count} ({T // shard.count} frames a rank); ring per step: merge "
               f"{fa.ring_merge.launches // 3}, pre-pass {fa.flash_bwd_prep.launches // 3}, sweep "
               f"{fa.flash_bwd_sweep.launches // 3}, post-pass {fa.flash_bwd_post.launches // 3}")
    print(f"[train] {backbone}{kv} dim_h=512 B={B} T={T} {precision} remat={plan}: {step_s:.4f} s/step (median of {times}){mfu}; "
          f"loss {float(metrics['loss']):.4f}; peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; "
          f"launches per step: forward with LSE {fa.flash_fwd.lse_launches // 3}, fused backward {fa.flash_bwd.launches // 3}, "
          f"dq {fa.flash_bwd_dq.launches // 3}, dkv {fa.flash_bwd_dkv.launches // 3}; grouped forward "
          f"{fa.flash_fwd.grouped_launches // 3}, grouped backward {fa.flash_bwd.grouped_launches // 3}; dq, dk/dv of "
          + ", ".join(f"{name} {[fn.launches // 3 for fn in fns]}" for name, fns in pairs.items() if fns))
    groups = FP32_GROUPS if precision == "fp32" else {}
    device_ms = kernel_table(lambda: step(state, batch), "one training step", groups)
    print(f"[train] device busy {device_ms:.1f} ms of a {step_s * 1e3:.1f} ms step: idle share {1 - device_ms / (step_s * 1e3):.3f}")


def _profile_rank(rank: int, n: int, port: int, args) -> None:
    """One process of ``--train --mesh-seq n``, in torchrun's environment."""
    import os

    os.environ.update({"MASTER_ADDR": "localhost", "MASTER_PORT": str(port), "WORLD_SIZE": str(n), "RANK": str(rank),
                       "LOCAL_RANK": str(rank), "LOCAL_WORLD_SIZE": str(n)})
    import torch.distributed as dist

    from osufusion_tpu_torch.parallel.distributed import local_device, maybe_initialize
    from osufusion_tpu_torch.parallel.mesh import make_mesh

    torch.cuda.set_device(local_device())
    maybe_initialize()
    if rank == 0:
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
        print(f"[device] {smi}; torch {torch.__version__}; {n} processes over {dist.get_backend()} on "
              f"{torch.cuda.device_count()} card(s)", flush=True)
    profile_train(args.remat, tuple(args.remat_levels.split(",")), args.precision, args.batch, args.frames,
                  args.backbone, args.kv_heads, make_mesh(data=1, model=1, seq=n).seq_shard(), args.dim_head)
    dist.destroy_process_group()


def main() -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--groupnorm", choices=["fused", "torch"], default="fused")
    p.add_argument("--train", action="store_true", help="profile one training step instead of the serving path")
    p.add_argument("--remat", default="none",
                   choices=["none", "block", "save-attn", "save-attn-out", "ff", "resnet", "resnet-dots", "mixed"])
    p.add_argument("--remat-levels", default="save-attn-out,save-attn-out,block,block", help="per-level modes of --remat mixed")
    p.add_argument("--batch", type=int, default=4, help="--train: batch size (at most 4)")
    p.add_argument("--frames", type=int, default=4096, help="--train: sequence length")
    p.add_argument("--precision", choices=["full-bf16", "bf16", "fp16", "fp32"], default="full-bf16")
    p.add_argument("--backbone", choices=["unet", "dit", "mmdit"], default="unet", help="--train: the denoiser")
    p.add_argument("--kv-heads", type=int, default=1, help="--train: the UNet's KV heads")
    p.add_argument("--mesh-seq", type=int, default=1, help="--train: sequence shards, one process each")
    p.add_argument("--dim-head", type=int, default=64, help="the attention head dim (attn_dim_head)")
    p.add_argument("--dtype", choices=["bfloat16", "float16", "float32"], default="bfloat16",
                   help="the serving model's dtype")
    p.add_argument("--sampler", choices=["ddim", "dpmpp-2m"], default="ddim",
                   help="the sampler of the s/map reading: DDIM-50 or DPM-Solver++(2M) at 16 steps")
    args = p.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_torch_serve: needs an NVIDIA GPU")
    if args.train and args.mesh_seq > 1:
        import multiprocessing
        import socket

        with socket.socket() as sock:
            sock.bind(("localhost", 0))
            port = sock.getsockname()[1]
        ctx = multiprocessing.get_context("spawn")
        procs = [ctx.Process(target=_profile_rank, args=(r, args.mesh_seq, port, args)) for r in range(args.mesh_seq)]
        for proc in procs:
            proc.start()
        for proc in procs:
            proc.join()
        if any(proc.exitcode for proc in procs):
            raise SystemExit(f"profile_torch_serve: ranks exited with {[proc.exitcode for proc in procs]}")
        return

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
    print(f"[device] {smi}; torch {torch.__version__}; groupnorm {args.groupnorm}; dim_head {args.dim_head}")
    if args.train:
        profile_train(args.remat, tuple(args.remat_levels.split(",")), args.precision, args.batch, args.frames,
                      args.backbone, args.kv_heads, dim_head=args.dim_head)
        return

    cfg = Config(model=ModelConfig(dim_h=128, attn_dim_head=args.dim_head, dtype=args.dtype))
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
        print(f"[unet] {args.dtype} dim_head={args.dim_head} B=2 T={FRAMES}: {ms:.3f} ms per call (CUDA events, mean "
              f"of {CALLS})")
        kernel_table(unet_call, groups=FP32_GROUPS if args.dtype == "float32" else {})

    steps, name = (16, "DPM-16") if args.sampler == "dpmpp-2m" else (50, "DDIM-50")
    for seed in (1, 2):
        x0 = torch.randn((1, 6, FRAMES), generator=torch.Generator().manual_seed(seed)).cuda()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = model.sample(params, a, c, x=x0, cond_scale=2.0, sampling_timesteps=steps, method=args.sampler)
        torch.cuda.synchronize()
        print(f"[sampler] {FRAMES} frames, {name}, CFG 2.0, B=1: {time.perf_counter() - t0:.3f} s/map")

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
