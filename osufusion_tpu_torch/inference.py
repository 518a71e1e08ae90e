"""Headless inference CLI on an NVIDIA GPU: audio -> .osz.

    python -m osufusion_tpu_torch.inference --model-path run/model.safetensors --audio song.wav

Takes the flags of the repository's root ``inference.py``; the ``ddim`` and
``dpmpp-2m`` samplers are ported (``midpoint`` samples rectified flow, which
is not).
"""

from __future__ import annotations

from argparse import ArgumentParser
from pathlib import Path

from osufusion_tpu_torch.serve import generate_beatmap, load_model


def build_parser() -> ArgumentParser:
    p = ArgumentParser()
    p.add_argument("--model-path", type=Path, required=True)
    p.add_argument("--config-path", type=Path, default=None)
    p.add_argument("--audio", type=Path, required=True)
    p.add_argument("--output", type=Path, default=Path("generated.osz"))
    p.add_argument("--title", type=str, default="Unknown")
    p.add_argument("--artist", type=str, default="Unknown")
    p.add_argument("--version", type=str, default="OsuFusion")
    p.add_argument("--cs", type=float, default=4.0)
    p.add_argument("--ar", type=float, default=9.0)
    p.add_argument("--od", type=float, default=9.0)
    p.add_argument("--hp", type=float, default=5.0)
    p.add_argument("--sr", type=float, default=6.0)
    p.add_argument("--num-samples", type=int, default=1)
    p.add_argument("--steps", type=int, default=None)
    p.add_argument(
        "--sampler",
        type=str,
        default=None,
        choices=["ddim", "dpmpp-2m"],
        help="override the model's sampler; dpmpp-2m reaches DDIM quality in ~half the steps",
    )
    p.add_argument("--cfg-scale", type=float, default=2.0)
    p.add_argument("--bpm", type=float, default=None)
    p.add_argument("--no-beat-snap", action="store_true")
    p.add_argument("--seed", type=int, default=0)
    return p


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)

    model, params = load_model(args.model_path, args.config_path)
    data, osu_texts = generate_beatmap(
        model,
        params,
        args.audio,
        title=args.title,
        artist=args.artist,
        version=args.version,
        cs=args.cs,
        ar=args.ar,
        od=args.od,
        hp=args.hp,
        sr=args.sr,
        num_samples=args.num_samples,
        sampling_timesteps=args.steps,
        sampler=args.sampler,
        cond_scale=args.cfg_scale,
        bpm=args.bpm,
        allow_beat_snap=not args.no_beat_snap,
        seed=args.seed,
        output_path=args.output,
    )
    n_objects = [len(t.split("[HitObjects]")[1].strip().splitlines()) for t in osu_texts]
    print(f"wrote {args.output} ({len(data)} bytes, {args.num_samples} map(s), hit objects: {n_objects})")


if __name__ == "__main__":
    main()
