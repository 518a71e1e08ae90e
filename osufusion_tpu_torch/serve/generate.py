"""End-to-end generation: audio file -> sampled signal -> .osu decode -> .osz
(``osufusion_tpu/serve/generate.py``).

The spectrogram, the sampler and the denoiser (the UNet, DiT or MMDiT that
the checkpoint's ``config.json`` names) run on the model's device; the
decode to ``.osu`` text runs on the host with this package's copy of the
codec (``codec/decode.py``). Initial noise comes from a CPU ``torch.Generator`` seeded with
``seed``, so a seed gives the same noise on every device.
"""

from __future__ import annotations

import io
import zipfile
from pathlib import Path
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from osufusion_tpu_torch.codec.decode import Metadata, decode_beatmap
from osufusion_tpu_torch.audio import frame_times, load_audio, normalize_context
from osufusion_tpu_torch.config import Config, ModelConfig
from osufusion_tpu_torch.models import build_model
from osufusion_tpu_torch.nn.unet import A_PAD_VALUE
from osufusion_tpu_torch.utils.convert import load_params_lenient
from osufusion_tpu_torch.utils.serialization import load_safetensors

# pad generated lengths to a multiple of this, as the JAX package does, so
# every UNet level of every song is longer than its attention context
LENGTH_BUCKET = 8192


def load_model(model_path: Path, config_path: Optional[Path] = None, device="cuda"):
    """Returns (model, params): a checkpoint written by either package's
    trainer (``model.safetensors``) and the ``config.json`` beside it if
    present, else the UNet defaults at dim_h=128. ``params`` is the backbone
    the config names, on ``device`` in the config's compute dtype. The load
    is lenient, as the JAX package's: the backbone is drawn from seed 0, the
    checkpoint's leaves that it has with the same shape replace the draws,
    and missing, unexpected and shape-mismatched keys are reported."""
    model_path = Path(model_path)
    if config_path is None:
        candidate = model_path.parent / "config.json"
        config_path = candidate if candidate.exists() else None
    cfg = Config.load(config_path) if config_path else Config(model=ModelConfig(dim_h=128))
    model = build_model(cfg.model, cfg.diffusion)
    params = model.init_params(seed=0, device=device, dtype=torch.float32)
    load_params_lenient(params, load_safetensors(model_path))
    return model, params.to(dtype=cfg.model.compute_dtype).eval()


def generate_beatmap(
    model,
    params: torch.nn.Module,
    audio_path: Path,
    title: str = "Unknown",
    artist: str = "Unknown",
    version: str = "OsuFusion",
    cs: float = 4.0,
    ar: float = 9.0,
    od: float = 9.0,
    hp: float = 5.0,
    sr: float = 6.0,
    num_samples: int = 1,
    sampling_timesteps: Optional[int] = None,
    sampler: Optional[str] = None,
    cond_scale: float = 2.0,
    bpm: Optional[float] = None,
    allow_beat_snap: bool = True,
    seed: int = 0,
    output_path: Optional[Path] = None,
) -> Tuple[bytes, list[str]]:
    """Returns (.osz bytes, list of .osu texts). Writes to output_path if given."""
    audio_path = Path(audio_path)
    device = params.null_cond.device
    spec = load_audio(audio_path, device=device)  # (96, T)
    n = spec.shape[-1]
    padded = ((n + LENGTH_BUCKET - 1) // LENGTH_BUCKET) * LENGTH_BUCKET
    spec_p = F.pad(spec, (0, padded - n), value=A_PAD_VALUE)

    a = spec_p[None].repeat(num_samples, 1, 1)
    context = normalize_context(np.array([cs, ar, od, hp, sr], np.float32))
    c = torch.from_numpy(np.repeat(context[None], num_samples, 0)).to(device)
    generator = torch.Generator().manual_seed(seed)
    x0 = torch.randn((num_samples, model.model_cfg.dim_in_x, padded), generator=generator).to(device)

    out = model.sample(params, a, c, x=x0, cond_scale=cond_scale, sampling_timesteps=sampling_timesteps,
                       method=sampler or "ddim")
    signals = out[..., :n].cpu().numpy()  # crop padding back off

    ft = frame_times(n)
    meta = Metadata(audio_path.name, title, artist, version, cs, ar, od, hp)

    osu_texts = []
    buf = io.BytesIO()
    with zipfile.ZipFile(buf, "w", zipfile.ZIP_DEFLATED) as z:
        z.write(audio_path, audio_path.name)
        for i in range(num_samples):
            osu = decode_beatmap(meta, signals[i], ft, bpm=bpm, allow_beat_snap=allow_beat_snap, verbose=False)
            osu_texts.append(osu)
            suffix = f" {i + 1}" if num_samples > 1 else ""
            z.writestr(f"{artist} - {title} ({version}{suffix}).osu", osu)
    data = buf.getvalue()

    if output_path is not None:
        Path(output_path).write_bytes(data)
    return data, osu_texts
