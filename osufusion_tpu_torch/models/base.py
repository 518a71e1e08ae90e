"""Shared wrapper plumbing for the generative models
(``osufusion_tpu/models/base.py``).

The surface mirrors the JAX package: channel-first (B, C, N) tensors at the
API edge, and methods that take the denoiser as ``params``. Here ``params`` is
the ``UNet`` module itself, which holds its weights, on its device and in its
compute dtype (``init_params``, or ``serve.load_model`` for a checkpoint).
"""

from __future__ import annotations

import torch

from osufusion_tpu_torch.config import DiffusionConfig, ModelConfig
from osufusion_tpu_torch.nn.unet import UNet


def to_channel_last(x: torch.Tensor) -> torch.Tensor:
    return x.transpose(-1, -2)


def to_channel_first(x: torch.Tensor) -> torch.Tensor:
    return x.transpose(-1, -2)


class GenerativeModel:
    """Base: owns the configuration and builds the denoiser (UNet only)."""

    def __init__(self, model_cfg: ModelConfig, diffusion_cfg: DiffusionConfig) -> None:
        if model_cfg.backbone in ("dit", "mmdit"):
            raise NotImplementedError(
                f"backbone {model_cfg.backbone!r} is not ported yet (ROADMAP.md, queue 1: nn/dit.py and nn/mmdit.py)"
            )
        if model_cfg.backbone != "unet":
            raise ValueError(f"unknown backbone: {model_cfg.backbone}")
        self.model_cfg = model_cfg
        self.cfg = diffusion_cfg

    def init_params(self, seed: int = 0, device=None) -> UNet:
        """A UNet with weights drawn from ``seed`` (the global RNG state is
        left as it was), on ``device`` in the config's compute dtype."""
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(seed)
            unet = UNet(self.model_cfg)
        return unet.to(device=device, dtype=self.model_cfg.compute_dtype).eval()

    def encode_audio(self, params: UNet, a_cf: torch.Tensor) -> torch.Tensor:
        """(B, 96, N) -> audio features (channel-last), reused across sampling steps."""
        return params.encode_audio(to_channel_last(a_cf))

    def _cfg_eps(
        self,
        params: UNet,
        x: torch.Tensor,  # (B, T, C) channel-last
        a_enc: torch.Tensor,
        t: torch.Tensor,  # (B,)
        c: torch.Tensor,
        cond_scale: float,
    ) -> torch.Tensor:
        """Classifier-free-guided prediction. For scale != 1 the conditional
        and unconditional branches run as ONE doubled batch."""
        B = x.shape[0]
        ones = torch.ones((B,), dtype=torch.bool, device=x.device)
        if cond_scale == 1.0:
            return params(x, a_enc, t, c, ones, audio_encoded=True)
        mask = torch.cat([ones, torch.zeros_like(ones)])
        out = params(
            torch.cat([x, x]), torch.cat([a_enc, a_enc]), torch.cat([t, t]), torch.cat([c, c]), mask,
            audio_encoded=True,
        )
        cond, uncond = out[:B], out[B:]
        return uncond + (cond - uncond) * cond_scale
