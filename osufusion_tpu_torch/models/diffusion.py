"""DDIM diffusion model (``osufusion_tpu/models/diffusion.py``): the sampler
encodes the audio once, runs CFG as one doubled batch, and steps DDIM in a
Python loop under ``torch.inference_mode()``."""

from __future__ import annotations

from typing import Optional

import torch

from osufusion_tpu_torch.models import ddim
from osufusion_tpu_torch.models.base import GenerativeModel, to_channel_first, to_channel_last
from osufusion_tpu_torch.nn.unet import UNet


class DiffusionModel(GenerativeModel):
    def __init__(self, model_cfg, diffusion_cfg) -> None:
        super().__init__(model_cfg, diffusion_cfg)
        self.acp = ddim.alphas_cumprod(diffusion_cfg.train_timesteps, diffusion_cfg.beta_start, diffusion_cfg.beta_end)

    def loss(self, *args, **kwargs):
        raise NotImplementedError("the diffusion loss is not ported yet (ROADMAP.md, queue 1: training)")

    @torch.inference_mode()
    def sample(
        self,
        params: UNet,
        a: torch.Tensor,  # (B, 96, N)
        c: torch.Tensor,  # (B, 5)
        x: Optional[torch.Tensor] = None,  # (B, 6, N) initial noise
        generator: Optional[torch.Generator] = None,
        cond_scale: float = 7.0,
        sampling_timesteps: Optional[int] = None,
        method: str = "ddim",
    ) -> torch.Tensor:
        """Returns (B, 6, N) float32. Initial noise is ``x`` or, without it,
        drawn from ``generator`` on a's device."""
        if method == "dpmpp-2m":
            raise NotImplementedError("the DPM++(2M) sampler is not ported yet (ROADMAP.md, queue 1: models/dpm.py)")
        if method != "ddim":
            raise ValueError(f"unknown sampling method: {method!r}")
        B, _, N = a.shape
        if x is None:
            if generator is None:
                raise ValueError("provide either initial noise x or a generator")
            x = torch.randn((B, self.model_cfg.dim_in_x, N), generator=generator, device=a.device)
        x = to_channel_last(x).float()

        steps = sampling_timesteps or self.cfg.sampling_timesteps
        ts = ddim.ddim_timesteps(self.cfg.train_timesteps, steps)
        ts_prev = [*ts[1:].tolist(), -1]
        acp = self.acp.to(x.device)

        a_enc = self.encode_audio(params, a)
        for t, t_prev in zip(ts.tolist(), ts_prev):
            t_b = torch.full((B,), float(t), device=x.device)
            eps = self._cfg_eps(params, x, a_enc, t_b, c, cond_scale)
            x = ddim.ddim_step(x, eps, t, t_prev, acp, self.cfg.clip_sample)
        return to_channel_first(x)
