"""DDIM diffusion model (``osufusion_tpu/models/diffusion.py``): the
epsilon-prediction loss (t ~ U{0..train_timesteps-1}, conditioning dropped
with ``cond_drop_prob``, MSE against the noise over valid frames), and the
sampler, which encodes the audio once, runs CFG as one doubled batch, and
steps DDIM or DPM-Solver++(2M) (``models/dpm.py``) in a Python loop under
``torch.inference_mode()``, in fp32 on x channel-last."""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch import nn

from osufusion_tpu_torch.models import ddim
from osufusion_tpu_torch.models.base import GenerativeModel, masked_mse, to_channel_first, to_channel_last
from osufusion_tpu_torch.models.dpm import dpmpp_2m_coeffs, dpmpp_2m_step, dpmpp_timesteps
from osufusion_tpu_torch.parallel.sequence import active_shard, frames_of


class DiffusionModel(GenerativeModel):
    def __init__(self, model_cfg, diffusion_cfg) -> None:
        super().__init__(model_cfg, diffusion_cfg)
        self.acp = ddim.alphas_cumprod(diffusion_cfg.train_timesteps, diffusion_cfg.beta_start, diffusion_cfg.beta_end)

    def loss(
        self,
        params: nn.Module,
        generator: torch.Generator,  # on x's device
        x: torch.Tensor,  # (B, 6, N) channel-first
        a: torch.Tensor,  # (B, 96, N)
        c: torch.Tensor,  # (B, 5)
        orig_len: Optional[torch.Tensor] = None,  # (B,) valid frames
    ) -> torch.Tensor:
        """The training loss (a float32 scalar) with noise, timesteps and the
        conditioning mask drawn from ``generator``. Under a sequence shard x
        and a hold this rank's frames; the noise is drawn for the whole song,
        as on one device, and this rank takes its frames, so n ranks with one
        generator state make the one-device step's draws."""
        B = x.shape[0]
        shard = active_shard()
        song = x.shape if shard is None else (*x.shape[:-1], x.shape[-1] * shard.count)
        noise = torch.randn(song, generator=generator, device=x.device, dtype=x.dtype)
        if shard is not None:
            noise = frames_of(noise, shard, dim=-1)
        t = torch.randint(0, self.cfg.train_timesteps, (B,), generator=generator, device=x.device)
        cond_mask = torch.rand((B,), generator=generator, device=x.device) < 1.0 - self.cfg.cond_drop_prob
        return self.loss_from_draws(params, x, a, c, orig_len, noise, t, cond_mask)

    def loss_from_draws(self, params: nn.Module, x, a, c, orig_len, noise, t, cond_mask) -> torch.Tensor:
        """``loss`` with its random draws handed in: noise (B, 6, N)
        channel-first like x, t (B,) integer, cond_mask (B,) bool."""
        if x.shape[-1] != a.shape[-1]:
            raise ValueError(f"x and a must have the same sequence length; got {x.shape[-1]} and {a.shape[-1]}")
        x, a, noise = to_channel_last(x), to_channel_last(a), to_channel_last(noise)
        x_noisy = ddim.add_noise(x, noise, t, self.acp.to(x.device))
        with self.compute_context(params):
            pred = params(x_noisy, a, t, c, cond_mask)
        return masked_mse(pred, noise, orig_len)

    @torch.inference_mode()
    def sample(
        self,
        params: nn.Module,
        a: torch.Tensor,  # (B, 96, N)
        c: torch.Tensor,  # (B, 5)
        x: Optional[torch.Tensor] = None,  # (B, 6, N) initial noise
        generator: Optional[torch.Generator] = None,
        cond_scale: float = 7.0,
        sampling_timesteps: Optional[int] = None,
        method: str = "ddim",
    ) -> torch.Tensor:
        """Returns (B, 6, N) float32. Initial noise is ``x`` or, without it,
        drawn from ``generator`` on a's device. ``method="ddim"`` is the
        reference sampler; ``"dpmpp-2m"`` solves the same ODE with
        DPM-Solver++(2M) (``models/dpm.py``): same checkpoint, about half the
        steps for the same trajectory accuracy."""
        if method not in ("ddim", "dpmpp-2m"):
            raise ValueError(f"unknown sampling method: {method!r}")
        B, _, N = a.shape
        if x is None:
            if generator is None:
                raise ValueError("provide either initial noise x or a generator")
            x = torch.randn((B, self.model_cfg.dim_in_x, N), generator=generator, device=a.device)
        x = to_channel_last(x).float()

        steps = sampling_timesteps or self.cfg.sampling_timesteps
        a_enc = self.encode_audio(params, a)
        if method == "dpmpp-2m":
            return self._sample_dpm(params, x, a_enc, c, cond_scale, steps)
        ts = ddim.ddim_timesteps(self.cfg.train_timesteps, steps)
        ts_prev = [*ts[1:].tolist(), -1]
        acp = self.acp.to(x.device)
        for t, t_prev in zip(ts.tolist(), ts_prev):
            t_b = torch.full((B,), float(t), device=x.device)
            eps = self._cfg_eps(params, x, a_enc, t_b, c, cond_scale).float()
            x = ddim.ddim_step(x, eps, t, t_prev, acp, self.cfg.clip_sample)
        return to_channel_first(x)

    def _sample_dpm(self, params, x, a_enc, c, cond_scale: float, steps: int) -> torch.Tensor:
        """DPM-Solver++(2M) on the log-SNR grid of ``steps`` points (fewer
        where timesteps collapse): one CFG-doubled denoiser call a step. The
        coefficients are host floats, so no step waits for the device."""
        acp = self.acp.numpy().astype(np.float64)
        coeffs = dpmpp_2m_coeffs(dpmpp_timesteps(steps, acp), acp)
        B = x.shape[0]
        m1 = torch.zeros_like(x)
        for row in coeffs.tolist():
            t_b = torch.full((B,), row[0], device=x.device)
            eps = self._cfg_eps(params, x, a_enc, t_b, c, cond_scale).float()
            x, m1 = dpmpp_2m_step(x, eps, m1, row, self.cfg.clip_sample)
        return to_channel_first(x)
