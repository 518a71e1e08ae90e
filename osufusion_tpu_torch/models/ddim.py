"""DDIM scheduler math (``osufusion_tpu/models/ddim.py``): linear betas over
1000 train steps, epsilon prediction, leading timestep spacing, x0 clipping:

  x0_hat = (x_t - sqrt(1 - a_t) * eps) / sqrt(a_t)          (clipped to [-1,1])
  x_{t_prev} = sqrt(a_prev) * x0_hat + sqrt(1 - a_prev) * eps

with a_prev = alpha_cumprod[t_prev] and alpha_cumprod[-1] := 1 (eta = 0).
"""

from __future__ import annotations

import numpy as np
import torch


def alphas_cumprod(train_timesteps: int, beta_start: float = 0.0001, beta_end: float = 0.02) -> torch.Tensor:
    """float64 cumulative product, returned as float32 (CPU)."""
    betas = np.linspace(beta_start, beta_end, train_timesteps, dtype=np.float64)
    return torch.from_numpy(np.cumprod(1.0 - betas).astype(np.float32))


def ddim_timesteps(train_timesteps: int, sampling_timesteps: int) -> np.ndarray:
    """Leading spacing: [.., 2r, r, 0] descending."""
    step_ratio = train_timesteps // sampling_timesteps
    ts = (np.arange(sampling_timesteps) * step_ratio).round().astype(np.int64)
    return ts[::-1].copy()


def add_noise(x: torch.Tensor, noise: torch.Tensor, t: torch.Tensor, acp: torch.Tensor) -> torch.Tensor:
    """q(x_t | x_0): sqrt(a_t) x + sqrt(1 - a_t) noise. t: (B,) integer;
    ``acp`` lives on x's device."""
    a_t = acp[t].reshape(-1, *([1] * (x.ndim - 1)))
    return torch.sqrt(a_t) * x + torch.sqrt(1.0 - a_t) * noise


def ddim_step(
    x: torch.Tensor,
    eps: torch.Tensor,
    t: int,
    t_prev: int,
    acp: torch.Tensor,
    clip_sample: bool = True,
) -> torch.Tensor:
    """One deterministic DDIM update from timestep t to t_prev (t_prev < 0
    means the final step, alpha_prev = 1). ``acp`` lives on x's device. x and
    eps are promoted to acp's dtype first, as jnp promotes them (acp[t] is an
    array there, not a weak scalar), so a bf16 eps is not rounded again."""
    dtype = torch.promote_types(torch.promote_types(x.dtype, eps.dtype), acp.dtype)
    x, eps = x.to(dtype), eps.to(dtype)
    a_t = acp[t]
    a_prev = acp[t_prev] if t_prev >= 0 else torch.ones_like(a_t)
    x0 = (x - torch.sqrt(1.0 - a_t) * eps) / torch.sqrt(a_t)
    if clip_sample:
        x0 = x0.clamp(-1.0, 1.0)
    return torch.sqrt(a_prev) * x0 + torch.sqrt(1.0 - a_prev) * eps
