"""DPM-Solver++(2M) scheduler math (``osufusion_tpu/models/dpm.py``), a
faster drop-in for the DDIM sampler.

DPM-Solver++(2M) (Lu et al. 2022, arXiv:2211.01095) integrates the same
probability-flow ODE as DDIM (same trained model, same epsilon
parameterization, no retraining) with a second-order linear multistep rule in
log-SNR time, so it needs roughly half the denoiser calls for the same
trajectory accuracy. Full-song generation costs almost exactly (steps x one
CFG-doubled forward), so fewer steps are less latency.

Every per-step scalar (the exponential-integrator coefficients below)
depends only on the timestep grid and the training beta schedule, so it is
computed on the host in float64, once per sampling call; the sampler
(``models/diffusion.py``) reads each step's row as host floats and evaluates
the denoiser exactly once per step.

Update rule (data-prediction form). With alpha_t = sqrt(acp[t]),
sigma_t = sqrt(1 - acp[t]), lambda_t = log(alpha_t / sigma_t), a step from
t_cur -> t_tgt with model predictions m0 = x0(x_cur, t_cur) and m1 = the
previous step's x0:

    h    = lambda_tgt - lambda_cur
    r    = h_prev / h                     (h_prev: the previous step's h)
    D    = (1 + 1/(2r)) m0 - 1/(2r) m1    (2nd-order extrapolated x0)
    x    = (sigma_tgt / sigma_cur) x_cur - alpha_tgt (e^{-h} - 1) D

The first step has no m1 (1/(2r) := 0, which reduces exactly to a DDIM
step), and the final step to t = -1 (alpha = 1, sigma = 0) is taken at first
order for stability, diffusers' ``lower_order_final`` behavior.
"""

from __future__ import annotations

import numpy as np
import torch


def dpmpp_timesteps(sampling_timesteps: int, acp: np.ndarray) -> np.ndarray:
    """Descending timestep grid uniform in log-SNR (lambda), the spacing the
    DPM-Solver++ paper's schedules use. On the linear-beta schedule,
    uniform-t grids make the final lambda hops huge (lambda(66)->lambda(0) is
    ~2.1 of a ~9.7 total span), which both starves the near-clean region of
    steps and ill-conditions the multistep extrapolation (h >> h_prev).

    Timesteps stay integers (nearest lambda), so the denoiser sees the same
    discrete grid it was trained on; duplicates collapse (only at step counts
    approaching the trained resolution), so the grid may be shorter than
    ``sampling_timesteps``."""
    acp = np.asarray(acp, np.float64)
    lam = 0.5 * (np.log(acp) - np.log1p(-acp))
    targets = np.linspace(lam[-1], lam[0], sampling_timesteps)
    ts = np.abs(lam[None, :] - targets[:, None]).argmin(axis=1)
    return np.unique(ts)[::-1].astype(np.int64).copy()


def dpmpp_2m_coeffs(ts: np.ndarray, acp: np.ndarray) -> np.ndarray:
    """Per-step coefficients of DPM-Solver++(2M).

    ts: descending timestep grid (``dpmpp_timesteps``); the last step
    targets t = -1 (the clean sample). acp: training alphas_cumprod.
    Returns a float32 array of shape (len(ts), 6) with columns
    ``[t, alpha_cur, sigma_cur, c_x, c_d, w1]`` where the update is
    ``x <- c_x * x + c_d * ((1 + w1) m0 - w1 m1)``.
    """
    acp = np.asarray(acp, np.float64)
    ts = np.asarray(ts, np.int64)
    tgt = np.concatenate([ts[1:], [-1]])

    def stats(t: np.ndarray):
        a = np.where(t >= 0, acp[np.maximum(t, 0)], 1.0)
        alpha, sigma = np.sqrt(a), np.sqrt(1.0 - a)
        with np.errstate(divide="ignore"):
            lam = np.log(alpha) - np.log(sigma)  # +inf at the clean endpoint
        return alpha, sigma, lam

    a_cur, s_cur, l_cur = stats(ts)
    a_tgt, s_tgt, l_tgt = stats(tgt)

    h = l_tgt - l_cur  # > 0 (denoising raises log-SNR); +inf on the last step
    c_x = s_tgt / s_cur  # 0 on the last step
    c_d = -a_tgt * np.expm1(-h)  # -> alpha_tgt * 1 on the last step

    h_prev = np.concatenate([[np.nan], h[:-1]])
    with np.errstate(invalid="ignore"):
        w1 = 0.5 * h / h_prev
    w1[0] = 0.0  # no m1 yet: first-order (== DDIM)
    w1[-1] = 0.0  # lower_order_final: first-order into the clean sample

    out = np.stack([ts.astype(np.float64), a_cur, s_cur, c_x, c_d, w1], axis=1)
    if not np.isfinite(out).all():
        raise ValueError("non-finite DPM++ coefficients")
    return out.astype(np.float32)


def dpmpp_2m_step(
    x: torch.Tensor,
    eps: torch.Tensor,
    m1: torch.Tensor,  # the previous step's x0 prediction (zeros at the first step, where w1 = 0)
    row,  # one row of ``dpmpp_2m_coeffs``: (t, alpha_cur, sigma_cur, c_x, c_d, w1), host floats
    clip_sample: bool = True,
) -> tuple[torch.Tensor, torch.Tensor]:
    """One DPM-Solver++(2M) update from the denoiser's ``eps`` at this step's
    timestep. Returns (x at the next timestep, m0, this step's x0 prediction,
    clipped to [-1, 1] with ``clip_sample``), m0 being the next step's m1."""
    _, alpha, sigma, c_x, c_d, w1 = row
    m0 = (x - sigma * eps) / alpha
    if clip_sample:
        m0 = m0.clamp(-1.0, 1.0)
    return c_x * x + c_d * ((1.0 + w1) * m0 - w1 * m1), m0
