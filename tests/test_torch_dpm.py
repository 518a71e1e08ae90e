"""DPM-Solver++(2M) in the port against the JAX package.

- The schedule (``models/dpm.py``) is a copy of the JAX package's numpy and
  must equal it bit for bit.
- The port's 2M update, driven by the analytic epsilon of Gaussian data (the
  oracle of ``tests/test_samplers.py``, copied here in numpy), must beat DDIM
  at 16 steps as the JAX package's does.
- The CLI offers ``dpmpp-2m``.
"""

import numpy as np
import pytest
import torch

from osufusion_tpu.models import ddim as jddim
from osufusion_tpu.models import dpm as jdpm
from osufusion_tpu_torch.inference import build_parser
from osufusion_tpu_torch.models import ddim, dpm


@pytest.mark.parametrize("steps", [1, 2, 16, 50, 999])
def test_dpmpp_schedule_matches_jax(steps):
    """Bit for bit: both sides run the same float64 numpy on the same float32
    alphas_cumprod. At 999 steps nearest-lambda timesteps collide and the
    grid collapses to fewer points."""
    acp = np.asarray(ddim.alphas_cumprod(1000).numpy(), np.float64)
    assert np.array_equal(acp, np.asarray(jddim.alphas_cumprod(1000), np.float64))
    ts, want_ts = dpm.dpmpp_timesteps(steps, acp), jdpm.dpmpp_timesteps(steps, acp)
    np.testing.assert_array_equal(ts, want_ts)
    assert ts.dtype == want_ts.dtype and (steps < 999 or len(ts) < steps)
    got, want = dpm.dpmpp_2m_coeffs(ts, acp), jdpm.dpmpp_2m_coeffs(want_ts, acp)
    assert got.dtype == want.dtype == np.float32 and got.shape == (len(ts), 6)
    np.testing.assert_array_equal(got, want)


# the Gaussian oracle of tests/test_samplers.py: for x0 ~ N(MU, S^2 I) the
# optimal epsilon prediction is the posterior mean's, in closed form
ACP = np.asarray(ddim.alphas_cumprod(1000).numpy(), np.float64)
MU = np.linspace(-0.5, 0.5, 8).reshape(2, 4)
S = 0.4


def oracle_eps(x: np.ndarray, t: int) -> np.ndarray:
    a = ACP[t]
    alpha, sigma = np.sqrt(a), np.sqrt(1.0 - a)
    x0 = (alpha * S**2 * x + sigma**2 * MU) / (alpha**2 * S**2 + sigma**2)
    return (x - alpha * x0) / sigma


def grid(n: int) -> np.ndarray:
    """Descending timestep grid from t=999, so every step count solves the
    same initial-value problem."""
    return np.round(np.linspace(999, 0, n)).astype(np.int64)


def run_ddim(x: np.ndarray, ts: np.ndarray) -> np.ndarray:
    acp = torch.from_numpy(ACP)
    for t, t_prev in zip(ts.tolist(), [*ts[1:].tolist(), -1]):
        eps = torch.from_numpy(oracle_eps(x, t))
        x = ddim.ddim_step(torch.from_numpy(x), eps, t, t_prev, acp, clip_sample=False).numpy()
    return x


def run_dpm(x: np.ndarray, ts: np.ndarray) -> np.ndarray:
    """The port's update (``dpm.dpmpp_2m_step``), rows as host floats as the
    sampler reads them."""
    xt, m1 = torch.from_numpy(x), torch.zeros(x.shape, dtype=torch.float64)
    for row in dpm.dpmpp_2m_coeffs(ts, ACP).tolist():
        eps = torch.from_numpy(oracle_eps(xt.numpy(), int(row[0])))
        xt, m1 = dpm.dpmpp_2m_step(xt, eps, m1, row, clip_sample=False)
    return xt.numpy()


def test_port_dpmpp_2m_beats_ddim_on_the_oracle_ode():
    """As ``test_samplers.py::test_dpmpp_2m_beats_ddim_on_the_oracle_ode``
    asserts for the JAX package: DPM-16 within a fifth of DDIM-16's error
    from a 500-step DDIM reference (the JAX package measured ~1.3e-2 against
    ~1.0e-1), and better than DDIM-64."""
    x_start = np.random.default_rng(0).normal(0, 1, MU.shape)
    ref = run_ddim(x_start.copy(), grid(500))

    def err(x):
        return float(np.abs(x - ref).max())

    e_ddim16 = err(run_ddim(x_start.copy(), grid(16)))
    e_ddim64 = err(run_ddim(x_start.copy(), grid(64)))
    e_dpm16 = err(run_dpm(x_start.copy(), dpm.dpmpp_timesteps(16, ACP)))
    assert e_dpm16 < 0.2 * e_ddim16, f"dpm16={e_dpm16:.2e} vs ddim16={e_ddim16:.2e}"
    assert e_dpm16 < e_ddim64, f"dpm16={e_dpm16:.2e} vs ddim64={e_ddim64:.2e}"


def test_inference_cli_offers_dpmpp_2m():
    base = ["--model-path", "model.safetensors", "--audio", "song.wav", "--steps", "16"]
    assert build_parser().parse_args([*base, "--sampler", "dpmpp-2m"]).sampler == "dpmpp-2m"
    assert build_parser().parse_args(base).sampler is None
    with pytest.raises(SystemExit):
        build_parser().parse_args([*base, "--sampler", "midpoint"])
