"""Vectorized Bézier curve math (evaluate / derivative / arc length).

The reference leans on the compiled third-party ``bezier`` package
(reference: osu_fusion/library/osu/sliders.py:3, data/fit_bezier.py:5) for
curve evaluation and arc-length computation. This module provides the same
capabilities as pure vectorized numpy: Bernstein-basis evaluation (stable for
the degrees osu! uses) and Gauss–Legendre quadrature arc length. The JAX
package can slot a C++ implementation with the same signatures in for the
decode-side hot path; this package has the numpy one only.

Curves are represented as ``(n_nodes, dim)`` float arrays of control points.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np

# 16-point Gauss–Legendre is exact for polynomial integrands up to degree 31;
# |B'(t)| is not polynomial but is extremely smooth for game sliders, and this
# order matches or exceeds typical adaptive tolerances at fixed cost.
_GL_ORDER = 16
_GL_NODES, _GL_WEIGHTS = np.polynomial.legendre.leggauss(_GL_ORDER)


@lru_cache(maxsize=64)
def _binomial_row(n: int) -> np.ndarray:
    row = np.ones(n + 1)
    for k in range(1, n + 1):
        row[k] = row[k - 1] * (n - k + 1) / k
    return row


def evaluate(nodes: np.ndarray, t: np.ndarray | float) -> np.ndarray:
    """Evaluate a Bézier curve at parameter(s) t.

    nodes: (n+1, dim) control points. t: scalar or (m,) array in [0, 1].
    Returns (dim,) for scalar t, else (m, dim).
    """
    nodes = np.asarray(nodes, dtype=float)
    scalar = np.isscalar(t) or np.ndim(t) == 0
    t_arr = np.atleast_1d(np.asarray(t, dtype=float))
    n = nodes.shape[0] - 1
    if n == 0:
        out = np.broadcast_to(nodes[0], (t_arr.shape[0], nodes.shape[1])).copy()
        return out[0] if scalar else out

    # Bernstein basis matrix (m, n+1)
    k = np.arange(n + 1)
    coeff = _binomial_row(n)
    tt = t_arr[:, None]
    # 0^0 := 1 convention holds with np.power on these grids
    basis = coeff * np.power(tt, k) * np.power(1.0 - tt, n - k)
    out = basis @ nodes
    return out[0] if scalar else out


def hodograph_nodes(nodes: np.ndarray) -> np.ndarray:
    """Control points of the derivative curve: n * (P[i+1] - P[i])."""
    nodes = np.asarray(nodes, dtype=float)
    n = nodes.shape[0] - 1
    if n == 0:
        return np.zeros((1, nodes.shape[1]))
    return n * (nodes[1:] - nodes[:-1])


def evaluate_hodograph(nodes: np.ndarray, t: np.ndarray | float) -> np.ndarray:
    """Evaluate the first derivative B'(t)."""
    return evaluate(hodograph_nodes(nodes), t)


def curve_length(nodes: np.ndarray) -> float:
    """Arc length of the full curve via Gauss–Legendre quadrature of |B'(t)|."""
    nodes = np.asarray(nodes, dtype=float)
    if nodes.shape[0] < 2:
        return 0.0
    if nodes.shape[0] == 2:
        return float(np.linalg.norm(nodes[1] - nodes[0]))
    # map GL nodes from [-1, 1] to [0, 1]
    ts = 0.5 * (_GL_NODES + 1.0)
    d = evaluate_hodograph(nodes, ts)
    speed = np.linalg.norm(d, axis=-1)
    return float(0.5 * np.dot(_GL_WEIGHTS, speed))


def arc_length_parameterize(nodes: np.ndarray, num: int = 64) -> tuple[np.ndarray, np.ndarray]:
    """Sample cumulative arc length at ``num`` evenly spaced parameters.

    Returns (params, cumulative_lengths) suitable for inverting
    (length -> parameter) with np.interp.
    """
    ts = np.linspace(0.0, 1.0, num)
    pts = evaluate(nodes, ts)
    seg = np.linalg.norm(np.diff(pts, axis=0), axis=-1)
    cum = np.concatenate([[0.0], np.cumsum(seg)])
    return ts, cum
