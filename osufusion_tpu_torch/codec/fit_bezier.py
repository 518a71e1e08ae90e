"""Least-squares cubic Bézier fitting of a point sequence.

Same algorithm family as the reference (Graphics Gems "fitCurves",
reference osu_fusion/library/osu/data/fit_bezier.py): chord-length
parameterization, closed-form alpha solve via 2x2 determinants,
Newton–Raphson reparameterization, recursive split at the max-error point
after 32 iterations, and a line-simplification check. Implemented on our own
``bezier_math`` (no compiled third-party curve library).
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np

from osufusion_tpu_torch.osu import bezier_math


def _q(p: np.ndarray, t: np.ndarray) -> np.ndarray:
    return bezier_math.evaluate(p, t)


def _qprime(p: np.ndarray, t: np.ndarray) -> np.ndarray:
    return bezier_math.evaluate(bezier_math.hodograph_nodes(p), t)


def _qprimeprime(p: np.ndarray, t: np.ndarray) -> np.ndarray:
    return bezier_math.evaluate(bezier_math.hodograph_nodes(bezier_math.hodograph_nodes(p)), t)


def normalize(v: np.ndarray) -> np.ndarray:
    magnitude = np.sqrt(np.dot(v, v))
    if magnitude < np.finfo(float).eps:
        return v
    return v / magnitude


def compute_error(p: np.ndarray, points: np.ndarray, u: np.ndarray) -> tuple[float, int]:
    errs = ((_q(p, u) - points) ** 2).sum(-1)
    split_point = int(errs.argmax())
    return float(errs[split_point]), split_point


def get_segment_length(p: np.ndarray) -> float:
    return bezier_math.curve_length(np.asarray(p, dtype=float))


def fit_bezier(
    points: np.ndarray,
    max_err: float,
    left_tangent: Optional[np.ndarray] = None,
    right_tangent: Optional[np.ndarray] = None,
) -> List[np.ndarray]:
    """Fit one or more cubic Bézier segments to ``points`` (N, 2).

    Returns a list of control-point arrays; 2-point arrays denote straight
    line segments.
    """
    points = np.asarray(points, dtype=float)
    if len(points) < 2:
        return []

    # Tangents from an exponentially weighted blend of nearby chords, which is
    # robust to single-pixel noise at the endpoints.
    n_w = min(5, len(points) - 2)
    if n_w > 0:
        weights = (2.0 ** -np.arange(1, n_w + 1)) / (1 - 2.0**-n_w)

    if left_tangent is None:
        l_vecs = points[2 : 2 + n_w] - points[1]
        left_tangent = normalize(np.einsum("np,n->p", l_vecs, weights)) if n_w > 0 else normalize(points[-1] - points[0])
    if right_tangent is None:
        r_vecs = points[-3 : -3 - n_w : -1] - points[-2]
        right_tangent = normalize(np.einsum("np,n->p", r_vecs, weights)) if n_w > 0 else normalize(points[0] - points[-1])

    if points.shape[0] == 2:
        return [points]

    # chord-length parameterization; a fully stationary trace (every point
    # identical — cursor pinned during a slide span) has zero total chord
    # length and no curve to fit
    u = np.cumsum(np.linalg.norm(points[1:] - points[:-1], axis=1))
    if u[-1] == 0.0:
        return [points[[0, -1]]]
    u = np.pad(u, (1, 0)) / u[-1]

    split_point = len(points) // 2
    for _ in range(32):
        bez_curve = generate_bezier(points, u, left_tangent, right_tangent)
        err, split_point = compute_error(bez_curve, points, u)

        if err < max_err:
            # prefer a straight line when it is already within tolerance
            line_err, _ = compute_error(bez_curve[[0, -1]], points, u)
            if line_err < max_err:
                return [bez_curve[[0, -1]]]
            return [bez_curve]

        u = newton_raphson_root_find(bez_curve, points, u)

    # fitting failed: split at the max-error point and recurse
    split_point = min(max(split_point, 1), len(points) - 2)
    center_tangent = normalize(points[split_point - 1] - points[split_point + 1])
    return [
        *fit_bezier(points[: split_point + 1], max_err, left_tangent, center_tangent),
        *fit_bezier(points[split_point:], max_err, -center_tangent, right_tangent),
    ]


def generate_bezier(
    points: np.ndarray,
    u: np.ndarray,
    left_tangent: np.ndarray,
    right_tangent: np.ndarray,
) -> np.ndarray:
    bez_curve = np.array([points[0], points[0], points[-1], points[-1]], dtype=float)

    # A[i] = Bernstein weights of the two inner control points along the tangents
    _a = (3 * (1 - u) * u * np.array([1 - u, u])).T[..., None] * np.array([left_tangent, right_tangent])

    _c = np.einsum("lix,ljx->ij", _a, _a)
    _x = np.einsum("lix,lx->i", _a, points - _q(bez_curve, u))

    det_c0_c1 = _c[0][0] * _c[1][1] - _c[1][0] * _c[0][1]
    det_c0_x = _c[0][0] * _x[1] - _c[1][0] * _x[0]
    det_x_c1 = _x[0] * _c[1][1] - _x[1] * _c[0][1]

    alpha_l = 0.0 if abs(det_c0_c1) < 1e-5 else det_x_c1 / det_c0_c1
    alpha_r = 0.0 if abs(det_c0_c1) < 1e-5 else det_c0_x / det_c0_c1

    # Wu/Barsky heuristic when the closed-form alphas collapse (coincident
    # control points would divide by zero in Newton-Raphson)
    seg_len = np.linalg.norm(points[0] - points[-1])
    epsilon = 1e-6 * seg_len
    if alpha_l < epsilon or alpha_r < epsilon:
        bez_curve[1] += left_tangent * (seg_len / 3.0)
        bez_curve[2] += right_tangent * (seg_len / 3.0)
    else:
        bez_curve[1] += left_tangent * alpha_l
        bez_curve[2] += right_tangent * alpha_r

    return bez_curve


def newton_raphson_root_find(bez: np.ndarray, points: np.ndarray, u: np.ndarray) -> np.ndarray:
    """One Newton step of parameter refinement: minimize distance point-curve
    by solving (q(u)-p) . q'(u) = 0."""
    d = _q(bez, u) - points
    qp = _qprime(bez, u)
    num = (d * qp).sum(-1)
    den = (qp**2 + d * _qprimeprime(bez, u)).sum(-1)
    return u - np.divide(num, den, out=np.zeros_like(num), where=den != 0)
