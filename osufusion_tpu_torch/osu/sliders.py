"""Slider geometry: Line / Perfect-arc / Bézier paths and the factory that
classifies a control-point list into one of them.

Capability parity with reference osu_fusion/library/osu/sliders.py (Line :14,
Perfect :41, Bezier :78, from_control_points :150) including the degenerate
cases: duplicated control point = segment break, tail extension to the declared
pixel length, collinear 3-point sliders, and the radius>320 arc fallback.
Implemented on our own numpy Bézier math instead of the compiled ``bezier``
package.
"""

from __future__ import annotations

from typing import List

import numpy as np

from osufusion_tpu_torch.osu import bezier_math
from osufusion_tpu_torch.osu.hit_objects import Slider


def round_and_cast(value: np.ndarray) -> np.ndarray:
    return np.asarray(value).round(0).astype(int)


class Line(Slider):
    __slots__ = ("start", "end")

    def __init__(
        self,
        t: float,
        beat_length: float,
        slider_multiplier: float,
        new_combo: bool,
        slides: int,
        length: float,
        start: np.ndarray,
        end: np.ndarray,
    ) -> None:
        super().__init__(t, beat_length, slider_multiplier, new_combo, slides, length)
        self.start = np.asarray(start, dtype=float)
        vec = np.asarray(end, dtype=float) - self.start
        # extend/trim to the declared pixel length; a degenerate line (zero
        # declared length or coincident anchors, both occur in real corpora)
        # collapses to its head rather than propagating 0/0 NaNs
        norm = float(np.linalg.norm(vec))
        self.end = self.start + vec / norm * length if norm > 0.0 else self.start.copy()

    def lerp(self, t: float) -> np.ndarray:
        return round_and_cast((1 - t) * self.start + t * self.end)

    def lerp_many(self, ts: np.ndarray) -> np.ndarray:
        ts = np.asarray(ts, dtype=float)[:, None]
        return round_and_cast((1 - ts) * self.start + ts * self.end)

    def velocity(self, t: float) -> np.ndarray:
        return round_and_cast((self.end - self.start) / self.slide_duration)


class Perfect(Slider):
    """Circular-arc slider through three points."""

    __slots__ = ("center", "radius", "start", "end")

    def __init__(
        self,
        t: float,
        beat_length: float,
        slider_multiplier: float,
        new_combo: bool,
        slides: int,
        length: float,
        center: np.ndarray,
        radius: float,
        start: float,
        end: float,
    ) -> None:
        super().__init__(t, beat_length, slider_multiplier, new_combo, slides, length)
        self.center = np.asarray(center, dtype=float)
        self.radius = radius
        self.start = start
        # sweep exactly the declared arc length, in the direction of the solve
        self.end = start + length / radius * np.sign(end - start)

    def _theta(self, t: float) -> float:
        return (1 - t) * self.start + t * self.end

    def lerp(self, t: float) -> np.ndarray:
        theta = self._theta(t)
        return round_and_cast(self.center + self.radius * np.array([np.cos(theta), np.sin(theta)]))

    def lerp_many(self, ts: np.ndarray) -> np.ndarray:
        theta = (1 - np.asarray(ts, dtype=float)) * self.start + np.asarray(ts, dtype=float) * self.end
        return round_and_cast(self.center + self.radius * np.stack([np.cos(theta), np.sin(theta)], axis=-1))

    def velocity(self, t: float) -> np.ndarray:
        theta = self._theta(t)
        return round_and_cast(self.radius * np.array([-np.sin(theta), np.cos(theta)]) / self.slide_duration)


class Bezier(Slider):
    """Multi-segment Bézier slider with arc-length reparameterization.

    A duplicated control point starts a new segment (osu! convention); if the
    declared pixel length exceeds the geometric path length the path is
    extended linearly along the final tangent.
    """

    __slots__ = ("control_points", "path_segments", "cum_t")

    def __init__(
        self,
        t: float,
        beat_length: float,
        slider_multiplier: float,
        new_combo: bool,
        slides: int,
        length: float,
        control_points: List[np.ndarray],
    ) -> None:
        super().__init__(t, beat_length, slider_multiplier, new_combo, slides, length)
        self.control_points = [np.asarray(p, dtype=float) for p in control_points]

        # split into segments at duplicated control points
        segments: List[List[np.ndarray]] = []
        current: List[np.ndarray] = []
        prev = None
        for p in self.control_points:
            if prev is not None and np.array_equal(prev, p):
                segments.append(current)
                current = []
            current.append(p)
            prev = p
        segments.append(current)

        curves: List[np.ndarray] = []
        total_length = 0.0
        for seg in segments:
            if len(seg) < 2:
                continue
            nodes = np.asarray(seg, dtype=float)
            total_length += bezier_math.curve_length(nodes)
            curves.append(nodes)

        tail_length = self.length - total_length
        if tail_length > 0 and curves:
            last = curves[-1]
            point = last[-1]
            vec = point - last[-2]
            norm = np.linalg.norm(vec)
            if norm > 0:
                tail = np.stack([point, point + vec / norm * tail_length])
                curves.append(tail)

        if not curves:
            # every control point coincident: a zero-extent path pinned at
            # the head (real corpora contain such sliders; NaNs here would
            # silently corrupt every downstream cursor signal)
            p0 = self.control_points[0]
            curves = [np.stack([p0, p0])]
        self.path_segments = curves
        seg_lengths = np.array([bezier_math.curve_length(c) for c in curves])
        # fraction of the declared length each segment ends at; a degenerate
        # zero declared length normalizes by the geometric length instead
        denom = self.length if self.length > 0 else max(float(seg_lengths.sum()), 1.0)
        self.cum_t = np.cumsum(seg_lengths) / denom
        self.cum_t[-1] = 1.0

    def _reparametrize(self, t: float) -> tuple[int, float]:
        t = min(1.0, max(0.0, t))
        idx = int(np.searchsorted(self.cum_t, t))
        idx = min(idx, len(self.cum_t) - 1)
        range_start = 0.0 if idx == 0 else self.cum_t[idx - 1]
        range_end = self.cum_t[idx]
        denom = range_end - range_start
        local = 0.0 if denom <= 0 else (t - range_start) / denom
        return idx, local

    def lerp(self, t: float) -> np.ndarray:
        idx, local = self._reparametrize(t)
        return round_and_cast(bezier_math.evaluate(self.path_segments[idx], local))

    def lerp_many(self, ts: np.ndarray) -> np.ndarray:
        ts = np.clip(np.asarray(ts, dtype=float), 0.0, 1.0)
        idxs = np.minimum(np.searchsorted(self.cum_t, ts), len(self.cum_t) - 1)
        starts = np.where(idxs == 0, 0.0, np.concatenate([[0.0], self.cum_t])[idxs])
        ends = self.cum_t[idxs]
        denom = ends - starts
        locals_ = np.where(denom > 0, (ts - starts) / np.where(denom > 0, denom, 1.0), 0.0)
        out = np.empty((ts.shape[0], 2))
        for seg_idx in np.unique(idxs):
            mask = idxs == seg_idx
            out[mask] = bezier_math.evaluate(self.path_segments[seg_idx], locals_[mask])
        return round_and_cast(out)

    def velocity(self, t: float) -> np.ndarray:
        idx, local = self._reparametrize(t)
        return round_and_cast(bezier_math.evaluate_hodograph(self.path_segments[idx], local) / self.slide_duration)


def from_control_points(
    t: float,
    beat_length: float,
    slider_multiplier: float,
    new_combo: bool,
    slides: int,
    length: float,
    control_points: List[np.ndarray],
) -> Slider:
    """Classify a control-point list into Line / Perfect / Bézier.

    Mirrors osu!'s slider-type rules: 2 points = line; 3 points = perfect arc
    unless collinear (line or folded Bézier) or the circumradius exceeds 320 px
    while curving forward (Bézier fallback); otherwise Bézier.
    """
    if len(control_points) < 2:
        raise ValueError(f"not enough control points: {len(control_points)}")

    control_points = [np.asarray(p, dtype=float) for p in control_points]

    if len(control_points) == 2:
        p1, p2 = control_points
        return Line(t, beat_length, slider_multiplier, new_combo, slides, length, p1, p2)

    if len(control_points) == 3:
        p1, p2, p3 = control_points

        if np.array_equal(p2, p3):
            return Line(t, beat_length, slider_multiplier, new_combo, slides, length, p1, p3)

        d1, d2 = p2 - p1, p3 - p1
        cross = float(d1[0] * d2[1] - d1[1] * d2[0])
        if cross == 0:  # collinear
            if np.dot(p2 - p1, p3 - p1) > 0:
                return Line(t, beat_length, slider_multiplier, new_combo, slides, length, p1, p3)
            # folded back on itself: duplicate the middle point to force a
            # segment break, producing an out-and-back path
            pts = [p1, p2, p2, p3]
            return Bezier(t, beat_length, slider_multiplier, new_combo, slides, length, pts)

        a = np.linalg.norm(p3 - p2)
        b = np.linalg.norm(p3 - p1)
        c = np.linalg.norm(p2 - p1)
        s = (a + b + c) / 2
        radius = a * b * c / 4 / np.sqrt(s * (s - a) * (s - b) * (s - c))

        if radius > 320 and np.dot(p3 - p2, p2 - p1) > 0:
            return Bezier(t, beat_length, slider_multiplier, new_combo, slides, length, control_points)

        # circumcenter in barycentric coordinates
        b1 = a * a * (b * b + c * c - a * a)
        b2 = b * b * (a * a + c * c - b * b)
        b3 = c * c * (a * a + b * b - c * c)
        center = np.column_stack((p1, p2, p3)) @ np.array([b1, b2, b3])
        center /= b1 + b2 + b3

        start_angle = float(np.arctan2(*(p1 - center)[[1, 0]]))
        end_angle = float(np.arctan2(*(p3 - center)[[1, 0]]))

        if cross < 0:  # clockwise
            while end_angle > start_angle:
                end_angle -= 2 * np.pi
        else:  # counter-clockwise
            while start_angle > end_angle:
                start_angle -= 2 * np.pi

        return Perfect(
            t, beat_length, slider_multiplier, new_combo, slides, length, center, radius, start_angle, end_angle
        )

    return Bezier(t, beat_length, slider_multiplier, new_combo, slides, length, control_points)
