"""osu! hit-object types.

Capability parity with the reference domain model
(reference: osu_fusion/library/osu/hit_objects.py) — same public surface
(``Timed``, ``TimingPoint``, ``Circle``, ``Spinner``, ``Slider`` with
``end_time/start_pos/end_pos`` and ``slide_duration``), implemented
independently.
"""

from __future__ import annotations

import numpy as np

PLAYFIELD_CENTER = np.array([256.0, 192.0])


class Timed:
    """Anything with a start time; orderable so bisect works on lists of these."""

    __slots__ = ("t",)

    def __init__(self, t: float) -> None:
        self.t = t

    def __lt__(self, other: "Timed") -> bool:
        return self.t < other.t


class TimingPoint(Timed):
    """A (possibly inherited) timing point.

    ``beat_length`` is the uninherited beat length in ms; ``slider_multiplier``
    carries the inherited SV (1.0 on uninherited points).
    """

    __slots__ = ("beat_length", "slider_multiplier", "meter", "kiai")

    def __init__(
        self,
        t: float,
        beat_length: float,
        slider_multiplier: float,
        meter: int,
        kiai: bool,
    ) -> None:
        super().__init__(t)
        self.beat_length = beat_length
        self.slider_multiplier = slider_multiplier
        self.meter = meter
        self.kiai = kiai

    def __eq__(self, other: object) -> bool:
        if not isinstance(other, TimingPoint):
            return NotImplemented
        return (
            self.t == other.t
            and self.beat_length == other.beat_length
            and self.slider_multiplier == other.slider_multiplier
            and self.meter == other.meter
            and self.kiai == other.kiai
        )

    def __hash__(self) -> int:
        return hash((self.t, self.beat_length, self.slider_multiplier, self.meter, self.kiai))


class HitObject(Timed):
    __slots__ = ("new_combo",)

    def __init__(self, t: float, new_combo: bool) -> None:
        super().__init__(t)
        self.new_combo = new_combo

    def end_time(self) -> float:
        raise NotImplementedError

    def start_pos(self) -> np.ndarray:
        raise NotImplementedError

    def end_pos(self) -> np.ndarray:
        return self.start_pos()


class Circle(HitObject):
    __slots__ = ("x", "y")

    def __init__(self, t: float, new_combo: bool, x: int, y: int) -> None:
        super().__init__(t, new_combo)
        self.x = x
        self.y = y

    def end_time(self) -> float:
        return self.t

    def start_pos(self) -> np.ndarray:
        return np.array([self.x, self.y], dtype=float)


class Spinner(HitObject):
    __slots__ = ("u",)

    def __init__(self, t: float, new_combo: bool, u: float) -> None:
        super().__init__(t, new_combo)
        self.u = u

    def end_time(self) -> float:
        return self.u

    def start_pos(self) -> np.ndarray:
        return PLAYFIELD_CENTER.copy()


class Slider(HitObject):
    """Abstract slider. ``slide_duration`` is the one-way travel time in ms:
    length px / (SV * 100 px/beat) * beat_length ms/beat.
    """

    __slots__ = ("slides", "length", "slider_multiplier", "slide_duration")

    def __init__(
        self,
        t: float,
        beat_length: float,
        slider_multiplier: float,
        new_combo: bool,
        slides: int,
        length: float,
    ) -> None:
        super().__init__(t, new_combo)
        self.slides = slides
        self.length = length
        self.slider_multiplier = slider_multiplier
        self.slide_duration = length / (slider_multiplier * 100) * beat_length

    def end_time(self) -> float:
        return int(self.t + self.slide_duration * self.slides)

    def lerp(self, t: float) -> np.ndarray:
        """Position along the (one-way) path at normalized parameter t in [0, 1]."""
        raise NotImplementedError

    def start_pos(self) -> np.ndarray:
        return self.lerp(0.0)

    def end_pos(self) -> np.ndarray:
        return self.lerp(self.slides % 2)
