"""osu! standard difficulty (star rating) — modern strain-skill algorithm.

The reference delegates star rating to the Rust ``rosu-pp`` crate
(reference scripts/dataset_creator.py:30-31,:139-142 and library/
dataset.py:64-66); the rating feeds the 5th conditioning scalar. This module
implements the MODERN osu!standard algorithm (the November 2021 difficulty
rework that rosu-pp 1.x tracks), not the early ppv2 family:

- per-object preprocessing into jump/travel attributes: strain time
  (25 ms floor), lazy jump distance from the previous object's *lazy end
  position*, minimum jump distance/time discounting slider follow-circle
  leniency, slider lazy travel via a cursor-follow simulation, and the
  movement angle at each object;
- AIM skill with wide-angle, acute-angle, velocity-change and slider-travel
  bonuses (strain decay 0.15/s);
- SPEED skill with OD-window-aware strain time, 75 ms speed bonus, capped
  spacing bonus ^3.5, and the island-based RHYTHM complexity multiplier over
  a 5 s history window (strain decay 0.3/s);
- 400 ms section peaks; top-10 (aim) / top-5 (speed) section reduction
  toward a 0.75 baseline; 0.9^i geometric weighting x 1.06;
- the current skill combination: ratings -> base performance values ->
  p-norm(1.1) -> star rating via the cbrt fold.

Deviations from rosu-pp, conscious and documented (rosu-pp is a Rust crate
that can neither be installed nor executed in this offline environment, so
bit-parity is unobtainable and the exact constants of any given release are
unverifiable here):

1. Slider nested objects (ticks at the beatmap's tick rate) drive lazer's
   lazy-travel simulation; we approximate the nested stream with path
   samples every ~50 osu!px per span (+ repeat markers at span boundaries,
   + the legacy 36 ms-lenient lazy end). Tick timing only changes WHERE the
   follow cursor is nudged, not the radius thresholds, so travel distances
   land close but not bit-equal.
2. Stacking (stack offsets of overlapping objects) is not applied; the
   reference corpus feeds unstacked coordinates too.
3. The flashlight skill is omitted (no-mod ratings: base flashlight
   performance is 0 in the combination).
4. Skill multipliers are the 2021-rework constants (aim 23.55, speed 1375,
   performance base 1.12); later lazer releases re-tuned them by a few
   percent.

Validation (tests/test_pipeline.py): golden drift pins on canonical
patterns, directional invariants (spacing/density/CS monotonicity, length
saturation), and exact equivalence with the C++ core (tests/test_native.py)
that serves the per-segment-SR hot path — both cores consume the same
preprocessed attribute table built here.
"""

from __future__ import annotations

import math
from typing import List, Optional

import numpy as np

from osufusion_tpu_torch.osu.beatmap import Beatmap
from osufusion_tpu_torch.osu.hit_objects import Slider, Spinner

# ------------------------------------------------------------ preprocessing

NORMALISED_RADIUS = 50.0
MIN_DELTA_TIME = 25.0
MAX_SLIDER_RADIUS = NORMALISED_RADIUS * 2.4
ASSUMED_SLIDER_RADIUS = NORMALISED_RADIUS * 1.8
TAIL_LENIENCY = -36.0  # legacy last tick sits 36 ms before the slider end
TRAVEL_SAMPLE_PX = 50.0  # nested-stream approximation density (deviation #1)

# aim
AIM_DECAY_BASE = 0.15
AIM_SKILL_MULTIPLIER = 23.55
WIDE_ANGLE_MULTIPLIER = 1.5
ACUTE_ANGLE_MULTIPLIER = 1.95
SLIDER_MULTIPLIER = 1.35
VELOCITY_CHANGE_MULTIPLIER = 0.75

# speed + rhythm
SPEED_DECAY_BASE = 0.3
SPEED_SKILL_MULTIPLIER = 1375.0
SINGLE_SPACING_THRESHOLD = 125.0
MIN_SPEED_BONUS = 75.0
SPEED_BALANCING_FACTOR = 40.0
RHYTHM_MULTIPLIER = 0.75
HISTORY_TIME_MAX = 5000.0
MAX_HISTORY_OBJECTS = 32

# skill -> rating
SECTION_LENGTH = 400.0
DECAY_WEIGHT = 0.9
REDUCED_SECTION_COUNT_AIM = 10
REDUCED_SECTION_COUNT_SPEED = 5
REDUCED_STRAIN_BASELINE = 0.75
SKILL_DIFFICULTY_MULTIPLIER = 1.06
DIFFICULTY_MULTIPLIER = 0.0675
PERFORMANCE_BASE_MULTIPLIER = 1.12


def circle_radius(cs: float) -> float:
    return 54.4 - 4.48 * cs


class MapAttributes:
    """Flat per-hit-object attribute table consumed by BOTH evaluator cores
    (the Python one below and native/difficulty.cpp). Row i describes hit
    object i; movement attributes at row i describe the jump from object
    i-1 to object i (row 0's movement fields are zero)."""

    __slots__ = (
        "start_time", "delta_time", "strain_time", "lazy_jump", "min_jump",
        "min_jump_time", "travel_dist", "travel_time", "angle",
        "is_slider", "is_spinner", "od", "n",
    )

    def __init__(self, n: int, od: float) -> None:
        self.n = n
        self.od = od
        self.start_time = np.zeros(n)
        self.delta_time = np.zeros(n)
        self.strain_time = np.full(n, MIN_DELTA_TIME)
        self.lazy_jump = np.zeros(n)
        self.min_jump = np.zeros(n)
        self.min_jump_time = np.full(n, MIN_DELTA_TIME)
        self.travel_dist = np.zeros(n)  # the object's OWN slider travel
        self.travel_time = np.full(n, MIN_DELTA_TIME)
        self.angle = np.full(n, np.nan)
        self.is_slider = np.zeros(n, dtype=np.uint8)
        self.is_spinner = np.zeros(n, dtype=np.uint8)


def _slider_travel(slider: Slider, scaling0: float):
    """Cursor-follow lazy travel over an approximated nested-object stream.

    Returns (lazy_travel_distance_scaled, lazy_travel_time_ms, lazy_end_pos,
    tail_pos). ``scaling0`` is NORMALISED_RADIUS / radius WITHOUT the
    small-circle bonus, matching lazer's computeSliderCursorPosition."""
    span_d = max(float(slider.slide_duration), 1e-9)
    n_spans = max(int(slider.slides), 1)
    duration = span_d * n_spans
    lazy_travel_time = max(duration + TAIL_LENIENCY, duration / 2.0)

    # final lazy-end path parameter (folded by span direction)
    p = lazy_travel_time / span_d
    frac = p % 1.0
    p_final = 1.0 - frac if (p % 2.0) >= 1.0 else frac

    head = np.asarray(slider.lerp(0.0), dtype=float)
    tail = np.asarray(slider.lerp(n_spans % 2), dtype=float)
    lazy_end_guess = np.asarray(slider.lerp(p_final), dtype=float)

    # nested stream: per span, samples every ~TRAVEL_SAMPLE_PX of path
    k = max(1, int(math.ceil(max(float(slider.length), 1.0) / TRAVEL_SAMPLE_PX)))
    frac = np.arange(1, k + 1) / k
    path_ts = np.concatenate([frac if s % 2 == 0 else 1.0 - frac for s in range(n_spans)])
    nested_pos = np.asarray(slider.lerp_many(path_ts), dtype=float)
    is_repeat_at = {s * k + (k - 1) for s in range(n_spans - 1)}

    cursor = head.copy()
    lazy_dist = 0.0
    for idx in range(len(nested_pos)):
        pos, is_repeat = nested_pos[idx], idx in is_repeat_at
        movement = pos - cursor
        if idx == len(nested_pos) - 1:
            # the tracking end is lenient: take the shorter of the true tail
            # movement and the lazy-end movement
            lazy_movement = lazy_end_guess - cursor
            if np.dot(lazy_movement, lazy_movement) < np.dot(movement, movement):
                movement = lazy_movement
        length = scaling0 * float(np.hypot(movement[0], movement[1]))
        required = NORMALISED_RADIUS if is_repeat else ASSUMED_SLIDER_RADIUS
        if length > required:
            shrink = (length - required) / length
            cursor = cursor + movement * shrink
            lazy_dist += length * shrink
    return lazy_dist, lazy_travel_time, cursor, tail


def preprocess(beatmap: Beatmap) -> Optional[MapAttributes]:
    """Build the shared attribute table (lazer OsuDifficultyHitObject)."""
    objs = list(beatmap.hit_objects)
    n = len(objs)
    if n < 2:
        return None

    radius = circle_radius(beatmap.cs)
    scaling0 = NORMALISED_RADIUS / radius
    scaling = scaling0
    if radius < 30:
        scaling *= 1 + min(30 - radius, 5.0) / 50.0

    at = MapAttributes(n, float(beatmap.od))
    positions = [np.asarray(ho.start_pos(), dtype=float) for ho in objs]
    lazy_end = list(positions)  # non-sliders: cursor rests on the object
    tail_pos = list(positions)
    lazy_travel_time = np.zeros(n)

    for i, ho in enumerate(objs):
        at.start_time[i] = float(ho.t)
        if isinstance(ho, Spinner):
            at.is_spinner[i] = 1
        elif isinstance(ho, Slider):
            at.is_slider[i] = 1
            dist, t_travel, end, tail = _slider_travel(ho, scaling0)
            repeat_count = max(int(ho.slides), 1) - 1
            at.travel_dist[i] = dist * (1 + repeat_count / 2.5) ** (1.0 / 2.5)
            at.travel_time[i] = max(t_travel, MIN_DELTA_TIME)
            lazy_travel_time[i] = t_travel
            lazy_end[i] = end
            tail_pos[i] = tail

    for i in range(1, n):
        at.delta_time[i] = at.start_time[i] - at.start_time[i - 1]
        at.strain_time[i] = max(at.delta_time[i], MIN_DELTA_TIME)
        at.min_jump_time[i] = at.strain_time[i]
        if at.is_spinner[i] or at.is_spinner[i - 1]:
            continue

        last_cursor = lazy_end[i - 1]
        jump = (positions[i] - last_cursor) * scaling
        at.lazy_jump[i] = float(np.hypot(jump[0], jump[1]))
        at.min_jump[i] = at.lazy_jump[i]

        if at.is_slider[i - 1]:
            last_travel = max(lazy_travel_time[i - 1], MIN_DELTA_TIME)
            at.min_jump_time[i] = max(at.strain_time[i] - last_travel, MIN_DELTA_TIME)
            tj = (tail_pos[i - 1] - positions[i]) * scaling
            tail_jump = float(np.hypot(tj[0], tj[1]))
            at.min_jump[i] = max(
                0.0,
                min(
                    at.lazy_jump[i] - (MAX_SLIDER_RADIUS - ASSUMED_SLIDER_RADIUS),
                    tail_jump - MAX_SLIDER_RADIUS,
                ),
            )

        if i >= 2 and not at.is_spinner[i - 2]:
            v1 = lazy_end[i - 2] - positions[i - 1]
            v2 = positions[i] - last_cursor
            dot = float(np.dot(v1, v2))
            det = float(v1[0] * v2[1] - v1[1] * v2[0])
            at.angle[i] = abs(math.atan2(det, dot))
    return at


# -------------------------------------------------------------- evaluators
#
# Mirrored statement-for-statement by native/difficulty.cpp — keep in sync.


def _calc_wide_angle_bonus(angle: float) -> float:
    return math.sin(0.75 * (min(5.0 / 6.0 * math.pi, max(math.pi / 6.0, angle)) - math.pi / 6.0)) ** 2


def _calc_acute_angle_bonus(angle: float) -> float:
    return 1.0 - _calc_wide_angle_bonus(angle)


def _aim_strain_of(at: MapAttributes, i: int) -> float:
    if i < 3 or at.is_spinner[i] or at.is_spinner[i - 1]:
        return 0.0

    curr_vel = at.lazy_jump[i] / at.strain_time[i]
    if at.is_slider[i - 1]:
        travel_vel = at.travel_dist[i - 1] / at.travel_time[i - 1]
        movement_vel = at.min_jump[i] / at.min_jump_time[i]
        curr_vel = max(curr_vel, movement_vel + travel_vel)

    prev_vel = at.lazy_jump[i - 1] / at.strain_time[i - 1]
    if at.is_slider[i - 2]:
        travel_vel = at.travel_dist[i - 2] / at.travel_time[i - 2]
        movement_vel = at.min_jump[i - 1] / at.min_jump_time[i - 1]
        prev_vel = max(prev_vel, movement_vel + travel_vel)

    wide = acute = vel_change = slider_bonus = 0.0
    aim_strain = curr_vel

    st_i, st_l = at.strain_time[i], at.strain_time[i - 1]
    if max(st_i, st_l) < 1.25 * min(st_i, st_l):
        a_c, a_l, a_ll = at.angle[i], at.angle[i - 1], at.angle[i - 2]
        if not (math.isnan(a_c) or math.isnan(a_l) or math.isnan(a_ll)):
            angle_bonus = min(curr_vel, prev_vel)
            wide = _calc_wide_angle_bonus(a_c)
            acute = _calc_acute_angle_bonus(a_c)
            if st_i > 100:
                acute = 0.0
            else:
                acute *= (
                    _calc_acute_angle_bonus(a_l)
                    * min(angle_bonus, 125.0 / st_i)
                    * math.sin(math.pi / 2 * min(1.0, (100.0 - st_i) / 25.0)) ** 2
                    * math.sin(math.pi / 2 * (min(max(at.lazy_jump[i], 50.0), 100.0) - 50.0) / 50.0) ** 2
                )
            wide *= angle_bonus * (1 - min(wide, _calc_wide_angle_bonus(a_l) ** 3))
            acute *= 0.5 + 0.5 * (1 - min(acute, _calc_acute_angle_bonus(a_ll) ** 3))

    if max(prev_vel, curr_vel) != 0.0:
        prev_vel = (at.lazy_jump[i - 1] + at.travel_dist[i - 2]) / at.strain_time[i - 1]
        curr_vel = (at.lazy_jump[i] + at.travel_dist[i - 1]) / at.strain_time[i]
        dist_ratio = math.sin(math.pi / 2 * abs(prev_vel - curr_vel) / max(prev_vel, curr_vel)) ** 2
        overlap_buff = min(125.0 / min(st_i, st_l), abs(prev_vel - curr_vel))
        vel_change = overlap_buff * dist_ratio * (min(st_i, st_l) / max(st_i, st_l)) ** 2

    if at.is_slider[i - 1]:
        slider_bonus = at.travel_dist[i - 1] / at.travel_time[i - 1]

    aim_strain += max(acute * ACUTE_ANGLE_MULTIPLIER, wide * WIDE_ANGLE_MULTIPLIER + vel_change * VELOCITY_CHANGE_MULTIPLIER)
    aim_strain += slider_bonus * SLIDER_MULTIPLIER
    return aim_strain


def _speed_strain_of(at: MapAttributes, i: int, great_window_full: float) -> float:
    if at.is_spinner[i]:
        return 0.0
    strain_time = at.strain_time[i]
    ratio = strain_time / great_window_full
    if i >= 2 and strain_time < great_window_full and at.strain_time[i - 1] > strain_time:
        strain_time = at.strain_time[i - 1] + ratio * (strain_time - at.strain_time[i - 1])
    strain_time /= min(max((strain_time / great_window_full) / 0.93, 0.92), 1.0)
    speed_bonus = 1.0
    if strain_time < MIN_SPEED_BONUS:
        speed_bonus = 1 + 0.75 * ((MIN_SPEED_BONUS - strain_time) / SPEED_BALANCING_FACTOR) ** 2
    travel = at.travel_dist[i - 1] if i >= 2 else 0.0
    dist = min(SINGLE_SPACING_THRESHOLD, travel + at.min_jump[i])
    return (speed_bonus + speed_bonus * (dist / SINGLE_SPACING_THRESHOLD) ** 3.5) / strain_time


def _rhythm_bonus_of(at: MapAttributes, i: int, great_window_full: float) -> float:
    """Island-based rhythm complexity over the trailing 5 s / 32 objects."""
    if at.is_spinner[i]:
        return 0.0
    prev_island = 0
    island = 1
    complexity = 0.0
    start_ratio = 0.0
    first_switch = False
    historical = min(i - 1, MAX_HISTORY_OBJECTS)

    rhythm_start = 0
    while (
        rhythm_start < historical - 2
        and at.start_time[i] - at.start_time[i - 1 - rhythm_start] < HISTORY_TIME_MAX
    ):
        rhythm_start += 1

    for j in range(rhythm_start, 0, -1):
        ci, pi, li = i - j, i - j - 1, i - j - 2
        decay = (HISTORY_TIME_MAX - (at.start_time[i] - at.start_time[ci])) / HISTORY_TIME_MAX
        decay = min((historical - j) / historical, decay)
        curr_d, prev_d, last_d = at.strain_time[ci], at.strain_time[pi], at.strain_time[li]
        ratio = 1.0 + 6.0 * min(0.5, math.sin(math.pi / (min(prev_d, curr_d) / max(prev_d, curr_d))) ** 2)
        window_penalty = min(
            1.0, max(0.0, abs(prev_d - curr_d) - great_window_full * 0.3) / (great_window_full * 0.3)
        )
        effective = window_penalty * ratio
        if first_switch:
            if not (prev_d > 1.25 * curr_d or prev_d * 1.25 < curr_d):
                if island < 7:
                    island += 1
            else:
                if at.is_slider[ci]:
                    effective *= 0.125
                if at.is_slider[pi]:
                    effective *= 0.25
                if prev_island == island:
                    effective *= 0.25
                if prev_island % 2 == island % 2:
                    effective *= 0.5
                if last_d > prev_d + 10 and prev_d > curr_d + 10:
                    effective *= 0.125
                complexity += (
                    math.sqrt(effective * start_ratio)
                    * decay
                    * math.sqrt(4.0 + island) / 2.0
                    * math.sqrt(4.0 + prev_island) / 2.0
                )
                start_ratio = effective
                prev_island = island
                if prev_d * 1.25 < curr_d:
                    first_switch = False
                island = 1
        elif prev_d > 1.25 * curr_d:
            first_switch = True
            start_ratio = effective
            island = 1
    return math.sqrt(4.0 + complexity * RHYTHM_MULTIPLIER) / 2.0


def _strain_peaks(
    at: MapAttributes, strains: np.ndarray, decay_base: float, rhythm: Optional[np.ndarray]
) -> List[float]:
    """lazer StrainSkill.Process: 400 ms sections of the decayed running
    strain. ``strains`` holds the per-object evaluator*multiplier increments
    (index 1..n-1); ``rhythm`` the per-object total-strain multiplier (speed
    only)."""
    peaks: List[float] = []
    current = 0.0
    first = 1
    section_end = math.ceil(at.start_time[first] / SECTION_LENGTH) * SECTION_LENGTH
    total = lambda i: current * (rhythm[i] if rhythm is not None else 1.0)  # noqa: E731
    section_peak = 0.0
    for i in range(first, at.n):
        t = at.start_time[i]
        while t > section_end:
            peaks.append(section_peak)
            decayed = current * decay_base ** ((section_end - at.start_time[i - 1]) / 1000.0)
            # lazer CalculateInitialStrain: currentRhythm still holds the
            # PREVIOUS object's multiplier when a new section begins
            section_peak = decayed * (rhythm[i - 1] if rhythm is not None else 1.0)
            section_end += SECTION_LENGTH
        current = current * decay_base ** (at.delta_time[i] / 1000.0) + strains[i]
        section_peak = max(section_peak, total(i))
    peaks.append(section_peak)
    return peaks


def _difficulty_value(peaks: List[float], reduced_count: int) -> float:
    strains = sorted(peaks, reverse=True)
    for i in range(min(len(strains), reduced_count)):
        scale = math.log10(1.0 + min(max(i / reduced_count, 0.0), 1.0) * 9.0)
        strains[i] *= REDUCED_STRAIN_BASELINE + (1 - REDUCED_STRAIN_BASELINE) * scale
    strains.sort(reverse=True)
    total = 0.0
    weight = 1.0
    for p in strains:
        total += p * weight
        weight *= DECAY_WEIGHT
    return total * SKILL_DIFFICULTY_MULTIPLIER


def evaluate(at: MapAttributes) -> float:
    """Attribute table -> star rating (the Python evaluator core)."""
    great_window_full = (80.0 - 6.0 * at.od) * 2.0

    aim_strains = np.zeros(at.n)
    speed_strains = np.zeros(at.n)
    rhythm = np.ones(at.n)
    for i in range(1, at.n):
        aim_strains[i] = _aim_strain_of(at, i) * AIM_SKILL_MULTIPLIER
        speed_strains[i] = _speed_strain_of(at, i, great_window_full) * SPEED_SKILL_MULTIPLIER
        rhythm[i] = _rhythm_bonus_of(at, i, great_window_full)

    aim_value = _difficulty_value(
        _strain_peaks(at, aim_strains, AIM_DECAY_BASE, None), REDUCED_SECTION_COUNT_AIM
    )
    speed_value = _difficulty_value(
        _strain_peaks(at, speed_strains, SPEED_DECAY_BASE, rhythm), REDUCED_SECTION_COUNT_SPEED
    )

    aim_rating = math.sqrt(aim_value) * DIFFICULTY_MULTIPLIER
    speed_rating = math.sqrt(speed_value) * DIFFICULTY_MULTIPLIER

    base_aim = (5.0 * max(1.0, aim_rating / 0.0675) - 4.0) ** 3 / 100000.0
    base_speed = (5.0 * max(1.0, speed_rating / 0.0675) - 4.0) ** 3 / 100000.0
    base_perf = (base_aim ** 1.1 + base_speed ** 1.1) ** (1.0 / 1.1)
    if base_perf <= 1e-5:
        return 0.0
    return (
        PERFORMANCE_BASE_MULTIPLIER ** (1.0 / 3.0)
        * 0.027
        * ((100000.0 / 2.0 ** (1.0 / 1.1) * base_perf) ** (1.0 / 3.0) + 4.0)
    )


# ------------------------------------------------------------- public API


def calculate_star_rating(beatmap: Beatmap) -> float:
    at = preprocess(beatmap)
    if at is None:
        return 0.0
    return evaluate(at)


def calculate_star_rating_from_text(osu_text: str) -> float:
    """Star rating of in-memory .osu text (used for per-segment SR,
    reference library/dataset.py:40-69)."""
    import tempfile
    from pathlib import Path

    with tempfile.TemporaryDirectory() as d:
        p = Path(d) / "segment.osu"
        p.write_text(osu_text, encoding="utf-8")
        try:
            bm = Beatmap(p)
        except ValueError:
            return 0.0
        return calculate_star_rating(bm)
