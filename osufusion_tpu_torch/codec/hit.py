"""Hit-signal rasterizers and their inverses.

Same signal semantics as reference osu_fusion/library/osu/data/hit.py —
``flips`` toggles a 0/1 square wave at each (new-combo) onset frame (:11),
``extents`` paints 1 over [start, end) time regions (:45); decoders recover
onset frames via gradient peak-finding (:23) and region boundaries via
threshold-crossing pairing with orphan cleanup (:52).

Encoders here are fully vectorized (cumulative toggle counts / +1-1 boundary
sums) instead of the reference's per-object Python loops — O(K log T + T).
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
from scipy.signal import find_peaks

from osufusion_tpu_torch.osu.beatmap import Beatmap
from osufusion_tpu_torch.osu.hit_objects import Slider, Spinner


def flips(beatmap: Beatmap, frame_times: np.ndarray, combo: bool = False) -> np.ndarray:
    """0/1 square wave that toggles at each onset (or new-combo onset)."""
    onset_times = np.array(
        [ho.t for ho in beatmap.hit_objects if (not combo or ho.new_combo)], dtype=float
    )
    return flips_from_times(onset_times, frame_times)


def flips_from_times(onset_times: np.ndarray, frame_times: np.ndarray) -> np.ndarray:
    n = frame_times.shape[0]
    if onset_times.size == 0:
        return np.zeros(n, dtype=float)
    idxs = np.searchsorted(frame_times, onset_times)
    idxs = idxs[idxs < n]
    toggles = np.zeros(n, dtype=np.int64)
    np.add.at(toggles, idxs, 1)
    return (np.cumsum(toggles) % 2).astype(float)


def decode_flips(flips_: np.ndarray) -> List[int]:
    """Recover onset frame indices from a (possibly soft) flip signal."""
    gradients = np.gradient(flips_)
    rising = find_peaks(gradients, height=0.5)[0].tolist()
    falling = find_peaks(-gradients, height=0.5)[0].tolist()
    return sorted(rising + falling)


Real = float


def combo_regions(beatmap: Beatmap) -> List[Tuple[Real, Real]]:
    """[start, end) spans of each combo, scanning objects back-to-front."""
    new_combo_regions: List[Tuple[Real, Real]] = []
    region_end = None
    for ho in beatmap.hit_objects[::-1]:
        if region_end is None:
            region_end = ho.end_time() + 1
        if ho.new_combo:
            new_combo_regions.insert(0, (ho.t, region_end))
            region_end = None
    return new_combo_regions


def extents(regions: Sequence[Tuple[Real, Real]], frame_times: np.ndarray) -> np.ndarray:
    """1 over [start, end) of each region, 0 elsewhere (vectorized)."""
    holds = np.zeros_like(frame_times, dtype=float)
    if len(regions) == 0:
        return holds
    regions_arr = np.asarray(regions, dtype=float)
    start_idx = np.searchsorted(frame_times, regions_arr[:, 0], side="left")
    end_idx = np.searchsorted(frame_times, regions_arr[:, 1], side="left")
    n = frame_times.shape[0]
    delta = np.zeros(n + 1, dtype=np.int64)
    np.add.at(delta, start_idx, 1)
    np.add.at(delta, end_idx, -1)
    holds[np.cumsum(delta[:-1]) > 0] = 1.0
    return holds


def decode_extents(extents_: np.ndarray) -> Tuple[List[int], List[int]]:
    """Recover (start, end) frame-index pairs from a region signal.

    Starts/ends come from threshold crossings; unmatched ends that precede
    their start are dropped so every start pairs with the first end after it.
    """
    before_below = extents_[:-1] <= 0
    after_below = extents_[1:] <= 0

    start_idxs = sorted(np.argwhere(before_below & ~after_below)[:, 0].tolist())
    end_idxs = sorted(np.argwhere(~before_below & after_below)[:, 0].tolist())

    cursor = 0
    for cursor, start in enumerate(start_idxs):
        try:
            while start >= end_idxs[cursor]:
                end_idxs.pop(cursor)
        except IndexError:
            break
    cursor += 1

    return start_idxs[:cursor], end_idxs[:cursor]


def hit_signals(beatmap: Beatmap, frame_times: np.ndarray) -> np.ndarray:
    """Stack the four hit channels: HIT flips, SUSTAIN extents (slider+spinner
    spans), SLIDER extents (first-slide span), COMBO flips."""
    return np.stack(
        [
            flips(beatmap, frame_times),
            extents(
                [(ho.t, ho.end_time()) for ho in beatmap.hit_objects if isinstance(ho, (Slider, Spinner))],
                frame_times,
            ),
            extents(
                [(ho.t, ho.t + ho.slide_duration) for ho in beatmap.hit_objects if isinstance(ho, Slider)],
                frame_times,
            ),
            flips(beatmap, frame_times, combo=True),
        ]
    )
