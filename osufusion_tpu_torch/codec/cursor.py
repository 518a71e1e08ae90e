"""Continuous 2-D cursor path sampled at frame times, normalized to [0, 1].

Same per-frame semantics as reference osu_fusion/library/osu/data/cursor.py
(slider ping-pong via modulo on the single-slide duration, spinner hold at
playfield center, linear interpolation between consecutive objects, playfield
normalization by (512, 384)) — but computed per-object over contiguous frame
slices with vectorized slider path evaluation instead of a per-frame Python
loop, so encoding a full song is O(objects + T) numpy work.
"""

from __future__ import annotations

import numpy as np

from osufusion_tpu_torch.osu.beatmap import Beatmap
from osufusion_tpu_torch.osu.hit_objects import Slider, Spinner

PLAYFIELD = np.array([512.0, 384.0])


def cursor_signal(beatmap: Beatmap, frame_times: np.ndarray) -> np.ndarray:
    """Returns (2, T) cursor positions normalized by the playfield size."""
    objs = beatmap.hit_objects
    T = frame_times.shape[0]
    positions = np.empty((T, 2), dtype=float)

    obj_times = np.array([ho.t for ho in objs], dtype=float)

    # boundaries[k] = first frame belonging to object k; a frame belongs to the
    # last object whose onset is <= its time (frames before the first object
    # track its start position).
    boundaries = np.searchsorted(frame_times, obj_times, side="left")

    if boundaries[0] > 0:
        positions[: boundaries[0]] = objs[0].start_pos()

    for k, ho in enumerate(objs):
        lo = boundaries[k]
        hi = boundaries[k + 1] if k + 1 < len(objs) else T
        if hi <= lo:
            continue
        ts = frame_times[lo:hi]
        end_t = ho.end_time()

        active = ts < end_t
        n_active = int(np.count_nonzero(active))

        if n_active:
            seg = slice(lo, lo + n_active)
            if isinstance(ho, Spinner):
                positions[seg] = ho.start_pos()
            elif isinstance(ho, Slider):
                s = (ts[:n_active] - ho.t) % (ho.slide_duration * 2) / ho.slide_duration
                param = np.where(s < 1, s, 2 - s)
                positions[seg] = ho.lerp_many(param)
            else:  # Circle: end_time == t, never active
                positions[seg] = ho.start_pos()

        if n_active < ts.shape[0]:
            seg = slice(lo + n_active, hi)
            tail = ts[n_active:]
            end_pos = np.asarray(ho.end_pos(), dtype=float)
            if k + 1 < len(objs):
                nxt = objs[k + 1]
                f = ((tail - end_t) / (nxt.t - end_t))[:, None]
                positions[seg] = (1 - f) * end_pos + f * np.asarray(nxt.start_pos(), dtype=float)
            else:
                positions[seg] = end_pos

    return (positions / PLAYFIELD).T
