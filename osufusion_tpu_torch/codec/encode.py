"""The 6-channel beatmap signal schema and encoder.

Channel layout identical to reference osu_fusion/library/osu/data/encode.py
(:10-26): four hit channels (HIT, SUSTAIN, SLIDER, COMBO) and two cursor
channels (CURSOR_X, CURSOR_Y), all mapped from {0,1}/[0,1] into [-1, 1].
"""

from __future__ import annotations

from enum import IntEnum

import numpy as np

from osufusion_tpu_torch.codec.cursor import cursor_signal
from osufusion_tpu_torch.codec.hit import hit_signals
from osufusion_tpu_torch.osu.beatmap import Beatmap


class BeatmapEncoding(IntEnum):
    # hit signals
    HIT = 0
    SUSTAIN = 1
    SLIDER = 2
    COMBO = 3
    # cursor signals
    CURSOR_X = 4
    CURSOR_Y = 5


HIT_DIM = 4
CURSOR_DIM = 2
TOTAL_DIM = HIT_DIM + CURSOR_DIM


def encode_beatmap(beatmap: Beatmap, frame_times: np.ndarray) -> np.ndarray:
    """Rasterize a parsed beatmap to a (6, T) signal in [-1, 1]."""
    hit = hit_signals(beatmap, frame_times)
    cursor = cursor_signal(beatmap, frame_times)
    return np.concatenate([hit, cursor], axis=0) * 2 - 1
