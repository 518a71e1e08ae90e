"""Audio feature constants and the conditioning-vector normalization.

Identical numeric constants to reference osu_fusion/scripts/dataset_creator.py
(:17-25): 22050 Hz, 8 ms/frame (hop 176 -> 125 fps), 96-bin log-VQT from C0
over 8 octaves, 5 conditioning scalars. ``normalize_context`` maps CS/AR/OD/HP
from [0,10] and star rating from [0,20] into [-1,1] (reference :58-79) —
implemented pure (returns a new array) rather than mutating in place.
"""

from __future__ import annotations

import numpy as np

SR = 22050
MS_PER_FRAME = 8
HOP_LENGTH = (SR // 1000) * MS_PER_FRAME  # 176 samples -> 125 fps

# C0 in 12-TET with A4=440: 440 * 2**(-57/12)
FMIN = 440.0 * 2.0 ** (-57.0 / 12.0)  # 16.3516 Hz
N_OCTAVES = 8
OCTAVE_BINS = 12
AUDIO_DIM = N_OCTAVES * OCTAVE_BINS  # 96
CONTEXT_DIM = 5  # CS, AR, OD, HP, star rating

# log(|silence| + 1e-10): the canonical padding value for spectrogram frames
SILENCE_VALUE = float(np.log(1e-10))  # ~= -23.026


def frame_times(n_frames: int) -> np.ndarray:
    """Center time in ms of each spectrogram frame (frame k at k*hop samples)."""
    return np.arange(n_frames, dtype=float) * HOP_LENGTH / SR * 1000.0


def normalize_context(context: np.ndarray) -> np.ndarray:
    """[CS, AR, OD, HP, SR*] -> [-1, 1]. Pure; does not mutate the input."""
    context = np.asarray(context, dtype=np.float32).copy()
    context[..., :4] = context[..., :4] / 5 - 1  # [0, 10] -> [-1, 1]
    context[..., 4] = context[..., 4] / 10 - 1  # [0, 20] -> [-1, 1]
    return context


def unnormalize_context(context: np.ndarray) -> np.ndarray:
    """Inverse of :func:`normalize_context`. Pure."""
    context = np.asarray(context, dtype=np.float32).copy()
    context[..., :4] = (context[..., :4] + 1) * 5
    context[..., 4] = (context[..., 4] + 1) * 10
    return context
