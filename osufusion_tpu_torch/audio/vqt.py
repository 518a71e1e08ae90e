"""Variable-Q transform (log-VQT) as one matmul (``osufusion_tpu/audio/vqt.py``).

The filter bank is the JAX package's, built in numpy: 96 Hann-windowed complex
exponentials with ERB-motivated variable-Q bandwidths, each L1-normalised then
scaled by sqrt(length), centred in a fixed window of 12 hops. Frame n's
analysis window starts at n*hop - 6*hop. The transform unfolds the padded
signal into (n_frames, 12*hop) windows and multiplies them by the
(12*hop, 192) bank: the same sum the JAX package takes as 12 block matmuls,
in float32.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch
import torch.nn.functional as F

from osufusion_tpu_torch.audio.constants import AUDIO_DIM, FMIN, HOP_LENGTH, OCTAVE_BINS, SR

_R = 2.0 ** (1.0 / OCTAVE_BINS)
ALPHA = (_R**2 - 1) / (_R**2 + 1)
GAMMA = 24.7 * ALPHA / 0.108
Q = 1.0 / ALPHA

# the longest filter (~1.56k samples) fits a window of whole hops
MAX_FILTER_LENGTH = 2048


def _window_blocks(hop: int) -> int:
    """Even number of hop-sized blocks covering the longest filter."""
    return 2 * max(1, -(-MAX_FILTER_LENGTH // (2 * hop)))


def bin_frequencies() -> np.ndarray:
    return FMIN * 2.0 ** (np.arange(AUDIO_DIM) / OCTAVE_BINS)


def filter_lengths() -> np.ndarray:
    freqs = bin_frequencies()
    return np.minimum(Q * SR / (freqs + GAMMA / ALPHA), MAX_FILTER_LENGTH)


@lru_cache(maxsize=4)
def vqt_kernels(hop: int = HOP_LENGTH) -> np.ndarray:
    """(2 * AUDIO_DIM, blocks*hop) float32 bank: real rows then imag rows."""
    freqs = bin_frequencies()
    lengths = filter_lengths()
    blocks = _window_blocks(hop)
    window_length = blocks * hop
    center = (blocks // 2) * hop
    t = np.arange(window_length, dtype=np.float64) - center

    kernels = np.zeros((2 * AUDIO_DIM, window_length), dtype=np.float32)
    for k, (f, l) in enumerate(zip(freqs, lengths)):
        win = 0.5 * (1 + np.cos(2 * np.pi * t / l))
        win[np.abs(t) > l / 2] = 0.0
        phase = 2 * np.pi * f * t / SR
        c = win * np.exp(1j * phase)
        c *= np.sqrt(l) / np.abs(c).sum()
        kernels[k] = c.real.astype(np.float32)
        kernels[k + AUDIO_DIM] = c.imag.astype(np.float32)
    return kernels


def vqt(y, hop_length: int = HOP_LENGTH, device=None) -> torch.Tensor:
    """Magnitude VQT of mono audio, shape (AUDIO_DIM, 1 + len(y)//hop_length)."""
    y = torch.as_tensor(np.asarray(y, dtype=np.float32), device=device)
    kernels = torch.from_numpy(vqt_kernels(hop_length)).to(y.device)
    blocks = _window_blocks(hop_length)
    center = (blocks // 2) * hop_length
    n_frames = 1 + y.shape[0] // hop_length
    total = (n_frames + blocks - 1) * hop_length
    y = F.pad(y, (center, max(0, total - y.shape[0] - center)))[:total]
    windows = y.unfold(0, blocks * hop_length, hop_length)  # (n_frames, blocks*hop)
    out = (windows @ kernels.T).T  # (192, n_frames)
    re, im = out[:AUDIO_DIM], out[AUDIO_DIM:]
    return torch.sqrt(re * re + im * im)


def log_vqt(y, hop_length: int = HOP_LENGTH, device=None) -> torch.Tensor:
    """log(|VQT| + 1e-10): the model's audio feature (silence floor -23.03)."""
    return torch.log(vqt(y, hop_length, device) + 1e-10)
