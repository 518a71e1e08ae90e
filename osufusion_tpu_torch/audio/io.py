"""Audio decode + resample front end (``osufusion_tpu/audio/io.py``).

WAV decodes natively via scipy; anything else goes through an ``ffmpeg``
subprocess when the binary exists. Resampling is polyphase (scipy
``resample_poly`` with a Kaiser window).
"""

from __future__ import annotations

import shutil
import subprocess
from fractions import Fraction
from pathlib import Path

import numpy as np
import torch
from scipy.io import wavfile
from scipy.signal import resample_poly

from osufusion_tpu_torch.audio.constants import SR
from osufusion_tpu_torch.audio.vqt import log_vqt

_FFMPEG = shutil.which("ffmpeg")


def decode_wav(path: Path) -> tuple[int, np.ndarray]:
    sr, data = wavfile.read(path)
    if data.dtype == np.int16:
        data = data.astype(np.float32) / 32768.0
    elif data.dtype == np.int32:
        data = data.astype(np.float32) / 2147483648.0
    elif data.dtype == np.uint8:
        data = (data.astype(np.float32) - 128.0) / 128.0
    else:
        data = data.astype(np.float32)
    if data.ndim == 2:
        data = data.mean(axis=1)
    return sr, data


def decode_ffmpeg(path: Path) -> tuple[int, np.ndarray]:
    if _FFMPEG is None:
        raise RuntimeError(f"cannot decode {path.suffix} audio: ffmpeg binary not available; provide WAV input")
    proc = subprocess.run(
        [_FFMPEG, "-v", "quiet", "-i", str(path), "-f", "f32le", "-ac", "1", "-ar", str(SR), "-"],
        capture_output=True,
        check=True,
    )
    return SR, np.frombuffer(proc.stdout, dtype=np.float32).copy()


def load_waveform(path: Path, target_sr: int = SR) -> np.ndarray:
    """Decode any supported audio file to mono float32 at ``target_sr``."""
    path = Path(path)
    if path.suffix.lower() == ".wav":
        sr, wave = decode_wav(path)
    else:
        sr, wave = decode_ffmpeg(path)

    if wave.shape[0] == 0:
        raise ValueError(f"Empty audio file: {path}")

    if sr != target_sr:
        frac = Fraction(target_sr, sr).limit_denominator(1000)
        wave = resample_poly(wave, frac.numerator, frac.denominator, window=("kaiser", 12.0))
    return wave.astype(np.float32)


def load_audio(audio_file: Path, device=None) -> torch.Tensor:
    """Audio file -> (AUDIO_DIM, T) float32 log-VQT spectrogram on ``device``."""
    return log_vqt(load_waveform(audio_file), device=device)
