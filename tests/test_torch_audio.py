"""The port's audio front end (log-VQT as one matmul, WAV decode + resample)
against the JAX package's, on a seeded tone-plus-noise signal."""

import numpy as np
from scipy.io import wavfile

from osufusion_tpu.audio import load_audio as jax_load_audio
from osufusion_tpu.audio import log_vqt as jax_log_vqt
from osufusion_tpu.audio.vqt import vqt_kernels as jax_vqt_kernels
from osufusion_tpu_torch.audio import SR, load_audio, log_vqt
from osufusion_tpu_torch.audio.vqt import vqt_kernels

# fp32 on both sides: the port sums the 2112-tap window in one matmul, the JAX
# package in 12 block matmuls. Magnitudes here are >= ~1e-3 (noise floor), so
# a ~1e-6 relative difference in a magnitude stays < 1e-3 in its log
LOG_TOL = 1e-3


def _signal(seconds=2.0, seed=0):
    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * SR)) / SR
    tones = sum(np.sin(2 * np.pi * f * t) for f in (110.0, 440.0, 1760.0)) / 3
    return (0.5 * tones + 0.05 * rng.standard_normal(t.shape)).astype(np.float32)


def test_vqt_kernels_are_the_jax_bank():
    np.testing.assert_array_equal(vqt_kernels(), jax_vqt_kernels())


def test_log_vqt_matches_jax():
    y = _signal()
    want = np.asarray(jax_log_vqt(y))
    got = log_vqt(y).numpy()
    assert got.shape == want.shape == (96, 1 + len(y) // 176)
    np.testing.assert_allclose(got, want, atol=LOG_TOL, rtol=0)


def test_load_audio_wav_with_resample_matches_jax(tmp_path):
    path = tmp_path / "tone.wav"
    y = _signal(seconds=1.0, seed=1)
    wavfile.write(path, 44100, (np.stack([y, 0.5 * y], axis=1) * 32767).astype(np.int16))  # 44.1 kHz int16 stereo
    want = np.asarray(jax_load_audio(path))
    got = load_audio(path).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=LOG_TOL, rtol=0)
