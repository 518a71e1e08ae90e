"""The port's copies of the host layers (``osufusion_tpu_torch/osu``,
``osufusion_tpu_torch/codec``) against the JAX package's originals: the same
parse, the same encoded signal, the same decoded ``.osu`` text, the same star
rating."""

import numpy as np
import pytest

from osufusion_tpu.audio.constants import frame_times
from osufusion_tpu.codec import decode as jdecode
from osufusion_tpu.codec.encode import encode_beatmap as jax_encode_beatmap
from osufusion_tpu.osu import Beatmap as JBeatmap
from osufusion_tpu.osu.difficulty import calculate_star_rating as jax_star_rating
from osufusion_tpu_torch.codec import decode
from osufusion_tpu_torch.codec.encode import TOTAL_DIM, BeatmapEncoding, encode_beatmap
from osufusion_tpu_torch.osu import Beatmap, Slider, Spinner
from osufusion_tpu_torch.osu.difficulty import calculate_star_rating
from tests.helpers import write_synthetic_map

N_FRAMES = 1600


@pytest.fixture(scope="module")
def osu_path(tmp_path_factory):
    return write_synthetic_map(tmp_path_factory.mktemp("map"))


def test_beatmap_parse_matches(osu_path):
    got, want = Beatmap(osu_path), JBeatmap(osu_path)
    assert len(got.hit_objects) == len(want.hit_objects) == 8
    for g, w in zip(got.hit_objects, want.hit_objects):
        assert type(g).__name__ == type(w).__name__ and g.t == w.t and g.end_time() == w.end_time()
        np.testing.assert_array_equal(g.start_pos(), w.start_pos())
    assert sum(isinstance(h, Slider) for h in got.hit_objects) == 3
    assert sum(isinstance(h, Spinner) for h in got.hit_objects) == 1
    assert (got.cs, got.ar, got.od, got.hp) == (want.cs, want.ar, want.od, want.hp)
    assert calculate_star_rating(got) == jax_star_rating(want) > 0


def test_encode_matches(osu_path):
    ft = frame_times(N_FRAMES)
    got, want = encode_beatmap(Beatmap(osu_path), ft), jax_encode_beatmap(JBeatmap(osu_path), ft)
    assert got.shape == (TOTAL_DIM, N_FRAMES) and int(BeatmapEncoding.CURSOR_X) == 4
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("bpm,snap", [(None, False), (120.0, True), (None, True)], ids=["free", "bpm-snapped", "estimated-bpm"])
def test_decode_of_an_encoded_map_gives_identical_text(osu_path, bpm, snap):
    ft = frame_times(N_FRAMES)
    x = encode_beatmap(Beatmap(osu_path), ft)
    meta = ("audio.mp3", "Synthetic", "UnitTest", "Easy", 4.0, 8.0, 6.0, 5.0)
    got = decode.decode_beatmap(decode.Metadata(*meta), x, ft, bpm=bpm, allow_beat_snap=snap, verbose=False)
    want = jdecode.decode_beatmap(jdecode.Metadata(*meta), x, ft, bpm=bpm, allow_beat_snap=snap, verbose=False)
    assert got == want
    assert got.startswith("osu file format v14") and len(got.split("[HitObjects]")[1].strip().splitlines()) >= 6


@pytest.mark.parametrize("seed", [0, 1])
def test_decode_of_a_seeded_signal_gives_identical_text(seed):
    """A smooth random signal, as a sampler's output is: many onsets, sliders
    with fitted curves, spinners."""
    rng = np.random.default_rng(seed)
    n = 2000
    x = rng.standard_normal((TOTAL_DIM, n + 40))
    x = np.stack([np.convolve(row, np.hanning(41) / np.hanning(41).sum(), mode="valid")[:n] for row in x]) * 4.0
    x = np.clip(x, -1.0, 1.0).astype(np.float32)
    ft = frame_times(n)
    meta = ("song.wav", "Seeded", "UnitTest", "v", 4.0, 9.0, 9.0, 5.0)
    got = decode.decode_beatmap(decode.Metadata(*meta), x, ft, verbose=False)
    want = jdecode.decode_beatmap(jdecode.Metadata(*meta), x, ft, verbose=False)
    assert got == want
    assert "[HitObjects]" in got
