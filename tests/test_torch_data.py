"""The port's input pipeline (``osufusion_tpu_torch/train/data.py``) against
the JAX package's on the same synthetic npz files: the same batches for the
same seed in every dataset mode, whatever the worker count, across a resume."""

import numpy as np
import pytest

from osufusion_tpu.train import data as JD
from osufusion_tpu_torch.train import data as D
from tests.helpers import write_synthetic_map


@pytest.fixture(scope="module")
def npz_paths(tmp_path_factory):
    """Six maps of 300..1300 frames, one with a NaN (both packages drop it)."""
    root = tmp_path_factory.mktemp("npz")
    rng = np.random.default_rng(0)
    for i in range(6):
        n = 300 + 200 * i
        spec = rng.normal(-10, 3, (96, n)).astype(np.float32)
        if i == 4:
            spec[3, 7] = np.nan
        np.savez_compressed(root / f"spec{i}.npz", a=spec)
        np.savez_compressed(root / f"m{i}.map.npz", x=rng.uniform(-1, 1, (6, n)).astype(np.float32),
                            c=rng.uniform(-1, 1, 5).astype(np.float32), spec_path=f"spec{i}.npz")
    return sorted(root.glob("*.map.npz"))


def _assert_same_batches(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        for gv, wv in zip(g, w):
            assert gv.dtype == wv.dtype
            np.testing.assert_array_equal(gv, wv)


@pytest.mark.parametrize("mode,kw", [
    ("subsequence", dict(segment_length=256)),
    ("random-length", dict()),
    ("full-sequence", dict()),
    ("dummy", dict(segment_length=128)),
    ("subsequence", dict(segment_length=256, sample_density=0.5)),
], ids=["subsequence", "random-length", "full-sequence", "dummy", "density"])
def test_batches_match_jax_package(npz_paths, mode, kw, monkeypatch):
    # the random-length crops need maps of at least MIN_LENGTH frames: shrink the class bounds alike
    for module in (JD, D):
        monkeypatch.setattr(module.RandomLengthDataset, "MIN_LENGTH", 200)
        monkeypatch.setattr(module.RandomLengthDataset, "MAX_LENGTH", 600)
    paths = [] if mode == "dummy" else npz_paths
    want = JD.DataPipeline(JD.make_dataset(mode, paths, seed=5, **kw), 2, bucket=64, num_workers=1)
    got = D.DataPipeline(D.make_dataset(mode, paths, seed=5, **kw), 2, bucket=64, num_workers=1)
    _assert_same_batches([next(got) for _ in range(5)], [next(want) for _ in range(5)])  # 10 samples: past one epoch
    assert got.state() == want.state()


def test_worker_count_invariance_and_resume(npz_paths):
    def mk(workers, start=None):
        return D.DataPipeline(D.make_dataset("subsequence", npz_paths, seed=9, segment_length=256), 2, bucket=64,
                              num_workers=workers, start=start)

    one, four = mk(1), mk(4)
    ref = [next(one) for _ in range(6)]
    _assert_same_batches([next(four) for _ in range(6)], ref)

    interrupted = mk(2)
    for _ in range(3):
        next(interrupted)
    want = JD.DataPipeline(JD.make_dataset("subsequence", npz_paths, seed=9, segment_length=256), 2, bucket=64,
                           start=interrupted.state())
    resumed = mk(2, start=interrupted.state())
    tail = [next(resumed) for _ in range(3)]
    _assert_same_batches(tail, ref[3:])
    _assert_same_batches(tail, [next(want) for _ in range(3)])


def test_dummy_dataset_shapes_and_collate():
    ds = D.DummyDataset(num_samples=4, seed=0, min_length=100, max_length=300)
    samples = [s for s in ds]
    assert len(samples) == 4
    for x, a, c in samples:
        assert x.shape[0] == 6 and a.shape[0] == 96 and c.shape == (5,) and 100 <= x.shape[1] == a.shape[1] <= 300
    x, a, c, orig_len = D.collate(samples, bucket=128, pad_to=500)
    assert x.shape == (4, 6, 512) and a.shape == (4, 96, 512) and c.shape == (4, 5)
    assert orig_len.tolist() == [s[0].shape[1] for s in samples]
    n = orig_len[0]
    assert (x[0, :, n:] == D.X_PAD).all() and (a[0, :, n:] == D.A_PAD).all()
    for mode, want in (("subsequence", 4096), ("dummy", 8192)):
        assert D.process_invariant_pad(mode, 4096) == JD.process_invariant_pad(mode, 4096) == want


def test_filter_dataset_and_nan_quarantine(npz_paths):
    assert D.filter_dataset(npz_paths, 800) == JD.filter_dataset(npz_paths, 800)
    assert len(D.filter_dataset(npz_paths, 800)) == 3
    with pytest.raises(ValueError):
        D.load_tensor(npz_paths[4])


def test_segment_star_rating_matches_jax_package(tmp_path):
    """The crop re-rating goes through the port's own codec, beatmap parser and
    numpy difficulty calculator: the same conditioning vector as the JAX
    package's (whose C++ core, when built, is held to its Python one)."""
    from osufusion_tpu.audio.constants import frame_times, normalize_context
    from osufusion_tpu.codec.encode import encode_beatmap
    from osufusion_tpu.osu import Beatmap

    x = encode_beatmap(Beatmap(write_synthetic_map(tmp_path)), frame_times(1600))
    c = normalize_context(np.array([4.0, 8.0, 6.0, 5.0, 9.9], dtype=np.float32))
    got, want = D.get_new_context(x, c), JD.get_new_context(x, c)
    assert got[4] != c[4]
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
