"""Host-side input pipeline: npz shard datasets, augmentation, bucketed
padding collation, and a checkpointable worker-pool pipeline.

Capability parity with reference osu_fusion/library/{dataset,augment}.py and
trainer.py's collate (:74-95): the same four dataset modes (full-sequence
<= 65536, random-length 2048-8192, fixed subsequence 4096, dummy), NaN
rejection, per-segment star-rating recompute (reference dataset.py:40-69,
default ON :75), sample-density subsampling, cursor-flip augmentation with
p=0.5 each axis, per-epoch reshuffle, and padding with x=-1 / a=-23 emitting
``orig_len``.

TPU-first differences:
- batch lengths are padded up to a BUCKET multiple (default 1024) instead of
  the exact batch max: XLA compiles one program per bucket instead of one per
  length, bounding recompiles (SURVEY.md "hard parts" #1);
- all randomness is POSITIONAL: sample ``i`` of epoch ``e`` is a pure function
  of ``(seed, e, i)``, the host-side analog of JAX's stateless PRNG. The
  pipeline's resume state is therefore just ``{"epoch", "index"}`` — no RNG
  blobs to serialize (the reference checkpoints torch RNG state instead,
  trainer.py:148-177) — and any worker schedule reproduces identical batches;
- ``DataPipeline`` runs ``num_workers`` threads over positions and reorders
  results, replacing the reference's DataLoader worker processes
  (trainer.py:254-262): the per-sample work (npz decode, segment-SR rating)
  is numpy/native code that releases the GIL, so threads overlap host prep
  with device steps without fork overhead.
"""

from __future__ import annotations

import random
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from osufusion_tpu_torch.audio.constants import AUDIO_DIM, CONTEXT_DIM
from osufusion_tpu_torch.codec.encode import BeatmapEncoding, TOTAL_DIM

X_PAD = -1.0
A_PAD = -23.0
BUCKET = 1024

Sample = Tuple[np.ndarray, np.ndarray, np.ndarray]  # x (6,N), a (96,N), c (5,)
Batch = Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]  # + orig_len (B,)


def flip_cursor_horizontal(x: np.ndarray) -> np.ndarray:
    x = x.copy()
    x[BeatmapEncoding.CURSOR_X] = -x[BeatmapEncoding.CURSOR_X]
    return x


def flip_cursor_vertical(x: np.ndarray) -> np.ndarray:
    x = x.copy()
    x[BeatmapEncoding.CURSOR_Y] = -x[BeatmapEncoding.CURSOR_Y]
    return x


def get_new_context(x: np.ndarray, c: np.ndarray) -> np.ndarray:
    """Re-rate a cropped segment: decode it to .osu text and recompute star
    rating for the conditioning vector (reference dataset.py:40-69), with the
    numpy difficulty calculator (the JAX package's C++ core is not ported).
    Failure containment
    (SURVEY.md section 5.3): an undecodable segment keeps its original
    conditioning instead of killing the input pipeline."""
    import tempfile

    from osufusion_tpu_torch.audio.constants import frame_times, normalize_context, unnormalize_context
    from osufusion_tpu_torch.codec.decode import Metadata, decode_beatmap
    from osufusion_tpu_torch.osu.beatmap import Beatmap
    from osufusion_tpu_torch.osu.difficulty import calculate_star_rating

    cs, ar, od, hp, _ = unnormalize_context(c).tolist()
    ft = frame_times(x.shape[-1])
    meta = Metadata("", "Dummy", "Dummy", "OsuFusion", cs, ar, od, hp)
    try:
        segment_osu = decode_beatmap(meta, x, ft, bpm=None, allow_beat_snap=False, verbose=False)
        with tempfile.TemporaryDirectory() as d:
            p = Path(d) / "segment.osu"
            p.write_text(segment_osu, encoding="utf-8")
            sr = calculate_star_rating(Beatmap(p))
    except Exception:
        return c

    return normalize_context(np.array([cs, ar, od, hp, min(max(sr, 0.0), 20.0)], dtype=np.float32))


def load_tensor(map_file: Path) -> Sample:
    """npz shard -> float32 arrays with NaN quarantine (reference dataset.py:25-37)."""
    map_data = np.load(map_file)
    audio_file = map_file.parent / str(map_data["spec_path"])
    audio_data = np.load(audio_file)
    x = map_data["x"].astype(np.float32)
    c = map_data["c"].astype(np.float32)
    a = audio_data["a"].astype(np.float32)
    if np.isnan(x).any() or np.isnan(a).any() or np.isnan(c).any():
        raise ValueError("Invalid values in map file")
    n = min(x.shape[-1], a.shape[-1])
    return x[..., :n], a[..., :n], c


def filter_dataset(paths: Sequence[Path], max_length: int) -> List[Path]:
    """Drop maps longer than max_length (reference trainer.py:42-48)."""
    kept = []
    for p in paths:
        try:
            with np.load(p) as d:
                if d["x"].shape[-1] <= max_length:
                    kept.append(p)
        except Exception:
            continue
    return kept


class StreamDataset:
    """Iterable over map shards with augmentation and per-epoch reshuffle.

    Positional randomness: every draw is derived from ``(seed, epoch, index)``
    via a SeedSequence, never from mutable RNG state — so position (e, i) is
    reproducible in isolation, which is what makes the pipeline resumable and
    worker-order independent.
    """

    def __init__(
        self,
        dataset: Sequence[Path],
        sample_density: float = 1.0,
        segment_sr: bool = False,
        flip_horizontal_prob: float = 0.5,
        flip_vertical_prob: float = 0.5,
        seed: int = 0,
    ) -> None:
        if not (0 < sample_density <= 1):
            raise ValueError("sample_density must be between 0 and 1")
        self.dataset = list(dataset)
        self.sample_density = sample_density
        self.segment_sr = segment_sr
        self.flip_horizontal_prob = flip_horizontal_prob
        self.flip_vertical_prob = flip_vertical_prob
        self.seed = seed
        self.epoch = 0
        self.index = 0

    def _rng(self, *salt: int) -> random.Random:
        ss = np.random.SeedSequence([self.seed & 0x7FFFFFFF, *salt])
        return random.Random(int(ss.generate_state(1, np.uint64)[0]))

    def epoch_order(self, epoch: int) -> List[Path]:
        """The (density-subsampled) shuffled map order of one epoch."""
        rng = self._rng(epoch)
        return rng.sample(self.dataset, int(len(self.dataset) * self.sample_density))

    def materialize(self, map_file: Path, epoch: int, index: int) -> List[Sample]:
        """All samples at one epoch position, with segment-SR + flips applied.
        Pure in (seed, epoch, index, file contents) — safe to run on any
        worker thread in any order."""
        rng = self._rng(epoch, index)
        out: List[Sample] = []
        for x, a, c in self.sample_stream(map_file, rng):
            if self.segment_sr:
                c = get_new_context(x, c)
            if rng.random() < self.flip_horizontal_prob:
                x = flip_cursor_horizontal(x)
            if rng.random() < self.flip_vertical_prob:
                x = flip_cursor_vertical(x)
            out.append((x, a, c))
        return out

    def sample_stream(self, map_file: Path, rng: random.Random) -> Iterator[Sample]:
        raise NotImplementedError

    def __iter__(self) -> Iterator[Sample]:
        order = self.epoch_order(self.epoch)
        while self.index < len(order):
            yield from self.materialize(order[self.index], self.epoch, self.index)
            self.index += 1
        self.epoch += 1
        self.index = 0

    def __len__(self) -> int:
        return len(self.dataset)


class DummyDataset(StreamDataset):
    """Synthetic random tensors with realistic shapes (reference dataset.py:118-131)."""

    MIN_LENGTH = 2048
    MAX_LENGTH = 8192

    def __init__(self, num_samples: int = 64, seed: int = 0, min_length: int = None, max_length: int = None) -> None:
        super().__init__([Path(f"dummy_{i}") for i in range(num_samples)], seed=seed)
        self.min_length = min_length or self.MIN_LENGTH
        self.max_length = max_length or self.MAX_LENGTH

    def sample_stream(self, _: Path, rng: random.Random) -> Iterator[Sample]:
        length = rng.randint(self.min_length, self.max_length)
        np_rng = np.random.default_rng(rng.getrandbits(63))
        x = np_rng.standard_normal((TOTAL_DIM, length), dtype=np.float32)
        a = np_rng.standard_normal((AUDIO_DIM, length), dtype=np.float32)
        c = np_rng.standard_normal(CONTEXT_DIM).astype(np.float32)
        yield x, a, c


class FullSequenceDataset(StreamDataset):
    MAX_LENGTH = 65536

    def sample_stream(self, map_file: Path, rng: random.Random) -> Iterator[Sample]:
        try:
            x, a, c = load_tensor(map_file)
        except ValueError:
            return
        if x.shape[-1] > self.MAX_LENGTH:
            return
        yield x[..., : self.MAX_LENGTH], a[..., : self.MAX_LENGTH], c


class RandomLengthDataset(StreamDataset):
    MIN_LENGTH = 2048
    MAX_LENGTH = 8192

    def sample_stream(self, map_file: Path, rng: random.Random) -> Iterator[Sample]:
        try:
            x, a, c = load_tensor(map_file)
        except ValueError:
            return
        n = x.shape[-1]
        if n < self.MIN_LENGTH:
            return
        length = rng.randint(self.MIN_LENGTH, min(self.MAX_LENGTH, n))
        start = rng.randint(0, n - length)
        yield x[..., start : start + length], a[..., start : start + length], c


class SubsequenceDataset(StreamDataset):
    def __init__(self, *args, sequence_length: int = 4096, **kwargs) -> None:
        super().__init__(*args, **kwargs)
        self.sequence_length = sequence_length

    def sample_stream(self, map_file: Path, rng: random.Random) -> Iterator[Sample]:
        try:
            x, a, c = load_tensor(map_file)
        except ValueError:
            return
        n = x.shape[-1]
        if self.sequence_length > n:
            return
        start = rng.randint(0, n - self.sequence_length)
        yield x[..., start : start + self.sequence_length], a[..., start : start + self.sequence_length], c


def collate(batch: Sequence[Sample], bucket: int = BUCKET, pad_to: Optional[int] = None) -> Batch:
    """Pad each sample to the batch's bucket-rounded max length.

    x pads with -1 (silence signal), a with -23 (log-VQT silence); returns
    ``orig_len`` for loss masking (reference trainer.py:74-95). Bucketing the
    padded length bounds the number of distinct shapes XLA sees.

    ``pad_to`` raises the padding target to a fixed minimum. Multi-host runs
    REQUIRE it for variable-length dataset modes: each process collates its
    own stripe of samples, so a batch-local max would diverge across hosts
    and the processes would compile mismatched programs (then hang in the
    first collective). See ``process_invariant_pad``.
    """
    max_len = max(x.shape[-1] for x, _, _ in batch)
    if pad_to is not None:
        max_len = max(max_len, pad_to)
    target = ((max_len + bucket - 1) // bucket) * bucket

    out_x = np.full((len(batch), TOTAL_DIM, target), X_PAD, dtype=np.float32)
    out_a = np.full((len(batch), AUDIO_DIM, target), A_PAD, dtype=np.float32)
    out_c = np.zeros((len(batch), CONTEXT_DIM), dtype=np.float32)
    orig_len = np.zeros(len(batch), dtype=np.int32)

    for i, (x, a, c) in enumerate(batch):
        n = x.shape[-1]
        out_x[i, :, :n] = x
        out_a[i, :, :n] = a
        out_c[i] = c
        orig_len[i] = n
    return out_x, out_a, out_c, orig_len


def process_invariant_pad(mode: str, segment_length: int, max_length: int = 0) -> Optional[int]:
    """The fixed padding target that makes every host collate identical shapes.

    Multi-host feeding (parallel/distributed.py) assembles the global batch
    from per-process stripes; the batch SHAPE must therefore be a pure
    function of the dataset mode, never of which samples landed on which
    host. Returns the mode's length cap (bucket-rounding happens in
    ``collate``): the fixed ``subsequence`` crop already satisfies the
    invariant for free, while the variable-length modes pay padding up to
    their cap — correctness over per-batch shape thrift.
    """
    if mode == "subsequence":
        return segment_length
    if mode == "random-length":
        cap = RandomLengthDataset.MAX_LENGTH
    elif mode == "full-sequence":
        cap = FullSequenceDataset.MAX_LENGTH
    elif mode == "dummy":
        cap = segment_length * 2  # make_dataset's dummy max_length
    else:
        raise ValueError(f"unknown dataset mode: {mode}")
    if max_length > 0:
        cap = min(cap, max_length)
    return cap


class DataPipeline:
    """Infinite, checkpointable, worker-parallel batch stream.

    ``num_workers`` threads materialize epoch positions ahead of the consumer
    (reference DataLoader workers, trainer.py:254-262); results are consumed
    in position order, so the stream is identical for any worker count.
    Because sample randomness is positional, the full resume state is
    ``state() == {"epoch": e, "index": i}``: reconstruct the pipeline with
    ``start=state`` and the next batch matches an uninterrupted run
    (reference saves torch RNG blobs instead, trainer.py:148-177).
    """

    def __init__(
        self,
        dataset: StreamDataset,
        batch_size: int,
        bucket: int = BUCKET,
        num_workers: int = 1,
        depth: int = 4,
        start: Optional[Dict[str, int]] = None,
        shard: Tuple[int, int] = (0, 1),
        pad_to: Optional[int] = None,
    ) -> None:
        self.dataset = dataset
        self.batch_size = batch_size
        self.bucket = bucket
        self.pad_to = pad_to
        # multi-host stripe: process p of n consumes positions i with
        # i % n == p of the SAME deterministic position stream — the analog of
        # the reference's per-process DataLoader shard (dataset.py:88-103).
        # Sample (epoch, i) is positionally random, so its content is
        # identical whether produced by a sharded or unsharded pipeline.
        self.shard_id, self.num_shards = shard
        assert 0 <= self.shard_id < self.num_shards
        start = start or {"epoch": dataset.epoch, "index": dataset.index}
        self._state = dict(start)
        self._next_state = dict(start)
        self._executor = ThreadPoolExecutor(max_workers=max(1, num_workers))
        self._window = max(2 * max(1, num_workers), depth * batch_size)
        self._futures: deque = deque()
        self._positions = self._position_stream(start["epoch"], start["index"])
        self._buf: List[Sample] = []

    def _position_stream(self, epoch: int, index: int):
        while True:
            order = self.dataset.epoch_order(epoch)
            while index < len(order):
                if index % self.num_shards == self.shard_id:
                    yield epoch, index, order[index]
                index += 1
            epoch += 1
            index = 0

    def state(self) -> Dict[str, int]:
        """Resume position covering every batch handed out so far."""
        return dict(self._state)

    def __iter__(self) -> Iterator[Batch]:
        return self

    def __next__(self) -> Batch:
        while True:
            while len(self._futures) < self._window:
                epoch, index, map_file = next(self._positions)
                fut = self._executor.submit(self.dataset.materialize, map_file, epoch, index)
                self._futures.append((epoch, index, fut))
            epoch, index, fut = self._futures.popleft()
            produced = fut.result()
            # exact-resume invariant: state() is {epoch, index} ONLY, so a
            # position may contribute at most one sample — a multi-sample
            # materialize would need a within-position offset in state() to
            # avoid dropping/duplicating buffered samples across resume
            assert len(produced) <= 1, (
                f"materialize({index}) produced {len(produced)} samples; "
                "DataPipeline's resume state assumes at most one per position"
            )
            self._buf.extend(produced)
            self._next_state = {"epoch": epoch, "index": index + 1}
            if len(self._buf) >= self.batch_size:
                batch = collate(self._buf[: self.batch_size], self.bucket, self.pad_to)
                self._buf = self._buf[self.batch_size :]
                # a position yields at most one sample in every dataset mode,
                # so the buffer is empty here and _next_state is exact
                self._state = dict(self._next_state)
                return batch


def make_dataset(
    mode: str,
    paths: Sequence[Path],
    seed: int = 0,
    segment_length: int = 4096,
    segment_sr: bool = False,
    sample_density: float = 1.0,
) -> StreamDataset:
    if mode == "dummy":
        # mirror the reference's "1/2x to 2x of context" dummy lengths, scaled
        # to the configured segment length so smoke runs stay small; dummy
        # tensors are random noise, so segment-SR re-rating is meaningless
        return DummyDataset(seed=seed, min_length=segment_length // 2, max_length=segment_length * 2)
    kw = dict(seed=seed, segment_sr=segment_sr, sample_density=sample_density)
    if mode == "full-sequence":
        return FullSequenceDataset(paths, **kw)
    if mode == "random-length":
        return RandomLengthDataset(paths, **kw)
    if mode == "subsequence":
        return SubsequenceDataset(paths, sequence_length=segment_length, **kw)
    raise ValueError(f"unknown dataset mode: {mode}")
