"""Model output -> playable ``.osu`` text.

Capability parity with reference osu_fusion/library/osu/data/decode.py
(studied for behavior, re-designed here): binarize the four hit channels,
recover onset/combo/sustain/slide events, estimate a tempo grid
(autocorrelation BPM + phase-histogram refinement, decode.py:90-123), snap
times to 1/16 beats (:126-130), classify each onset as circle/spinner/slider
with the min-4-frame span rules (:194-212), re-fit slider paths with
least-squares Béziers plus per-slider inherited velocity points (:63-80,
:224-231), and emit an ``.osu`` v14 file.

Design (original to this repo): the decode is staged as
  signal -> event table (vectorized numpy)        _extract_events
         -> TempoGrid (frozen dataclass)          estimate_tempo / TempoGrid.from_bpm
         -> hit-object IR (dataclasses)           _classify_onset
         -> section renderer                      _render_osu
instead of a single string-appending walk.

Fixes over the reference (documented in SURVEY.md "quirks"): a zero-length
slider decodes to a circle only (the reference also emitted a malformed
slider line); object times are written as integer milliseconds (the
reference emitted raw floats its own parser rejects); combo flips that do
not land exactly on an onset frame are ignored instead of crashing.

Invariant (pinned by tests/test_codec.py's fuzz + property tests): the
emitted file ALWAYS re-parses, for arbitrary model output. Slider velocities
are quantized and clamped to what a parser recovers, slider end times mirror
the parser's own float expression bit-for-bit, and onsets starting inside a
previous object's span are dropped. The reference wrote raw out-of-range
velocities and overlapping objects that its own parser then rejected
(reference decode.py:231 vs beatmap.py:137).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple, Union

import numpy as np
from scipy import signal as sp_signal

from osufusion_tpu_torch.codec.encode import BeatmapEncoding
from osufusion_tpu_torch.codec.fit_bezier import fit_bezier, get_segment_length
from osufusion_tpu_torch.codec.hit import decode_extents, decode_flips

BEAT_DIVISOR = 16
SLIDER_MULT = 1.0
MIN_BPM = 1
MAX_BPM = 300
PLAYFIELD = np.array([512.0, 384.0])

# .osu hit-object type bitfield
_TYPE_CIRCLE = 1 << 0
_TYPE_SLIDER = 1 << 1
_TYPE_NEW_COMBO = 1 << 2
_TYPE_SPINNER = 1 << 3

# minimum region length (frames) for a sustain/slide to count as such
_MIN_SPAN_FRAMES = 4


@dataclass
class Metadata:
    audio_filename: str
    title: str
    artist: str
    version: str
    cs: float
    ar: float
    od: float
    hp: float


# --------------------------------------------------------------------------
# Tempo estimation
# --------------------------------------------------------------------------


@dataclass(frozen=True)
class TempoGrid:
    """A beat grid: period + phase, and whether snapping is active."""

    beat_length: float  # ms per beat
    offset: float  # ms phase of beat 0
    snap: bool

    @classmethod
    def free(cls) -> "TempoGrid":
        """No snapping; nominal 200 BPM grid only for the header line."""
        return cls(beat_length=60000.0 / 200.0, offset=0.0, snap=False)

    @classmethod
    def from_beat_length(cls, beat_length: float, hit_times: np.ndarray) -> "TempoGrid":
        """Anchor the grid phase at the densest onset-phase bin."""
        _, offset = _phase_concentration(hit_times, beat_length)
        return cls(beat_length=beat_length, offset=offset, snap=True)

    def snap_time(self, t: float) -> float:
        if not self.snap:
            return t
        tick = self.beat_length / BEAT_DIVISOR
        return round((t - self.offset) / tick) * tick + self.offset

    def header_line(self) -> str:
        # uninherited timing point: offset, beat_length, meter, sampleset,
        # sampleindex, volume, uninherited=1, effects
        return f"{self.offset},{self.beat_length},4,0,0,50,1,0"

    @property
    def base_slider_velocity(self) -> float:
        """Playfield px/ms at SliderMultiplier 1 and SV x1."""
        return SLIDER_MULT * 100.0 / self.beat_length


def _phase_concentration(times: np.ndarray, beat_length: float) -> Tuple[int, float]:
    """(count, left-edge) of the densest of 100 phase bins modulo the beat."""
    hist, edges = np.histogram(times % beat_length, bins=100, range=(0, beat_length))
    k = int(np.argmax(hist))
    return int(hist[k]), float(edges[k])


def _refine_bpm(hit_times: np.ndarray, coarse_bpm: float, n_candidates: int = 1000) -> float:
    """Pick the BPM in ±5% of the coarse guess whose beat grid concentrates
    the most onsets into a single 1%-of-beat phase bin (fully vectorized)."""
    candidates = np.linspace(coarse_bpm * 0.95, coarse_bpm * 1.05, n_candidates)
    beat_lengths = 60000.0 / candidates  # (C,)
    # bin index of every (candidate, onset) pair in one shot
    phase = hit_times[None, :] % beat_lengths[:, None]
    bins = np.minimum((phase * (100.0 / beat_lengths[:, None])).astype(np.int64), 99)
    flat = (bins + 100 * np.arange(n_candidates)[:, None]).ravel()
    counts = np.bincount(flat, minlength=100 * n_candidates).reshape(n_candidates, 100)
    return float(candidates[int(np.argmax(counts.max(axis=1)))])


def estimate_tempo(hit_times: np.ndarray, verbose: bool = True) -> TempoGrid:
    """Autocorrelation tempo detector over the onset sequence.

    The lag spectrum of inter-onset gaps peaks at the beat period (and its
    multiples); the strongest peak inside the [MIN_BPM, MAX_BPM] band seeds a
    ±5% refinement scored by phase concentration.
    """
    gaps = np.diff(hit_times)
    lags = sp_signal.correlate(gaps, gaps, mode="full")
    lags = lags[lags.shape[0] // 2 :]  # non-negative lags only

    period_band = (60000.0 / MAX_BPM, 60000.0 / MIN_BPM)
    peaks, _ = sp_signal.find_peaks(lags, distance=period_band[0])
    peaks = peaks[(peaks >= period_band[0] * 0.95) & (peaks <= period_band[1] * 1.05)]
    if peaks.size == 0:
        if verbose:
            print("Warning: no valid BPM found within the range, disabling beat snap")
        return TempoGrid.free()

    coarse_bpm = 60000.0 / float(peaks[np.argmax(lags[peaks])])
    best_bpm = _refine_bpm(hit_times, coarse_bpm)
    return TempoGrid.from_beat_length(60000.0 / best_bpm, hit_times)


# --------------------------------------------------------------------------
# Signal -> event table
# --------------------------------------------------------------------------


@dataclass(frozen=True)
class OnsetEvents:
    """Per-onset decode table (frame indices; -1 where a region is absent)."""

    frames: np.ndarray  # (K,) int
    new_combo: np.ndarray  # (K,) bool
    sustain_end: np.ndarray  # (K,) int
    slide_end: np.ndarray  # (K,) int


def _ends_by_onset(onsets: np.ndarray, starts: Sequence[int], ends: Sequence[int]) -> np.ndarray:
    """Scatter each region's end frame onto the onset whose frame equals the
    region's start frame; onsets with no region get -1."""
    out = np.full(onsets.shape, -1, dtype=np.int64)
    n_regions = min(len(starts), len(ends))  # a trailing start may lack its end
    if n_regions == 0 or onsets.size == 0:
        return out
    starts_arr = np.asarray(starts[:n_regions], dtype=np.int64)
    ends_arr = np.asarray(ends[:n_regions], dtype=np.int64)
    pos = np.searchsorted(onsets, starts_arr)
    in_range = pos < onsets.size
    exact = np.zeros_like(in_range)
    exact[in_range] = onsets[pos[in_range]] == starts_arr[in_range]
    out[pos[exact]] = ends_arr[exact]
    return out


def _extract_events(hit_channels: np.ndarray) -> OnsetEvents:
    """Binarized (4, T) hit channels -> per-onset event table."""
    onsets = np.asarray(decode_flips(hit_channels[BeatmapEncoding.HIT]), dtype=np.int64)
    combo_frames = np.asarray(decode_flips(hit_channels[BeatmapEncoding.COMBO]), dtype=np.int64)
    return OnsetEvents(
        frames=onsets,
        new_combo=np.isin(onsets, combo_frames),
        sustain_end=_ends_by_onset(onsets, *decode_extents(hit_channels[BeatmapEncoding.SUSTAIN])),
        slide_end=_ends_by_onset(onsets, *decode_extents(hit_channels[BeatmapEncoding.SLIDER])),
    )


# --------------------------------------------------------------------------
# Hit-object IR
# --------------------------------------------------------------------------


def _combo_bit(new_combo: bool) -> int:
    return _TYPE_NEW_COMBO if new_combo else 0


@dataclass(frozen=True)
class CircleIR:
    t: int
    x: int
    y: int
    new_combo: bool

    def object_line(self) -> str:
        return f"{self.x},{self.y},{self.t},{_TYPE_CIRCLE + _combo_bit(self.new_combo)},0,0:0:0:0:"

    def end_time(self) -> int:
        return self.t


@dataclass(frozen=True)
class SpinnerIR:
    t: int
    end_t: int
    new_combo: bool

    def object_line(self) -> str:
        return f"256,192,{self.t},{_TYPE_SPINNER + _combo_bit(self.new_combo)},0,{self.end_t}"

    def end_time(self) -> int:
        return self.end_t


@dataclass(frozen=True)
class SliderIR:
    t: int
    end_t: int  # effective end under the parsed (quantized + clamped) velocity
    anchors: Tuple[Tuple[int, int], ...]  # rounded control points, head first
    length: float  # px, one slide
    slides: int
    new_combo: bool
    sv: float  # slider-velocity multiplier, already quantized to what a parser recovers
    clamped: bool  # True if the natural velocity fell outside the [0.1, 10] SV range

    def object_line(self) -> str:
        head_x, head_y = self.anchors[0]
        path = "|".join(f"{x}:{y}" for x, y in self.anchors[1:])
        return (
            f"{head_x},{head_y},{self.t},{_TYPE_SLIDER + _combo_bit(self.new_combo)},0,"
            f"B|{path},{self.slides},{self.length}"
        )

    def end_time(self) -> int:
        return self.end_t

    def velocity_line(self, grid: TempoGrid, verbose: bool) -> str:
        """Inherited timing point setting this slider's velocity.

        ``sv`` is already the value a parser recovers (round-3-decimals +
        clamp to [0.1, 10], the osu! SV rules), and ``end_t`` was recomputed
        from it, so the emitted file is self-consistent: the slider a parser
        reconstructs spans exactly [t, end_t]. The reference wrote the raw
        (possibly out-of-range) velocity and only warned (ref decode.py:231),
        producing sliders up to 13x longer than intended once the reader
        clamps — overlapping later objects its own parser then rejects.
        """
        if verbose and self.clamped:
            print(f"Warning: slider at {self.t} needed an out-of-range velocity; clamped to {self.sv}")
        return f"{self.t},{-100.0 / self.sv},4,0,0,50,0,0"


HitObjectIR = Union[CircleIR, SpinnerIR, SliderIR]


def fit_slider_path(points: np.ndarray, max_err: float = 50.0) -> Tuple[float, List[Tuple[int, int]]]:
    """Least-squares piecewise-Bézier fit of one slide's cursor trace.

    Returns (pixel length, rounded anchor list). Anchors concatenate all
    fitted segments' control points, so consecutive segments share their
    join anchor twice — the .osu red-anchor convention.
    """
    anchors: List[Tuple[int, int]] = []
    total_length = 0.0
    for segment in fit_bezier(points, max_err=max_err):
        segment = segment.round()
        anchors.extend((int(px), int(py)) for px, py in segment)
        total_length += get_segment_length(segment)
    return total_length, anchors


def _classify_onset(
    k: int,
    events: OnsetEvents,
    cursor_xy: np.ndarray,  # (T, 2) playfield px
    frame_times: np.ndarray,
    grid: TempoGrid,
) -> HitObjectIR:
    """Decide what hit object onset ``k`` is and build its IR."""
    frame = int(events.frames[k])
    new_combo = bool(events.new_combo[k])
    sustain_end = int(events.sustain_end[k])
    slide_end = int(events.slide_end[k])

    t = grid.snap_time(float(frame_times[frame]))
    u = grid.snap_time(float(frame_times[sustain_end]))
    # .osu v14 stores times as integer milliseconds (the reference emitted
    # raw floats here, producing files its own parser rejects)
    t, u = int(round(t)), int(round(u))

    x, y = (int(v) for v in cursor_xy[frame].round())
    circle = CircleIR(t, x, y, new_combo)

    if sustain_end < 0 or sustain_end - frame < _MIN_SPAN_FRAMES:
        return circle  # no sustain, or too short to mean anything
    if slide_end < 0:
        return SpinnerIR(t, u, new_combo)  # held but motionless
    if slide_end - frame < _MIN_SPAN_FRAMES:
        return circle  # slide region too short

    slides = max(1, round((sustain_end - frame) / (slide_end - frame)))
    first_slide_stop = round(frame + (sustain_end - frame) / slides)
    length, anchors = fit_slider_path(cursor_xy[frame : first_slide_stop + 1])
    if length == 0 or u <= t:
        return circle  # degenerate path (reference also emitted a bad slider line)
    # Velocity that spans [t, u] — quantized and clamped exactly as a parser
    # will recover it (round to 3 decimals, clip to the osu! SV range), then
    # the end time recomputed from the quantized value so the written file is
    # self-consistent (see SliderIR.velocity_line).
    sv_exact = length * slides / (u - t) / grid.base_slider_velocity
    sv = float(min(10.0, max(0.1, round(sv_exact, 3))))
    # Mirror the parser's end-time float expression bit-for-bit
    # (beatmap.py _read_slider -> Slider.slide_duration -> end_time): the
    # written length / beat_length / sv all round-trip exactly through the
    # file text, so computing the same ops in the same order makes the
    # decoder's span identical to the span its own parser reconstructs —
    # no tolerance needed at either end.
    slide_duration = length / ((SLIDER_MULT * sv) * 100) * grid.beat_length
    u_eff = int(t + slide_duration * slides)
    clamped = not (0.1 <= round(sv_exact, 3) <= 10.0)
    return SliderIR(t, u_eff, tuple(anchors), length, slides, new_combo, sv, clamped)


# --------------------------------------------------------------------------
# Rendering
# --------------------------------------------------------------------------


def _render_osu(metadata: Metadata, timing_lines: Sequence[str], object_lines: Sequence[str]) -> str:
    sections: List[Tuple[str, List[str]]] = [
        (
            "General",
            [f"AudioFilename: {metadata.audio_filename}", "AudioLeadIn: 0", "Mode: 0"],
        ),
        (
            "Metadata",
            [
                f"Title: {metadata.title}",
                f"TitleUnicode: {metadata.title}",
                f"Artist: {metadata.artist}",
                f"ArtistUnicode: {metadata.artist}",
                "Creator: OsuFusion",
                f"Version: {metadata.version}",
                "Tags: OsuFusion",
            ],
        ),
        (
            "Difficulty",
            [
                f"HPDrainRate: {metadata.hp}",
                f"CircleSize: {metadata.cs}",
                f"OverallDifficulty: {metadata.od}",
                f"ApproachRate: {metadata.ar}",
                "SliderMultiplier: 1",
                "SliderTickRate: 1",
            ],
        ),
        ("TimingPoints", list(timing_lines)),
        ("HitObjects", list(object_lines)),
    ]
    out = ["osu file format v14"]
    for name, lines in sections:
        out.append("")
        out.append(f"[{name}]")
        out.extend(lines)
    return "\n".join(out) + "\n"


# --------------------------------------------------------------------------
# Entry point
# --------------------------------------------------------------------------


def decode_beatmap(
    metadata: Metadata,
    encoded_beatmap: np.ndarray,
    frame_times: np.ndarray,
    bpm: Optional[float] = None,
    allow_beat_snap: bool = True,
    verbose: bool = True,
) -> str:
    """Decode a (6, T) signal tensor into ``.osu`` v14 text."""
    hit_channels = np.where(encoded_beatmap[: BeatmapEncoding.CURSOR_X] > 0, 1.0, -1.0)
    cursor_xy = ((encoded_beatmap[[BeatmapEncoding.CURSOR_X, BeatmapEncoding.CURSOR_Y]].T + 1) / 2) * PLAYFIELD

    events = _extract_events(hit_channels)
    hit_times = frame_times[events.frames]

    if bpm is not None:
        grid = TempoGrid.from_beat_length(60000.0 / bpm, hit_times)
    elif allow_beat_snap:
        grid = estimate_tempo(hit_times, verbose)
    else:
        grid = TempoGrid.free()

    timing_lines = [grid.header_line()]
    object_lines: List[str] = []
    # An onset that starts inside the previous object's span (e.g. a circle
    # while a spinner is still held — which an untrained/noisy model emits
    # freely) produces a file the beatmap parser rejects. The reference
    # emitted such lines anyway (reference decode.py:185-224 vs its own
    # parser check, beatmap.py:137); we drop them so decoded output always
    # re-parses.
    prev_end = -(10**9)
    dropped = 0
    for k in range(events.frames.size):
        ir = _classify_onset(k, events, cursor_xy, frame_times, grid)
        if ir.t < prev_end:
            dropped += 1
            continue
        prev_end = ir.end_time()
        object_lines.append(ir.object_line())
        if isinstance(ir, SliderIR):
            timing_lines.append(ir.velocity_line(grid, verbose))
    if dropped and verbose:
        print(f"Warning: dropped {dropped} onset(s) overlapping a previous object's span")

    return _render_osu(metadata, timing_lines, object_lines)
