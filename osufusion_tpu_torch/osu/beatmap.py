""".osu beatmap (v14 text format) parser and corpus iterators.

Capability parity with reference osu_fusion/library/osu/beatmap.py (section
parse, timing points with inherited-SV handling, bitfield hit-object dispatch,
active-timing-point lookup with +/-1 ms tolerance, ground-truth cursor,
corpus iterators), implemented independently:

- the text format is tokenized into a flat ``(section, payload)`` record
  stream first; typed readers consume the records they care about;
- timing points decode in two passes — raw rows, then a stateful fold that
  tracks the effective (beat length, SV, meter) — instead of interleaving
  parse and dedup;
- the cursor model is UNIFIED: every hit object is reduced to a "busy phase"
  (duration + position function) and an idle anchor, and one glide rule
  interpolates from the anchor to the next object's head. The three per-type
  branches of the reference collapse into ``_busy_span``/``_busy_pos``;
- active-object and active-timing-point lookups run on cached numpy arrays
  via ``searchsorted``.

Note: the reference's ``parse_events`` compares a string against int 2 and so
never collects events (beatmap.py:150); we parse break events correctly
instead (documented fix, SURVEY.md section "quirks").
"""

from __future__ import annotations

from pathlib import Path
from typing import Any, Dict, Generator, Iterable, List, Optional, Tuple

import numpy as np

from osufusion_tpu_torch.osu.hit_objects import Circle, HitObject, Slider, Spinner, TimingPoint
from osufusion_tpu_torch.osu.sliders import from_control_points

CX, CY = 256, 192

# hit-object type bitfield (osu!wiki file format spec)
BIT_CIRCLE, BIT_SLIDER, BIT_NEW_COMBO, BIT_SPINNER = 1, 2, 4, 8

_LIST_SECTIONS = frozenset({"Events", "TimingPoints", "HitObjects"})


# ----------------------------------------------------------------- tokenizer


def _records(lines: Iterable[str]) -> Generator[Tuple[str, str], None, None]:
    """Flatten the INI-ish file into (section, payload) records. Comments are
    dropped, blank lines close the current section."""
    section = ""
    for raw in lines:
        if raw.startswith("//"):
            continue
        line = raw.strip()
        if not line:
            section = ""
            continue
        if line[0] == "[" and line[-1] == "]":
            section = line[1:-1]
            yield section, ""
            continue
        if section:
            yield section, line


def _split_sections(lines: Iterable[str]) -> Dict[str, Any]:
    """Group records per section: list sections keep raw lines, the rest
    become key->value dicts (``Key : value`` rows; malformed rows dropped)."""
    out: Dict[str, Any] = {}
    for section, payload in _records(lines):
        bucket = out.setdefault(section, [] if section in _LIST_SECTIONS else {})
        if payload == "":
            continue
        if isinstance(bucket, list):
            bucket.append(payload)
        else:
            key, sep, value = payload.partition(":")
            if sep and key.rstrip().isidentifier():
                bucket[key.rstrip()] = value.strip()
    return out


# ------------------------------------------------------------- timing points


def _fold_timing_rows(lines: List[str]) -> Tuple[List[TimingPoint], List[TimingPoint]]:
    """Decode TimingPoints rows into (all_points, uninherited_points).

    Effective state (beat length / SV / meter) folds across rows: red
    (uninherited) rows reset SV to 1.0 and set the beat length; green rows
    set SV = -100/value clamped to [0.1, 10]. Green rows before any red row
    are meaningless and skipped; a green row at the time of the previous
    point REPLACES it (osu! applies the later row); exact consecutive
    duplicates are compressed.
    """
    points: List[TimingPoint] = []
    bare: List[TimingPoint] = []  # SV/kiai-free stream of the same rows
    beat_length: Optional[float] = None
    meter: Optional[float] = None

    for line in lines:
        cols = [float(c) for c in line.split(",")]
        t = int(cols[0])
        kiai = len(cols) >= 8 and int(cols[7]) & 1 == 1
        is_red = len(cols) < 7 or cols[6] != 0

        if is_red:
            beat_length, meter = cols[1], cols[2]
            sv = 1.0
        else:
            if beat_length is None:
                continue  # green point before the first red one: undefined
            sv = float(np.clip(round(-100.0 / cols[1], 3), 0.1, 10.0))
            if points and points[-1].t == t:
                points.pop()  # the later row at the same timestamp wins

        for stream, tp in (
            (points, TimingPoint(t, beat_length, sv, meter, kiai)),
            (bare, TimingPoint(t, beat_length, None, meter, None)),
        ):
            if not stream or tp != stream[-1]:
                stream.append(tp)

    if not points:
        raise ValueError("no timing points found")
    return points, bare


# --------------------------------------------------------------- hit objects


def _read_circle(cols: List[str], t: int, combo: bool, _bm: "Beatmap") -> Circle:
    return Circle(t, combo, int(float(cols[0])), int(float(cols[1])))


def _read_spinner(cols: List[str], t: int, combo: bool, _bm: "Beatmap") -> Spinner:
    return Spinner(t, combo, int(cols[5]))


def _read_slider(cols: List[str], t: int, combo: bool, bm: "Beatmap") -> Slider:
    head = np.array([float(cols[0]), float(cols[1])])
    curve_spec, slides, length = cols[5], int(cols[6]), float(cols[7])
    knots = [head] + [
        np.array([float(v) for v in pt.split(":")]) for pt in curve_spec.split("|")[1:]
    ]
    tp = bm.get_active_timing_point(t)
    return from_control_points(
        t, tp.beat_length, bm.slider_multiplier * tp.slider_multiplier, combo, slides, length, knots
    )


def _decode_hit_objects(lines: List[str], bm: "Beatmap") -> List[HitObject]:
    readers = ((BIT_CIRCLE, _read_circle), (BIT_SLIDER, _read_slider), (BIT_SPINNER, _read_spinner))
    out: List[HitObject] = []
    for line in lines:
        cols = line.split(",")
        t, kind = int(float(cols[2])), int(float(cols[3]))
        reader = next((fn for bit, fn in readers if kind & bit), None)
        if reader is None:
            continue
        ho = reader(cols, t, bool(kind & BIT_NEW_COMBO), bm)
        # strict check; exactly-abutting objects (t == end) are accepted.
        # decode_beatmap guarantees its output satisfies this by recomputing
        # each slider's end time with this parser's own float expression.
        if out and ho.t < out[-1].end_time():
            raise ValueError(f"hit objects not in chronological order: {ho.t} < {out[-1].end_time()}")
        out.append(ho)
    if not out:
        raise ValueError("no hit objects found")
    return out


# ------------------------------------------------------------ cursor model


def _busy_span(ho: HitObject) -> float:
    """How long the cursor is pinned to the object after its start time."""
    if isinstance(ho, Slider):
        return ho.slide_duration * ho.slides
    if isinstance(ho, Spinner):
        return ho.u - ho.t
    return 0.0


def _busy_pos(ho: HitObject, rel: float) -> np.ndarray:
    """Cursor position ``rel`` ms into the busy phase."""
    if isinstance(ho, Slider):
        if ho.slide_duration <= 0.0:  # zero-pixel-length slider: cursor sits on its head
            return np.asarray(ho.lerp(0.0), dtype=float)
        # ping-pong over the path: slide k alternates direction
        phase = (rel / ho.slide_duration) % 2.0
        return np.asarray(ho.lerp(phase if phase <= 1.0 else 2.0 - phase), dtype=float)
    if isinstance(ho, Spinner):
        return np.array([CX, CY], dtype=float)
    return np.array([ho.x, ho.y], dtype=float)


def _idle_anchor(ho: HitObject) -> np.ndarray:
    """Where the cursor rests once the object is finished."""
    if isinstance(ho, Slider):
        return np.asarray(ho.lerp(ho.slides % 2), dtype=float)
    if isinstance(ho, Spinner):
        return np.array([CX, CY], dtype=float)
    return np.array([ho.x, ho.y], dtype=float)


# ------------------------------------------------------------------ Beatmap


class Beatmap:
    def __init__(self, filename: Path, meta_only: bool = False) -> None:
        self.filename = Path(filename)

        self.timing_points: List[TimingPoint] = []
        self.uninherited_timing_points: List[TimingPoint] = []
        self.hit_objects: List[HitObject] = []
        self.events: List[List[str]] = []
        self._tp_times: Optional[np.ndarray] = None
        self._ho_starts: Optional[np.ndarray] = None

        text = self.filename.read_text(encoding="utf-8")
        cfg = _split_sections(text.splitlines())
        self._sections = cfg

        general, meta = cfg.get("General", {}), cfg.get("Metadata", {})
        self.audio_filename = self.filename.parent / general["AudioFilename"]
        self.mode = int(general.get("Mode", 0))
        self.title = meta.get("Title", "")
        self.artist = meta.get("Artist", "")
        self.creator = meta.get("Creator", "")
        self.version = meta.get("Version", "")
        try:
            self.mapset_id: Optional[int] = int(meta["BeatmapSetID"])
        except (KeyError, ValueError):
            self.mapset_id = None

        diff = cfg["Difficulty"]
        self.hp = float(diff["HPDrainRate"])
        self.cs = float(diff["CircleSize"])
        self.od = float(diff["OverallDifficulty"])
        self.ar = float(diff.get("ApproachRate", 7))
        self.slider_multiplier = float(diff["SliderMultiplier"])
        self.slider_tick_rate = float(diff["SliderTickRate"])
        self.beat_divisor = int(diff.get("BeatDivisor", 4))

        if not meta_only:
            self.parse_map_data()

    # ------------------------------------------------------------------ parse

    def parse_map_data(self) -> None:
        """Decode the deferred list sections (timing, objects, events)."""
        cfg, self._sections = self._sections, {}
        self.timing_points, self.uninherited_timing_points = _fold_timing_rows(
            cfg.get("TimingPoints", [])
        )
        self._tp_times = np.array([tp.t for tp in self.timing_points], dtype=float)
        self.hit_objects = _decode_hit_objects(cfg.get("HitObjects", []), self)
        self._ho_starts = np.array([ho.t for ho in self.hit_objects], dtype=float)
        # break periods only; type id 2, or the "Break" alias
        self.events = [
            row.split(",") for row in cfg.get("Events", []) if row.split(",", 1)[0] in ("2", "Break")
        ]

    def get_active_timing_point(self, t: float) -> TimingPoint:
        """Latest timing point at or before ``t``; if none, tolerate a row
        stamped up to 1 ms late (rows and objects are often off by a ms);
        clamps to the first point."""
        if self._tp_times is None or len(self._tp_times) != len(self.timing_points):
            self._tp_times = np.array([tp.t for tp in self.timing_points], dtype=float)
        idx = int(np.searchsorted(self._tp_times, t, side="right")) - 1
        if idx < 0:
            idx = int(np.searchsorted(self._tp_times, t + 1.0, side="right")) - 1
        return self.timing_points[max(idx, 0)]

    # ------------------------------------------------------------------ cursor

    def cursor(self, t: float) -> Tuple[Tuple[float, float], float]:
        """Ground-truth cursor position at absolute time ``t`` (ms), plus the
        time the cursor has been idle (inf before the first object).

        Every object type runs through the same three-phase rule: busy
        (pinned by ``_busy_pos``), then a straight glide from the idle anchor
        to the next object's head, arriving exactly at its start time.
        """
        objs = self.hit_objects
        if t < objs[0].t:
            return tuple(_busy_pos(objs[0], 0.0)), np.inf

        if self._ho_starts is None or len(self._ho_starts) != len(objs):
            self._ho_starts = np.array([ho.t for ho in objs], dtype=float)
        i = int(np.searchsorted(self._ho_starts, t, side="right")) - 1
        ho = objs[i]
        nxt = objs[i + 1] if i + 1 < len(objs) else None

        rel = t - ho.t
        busy = _busy_span(ho)
        if rel < busy:
            return tuple(_busy_pos(ho, rel)), 0.0

        idle = rel - busy
        anchor = _idle_anchor(ho)
        if nxt is None:
            return tuple(anchor), idle
        f = idle / (nxt.t - ho.t - busy)
        head = _busy_pos(nxt, 0.0)  # the next object's entry point, any type
        return tuple((1.0 - f) * anchor + f * head), idle

    # ------------------------------------------------------------------ corpus

    @staticmethod
    def try_parse(filename: Path, meta_only: bool = False) -> Optional["Beatmap"]:
        """Best-effort parse for corpus sweeps: returns the std-mode beatmap
        or None (logging the reason) — malformed community maps are data
        noise, not fatal errors."""
        try:
            bm = Beatmap(filename, meta_only=meta_only)
        except Exception as e:  # noqa: BLE001 — corpus iteration is best-effort
            print(f"skipping unparseable map {filename}: {e}")
            return None
        return bm if bm.mode == 0 else None

    @staticmethod
    def all_maps(src_path: str, meta_only: bool = False) -> Generator["Beatmap", None, None]:
        """Every std-mode map under ``src_path/<mapset>/<map>.osu``."""
        candidates = Path(src_path).glob("*/*.osu")
        yield from (
            bm for bm in (Beatmap.try_parse(f, meta_only) for f in candidates) if bm is not None
        )

    @staticmethod
    def all_mapsets(
        src_path: str, meta_only: bool = False
    ) -> Generator[Tuple[int, Path, List["Beatmap"]], None, None]:
        """Mapset-grouped corpus walk: yields (mapset_id, audio_path, maps)
        for every directory that produced at least one parseable std map with
        a known mapset id."""
        for mapset_dir in (d for d in Path(src_path).iterdir() if d.is_dir()):
            maps = [
                bm
                for f in mapset_dir.glob("*.osu")
                if (bm := Beatmap.try_parse(f, meta_only)) is not None
            ]
            ids = [bm.mapset_id for bm in maps if bm.mapset_id is not None]
            if maps and ids:
                yield ids[0], maps[0].audio_filename, maps
