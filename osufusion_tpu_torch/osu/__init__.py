from osufusion_tpu_torch.osu.beatmap import Beatmap
from osufusion_tpu_torch.osu.hit_objects import Circle, HitObject, Slider, Spinner, Timed, TimingPoint
from osufusion_tpu_torch.osu.sliders import Bezier, Line, Perfect, from_control_points

__all__ = [
    "Beatmap",
    "Circle",
    "HitObject",
    "Slider",
    "Spinner",
    "Timed",
    "TimingPoint",
    "Line",
    "Perfect",
    "Bezier",
    "from_control_points",
]
