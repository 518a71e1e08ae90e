from osufusion_tpu_torch.codec.encode import (
    CURSOR_DIM,
    HIT_DIM,
    TOTAL_DIM,
    BeatmapEncoding,
    encode_beatmap,
)

__all__ = ["BeatmapEncoding", "HIT_DIM", "CURSOR_DIM", "TOTAL_DIM", "encode_beatmap"]
