from osufusion_tpu_torch.audio.constants import (
    AUDIO_DIM,
    CONTEXT_DIM,
    HOP_LENGTH,
    SR,
    frame_times,
    normalize_context,
)
from osufusion_tpu_torch.audio.io import load_audio
from osufusion_tpu_torch.audio.vqt import log_vqt

__all__ = ["SR", "HOP_LENGTH", "AUDIO_DIM", "CONTEXT_DIM", "frame_times", "normalize_context", "load_audio", "log_vqt"]
