"""The configuration dataclasses of ``osufusion_tpu.config``, read from and
written to the same ``config.json``, with a torch dtype table.

The fields, their defaults and the JSON round trip are those of the JAX
package, so one checkpoint directory serves both. Only the fields the ported
paths read have an effect here; the rest ride along unchanged.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from pathlib import Path
from typing import Optional, Tuple

import torch

from osufusion_tpu_torch.audio.constants import AUDIO_DIM, CONTEXT_DIM

TOTAL_DIM = 6  # osufusion_tpu.codec.encode.TOTAL_DIM

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16, "float16": torch.float16}


@dataclass(frozen=True)
class ModelConfig:
    """Denoiser backbone configuration (``osufusion_tpu.config.ModelConfig``)."""

    backbone: str = "unet"  # unet | dit | mmdit
    dim_in_x: int = TOTAL_DIM
    dim_in_a: int = AUDIO_DIM
    dim_in_c: int = CONTEXT_DIM
    dim_h: int = 512
    dim_h_mult: Tuple[int, ...] = (1, 2, 3, 4)
    num_layer_blocks: Tuple[int, ...] = (3, 3, 3, 3)
    num_middle_transformers: int = 3
    cross_embed_kernel_sizes: Tuple[int, ...] = (3, 7, 15)
    attn_dim_head: int = 64
    attn_heads: int = 16
    attn_kv_heads: int = 1
    attn_context_len: int = 4096
    depth: int = 12
    patch_size: int = 4
    dtype: str = "bfloat16"
    param_dtype: str = "float32"
    quant: str = "none"
    remat: bool = False
    remat_mode: str = "save-attn"
    remat_level_modes: Tuple[str, ...] = ("save-attn-out", "save-attn-out", "block", "block")
    audio_remat_mode: Optional[str] = None
    attn_backend: str = "auto"
    # sliding-window attention (window = the level's context length) engages
    # only when a site's sequence is longer than its context
    attn_local: bool = True

    @property
    def compute_dtype(self) -> torch.dtype:
        """The dtype the port's modules hold their weights and compute in."""
        return _DTYPES[self.dtype]


@dataclass(frozen=True)
class DiffusionConfig:
    """Objective + sampler configuration (``osufusion_tpu.config.DiffusionConfig``)."""

    objective: str = "diffusion"  # diffusion (DDIM) | rectified-flow
    train_timesteps: int = 1000
    sampling_timesteps: int = 35
    cond_drop_prob: float = 0.5
    cfg_scale: float = 7.0
    beta_start: float = 0.0001
    beta_end: float = 0.02
    clip_sample: bool = True


@dataclass(frozen=True)
class TrainConfig:
    """Training loop configuration (``osufusion_tpu.config.TrainConfig``);
    carried for the JSON round trip, not read by the serving path."""

    project_dir: str = "runs/default"
    dataset_dir: str = "data"
    model_type: str = "diffusion"
    resume: Optional[str] = None
    reset_steps: bool = False
    dataset_mode: str = "subsequence"
    max_length: int = 0
    segment_length: int = 4096
    segment_sr: bool = True
    sample_density: float = 1.0
    mixed_precision: str = "bf16"
    full_bf16: bool = False
    opt_moments: str = "dtype"
    gradient_checkpointing: bool = False
    gradient_accumulation_steps: int = 1
    clip_grad_norm: float = 0.0
    lr: float = 1e-5
    batch_size: int = 4
    num_workers: int = 2
    total_steps: int = 1_000_000
    save_every: int = 1000
    max_num_checkpoints: int = 5
    warmup_steps: int = 1000
    sample_every: int = 1000
    sample_audio: Optional[str] = None
    seed: int = 0
    mesh_data: int = -1
    mesh_model: int = 1
    mesh_seq: int = 1
    shard_opt_state: bool = True


@dataclass(frozen=True)
class Config:
    model: ModelConfig = field(default_factory=ModelConfig)
    diffusion: DiffusionConfig = field(default_factory=DiffusionConfig)
    train: TrainConfig = field(default_factory=TrainConfig)

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2)

    @staticmethod
    def from_json(text: str) -> "Config":
        raw = json.loads(text)

        def mk(cls, d):
            fields = {f.name for f in dataclasses.fields(cls)}
            kwargs = {k: (tuple(v) if isinstance(v, list) else v) for k, v in d.items() if k in fields}
            return cls(**kwargs)

        return Config(
            model=mk(ModelConfig, raw.get("model", {})),
            diffusion=mk(DiffusionConfig, raw.get("diffusion", {})),
            train=mk(TrainConfig, raw.get("train", {})),
        )

    def save(self, path: Path) -> None:
        Path(path).write_text(self.to_json())

    @staticmethod
    def load(path: Path) -> "Config":
        return Config.from_json(Path(path).read_text())
