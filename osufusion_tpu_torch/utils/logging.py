"""Metric logging (``osufusion_tpu/utils/logging.py``): a JSONL file under
the project directory with the JAX package's metric names (loss, total_norm,
lr, save_loss). The wandb mirror of the JAX package is not ported, so a run
contacts no outside service."""

from __future__ import annotations

import json
import time
from pathlib import Path


class MetricLogger:
    def __init__(self, project_dir: Path) -> None:
        self.project_dir = Path(project_dir)
        self.project_dir.mkdir(parents=True, exist_ok=True)
        self.file = open(self.project_dir / "metrics.jsonl", "a", buffering=1)

    def log(self, metrics: dict, step: int) -> None:
        rec = {"step": step, "time": time.time(), **{k: float(v) for k, v in metrics.items()}}
        self.file.write(json.dumps(rec) + "\n")

    def close(self) -> None:
        self.file.close()
