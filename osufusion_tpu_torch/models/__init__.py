from osufusion_tpu_torch.models.diffusion import DiffusionModel

__all__ = ["DiffusionModel", "build_model"]


def build_model(model_cfg, diff_cfg) -> DiffusionModel:
    """Objective dispatch; only the diffusion (DDIM) objective is ported."""
    if diff_cfg.objective in ("diffusion", "ddim"):
        return DiffusionModel(model_cfg, diff_cfg)
    if diff_cfg.objective in ("rectified-flow", "rf"):
        raise NotImplementedError("rectified flow is not ported yet (ROADMAP.md, queue 1: models/rectified_flow.py)")
    raise ValueError(f"unknown objective: {diff_cfg.objective}")
