"""Shared wrapper plumbing for the generative models
(``osufusion_tpu/models/base.py``).

The surface mirrors the JAX package: channel-first (B, C, N) tensors at the
API edge, and methods that take the denoiser as ``params``. Here ``params`` is
the ``UNet`` module itself, which holds its weights on its device
(``init_params``, or ``serve.load_model`` for a checkpoint).

Precision: the module computes in the dtype of its parameters. Serving and
``full_bf16`` training hold the parameters in the config's compute dtype.
Mixed-precision training holds them in float32 and runs the forward under
``torch.autocast`` to the compute dtype (``compute_context``): convolutions
and matrix products then take bf16 operands, norms keep float32 statistics,
and the gradients arrive in float32.
"""

from __future__ import annotations

import contextlib
from typing import Optional

import torch

from osufusion_tpu_torch.config import DiffusionConfig, ModelConfig
from osufusion_tpu_torch.nn.unet import UNet
from osufusion_tpu_torch.parallel.sequence import active_shard, all_reduce_sum


def to_channel_last(x: torch.Tensor) -> torch.Tensor:
    return x.transpose(-1, -2)


def to_channel_first(x: torch.Tensor) -> torch.Tensor:
    return x.transpose(-1, -2)


def masked_mse(pred: torch.Tensor, target: torch.Tensor, orig_len: Optional[torch.Tensor]) -> torch.Tensor:
    """MSE over valid frames only: the squared error summed over frames
    t < orig_len, over (valid frames x C), the denominator at least 1.

    Under a sequence shard pred and target hold this rank's frames: the mask
    takes their global indices and both sums run over the group. The value is
    the song's loss on every rank; its gradient is this rank's share, its own
    frames' error over the song's denominator, so that the shares' gradients
    sum to the loss's (``parallel/sequence.py``)."""
    se = (pred - target) ** 2  # (B, T, C)
    shard = active_shard()
    if shard is not None:
        return _sharded_mse(se, orig_len, shard)
    if orig_len is None:
        return se.mean()
    _, T, C = se.shape
    mask = (torch.arange(T, device=se.device)[None, :] < orig_len[:, None]).to(se.dtype)  # (B, T)
    num = (se * mask[..., None]).sum()
    den = mask.sum() * C
    return num / den.clamp(min=1.0)


def _sharded_mse(se: torch.Tensor, orig_len: Optional[torch.Tensor], shard) -> torch.Tensor:
    _, T, C = se.shape
    if orig_len is None:
        num, den = se.sum(), se.numel() * shard.count
    else:
        frames = torch.arange(shard.g0(T), shard.g0(T) + T, device=se.device)
        mask = (frames[None, :] < orig_len[:, None]).to(se.dtype)  # (B, T)
        num, den = (se * mask[..., None]).sum(), all_reduce_sum(mask.sum() * C, shard).clamp(min=1.0)
    share = num / den
    return share + (all_reduce_sum(share.detach(), shard) - share.detach())


class GenerativeModel:
    """Base: owns the configuration and builds the denoiser (UNet only)."""

    def __init__(self, model_cfg: ModelConfig, diffusion_cfg: DiffusionConfig) -> None:
        if model_cfg.backbone in ("dit", "mmdit"):
            raise NotImplementedError(
                f"backbone {model_cfg.backbone!r} is not ported yet (ROADMAP.md, queue 1: nn/dit.py and nn/mmdit.py)"
            )
        if model_cfg.backbone != "unet":
            raise ValueError(f"unknown backbone: {model_cfg.backbone}")
        self.model_cfg = model_cfg
        self.cfg = diffusion_cfg

    def init_params(self, seed: int = 0, device=None, dtype: Optional[torch.dtype] = None) -> UNet:
        """A UNet with weights drawn as the JAX package's ``init`` draws them
        (``UNet.reset_parameters``) from a generator seeded with ``seed``; the
        global RNG state is left as it was. The module is built without
        storage and drawn once, in float32 on ``device`` with that device's
        generator (so a seed gives one set of weights per device type), then
        cast to ``dtype`` or without it the config's compute dtype."""
        device = torch.device(device or "cpu")
        with torch.device("meta"):
            unet = UNet(self.model_cfg)
        unet = unet.to_empty(device=device)
        unet.reset_parameters(torch.Generator(device=device).manual_seed(seed))
        return unet.to(dtype=dtype or self.model_cfg.compute_dtype).eval()

    def compute_context(self, params: UNet):
        """Autocast to the config's compute dtype when the parameters are held
        in a wider one (mixed precision); otherwise nothing."""
        compute = self.model_cfg.compute_dtype
        if params.dtype == compute or compute == torch.float32:
            return contextlib.nullcontext()
        return torch.autocast(device_type=params.null_cond.device.type, dtype=compute)

    def encode_audio(self, params: UNet, a_cf: torch.Tensor) -> torch.Tensor:
        """(B, 96, N) -> audio features (channel-last), reused across sampling steps."""
        return params.encode_audio(to_channel_last(a_cf))

    def _cfg_eps(
        self,
        params: UNet,
        x: torch.Tensor,  # (B, T, C) channel-last
        a_enc: torch.Tensor,
        t: torch.Tensor,  # (B,)
        c: torch.Tensor,
        cond_scale: float,
    ) -> torch.Tensor:
        """Classifier-free-guided prediction. For scale != 1 the conditional
        and unconditional branches run as ONE doubled batch."""
        B = x.shape[0]
        ones = torch.ones((B,), dtype=torch.bool, device=x.device)
        if cond_scale == 1.0:
            return params(x, a_enc, t, c, ones, audio_encoded=True)
        mask = torch.cat([ones, torch.zeros_like(ones)])
        out = params(
            torch.cat([x, x]), torch.cat([a_enc, a_enc]), torch.cat([t, t]), torch.cat([c, c]), mask,
            audio_encoded=True,
        )
        cond, uncond = out[:B], out[B:]
        return uncond + (cond - uncond) * cond_scale
