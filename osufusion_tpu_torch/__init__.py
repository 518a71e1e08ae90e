"""OsuFusion in PyTorch for NVIDIA Hopper: the full-song serving path of
``osufusion_tpu`` (audio -> log-VQT -> UNet under DDIM with classifier-free
guidance -> ``.osz``) and UNet training on one GPU (diffusion loss, AdamW
loop, checkpoints), with the attention kernels, forward and backward, written
by hand in CUDA C++.

The layout mirrors ``osufusion_tpu`` module for module:

- ``osufusion_tpu_torch.audio``  — WAV decode/resample and the log-VQT as one matmul
- ``osufusion_tpu_torch.ops``    — RoPE, attention dispatch, the flash kernels' wrappers and autograd Function
- ``osufusion_tpu_torch.csrc``   — CUDA C++ sources, built with ``nvcc`` at first use
- ``osufusion_tpu_torch.nn``     — UNet building blocks and the UNet, channel-last
- ``osufusion_tpu_torch.models`` — DDIM schedule, the diffusion loss and the sampler
- ``osufusion_tpu_torch.utils``  — safetensors reading and writing, JAX-checkpoint conversion both ways
- ``osufusion_tpu_torch.serve``  — end-to-end generation (audio -> .osz)
- ``osufusion_tpu_torch.train``  — the input pipeline and the training loop
- ``osufusion_tpu_torch.trainer`` — the training CLI
- ``osufusion_tpu_torch.osu``, ``osufusion_tpu_torch.codec`` — the beatmap domain model and the
  signal codec: numpy/scipy copies of the JAX package's host layers, import paths changed

This package never imports ``jax``, ``flax``, ``optax`` or anything of
``osufusion_tpu``: it keeps its own copy of what it needs from there.
"""

__version__ = "0.1.0"
