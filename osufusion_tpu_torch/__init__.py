"""OsuFusion in PyTorch for NVIDIA Hopper: the full-song serving path of
``osufusion_tpu`` (audio -> log-VQT -> UNet under DDIM with classifier-free
guidance -> ``.osz``), with the attention kernel written by hand in CUDA C++.

The layout mirrors ``osufusion_tpu`` module for module:

- ``osufusion_tpu_torch.audio``  — WAV decode/resample and the log-VQT as one matmul
- ``osufusion_tpu_torch.ops``    — RoPE, attention dispatch, the flash-forward kernel wrapper
- ``osufusion_tpu_torch.csrc``   — CUDA C++ sources, built with ``nvcc`` at first use
- ``osufusion_tpu_torch.nn``     — UNet building blocks and the UNet, channel-last
- ``osufusion_tpu_torch.models`` — DDIM schedule and the sampler
- ``osufusion_tpu_torch.utils``  — safetensors reading and JAX-checkpoint conversion
- ``osufusion_tpu_torch.serve``  — end-to-end generation (audio -> .osz)

The framework-free host layers (``osufusion_tpu.osu``, ``osufusion_tpu.codec``)
are imported from the JAX package, which they do not depend on. This package
never imports ``jax`` or ``flax``.
"""

__version__ = "0.1.0"
