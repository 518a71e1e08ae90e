"""JAX-package parameters -> this package's ``state_dict``.

The port's modules carry the flax parameter names (see ``nn/blocks.py``), so
the map is mechanical: the ``/``-joined path becomes a ``.``-joined one, and
the leaves change name and layout:

- ``kernel`` (k, in, out) of a conv -> ``weight`` (out, in, k);
- ``kernel`` (in, out) of a Dense -> ``weight`` (out, in);
- ``scale`` of a LayerNorm/GroupNorm -> ``weight``;
- ``bias`` and ``null_cond`` are unchanged.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch


def state_dict_from_jax(flat: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    """``flat`` is keyed as ``osufusion_tpu.utils.serialization.flatten_params``
    writes ``model.safetensors`` (a leading ``params/`` is dropped)."""
    out = {}
    for key, value in flat.items():
        parts = key.split("/")
        if parts[0] == "params":
            parts = parts[1:]
        value = np.asarray(value, dtype=np.float32)
        leaf = parts[-1]
        if leaf == "kernel":
            if value.ndim == 3:
                value = value.transpose(2, 1, 0)
            elif value.ndim == 2:
                value = value.T
            else:
                raise ValueError(f"{key}: kernel of rank {value.ndim}")
            leaf = "weight"
        elif leaf == "scale":
            leaf = "weight"
        elif leaf not in ("bias", "null_cond"):
            raise ValueError(f"{key}: unknown parameter leaf {leaf!r}")
        out[".".join([*parts[:-1], leaf])] = torch.tensor(value)
    return out
