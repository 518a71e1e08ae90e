"""JAX-package parameters <-> this package's ``state_dict``.

The port's modules carry the flax parameter names (see ``nn/blocks.py``), so
the map is mechanical: the ``/``-joined path becomes a ``.``-joined one, and
the leaves change name and layout:

- ``kernel`` (k, in, out) of a conv -> ``weight`` (out, in, k);
- ``kernel`` (in, out) of a Dense -> ``weight`` (out, in);
- ``scale`` of a LayerNorm/GroupNorm -> ``weight``;
- ``bias`` and ``null_cond`` are unchanged.

``jax_flat_from_state_dict`` is the inverse, so a checkpoint this package
trains carries the flax names and layouts and serves in both packages.
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


def jax_flat_from_state_dict(state_dict: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """The inverse of ``state_dict_from_jax``: float32 arrays keyed
    ``params/<flax path>``, as the JAX trainer writes ``model.safetensors``.
    A ``weight`` of rank 1 is a norm's ``scale``."""
    out = {}
    for key, tensor in state_dict.items():
        parts = key.split(".")
        value = tensor.detach().to(device="cpu", dtype=torch.float32).numpy()
        leaf = parts[-1]
        if leaf == "weight":
            if value.ndim == 3:
                value, leaf = value.transpose(2, 1, 0), "kernel"
            elif value.ndim == 2:
                value, leaf = value.T, "kernel"
            elif value.ndim == 1:
                leaf = "scale"
            else:
                raise ValueError(f"{key}: weight of rank {value.ndim}")
        elif leaf not in ("bias", "null_cond"):
            raise ValueError(f"{key}: unknown parameter leaf {leaf!r}")
        out["/".join(["params", *parts[:-1], leaf])] = np.ascontiguousarray(value)
    return out
