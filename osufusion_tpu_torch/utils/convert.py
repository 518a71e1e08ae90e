"""JAX-package parameters <-> this package's ``state_dict``.

The port's modules carry the flax parameter names (see ``nn/blocks.py``), so
the map is mechanical: the ``/``-joined path becomes a ``.``-joined one, and
the leaves change name and layout:

- ``kernel`` (k, in, out) of a conv -> ``weight`` (out, in, k);
- ``kernel`` (in, out) of a Dense -> ``weight`` (out, in);
- ``scale`` of a LayerNorm/GroupNorm -> ``weight``;
- ``bias``, ``null_cond`` and the ``gamma`` (heads, dim) of the DiT/MMDiT
  ``MultiHeadRMSNorm`` are unchanged.

``jax_flat_from_state_dict`` is the inverse, so a checkpoint this package
trains carries the flax names and layouts and serves in both packages.
``load_params_lenient`` loads what of a checkpoint fits a module and reports
the rest, as the JAX package's loader of the same name does.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

# leaves that keep their name and layout
UNCHANGED = ("bias", "null_cond", "gamma")


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
        elif leaf not in UNCHANGED:
            raise ValueError(f"{key}: unknown parameter leaf {leaf!r}")
        out[".".join([*parts[:-1], leaf])] = torch.tensor(value)
    return out


def flax_leaf(name: str, shape) -> tuple[str, tuple]:
    """The JAX package's key (``params/<flax path>``) and shape of the
    ``state_dict`` entry ``name`` of shape ``shape``. A ``weight`` of rank 1
    is a norm's ``scale``."""
    parts = name.split(".")
    leaf, shape = parts[-1], tuple(shape)
    if leaf == "weight":
        if len(shape) in (2, 3):
            leaf, shape = "kernel", shape[::-1]
        elif len(shape) == 1:
            leaf = "scale"
        else:
            raise ValueError(f"{name}: weight of rank {len(shape)}")
    elif leaf not in UNCHANGED:
        raise ValueError(f"{name}: unknown parameter leaf {leaf!r}")
    return "/".join(["params", *parts[:-1], leaf]), shape


def jax_flat_from_state_dict(state_dict: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """The inverse of ``state_dict_from_jax``: float32 arrays keyed
    ``params/<flax path>``, as the JAX trainer writes ``model.safetensors``.
    A kernel's axes are reversed on its own device before the copy to the
    host (a host-side transpose of a 1.3 B-parameter model takes ~10 s)."""
    out = {}
    for name, tensor in state_dict.items():
        key, _ = flax_leaf(name, tuple(tensor.shape))
        value = tensor.detach().to(torch.float32)
        if key.endswith("/kernel"):
            value = value.permute(*reversed(range(value.ndim)))
        out[key] = value.contiguous().cpu().numpy()
    return out


def load_params_lenient(module: torch.nn.Module, flat: Dict[str, np.ndarray], verbose: bool = True):
    """Fill ``module`` with the entries of ``flat`` (keyed as the JAX package
    writes ``model.safetensors``) that it has with the same shape, keeping its
    own values for the rest, as ``osufusion_tpu.utils.serialization.
    load_params_lenient`` does, and reporting missing, unexpected and
    shape-mismatched keys in its words. Returns the three sorted lists."""
    names, like = {}, {}
    for name, t in module.state_dict().items():
        key, like[key] = flax_leaf(name, t.shape)
        names[key] = name
    shapes = {key: tuple(np.shape(value)) for key, value in flat.items()}
    missing = sorted(like.keys() - shapes.keys())
    unexpected = sorted(shapes.keys() - like.keys())
    mismatched = sorted(k for k in like.keys() & shapes.keys() if shapes[k] != like[k])
    if verbose and missing:
        print(f"Missing keys ({len(missing)}): {missing[:8]}{'...' if len(missing) > 8 else ''}")
    if verbose and unexpected:
        print(f"Unexpected keys ({len(unexpected)}): {unexpected[:8]}{'...' if len(unexpected) > 8 else ''}")
    if verbose and mismatched:
        # a key that exists but with the wrong shape means the architectures
        # disagree: the most dangerous case, since the random init stays
        examples = [f"{k} {shapes[k]}->{like[k]}" for k in mismatched[:4]]
        print(
            f"Shape-mismatched keys kept at their INIT values ({len(mismatched)}): "
            f"{examples}{'...' if len(mismatched) > 4 else ''}"
        )
    keep = {k: flat[k] for k in like.keys() & shapes.keys() if shapes[k] == like[k]}
    loaded = module.load_state_dict(state_dict_from_jax(keep), strict=False)
    # the two name maps must agree, or a leaf would keep its init unreported
    kept = sorted(names[k] for k in (*missing, *mismatched))
    if sorted(loaded.missing_keys) != kept or loaded.unexpected_keys:
        raise RuntimeError(f"checkpoint keys did not map onto the module: left at init {sorted(loaded.missing_keys)}, "
                           f"expected {kept}; not in the module {loaded.unexpected_keys}")
    return missing, unexpected, mismatched
