"""Shared helpers of the ``test_torch_*`` parity tests: one set of seeded
parameters in both packages."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from osufusion_tpu.utils.serialization import flatten_params, unflatten_params
from osufusion_tpu_torch.utils.convert import state_dict_from_jax


def random_variables(flax_module, *inputs, seed: int = 0):
    """Seeded flax variables for ``flax_module`` at the shapes its ``init``
    gives (traced, not run). Kernels are lecun-scaled normals; biases, norm
    scales (about 1) and ``null_cond`` are random too, so a mapping fault that
    swaps or drops any of them shows."""
    abstract = jax.eval_shape(flax_module.init, jax.random.PRNGKey(0), *inputs)
    shapes = {"/".join(str(k.key) for k in path): leaf.shape for path, leaf in jax.tree_util.tree_leaves_with_path(abstract)}
    rng = np.random.default_rng(seed)
    flat = {}
    for key, shape in sorted(shapes.items()):
        if key.endswith("kernel"):
            value = rng.normal(0.0, 1.0 / np.sqrt(np.prod(shape[:-1])), shape)
        elif key.endswith("scale"):
            value = 1.0 + rng.normal(0.0, 0.1, shape)
        else:
            value = rng.normal(0.0, 0.1 if key.endswith("bias") else 1.0, shape)
        flat[key] = jnp.asarray(value, jnp.float32)
    return unflatten_params(flat)


def load_jax_params(module, variables):
    """Load flax ``variables`` into a torch ``module`` (strict: every name maps)."""
    module.load_state_dict(state_dict_from_jax({k: np.asarray(v) for k, v in flatten_params(variables).items()}))
    return module.eval()
