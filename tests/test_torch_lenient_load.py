"""``serve.load_model`` on a checkpoint that does not quite fit its config, in
both packages: one leaf missing, one extra and one of the wrong shape. Both
report the same three key lists in the same words, load every leaf that fits
and keep their own init for the others."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from osufusion_tpu.config import Config as JConfig
from osufusion_tpu.config import ModelConfig as JModelConfig
from osufusion_tpu.models import build_model as jax_build_model
from osufusion_tpu.models.diffusion import DiffusionModel as JDiffusionModel
from osufusion_tpu.serve.generate import load_model as jax_load_model
from osufusion_tpu.utils.serialization import flatten_params, save_safetensors
from osufusion_tpu_torch.config import Config, DiffusionConfig, ModelConfig
from osufusion_tpu_torch.models import build_model
from osufusion_tpu_torch.serve import load_model
from osufusion_tpu_torch.utils import convert
from osufusion_tpu_torch.utils.convert import jax_flat_from_state_dict
from tests.torch_helpers import random_variables

# the sizes here are tiny, and the suite runs several workers at once: a few
# threads each keep them from fighting over the cores
torch.set_num_threads(2)

TINY = dict(dim_h=32, dim_h_mult=(1,), num_layer_blocks=(1,), num_middle_transformers=1,
            attn_heads=2, attn_context_len=64, dtype="float32")


def test_load_model_is_lenient_as_in_the_jax_package(tmp_path, capsys, monkeypatch):
    # the JAX package's init (PRNGKey(0) in its load_model) is drawn once and
    # kept, so the test reads the same draws that load_model starts from
    drawn = {}
    init = JDiffusionModel.init_params
    monkeypatch.setattr(JDiffusionModel, "init_params",
                        lambda self, *a, **k: drawn.setdefault("params", init(self, *a, **k)))
    cfg = JConfig(model=JModelConfig(**TINY))
    jmodel = jax_build_model(cfg.model, cfg.diffusion)
    args = (jnp.zeros((1, 32, 6)), jnp.zeros((1, 32, 96)), jnp.zeros((1,)), jnp.zeros((1, 5)), jnp.ones((1,), bool))
    flat = {k: np.asarray(v) for k, v in flatten_params(random_variables(jmodel.unet, *args, seed=3)).items()}
    missing = "params/null_cond"
    kernels = sorted(k for k in flat if k.endswith("/kernel") and flat[k].ndim == 2)
    mismatched = kernels[0]
    flat.pop(missing)
    flat[mismatched] = np.zeros((flat[mismatched].shape[0] + 1, flat[mismatched].shape[1]), np.float32)
    unexpected = "params/extra/kernel"
    flat[unexpected] = np.ones((3, 4), np.float32)
    save_safetensors({"params": _tree(flat)}, tmp_path / "model.safetensors")
    cfg.save(tmp_path / "config.json")

    capsys.readouterr()
    _, jparams = jax_load_model(tmp_path / "model.safetensors")
    jax_report = capsys.readouterr().out
    model, params = load_model(tmp_path / "model.safetensors", device="cpu")
    port_report = capsys.readouterr().out
    assert port_report == jax_report
    assert f"Missing keys (1): ['{missing}']" in port_report
    assert f"Unexpected keys (1): ['{unexpected}']" in port_report
    assert f"Shape-mismatched keys kept at their INIT values (1): ['{mismatched} " in port_report

    # what fits is loaded; the rest keeps each package's own init (seed 0 / PRNGKey(0))
    got = jax_flat_from_state_dict(params.state_dict())
    jgot = {k: np.asarray(v) for k, v in flatten_params(jparams).items()}
    assert got.keys() == jgot.keys() == (flat.keys() - {unexpected}) | {missing}
    init = jax_flat_from_state_dict(build_model(ModelConfig(**TINY), DiffusionConfig()).init_params(seed=0, device="cpu").state_dict())
    jinit = {k: np.asarray(v) for k, v in flatten_params(drawn["params"]).items()}
    for key in got:
        if key in (missing, mismatched):
            np.testing.assert_array_equal(got[key], init[key], err_msg=key)
            np.testing.assert_array_equal(jgot[key], jinit[key], err_msg=key)
        else:
            np.testing.assert_array_equal(got[key], flat[key], err_msg=key)
            np.testing.assert_array_equal(jgot[key], flat[key], err_msg=key)
    assert Config.load(tmp_path / "config.json").model.dim_h == model.model_cfg.dim_h


def test_lenient_load_raises_where_the_name_maps_disagree(monkeypatch):
    """A leaf that ``state_dict_from_jax`` names otherwise than ``flax_leaf``
    would keep its init with nothing reported: the loader raises instead."""
    params = build_model(ModelConfig(**TINY), DiffusionConfig()).init_params(seed=0, device="cpu")
    flat = jax_flat_from_state_dict(params.state_dict())
    assert convert.load_params_lenient(params, flat, verbose=False) == ([], [], [])
    to_torch = convert.state_dict_from_jax
    monkeypatch.setattr(convert, "state_dict_from_jax",
                        lambda f: {k.replace("null_cond", "null_cond_"): v for k, v in to_torch(f).items()})
    with pytest.raises(RuntimeError, match="null_cond"):
        convert.load_params_lenient(params, flat, verbose=False)


def _tree(flat):
    """{"a/b/c": x} without the leading "params/" as a nested dict."""
    tree = {}
    for key, value in flat.items():
        node = tree
        *path, leaf = key.split("/")[1:]
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = value
    return tree
