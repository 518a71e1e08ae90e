"""Serving through the port on the CPU: a checkpoint written by the JAX
package loads into ``load_model`` and ``generate_beatmap`` turns a short WAV
into a parseable ``.osz``; and the port imports no JAX."""

import io
import subprocess
import sys
import zipfile
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.io import wavfile

from osufusion_tpu.config import Config as JConfig
from osufusion_tpu.config import ModelConfig as JModelConfig
from osufusion_tpu.models import build_model as jax_build_model
from osufusion_tpu.osu import Beatmap
from osufusion_tpu.utils.serialization import flatten_params, save_safetensors
from osufusion_tpu_torch.serve import generate_beatmap, load_model
from osufusion_tpu_torch.utils.serialization import load_safetensors
from tests.torch_helpers import random_variables

# the sizes here are tiny, and the suite runs several workers at once: a few
# threads each keep them from fighting over the cores
torch.set_num_threads(2)

REPO = Path(__file__).resolve().parent.parent
TINY = dict(dim_h=96, dim_h_mult=(1, 2), num_layer_blocks=(1, 1), num_middle_transformers=1,
            attn_heads=2, attn_context_len=64, dtype="float32")


def _click_track(path, seconds=3.0, bpm=120.0):
    sr = 22050
    rng = np.random.default_rng(0)
    y = 0.05 * rng.standard_normal(int(seconds * sr))
    for beat in np.arange(0.0, seconds, 60.0 / bpm):
        i = int(beat * sr)
        y[i : i + 400] += np.hanning(800)[400:] * np.sin(2 * np.pi * 1000 * np.arange(400) / sr)
    wavfile.write(path, sr, (np.clip(y, -1, 1) * 32767).astype(np.int16))


@pytest.mark.parametrize("sampler", [None, "dpmpp-2m"])
def test_jax_checkpoint_serves_through_the_port(tmp_path, sampler):
    cfg = JConfig(model=JModelConfig(**TINY))
    jmodel = jax_build_model(cfg.model, cfg.diffusion)
    args = (jnp.zeros((1, 32, 6)), jnp.zeros((1, 32, 96)), jnp.zeros((1,)), jnp.zeros((1, 5)), jnp.ones((1,), bool))
    variables = random_variables(jmodel.unet, *args, seed=0)
    save_safetensors(variables, tmp_path / "model.safetensors")
    cfg.save(tmp_path / "config.json")

    # the numpy-only reader gives back what was written
    flat = flatten_params(variables)
    loaded = load_safetensors(tmp_path / "model.safetensors")
    assert loaded.keys() == flat.keys()
    assert all(np.array_equal(loaded[k], flat[k]) for k in flat)

    model, params = load_model(tmp_path / "model.safetensors", device="cpu")
    assert params.null_cond.dtype == torch.float32
    np.testing.assert_array_equal(params.null_cond.detach().numpy(), flat["params/null_cond"])

    wav = tmp_path / "song.wav"
    _click_track(wav)
    data, texts = generate_beatmap(model, params, wav, num_samples=2, sampling_timesteps=2, sampler=sampler, seed=1,
                                   output_path=tmp_path / "out.osz")
    assert (tmp_path / "out.osz").read_bytes() == data
    with zipfile.ZipFile(io.BytesIO(data)) as z:
        names = z.namelist()
        assert "song.wav" in names
        osu_names = [n for n in names if n.endswith(".osu")]
        assert len(osu_names) == 2
        for name in osu_names:
            z.extract(name, tmp_path)
            Beatmap(tmp_path / name)  # parses
    assert len(texts) == 2 and all("[HitObjects]" in t for t in texts)


def test_port_imports_no_jax():
    code = (
        "import sys; sys.modules['jax'] = None; sys.modules['flax'] = None\n"
        "import osufusion_tpu_torch.serve, osufusion_tpu_torch.inference\n"
        "assert not any(m.split('.')[0] in ('jax', 'flax') and sys.modules[m] is not None for m in sys.modules)\n"
    )
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True, timeout=120)


def test_safetensors_reader_rejects_a_damaged_file(tmp_path):
    import pytest

    good = tmp_path / "m.safetensors"
    save_safetensors({"w": np.arange(6, dtype=np.float32).reshape(2, 3)}, good)
    data = good.read_bytes()
    assert load_safetensors(good)["w"].tolist() == [[0, 1, 2], [3, 4, 5]]
    for name, blob in (("short", data[:5]), ("header", b"\xff" * 8 + data[8:]), ("truncated", data[:-4])):
        bad = tmp_path / f"{name}.safetensors"
        bad.write_bytes(blob)
        with pytest.raises(ValueError):
            load_safetensors(bad)


def test_config_json_round_trips_with_jax():
    import json

    from osufusion_tpu_torch.config import Config

    jcfg = JConfig(model=JModelConfig(**TINY))
    port = Config.from_json(jcfg.to_json())
    assert port.model.compute_dtype == torch.float32 and port.model.dim_h_mult == (1, 2)
    assert json.loads(port.to_json()) == json.loads(jcfg.to_json())
    assert JConfig.from_json(port.to_json()) == jcfg
