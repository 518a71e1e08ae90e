"""The port's training loop against the JAX package's: learning-rate
schedule, three optimizer steps from the same parameters with the same random
draws (with clipping, and with accumulation), checkpoints, precision modes,
and the final ``model.safetensors`` served by both packages. fp32 on the CPU
at a tiny width."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from osufusion_tpu.config import Config as JConfig
from osufusion_tpu.config import DiffusionConfig as JDiffusionConfig
from osufusion_tpu.config import ModelConfig as JModelConfig
from osufusion_tpu.config import TrainConfig as JTrainConfig
from osufusion_tpu.models import build_model as jax_build_model
from osufusion_tpu.parallel import make_mesh
from osufusion_tpu.train import loop as jax_loop
from osufusion_tpu.utils.serialization import flatten_params
from osufusion_tpu.utils.serialization import load_safetensors as jax_load_safetensors
from osufusion_tpu_torch.config import Config, DiffusionConfig, ModelConfig, TrainConfig
from osufusion_tpu_torch.models import build_model
from osufusion_tpu_torch.nn.unet import UNet
from osufusion_tpu_torch.serve import load_model
from osufusion_tpu_torch.train import loop
from osufusion_tpu_torch.trainer import parse_args, train
from osufusion_tpu_torch.utils.convert import jax_flat_from_state_dict
from tests.torch_helpers import load_jax_params, random_variables

# the sizes here are tiny, and the suite runs several workers at once: a few
# threads each keep them from fighting over the cores
torch.set_num_threads(2)

TINY = dict(
    dim_h=32, dim_h_mult=(1, 2), num_layer_blocks=(1, 1), num_middle_transformers=1,
    attn_dim_head=16, attn_heads=4, attn_context_len=64, dtype="float32",
)
TRAIN = dict(total_steps=10, warmup_steps=2, lr=1e-3, batch_size=4)
B, N = 4, 64


def configs(**train_kw):
    kw = {**TRAIN, **train_kw}
    return (JConfig(model=JModelConfig(**TINY), diffusion=JDiffusionConfig(), train=JTrainConfig(**kw)),
            Config(model=ModelConfig(**TINY), diffusion=DiffusionConfig(), train=TrainConfig(**kw)))


@pytest.mark.parametrize("warmup,total", [(2, 10), (0, 10), (5, 3)], ids=["usual", "no-warmup", "short-run"])
@pytest.mark.parametrize("where", ["start", "one", "warmup", "mid", "end"])
def test_lr_schedule_matches_optax(warmup, total, where):
    jcfg, cfg = configs(warmup_steps=warmup, total_steps=total)
    end = max(total, warmup + 1)
    step = {"start": 0, "one": 1, "warmup": warmup, "mid": (warmup + end) // 2, "end": end}[where]
    want = float(jax_loop.make_lr_schedule(jcfg)(step))
    assert loop.make_lr_schedule(cfg)(step) == pytest.approx(want, rel=1e-6, abs=1e-12)


def _batch(seed, accum=1):
    rng = np.random.default_rng(seed)
    lead = (accum, B) if accum > 1 else (B,)
    x = rng.uniform(-1, 1, (*lead, 6, N)).astype(np.float32)
    a = rng.normal(-10, 1, (*lead, 96, N)).astype(np.float32)
    c = rng.uniform(-1, 1, (*lead, 5)).astype(np.float32)
    orig_len = rng.integers(N // 2, N + 1, lead).astype(np.int32)
    return x, a, c, orig_len


def _jax_draws(rng_step, accum):
    """The draws ``make_train_step`` hands to each micro-batch's loss."""
    keys = [rng_step] if accum <= 1 else list(jax.random.split(rng_step, accum))
    draws = []
    for key in keys:
        k_noise, k_t, k_drop = jax.random.split(key, 3)
        noise = np.asarray(jax.random.normal(k_noise, (B, N, 6), jnp.float32)).transpose(0, 2, 1).copy()
        t = np.array(jax.random.randint(k_t, (B,), 0, 1000))
        mask = np.array(jax.random.bernoulli(k_drop, 0.5, (B,)))
        draws.append((torch.from_numpy(noise), torch.from_numpy(t), torch.from_numpy(mask)))
    return draws


@pytest.mark.parametrize("case", ["plain", "clipped", "accumulated"])
def test_three_optimizer_steps_match_jax(case):
    train_kw = {"plain": {}, "clipped": {"clip_grad_norm": 0.05}, "accumulated": {"gradient_accumulation_steps": 2}}[case]
    accum = train_kw.get("gradient_accumulation_steps", 1)
    jcfg, cfg = configs(**train_kw)
    jmodel = jax_build_model(jcfg.model, jcfg.diffusion)
    args = (jnp.zeros((1, 32, 6)), jnp.zeros((1, 32, 96)), jnp.zeros((1,)), jnp.zeros((1, 5)), jnp.ones((1,), bool))
    variables = random_variables(jmodel.unet, *args, seed=4)

    tx = jax_loop.make_optimizer(jcfg)
    jstate = jax_loop.TrainState(step=jnp.zeros((), jnp.int32), params=variables, opt_state=tx.init(variables),
                                 rng=jax.random.PRNGKey(11))
    jstep = jax_loop.make_train_step(jmodel, jcfg, make_mesh(data=1, model=1, devices=jax.devices()[:1]))

    model = build_model(cfg.model, cfg.diffusion)
    params = load_jax_params(UNet(cfg.model), variables).train()
    state = loop.TrainState(0, params, loop.make_optimizer(cfg, params), torch.Generator().manual_seed(0))
    step = loop.make_train_step(model, cfg)

    moved = 0.0
    for i in range(3):
        batch = _batch(20 + i, accum)
        _, rng_step = jax.random.split(jstate.rng)
        draws = _jax_draws(rng_step, accum)
        jstate, jmetrics = jstep(jstate, batch)
        metrics = step(state, batch, draws=draws)
        # the loss and the norm are sums over ~1e4 terms in another order; the rate is a formula
        assert float(metrics["loss"]) == pytest.approx(float(jmetrics["loss"]), rel=2e-5), f"loss, step {i}"
        assert float(metrics["grad_norm"]) == pytest.approx(float(jmetrics["grad_norm"]), rel=5e-4), f"grad_norm, step {i}"
        assert float(metrics["lr"]) == pytest.approx(float(jmetrics["lr"]), rel=1e-6, abs=1e-12)
        want = flatten_params(jstate.params)
        got = jax_flat_from_state_dict(params.state_dict())
        moved += float(jmetrics["lr"])  # Adam normalises each update to about the learning rate
        for name, value in want.items():
            # The two gradients agree to ~1e-4 relative, which Adam's ratio
            # m / sqrt(v) passes on: the parameters may differ by 2 % of the
            # distance moved so far. One kind of leaf cannot be held closer
            # than that distance itself: the bias in front of GlobalContext's
            # softmax over T shifts every logit alike, so its true gradient is
            # zero, what each framework computes is rounding noise, and Adam
            # turns the noise's sign into a whole step.
            noise_only = name.endswith("GlobalContext_0/Dense_0/bias")
            atol = (1.01 if noise_only else 0.02) * moved + 1e-7
            np.testing.assert_allclose(got[name], np.asarray(value), rtol=0, atol=atol, err_msg=f"{name}, step {i}")
    assert state.step == int(jstate.step) == 3
    if case == "clipped":
        assert float(metrics["grad_norm"]) > cfg.train.clip_grad_norm  # the clip engaged


def test_accumulated_step_equals_the_big_batch():
    """Two micro-batches of B with their draws give the step of one batch of
    2B with the same draws (full-length samples, so both means weigh alike)."""
    _, cfg = configs(gradient_accumulation_steps=2)
    _, cfg_big = configs(batch_size=2 * B)
    x, a, c, _ = _batch(5, accum=2)
    orig_len = np.full((2, B), N, np.int32)
    rng = np.random.default_rng(6)
    draws = [(torch.from_numpy(rng.standard_normal((B, 6, N)).astype(np.float32)),
              torch.from_numpy(rng.integers(0, 1000, B)), torch.from_numpy(rng.random(B) < 0.5)) for _ in range(2)]
    results = []
    for config, batch, step_draws in (
        (cfg, (x, a, c, orig_len), draws),
        (cfg_big, tuple(v.reshape(2 * B, *v.shape[2:]) for v in (x, a, c, orig_len)),
         [tuple(torch.cat(pair) for pair in zip(*draws))]),
    ):
        model = build_model(config.model, config.diffusion)
        params = model.init_params(seed=3, device="cpu", dtype=torch.float32).train()
        with torch.no_grad():
            params.final_conv.weight.normal_(0, 0.2, generator=torch.Generator().manual_seed(1))
        state = loop.TrainState(1, params, loop.make_optimizer(config, params), torch.Generator().manual_seed(0))
        metrics = loop.make_train_step(model, config)(state, batch, draws=step_draws)
        results.append((float(metrics["loss"]), float(metrics["grad_norm"]), params.state_dict()))
    assert results[0][0] == pytest.approx(results[1][0], rel=1e-5)
    assert results[0][1] == pytest.approx(results[1][1], rel=1e-3)


def _tiny_train_config(project_dir, **kw):
    _, cfg = configs(project_dir=str(project_dir), dataset_mode="dummy", segment_length=32, batch_size=2,
                     save_every=2, num_workers=1, **kw)
    return cfg


def test_checkpoint_roundtrip_pruning_and_resume(tmp_path):
    """Through the trainer: three saves with max_num_checkpoints=2 leave the
    two newest, the newest restores bit for bit, and a resumed run goes on
    from its step."""
    cfg = _tiny_train_config(tmp_path, total_steps=6, max_num_checkpoints=2)
    train(cfg, device="cpu")
    assert loop.checkpoint_steps(tmp_path) == [4, 6]
    model = build_model(cfg.model, cfg.diffusion)
    state = loop.restore_checkpoint(tmp_path, loop.init_state(model, cfg, "cpu"))
    assert state.step == 6
    saved = torch.load(tmp_path / "checkpoints" / "6" / "state.pt", weights_only=True)
    for name, value in state.params.state_dict().items():
        assert torch.equal(value, saved["params"][name]), name
    assert torch.equal(state.generator.get_state(), saved["generator"])
    moments = state.optimizer.state_dict()["state"]
    assert len(moments) == len(list(state.params.parameters())) and int(moments[0]["step"]) == 6
    assert loop.load_data_state(tmp_path, 6) == {"epoch": 0, "index": 12} and loop.load_data_state(tmp_path, 4) is None

    longer = dataclasses.replace(cfg, train=dataclasses.replace(cfg.train, total_steps=8, resume="latest"))
    assert [h["step"] for h in train(longer, device="cpu")] == [7, 8]
    assert loop.checkpoint_steps(tmp_path) == [6, 8]


def test_resume_takes_the_same_next_steps(tmp_path):
    """Save after four steps, go on for two; a fresh state restored from the
    checkpoint, fed from the saved data position, takes the same two steps."""
    from osufusion_tpu_torch.train import data as D

    cfg = _tiny_train_config(tmp_path, total_steps=6)
    model = build_model(cfg.model, cfg.diffusion)
    step = loop.make_train_step(model, cfg)

    def pipeline(start=None):
        return D.DataPipeline(D.make_dataset("dummy", [], seed=0, segment_length=32), 2, bucket=64, start=start)

    state, batches = loop.init_state(model, cfg, "cpu"), pipeline()
    for _ in range(4):
        step(state, next(batches))
    loop.save_checkpoint(tmp_path, state, max_to_keep=5)
    loop.save_data_state(tmp_path, state.step, batches)
    straight = [step(state, next(batches)) for _ in range(2)]

    fresh = loop.restore_checkpoint(tmp_path, loop.init_state(model, cfg, "cpu"))
    batches = pipeline(loop.load_data_state(tmp_path, fresh.step))
    resumed = [step(fresh, next(batches)) for _ in range(2)]
    assert fresh.step == state.step == 6
    for got, want in zip(resumed, straight):
        assert all(float(got[k]) == float(want[k]) for k in ("loss", "grad_norm", "lr"))
    for (name, p), q in zip(fresh.params.state_dict().items(), state.params.state_dict().values()):
        assert torch.equal(p, q), name


@pytest.mark.parametrize("precision", ["full_bf16", "mixed_bf16", "fp32"])
def test_precision_modes_take_a_finite_step(precision):
    model_kw = {**TINY, "dtype": "float32" if precision == "fp32" else "bfloat16"}
    cfg = Config(model=ModelConfig(**model_kw), diffusion=DiffusionConfig(),
                 train=TrainConfig(**TRAIN, full_bf16=precision == "full_bf16",
                                   mixed_precision="no" if precision == "fp32" else "bf16"))
    model = build_model(cfg.model, cfg.diffusion)
    state = loop.init_state(model, cfg, "cpu")
    want = torch.bfloat16 if precision == "full_bf16" else torch.float32
    assert all(p.dtype == want for p in state.params.parameters())
    step = loop.make_train_step(model, cfg)
    before = state.params.final_conv.weight.detach().clone()
    state.step = 1  # the schedule's step 0 has rate 0
    metrics = step(state, _batch(1))
    assert np.isfinite(float(metrics["loss"])) and float(metrics["grad_norm"]) > 0
    assert all(p.grad.dtype == want for p in state.params.parameters() if p.grad is not None)
    assert all(v.dtype == want for s in state.optimizer.state.values() for k, v in s.items() if k.startswith("exp_avg"))
    assert not torch.equal(before, state.params.final_conv.weight)


@pytest.mark.parametrize("flags,match", [
    (["--mixed-precision", "fp16"], "fp16"),
    (["--mixed-precision", "fp8"], "fp8"),
    (["--opt-moments", "int8"], "quant_opt"),
    (["--mesh-model", "2"], "parallel"),
    (["--mesh-data", "2"], "item 5"),
    (["--sample-audio", "song.wav"], "sample"),
    (["--model-type", "rectified-flow"], "rectified"),
])
def test_unported_flags_raise_naming_the_roadmap(tmp_path, flags, match):
    cfg = parse_args(["--dummy-dataset", "--project-dir", str(tmp_path), *flags])
    with pytest.raises(NotImplementedError, match=match) as info:
        train(cfg, device="cpu")
    assert "ROADMAP.md" in str(info.value)


@pytest.mark.parametrize("flags,plans", [
    (["--gradient-checkpointing-mode", "save-attn-out"], [("save-attn-out", "none")] * 4),
    (["--gradient-checkpointing-mode", "resnet-dots"], [("none", "resnet-dots")] * 4),
    (["--gradient-checkpointing-mode", "mixed"], [("save-attn-out", "none")] + [("block", "none")] * 3),  # the flag's default levels
    (["--gradient-checkpointing-mode", "mixed", "--gradient-checkpointing-levels", "resnet,save-attn"],
     [("none", "resnet")] + [("none", "inner")] * 3),
], ids=["save-attn-out", "resnet-dots", "mixed", "mixed-levels"])
def test_remat_flags_reach_the_model(tmp_path, flags, plans):
    from osufusion_tpu_torch.nn.unet import _remat_plan

    cfg = parse_args(["--dummy-dataset", "--project-dir", str(tmp_path), "--gradient-checkpointing", *flags])
    assert [_remat_plan(cfg.model, level) for level in range(4)] == plans
    assert Config.from_json(cfg.to_json()).model == cfg.model  # and survive config.json
    off = parse_args(["--dummy-dataset", "--project-dir", str(tmp_path), *flags])
    assert [_remat_plan(off.model, level) for level in range(4)] == [("none", "none")] * 4


def test_trainer_takes_steps_under_the_mixed_plan_at_a_windowed_length(tmp_path):
    """Samples of 64 to 256 frames padded to 256, four times the attention
    context: every trunk site is windowed, level 0 under ``save-attn-out``,
    level 1 under ``block``, the audio stack under its own override."""
    cfg = _tiny_train_config(tmp_path, total_steps=2)
    cfg = dataclasses.replace(cfg, train=dataclasses.replace(cfg.train, segment_length=128))
    model_cfg = dataclasses.replace(cfg.model, remat=True, remat_mode="mixed", remat_level_modes=("save-attn-out", "block"),
                                    audio_remat_mode="resnet-dots")
    plain = train(dataclasses.replace(cfg, train=dataclasses.replace(cfg.train, project_dir=str(tmp_path / "plain"))), device="cpu")
    history = train(dataclasses.replace(cfg, model=model_cfg), device="cpu")
    assert [h["step"] for h in history] == [1, 2] and loop.checkpoint_steps(tmp_path) == [2]
    assert all(np.isfinite(h["loss"]) and np.isfinite(h["grad_norm"]) for h in history) and history[1]["grad_norm"] > 0
    # a remat plan changes no arithmetic: the same seed takes the same steps without it
    for got, want in zip(history, plain):
        assert got["loss"] == pytest.approx(want["loss"], rel=1e-6) and got["grad_norm"] == pytest.approx(want["grad_norm"], rel=1e-5)
    assert Config.load(tmp_path / "config.json").model == model_cfg


LAUNCH_ENV = ("OSUFUSION_COORDINATOR", "OSUFUSION_NUM_PROCESSES", "OSUFUSION_PROCESS_ID", "WORLD_SIZE", "RANK",
              "LOCAL_RANK", "LOCAL_WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")


@pytest.mark.parametrize("how", ["flags", "osufusion-env", "torchrun-env"])
def test_launch_settings_reach_maybe_initialize(tmp_path, monkeypatch, how):
    """The JAX package's multi-host flags, their environment variables and
    torchrun's environment all reach ``init_process_group`` through the CLI
    (gloo here: this machine has no GPU), before the run starts."""
    import torch.distributed as dist

    from osufusion_tpu_torch import trainer

    calls = []
    for name in LAUNCH_ENV:
        monkeypatch.delenv(name, raising=False)
    monkeypatch.setattr(dist, "is_initialized", lambda: False)
    monkeypatch.setattr(dist, "init_process_group", lambda backend, **kw: calls.append((backend, kw)))
    monkeypatch.setattr(trainer, "train", lambda cfg: calls.append(cfg))
    argv = ["--dummy-dataset", "--project-dir", str(tmp_path), "--mesh-seq", "2"]
    if how == "flags":
        argv += ["--coordinator", "host0:1234", "--num-processes", "2", "--process-id", "1"]
    elif how == "osufusion-env":
        for name, value in (("COORDINATOR", "host0:1234"), ("NUM_PROCESSES", "2"), ("PROCESS_ID", "1")):
            monkeypatch.setenv(f"OSUFUSION_{name}", value)
    else:
        for name, value in (("WORLD_SIZE", "2"), ("RANK", "1"), ("LOCAL_RANK", "1"), ("LOCAL_WORLD_SIZE", "2")):
            monkeypatch.setenv(name, value)
    trainer.main(argv)
    (backend, kw), cfg = calls
    method = "env://" if how == "torchrun-env" else "tcp://host0:1234"
    assert backend == "gloo" and kw == {"init_method": method, "world_size": 2, "rank": 1}
    assert cfg.train.mesh_seq == 2


def test_sequence_parallel_length_must_split(tmp_path):
    """Dummy batches of 64 frames do not split into 3 shards of a multiple of
    2^4 frames: the trainer says so before it starts any process group."""
    cfg = parse_args(["--dummy-dataset", "--project-dir", str(tmp_path), "--segment-length", "32", "--mesh-seq", "3"])
    with pytest.raises(ValueError, match="multiple of 48"):
        train(cfg, device="cpu")
    with pytest.raises(ValueError, match="--mesh-seq 2 runs one process per shard"):  # 64 splits in two; one process
        train(dataclasses.replace(cfg, train=dataclasses.replace(cfg.train, mesh_seq=2)), device="cpu")


def test_trained_checkpoint_serves_in_both_packages(tmp_path):
    cfg = _tiny_train_config(tmp_path, total_steps=2)
    train(cfg, device="cpu")
    path = tmp_path / "model.safetensors"

    variables = jax_load_safetensors(path)
    jmodel = jax_build_model(JModelConfig(**TINY), JDiffusionConfig())
    model, params = load_model(path, device="cpu")
    assert params.cfg.dim_h == TINY["dim_h"] and next(params.parameters()).dtype == torch.float32

    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 40, 6)).astype(np.float32)
    a = rng.normal(-10.0, 3.0, (2, 40, 96)).astype(np.float32)
    t = np.array([10.0, 900.0], np.float32)
    c = rng.uniform(-1, 1, (2, 5)).astype(np.float32)
    mask = np.array([True, False])
    want = np.asarray(jmodel.unet.apply(variables, *(jnp.asarray(v) for v in (x, a, t, c, mask))))
    with torch.no_grad():
        got = params(*(torch.from_numpy(v) for v in (x, a, t, c, mask))).numpy()
    assert np.abs(want).max() > 0  # two steps moved the final conv off zero
    # fp32 through ~30 layers in two frameworks: ~1e-5 relative
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4 * np.abs(want).max())
