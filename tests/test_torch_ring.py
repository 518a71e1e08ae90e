"""Ring attention (K6) on the CPU: gloo groups of 2 and 4 processes, one
shard of the frame axis each (``ring`` in tests/seq_parallel_cases.py),
against the JAX package in fp32.

- The op, through ``ops/attention.py::sdpa`` under the shard, forward and
  gradients: over two shards against JAX ``gqa_attention`` on the gathered
  sequence (the JAX package's own two-shard ring test is red), over four
  against JAX ``ring_attention`` on a four-device CPU mesh in interpret mode;
  MQA with rotary tables, GQA and full MHA without.
- The slice: DiT and MMDiT loss and every gradient over two shards (plain
  and under block remat) against the JAX package's one-device ones with the
  same weights and draws; one AdamW step of a tiny UNet whose every site is
  global against the one-process step.
- ``ring_available`` against the JAX package's rules, and
  ``check_supported`` with ``--mesh-seq 2`` for the transformers.

Each group runs once per test run (``_once``: under pytest-xdist the first
worker to ask spawns it and the others read its results), and the cases read
its results. Every case checks that the ring took its sites and that no
whole sequence was gathered."""

import fcntl
import os
import pickle
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import seq_parallel_cases as cases
import torch
from jax.experimental.pallas import tpu as pltpu
from jax.sharding import Mesh
from test_torch_seq_parallel import LOSS_REL, assert_step_matches, run_group

from osufusion_tpu.config import DiffusionConfig as JDiffusionConfig
from osufusion_tpu.config import ModelConfig as JModelConfig
from osufusion_tpu.models import build_model as jax_build_model
from osufusion_tpu.ops.attention import gqa_attention
from osufusion_tpu.ops.rope import apply_rope as jax_apply_rope
from osufusion_tpu.ops.rope import rope_tables as jax_rope_tables
from osufusion_tpu.parallel.ring import ring_attention as jax_ring_attention
from osufusion_tpu.parallel.ring import ring_available as jax_ring_available
from osufusion_tpu.utils.serialization import flatten_params
from osufusion_tpu_torch.config import Config
from osufusion_tpu_torch.parallel.ring import ring_available
from osufusion_tpu_torch.train import loop
from osufusion_tpu_torch.trainer import parse_args
from osufusion_tpu_torch.utils.convert import jax_flat_from_state_dict, state_dict_from_jax
from tests.torch_helpers import random_variables

torch.set_num_threads(2)

# fp32 on both sides; the ring adds each row's hops in the exp2 domain and the
# gradients hop by hop, another order than one softmax: ~1e-6. The JAX
# package's own tolerances of its ring tests (forward, then gradients)
O_TOL = dict(atol=2e-5, rtol=2e-5)
GRAD_TOL = dict(atol=5e-5, rtol=5e-4)
# the transformers' loss and gradients against one JAX device: the tolerances
# of tests/test_torch_dit.py (two blocks, fp32, sums in another order; the
# sharded statistics and loss add the same terms in another order again)
LOSS_TOL, GRAD_RTOL, GRAD_ATOL = 1e-5, 2e-3, 2e-5
BACKBONES = ["dit", "mmdit"]


def _once(tmp_path_factory, name: str, compute):
    """``compute()`` once per test run: under pytest-xdist the first worker
    to ask computes and pickles it in the run's shared base directory, the
    others wait on a lock and read it."""
    if "PYTEST_XDIST_WORKER" not in os.environ:
        return compute()
    root = tmp_path_factory.getbasetemp().parent
    path = root / f"{name}.pkl"
    with open(root / f"{name}.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not path.exists():
            path.write_bytes(pickle.dumps(compute()))
    return pickle.loads(path.read_bytes())


def _transformer_reference(backbone: str):
    """The JAX package's loss and gradients of one batch (jitted), with the
    weights (the port's state dict) and the draws its loss makes."""
    jmodel = jax_build_model(JModelConfig(backbone=backbone, **cases.RING_TRANSFORMER), JDiffusionConfig())
    args = (jnp.zeros((1, 32, 6)), jnp.zeros((1, 32, 96)), jnp.zeros((1,)), jnp.zeros((1, 5)), jnp.ones((1,), bool))
    variables = random_variables(jmodel.unet, *args, seed=4)
    weights = {k: v.numpy() for k, v in state_dict_from_jax({k: np.asarray(v) for k, v in
                                                            flatten_params(variables).items()}).items()}
    B, T = cases.B, cases.T_SONG
    rng = np.random.default_rng(0)
    batch = (rng.uniform(-1, 1, (B, 6, T)).astype(np.float32), rng.normal(-10, 1, (B, 96, T)).astype(np.float32),
             rng.uniform(-1, 1, (B, 5)).astype(np.float32), np.array([T, T - 70], np.int32))
    key = jax.random.PRNGKey(7)
    k_noise, k_t, k_drop = jax.random.split(key, 3)
    draws = (np.asarray(jax.random.normal(k_noise, (B, T, 6), jnp.float32)).transpose(0, 2, 1),
             np.asarray(jax.random.randint(k_t, (B,), 0, 1000)), np.asarray(jax.random.bernoulli(k_drop, 0.5, (B,))))
    loss, grads = jax.jit(jax.value_and_grad(jmodel.loss))(variables, key, *(jnp.asarray(b) for b in batch))
    want = (float(loss), {k: np.asarray(v) for k, v in flatten_params(grads).items()})
    return (weights, batch, draws), want


@pytest.fixture(scope="module")
def transformers(tmp_path_factory):
    """backbone -> ((weights, batch, draws), (JAX loss, JAX gradients))."""
    return _once(tmp_path_factory, "ring_transformers", lambda: {b: _transformer_reference(b) for b in BACKBONES})


@pytest.fixture(scope="module")
def group2(tmp_path_factory, transformers):
    """Each rank's results of two shards: the sites, the transformers, the UNet."""
    inputs = {b: ref[0] for b, ref in transformers.items()}
    return _once(tmp_path_factory, "ring_group2", lambda: run_group(
        2, "ring", tmp_path_factory.mktemp("ring2"), cases.RING_SITES, inputs))


@pytest.fixture(scope="module")
def group4(tmp_path_factory):
    return _once(tmp_path_factory, "ring_group4", lambda: run_group(
        4, "ring", tmp_path_factory.mktemp("ring4"), cases.RING_SITES_4))


def _jax_site(name: str, sites: dict, attend):
    """o and (dq, dk, dv) of ``attend(q, k, v)`` on the whole sequence, with
    the rotary tables applied first where the site has them."""
    _, T, _, _, tables = sites[name]
    q, k, v, do = (jnp.asarray(t.numpy()) for t in cases.ring_site_inputs(name, sites))
    rope = jax_rope_tables(T, 64, cases.ROPE_BASE) if tables else None

    def site(q, k, v):
        if rope is not None:
            q, k = jax_apply_rope(q, *rope), jax_apply_rope(k, *rope)
        return attend(q, k, v)

    # jitted: the JAX ring in interpret mode waits forever on an operand computed eagerly on one device
    o, vjp = jax.vjp(jax.jit(site), q, k, v)
    return [np.asarray(t) for t in (o, *vjp(do))]


def _check_site(got: list, want: list, name: str) -> None:
    n = len(got)
    for i, result in enumerate(got):
        r = result["sites"][name]
        assert r["routes"] == {"ring": 1, "gather": 0, "ring_fwd": 1}, f"{name}, rank {i}: routes {r['routes']}"
        for part, a, b in zip(("o", "dq", "dk", "dv"), r["grads"], want):
            np.testing.assert_allclose(a, np.split(b, n, axis=1)[i], **(O_TOL if part == "o" else GRAD_TOL),
                                       err_msg=f"{name}, rank {i}, {part}")


@pytest.mark.parametrize("name", sorted(cases.RING_SITES))
def test_ring_over_two_shards_matches_jax_attention_on_the_whole_sequence(group2, name):
    _check_site(group2, _jax_site(name, cases.RING_SITES, gqa_attention), name)


def jax_ring_sites() -> dict:
    """site -> the JAX ring's o and gradients at RING_SITES_4, on a
    four-device mesh in interpret mode, in this process."""
    mesh = Mesh(np.asarray(jax.devices()[:4]), axis_names=("seq",))
    with pltpu.force_tpu_interpret_mode():
        return {name: _jax_site(name, cases.RING_SITES_4, lambda q, k, v: jax_ring_attention(q, k, v, mesh))
                for name in cases.RING_SITES_4}


@pytest.fixture(scope="module")
def jax_ring4(tmp_path_factory):
    """``jax_ring_sites`` in an interpreter of its own: the JAX package's ring
    in interpret mode has aborted a test worker whose JAX runtime an earlier
    test had left in error (the known-red tests of queue 3 run first on some
    workers)."""
    tests = Path(__file__).resolve().parent
    code = (f"import pickle, sys; sys.path[:0] = {[str(tests), str(tests.parent)]!r}; import test_torch_ring; "
            "sys.stdout.buffer.write(pickle.dumps(test_torch_ring.jax_ring_sites()))")

    def compute():
        env = {**os.environ, "JAX_PLATFORMS": "cpu", "XLA_FLAGS": "--xla_force_host_platform_device_count=4"}
        proc = subprocess.run([sys.executable, "-c", code], capture_output=True, env=env, timeout=600)
        assert proc.returncode == 0, proc.stderr.decode()[-3000:]
        return pickle.loads(proc.stdout)

    return _once(tmp_path_factory, "ring_jax4", compute)


@pytest.mark.parametrize("name", sorted(cases.RING_SITES_4))
def test_ring_over_four_shards_matches_the_jax_ring(group4, jax_ring4, name):
    """Against ``osufusion_tpu.parallel.ring.ring_attention`` on a four-device
    mesh (one ring per KV head there, every KV head at once here)."""
    _check_site(group4, jax_ring4[name], name)


@pytest.mark.parametrize("remat", ["plain", "remat"])
@pytest.mark.parametrize("backbone", BACKBONES)
def test_sharded_transformer_loss_and_gradients_match_jax(group2, transformers, backbone, remat):
    """Two shards of T = 256 (DiT: 128 frames a rank; MMDiT: 32 + 32 packed
    tokens); each block's site takes the ring once, twice under remat (the
    recompute runs the forward ring again), and nothing is gathered."""
    want_loss, want_grads = transformers[backbone][1]
    depth = cases.RING_TRANSFORMER["depth"]
    for i, result in enumerate(group2):
        r = result[f"{backbone}-{remat}"]
        runs = depth * (2 if remat == "remat" else 1)
        assert r["routes"] == {"ring": runs, "gather": 0, "ring_fwd": runs}, f"rank {i}: {r['routes']}"
        assert r["loss"] == pytest.approx(want_loss, rel=LOSS_TOL), f"rank {i}"
    grads = jax_flat_from_state_dict({k: torch.from_numpy(v) for k, v in group2[0][f"{backbone}-{remat}"]["grads"].items()})
    assert set(grads) == set(want_grads)
    scale = max(np.abs(v).max() for v in want_grads.values())
    for name, value in want_grads.items():
        np.testing.assert_allclose(grads[name], value, rtol=GRAD_RTOL, atol=GRAD_ATOL * max(1.0, scale), err_msg=name)


@pytest.fixture(scope="module")
def one_process_unet_step():
    return cases.unet_step(cases.unet_config(**cases.RING_UNET))


@pytest.mark.parametrize("plan", ["unet", "unet-save-attn-out"])
def test_all_global_unet_step_over_two_shards_matches_one_process(group2, one_process_unet_step, plan):
    """The tiny UNet with a context of T (every site global, levels of 128 and
    64 frames a rank all take the ring): loss, gradient norm and every
    parameter after one AdamW step, the JAX package's tolerances of its
    sharded step; under ``save-attn-out`` (which changes no arithmetic) the
    backward keeps the ring op's outputs and runs no forward ring again."""
    loss, norm, params, grads = one_process_unet_step
    got = [r[plan] for r in group2]
    sites = group2[0]["unet"]["routes"]["ring"]
    assert len({r["checksum"] for r in got}) == 1, "the ranks' parameters differ"
    for r in got:
        assert r["routes"]["gather"] == 0 and r["routes"]["ring_fwd"] == sites > 0, r["routes"]
        assert r["loss"] == pytest.approx(loss, rel=LOSS_REL) and r["grad_norm"] == pytest.approx(norm, rel=LOSS_REL)
    assert_step_matches(got[0], params, grads, norm, loop.make_lr_schedule(cases.unet_config(**cases.RING_UNET))(1))


# (t, s, d, window, n, h, kv): test_ring_availability_rules' cases, the full-MHA one of
# test_ring_full_mha_timestep_fold and a head dim of 128, which both packages decide alike
SAME = [(512, 512, 64, 128, 4, 1, 1), (512, 512, 64, 512, 4, 1, 1), (512, 512, 64, None, 4, 1, 1),
        (512, 512, 64, None, 1, 1, 1), (256, 256, 64, None, 8, 1, 1), (512, 256, 64, None, 4, 1, 1),
        (512, 512, 48, None, 4, 1, 1), (512, 512, 64, None, 2, 4, 4), (512, 512, 128, None, 4, 1, 1)]
# where they differ, by design: the JAX package refuses a full-MHA shard that no
# timestep fold tiles (a TPU tiling rule; the port has no fold)
DIFFERENT = [((256, 256, 64, None, 4, 4, 4), True), ((384, 384, 64, None, 2, 2, 2), True)]


@pytest.mark.parametrize("args", SAME)
def test_ring_available_keeps_the_jax_rules(args):
    assert ring_available(*args) == jax_ring_available(*args)


@pytest.mark.parametrize("args,port", DIFFERENT)
def test_ring_available_documented_differences(args, port):
    assert ring_available(*args) == port and jax_ring_available(*args) != port


@pytest.mark.parametrize("backbone", BACKBONES)
def test_check_supported_takes_a_sequence_shard_for_the_transformers(tmp_path, backbone):
    cfg = parse_args(["--dummy-dataset", "--project-dir", str(tmp_path), "--model-backbone", backbone, "--mesh-seq", "2"])
    loop.check_supported(cfg)
    assert Config.from_json(cfg.to_json()).train.mesh_seq == 2


def test_mmdit_shard_must_hold_whole_patches():
    """The padding to whole patches belongs to the whole song: a shard of 62
    frames (patches of 4) raises before any collective."""
    from osufusion_tpu_torch.config import ModelConfig
    from osufusion_tpu_torch.nn.mmdit import MMDiT
    from osufusion_tpu_torch.parallel.sequence import SeqShard, sequence_sharding

    net = MMDiT(ModelConfig(backbone="mmdit", dim_h=32, attn_heads=4, attn_dim_head=8, depth=1, patch_size=4,
                            dtype="float32"))
    x, a = torch.zeros((1, 62, 6)), torch.zeros((1, 62, 96))
    with sequence_sharding(SeqShard(group=None, index=0, count=2)), pytest.raises(ValueError, match="whole patches"):
        net(x, a, torch.zeros(1), torch.zeros((1, 5)))
