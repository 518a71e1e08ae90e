"""Sequence parallelism on the CPU: gloo groups of 2 and 4 processes, one
shard of the frame axis each (tests/seq_parallel_cases.py), against one
process: the halo exchange and its backward at the song's ends, the sharded
attention (halo kernels' plain versions at a windowed site, the gathered
sequence at a global one), every UNet block with a cross-shard step, and one
AdamW step of the tiny UNet (plain and under the ``mixed`` remat plan), whose
one-process result the other tests hold to the JAX package; the trainer
across a save and a resume.

Each group joins through a file store under the test's own directory and
must report within ``TIMEOUT`` seconds: a rank that waits on a collective
that another never posts (a remat order that differs between ranks) fails
the test instead of holding the suite."""

import multiprocessing
import queue as queue_module
import time

import numpy as np
import pytest
import seq_parallel_cases as cases
import torch

from osufusion_tpu_torch.nn.blocks import sdpa
from osufusion_tpu_torch.ops.rope import rope_tables
from osufusion_tpu_torch.train import loop

torch.set_num_threads(2)

TIMEOUT = 60
# fp32 both sides; the sharded sums (norm statistics, softmax denominators, the
# loss) add the same terms in another order: ~1e-7 relative
TOL = dict(atol=2e-5, rtol=2e-5)
# the JAX package's tolerances for the train step (test_seq_parallel_train_step_matches_dp)
LOSS_REL = 1e-4
PARAM_TOL = dict(atol=5e-5, rtol=5e-4)


def run_group(n: int, case: str, tmp_path, *args) -> list:
    """Each rank's result of ``case`` (with ``args``), in rank order."""
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    procs = [ctx.Process(target=cases.rank_main, args=(r, n, str(tmp_path / "store"), case, results, *args))
             for r in range(n)]
    for p in procs:
        p.start()
    got, deadline = {}, time.monotonic() + TIMEOUT
    try:
        while len(got) < n:
            try:
                rank, error, value = results.get(timeout=1)
            except queue_module.Empty:
                # a rank that died before reporting fails the test now, not at the deadline
                if time.monotonic() > deadline or any(p.exitcode is not None and r not in got for r, p in enumerate(procs)):
                    pytest.fail(f"case {case!r}: ranks {sorted(set(range(n)) - set(got))} of {n} did not report "
                                f"(exit codes {[p.exitcode for p in procs]})")
                continue
            assert error is None, f"rank {rank} of {n}:\n{error}"
            got[rank] = value
    finally:
        for p in procs:
            p.join(timeout=TIMEOUT)
            if p.is_alive():
                p.terminate()
                p.join()
    assert not any(p.is_alive() for p in procs)
    return [got[r] for r in range(n)]


def frames(t: torch.Tensor, n: int, i: int, dim: int = 1) -> torch.Tensor:
    size = t.shape[dim] // n
    return t.narrow(dim, i * size, size)


@pytest.mark.parametrize("n", [2, 4])
def test_exchange_halo_and_its_backward(n, tmp_path):
    """Zeros beyond the song's ends; each halo's gradient goes home and is
    added to the rows it came from; the ends' halo gradients go nowhere."""
    got = run_group(n, "exchange", tmp_path)
    x, weights = cases.exchange_inputs(n)
    x = x.clone().requires_grad_(True)
    left, right = cases.HALO
    padded = torch.nn.functional.pad(x, (0, 0, left, right))
    t = x.shape[1] // n
    want = [padded[:, i * t : i * t + t + left + right] for i in range(n)]
    sum((w * wt).sum() for w, wt in zip(want, weights)).backward()
    for i, result in enumerate(got):
        np.testing.assert_array_equal(result["y"], want[i].detach().numpy())
        np.testing.assert_allclose(result["grad"], frames(x.grad, n, i).numpy(), **TOL)


@pytest.mark.parametrize("n", [2, 4])
def test_sequence_parallel_attention_matches_one_process(n, tmp_path):
    """Each site's o and gradients against one process; a windowed site runs
    the halo kernels once per KV head (two KV heads: twice), a global one
    gathers the sequence."""
    got = run_group(n, "attention", tmp_path)
    for name, window, base, kv in cases.ATTENTION_SITES:
        q, k, v, do = cases.attention_inputs(n, kv)
        leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
        out = sdpa(*leaves, window, rope_tables(cases.T_SONG, 64, scale_base=base))
        out.backward(do)
        for i, result in enumerate(got):
            *tensors, halo_calls = result[name]
            assert halo_calls == (kv if window is not None else 0), f"{name}, rank {i}: {halo_calls} halo calls"
            for grad_name, a, b in zip(("o", "dq", "dk", "dv"), tensors, (out.detach(), *(t.grad for t in leaves))):
                np.testing.assert_allclose(a, frames(b, n, i).numpy(), **TOL, err_msg=f"{name}, rank {i}, {grad_name}")


@pytest.mark.parametrize("n", [2, 4])
def test_sharded_blocks_match_one_process(n, tmp_path):
    got = run_group(n, "blocks", tmp_path)
    for name, (module, width) in cases.block_modules().items():
        x, g = cases.block_inputs(name, width, n)
        x = x.clone().requires_grad_(True)
        y = module(x)
        (y * g).sum().backward()
        gate = name in ("global_context", "squeeze_excite")
        for i, result in enumerate(got):
            y_i, dx_i, _ = result[name]
            want = y.detach() if gate else frames(y.detach(), n, i)
            np.testing.assert_allclose(y_i, want.numpy(), **TOL, err_msg=f"{name} output, rank {i}")
            np.testing.assert_allclose(dx_i, frames(x.grad, n, i).numpy(), **TOL, err_msg=f"{name} input gradient, rank {i}")
        for p_name, p in module.named_parameters():  # each rank holds its frames' share
            total = sum(result[name][2][p_name] for result in got)
            np.testing.assert_allclose(total, p.grad.numpy(), **TOL, err_msg=f"{name}.{p_name} gradient")


@pytest.fixture(scope="module")
def one_process_step():
    return cases.unet_step(cases.unet_config())


@pytest.mark.parametrize("n,case", [(2, "unet"), (4, "unet"), (2, "unet-mixed")], ids=["seq2", "seq4", "seq2-mixed"])
def test_unet_train_step_matches_one_process(n, case, tmp_path, one_process_step):
    """Loss, gradient norm and every parameter after one AdamW step; all ranks
    end with the same parameters."""
    got = run_group(n, case, tmp_path)
    loss, norm, params = one_process_step
    assert len({r["checksum"] for r in got}) == 1, "the ranks' parameters differ"
    for r in got:
        assert r["loss"] == pytest.approx(loss, rel=LOSS_REL) and r["grad_norm"] == pytest.approx(norm, rel=LOSS_REL)
    lr = loop.make_lr_schedule(cases.unet_config())(1)
    for name, value in params.items():
        # the bias in front of GlobalContext's softmax over T shifts every logit
        # alike: its true gradient is zero, each run computes rounding noise, and
        # Adam turns the noise into a step of up to the learning rate either way
        tol = dict(atol=2.02 * lr, rtol=0) if name.endswith("GlobalContext_0.Dense_0.bias") else PARAM_TOL
        np.testing.assert_allclose(got[0]["params"][name], value.numpy(), **tol, err_msg=name)


def test_trainer_runs_sequence_parallel_across_a_resume(tmp_path):
    """``trainer.train`` in two processes (``--mesh-seq 2``): one step and a
    save by rank 0, a resume on both, a second step; the same losses and norms
    as one process on the same dummy batches, and rank 0's files."""
    from osufusion_tpu_torch.train.loop import checkpoint_steps
    from osufusion_tpu_torch.trainer import train

    got = run_group(2, "trainer", tmp_path, str(tmp_path / "seq"))
    want = train(cases.trainer_config(str(tmp_path / "one"), 1, 2), device="cpu")
    assert [(h["loss"], h["grad_norm"]) for h in got[0]] == [(h["loss"], h["grad_norm"]) for h in got[1]]
    for seq_step, one_step in zip(got[0], want):
        assert seq_step["step"] == one_step["step"]
        assert seq_step["loss"] == pytest.approx(one_step["loss"], rel=LOSS_REL)
        assert seq_step["grad_norm"] == pytest.approx(one_step["grad_norm"], rel=LOSS_REL)
    assert len(got[0]) == 2 and checkpoint_steps(tmp_path / "seq") == [1, 2]
    assert (tmp_path / "seq" / "model.safetensors").exists() and (tmp_path / "seq" / "data_state.json").exists()
