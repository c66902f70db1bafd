"""Data parallelism of the port on the CPU: two gloo ranks, each on its rows
of one global batch, equal one rank on the whole batch (the counterpart of
``tests/test_multihost.py``).

The module's fixture starts the two ranks once (``tests/torch_dp_cases.py``
as a script: torch and the port, no JAX) and runs the one-rank cases in
this process meanwhile; every test reads what they wrote.  The one-rank
run is the port's own, which the other port tests hold against the JAX
package.
"""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from tests import torch_dp_cases as cases

TESTS_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(TESTS_DIR)
WORLD = 2
#: the JAX test's tolerances for every parameter and BN statistic after a
#: step (``tests/test_multihost.py``): the ranks' partial sums add in another
#: order, which BatchNorm over a few samples amplifies
STATE_TOL = dict(rtol=1e-4, atol=2e-4)
#: the momentum buffers (the gradient, plus 0.9 of the last one) are held
#: to STATE_TOL plus this share of each tensor's largest entry.  After a
#: plain 3D step and the finetune steps the ranks' gradients meet STATE_TOL
#: but for 6e-5 of the largest entry; after the mixup step and the 2D step
#: they are off by up to 1.2e-1 and 4.0e-2 of it, as ill-conditioned as the
#: one-rank f32 gradient there (BatchNorm over 4 or 8 pooled samples, made
#: more alike by mixing; JAX's own f32 gradient of the 2D model is off from
#: float64 by up to 9.4e-2, ``tests/test_torch_model2d.py``), so those take
#: 0.15; the parameters, which move by lr × momentum, stay at STATE_TOL.
MOMENTUM_REL = {"plain": 1e-3, "chaotic": 0.15}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread per test worker (the suite runs several a host)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(the one-rank results, [rank 0's, rank 1's])."""
    out = tmp_path_factory.mktemp("dp")
    env = {k: v for k, v in os.environ.items() if k not in ("RANK", "WORLD_SIZE")}
    env.update(OMP_NUM_THREADS="1", PYTHONPATH=ROOT + os.pathsep + env.get("PYTHONPATH", ""))
    port = str(_free_port())
    script = os.path.join(TESTS_DIR, "torch_dp_cases.py")
    procs = [subprocess.Popen([sys.executable, script, str(r), str(WORLD), port, str(out)],
                              cwd=ROOT, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT) for r in range(WORLD)]
    try:
        one = cases.run_all(0, 1, None, str(out / "one"))
        logs = [p.communicate(timeout=600)[0].decode(errors="replace") for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r} failed:\n{log[-4000:]}"
    return one, [torch.load(out / f"rank{r}.pt", weights_only=False) for r in range(WORLD)]


def _rows(t, rank):
    return cases.rows(t, rank, WORLD)


def _close(got, want, rel):
    """Within ``rel`` of each entry and ``rel`` of the tensor's largest."""
    want = np.asarray(want, np.float64)
    np.testing.assert_allclose(np.asarray(got, np.float64), want, rtol=rel,
                               atol=rel * max(np.abs(want).max(), 1e-30))


def _metrics_close(got, want):
    """The loss within 1e-4 relative; each term and metric within 1e-4 of
    the loss (a term can be far smaller than the total)."""
    assert set(got) == set(want)
    for k, v in want.items():
        np.testing.assert_allclose(got[k], v, rtol=1e-4, atol=1e-4 * abs(want["loss"]) * (
            k != "loss"), err_msg=k)


def _state_close(got, want, momentum="plain"):
    """Parameters, BN statistics, momentum and the step counter."""
    assert got["step"] == want["step"]
    assert set(got["state"]) == set(want["state"])
    for k, v in want["state"].items():
        np.testing.assert_allclose(got["state"][k].numpy(), v.numpy(), err_msg=k, **STATE_TOL)
    assert len(got["momentum"]) == len(want["momentum"])
    for i, (a, b) in enumerate(zip(got["momentum"], want["momentum"])):
        atol = STATE_TOL["atol"] + MOMENTUM_REL[momentum] * b.abs().max().item()
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=STATE_TOL["rtol"], atol=atol,
                                   err_msg=f"momentum {i}")


def test_ranks_import_no_jax(runs):
    _, two = runs
    assert [r["modules"] for r in two] == [[], []]


@pytest.mark.parametrize("shape", ["5d", "4d"])
def test_batch_norm_two_ranks_equal_one(runs, shape):
    """Output and input gradient (each rank's rows), weight and bias
    gradients (summed over the ranks: the loss is the sum of theirs) and
    the running statistics (the same on every rank), f32 at 1e-6
    relative."""
    one, two = runs
    want = one["bn"][shape]
    for r, res in enumerate(two):
        got = res["bn"][shape]
        _close(got["y"], _rows(want["y"], r), 1e-6)
        _close(got["dx"], _rows(want["dx"], r), 1e-6)
        _close(got["mean"], want["mean"], 1e-6)
        _close(got["var"], want["var"], 1e-6)
    for k in ("dw", "db"):
        _close(sum(res["bn"][shape][k] for res in two), want[k], 1e-6)


def test_pretask_step_two_ranks_equal_one(runs):
    """``train_step`` of ``PCRLv23d`` on 2 × 2 rows against 4: the global
    loss and metrics on every rank, and the state."""
    one, two = runs
    for res in two:
        got = res["pretask3d"]
        _metrics_close(got["m1"], one["pretask3d"]["m1"])
        _state_close(got["s1"], one["pretask3d"]["s1"])


def test_remat_step_equals_the_plain_step_on_two_ranks(runs):
    """``PCRLv23d(remat=True)`` under the 2-rank group: each rank's step
    equals its plain step bit for bit (metrics, parameters, BN statistics,
    momentum): the recomputed BatchNorms' all-reduces stayed matched across
    the ranks and advanced no statistic twice."""
    _, two = runs
    for res in two:
        got, want = res["remat3d"], res["pretask3d"]
        assert got["m"] == want["m1"]
        assert got["s"]["step"] == want["s1"]["step"]
        for k, v in want["s1"]["state"].items():
            assert torch.equal(got["s"]["state"][k], v), k
        assert all(torch.equal(a, b) for a, b in zip(got["s"]["momentum"],
                                                     want["s1"]["momentum"]))


def test_mixup_step_permutes_the_global_batch(runs):
    """``pipelined_train_step(mixup_alpha=0.2)``: λ, the permutation (over
    the 4 rows of the global batch) and the levels drawn alike on every
    rank, each rank keeping its rows of the mixed batch."""
    one, two = runs
    for res in two:
        got = res["pretask3d"]
        _metrics_close(got["m2"], one["pretask3d"]["m2"])
        _state_close(got["s2"], one["pretask3d"]["s2"], "chaotic")


def test_guard_reverts_every_rank(runs):
    """A NaN in the last rank's rows only: the global loss is NaN on every
    rank, so every rank skips the step and its state is bit-identical to
    before it."""
    one, two = runs
    for res in [one] + two:
        got = res["pretask3d"]
        assert got["m3"]["skipped"] == 1.0 and not np.isfinite(got["m3"]["loss"])
        assert got["s3"]["step"] == got["s2"]["step"] == 2
        for k, v in got["s2"]["state"].items():
            assert torch.equal(got["s3"]["state"][k], v), k
        assert all(torch.equal(a, b) for a, b in zip(got["s3"]["momentum"],
                                                     got["s2"]["momentum"]))


def test_2d_step_two_ranks_equal_one(runs):
    """``train_step`` of the 2D ``PCRLv2`` on 2 × 4 rows against 8."""
    one, two = runs
    for res in two:
        _metrics_close(res["pretask2d"]["m"], one["pretask2d"]["m"])
        _state_close(res["pretask2d"]["s"], one["pretask2d"]["s"], "chaotic")


@pytest.mark.parametrize("dim", [3, 2])
def test_finetune_step_two_ranks_equal_one(runs, dim):
    """The 3D segmentation step (the Dice over the global batch) and the 2D
    classifier step with dropout (the ranks' masks are the one-rank
    mask's rows)."""
    one, two = runs
    name = f"finetune{dim}d"
    for res in two:
        _metrics_close(res[name]["m"], one[name]["m"])
        _state_close(res[name]["s"], one[name]["s"])


def test_eval_auc_two_ranks_equal_one(runs):
    """``FinetuneTrainer.evaluate``: the ranks' sums and counts added, the
    logits and labels gathered before the AUC."""
    one, two = runs
    assert set(one["eval"]) == {"eval_loss", "eval_acc", "eval_auc"}
    for res in two:
        assert set(res["eval"]) == set(one["eval"])
        for k, v in one["eval"].items():
            np.testing.assert_allclose(res["eval"][k], v, rtol=1e-5, err_msg=k)
