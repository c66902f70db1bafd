"""The port's CLI and trainer under data parallelism on the CPU: ``--device
cpu --gpus 0,1`` spawns two gloo ranks, which train, evaluate, write one
``.pt`` and a metrics file each, and resume (the counterpart of
``tests/multihost_trainer_worker.py``); the device count, the batch check
and the per-rank data: rows of the JAX CLI's global batches under
``--gpus``, interleaved slices under ``--multihost``.

The module's fixture runs the CLI three times in one process (so the
spawned ranks start from a process that never imported JAX): one run of
epochs 0-1, and the same run interrupted after epoch 0 and resumed.
"""

import argparse
import json
import os
import shlex
import subprocess
import sys

import numpy as np
import pytest
import torch

from pcrlv2_tpu_torch.cli import main as cli
from pcrlv2_tpu_torch.core import mesh
from pcrlv2_tpu_torch.models.unet3d import PCRLv23d
from pcrlv2_tpu_torch.train import checkpoint as ckpt

TESTS_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(TESTS_DIR)


def _tiny_tree(root):
    """A processed-LUNA layout at 16×16×8 crops with 2 local views of 8³:
    10 subsets of one UID with 2 pairs (14 train crops, 6 held out)."""
    rng = np.random.RandomState(0)
    for s in range(10):
        d = os.path.join(root, f"subset{s}")
        os.makedirs(d)
        for k in range(2):
            np.save(os.path.join(d, f"1.2.{s}.0_global_{k}.npy"),
                    rng.rand(2, 16, 16, 8).astype(np.float32))
            np.save(os.path.join(d, f"1.2.{s}.0_local_{k}.npy"),
                    rng.rand(2, 8, 8, 8).astype(np.float32))


def _argv(tree, out, epochs, *extra):
    return ["--data", tree, "--device", "cpu", "--gpus", "0,1", "--b", "4",
            "--steps_per_epoch", "1", "--eval_every", "1", "--save_every", "1",
            "--log_every", "1", "--output", out, "--epochs", str(epochs), *extra]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{"whole", "cut", "log"}: the output directories of the uninterrupted
    run and of the interrupted-and-resumed one, and the runs' output."""
    tmp = tmp_path_factory.mktemp("dpcli")
    tree = str(tmp / "tree")
    _tiny_tree(tree)
    whole, cut = str(tmp / "whole"), str(tmp / "cut")
    argvs = [_argv(tree, whole, 1), _argv(tree, cut, 0),
             _argv(tree, cut, 1, "--resume", os.path.join(cut, "train_state"))]
    code = ("import sys\nfrom pcrlv2_tpu_torch.cli.main import main\n"
            f"for argv in {argvs!r}:\n    main(argv)\n"
            "print(sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'flax', 'pcrlv2_tpu')))\n")
    env = {k: v for k, v in os.environ.items() if k not in ("RANK", "WORLD_SIZE")}
    env.update(OMP_NUM_THREADS="1", PYTHONPATH=ROOT + os.pathsep + env.get("PYTHONPATH", ""))
    proc = subprocess.run([sys.executable, "-c", code], cwd=str(tmp), env=env,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    return {"whole": whole, "cut": cut, "log": proc.stdout}


def _rows(path):
    return [json.loads(s) for s in open(path)]


def test_two_ranks_train_evaluate_and_write_once(runs):
    """Each epoch: one step of 2 × 2 rows, then eval over the 6 held-out
    crops (one global batch of 4, 2 rows a rank; the ragged tail of 2
    skipped, with the warning); one ``.pt`` (rank 0's), loading strictly;
    ``metrics.jsonl`` and ``metrics.rank1.jsonl``, the global loss in
    both."""
    out, log = runs["whole"], runs["log"]
    assert "==> data parallel: 2 device(s) of the 2 --gpus lists" in log
    assert "WARNING: eval tail batch of 2 samples skipped" in log
    assert log.rstrip().splitlines()[-1] == "[]"  # the CLI's process imported no JAX
    pts = sorted(f for f in os.listdir(out) if f.endswith(".pt"))
    assert pts == ["pcrlv2_luna_pretask_1.0_0.pt"]
    ckpt.import_pcrlv23d(os.path.join(out, pts[0]), PCRLv23d(device="cpu", seed=1))
    rank0 = _rows(os.path.join(out, "metrics.jsonl"))
    rank1 = _rows(os.path.join(out, "metrics.rank1.jsonl"))
    steps = [[r for r in rows if "iter" in r] for rows in (rank0, rank1)]
    assert [r["epoch"] for r in steps[0]] == [r["epoch"] for r in steps[1]] == [0, 1]
    for a, b in zip(*steps):
        assert a["loss"] == b["loss"] and a["skipped"] == 0.0
    evals = [[r["eval"] for r in rows if "eval" in r] for rows in (rank0, rank1)]
    assert len(evals[0]) == 2 and evals[0] == evals[1]
    assert all(np.isfinite(v) for ev in evals[0] for v in ev.values())


def test_resume_restores_the_state_and_each_ranks_generators(runs):
    """Epoch 0, then ``--resume`` at epoch 1: the same train state as the
    run that went on, bit for bit: parameters, statistics, momentum, step,
    and each rank's generators (rank 1's from ``state.rank1.pt``)."""
    assert "==> resumed at epoch 1 (global step 1)" in runs["log"]
    for name in ("state.pt", "state.rank1.pt"):
        want, got = (torch.load(os.path.join(runs[k], "train_state", name), weights_only=True)
                     for k in ("whole", "cut"))
        assert set(got) == set(want) and got["epoch"] == 1
        for k, v in want.items():
            if isinstance(v, dict):
                assert set(got[k]) == set(v)
                assert all(torch.equal(got[k][n], v[n]) for n in v), (name, k)
            elif isinstance(v, list):
                assert all(torch.equal(a, b) for a, b in zip(got[k], v)), (name, k)
            else:
                assert got[k] == v, (name, k)
    gens = [torch.load(os.path.join(runs["whole"], "train_state", n),
                       weights_only=True)["generators"] for n in ("state.pt", "state.rank1.pt")]
    assert torch.equal(gens[0]["level"], gens[1]["level"])  # the levels: alike
    assert not torch.equal(gens[0]["aug"], gens[1]["aug"])  # the augmentation: each its own


def test_lists_are_sliced_per_rank_and_trimmed_to_a_common_length():
    """``shard_for_process`` under ``--multihost``:
    ``lst[rank::world][:len(lst)//world]`` and the ``b / world`` batch; one
    rank, and ranks spawned for ``--gpus``, pass through."""
    lst = [f"s{i}" for i in range(7)]
    for args in (argparse.Namespace(b=8, rank=0, world=1, multihost=True),
                 argparse.Namespace(b=8, rank=1, world=2, multihost=False)):
        assert cli.shard_for_process(args, lst) == (args, (lst,))
    for rank, want in ((0, ["s0", "s2", "s4"]), (1, ["s1", "s3", "s5"])):
        local, (sliced,) = cli.shard_for_process(
            argparse.Namespace(b=8, rank=rank, world=2, multihost=True), lst)
        assert sliced == want and local.b == 4


def _loaders(argv, rank, world, monkeypatch):
    """The loaders ``prepare`` builds for rank ``rank`` of ``world`` (the
    call each spawned rank makes), on the CPU."""
    monkeypatch.setattr(mesh, "world", lambda group=None: world)
    monkeypatch.setattr(mesh, "rank", lambda group=None: rank)
    return cli.prepare(argv, torch.device("cpu"), group=object() if world > 1 else None)[2]


def test_gpus_ranks_take_their_rows_of_the_global_batches(tmp_path, monkeypatch):
    """``--device cpu --gpus 0,1``: each epoch's train batches and the eval
    batches of the two ranks, gathered in rank order, are the one-process
    run's global batches row for row (the JAX CLI's one process over its
    data mesh); nothing is left out but the train list's ``drop_last``
    tail and the eval tail the ranks skip.  ``--multihost`` keeps the
    interleaved slices."""
    tree = str(tmp_path / "tree")
    _tiny_tree(tree)
    argv = ["--data", tree, "--device", "cpu", "--b", "4", "--output", str(tmp_path / "out")]
    one = _loaders([*argv, "--gpus", "0"], 0, 1, monkeypatch)
    argv += ["--gpus", "0,1"]
    ranks = [_loaders(argv, r, 2, monkeypatch) for r in (0, 1)]
    assert len(one["train"]) == 3 and len(one["eval"]) == 2
    for split, epochs in (("train", (0, 1)), ("eval", (0,))):
        for epoch in epochs:
            want = list(one[split].epoch(epoch))
            got = [list(r[split].epoch(epoch)) for r in ranks]
            assert len(got[0]) == len(got[1]) == (3 if split == "train" else 1)
            for i, (a, b) in enumerate(zip(*got)):
                for k in want[i]:
                    assert a[k].shape[0] == b[k].shape[0] == 2
                    np.testing.assert_array_equal(np.concatenate([a[k], b[k]]), want[i][k])
    full = one["train"].paths
    for r in (0, 1):
        sliced = _loaders([*argv, "--multihost"], r, 2, monkeypatch)
        assert sliced["train"].paths == full[r::2][:7] and sliced["train"].part is None
        assert sliced["train"].batch_size == 2


def test_a_batch_that_does_not_divide_is_refused(monkeypatch):
    """In the JAX CLI's words: by the data-parallel devices before any rank
    starts; by the processes of a joined group."""
    with pytest.raises(SystemExit, match="batch 3 not divisible by 2 data-parallel devices"):
        cli.main(["--synthetic", "--device", "cpu", "--gpus", "0,1", "--b", "3"])
    monkeypatch.setattr(mesh, "world", lambda group=None: 2)
    monkeypatch.setattr(mesh, "rank", lambda group=None: 0)
    with pytest.raises(SystemExit, match="global batch 3 not divisible by 2 processes"):
        cli.configure(["--synthetic", "--device", "cpu", "--b", "3"], group=object())


@pytest.mark.parametrize("script", ["run3d.sh", "run2d.sh"])
def test_canonical_scripts_use_the_devices_there_are(script, monkeypatch):
    """The argument lists of ``run3d.sh`` and ``run2d.sh`` (``--gpus
    0,1,2,3``) pass the port's CLI; with one CUDA device the run uses one,
    as the JAX CLI does on one chip; with two, two."""
    text = open(os.path.join(ROOT, script)).read().replace("\\\n", " ")
    line = next(s for s in text.splitlines() if s.startswith("python main.py"))
    argv = [a for a in shlex.split(line)[2:] if a != "$@"]
    args = cli.build_parser().parse_args(argv)
    cli.refuse(args)
    assert cli.gpu_ids(args) == [0, 1, 2, 3]
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert cli.devices_used(args) == 1
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    assert cli.devices_used(args) == 2
    assert cli.devices_used(cli.build_parser().parse_args(argv + ["--device", "cpu"])) == 4
