"""The port's GPU lock (``utils/chiplock.py``) and its bench
(``tools/bench.py``, the counterpart of ``bench.py``) on the CPU."""

import json
import os
import tempfile

import pytest
import torch

from pcrlv2_tpu_torch.core.precision import PARITY_POLICY
from pcrlv2_tpu_torch.data.pipeline import synthetic_luna_batch
from pcrlv2_tpu_torch.models.unet3d import PCRLv23d
from pcrlv2_tpu_torch.tools import bench
from pcrlv2_tpu_torch.utils import chiplock


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs several test workers per host; torch's default of one
    intra-op thread per core then oversubscribes the cores and its CPU ops
    slow down by orders of magnitude.  One thread per worker, restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_lock_acquire_refuse_release(tmp_path, monkeypatch):
    path = str(tmp_path / "gpu.lock")
    monkeypatch.setenv("PCRL_CHIP_LOCK", path)
    assert chiplock.lock_path() == path
    lock = chiplock.acquire("first")
    assert lock is not None and lock.path == path
    info = chiplock.holder_info()
    assert info["pid"] == os.getpid() and info["label"] == "first" and "held_for_s" in info
    # the lock is per open file: the same process cannot take it twice
    assert chiplock.acquire_ex("second") == (None, "contended")
    with pytest.raises(SystemExit, match="REFUSING to run 'bench'.*held by .*first"):
        chiplock.guard_exclusive("bench")
    monkeypatch.setenv("PCRL_IGNORE_CHIP_LOCK", "1")
    chiplock.guard_exclusive("bench").release()
    monkeypatch.delenv("PCRL_IGNORE_CHIP_LOCK")
    lock.release()
    with chiplock.guard_exclusive("bench") as held:
        assert chiplock.holder_info()["label"] == "bench"
        assert chiplock.acquire("third") is None
    assert held._fd is None
    again = chiplock.acquire("third")
    assert again is not None
    again.release()


def test_lock_default_path_follows_tmpdir(tmp_path, monkeypatch):
    """Without ``PCRL_CHIP_LOCK`` the lock lies in the temporary directory,
    so a run with a ``TMPDIR`` of its own writes nothing outside it."""
    monkeypatch.delenv("PCRL_CHIP_LOCK", raising=False)
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    assert chiplock.lock_path() == str(tmp_path / "pcrl_gpu.lock")
    with chiplock.guard_exclusive("bench") as held:
        assert held.path == str(tmp_path / "pcrl_gpu.lock")
        assert chiplock.holder_info()["label"] == "bench"
    assert os.listdir(tmp_path) == ["pcrl_gpu.lock"]


def test_lock_warns_and_reports_an_unopenable_file(tmp_path, capsys):
    path = str(tmp_path / "gpu.lock")
    held = chiplock.acquire("trainer", path)
    assert chiplock.guard_warn("second trainer", path) is None
    assert "WARNING: the GPU lock" in capsys.readouterr().out
    held.release()
    lock = chiplock.guard_warn("second trainer", path)
    assert lock is not None and capsys.readouterr().out == ""
    lock.release()
    missing = str(tmp_path / "no" / "such" / "dir" / "gpu.lock")
    lock, why = chiplock.acquire_ex("x", missing)
    assert lock is None and why.startswith("open-failed")
    assert chiplock.guard_warn("x", missing) is None
    assert "could not open the GPU lock file" in capsys.readouterr().out
    with pytest.raises(SystemExit, match="could not open the GPU lock file"):
        chiplock.guard_exclusive("x", missing)


def test_bench_run_prints_one_json_line(capsys):
    """The timed loop at a tiny size on the CPU: one JSON line with the JAX
    bench's keys (no ``vs_baseline``), no device numbers."""
    batch = synthetic_luna_batch(2, size=(16, 16, 8), local=(8, 8, 8), n_views=2, seed=1)
    out = bench.run(batch, PARITY_POLICY, warmup=0, steps=1, trials=3, device="cpu")
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1 and json.loads(lines[0]) == out
    assert out["metric"] == "3d_pretrain_volumes_per_sec_per_chip"
    assert out["unit"] == "volumes/sec/chip" and out["value"] > 0
    assert len(out["trials"]) == 3 and out["value"] == out["trials"][1]
    assert out["device"] == "cpu" and out["peak_memory_gib"] is None
    assert (out["batch"], out["compute_dtype"]) == (2, "float32")
    assert "vs_baseline" not in out


@pytest.mark.parametrize("env,missing", [
    ({"BENCH_DIM": "4"}, "expected 3 or 2"),
    ({"BENCH_REMAT": "1", "BENCH_DIM": "2"}, "activation checkpointing"),
    ({"BENCH_PRNG": "rbg"}, "no counterpart"),
])
def test_bench_names_what_it_cannot_run(monkeypatch, env, missing):
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    with pytest.raises(SystemExit, match=missing):
        bench.main(device="cpu")


def test_bench_remat_builds_the_remat_model(monkeypatch, capsys):
    """``BENCH_REMAT=1`` reaches ``run`` as ``remat``, which times
    ``PCRLv23d(remat=True)`` (a tiny batch on the CPU here) and says so in
    its line."""
    asked = {}
    monkeypatch.setenv("BENCH_REMAT", "1")
    monkeypatch.setattr(bench, "run", lambda batch, policy, **kw: asked.update(kw))
    bench.main(device="cpu")
    assert asked["remat"] is True
    monkeypatch.undo()
    built = []

    def spy(**kw):
        built.append(kw["remat"])
        return PCRLv23d(**kw)

    monkeypatch.setattr(bench, "PCRLv23d", spy)
    batch = synthetic_luna_batch(2, size=(16, 16, 8), local=(8, 8, 8), n_views=2, seed=1)
    out = bench.run(batch, PARITY_POLICY, warmup=0, steps=1, trials=1, device="cpu",
                    remat=True)
    assert built == [True] and out["remat"] is True and out["value"] > 0
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == out


def test_bench_needs_cuda_unless_cpu_is_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        bench.main()
