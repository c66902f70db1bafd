"""The port as a package: it imports no JAX, its entry points refuse to fall
back to the CPU, unported paths say so, and the trainer writes a
reference-schema checkpoint and metrics."""

import json
import os
import pkgutil
import subprocess
import sys

import pytest
import torch

import pcrlv2_tpu_torch
from pcrlv2_tpu_torch.cli import main as cli
from pcrlv2_tpu_torch.data.augment3d import make_luna_aug_fn
from pcrlv2_tpu_torch.data.pipeline import synthetic_luna_batch
from pcrlv2_tpu_torch.models.unet3d import PCRLv23d
from pcrlv2_tpu_torch.train.checkpoint import import_pcrlv23d
from pcrlv2_tpu_torch.train.trainer import TrainConfig, Trainer, run_training


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs several test workers per host; torch's default of one
    intra-op thread per core then oversubscribes the cores and its CPU ops
    slow down by orders of magnitude.  One thread per worker, restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_package_imports_no_jax():
    mods = [m.name for m in pkgutil.walk_packages(pcrlv2_tpu_torch.__path__,
                                                  "pcrlv2_tpu_torch.")]
    for name in ("ops.conv3d_kernel", "native", "utils.chiplock", "tools.bench",
                 "models.resnet", "models.unet2d", "data.augment2d", "train.finetune"):
        assert f"pcrlv2_tpu_torch.{name}" in mods
    code = ("import importlib, sys\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith("
            "('jax.', 'flax', 'optax', 'pcrlv2_tpu.')) or m == 'pcrlv2_tpu')\n"
            "print(bad)\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_entry_points_need_cuda_unless_cpu_is_asked(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        PCRLv23d()
    with pytest.raises(RuntimeError, match="--device cpu"):
        cli.main(["--synthetic", "--output", str(tmp_path)])
    model = PCRLv23d(device="cpu")
    with pytest.raises(RuntimeError):
        Trainer(model, TrainConfig(output=str(tmp_path)), make_luna_aug_fn())


@pytest.mark.parametrize("argv,item", [
    (["--synthetic", "--phase", "finetune", "--multihost"], "does not support --multihost"),
    (["--synthetic", "--phase", "finetune", "--spatial", "2"], "does not support --spatial"),
    ([], "--data is required"),
    (["--synthetic", "--spatial", "2"], "pcrlv2_tpu/parallel/spatial_train.py"),
    (["--synthetic", "--multihost"], "pcrlv2_tpu/core/mesh.py"),
])
def test_unported_paths_name_their_roadmap_item(argv, item):
    """Paths not ported yet stop naming the JAX module they wait for;
    without a data source the CLI says what it needs; finetuning refuses
    ``--multihost`` and ``--spatial`` as the JAX CLI does."""
    with pytest.raises(SystemExit, match=item):
        cli.main(argv + ["--device", "cpu"])


class _TinyLoader:
    def epoch(self, epoch):
        for i in range(2):
            yield synthetic_luna_batch(2, size=(16, 16, 8), local=(8, 8, 8),
                                       n_views=2, seed=epoch * 2 + i)


def test_trainer_writes_metrics_and_a_loadable_checkpoint(tmp_path):
    cfg = TrainConfig(b=2, epochs=0, output=str(tmp_path), log_every=1, seed=3)
    model = PCRLv23d(device="cpu", seed=3)
    trainer = run_training(model, cfg, _TinyLoader(), make_luna_aug_fn(), "cpu")
    assert trainer.state.step == 2
    lines = [json.loads(s) for s in open(tmp_path / "metrics.jsonl")]
    steps = [r for r in lines if "iter" in r]
    assert [r["iter"] for r in steps] == [1, 2]
    assert all(r["skipped"] == 0.0 and r["loss"] == r["loss"] for r in steps)
    path = tmp_path / cfg.ckpt_name(0)
    fresh = PCRLv23d(device="cpu", seed=4)
    ckpt = import_pcrlv23d(str(path), fresh)
    assert ckpt["epoch"] == 0 and ckpt["opt"]["b"] == 2
    for (k, a), b in zip(model.state_dict().items(), fresh.state_dict().values()):
        torch.testing.assert_close(a, b, rtol=0, atol=0, msg=k)
