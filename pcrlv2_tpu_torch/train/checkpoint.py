"""Reference-schema ``.pt`` checkpoints, the train state for resume, and the
bridge from JAX variables (port of ``pcrlv2_tpu/train/checkpoint.py``).

The port's ``PCRLv23d.state_dict()`` and ``PCRLv2.state_dict()`` already are
the reference schemas, so a ``.pt`` is ``{'opt', 'state_dict', 'optimizer',
'epoch'}`` written by ``torch.save`` (reference ``train_3d.py:74-75``).  The
2D model's ``.pt`` holds its encoder only, with torchvision's ResNet-18 key
names (reference ``train_2d.py:99``: ``export_resnet18_encoder``), and
``import_resnet18_encoder`` reads one, or a bare torchvision state_dict
(``--encoder_weights``).  ``from_jax_variables`` carries the JAX package's
``params``/``batch_stats`` trees (numpy leaves) into these schemas; the
mapping tables are copies of ``pcrlv23d_mapping``, ``resnet18_encoder_mapping``
and ``pcrlv2_2d_mapping``, and ``chest_classifier_mapping`` covers the finetune
classifier (the encoder's table plus its ``fc``).

The train state (``save_train_state``, the role of the JAX package's Orbax
state) is one ``torch.save`` file, ``<state dir>/state.pt``: parameters and
BN statistics, momentum buffers, step counter, epoch, and the state of the
trainer's random generators, so a resumed run draws the augmentations and
levels an unbroken run would.

Layouts (torch ← flax, channels-last):
  Conv3d  (O, I, kd, kh, kw) ← (kd, kh, kw, I, O)
  Conv2d  (O, I, kh, kw)     ← (kh, kw, I, O)
  ConvT3d (I, O, kd, kh, kw) ← (kd, kh, kw, I, O)
  Linear  (O, I)             ← (I, O)
"""

from __future__ import annotations

import os
from typing import Any, Dict, Mapping, Tuple

import numpy as np
import torch

_F2T = {
    "conv3d": lambda w: np.transpose(w, (4, 3, 0, 1, 2)),
    "convT3d": lambda w: np.transpose(w, (3, 4, 0, 1, 2)),
    "conv2d": lambda w: np.transpose(w, (3, 2, 0, 1)),
    "linear": np.transpose,
    "id": lambda w: w,
    "stat": lambda w: w,
}


def _luconv_entries(tprefix: str, fpath: Tuple[str, ...], norm: str = "bn",
                    act: str = "relu"):
    entries = [
        (f"{tprefix}.conv1.weight", fpath + ("conv1", "kernel"), "conv3d"),
        (f"{tprefix}.conv1.bias", fpath + ("conv1", "bias"), "id"),
        (f"{tprefix}.bn1.weight", fpath + ("bn1", "scale"), "id"),
        (f"{tprefix}.bn1.bias", fpath + ("bn1", "bias"), "id"),
    ]
    if norm == "bn":
        entries += [
            (f"{tprefix}.bn1.running_mean", fpath + ("bn1", "mean"), "stat"),
            (f"{tprefix}.bn1.running_var", fpath + ("bn1", "var"), "stat"),
        ]
    if act == "prelu":
        entries.append((f"{tprefix}.activation.weight",
                        fpath + ("PReLU_0", "alpha"), "id"))
    return entries


def _bn_entries(tprefix: str, fpath: Tuple[str, ...]):
    return [
        (f"{tprefix}.weight", fpath + ("scale",), "id"),
        (f"{tprefix}.bias", fpath + ("bias",), "id"),
        (f"{tprefix}.running_mean", fpath + ("mean",), "stat"),
        (f"{tprefix}.running_var", fpath + ("var",), "stat"),
    ]


def pcrlv23d_mapping(norm: str = "bn", act: str = "relu"):
    """(torch_key, flax_path, kind) for every PCRLv23d tensor."""
    entries = []
    for name in ["down_tr64", "down_tr128", "down_tr256", "down_tr512"]:
        for i in (0, 1):
            entries += _luconv_entries(f"{name}.ops.{i}", (name, f"ops{i}"),
                                       norm, act)
    for name in ["up_tr256", "up_tr128", "up_tr64"]:
        entries += [
            (f"{name}.up_conv.weight", (name, "up_conv", "kernel"), "convT3d"),
            (f"{name}.up_conv.bias", (name, "up_conv", "bias"), "id"),
        ]
        for i in (0, 1):
            entries += _luconv_entries(f"{name}.ops.{i}", (name, f"ops{i}"),
                                       norm, act)
        entries += _bn_entries(f"{name}.bn", (name, "bn"))
        entries += [
            (f"{name}.predictor_head.0.weight",
             (name, "predictor_head", "fc1", "kernel"), "linear"),
            (f"{name}.predictor_head.0.bias",
             (name, "predictor_head", "fc1", "bias"), "id"),
        ]
        entries += _bn_entries(f"{name}.predictor_head.1",
                               (name, "predictor_head", "bn"))
        entries += [
            (f"{name}.predictor_head.3.weight",
             (name, "predictor_head", "fc2", "kernel"), "linear"),
            (f"{name}.predictor_head.3.bias",
             (name, "predictor_head", "fc2", "bias"), "id"),
        ]
        entries += _luconv_entries(f"{name}.deep_supervision_head",
                                   (name, "deep_supervision_head"),
                                   norm, "sigmoid")
    entries += [
        ("out_tr.final_conv.weight", ("out_tr", "final_conv", "kernel"), "conv3d"),
        ("out_tr.final_conv.bias", ("out_tr", "final_conv", "bias"), "id"),
    ]
    return entries


def resnet18_encoder_mapping():
    """(torch_key, flax_path, kind) for every tensor of the ResNet-18 encoder
    (torchvision names)."""
    entries = [("conv1.weight", ("conv1", "kernel"), "conv2d")]
    entries += _bn_entries("bn1", ("bn1",))
    for stage in range(1, 5):
        for blk in range(2):
            t, f = f"layer{stage}.{blk}", f"layer{stage}_{blk}"
            entries += [(f"{t}.conv1.weight", (f, "conv1", "kernel"), "conv2d"),
                        (f"{t}.conv2.weight", (f, "conv2", "kernel"), "conv2d")]
            entries += _bn_entries(f"{t}.bn1", (f, "bn1"))
            entries += _bn_entries(f"{t}.bn2", (f, "bn2"))
            if stage > 1 and blk == 0:
                entries += [(f"{t}.downsample.0.weight", (f, "downsample_conv", "kernel"),
                             "conv2d")]
                entries += _bn_entries(f"{t}.downsample.1", (f, "downsample_bn"))
    return entries


def chest_classifier_mapping():
    """(torch_key, flax_path, kind) for every tensor of the finetune
    ``ChestClassifier``: the encoder's under ``encoder`` and the linear
    ``fc`` head."""
    entries = [("encoder." + tkey, ("encoder",) + fpath, kind)
               for tkey, fpath, kind in resnet18_encoder_mapping()]
    return entries + [("fc.weight", ("fc", "kernel"), "linear"),
                      ("fc.bias", ("fc", "bias"), "id")]


def _conv2drelu_entries(tprefix: str, fpath: Tuple[str, ...]):
    """smp ``Conv2dReLU`` = Sequential(conv without bias, BN, ReLU)."""
    return ([(f"{tprefix}.0.weight", fpath + ("conv", "kernel"), "conv2d")]
            + _bn_entries(f"{tprefix}.1", fpath + ("bn",)))


def pcrlv2_2d_mapping():
    """(torch_key, flax_path, kind) for every tensor of the 2D ``PCRLv2``."""
    entries = [("model.encoder." + tkey, ("encoder",) + fpath, kind)
               for tkey, fpath, kind in resnet18_encoder_mapping()]
    for i in range(5):
        t, f = f"model.decoder.blocks.{i}", (f"block{i}",)
        entries += _conv2drelu_entries(f"{t}.conv1", f + ("conv1",))
        entries += _conv2drelu_entries(f"{t}.conv2", f + ("conv2",))
        entries += _bn_entries(f"{t}.bn", f + ("bn",))
        entries += [
            (f"{t}.deep_supervision_head.0.weight", f + ("ds_conv1", "kernel"), "conv2d"),
            (f"{t}.deep_supervision_head.0.bias", f + ("ds_conv1", "bias"), "id"),
        ]
        entries += _bn_entries(f"{t}.deep_supervision_head.1", f + ("ds_bn",))
        entries += [
            (f"{t}.deep_supervision_head.3.weight", f + ("ds_conv2", "kernel"), "conv2d"),
            (f"{t}.deep_supervision_head.3.bias", f + ("ds_conv2", "bias"), "id"),
            (f"{t}.predictor_head.0.weight", f + ("predictor_head", "fc1", "kernel"), "linear"),
            (f"{t}.predictor_head.0.bias", f + ("predictor_head", "fc1", "bias"), "id"),
        ]
        entries += _bn_entries(f"{t}.predictor_head.1", f + ("predictor_head", "bn"))
        entries += [
            (f"{t}.predictor_head.3.weight", f + ("predictor_head", "fc2", "kernel"), "linear"),
            (f"{t}.predictor_head.3.bias", f + ("predictor_head", "fc2", "bias"), "id"),
        ]
    entries += [("model.segmentation_head.0.weight", ("segmentation_head", "kernel"), "conv2d"),
                ("model.segmentation_head.0.bias", ("segmentation_head", "bias"), "id")]
    return entries


def from_jax_variables(variables: Mapping[str, Any], norm: str = "bn",
                       act: str = "relu", mapping=None) -> Dict[str, torch.Tensor]:
    """``{'params': …, 'batch_stats': …}`` of a JAX model (numpy leaves) →
    the port's ``state_dict`` (CPU tensors), by ``mapping`` (default: the
    ``PCRLv23d`` table for ``norm`` and ``act``; ``pcrlv2_2d_mapping()`` for
    ``PCRLv2``, ``resnet18_encoder_mapping()`` for its encoder,
    ``chest_classifier_mapping()`` for the finetune ``ChestClassifier``).  BatchNorm
    step counters have no flax analog and start at 0."""
    out: Dict[str, torch.Tensor] = {}
    for tkey, fpath, kind in mapping or pcrlv23d_mapping(norm, act):
        node = variables["batch_stats" if kind == "stat" else "params"]
        for p in fpath:
            node = node[p]
        val = _F2T[kind](np.asarray(node, dtype=np.float32))
        out[tkey] = torch.from_numpy(np.array(val, copy=True))
        if tkey.endswith(".running_var"):
            out[tkey[:-len("running_var")] + "num_batches_tracked"] = (
                torch.zeros((), dtype=torch.long))
    return out


def save_reference_checkpoint(path: str, state_dict: Mapping[str, torch.Tensor],
                              opt: Any = None, optimizer: Any = None,
                              epoch: int = 0) -> None:
    """Write the reference ``{'opt','state_dict','optimizer','epoch'}`` schema."""
    tensors = {k: v.detach().cpu().clone() for k, v in state_dict.items()}
    torch.save({"opt": opt, "state_dict": tensors, "optimizer": optimizer,
                "epoch": epoch}, path)


def load_reference_checkpoint(path: str) -> Dict[str, Any]:
    """Read a reference-schema ``.pt`` (this program's own or the reference's)."""
    return torch.load(path, map_location="cpu", weights_only=False)


def export_pcrlv23d(model: torch.nn.Module, path: str, opt=None,
                    epoch: int = 0) -> None:
    save_reference_checkpoint(path, model.state_dict(), opt=opt, epoch=epoch)


def import_pcrlv23d(path: str, model: torch.nn.Module) -> Dict[str, Any]:
    """Load a reference-schema ``.pt`` into ``model`` (strict); returns the
    checkpoint dict."""
    ckpt = load_reference_checkpoint(path)
    model.load_state_dict(ckpt["state_dict"], strict=True)
    return ckpt


def export_resnet18_encoder(encoder: torch.nn.Module, path: str, opt=None,
                            epoch: int = 0) -> None:
    """The 2D model's ``.pt``: its encoder's ``state_dict`` (torchvision key
    names, BN counters included), as reference ``train_2d.py:99`` saves it."""
    save_reference_checkpoint(path, encoder.state_dict(), opt=opt, epoch=epoch)


def import_resnet18_encoder(path: str, encoder: torch.nn.Module) -> Dict[str, Any]:
    """Load a ResNet-18 encoder ``.pt`` (``{'state_dict': …}``, the reference's
    2D schema) or a bare torchvision state_dict into ``encoder``, its ``fc``
    dropped (reference ``README.md:42-43``); every tensor of
    ``resnet18_encoder_mapping`` must be there, a BN counter it lacks stays
    as it was.  Returns the file's dict."""
    ckpt = load_reference_checkpoint(path)
    given = dict(ckpt["state_dict"]) if "state_dict" in ckpt else dict(ckpt)
    state = encoder.state_dict()
    missing = [k for k in state if k not in given and not k.endswith("num_batches_tracked")]
    if missing:
        raise KeyError(f"{path}: not a ResNet-18 encoder state_dict (no {missing[:4]}…)")
    encoder.load_state_dict({k: given.get(k, v) for k, v in state.items()}, strict=True)
    return ckpt


# ---------------------------------------------------------------------------
# train state for resume
# ---------------------------------------------------------------------------

STATE_FILE = "state.pt"


def save_train_state(state_dir: str, epoch: int, state,
                     generators: Mapping[str, torch.Generator]) -> str:
    """Write ``state`` (a ``train.step.TrainState``) after ``epoch`` and the
    generators' states to ``<state_dir>/state.pt`` (tmp + rename, so a crash
    never leaves a torn file); returns its path."""
    os.makedirs(state_dir, exist_ok=True)
    path = os.path.join(state_dir, STATE_FILE)
    payload = {
        "epoch": int(epoch), "step": int(state.step),
        "model": {k: v.detach().cpu().clone()
                  for k, v in state.model.state_dict().items()},
        "momentum": [b.detach().cpu().clone() for b in state.optimizer.buffers],
        "generators": {k: g.get_state() for k, g in generators.items()},
    }
    tmp = f"{path}.tmp.{os.getpid()}"
    torch.save(payload, tmp)
    os.replace(tmp, path)
    return path


def load_train_state(state_dir: str, state,
                     generators: Mapping[str, torch.Generator]) -> int:
    """Restore what ``save_train_state`` wrote into ``state`` and
    ``generators`` (in place, strict: the step counter, parameters and
    buffers keep their tensors); returns the saved epoch.  Raises
    ``FileNotFoundError`` when ``state_dir`` holds no state."""
    path = os.path.join(state_dir, STATE_FILE)
    if not os.path.isfile(path):
        raise FileNotFoundError(f"no train state to resume from: {path} does not exist")
    payload = torch.load(path, map_location="cpu", weights_only=True)
    state.model.load_state_dict(payload["model"], strict=True)
    if len(payload["momentum"]) != len(state.optimizer.buffers):
        raise ValueError(f"{path}: {len(payload['momentum'])} momentum buffers "
                         f"for {len(state.optimizer.buffers)} parameters")
    with torch.no_grad():
        for buf, saved in zip(state.optimizer.buffers, payload["momentum"]):
            buf.copy_(saved)
        # in place: a captured CUDA graph holds this tensor's address
        state.step.fill_(int(payload["step"]))
    if set(payload["generators"]) != set(generators):
        raise ValueError(f"{path}: generators {sorted(payload['generators'])}, "
                         f"expected {sorted(generators)}")
    for k, g in generators.items():
        g.set_state(payload["generators"][k])
    return int(payload["epoch"])
