"""The port's downstream finetuning (``train/finetune.py``, ``--phase
finetune``) held against the JAX package's on the same weights and inputs
(CPU).

One set of weights serves both sides: the port's models carried into the
JAX package's variables by its own ``torch_state_to_flax``, so no JAX model
is initialized here.  The JAX steps run in float64 (an f64 ``Policy``, x64
enabled): JAX's own f32 gradients are off from float64 by up to 2.4 % (3D)
and 9.4e-2 (2D encoder) of a tensor's largest entry at these sizes
(``ROADMAP.md`` Queue C), more than any useful tolerance, so the port's
f32 step is held to the float64 one.  Each side's programs run once per
file (module fixtures): the 2D forwards and step as one jitted program at
b = 4, 64², the 3D step and eval as another at b = 2, 16×16×8, their
convs traced as products (``tests/f64_reference.py``: XLA's float64 CPU
conv is a plain loop nest).  The JAX
steps use ``dropout=0.0`` (their dropout bits come from ``jax.random``);
the port's dropout is held by its own test.
"""

import os
from functools import partial

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pcrlv2_tpu.core.precision import Policy as JaxPolicy
from pcrlv2_tpu.data import manifests as jmanifests
from pcrlv2_tpu.data import pipeline as jpipeline
from pcrlv2_tpu.models import PCRLv23d as JaxPCRLv23d
from pcrlv2_tpu.train import checkpoint as jax_ckpt
from pcrlv2_tpu.train import finetune as jft
from pcrlv2_tpu.train.optimizer import sgd
from pcrlv2_tpu.train.step import TrainState as JaxTrainState

from pcrlv2_tpu_torch.cli import main as cli
from pcrlv2_tpu_torch.core.precision import PARITY_POLICY
from pcrlv2_tpu_torch.data import manifests, pipeline
from pcrlv2_tpu_torch.models.resnet import ResNet18Encoder
from pcrlv2_tpu_torch.models.unet3d import PCRLv23d
from pcrlv2_tpu_torch.train import checkpoint as ckpt
from pcrlv2_tpu_torch.train import finetune as ft
from pcrlv2_tpu_torch.train.step import TrainState
from pcrlv2_tpu_torch.train.trainer import TrainConfig

from tests.f64_reference import ONCE_COMPILE, convs_as_products


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs several test workers per host; torch's default of one
    intra-op thread per core then oversubscribes the cores and its CPU ops
    slow down by orders of magnitude.  One thread per worker, restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


B2, SIZE2, N_CLASS = 4, 64, 14
B3, SIZE3 = 2, (16, 16, 8)
LR = 0.1
CHEST_MAP = ckpt.chest_classifier_mapping()
F64 = JaxPolicy(param_dtype=jnp.float64, compute_dtype=jnp.float64, output_dtype=jnp.float64)
# the port's f32 forward against float64, per tensor: its largest error at
# most this share of the tensor's largest entry (BatchNorm over 16 values a
# channel in layer4 at 64² amplifies f32 rounding; test_torch_model2d.py)
FWD_REL = 1e-4
# the port's f32 gradient against float64, as a share of each tensor's
# largest entry: the classifier's BCE reaches the encoder through the
# pooled features alone, and the port's worst tensor reads 1.4e-5 (the
# pretask's SimSiam loss through the decoder needs test_torch_model2d.py's
# _GRAD_REL table, up to 0.15, at the same size)
GRAD_REL_2D = 1e-3
# the 3D gradient at 2e-3, as test_torch_model.py's
# test_gradient_matches_jax_float64 holds the pretask's (the port's worst
# tensor reads 2.5e-4 here, up_tr128.up_conv.bias); the conv biases that
# feed a BatchNorm have a true gradient of 0 and momenta of ~1e-6 (wd·p),
# which _close's 1e-6 floor covers, as that test leaves them out
GRAD_REL_3D = 2e-3


def _close(got, want, rel, what=""):
    """max |got − want| ≤ ``rel`` · max |want| + 1e-6."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, what
    err, scale = np.abs(got - want).max(), np.abs(want).max()
    assert err <= rel * scale + 1e-6, f"{what}: {err:.3e} > {rel} × {scale:.3e} + 1e-6"


def _to64(tree):
    return jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), tree)


def _cfg(tmp_path, **kw):
    return TrainConfig(**dict(dict(b=2, epochs=0, lr=LR, output=str(tmp_path / "out"), seed=0,
                                   phase="finetune"), **kw))


def _classifier(seed=0, dropout=0.0):
    return ft.ChestClassifier(N_CLASS, dropout, PARITY_POLICY, seed=seed, device="cpu")


def _chest_batch(seed, b=B2, size=SIZE2, channels=1):
    rng = np.random.RandomState(seed)
    return {"image": rng.randint(0, 256, (b, size, size, channels)).astype(np.uint8),
            "label": rng.randint(0, 2, (b, N_CLASS)).astype(np.float32)}


def _luna_batch(seed, b=B3, size=SIZE3, masks=False):
    rng = np.random.RandomState(seed)
    batch = {"pair": rng.rand(b, 2, *size).astype(np.float32)}
    if masks:
        batch["mask"] = (rng.rand(b, *size, 1) > 0.7).astype(np.float32)
    return batch


def _tensors(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _momentum_close(state, jax_trace, mapping, rel_of, what):
    """Each momentum buffer (g + wd·p after one step from zero) against the
    JAX optimizer's trace, mapped by ``mapping`` into the port's layout."""
    want = ckpt.from_jax_variables({"params": jax.device_get(jax_trace), "batch_stats": {}},
                                   mapping=[e for e in mapping if e[2] != "stat"])
    names = [n for n, _ in state.model.named_parameters()]
    for name, buf in zip(names, state.optimizer.buffers):
        _close(buf.numpy(), want[name].numpy(), rel_of(name), f"{what} momentum of {name}")


@pytest.fixture(scope="module")
def chest_setup():
    """The port's seed-0 classifier as JAX variables, and the JAX side in
    float64 as one jitted program: the train-mode forward (with its updated
    statistics), the eval-mode forward on those statistics, and one
    ``make_finetune_step_2d`` on a uint8 single-channel batch."""
    model = _classifier()
    variables = jax_ckpt.torch_state_to_flax(model.state_dict(), CHEST_MAP)
    x = np.random.RandomState(3).rand(B2, SIZE2, SIZE2, 3).astype(np.float32)
    batch = _chest_batch(4)
    with jax.enable_x64(True), convs_as_products():
        jmodel = jft.ChestClassifier(n_class=N_CLASS, dropout=0.0, policy=F64)
        tx = sgd()
        step = jft.make_finetune_step_2d(jmodel, tx)

        @partial(jax.jit, compiler_options=ONCE_COMPILE)
        def run(params, stats, x, images, labels):
            logits, mutated = jmodel.apply({"params": params, "batch_stats": stats}, x,
                                           train=True, mutable=["batch_stats"])
            evaluated = jmodel.apply({"params": params, "batch_stats": mutated["batch_stats"]},
                                     x, train=False)
            state = JaxTrainState(params=params, batch_stats=stats,
                                  opt_state=tx.init(params), step=jnp.zeros((), jnp.int32))
            new, metrics = step(state, images, labels, jax.random.key(0), LR)
            return logits, mutated["batch_stats"], evaluated, new, metrics

        out = jax.device_get(run(*_to64((variables["params"], variables["batch_stats"], x)),
                                 batch["image"], batch["label"]))
    return variables, x, batch, out


@pytest.fixture(scope="module")
def luna_setup():
    """The port's seed-0 ``PCRLv23d`` as JAX variables, and JAX in float64
    as one jitted program: ``make_finetune_eval_3d`` and one
    ``make_finetune_step_3d`` on the pseudo-mask of a (2, 16, 16, 8) batch."""
    model = PCRLv23d(policy=PARITY_POLICY, device="cpu", seed=0)
    variables = jax_ckpt.torch_state_to_flax(model.state_dict(), ckpt.pcrlv23d_mapping())
    batch = _luna_batch(5)
    vol = batch["pair"][:, 0, ..., None]
    with jax.enable_x64(True), convs_as_products():
        jmodel = JaxPCRLv23d(policy=F64)
        tx = sgd()
        step = jft.make_finetune_step_3d(jmodel, tx)
        evaluate = jft.make_finetune_eval_3d(jmodel)

        @jax.jit
        def run(params, stats, vol):
            masks = jft.pseudo_mask(vol)
            ev = evaluate(params, stats, vol, masks)
            state = JaxTrainState(params=params, batch_stats=stats,
                                  opt_state=tx.init(params), step=jnp.zeros((), jnp.int32))
            new, metrics = step(state, vol, masks, LR)
            return ev, new, metrics

        out = jax.device_get(run(*_to64((variables["params"], variables["batch_stats"], vol))))
    return variables, batch, out


# ---------------------------------------------------------------------------
# losses, the metric, the classifier
# ---------------------------------------------------------------------------


def test_losses_and_pseudo_mask_match_jax():
    """``bce_with_logits`` (logits up to ±40), ``dice_loss``, ``seg_loss``
    (probabilities exactly 0 and 1 included: the clip) and ``pseudo_mask``
    against the JAX package's on the same arrays, f32 both sides: 1e-6
    relative (the same formulas, sums in another order)."""
    rng = np.random.RandomState(0)
    z = (rng.randn(6, N_CLASS) * 10).astype(np.float32)
    z[0, :3] = (-40.0, 40.0, 0.0)
    y = rng.randint(0, 2, (6, N_CLASS)).astype(np.float32)
    p = rng.rand(2, 8, 8, 4, 1).astype(np.float32)
    p[0, 0, 1, :, 0] = (0.0, 1.0, 0.5, 1.0)
    t = (rng.rand(2, 8, 8, 4, 1) > 0.5).astype(np.float32)
    pairs = [(ft.bce_with_logits, jft.bce_with_logits, z, y),
             (ft.dice_loss, jft.dice_loss, p, t), (ft.seg_loss, jft.seg_loss, p, t),
             (ft.dice_loss, jft.dice_loss, t, t)]
    for fn, jfn, a, b in pairs:
        got = float(fn(torch.from_numpy(a), torch.from_numpy(b)))
        want = float(jfn(jnp.asarray(a), jnp.asarray(b)))
        assert np.isfinite(got)
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7, err_msg=fn.__name__)
    np.testing.assert_array_equal(ft.pseudo_mask(torch.from_numpy(p)).numpy(),
                                  np.asarray(jft.pseudo_mask(jnp.asarray(p))))


def test_mean_roc_auc_equals_jax():
    """``mean_roc_auc`` is the JAX package's NumPy function copied: equal
    on ties (scores rounded to 0.1), a class with no positives and one with
    no negatives (both skipped), and NaN when no class is left."""
    rng = np.random.RandomState(1)
    scores = np.round(rng.rand(40, 5), 1)
    labels = (rng.rand(40, 5) > 0.5).astype(np.float32)
    labels[:, 1] = 0.0
    labels[:, 3] = 1.0
    got = ft.mean_roc_auc(scores, labels)
    assert got == jft.mean_roc_auc(scores, labels) and np.isfinite(got)
    assert np.isnan(ft.mean_roc_auc(scores[:, 1:2], labels[:, 1:2]))
    assert np.isnan(jft.mean_roc_auc(scores[:, 1:2], labels[:, 1:2]))
    perfect = np.stack([labels[:, 0], -labels[:, 0]], 1)
    assert ft.mean_roc_auc(perfect, labels[:, [0, 0]]) == 0.5  # 1.0 and 0.0


def test_classifier_forward_matches_jax_float64(chest_setup):
    """``ChestClassifier`` (dropout 0) at b = 4, 64², weights through
    ``chest_classifier_mapping``, against JAX's in float64: train mode (batch
    statistics; the updated running statistics too) and eval mode on those
    statistics, at ``FWD_REL`` of each tensor's largest entry.  The mapping
    carries JAX variables back into the port's ``state_dict`` leaf-exact."""
    variables, x, _, (logits, stats, evaluated, _, _) = chest_setup
    model = _classifier(seed=9)
    model.load_state_dict(ckpt.from_jax_variables(variables, mapping=CHEST_MAP), strict=True)
    for k, v in _classifier().state_dict().items():
        if not k.endswith("num_batches_tracked"):
            assert torch.equal(model.state_dict()[k], v), k
    got = model.train()(torch.from_numpy(x))
    _close(got.detach().numpy(), logits, FWD_REL, "train-mode logits")
    want = ckpt.from_jax_variables({"params": variables["params"], "batch_stats": stats},
                                   mapping=CHEST_MAP)
    for k, v in model.state_dict().items():
        if k.endswith(("running_mean", "running_var")):
            _close(v.numpy(), want[k].numpy(), FWD_REL, k)
    with torch.no_grad():
        got = model.eval()(torch.from_numpy(x))
    _close(got.numpy(), evaluated, FWD_REL, "eval-mode logits")


def test_dropout_keeps_share_scale_zeros_and_draws_on_its_generator():
    """``apply_dropout`` at p = 0.2: about 80 % of the units kept (within 5σ
    of the binomial), each kept one exactly x/0.8, the rest exactly 0; the
    same generator state gives the same mask, and the draw advances it.  In
    the classifier: a training forward with dropout draws on its generator
    (two draws differ), an eval forward draws nothing and needs none, and a
    training forward without a generator raises."""
    x = torch.rand(64, 512) + 0.5
    gen = torch.Generator().manual_seed(3)
    start = gen.get_state()
    out = ft.apply_dropout(x, 0.2, gen)
    kept = out != 0
    share, n = kept.float().mean().item(), x.numel()
    assert abs(share - 0.8) < 5 * (0.8 * 0.2 / n) ** 0.5
    assert torch.equal(out[kept], x[kept] / (1.0 - 0.2))
    assert not torch.equal(gen.get_state(), start)
    gen.set_state(start)
    assert torch.equal(ft.apply_dropout(x, 0.2, gen), out)

    model = _classifier(dropout=0.2)
    images = torch.from_numpy(np.random.RandomState(2).rand(2, 32, 32, 3).astype(np.float32))
    gen.manual_seed(4)
    a, b = model.train()(images, gen), model(images, gen)
    assert not torch.equal(a, b)
    with pytest.raises(ValueError, match="dropout_gen"):
        model(images)
    state = gen.get_state()
    with torch.no_grad():
        e1, e2 = model.eval()(images), model(images)
    assert torch.equal(e1, e2) and torch.equal(gen.get_state(), state)


# ---------------------------------------------------------------------------
# the steps
# ---------------------------------------------------------------------------


def test_finetune_step_2d_matches_jax_float64(chest_setup):
    """One ``finetune_step_2d`` (uint8 single-channel images: /255 and the
    channel tiled inside the step) against ``make_finetune_step_2d`` in
    float64 on the same weights: loss and accuracy (1e-4 relative), the
    updated BN statistics (``FWD_REL``), the momentum buffers = gradient +
    wd·p (``GRAD_REL_2D``) and the parameters after the update (1e-4 of
    each tensor's largest entry: lr·momentum is small beside p)."""
    variables, _, batch, (*_, new, metrics) = chest_setup
    model = _classifier(seed=9)
    model.load_state_dict(ckpt.from_jax_variables(variables, mapping=CHEST_MAP), strict=True)
    state = TrainState(model)
    got = ft.finetune_step_2d(state, *ft.images_and_labels(_tensors(batch)), LR,
                              torch.Generator())
    assert all(v.dim() == 0 for v in got.values()) and int(state.step) == 1
    for k in ("loss", "acc"):
        np.testing.assert_allclose(float(got[k]), float(metrics[k]), rtol=1e-4, err_msg=k)
    want = ckpt.from_jax_variables({"params": new.params, "batch_stats": new.batch_stats},
                                   mapping=CHEST_MAP)
    for k, v in model.state_dict().items():
        if not k.endswith("num_batches_tracked"):
            _close(v.numpy(), want[k].numpy(), FWD_REL, k)
    _momentum_close(state, new.opt_state[1].trace, CHEST_MAP, lambda _: GRAD_REL_2D, "2D")


def test_finetune_step_3d_matches_jax_float64(luna_setup):
    """One ``finetune_step_3d`` at b = 2, 16×16×8 on the pseudo-mask against
    ``make_finetune_step_3d`` in float64: loss and dice (1e-4 relative), the
    BN statistics after the step (1e-4 of each tensor's largest entry), and
    every momentum buffer (gradient + wd·p) within ``GRAD_REL_3D`` of its
    largest entry — the mask heads' and projection heads' too, where no
    gradient reaches (exactly wd·p on both sides).  Beforehand, the eval
    pass against ``make_finetune_eval_3d`` (1e-4 relative)."""
    variables, batch, (ev, new, metrics) = luna_setup
    model = PCRLv23d(policy=PARITY_POLICY, device="cpu", seed=0)
    vol, masks = ft.volumes_and_masks(_tensors(batch))
    got_ev = ft.finetune_eval_3d(model, vol, masks)
    for k in ("loss", "dice"):
        np.testing.assert_allclose(float(got_ev[k]), float(ev[k]), rtol=1e-4, err_msg=k)
    state = TrainState(model)
    got = ft.finetune_step_3d(state, vol, masks, LR)
    for k in ("loss", "dice"):
        np.testing.assert_allclose(float(got[k]), float(metrics[k]), rtol=1e-4, err_msg=k)
    heads = [n for n, p in model.named_parameters() if p.grad is None]
    assert heads and all(".deep_supervision_head." in n or ".predictor_head." in n
                         or n.startswith(("up_tr256.bn", "up_tr128.bn", "up_tr64.bn"))
                         for n in heads), heads
    want = ckpt.from_jax_variables({"params": new.params, "batch_stats": new.batch_stats})
    for k, v in model.state_dict().items():
        if k.endswith(("running_mean", "running_var")):
            _close(v.numpy(), want[k].numpy(), 1e-4, k)
    _momentum_close(state, new.opt_state[1].trace, ckpt.pcrlv23d_mapping(),
                    lambda _: GRAD_REL_3D, "3D")


def test_finetune_steps_read_nothing_back(monkeypatch):
    """The 2D step (uint8 images, dropout on a generator) and the 3D step
    (pseudo-mask computed inside) call no ``Tensor.item`` / ``tolist`` /
    ``__float__`` / ``__int__`` / ``__bool__``, as a captured graph requires,
    and return 0-d metrics."""
    state2 = TrainState(_classifier(dropout=0.2))
    state3 = TrainState(PCRLv23d(policy=PARITY_POLICY, device="cpu", seed=1))
    step = ft._step_fn(state2, torch.tensor(1e-3), torch.Generator().manual_seed(1), 2)
    step3 = ft._step_fn(state3, torch.tensor(1e-3), None, 3)
    chest, luna = _tensors(_chest_batch(1, b=2, size=32)), _tensors(_luna_batch(2))

    def host_read(*_):
        raise AssertionError("a finetune step read a tensor back to the host")

    with monkeypatch.context() as mp:
        for name in ("item", "tolist", "__float__", "__int__", "__bool__"):
            mp.setattr(torch.Tensor, name, host_read)
        outs = [step(chest)[0], step3(luna)[0]]
    assert all(v.dim() == 0 for m in outs for v in m.values())
    assert int(state2.step) == int(state3.step) == 1


# ---------------------------------------------------------------------------
# the trainer
# ---------------------------------------------------------------------------


def test_evaluate_weights_batches_gathers_auc_and_leaves_the_state(tmp_path):
    """``FinetuneTrainer.evaluate`` over a batch of 2 and a ragged one of 1
    (after a train epoch): means weighted by batch size over
    ``finetune_eval_2d``'s, ``eval_auc`` = ``mean_roc_auc`` of the whole set's
    logits, ``max_batches`` caps the pass; parameters, statistics, momentum
    and the dropout generator come out as they went in.  3D: the size-
    weighted ``finetune_eval_3d`` on the batches' own masks."""
    trainer = ft.FinetuneTrainer(_cfg(tmp_path), dim=2, n_class=N_CLASS, policy=PARITY_POLICY,
                                 device="cpu")
    trainer.train_epoch(0, [_tensors(_chest_batch(0, b=2, size=32))])
    before = {k: v.clone() for k, v in trainer.state.model.state_dict().items()}
    momentum = [b.clone() for b in trainer.state.optimizer.buffers]
    gen_state = trainer.dropout_gen.get_state()
    batches = [_tensors(_chest_batch(1, b=2, size=32, channels=3)),
               _tensors(_chest_batch(2, b=1, size=32, channels=3))]
    ev = trainer.evaluate(batches)
    parts = [ft.finetune_eval_2d(trainer.state.model, *ft.images_and_labels(b)) for b in batches]
    for k in ("loss", "acc"):
        np.testing.assert_allclose(ev[f"eval_{k}"], (2 * float(parts[0][k])
                                                     + float(parts[1][k])) / 3, rtol=1e-6)
    auc = ft.mean_roc_auc(torch.cat([p["logits"] for p in parts]).numpy(),
                          torch.cat([b["label"] for b in batches]).numpy())
    np.testing.assert_allclose(ev["eval_auc"], auc, rtol=1e-9)
    first = trainer.evaluate(batches, max_batches=1)
    assert first == trainer.evaluate(batches[:1]) and first != ev
    for k, v in trainer.state.model.state_dict().items():
        assert torch.equal(v, before[k]), k
    assert all(torch.equal(a, b) for a, b in zip(trainer.state.optimizer.buffers, momentum))
    assert torch.equal(trainer.dropout_gen.get_state(), gen_state)

    trainer3 = ft.FinetuneTrainer(_cfg(tmp_path / "3d"), dim=3, policy=PARITY_POLICY,
                                  device="cpu")
    luna = [_tensors(_luna_batch(3, masks=True)), _tensors(_luna_batch(4, b=1, masks=True))]
    ev3 = trainer3.evaluate(luna)
    parts = [ft.finetune_eval_3d(trainer3.state.model, *ft.volumes_and_masks(b)) for b in luna]
    for k in ("loss", "dice"):
        np.testing.assert_allclose(ev3[f"eval_{k}"], (2 * float(parts[0][k])
                                                      + float(parts[1][k])) / 3, rtol=1e-6)


def test_weight_loads_jax_exported_pt_leaf_exact(tmp_path, chest_setup, luna_setup):
    """``--weight`` from a ``.pt`` the JAX package wrote: its 2D
    ``export_resnet18_encoder`` (the pretask's encoder-only file) and a bare
    torchvision state_dict with ``fc.*`` (dropped) load into the classifier's
    encoder, and its ``export_pcrlv23d`` into the whole 3D model, each
    leaf-exact."""
    variables, *_ = chest_setup
    enc = {k: variables[k]["encoder"] for k in ("params", "batch_stats")}
    path = str(tmp_path / "enc.pt")
    jax_ckpt.export_resnet18_encoder(enc, path)
    want = ckpt.from_jax_variables(enc, mapping=ckpt.resnet18_encoder_mapping())
    bare = str(tmp_path / "bare.pt")
    torch.save(dict(want, **{"fc.weight": torch.zeros(1000, 512),
                             "fc.bias": torch.zeros(1000)}), bare)
    for weight in (path, bare):
        trainer = ft.FinetuneTrainer(_cfg(tmp_path), dim=2, policy=PARITY_POLICY,
                                     weight=weight, device="cpu")
        got = trainer.state.model.encoder.state_dict()
        for k, v in want.items():
            if not k.endswith("num_batches_tracked"):
                assert torch.equal(got[k], v), k

    variables3, *_ = luna_setup
    path3 = str(tmp_path / "m3d.pt")
    jax_ckpt.export_pcrlv23d(variables3, path3)
    trainer = ft.FinetuneTrainer(_cfg(tmp_path), dim=3, policy=PARITY_POLICY, weight=path3,
                                 device="cpu")
    for k, v in ckpt.from_jax_variables(variables3).items():
        assert torch.equal(trainer.state.model.state_dict()[k], v), k


def _schema():
    """The torchvision ResNet-18 ``state_dict`` schema fixture: {key: shape}."""
    path = os.path.join(os.path.dirname(os.path.dirname(__file__)), "fixtures",
                        "torchvision_resnet18_schema.txt")
    want = {}
    for line in open(path):
        if line.strip() and not line.startswith("#"):
            key, rest = line.split(" ", 1)
            want[key] = tuple(int(d) for d in rest.rsplit(" ", 1)[0].strip("()").split(",")
                              if d.strip())
    return want


def test_saved_pt_is_torchvision_complete_2d_and_strict_3d(tmp_path):
    """``FinetuneTrainer.save``: the 2D file in the reference schema
    (``opt``, ``state_dict``, ``optimizer``, ``epoch``) whose ``state_dict``
    has every key and shape of torchvision's ResNet-18
    (``tests/fixtures/torchvision_resnet18_schema.txt``) with ``fc`` n_class
    × 512, the classifier's own ``fc``; the 3D file loads strictly into the
    port's ``PCRLv23d`` and, through ``import_pcrlv23d``, into the JAX
    package's variables, equal to the trained model's."""
    trainer = ft.FinetuneTrainer(_cfg(tmp_path, n="chest"), dim=2, n_class=N_CLASS,
                                 policy=PARITY_POLICY, device="cpu")
    saved = ckpt.load_reference_checkpoint(trainer.save(3))
    assert set(saved) == {"opt", "state_dict", "optimizer", "epoch"} and saved["epoch"] == 3
    want = dict(_schema(), **{"fc.weight": (N_CLASS, 512), "fc.bias": (N_CLASS,)})
    assert {k: tuple(v.shape) for k, v in saved["state_dict"].items()} == want
    assert torch.equal(saved["state_dict"]["fc.weight"], trainer.state.model.fc.weight)
    fresh = ResNet18Encoder(device="cpu", seed=5)
    ckpt.import_resnet18_encoder(trainer.save(4), fresh)

    trainer3 = ft.FinetuneTrainer(_cfg(tmp_path), dim=3, policy=PARITY_POLICY, device="cpu")
    path = trainer3.save(0)
    assert os.path.basename(path) == "pcrlv2_luna_finetune_1.0_0.pt"
    ckpt.import_pcrlv23d(path, PCRLv23d(device="cpu", seed=3))
    jvars, _ = jax_ckpt.import_pcrlv23d(path)
    for k, v in ckpt.from_jax_variables(jvars).items():
        assert torch.equal(trainer3.state.model.state_dict()[k], v), k


# ---------------------------------------------------------------------------
# the data plane and the CLI
# ---------------------------------------------------------------------------


def _tiny_tree(root, masks=True):
    """A processed-LUNA layout at 16×16×8 crops with 2 local views of 8³ and
    a (2, 16, 16, 8) mask beside each pair: 10 subsets of one UID with 2
    pairs; the UID list beside it."""
    rng = np.random.RandomState(0)
    for s in range(10):
        d = os.path.join(root, f"subset{s}")
        os.makedirs(d)
        for k in range(2):
            np.save(os.path.join(d, f"1.2.{s}.0_global_{k}.npy"),
                    rng.rand(2, *SIZE3).astype(np.float32))
            np.save(os.path.join(d, f"1.2.{s}.0_local_{k}.npy"),
                    rng.rand(2, 8, 8, 8).astype(np.float32))
            if masks:
                np.save(os.path.join(d, f"1.2.{s}.0_mask_{k}.npy"),
                        (rng.rand(2, *SIZE3) > 0.6).astype(np.float32))
    with open(os.path.join(root, "luna_train.txt"), "w") as f:
        f.write("".join(f"1.2.{s}.0\n" for s in range(10)))


def test_mask_reader_and_finetune_list_match_jax(tmp_path):
    """``get_luna_finetune_list`` (the complement of the pretrain split),
    ``mask_path_for`` and ``make_luna_mask_reader`` (a 4-D mask file gives
    crop 0, a 3-D one itself) equal the JAX package's; a missing mask raises
    ``FileNotFoundError`` naming the path it looked for, in JAX's words."""
    root = str(tmp_path / "tree")
    _tiny_tree(root)
    lst = os.path.join(root, "luna_train.txt")
    for ratio in (0.0, 0.5, 1.0):
        assert manifests.get_luna_finetune_list(ratio, lst) == \
            jmanifests.get_luna_finetune_list(ratio, lst)
    gpath = os.path.join(root, "subset3", "1.2.3.0_global_1.npy")
    for mask_dir in (root, str(tmp_path / "masks")):
        assert pipeline.mask_path_for(gpath, mask_dir, root) == \
            jpipeline.mask_path_for(gpath, mask_dir, root)
    np.save(os.path.join(root, "subset3", "1.2.3.0_mask_0.npy"),
            (np.random.RandomState(1).rand(*SIZE3) > 0.5).astype(np.float32))
    for k in (0, 1):
        path = os.path.join(root, "subset3", f"1.2.3.0_global_{k}.npy")
        got = pipeline.make_luna_mask_reader(root, root)(path)
        want = jpipeline.make_luna_mask_reader(root, root)(path)
        assert got.keys() == want.keys() and got["mask"].shape == SIZE3 + (1,)
        for key in want:
            np.testing.assert_array_equal(got[key], want[key])
    os.remove(os.path.join(root, "subset3", "1.2.3.0_mask_1.npy"))
    with pytest.raises(FileNotFoundError) as err:
        pipeline.make_luna_mask_reader(root, root)(gpath)
    with pytest.raises(FileNotFoundError) as jerr:
        jpipeline.make_luna_mask_reader(root, root)(gpath)
    assert str(err.value) == str(jerr.value) and "1.2.3.0_mask_1.npy" in str(err.value)


def _rows(path):
    import json

    return [json.loads(s) for s in open(path)]


def test_cli_finetunes_3d_from_disk_with_masks_and_a_pretask_weight(tmp_path, capsys):
    """``--d 3 --phase finetune --data <tree> --mask_dir <tree> --ratio 0.5``
    from a pretask ``.pt`` (``--weight``): one epoch on the finetune split's
    crops (folds 0-6 of the 5 UIDs after the top half) against the mask
    files, an eval pass over folds 7-9 (``--eval_every``), its ``eval_*``
    row and the ``.pt``, which loads strictly; ``--resume`` is refused."""
    tree, out = str(tmp_path / "tree"), str(tmp_path / "out")
    _tiny_tree(tree)
    pretask = str(tmp_path / "pretask.pt")
    ckpt.export_pcrlv23d(PCRLv23d(device="cpu", seed=4), pretask)
    argv = ["--d", "3", "--phase", "finetune", "--data", tree, "--train_list",
            os.path.join(tree, "luna_train.txt"), "--ratio", "0.5", "--mask_dir", tree,
            "--b", "2", "--epochs", "0", "--eval_every", "1", "--eval_batches", "1",
            "--workers", "1", "--device", "cpu", "--output", out]
    trainer = cli.main(argv + ["--weight", pretask])
    text = capsys.readouterr().out
    assert "finetune train images 4, validation images 6" in text
    assert "REAL masks" in text and f"finetune initialized from {pretask}" in text
    assert [f for f in os.listdir(out) if f.endswith(".pt")] == [
        "pcrlv2_luna_finetune_0.5_0.pt"]
    rows = _rows(os.path.join(out, "metrics.jsonl"))
    assert [r["epoch"] for r in rows if "loss" in r] == [0]
    evals = [r for r in rows if "eval_loss" in r]
    assert [r["epoch"] for r in evals] == [0]
    assert all(np.isfinite(r[k]) for r in evals for k in ("eval_loss", "eval_dice"))
    assert int(trainer.state.step) == 2
    ckpt.import_pcrlv23d(os.path.join(out, "pcrlv2_luna_finetune_0.5_0.pt"),
                         PCRLv23d(device="cpu", seed=1))
    with pytest.raises(SystemExit, match="--resume is not supported"):
        cli.main(argv + ["--resume", out])


def test_cli_finetunes_synthetic_2d_and_3d(tmp_path, monkeypatch, capsys):
    """``--synthetic --phase finetune`` at the smallest sizes it takes: 2D on
    a 32² canvas (``--chest_canvas``, b = 4, 3 labels), 3D on 16×16×8 crops
    (b = 2; the loader's LUNA batches patched smaller), two epochs of one
    step, ``--eval_every 1`` on the second loader, ``--save_every 1``: one
    ``.pt`` per epoch, finite losses, ``eval_auc`` in 2D; the 2D ``.pt`` has
    the torchvision schema with ``fc`` 3 × 512.  ``--multihost``,
    ``--spatial`` and ``--encoder_weights`` are refused."""
    monkeypatch.setattr(cli, "synthetic_luna_batch",
                        lambda b, seed: pipeline.synthetic_luna_batch(
                            b, size=SIZE3, local=(8, 8, 8), n_views=2, seed=seed))
    common = ["--synthetic", "--phase", "finetune", "--epochs", "1", "--steps_per_epoch", "1",
              "--eval_every", "1", "--save_every", "1", "--device", "cpu"]
    for d, extra in (("2", ["--n", "chest", "--chest_canvas", "32", "--n_class", "3",
                            "--b", "4"]),
                     ("3", ["--b", "2"])):
        out = str(tmp_path / d)
        trainer = cli.main(common + ["--d", d, "--output", out] + extra)
        assert "finetuning FROM SCRATCH" in capsys.readouterr().out
        assert int(trainer.state.step) == 2
        name = "chest" if d == "2" else "luna"
        assert sorted(f for f in os.listdir(out) if f.endswith(".pt")) == [
            f"pcrlv2_{name}_finetune_1.0_{e}.pt" for e in (0, 1)]
        rows = _rows(os.path.join(out, "metrics.jsonl"))
        assert all(np.isfinite(r["loss"]) for r in rows if "loss" in r)
        evals = [r for r in rows if "eval_loss" in r]
        assert len(evals) == 2 and (d == "3" or all("eval_auc" in r for r in evals))
    saved = ckpt.load_reference_checkpoint(str(tmp_path / "2" / "pcrlv2_chest_finetune_1.0_1.pt"))
    assert {k: tuple(v.shape) for k, v in saved["state_dict"].items()} == dict(
        _schema(), **{"fc.weight": (3, 512), "fc.bias": (3,)})
    for flags, message in ((["--multihost"], "does not support --multihost"),
                           (["--spatial", "2"], "does not support --spatial"),
                           (["--d", "2", "--encoder_weights", "x.pt"], "starts from --weight")):
        with pytest.raises(SystemExit, match=message):
            cli.main(common + flags)
