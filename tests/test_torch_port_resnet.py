"""The port's ResNets, their train step, the classification evaluator and
the classification CLIs on the runner, against the JAX package on the CPU.

Tiny models on the same weights (``resnet_state_dict_from_jax``):
``ResNet(Bottleneck, [1, 1, 1, 1], inplanes=8)`` and a ``BasicBlock`` one at
64^2 (also with ``use_gradient_checkpoint``, and with the OCR backbones'
``stage_strides`` and ``return_features``), ``ResNetCifar`` at 32^2. Each
is held to the JAX model in fp32: eval and train-mode logits 1e-4 of the
logits' scale; every gradient 1e-4 of its largest value (fp32 convolutions
summed in other orders); the BatchNorm running statistics after one train
step 1e-5 (a control: ``nn.BatchNorm2d``'s update, by the unbiased variance,
must miss them by more than 100 times that); one SGD step from a carried
JAX state, each parameter's update 1e-4 of its largest value (the
gradients' tolerance) and so the momentum; a skipped step leaves
every BatchNorm buffer bit for bit as it was, as JAX's does; the weight map
round-trips through the JAX package's ``convert_resnet_state_dict``
exactly. The evaluator's top-1 / top-5 against JAX's on the same weights
(fp32: equal counts), with soft labels, ``output_index``, EMA parameters
and a short last batch. The classification train CLI on the runner with a
CIFAR ResNet on pickles the test writes (two epochs, a resume that repeats
the uninterrupted run bit for bit, the CUDA default), and the ImageNet-21K
train and eval CLIs on a JPEG tree.
"""

import pickle
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn

from simpleaicv_pytorch_training_examples_tpu.classification import (
    losses as jax_losses)
from simpleaicv_pytorch_training_examples_tpu.data import (
    DataLoader as JaxDataLoader)
from simpleaicv_pytorch_training_examples_tpu.engine import (
    TrainState, make_train_step as jax_make_train_step)
from simpleaicv_pytorch_training_examples_tpu.engine.evaluators import (
    classification_evaluator as jax_evaluator)
from simpleaicv_pytorch_training_examples_tpu.engine.runner import (
    RunContext as JaxRunContext)
from simpleaicv_pytorch_training_examples_tpu.models.backbones import (
    resnet as jax_resnet, resnetcifar as jax_resnetcifar)
from simpleaicv_pytorch_training_examples_tpu.parallel import build_mesh
from simpleaicv_pytorch_training_examples_tpu.utils import (
    optimizers as jax_optimizers)
from simpleaicv_pytorch_training_examples_tpu.utils.optimizers import (
    leaf_path_names)
from simpleaicv_pytorch_training_examples_tpu.utils.torch_convert import (
    convert_resnet_state_dict)
from simpleaicv_pytorch_training_examples_tpu_torch.classification import (
    common as port_common, losses as port_losses)
from simpleaicv_pytorch_training_examples_tpu_torch.data import build_loader
from simpleaicv_pytorch_training_examples_tpu_torch.engine import (
    RunContext, classification_evaluator, make_train_step)
from simpleaicv_pytorch_training_examples_tpu_torch.models.backbones import (
    resnet, resnetcifar)
from simpleaicv_pytorch_training_examples_tpu_torch.models.common import (
    BatchNorm2d, batch_stat_buffers)
from simpleaicv_pytorch_training_examples_tpu_torch.tools import (
    test_imagenet21k_classification_model as in21k_test_cli,
    train_classification_model as train_cli,
    train_imagenet21k_classification_model as in21k_train_cli)
from simpleaicv_pytorch_training_examples_tpu_torch.utils import (
    build_optimizer)
from simpleaicv_pytorch_training_examples_tpu_torch.utils.jax_weights import (
    optimizer_state_from_jax, resnet_state_dict_from_jax)
from torch_port_helpers import (IN21K_TREE, random_flat, unflatten,
                                write_in21k_root)
from torch_port_helpers import (  # noqa: F401 (autouse)
    drop_work_dir_configs, one_torch_thread)

LR = 0.1
KINDS = ("bottleneck", "basic", "bottleneck_remat", "cifar")


def _pair(kind, **kwargs):
    """(JAX model, port model, image size) of one tiny ResNet."""
    if kind == "cifar":
        return (jax_resnetcifar.ResNetCifar(
                    jax_resnet.BasicBlock, [1, 1, 1, 1], 8, num_classes=10),
                resnetcifar.ResNetCifar(resnet.BasicBlock, [1, 1, 1, 1], 8,
                                        num_classes=10), 32)
    remat = kind == "bottleneck_remat"
    jax_block, block = {"basic": (jax_resnet.BasicBlock, resnet.BasicBlock)
                        }.get(kind, (jax_resnet.Bottleneck, resnet.Bottleneck))
    return (jax_resnet.ResNet(jax_block, [1, 1, 1, 1], 8, num_classes=10,
                              use_gradient_checkpoint=remat, **kwargs),
            resnet.ResNet(block, [1, 1, 1, 1], 8, num_classes=10,
                          use_gradient_checkpoint=remat, **kwargs), 64)


def _flat(tree):
    return dict(zip(leaf_path_names(tree),
                    (np.asarray(l) for l in jax.tree_util.tree_leaves(tree))))


def _models(kind, seed=1, **kwargs):
    """Both models on the same seeded weights and batch statistics; returns
    (jax model, port model, params flat, batch stats flat, image size)."""
    jax_model, port_model, size = _pair(kind, **kwargs)
    shapes = jax.eval_shape(jax_model.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, size, size, 3)))
    params = random_flat(shapes["params"], seed)
    rs = np.random.RandomState(seed + 1)
    tree = shapes["batch_stats"]
    stats = {n: ((0.1 * rs.standard_normal(v.shape)) if n.endswith("mean")
                 else (1.0 + 0.5 * rs.uniform(size=v.shape))).astype(
                     np.float32)
             for n, v in zip(leaf_path_names(tree),
                             jax.tree_util.tree_leaves(tree))}
    port_model.load_state_dict(resnet_state_dict_from_jax(params, stats))
    return jax_model, port_model, params, stats, size


def _images(size, n=4, seed=5):
    rs = np.random.RandomState(seed)
    return (rs.standard_normal((n, size, size, 3)).astype(np.float32),
            rs.randint(0, 10, n))


def _nchw(images):
    return torch.from_numpy(images.transpose(0, 3, 1, 2).copy())


def _close(got, want, scale_rtol, name=""):
    want = np.asarray(want)
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    scale = max(np.abs(want).max(), 1e-30)
    np.testing.assert_allclose(got, want, rtol=0, atol=scale_rtol * scale,
                               err_msg=name)


def _stats_error(port_model, new_stats):
    """Largest |running stat - JAX's| over every BatchNorm buffer."""
    want = resnet_state_dict_from_jax({}, new_stats)
    got = port_model.state_dict()
    return max(np.abs(got[n].numpy() - w.numpy()).max()
               for n, w in want.items() if "running" in n)


# ------------------------------------------------------------- the model


@pytest.mark.parametrize("kind", KINDS)
def test_logits_and_gradients_match_jax(kind):
    jax_model, port_model, params, stats, size = _models(kind)
    images, labels = _images(size)
    variables = {"params": unflatten(params), "batch_stats": unflatten(stats)}
    want = jax.jit(jax_model.apply)(variables, jnp.asarray(images))
    got = port_model.eval()(_nchw(images))
    assert got.dtype == torch.float32 and got.shape == (4, 10)
    _close(got, want, 1e-4, "eval logits")

    def loss_fn(p):
        out, _ = jax_model.apply({"params": p,
                                  "batch_stats": variables["batch_stats"]},
                                 jnp.asarray(images), train=True,
                                 mutable=["batch_stats"])
        return jax_losses.CELoss()(out, jnp.asarray(labels)), out
    (want_loss, want_train), grads = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(variables["params"])
    port_model.train()
    out = port_model(_nchw(images))
    _close(out, want_train, 1e-4, "train logits")
    loss = port_losses.CELoss()(out, torch.from_numpy(labels))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-5)
    want_grads = resnet_state_dict_from_jax(_flat(grads), {})
    named = dict(port_model.named_parameters())
    assert set(want_grads) == set(named)
    for name, w in want_grads.items():
        _close(named[name].grad, w.numpy(), 1e-4, name)


@pytest.mark.parametrize("kind", KINDS)
def test_running_statistics_after_one_train_forward_match_jax(kind):
    """Flax's update by the biased variance; torch's nn.BatchNorm2d, with
    the same weights and its momentum read the other way round (0.1), moves
    running_var by the unbiased variance, which this check must catch."""
    jax_model, port_model, params, stats, size = _models(kind)
    images, _ = _images(size, n=2)
    _, new_vars = jax.jit(lambda v, x: jax_model.apply(
        v, x, train=True, mutable=["batch_stats"]))(
        {"params": unflatten(params), "batch_stats": unflatten(stats)},
        jnp.asarray(images))
    new_stats = _flat(new_vars["batch_stats"])
    port_model.train()(_nchw(images)).sum().backward()
    assert _stats_error(port_model, new_stats) <= 1e-5
    assert all(int(b) == 1 for n, b in port_model.state_dict().items()
               if n.endswith("num_batches_tracked"))

    _, control, *_ = _models(kind)
    for module in list(control.modules()):
        for name, child in module.named_children():
            if isinstance(child, BatchNorm2d):
                stock = torch.nn.BatchNorm2d(child.weight.numel(), eps=1e-5,
                                             momentum=0.1)
                stock.load_state_dict(child.state_dict())
                setattr(module, name, stock)
    control.train()(_nchw(images))
    assert _stats_error(control, new_stats) > 100 * 1e-5


def _sgd_config(params):
    class config:
        optimizer = ("SGD", {"lr": LR, "momentum": 0.9,
                             "global_weight_decay": False,
                             "weight_decay": 1e-4,
                             "no_weight_decay_layer_name_list": []})
        scheduler = ("MultiStepLR", {"warm_up_epochs": 0, "gamma": 0.1,
                                     "milestones": [30, 60, 90]})
        epochs = 100
    return config


def _steps(kind, nan=False):
    """One SGD step on each side from the same carried state (momentum and
    step count), fp32. Returns both sides' states and metrics."""
    jax_model, port_model, params, stats, size = _models(kind)
    images, labels = _images(size, seed=9)
    if nan:
        images[1, 2, 3, 0] = np.nan
    jax_params = unflatten(params)
    tx, _ = jax_optimizers.build_optimizer(_sgd_config(None), jax_params, 10)
    rs = np.random.RandomState(3)
    momentum = {n: (0.01 * rs.standard_normal(v.shape)).astype(np.float32)
                for n, v in params.items()}
    opt_state = type(tx.init(jax_params))(jnp.asarray(3, jnp.int32),
                                          unflatten(momentum))
    state = TrainState(step=jnp.zeros((), jnp.int32), params=jax_params,
                       variables={"batch_stats": unflatten(stats)},
                       opt_state=opt_state, ema_params=None)
    jax_step = jax_make_train_step(jax_model, jax_losses.CELoss(), tx,
                                   compute_dtype=jnp.float32, donate=False)
    state, want = jax_step(state, {"image": jnp.asarray(images),
                                   "label": jnp.asarray(labels)},
                           jax.random.PRNGKey(0))
    optimizer, _ = build_optimizer(_sgd_config(None), port_model, 10)
    optimizer.load_state_dict(optimizer_state_from_jax(
        3, model="resnet", momentum_buf=momentum))
    before = {n: b.clone() for n, b in port_model.state_dict().items()}
    port_step = make_train_step(port_model, port_losses.CELoss(), optimizer,
                                compute_dtype=torch.float32)
    got = port_step({"image": _nchw(images),
                     "label": torch.from_numpy(labels)}, 0)
    return state, want, port_model, optimizer, got, before


@pytest.mark.parametrize("kind", ["bottleneck", "basic", "cifar"])
def test_one_sgd_step_from_a_carried_jax_state(kind):
    state, want, port_model, optimizer, got, before = _steps(kind)
    assert want["skipped"] == got["skipped"].item() == 0.0
    np.testing.assert_allclose(got["loss"].item(), float(want["loss"]),
                               rtol=1e-5)
    assert int(optimizer.step) == int(state.opt_state.step) == 4
    named = dict(port_model.named_parameters())
    for name, w in resnet_state_dict_from_jax(_flat(state.params),
                                              {}).items():
        old = before[name].numpy()
        _close(named[name].detach().numpy() - old, w.numpy() - old, 1e-4,
               name)
    moments = optimizer.state_dict()["momentum_buf"]
    for name, w in resnet_state_dict_from_jax(
            _flat(state.opt_state.momentum_buf), {}).items():
        _close(moments[name], w.numpy(), 1e-4, name)
    assert _stats_error(port_model, _flat(
        state.variables["batch_stats"])) <= 1e-5


@pytest.mark.parametrize("kind", ["bottleneck", "cifar"])
def test_a_skipped_step_leaves_every_batchnorm_buffer_as_it_was(kind):
    state, want, port_model, optimizer, got, before = _steps(kind, nan=True)
    assert want["skipped"] == got["skipped"].item() == 1.0
    assert int(optimizer.step) == int(state.opt_state.step) == 3
    after = port_model.state_dict()
    buffers = [n for n, _ in port_model.named_buffers()]
    assert len(buffers) == len(batch_stat_buffers(port_model)) > 0
    for name in after:
        assert torch.equal(after[name], before[name]), name
    # JAX keeps its batch statistics on the skipped step too
    for name, w in resnet_state_dict_from_jax({}, _flat(
            state.variables["batch_stats"])).items():
        if "running" in name:
            np.testing.assert_array_equal(before[name].numpy(), w.numpy())


@pytest.mark.parametrize("kind", ["bottleneck", "basic", "cifar"])
def test_the_weight_map_round_trips_through_convert_resnet_state_dict(kind):
    _, port_model, params, stats, _ = _models(kind)
    sd = {k: v.numpy() for k, v in port_model.state_dict().items()}
    back_params, back_stats = convert_resnet_state_dict(sd)
    assert set(back_params) == set(params) and set(back_stats) == set(stats)
    for name in params:
        np.testing.assert_array_equal(back_params[name], params[name])
    for name in stats:
        np.testing.assert_array_equal(back_stats[name], stats[name])


def test_stage_strides_and_features_match_jax():
    """The OCR backbones' strides, (2, 1) keeping the width."""
    strides = (1, 2, (2, 1), (2, 1))
    jax_model, port_model, params, stats, _ = _models(
        "basic", stage_strides=strides)
    images, _ = _images(64, n=2)
    want = jax_model.apply({"params": unflatten(params),
                            "batch_stats": unflatten(stats)},
                           jnp.asarray(images), return_features=True)
    got = port_model.eval()(_nchw(images), return_features=True)
    assert [f.shape[1] for f in got] == port_model.out_channels == [
        8, 16, 32, 64] == list(jax_model.out_channels)
    assert got[-1].shape[2:] == (2, 8)
    for g, w in zip(got, want):
        _close(g, np.asarray(w).transpose(0, 3, 1, 2), 1e-4)


# ----------------------------------------------------------- the evaluator


class _JaxPair(fnn.Module):
    """A model with two outputs, the second the logits."""
    inner: fnn.Module

    @fnn.compact
    def __call__(self, x, train=False):
        logits = self.inner(x, train)
        return -logits, logits


class _PortPair(torch.nn.Module):

    def __init__(self, inner):
        super().__init__()
        self.inner = inner

    def forward(self, x):
        logits = self.inner(x)
        return -logits, logits


class _Images:

    def __init__(self, images, labels):
        self.images, self.labels = images, labels

    def __len__(self):
        return len(self.images)

    def __getitem__(self, i):
        return {"image": self.images[i], "label": self.labels[i]}


def _jax_collate(samples):
    return {"image": np.stack([s["image"] for s in samples]),
            "label": np.stack([s["label"] for s in samples])}


@pytest.mark.parametrize("case", ["plain", "soft_labels_output_index", "ema"])
def test_classification_evaluator_matches_jax(case):
    jax_model, port_model, params, stats, size = _models("bottleneck")
    images, labels = _images(size, n=13, seed=11)
    if case == "soft_labels_output_index":
        labels = (np.eye(10, dtype=np.float32)[labels] * 0.7 + 0.03)
        jax_model, port_model = _JaxPair(jax_model), _PortPair(port_model)
        output_index = 1
    else:
        output_index = None

    class config:
        use_amp = False
        use_ema_model = case == "ema"

    ema = {n: v * 0.9 for n, v in params.items()}
    prefix = "inner." if output_index else ""
    jax_params = unflatten(params)
    state = TrainState(
        step=jnp.zeros((), jnp.int32),
        params={"inner": jax_params} if output_index else jax_params,
        variables={"batch_stats": ({"inner": unflatten(stats)}
                                   if output_index else unflatten(stats))},
        opt_state=(), ema_params=unflatten(ema))
    dataset = _Images(images, labels)
    mesh = build_mesh()
    jax_loader = JaxDataLoader(dataset, 4, _jax_collate, shuffle=False,
                               drop_last=False)
    want = jax_evaluator(jax_model, config, JaxRunContext(
        mesh, None, jax_loader, None, mesh.devices.size),
        output_index=output_index)(state)
    ema_by_name = resnet_state_dict_from_jax(ema, {})
    ema_params = [ema_by_name[n[len(prefix):]]
                  for n, _ in port_model.named_parameters()]

    def collate(samples):
        batch = _jax_collate(samples)
        return {"image": _nchw(batch["image"]),
                "label": torch.from_numpy(batch["label"])}
    loader = build_loader(dataset, 4, collate, "cpu")
    assert [len(b["label"]) for b in loader] == [4, 4, 4, 1]
    evaluate = classification_evaluator(
        port_model, config, RunContext(loader, None, torch.device("cpu"),
                                       ema_params),
        output_index=output_index)
    metric, log_line, values = evaluate()
    assert metric == want[0] and log_line == want[1]
    assert values["images"] == 13
    assert values["top1"] == want[0] and 0 < values["top5"] <= 100
    assert evaluate.metric_name == "acc"
    if case == "ema":   # the live parameters give another reading
        plain = classification_evaluator(
            port_model, type("c", (), {"use_amp": False}),
            RunContext(loader, None, torch.device("cpu")))()
        assert plain[2]["images"] == 13


# -------------------------------------------------------------- the CLIs

CIFAR_CONFIG = """
import numpy as np

from simpleaicv_pytorch_training_examples_tpu_torch.classification import losses
from simpleaicv_pytorch_training_examples_tpu_torch.classification.common import (
    ClassificationCollater, Opencv2PIL, TorchMeanStdNormalize, TorchPad,
    TorchRandomCrop, TorchRandomHorizontalFlip)
from simpleaicv_pytorch_training_examples_tpu_torch.classification.datasets.cifar100dataset import (
    CIFAR100Dataset)
from simpleaicv_pytorch_training_examples_tpu_torch.data import Compose
from simpleaicv_pytorch_training_examples_tpu_torch.models.backbones.resnet import BasicBlock
from simpleaicv_pytorch_training_examples_tpu_torch.models.backbones.resnetcifar import ResNetCifar

normalize = TorchMeanStdNormalize(mean=np.array([125.3, 123.0, 113.9]) / 255.0,
                                  std=np.array([63.0, 62.1, 66.7]) / 255.0)


class config:
    model = ResNetCifar(BasicBlock, [1, 1, 1, 1], 8, num_classes=100)
    train_criterion = losses.CELoss()
    train_dataset = CIFAR100Dataset(
        root_dir="{root}", set_name="train",
        transform=Compose([Opencv2PIL(),
                           TorchPad(padding=4, fill=0, padding_mode="reflect"),
                           TorchRandomHorizontalFlip(prob=0.5),
                           TorchRandomCrop(resize=32), normalize]))
    test_dataset = CIFAR100Dataset(root_dir="{root}", set_name="test",
                                   transform=Compose([normalize]))
    train_collater = ClassificationCollater()
    test_collater = ClassificationCollater()
    seed = 0
    batch_size = 8
    num_workers = 0
    optimizer = ("SGD", {{"lr": 0.1, "momentum": 0.9,
                          "global_weight_decay": False, "weight_decay": 5e-4,
                          "no_weight_decay_layer_name_list": []}})
    scheduler = ("MultiStepLR", {{"warm_up_epochs": 0, "gamma": 0.2,
                                  "milestones": [60, 120, 160]}})
    epochs = {epochs}
    print_interval = 2
    use_amp = {use_amp}
    use_ema_model = {ema}
    ema_model_decay = 0.5
"""


def _cifar_root(root, n_train=24, n_test=10):
    rs = np.random.RandomState(2)
    base = root / "cifar-100-python"
    base.mkdir(parents=True)
    for name, n in (("train", n_train), ("test", n_test)):
        with open(base / name, "wb") as f:
            pickle.dump({b"data": rs.randint(0, 256, (n, 3072)).astype(
                np.uint8), b"fine_labels": rs.randint(0, 100, n).tolist()}, f)


def _write_cifar_config(work_dir, root, epochs, use_amp=True, ema=False):
    work_dir.mkdir(exist_ok=True)
    (work_dir / "train_config.py").write_text(CIFAR_CONFIG.format(
        root=root, epochs=epochs, use_amp=use_amp, ema=ema))


def test_train_cli_on_the_runner_with_a_cifar_resnet(tmp_path):
    _cifar_root(tmp_path / "data")
    work = tmp_path / "run"
    _write_cifar_config(work, tmp_path / "data", epochs=2, ema=True)
    first = train_cli.main(["--work-dir", str(work)], device="cpu")
    assert first["resumed_from"] is None
    assert [e["epoch"] for e in first["epochs"]] == [1, 2]
    for e in first["epochs"]:
        assert e["skipped"] == 0 and np.isfinite(e["loss_avg"])
        assert 0.0 <= e["top1"] <= e["top5"] <= 100.0
        assert 0.0 <= e["loader_wait_seconds"] <= e["seconds"]
        assert e["loader_start_seconds"] >= 0.0
        assert e["first_batch_wait_seconds"] >= 0.0
        assert e["loader_start_seconds"] + e[
            "first_batch_wait_seconds"] <= e["loader_wait_seconds"] + 1e-9
        assert e["step_seconds"] == pytest.approx(
            e["seconds"] - e["loader_wait_seconds"])
    log = (work / "log" / "train.log").read_text()
    assert re.search(r"epoch 2 iter 2/3 lr 0\.100000 loss \d+\.\d{4} avg "
                     r"\d+\.\d{4} skipped 0", log)
    assert re.search(r"epoch 2: top1 \d+\.\d{3} top5 \d+\.\d{3} train loss "
                     r"avg \d+\.\d{4} hours", log)
    latest = torch.load(work / "checkpoints" / "latest.pth",
                        weights_only=False)
    assert int(latest["optimizer_state_dict"]["step"]) == 6
    assert int(latest["model_state_dict"][
        "conv1.layer.1.num_batches_tracked"]) == 6
    # best.pth: the EMA parameters with the live statistics
    best = torch.load(work / "checkpoints" / "best.pth",
                      weights_only=False)["model_state_dict"]
    bn = "conv1.layer.1."
    assert int(best[bn + "num_batches_tracked"]) in (3, 6)
    if int(best[bn + "num_batches_tracked"]) == 6:
        for name in (bn + "running_var", "fc.weight"):
            assert torch.equal(best[name], latest["ema_state_dict"][name])
        assert not torch.equal(best["fc.weight"],
                               latest["model_state_dict"]["fc.weight"])

    _write_cifar_config(work, tmp_path / "data", epochs=3, ema=True)
    again = train_cli.main(["--work-dir", str(work)], device="cpu")
    assert again["resumed_from"] == 2
    assert [e["epoch"] for e in again["epochs"]] == [3]
    assert re.search(r"resumed from epoch 2, best acc \d+\.\d{3}",
                     (work / "log" / "train.log").read_text())


def test_a_resumed_cifar_run_repeats_the_uninterrupted_one(tmp_path):
    """Parameters, momentum and every BatchNorm buffer end bit for bit
    where two epochs in one run end."""
    _cifar_root(tmp_path / "data")
    whole, parts = tmp_path / "whole", tmp_path / "parts"
    _write_cifar_config(whole, tmp_path / "data", epochs=2, use_amp=False)
    train_cli.main(["--work-dir", str(whole)], device="cpu")
    _write_cifar_config(parts, tmp_path / "data", epochs=1, use_amp=False)
    train_cli.main(["--work-dir", str(parts)], device="cpu")
    _write_cifar_config(parts, tmp_path / "data", epochs=2, use_amp=False)
    assert train_cli.main(["--work-dir", str(parts)],
                          device="cpu")["resumed_from"] == 1
    a, b = (torch.load(d / "checkpoints" / "latest.pth", weights_only=False)
            for d in (whole, parts))
    for name, tensor in a["model_state_dict"].items():
        assert torch.equal(tensor, b["model_state_dict"][name]), name
    for name, tensor in a["optimizer_state_dict"]["momentum_buf"].items():
        assert torch.equal(tensor,
                           b["optimizer_state_dict"]["momentum_buf"][name])


def test_the_train_cli_runs_on_cuda_unless_the_cpu_is_asked_for(
        tmp_path, monkeypatch):
    _cifar_root(tmp_path / "data")
    _write_cifar_config(tmp_path / "run", tmp_path / "data", epochs=1)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train_cli.main(["--work-dir", str(tmp_path / "run")])


IN21K_CONFIG = """
import torch

from simpleaicv_pytorch_training_examples_tpu_torch.classification import losses
from simpleaicv_pytorch_training_examples_tpu_torch.classification.common import (
    ClassificationCollater, TorchCenterCrop, TorchMeanStdNormalize,
    TorchRandomHorizontalFlip, TorchRandomResizedCrop, TorchResize,
    load_state_dict)
from simpleaicv_pytorch_training_examples_tpu_torch.classification.datasets.imagenet21kdataset import (
    ImageNet21KSemanticTreeLabelDataset)
from simpleaicv_pytorch_training_examples_tpu_torch.data import Compose
from simpleaicv_pytorch_training_examples_tpu_torch.models.backbones.resnet import (
    Bottleneck, ResNet)

normalize = TorchMeanStdNormalize(mean=[0.485, 0.456, 0.406],
                                  std=[0.229, 0.224, 0.225])


class config:
    model = ResNet(Bottleneck, [1, 1, 1, 1], 8, num_classes=7,
                   dtype=torch.bfloat16)
    load_state_dict("{weights}", model)
    train_dataset = ImageNet21KSemanticTreeLabelDataset(
        root_dir="{root}", set_name="train",
        transform=Compose([TorchRandomResizedCrop(resize=64),
                           TorchRandomHorizontalFlip(prob=0.5), normalize]))
    test_dataset = ImageNet21KSemanticTreeLabelDataset(
        root_dir="{root}", set_name="val",
        transform=Compose([TorchResize(resize=72), TorchCenterCrop(resize=64),
                           normalize]))
    train_collater = ClassificationCollater()
    test_collater = ClassificationCollater()
    train_criterion = losses.SemanticSoftmaxLoss(
        train_dataset.normalization_factor_list)
    seed = 0
    batch_size = 4
    num_workers = 0
    optimizer = ("AdamW", {{"lr": 3e-4, "global_weight_decay": False,
                            "weight_decay": 1e-4,
                            "no_weight_decay_layer_name_list": []}})
    scheduler = ("CosineLR", {{"warm_up_epochs": 1, "min_lr": 1e-6}})
    epochs = 1
    print_interval = 1
    use_amp = True
"""


def test_imagenet21k_train_and_eval_clis_on_a_jpeg_tree(tmp_path):
    write_in21k_root(tmp_path / "data", IN21K_TREE)
    work = tmp_path / "run"
    work.mkdir()
    (work / "train_config.py").write_text(IN21K_CONFIG.format(
        weights="", root=tmp_path / "data"))
    run = in21k_train_cli.main(["--work-dir", str(work)], device="cpu")
    assert [e["epoch"] for e in run["epochs"]] == [1]
    assert np.isfinite(run["epochs"][0]["loss_avg"])
    assert 0.0 <= run["epochs"][0]["top1"] <= 100.0
    log = (work / "log" / "train.log").read_text()
    assert len(re.findall(r"epoch 1 iter \d/1 lr", log)) == 1
    (work / "test_config.py").write_text(IN21K_CONFIG.format(
        weights=work / "checkpoints" / "best.pth", root=tmp_path / "data"))
    values = in21k_test_cli.main(["--work-dir", str(work)], device="cpu")
    assert values["images"] == 7
    test_log = (work / "log" / "test.log").read_text()
    assert re.search(r"pretrained load: (\d+)/\1 tensors", test_log)
    assert re.search(r"top1 \d+\.\d{3} top5 \d+\.\d{3} images/s [\d.]+ on cpu",
                     test_log)
