"""The port's knowledge distillation against the JAX package, on the CPU.

- ``KDLoss``, ``DMLLoss`` and ``L2Loss`` on the same logits (bf16 and fp32).
- ``KDModel`` with two ResNet-18s (10 classes, 64^2) on the same weights
  (``kd_state_dict_from_jax``): a frozen teacher stays in eval mode after
  ``train()`` (its logits are JAX's eval-mode teacher's, its BatchNorm
  buffers never move) and gets no gradient; a joint (DML) teacher trains
  and its BatchNorm statistics move as JAX's.
- One distillation step on each side from the same carried SGD state
  (``freeze_teacher`` sets the teacher's lr to 0 through ``sub_layer_lr`` on
  both), with the root JAX tool's loss function and the port CLI's: the loss
  dict, every parameter's update, the BatchNorm statistics.
- The port's distill CLI on the committed JPEG fixtures: two epochs, a
  resume that repeats the uninterrupted run bit for bit, the frozen teacher
  bit for bit as it started, the student scored, and the CUDA default.

Tolerances, as the ResNet tests': fp32 logits and every parameter's update
1e-4 of their largest value (fp32 convolutions summed in other orders; at
64^2 the worst update reads 3.5e-5 of its largest, where at 32^2 the last
stage's BatchNorm over 1x1 maps of 4 images brought it to 1e-4),
losses 1e-5 relative, BatchNorm statistics 1e-5; the bf16 losses 1e-4
relative (both sides cast the same bf16 logits to fp32); frozen parts bit
for bit.
"""

import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from simpleaicv_pytorch_training_examples_tpu.distillation import (
    losses as jax_losses)
from simpleaicv_pytorch_training_examples_tpu.distillation.distillmodel import (
    KDModel as JaxKDModel)
from simpleaicv_pytorch_training_examples_tpu.engine import (
    TrainState, make_train_step as jax_make_train_step)
from simpleaicv_pytorch_training_examples_tpu.utils import (
    optimizers as jax_optimizers)
from simpleaicv_pytorch_training_examples_tpu.utils.optimizers import (
    leaf_path_names)
from simpleaicv_pytorch_training_examples_tpu_torch.distillation import (
    KDModel, losses as port_losses)
from simpleaicv_pytorch_training_examples_tpu_torch.engine import (
    init_model, make_train_step)
from simpleaicv_pytorch_training_examples_tpu_torch.tools import (
    train_distill_classification_model as distill_cli)
from simpleaicv_pytorch_training_examples_tpu_torch.utils import (
    build_optimizer)
from simpleaicv_pytorch_training_examples_tpu_torch.utils.jax_weights import (
    kd_state_dict_from_jax, optimizer_state_from_jax)
from torch_port_helpers import random_flat, unflatten
from torch_port_helpers import (  # noqa: F401 (autouse)
    drop_work_dir_configs, one_torch_thread)

REPO = Path(__file__).resolve().parents[1]
JPEG_FIXTURES = REPO / "tests" / "torch_port_data" / "jpeg"
SIZE, N_CLASSES, LR = 64, 10, 0.1


def _flat(tree):
    return dict(zip(leaf_path_names(tree),
                    (np.asarray(l) for l in jax.tree_util.tree_leaves(tree))))


def _close(got, want, scale_rtol, name=""):
    want = np.asarray(want)
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    scale = max(np.abs(want).max(), 1e-30)
    np.testing.assert_allclose(got, want, rtol=0, atol=scale_rtol * scale,
                               err_msg=name)


@pytest.mark.parametrize("name", ["KDLoss", "DMLLoss", "L2Loss"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_pairwise_losses_match_jax(name, dtype):
    rs = np.random.RandomState(0)
    stu, tea = (3.0 * rs.standard_normal((6, N_CLASSES)).astype(np.float32)
                for _ in range(2))
    args = () if name == "L2Loss" else (2.0,)
    jd, td = {"float32": (jnp.float32, torch.float32),
              "bfloat16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    want = getattr(jax_losses, name)(*args)(jnp.asarray(stu, jd),
                                            jnp.asarray(tea, jd))
    got = getattr(port_losses, name)(*args)(torch.from_numpy(stu).to(td),
                                           torch.from_numpy(tea).to(td))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.item(), float(want),
                               rtol=1e-5 if dtype == "float32" else 1e-4)


def _models(freeze, seed=1):
    """JAX and port KDModels (two ResNet-18s) on the same random weights and
    batch statistics; returns (jax model, port model, params, stats)."""
    jax_model = JaxKDModel("resnet18", "resnet18", freeze_teacher=freeze,
                           num_classes=N_CLASSES)
    port_model = KDModel("resnet18", "resnet18", freeze_teacher=freeze,
                         num_classes=N_CLASSES)
    shapes = jax.eval_shape(jax_model.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, SIZE, SIZE, 3)))
    params = random_flat(shapes["params"], seed)
    rs = np.random.RandomState(seed + 1)
    stats = {n: ((0.1 * rs.standard_normal(v.shape)) if n.endswith("mean")
                 else (1.0 + 0.5 * rs.uniform(size=v.shape))).astype(
                     np.float32)
             for n, v in zip(leaf_path_names(shapes["batch_stats"]),
                             jax.tree_util.tree_leaves(shapes["batch_stats"]))}
    port_model.load_state_dict(kd_state_dict_from_jax(params, stats))
    return jax_model, port_model, params, stats


def _images(n=4, seed=5):
    rs = np.random.RandomState(seed)
    return (rs.standard_normal((n, SIZE, SIZE, 3)).astype(np.float32),
            rs.randint(0, N_CLASSES, n))


def _nchw(images):
    return torch.from_numpy(images.transpose(0, 3, 1, 2).copy())


@pytest.mark.parametrize("freeze", [True, False])
def test_train_mode_forward_and_teacher_state_match_jax(freeze):
    jax_model, port_model, params, stats = _models(freeze)
    images, _ = _images()
    (want_tea, want_stu), new_vars = jax.jit(
        lambda p, s, x: jax_model.apply(
            {"params": p, "batch_stats": s}, x, train=True,
            mutable=["batch_stats"]))(unflatten(params), unflatten(stats),
                                      jnp.asarray(images))
    port_model.train()
    assert port_model.student.training
    assert port_model.teacher.training == (not freeze)
    before = {n: b.clone() for n, b in port_model.named_buffers()}
    tea, stu = port_model(_nchw(images))
    _close(tea, want_tea, 1e-4, "teacher")
    _close(stu, want_stu, 1e-4, "student")
    assert tea.requires_grad == (not freeze)
    want_stats = kd_state_dict_from_jax({}, _flat(new_vars["batch_stats"]))
    for name, b in port_model.named_buffers():
        if name.startswith("teacher.") and freeze:
            assert torch.equal(b, before[name]), name
        elif "running" in name:
            _close(b, want_stats[name].numpy(), 1e-5, name)
    if freeze:
        stu.float().sum().backward()
        assert all(p.grad is None for p in port_model.teacher.parameters())
        assert all(p.grad is not None
                   for p in port_model.student.parameters())


class KDConfig:
    loss_ratio = {"CELoss": 1.0, "KDLoss": 1.0}
    use_amp = False
    optimizer = ("SGD", {"lr": LR, "momentum": 0.9,
                         "global_weight_decay": False, "weight_decay": 1e-4,
                         "no_weight_decay_layer_name_list": []})
    scheduler = ("MultiStepLR", {"warm_up_epochs": 0, "gamma": 0.1,
                                 "milestones": [30, 60, 90]})
    epochs = 100


def _config(freeze, package_losses):
    pairwise = "KDLoss" if freeze else "DMLLoss"

    class config(KDConfig):
        freeze_teacher = freeze
        loss_ratio = {"CELoss": 1.0, pairwise: 1.0}
        train_criterion = {
            "CELoss": package_losses.CELoss(),
            pairwise: getattr(package_losses, pairwise)(1.0)}
    return distill_cli.freeze_teacher_lr(config)


@pytest.mark.parametrize("freeze", [True, False])
def test_one_distillation_step_from_a_carried_jax_state(freeze, monkeypatch):
    monkeypatch.syspath_prepend(str(REPO / "tools"))
    sys.modules.pop("train_distill_classification_model", None)
    from train_distill_classification_model import (
        build_loss_fn as jax_build_loss_fn)
    jax_model, port_model, params, stats = _models(freeze)
    images, labels = _images(seed=9)
    jax_config, port_config = (_config(freeze, jax_losses),
                               _config(freeze, port_losses))
    assert (jax_config.optimizer[1].get("sub_layer_lr") == {
        "teacher": 0.0}) == freeze
    jax_params = unflatten(params)
    tx, _ = jax_optimizers.build_optimizer(jax_config, jax_params, 10)
    rs = np.random.RandomState(3)
    momentum = {n: (0.01 * rs.standard_normal(v.shape)).astype(np.float32)
                for n, v in params.items()}
    state = TrainState(step=jnp.zeros((), jnp.int32), params=jax_params,
                       variables={"batch_stats": unflatten(stats)},
                       opt_state=type(tx.init(jax_params))(
                           jnp.asarray(3, jnp.int32), unflatten(momentum)),
                       ema_params=None)
    jax_step = jax_make_train_step(
        jax_model, None, tx, compute_dtype=jnp.float32, donate=False,
        loss_fn=jax_build_loss_fn(jax_model, jax_config))
    state, want = jax_step(state, {"image": jnp.asarray(images),
                                   "label": jnp.asarray(labels)},
                           jax.random.PRNGKey(0))

    optimizer, _ = build_optimizer(port_config, port_model, 10)
    optimizer.load_state_dict(optimizer_state_from_jax(
        3, model="kd", momentum_buf=momentum))
    before = {n: b.clone() for n, b in port_model.state_dict().items()}
    port_step = make_train_step(
        port_model, None, optimizer, compute_dtype=torch.float32,
        loss_fn=distill_cli.build_loss_fn(port_model, port_config))
    got = port_step({"image": _nchw(images),
                     "label": torch.from_numpy(labels)}, 0)
    keys = ({"stu_CELoss", "KDLoss"} if freeze
            else {"tea_CELoss", "stu_CELoss", "DMLLoss"})
    assert set(got) == keys | {"loss", "skipped"}
    assert want["skipped"] == got["skipped"].item() == 0.0
    np.testing.assert_allclose(got["loss"].item(), float(want["loss"]),
                               rtol=1e-5)
    named = dict(port_model.named_parameters())
    for name, w in kd_state_dict_from_jax(_flat(state.params), {}).items():
        old = before[name]
        if freeze and name.startswith("teacher."):
            assert torch.equal(named[name], old), name
            continue
        _close(named[name].detach().numpy() - old.numpy(),
               w.numpy() - old.numpy(), 1e-4, name)
    want_stats = kd_state_dict_from_jax(
        {}, _flat(state.variables["batch_stats"]))
    for name, b in port_model.state_dict().items():
        if freeze and name.startswith("teacher."):
            assert torch.equal(b, before[name]), name
        elif "running" in name:
            _close(b, want_stats[name].numpy(), 1e-5, name)


DISTILL_CONFIG = """
from simpleaicv_pytorch_training_examples_tpu_torch.classification.common import (
    ClassificationCollater, Opencv2PIL, TorchCenterCrop, TorchMeanStdNormalize,
    TorchRandomHorizontalFlip, TorchRandomResizedCrop, TorchResize)
from simpleaicv_pytorch_training_examples_tpu_torch.classification.datasets.ilsvrc2012dataset import (
    ILSVRC2012Dataset)
from simpleaicv_pytorch_training_examples_tpu_torch.data import Compose
from simpleaicv_pytorch_training_examples_tpu_torch.distillation import losses
from simpleaicv_pytorch_training_examples_tpu_torch.distillation.distillmodel import (
    KDModel)

normalize = TorchMeanStdNormalize(mean=[0.485, 0.456, 0.406],
                                  std=[0.229, 0.224, 0.225])


class config:
    freeze_teacher = {freeze}
    model = KDModel(teacher_type="resnet18", student_type="resnet18",
                    freeze_teacher=freeze_teacher, num_classes=10)
    loss_ratio = {{"CELoss": 1.0, "{pairwise}": 1.0}}
    train_criterion = {{"CELoss": losses.CELoss(),
                        "{pairwise}": losses.{pairwise}(1.0)}}
    train_dataset = ILSVRC2012Dataset(
        root_dir="{root}", set_name="train",
        transform=Compose([Opencv2PIL(), TorchRandomResizedCrop(resize=32),
                           TorchRandomHorizontalFlip(prob=0.5), normalize]))
    test_dataset = ILSVRC2012Dataset(
        root_dir="{root}", set_name="val",
        transform=Compose([Opencv2PIL(), TorchResize(resize=36),
                           TorchCenterCrop(resize=32), normalize]))
    train_collater = ClassificationCollater()
    test_collater = ClassificationCollater()
    seed = 0
    batch_size = 4
    num_workers = 0
    optimizer = ("SGD", {{"lr": 0.1, "momentum": 0.9,
                          "global_weight_decay": False, "weight_decay": 1e-4,
                          "no_weight_decay_layer_name_list": []}})
    scheduler = ("MultiStepLR", {{"warm_up_epochs": 0, "gamma": 0.1,
                                  "milestones": [30, 60, 90]}})
    epochs = {epochs}
    print_interval = 1
    use_amp = {use_amp}
"""


def jpeg_root(root, per_set=(("train", 8), ("val", 4))):
    """root/{train,val}/<class>/*.JPEG over two classes, copies of the
    committed fixtures."""
    fixtures = sorted(JPEG_FIXTURES.glob("*.jpg"))
    for set_name, n in per_set:
        for i in range(n):
            folder = root / set_name / f"n{i % 2:08d}"
            folder.mkdir(parents=True, exist_ok=True)
            (folder / f"{set_name}_{i:03d}.JPEG").write_bytes(
                fixtures[i % len(fixtures)].read_bytes())


def write_distill_config(work, root, epochs, freeze=True, use_amp=False):
    work.mkdir(exist_ok=True)
    (work / "train_config.py").write_text(DISTILL_CONFIG.format(
        root=root, epochs=epochs, freeze=freeze, use_amp=use_amp,
        pairwise="KDLoss" if freeze else "DMLLoss"))


def test_distill_cli_trains_resumes_exactly_and_keeps_a_frozen_teacher(
        tmp_path):
    jpeg_root(tmp_path / "data")
    whole, parts = tmp_path / "whole", tmp_path / "parts"
    write_distill_config(whole, tmp_path / "data", epochs=2)
    run = distill_cli.main(["--work-dir", str(whole)], device="cpu")
    assert [e["epoch"] for e in run["epochs"]] == [1, 2]
    for e in run["epochs"]:
        assert e["skipped"] == 0 and np.isfinite(e["loss_avg"])
        assert np.isfinite(e["stu_CELoss_avg"]) and np.isfinite(
            e["KDLoss_avg"])
        assert "tea_CELoss_avg" not in e
        assert 0.0 <= e["top1"] <= e["top5"] <= 100.0
    write_distill_config(parts, tmp_path / "data", epochs=1)
    distill_cli.main(["--work-dir", str(parts)], device="cpu")
    write_distill_config(parts, tmp_path / "data", epochs=2)
    again = distill_cli.main(["--work-dir", str(parts)], device="cpu")
    assert again["resumed_from"] == 1
    a, b = (torch.load(d / "checkpoints" / "latest.pth", weights_only=False)
            for d in (whole, parts))
    for name, tensor in a["model_state_dict"].items():
        assert torch.equal(tensor, b["model_state_dict"][name]), name
    # the frozen teacher: bit for bit its seeded init, buffers included
    seeded = init_model(KDModel("resnet18", "resnet18", num_classes=10), 0,
                        "cpu").state_dict()
    moved = {n for n, t in a["model_state_dict"].items()
             if not torch.equal(t, seeded[n])}
    assert moved and all(n.startswith("student.") for n in moved)


def test_dml_cli_moves_both_networks(tmp_path):
    jpeg_root(tmp_path / "data")
    write_distill_config(tmp_path / "run", tmp_path / "data", epochs=1,
                         freeze=False)
    run = distill_cli.main(["--work-dir", str(tmp_path / "run")],
                           device="cpu")
    e = run["epochs"][0]
    assert all(np.isfinite(e[k]) for k in ("tea_CELoss_avg",
                                           "stu_CELoss_avg", "DMLLoss_avg"))
    state = run["model"].state_dict()
    seeded = init_model(KDModel("resnet18", "resnet18", freeze_teacher=False,
                                num_classes=10), 0, "cpu").state_dict()
    for part in ("teacher.", "student."):
        for leaf in ("conv1.layer.0.weight", "conv1.layer.1.running_mean"):
            assert not torch.equal(state[part + leaf], seeded[part + leaf])


def test_distill_cli_runs_on_cuda_unless_the_cpu_is_asked_for(tmp_path,
                                                              monkeypatch):
    jpeg_root(tmp_path / "data", (("train", 4), ("val", 2)))
    write_distill_config(tmp_path / "run", tmp_path / "data", epochs=1,
                         use_amp=True)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        distill_cli.main(["--work-dir", str(tmp_path / "run")])
    run = distill_cli.main(["--work-dir", str(tmp_path / "run"), "--device",
                            "cpu"])
    assert np.isfinite(run["epochs"][0]["loss_avg"])
