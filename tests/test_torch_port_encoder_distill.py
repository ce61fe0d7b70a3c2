"""The port's SAM and SAM2 encoder distillation (models, loss, CLIs and the
13.0 / 14.0 configs) against the JAX package on the CPU.

Tiny models: a SAM ViT teacher (64^2, width 32, 2 blocks) or a SAM2 Hiera
teacher (128^2, width 56, heads of 56), and a DINOv3 student (width 32, 2 blocks; patch
16, or patch 8 for SAM2 so that its 16 x 16 map is resized to the
teacher's 8 x 8 with antialiasing), registered under one name in both
packages' backbone registries. On the same weights, fp32: the MSE loss
within 1e-5 and every student gradient 1e-4 of its largest value, the
teacher getting none; the student's RoPE rescale drawn from one key in
both packages. One train step of the port (AdamW, the CLI's frozen-teacher
rule) leaves every teacher tensor bit for bit and moves the student. The
CLIs run two epochs on the CPU and resume; the 13.0 and 14.0 configs load.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from simpleaicv_pytorch_training_examples_tpu.interactive_segmentation import (
    distill_losses as jax_losses, distill_model as jax_distill)
from simpleaicv_pytorch_training_examples_tpu.models import (
    backbones as jax_backbones)
from simpleaicv_pytorch_training_examples_tpu.models.backbones import (
    dinov3_vit as jax_dinov3)
from simpleaicv_pytorch_training_examples_tpu.utils.optimizers import (
    leaf_path_names)
from simpleaicv_pytorch_training_examples_tpu.video_interactive_segmentation import (
    distill_model as jax_video_distill)
from simpleaicv_pytorch_training_examples_tpu_torch.engine import (
    init_model, make_train_step)
from simpleaicv_pytorch_training_examples_tpu_torch.interactive_segmentation import (
    distill_losses, distill_model)
from simpleaicv_pytorch_training_examples_tpu_torch.models import backbones
from simpleaicv_pytorch_training_examples_tpu_torch.models.backbones import (
    dinov3_vit)
from simpleaicv_pytorch_training_examples_tpu_torch.tools import (
    train_interactive_segmentation_distill_encoder_model as sam_cli,
    train_video_interactive_segmentation_distill_encoder_model as sam2_cli)
from simpleaicv_pytorch_training_examples_tpu_torch.tools.train_distill_classification_model import (
    freeze_teacher_lr)
from simpleaicv_pytorch_training_examples_tpu_torch.utils import (
    build_optimizer)
from simpleaicv_pytorch_training_examples_tpu_torch.utils.jax_weights import (
    _mapped_state_dict, dinov3_vit_state_dict_from_jax,
    sam2_state_dict_from_jax, sam_state_dict_from_jax)
from simpleaicv_pytorch_training_examples_tpu_torch.video_interactive_segmentation import (
    distill_model as video_distill_model)
from torch_port_helpers import random_flat, unflatten
from torch_port_helpers import (  # noqa: F401 (autouse)
    drop_work_dir_configs, one_torch_thread)

ROPE_KEY = jax.random.PRNGKey(11)
STUDENT = "tiny_dinov3_student"
SAM_TEACHER = dict(image_size=64, patch_size=16, embedding_planes=32,
                   block_nums=2, head_nums=2, out_planes=16, window_size=2,
                   global_attn_indexes=(1,))
HIERA_TEACHER = dict(embedding_planes=56, head_nums=1,
                     block_nums=(1, 1, 2, 1),
                     window_specification=(4, 2, 4, 2),
                     global_attention_blocks=(3,), fpn_planes=16)


@pytest.fixture()
def tiny_student(monkeypatch, request):
    """A tiny DINOv3 student under one name in both registries (patch from
    the test's ``patch`` marker value, 16 by default), and the JAX RoPE
    rescale drawn from ROPE_KEY."""
    patch = getattr(request, "param", 16)
    kwargs = dict(patch_size=patch, embedding_planes=32, block_nums=2,
                  head_nums=2)
    monkeypatch.setitem(vars(jax_backbones), STUDENT, lambda **kw: (
        jax_dinov3.DinoVisionTransformer(**kwargs, **kw)))
    monkeypatch.setitem(vars(backbones), STUDENT, lambda **kw: (
        dinov3_vit.DinoVisionTransformer(**kwargs, **kw)))
    original = jax_dinov3.rope_sincos_augmented
    monkeypatch.setattr(jax_dinov3, "rope_sincos_augmented",
                        lambda h, w, hp, base, rng, **kw: original(
                            h, w, hp, base, ROPE_KEY, **kw))
    return patch


def _rope_draws():
    k_rescale = jax.random.split(ROPE_KEY, 3)[2]
    a = math.log(2.0)
    return {"rescale": np.asarray(jax.random.uniform(
        k_rescale, (1,), minval=-a, maxval=a))}


def _flat(tree):
    return dict(zip(leaf_path_names(tree),
                    (np.asarray(l) for l in jax.tree_util.tree_leaves(tree))))


def _close(got, want, scale_rtol, name=""):
    want = np.asarray(want)
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    scale = max(np.abs(want).max(), 1e-30)
    np.testing.assert_allclose(got, want, rtol=0, atol=scale_rtol * scale,
                               err_msg=name)


def _part(flat, prefix):
    return {k[len(prefix):]: v for k, v in flat.items()
            if k.startswith(prefix)}


def _port_state_dict(flat, constants, video):
    """The JAX distill model's parameters -> the port model's state_dict."""
    teacher = {"image_encoder." + k: v
               for k, v in _part(flat, "teacher.").items()}
    if video:
        teacher = sam2_state_dict_from_jax(teacher, {})
    else:
        teacher = sam_state_dict_from_jax(teacher, constants)
    sd = {"teacher." + k[len("image_encoder."):]: v
          for k, v in teacher.items()}
    sd.update({"student." + k: v for k, v in dinov3_vit_state_dict_from_jax(
        _part(flat, "student.")).items()})
    sd.update(_mapped_state_dict({k: v for k, v in flat.items()
                                  if k.startswith("student_neck")}, ()))
    return sd


def _models(video, seed=1):
    size = 128 if video else 64
    if video:
        jax_model = jax_video_distill.DINOV3ImageEncoderDistillModel(
            teacher_params=HIERA_TEACHER, student_backbone_type=STUDENT,
            out_planes=16)
        port = video_distill_model.DINOV3ImageEncoderDistillModel(
            teacher_params=dict(HIERA_TEACHER, image_size=size),
            student_backbone_type=STUDENT, out_planes=16)
    else:
        jax_model = jax_distill.DINOV3ImageEncoderDistillModel(
            teacher_params=SAM_TEACHER, student_backbone_type=STUDENT,
            out_planes=16)
        port = distill_model.DINOV3ImageEncoderDistillModel(
            teacher_params=SAM_TEACHER, student_backbone_type=STUDENT,
            out_planes=16)
    variables = jax.eval_shape(jax_model.init, jax.random.PRNGKey(0),
                               jnp.zeros((1, size, size, 3)))
    params = random_flat(variables["params"], seed)
    constants = {k: np.asarray(v) for k, v in _flat(
        {k: v for k, v in variables.items() if k != "params"}).items()}
    constants = {k.split(".", 1)[1] if k.startswith("constants.") else k: v
                 for k, v in constants.items()}
    port.load_state_dict(_port_state_dict(params, constants, video),
                         strict=True)
    return jax_model, port, params, size


@pytest.mark.parametrize("video,tiny_student", [(False, 16), (True, 8)],
                         indirect=["tiny_student"], ids=["sam", "sam2"])
def test_loss_and_student_gradients_match_jax(video, tiny_student):
    jax_model, port, params, size = _models(video)
    images = np.random.RandomState(5).uniform(
        -1, 1, (2, size, size, 3)).astype(np.float32)

    def loss_fn(p):
        tea, stu = jax_model.apply({"params": p}, jnp.asarray(images),
                                   train=True,
                                   rngs={"dropout": jax.random.PRNGKey(0)})
        return jax_losses.MSELoss()(tea, stu)["distill_mse_loss"]
    loss, grads = jax.jit(jax.value_and_grad(loss_fn))(unflatten(params))
    port.train()
    port.student.rope_draw.draw = lambda device: {
        k: torch.from_numpy(v.copy()) for k, v in _rope_draws().items()}
    tea, stu = port(torch.from_numpy(images.transpose(0, 3, 1, 2).copy()))
    grid = 8 if video else 4
    assert tea.shape == stu.shape == (2, 16, grid, grid)
    port_loss = distill_losses.MSELoss()(tea, stu)["distill_mse_loss"]
    port_loss.backward()
    np.testing.assert_allclose(port_loss.item(), float(loss), rtol=1e-5)
    want = _port_state_dict(_flat(grads), {}, video)
    for name, p in port.named_parameters():
        if name.startswith("teacher."):
            assert p.grad is None, name
            assert np.abs(want[name].numpy()).max() == 0.0, name
        else:
            _close(p.grad, want[name].numpy(), 1e-4, name)


class _Config:
    optimizer = ("AdamW", {"lr": 1e-3, "global_weight_decay": False,
                           "weight_decay": 1e-4,
                           "no_weight_decay_layer_name_list": []})
    scheduler = ("CosineLR", {"warm_up_epochs": 0, "min_lr": 1e-6})
    epochs = 1


@pytest.mark.parametrize("tiny_student", [16], indirect=True)
def test_train_step_leaves_the_teacher_as_loaded(tiny_student):
    model = init_model(distill_model.DINOV3ImageEncoderDistillModel(
        teacher_params=SAM_TEACHER, student_backbone_type=STUDENT,
        out_planes=16), 0, "cpu")
    config = freeze_teacher_lr(_Config())
    optimizer, _ = build_optimizer(config, model, 1)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    step = make_train_step(model, None, optimizer, compute_dtype=torch.float32,
                           loss_fn=sam_cli.build_loss_fn(model, type(
                               "C", (), {"train_criterion":
                                         distill_losses.MSELoss(),
                                         "use_amp": False})))
    metrics = step({"image": torch.randn(2, 3, 64, 64)}, 0)
    assert float(metrics["skipped"]) == 0.0
    after = model.state_dict()
    teacher = [k for k in before if k.startswith("teacher.")]
    assert teacher and all(torch.equal(before[k], after[k]) for k in teacher)
    assert not torch.equal(before["student.blocks.0.attn.qkv.weight"],
                           after["student.blocks.0.attn.qkv.weight"])
    assert not model.teacher.training and model.student.training


CLI_CONFIG = """
from simpleaicv_pytorch_training_examples_tpu_torch.interactive_segmentation.datasets.sam_segmentation_dataset import (
    SAMCollater)
from simpleaicv_pytorch_training_examples_tpu_torch.interactive_segmentation.datasets.syntheticdataset import (
    SyntheticSAMDataset)
from simpleaicv_pytorch_training_examples_tpu_torch.interactive_segmentation.distill_losses import (
    MSELoss)
from simpleaicv_pytorch_training_examples_tpu_torch.{package}.distill_model import (
    DINOV3ImageEncoderDistillModel)


class config:
    input_image_size = {size}
    freeze_teacher = True
    model = DINOV3ImageEncoderDistillModel(
        teacher_params={teacher}, student_backbone_type="{student}",
        out_planes=16, freeze_teacher=True)
    train_criterion = MSELoss()
    train_dataset = SyntheticSAMDataset(n=4, image_size=({size}, {size}),
                                        seed=4)
    test_dataset = None
    train_collater = SAMCollater(resize=input_image_size, n_points=1,
                                 prompt_probs=(1.0, 0.0, 0.0))
    seed = 0
    batch_size = 2
    num_workers = 0
    optimizer = ("AdamW", {{"lr": 1e-3, "global_weight_decay": False,
                           "weight_decay": 1e-4,
                           "no_weight_decay_layer_name_list": []}})
    scheduler = ("CosineLR", {{"warm_up_epochs": 0, "min_lr": 1e-6}})
    epochs = {epochs}
    print_interval = 1
    save_interval = 1
    use_amp = False
"""


@pytest.mark.parametrize("video,tiny_student", [(False, 16), (True, 16)],
                         indirect=["tiny_student"], ids=["sam", "sam2"])
def test_cli_trains_and_resumes(video, tiny_student, tmp_path):
    cli = sam2_cli if video else sam_cli
    teacher = dict(HIERA_TEACHER, image_size=128) if video else SAM_TEACHER
    size = 128 if video else 64

    def write(epochs):
        (tmp_path / "train_config.py").write_text(CLI_CONFIG.format(
            package=("video_interactive_segmentation" if video
                     else "interactive_segmentation"),
            size=size, teacher=repr(teacher), student=STUDENT,
            epochs=epochs))
    write(2)
    first = cli.main(["--work-dir", str(tmp_path)], device="cpu")
    assert first["resumed_from"] is None and len(first["epochs"]) == 2
    assert all(np.isfinite(e["loss_avg"]) and e["skipped"] == 0
               for e in first["epochs"])
    assert (tmp_path / "checkpoints" / "latest.pth").exists()
    write(3)
    import sys
    sys.modules.pop("train_config", None)
    again = cli.main(["--work-dir", str(tmp_path)], device="cpu")
    assert again["resumed_from"] == 2 and len(again["epochs"]) == 1
    log = (tmp_path / "log" / "train.log").read_text()
    assert "resumed from epoch 2" in log and "mesh: 1 devices" in log


@pytest.mark.parametrize("config_dir,jax_dir", [
    ("interactive_segmentation/sam_h_encoder_distill_dinov3_vit_base_patch16_encoder",
     "13.interactive_segmentation_training/13.0.encoder_distill_training/"
     "sam_h_encoder_distill_dinov3_vit_base_patch16_encoder"),
    ("video_interactive_segmentation/hiera_l_encoder_distill_dinov3_vit_base_patch16_encoder",
     "14.video_interactive_segmentation_training/14.0.encoder_distill_training/"
     "hiera_l_encoder_distill_dinov3_vit_base_patch16_encoder")])
def test_distill_configs_match_their_jax_configs(config_dir, jax_dir,
                                                 tmp_path, monkeypatch):
    """The run settings, the teacher and student and the data pipeline
    equal the JAX config's; the model is built on the meta device."""
    from pathlib import Path
    import sys

    from simpleaicv_pytorch_training_examples_tpu.utils import (
        load_config_from_work_dir as jax_load_config)
    from simpleaicv_pytorch_training_examples_tpu_torch.utils import (
        load_config_from_work_dir)
    from test_torch_port_configs import RUN_KEYS, _object, _plain

    def summary(config):
        out = {k: _plain(getattr(config, k)) for k in RUN_KEYS + (
            "teacher_params", "freeze_teacher", "save_interval",
            "optimizer", "scheduler", "test_dataset")
            if hasattr(config, k)}
        for key in ("train_dataset", "train_collater", "train_criterion"):
            out[key] = _object(getattr(config, key))
        return out

    monkeypatch.setenv("SIMPLEAICV_DATA_ROOT", str(tmp_path / "no_data"))
    sys.modules.pop("tools.path", None)
    repo = Path(__file__).resolve().parents[1]
    jax_config = jax_load_config(str(repo / jax_dir), "train_config")
    with torch.device("meta"):
        config = load_config_from_work_dir(str(
            repo / "simpleaicv_pytorch_training_examples_tpu_torch" /
            "experiments" / config_dir), "train_config")
    sys.modules.pop("tools.path", None)
    assert summary(config) == summary(jax_config)
    model, jax_model = config.model, jax_config.model
    assert type(model).__name__ == type(jax_model).__name__
    assert (model.student.embedding_planes, len(model.student.blocks)) == \
        (768, 12)
    assert jax_model.student_backbone_type == \
        "dinov3_vit_base_patch16_backbone"
    assert model.dtype == torch.float32 and model.freeze_teacher
