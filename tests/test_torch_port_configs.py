"""Every experiment config of the port against its JAX config.

Each port config (``experiments/``, train and test) is loaded next to the
JAX experiment's train config (the JAX test configs re-export it) on a data
root that holds nothing, and the two are held equal: the network and its
settings, the optimizer (name rules compared after mapping the JAX names
onto the port's: ``block_`` -> ``blocks.``, ``position_encoding`` ->
``pos_embed``), the scheduler, the batch size, the epochs and the other
run settings, the losses, and the transforms' and collaters' classes and
arguments. The one planned difference: every port config computes in bf16
over fp32 parameters, where the JAX ResNet, MAE and distillation configs
leave their models in fp32 and round only the input to bf16; the test holds
the port's dtype to bf16 there. The port's models are built on the meta
device (no memory, no init), the JAX models are Flax definitions.
"""

import dataclasses
import os
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from simpleaicv_pytorch_training_examples_tpu.utils import (
    load_config_from_work_dir as jax_load_config)
from simpleaicv_pytorch_training_examples_tpu_torch.utils import (
    load_config_from_work_dir)
from torch_port_helpers import (  # noqa: F401 (autouse)
    drop_work_dir_configs, one_torch_thread)

REPO = Path(__file__).resolve().parents[1]
PORT = REPO / "simpleaicv_pytorch_training_examples_tpu_torch" / "experiments"
RESNET_CONFIGS = [
    *(f"imagenet/resnet{n}" for n in (18, 34, 50, 101, 152)),
    *(f"imagenet/resnet{n}_vit_aug_imagenet21k_pretrain"
      for n in (50, 101, 152)),
    *(f"cifar100/resnet{n}cifar" for n in (18, 34, 50, 101, 152)),
    *(f"imagenet21k/resnet{n}_semantic_softmax_1k_pretrain"
      for n in (50, 101, 152)),
]
VIT_CONFIGS = [f"imagenet/{net}_for_{kind}_mae_pretrain"
               for net in ("vit_base_patch16", "vit_large_patch16",
                           "vit_huge_patch14")
               for kind in ("official", "self_train")]
CASES = (
    [(f"{c}/{f}", f"00.classification_training/{c}")
     for c in RESNET_CONFIGS + VIT_CONFIGS
     for f in ("train_config.py", "test_config.py")]
    + [(f"masked_image_modeling/imagenet/{c}/train_config.py",
        f"02.masked_image_modeling_training/imagenet/{c}")
       for c in ("vit_b_16_224_mae_pretrain", "mae_vit_large_patch16_224",
                 "mae_vit_huge_patch14_224")]
    + [(f"distillation/imagenet/{c}/train_config.py",
        f"01.distillation_training/imagenet/{c}")
       for c in ("resnet_152_kd_50", "resnet_152_kd_50_vit_aug",
                 "resnet_152_dml_50", "resnet_152_dml_50_vit_aug")])
# the JAX package's parameter names -> the port's, in the optimizer rules
NAME_MAP = {"block_": "blocks.", "position_encoding": "pos_embed",
            "patch_embedding": "patch_embed"}
RUN_KEYS = ("network", "num_classes", "input_image_size", "scale", "seed",
            "batch_size", "num_workers", "accumulation_steps", "epochs",
            "print_interval", "use_amp", "use_ema_model", "ema_model_decay",
            "clip_max_norm", "freeze_teacher", "teacher", "student",
            "loss_list", "loss_ratio", "T", "trained_model_path")

TEST_KEYS = ("network", "num_classes", "input_image_size", "scale", "seed",
             "batch_size", "use_amp", "test_dataset", "test_collater")


def _plain(value):
    """Numbers, strings and containers as comparable Python values."""
    if isinstance(value, np.ndarray):
        return [_plain(v) for v in value.tolist()]
    if isinstance(value, (list, tuple)):
        return [_plain(v) for v in value]
    if isinstance(value, dict):
        return {k: _plain(v) for k, v in value.items()}
    if isinstance(value, (np.floating, float)):
        return float(value)
    if isinstance(value, (np.integer, int)) and not isinstance(value, bool):
        return int(value)
    return value


def _object(obj):
    """An object as (class name, its public attributes)."""
    if obj is None:
        return None
    return (type(obj).__name__, {k: _plain(v) for k, v in vars(obj).items()
                                 if not k.startswith("_")})


def _map_names(value):
    if isinstance(value, str):
        for old, new in NAME_MAP.items():
            value = value.replace(old, new)
        return value
    if isinstance(value, list):
        return [_map_names(v) for v in value]
    return value


def _transforms(dataset):
    if dataset is None:
        return None
    return [_object(t) for t in dataset.transform.transforms]


def _criterion(criterion):
    if isinstance(criterion, dict):
        return {k: _object(v) for k, v in criterion.items()}
    return _object(criterion)


def _jax_model(model):
    fields = {f.name: getattr(model, f.name) for f in dataclasses.fields(model)
              if f.name not in ("parent", "name", "dtype", "softmax_dtype")}
    if "block_cls" in fields:
        fields["block_cls"] = fields["block_cls"].__name__
        fields["layer_nums"] = list(fields["layer_nums"])
    for key in ("teacher_pretrained_path", "student_pretrained_path",
                "use_fused_norm", "use_fused_block", "dropout_prob",
                "encoder_dropout_prob", "decoder_dropout_prob",
                "feedforward_ratio", "encoder_feedforward_ratio",
                "decoder_feedforward_ratio", "stage_strides"):
        fields.pop(key, None)
    return {k: _plain(v) for k, v in fields.items()}


def _port_model(model):
    """The port model's settings under the JAX module's field names, and
    its compute dtype."""
    kind = type(model).__name__
    if kind == "ViT":
        block = model.blocks[0]
        n = model.pos_embed.shape[1] - 1
        patch = model.patch_embed.patch_size
        return {"patch_size": patch,
                "embedding_planes": model.pos_embed.shape[-1],
                "block_nums": len(model.blocks),
                "head_nums": block.attn.head_nums,
                "image_size": int(round(n ** 0.5)) * patch,
                "drop_path_prob": model.blocks[-1].drop_path.drop_path_prob,
                "global_pool": model.global_pool,
                "num_classes": model.fc.out_features,
                "use_gradient_checkpoint": model.use_gradient_checkpoint,
                "use_fused_attention": block.attn.use_fused_attention,
                }, block.attn.compute_dtype
    if kind in ("ResNet", "ResNetCifar"):
        settings = {"block_cls": type(model.layer1[0]).__name__,
                    "layer_nums": [len(getattr(model, f"layer{i}"))
                                   for i in range(1, 5)],
                    "inplanes": model.conv1.layer[0].out_channels,
                    "num_classes": model.fc.out_features}
        if kind == "ResNet":
            settings["use_gradient_checkpoint"] = \
                model.use_gradient_checkpoint
        return settings, model.conv1.layer[0].compute_dtype
    if kind == "VITMAEPretrainModel":
        enc, dec = model.encoder, model.decoder
        patch = enc.patch_embed.patch_size
        return {"patch_size": patch,
                "image_size": int(round((dec.pos_embed.shape[1] - 1) ** 0.5))
                * patch,
                "mask_ratio": enc.mask_ratio,
                "encoder_embedding_planes": enc.cls_token.shape[-1],
                "encoder_block_nums": len(enc.blocks),
                "encoder_head_nums": enc.blocks[0].attn.head_nums,
                "decoder_embedding_planes": dec.mask_token.shape[-1],
                "decoder_block_nums": len(dec.blocks),
                "decoder_head_nums": dec.blocks[0].attn.head_nums,
                "use_gradient_checkpoint": enc.use_gradient_checkpoint,
                "use_fused_attention": enc.blocks[0].attn.use_fused_attention,
                }, enc.blocks[0].attn.compute_dtype
    assert kind == "KDModel", kind
    student, dtype = _port_model(model.student)
    return {"teacher_type": model.teacher_type,
            "student_type": model.student_type,
            "freeze_teacher": model.freeze_teacher,
            "num_classes": student["num_classes"],
            "use_gradient_checkpoint": False}, dtype


def _summary(config):
    out = {k: _plain(getattr(config, k)) for k in RUN_KEYS
           if hasattr(config, k)}
    if "trained_model_path" in out:   # the two packages' data roots differ
        out["trained_model_path"] = os.path.basename(
            out["trained_model_path"])
    for key in ("optimizer", "scheduler"):
        if hasattr(config, key):
            name, params = config.__dict__[key] if key in config.__dict__ \
                else getattr(config, key)
            out[key] = (name, {k: _plain(_map_names(v))
                               for k, v in params.items()})
    for key in ("train_dataset", "test_dataset"):
        if hasattr(config, key):
            out[key] = (type(getattr(config, key)).__name__,
                        _transforms(getattr(config, key)))
    for key in ("train_collater", "test_collater"):
        if hasattr(config, key):
            out[key] = _object(getattr(config, key))
    for key in ("train_criterion", "test_criterion"):
        if hasattr(config, key):
            out[key] = _criterion(getattr(config, key))
    return out


@pytest.fixture()
def empty_data_root(tmp_path, monkeypatch):
    monkeypatch.setenv("SIMPLEAICV_DATA_ROOT", str(tmp_path / "no_data"))
    monkeypatch.setenv("SIMPLEAICV_PRETRAINED_ROOT",
                       str(tmp_path / "no_data" / "pretrained_models"))
    sys.modules.pop("tools.path", None)   # it reads the root on import
    yield
    sys.modules.pop("tools.path", None)


@pytest.mark.parametrize("port_config,jax_dir", CASES,
                         ids=[c for c, _ in CASES])
def test_port_config_matches_its_jax_config(port_config, jax_dir,
                                            empty_data_root):
    port_path = PORT / port_config
    jax_config = jax_load_config(str(REPO / jax_dir), "train_config")
    want = _summary(jax_config)
    want_model = _jax_model(jax_config.model)
    sys.modules.pop(port_path.stem, None)
    with torch.device("meta"):
        config = load_config_from_work_dir(str(port_path.parent),
                                           port_path.stem)
    got = _summary(config)
    got_model, dtype = _port_model(config.model)
    assert dtype == torch.bfloat16
    assert got_model == want_model
    if port_path.stem == "test_config":
        # a test config holds the model and its eval side; it names the
        # checkpoint to evaluate and the loader's workers for itself
        keys = set(TEST_KEYS) & set(got)
        assert {"network", "batch_size", "test_dataset",
                "test_collater"} <= keys
        got, want = ({k: d[k] for k in keys} for d in (got, want))
    assert got == want


def test_a_work_dir_loaded_again_gives_its_own_config(tmp_path):
    """A work dir loaded again after another one gives its own
    ``train_config``, though the other dir went on the path after it."""
    for name in ("a", "b"):
        (tmp_path / name).mkdir()
        (tmp_path / name / "train_config.py").write_text(
            f"class config:\n    name = {name!r}\n")
    names = [load_config_from_work_dir(str(tmp_path / n)).name
             for n in ("a", "b", "a")]
    assert names == ["a", "b", "a"]
