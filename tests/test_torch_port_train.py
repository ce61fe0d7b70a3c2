"""The port's training path against the JAX package, on the CPU.

The same inputs, made from a seed with numpy, go through the JAX function
and its counterpart in the port: losses, transforms, the Mixup/CutMix
collater, schedules, the per-parameter optimizer rules, the AdamW and SGD
updates, and the slice as a whole (three steps of ``make_train_step`` with
``build_optimizer``, accumulation, EMA and the non-finite skip). Then the
work-dir train CLI on the CPU: two epochs, resume, and a golden overfit.

Tolerances. Losses, schedules: 1e-6 (fp32 against fp64 arithmetic). Three
optimizer updates from equal gradients: 5e-6 absolute at lr 1e-2 (a few
fp32 ulps of an update that reaches 0.3 where the carried-in second moment
is small). The whole train step in fp32: loss per step 1e-5; parameters and
EMA after three AdamW steps 1e-3 of the lr (measured: 1.2e-7), with one
exception. The key third of every ``attn.qkv.bias`` has a gradient of
exactly zero in exact arithmetic (a constant added to all keys' scores
leaves the softmax unchanged), so what each side computes there is rounding
noise, and Adam, which divides a gradient by its own magnitude, turns that
noise into steps of up to the lr with either sign: those entries are held
to the sum of the three steps' lrs, which is all that can be said of them.
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from simpleaicv_pytorch_training_examples_tpu.classification import (
    common as jax_common, losses as jax_losses)
from simpleaicv_pytorch_training_examples_tpu.classification.mixupcutmixclassificationcollator import (
    MixupCutmixClassificationCollater as JaxMixupCollater)
from simpleaicv_pytorch_training_examples_tpu.engine import (
    TrainState, make_train_step as jax_make_train_step)
from simpleaicv_pytorch_training_examples_tpu.models.backbones import vit as jax_vit
from simpleaicv_pytorch_training_examples_tpu.utils import (
    optimizers as jax_optimizers, schedules as jax_schedules)
from simpleaicv_pytorch_training_examples_tpu.utils.ema import (
    ema_init as jax_ema_init)
from simpleaicv_pytorch_training_examples_tpu.utils.optimizers import (
    leaf_path_names)
from simpleaicv_pytorch_training_examples_tpu_torch.classification import (
    common as port_common, losses as port_losses)
from simpleaicv_pytorch_training_examples_tpu_torch.classification.datasets.syntheticdataset import (
    SyntheticClassificationDataset)
from simpleaicv_pytorch_training_examples_tpu_torch.classification.mixupcutmixclassificationcollator import (
    MixupCutmixClassificationCollater)
from simpleaicv_pytorch_training_examples_tpu_torch.data import TrainLoader
from simpleaicv_pytorch_training_examples_tpu_torch.engine import (
    make_train_step)
from simpleaicv_pytorch_training_examples_tpu_torch.engine.engine import (
    mask_seed)
from simpleaicv_pytorch_training_examples_tpu_torch.models import common as port_layers
from simpleaicv_pytorch_training_examples_tpu_torch.models.backbones import vit
from simpleaicv_pytorch_training_examples_tpu_torch.tools import (
    test_classification_model as eval_cli,
    train_classification_model as train_cli)
from simpleaicv_pytorch_training_examples_tpu_torch.utils import (
    build_optimizer, schedules as port_schedules)
from simpleaicv_pytorch_training_examples_tpu_torch.utils.ema import (
    ema_init, ema_update)
from simpleaicv_pytorch_training_examples_tpu_torch.utils.jax_weights import (
    _torch_name, optimizer_state_from_jax, vit_state_dict_from_jax)
from simpleaicv_pytorch_training_examples_tpu_torch.utils.optimizers import (
    compute_wd_and_lr)
from torch_port_helpers import random_flat, unflatten
from torch_port_helpers import (  # noqa: F401 (autouse)
    drop_work_dir_configs, one_torch_thread)

VIT_KWARGS = dict(image_size=64, num_classes=10, global_pool=True,
                  use_fused_attention=True)
LR = 1e-3


class JaxConfig:
    optimizer = ("AdamW", {
        "lr": LR, "global_weight_decay": False, "weight_decay": 5e-2,
        "lr_layer_decay": 0.65, "lr_layer_decay_block": 2,
        "block_name": "block_",
        "no_weight_decay_layer_name_list": ["position_encoding", "cls_token"],
    })
    scheduler = ("CosineLR", {"warm_up_epochs": 1, "min_lr": 1e-6})
    epochs = 3


class PortConfig(JaxConfig):
    optimizer = ("AdamW", dict(
        JaxConfig.optimizer[1], block_name="blocks.",
        no_weight_decay_layer_name_list=["pos_embed", "cls_token"]))


def _models(heads=2, seed=11):
    """A JAX ViT and its port twin (2 blocks, width 128) on equal weights;
    2 heads take the K1 route, 4 heads the K2 route."""
    jax_model = jax_vit.ViT(16, 128, 2, heads, 4, **VIT_KWARGS)
    port_model = vit.ViT(16, 128, 2, heads, 4, **VIT_KWARGS)
    shapes = jax.eval_shape(jax_model.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 64, 64, 3)))["params"]
    flat = random_flat(shapes, seed)
    port_model.load_state_dict(vit_state_dict_from_jax(flat))
    return jax_model, port_model, flat


def _flat(tree):
    return dict(zip(leaf_path_names(tree),
                    (np.asarray(l) for l in jax.tree_util.tree_leaves(tree))))


def _assert_tree_close(jax_tree, port_by_name, atol, key_bias_atol=None):
    """Every JAX leaf against the port's tensor of the mapped name; with
    ``key_bias_atol`` the key third of each qkv bias (zero gradient in
    exact arithmetic) is held to that instead."""
    want = vit_state_dict_from_jax(_flat(jax_tree))
    assert set(want) == set(port_by_name)
    for name, w in want.items():
        got = port_by_name[name].detach().numpy()
        w = w.numpy()
        if key_bias_atol is not None and name.endswith("attn.qkv.bias"):
            third = w.shape[0] // 3
            keys = slice(third, 2 * third)
            np.testing.assert_allclose(got[keys], w[keys], rtol=0,
                                       atol=key_bias_atol, err_msg=name)
            got, w = np.delete(got, keys), np.delete(w, keys)
        np.testing.assert_allclose(got, w, rtol=0, atol=atol, err_msg=name)


def _batches(n_batches, batch_size, seed, soft=True):
    rs = np.random.RandomState(seed)
    out = []
    for _ in range(n_batches):
        images = rs.standard_normal((batch_size, 64, 64, 3)).astype(np.float32)
        labels = rs.randint(0, 10, batch_size)
        soft_labels = (0.9 * np.eye(10, dtype=np.float32)[labels] + 0.01)
        out.append((images, soft_labels if soft else labels))
    return out


def _jax_batch(images, labels):
    return {"image": jnp.asarray(images), "label": jnp.asarray(labels)}


def _port_batch(images, labels):
    return {"image": torch.from_numpy(images.transpose(0, 3, 1, 2).copy()),
            "label": torch.from_numpy(np.asarray(labels))}


# ---------------------------------------------------------------- losses


@pytest.mark.parametrize("name,soft", [("CELoss", False),
                                       ("LabelSmoothCELoss", False),
                                       ("FocalCELoss", False),
                                       ("OneHotLabelCELoss", True)])
def test_losses_match_jax(name, soft):
    rs = np.random.RandomState(1)
    logits = (3.0 * rs.standard_normal((6, 10))).astype(np.float32)
    labels = rs.randint(0, 10, 6)
    if soft:
        labels = rs.dirichlet(np.ones(10), 6).astype(np.float32)
    want = getattr(jax_losses, name)()(jnp.asarray(logits),
                                       jnp.asarray(labels))
    got = getattr(port_losses, name)()(torch.from_numpy(logits),
                                       torch.from_numpy(labels))
    assert got.dtype == torch.float32 and got.dim() == 0
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6, atol=1e-6)
    half = getattr(port_losses, name)()(torch.from_numpy(logits).bfloat16(),
                                        torch.from_numpy(labels))
    assert half.dtype == torch.float32


# ------------------------------------------------- transforms and collater


@pytest.mark.parametrize("name,kwargs", [
    ("TorchRandomHorizontalFlip", dict(prob=0.5)),
    ("RandomErasing", dict(prob=0.9)),
    ("TorchRandomResizedCrop", dict(resize=24)),
])
def test_train_transforms_match_jax_under_one_numpy_seed(name, kwargs):
    image = np.random.RandomState(2).standard_normal((32, 40, 3)).astype(
        np.float32)
    for seed in range(4):
        np.random.seed(seed)
        want = getattr(jax_common, name)(**kwargs)(
            {"image": image.copy(), "label": 1})["image"]
        np.random.seed(seed)
        got = getattr(port_common, name)(**kwargs)(
            {"image": image.copy(), "label": 1})["image"]
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("seed", [0, 1, 2, 3, 4])
def test_mixup_cutmix_collater_matches_jax(seed):
    """Seeds 0-4 draw both Mixup and CutMix batches; images transposed,
    labels equal."""
    rs = np.random.RandomState(seed)
    samples = [{"image": rs.standard_normal((16, 20, 3)).astype(np.float32),
                "label": int(rs.randint(0, 7))} for _ in range(6)]
    copy = lambda: [{"image": s["image"].copy(), "label": s["label"]}
                    for s in samples]
    np.random.seed(seed)
    want = JaxMixupCollater(num_classes=7)(copy())
    np.random.seed(seed)
    got = MixupCutmixClassificationCollater(num_classes=7)(copy())
    assert got["image"].shape == (6, 3, 16, 20)
    assert got["image"].dtype == got["label"].dtype == torch.float32
    np.testing.assert_allclose(got["image"].permute(0, 2, 3, 1).numpy(),
                               want["image"], rtol=0, atol=1e-6)
    # the JAX collater's labels turn float64 when CutMix corrects lambda;
    # its train step rounds them to float32, as the port's collater does
    np.testing.assert_array_equal(got["label"].numpy(),
                                  want["label"].astype(np.float32))
    np.testing.assert_allclose(got["label"].sum(dim=1).numpy(), 1.0,
                               atol=1e-5)


def test_train_loader_order_follows_seed_and_epoch():
    dataset = SyntheticClassificationDataset(n=21, image_size=8,
                                             num_classes=50, seed=4)

    def labels(seed, epoch):
        loader = TrainLoader(dataset, 4, port_common.ClassificationCollater(),
                             "cpu", seed=seed)
        loader.set_epoch(epoch)
        assert len(loader) == 5                      # the short batch dropped
        return torch.cat([b["label"] for b in loader]).tolist()
    first = labels(0, 1)
    assert len(first) == 20
    assert labels(0, 1) == first
    assert labels(0, 2) != first and labels(1, 1) != first
    np.random.seed(123)          # the epoch start reseeds the global numpy
    labels(0, 1)
    drawn = np.random.rand()
    labels(0, 1)
    assert np.random.rand() == drawn


# ------------------------------------------------------------- schedules


@pytest.mark.parametrize("name,params", [
    ("MultiStepLR", {"warm_up_epochs": 1, "gamma": 0.1, "milestones": [2, 4]}),
    ("CosineLR", {"warm_up_epochs": 1, "min_lr": 1e-6}),
    ("PolyLR", {"warm_up_epochs": 2, "power": 2.0, "min_lr": 1e-5}),
    ("CosineLR", {"warm_up_epochs": 0, "min_lr": 0.0}),
])
def test_schedules_match_jax_over_20_steps(name, params):
    epochs, steps_per_epoch, lr = 5, 4, 4e-3
    want = jax_schedules.build_schedule(name, params, epochs, steps_per_epoch,
                                        lr)
    got = port_schedules.build_schedule(name, params, epochs, steps_per_epoch,
                                        lr)
    for step in range(20):
        assert isinstance(got(step), float)
        np.testing.assert_allclose(got(step), float(want(step)), rtol=1e-6,
                                   atol=1e-6, err_msg=f"step {step}")
        np.testing.assert_allclose(
            port_schedules.schedule_value(name, params, epochs, lr,
                                          step / steps_per_epoch),
            jax_schedules.schedule_value(name, params, epochs, lr,
                                         step / steps_per_epoch), rtol=1e-12)


# ------------------------------------------------------- optimizer rules


@pytest.mark.parametrize("extra", [
    {},
    {"global_weight_decay": True},
    {"sub_layer_weight_decay": {"fc": 0.3}, "sub_layer_lr": {"fc": 0.5}},
])
def test_per_parameter_rules_match_jax_through_the_name_map(extra):
    _, port_model, flat = _models()
    jax_params = dict(JaxConfig.optimizer[1], **extra)
    port_params = dict(PortConfig.optimizer[1], **extra)
    names, wds, lrs, scales = jax_optimizers._compute_wd_and_lr(
        unflatten(flat), jax_params)
    want = {_torch_name(n): rule for n, *rule in zip(names, wds, lrs, scales)}
    names, wds, lrs, scales = compute_wd_and_lr(
        list(port_model.named_parameters()), port_params)
    got = {n: rule for n, *rule in zip(names, wds, lrs, scales)}
    assert got == want
    assert len({tuple(r) for r in got.values()}) >= 4
    # the stem decays deepest, the head not at all
    assert got["pos_embed"][2] == 0.65 ** 3 and got["fc.weight"][2] == 1.0
    assert got["blocks.1.mlp.fc1.weight"][2] == 0.65


def test_group_report_counts_every_parameter():
    _, port_model, _ = _models()
    _, report = build_optimizer(PortConfig, port_model, 2)
    assert sum(len(g["name"]) for g in report) == len(
        list(port_model.parameters()))
    assert {g["weight_decay"] for g in report} == {0.0, 5e-2}


def _random_like(flat, seed, scale=1.0):
    rs = np.random.RandomState(seed)
    return {n: (scale * rs.standard_normal(v.shape)).astype(np.float32)
            for n, v in flat.items()}


@pytest.mark.parametrize("name,params", [
    ("AdamW", {"lr": 1e-2, "weight_decay": 5e-2, "global_weight_decay": False,
               "lr_layer_decay": 0.65, "lr_layer_decay_block": 2}),
    ("SGD", {"lr": 1e-2, "momentum": 0.9, "weight_decay": 1e-3}),
    ("SGD", {"lr": 1e-2, "momentum": 0.9, "weight_decay": 1e-3,
             "nesterov": True}),
])
def test_optimizer_updates_match_jax_from_equal_gradients(name, params):
    """Three updates from the same gradients, the first from a mid-run
    state carried across by ``optimizer_state_from_jax``."""
    _, port_model, flat = _models()

    class jax_config(JaxConfig):
        optimizer = (name, dict(params, block_name="block_"))

    class port_config(JaxConfig):
        optimizer = (name, dict(params, block_name="blocks."))
    jax_params = unflatten(flat)
    tx, _ = jax_optimizers.build_optimizer(jax_config, jax_params, 2)
    state = tx.init(jax_params)
    moments = {"mu": _random_like(flat, 1, 0.1),
               "nu": {n: v ** 2 for n, v in _random_like(flat, 2, 0.1).items()}
               } if name == "AdamW" else {
                   "momentum_buf": _random_like(flat, 1, 0.1)}
    state = type(state)(jnp.asarray(3, jnp.int32),
                        *(unflatten(m) for m in moments.values()))
    optimizer, _ = build_optimizer(port_config, port_model, 2)
    optimizer.load_state_dict(optimizer_state_from_jax(3, **moments))
    named = dict(port_model.named_parameters())
    for i in range(3):
        grads = _random_like(flat, 10 + i)
        updates, state = tx.update(unflatten(grads), state, jax_params)
        jax_params = jax.tree.map(jnp.add, jax_params, updates)
        port_grads = vit_state_dict_from_jax(grads)
        optimizer.update([port_grads[n] for n in optimizer.names],
                         torch.tensor(True))
    assert int(optimizer.step) == int(state.step) == 6
    _assert_tree_close(jax_params, named, atol=5e-6)
    for slot, tree in zip(moments, state[1:]):
        _assert_tree_close(tree, optimizer.state_dict()[slot], atol=1e-6)


@pytest.mark.parametrize("name,params", [
    ("AdamW", {"lr": 1e-2, "weight_decay": 5e-2}),
    ("SGD", {"lr": 1e-2, "momentum": 0.9, "weight_decay": 1e-3}),
])
def test_an_update_gated_off_changes_nothing_bit_for_bit(name, params):
    _, port_model, flat = _models()

    class config(JaxConfig):
        optimizer = (name, params)
    optimizer, _ = build_optimizer(config, port_model, 2)
    by_name = vit_state_dict_from_jax(_random_like(flat, 3))
    grads = [by_name[n] for n in optimizer.names]
    optimizer.update(grads, torch.tensor(True))
    optimizer.update(grads, torch.tensor(True))
    before = ([p.detach().clone() for p in optimizer.params],
              optimizer.state_dict())
    bad = [g.clone() for g in grads]
    bad[0][0] = float("nan")
    bad[1][0] = float("inf")
    optimizer.update(bad, torch.tensor(False))
    after = optimizer.state_dict()
    assert int(after["step"]) == int(before[1]["step"]) == 2
    for p, old in zip(optimizer.params, before[0]):
        assert torch.equal(p, old)
    for slot in optimizer.moments:
        for n in optimizer.names:
            assert torch.equal(after[slot][n], before[1][slot][n])


def test_ema_update_matches_the_formula():
    params = [torch.tensor([1.0, 2.0]), torch.tensor([[3.0]])]
    ema = ema_init(params)
    params[0] += 1.0
    ema_update(ema, params, 0.9)
    torch.testing.assert_close(ema[0], torch.tensor([1.1, 2.1]))
    torch.testing.assert_close(ema[1], torch.tensor([[3.0]]))


# ------------------------------------------------- dropout and drop path


def test_masks_come_from_the_attached_generator_only():
    layers = torch.nn.Sequential(port_layers.DropPath(0.5),
                                 port_layers.Dropout(0.5)).train()
    path, drop = layers
    x = torch.ones(64, 3, 2)
    generator = torch.Generator()
    port_layers.attach_mask_generator(layers, generator)

    def draw(seed):
        generator.manual_seed(seed)
        return path(x), drop(x)
    torch.manual_seed(0)
    state = torch.get_rng_state()
    a, b, c = draw(mask_seed(0, 5, 1)), draw(mask_seed(0, 5, 1)), \
        draw(mask_seed(0, 6, 1))
    assert torch.equal(torch.get_rng_state(), state)   # global RNG untouched
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    assert not torch.equal(a[0], c[0]) and not torch.equal(a[1], c[1])
    # per-sample masks, scaled by 1 / keep
    assert set(a[0].unique().tolist()) == {0.0, 2.0}
    assert (a[0].flatten(1).std(dim=1) == 0).all()
    assert len({mask_seed(0, 5, 1), mask_seed(0, 5, 2), mask_seed(1, 5, 1),
                mask_seed(0, 6, 1)}) == 4
    assert path.eval()(x) is x and drop.eval()(x) is x
    # another model's layers keep drawing from torch's default generator
    assert port_layers.DropPath(0.5).mask_generator is None


def test_fused_norm_blocks_equal_plain_norm_blocks():
    torch.manual_seed(0)
    plain = vit.ViT(16, 64, 2, 1, image_size=32, num_classes=5,
                    dtype=torch.bfloat16, use_fused_attention=True)
    fused = vit.ViT(16, 64, 2, 1, image_size=32, num_classes=5,
                    dtype=torch.bfloat16, use_fused_attention=True,
                    use_fused_norm=True)
    fused.load_state_dict(plain.state_dict())
    assert fused.blocks[0].norm1.use_fused and not fused.norm.use_fused
    x = torch.randn(3, 3, 32, 32)
    outs = []
    for model in (plain, fused):
        model.zero_grad()
        out = model(x)
        out.square().sum().backward()
        outs.append((out, model.blocks[0].norm1.weight.grad.clone(),
                     model.patch_embed.proj.weight.grad.clone()))
    for a, b in zip(*outs):
        torch.testing.assert_close(a, b, rtol=2e-2, atol=2e-3)


# ----------------------------------------------- the slice as a whole


def _train_steps(heads, batches, nan_at=None):
    """Run the batches through both train steps (AdamW, layer decay, cosine
    warm-up, accumulation 2, EMA, fp32, no drop); returns both end states
    and the per-step metrics."""
    jax_model, port_model, flat = _models(heads)
    params = unflatten(flat)
    tx, _ = jax_optimizers.build_optimizer(JaxConfig, params, 2)
    state = TrainState(step=jnp.zeros((), jnp.int32), params=params,
                       variables={}, opt_state=tx.init(params),
                       ema_params=jax_ema_init(params))
    jax_step = jax_make_train_step(
        jax_model, jax_losses.OneHotLabelCELoss(), tx, accumulation_steps=2,
        use_ema_model=True, ema_model_decay=0.9, clip_max_norm=5.0,
        compute_dtype=jnp.float32, donate=False)
    optimizer, _ = build_optimizer(PortConfig, port_model, 2)
    ema = ema_init(port_model.parameters())
    port_step = make_train_step(
        port_model, port_losses.OneHotLabelCELoss(), optimizer,
        accumulation_steps=2, use_ema_model=True, ema_model_decay=0.9,
        ema_params=ema, clip_max_norm=5.0, compute_dtype=torch.float32)
    metrics = []
    for i, (images, labels) in enumerate(batches):
        if i == nan_at:
            images = images.copy()
            images[1, 3, 4, 0] = np.nan
        state, want = jax_step(state, _jax_batch(images, labels),
                               jax.random.PRNGKey(i))
        got = port_step(_port_batch(images, labels), i)
        metrics.append(({k: float(v) for k, v in want.items()},
                        {k: v.item() for k, v in got.items()}))
    names = [n for n, _ in port_model.named_parameters()]
    return state, port_model, optimizer, dict(zip(names, ema)), metrics


@pytest.mark.parametrize("heads", [2, 4])
def test_three_train_steps_match_jax(heads):
    state, port_model, optimizer, ema, metrics = _train_steps(
        heads, _batches(3, 8, seed=21))
    for want, got in metrics:
        assert want["skipped"] == got["skipped"] == 0.0
        np.testing.assert_allclose(got["loss"], want["loss"], rtol=0,
                                   atol=1e-5)
    assert metrics[0][1]["loss"] != metrics[2][1]["loss"]
    assert int(optimizer.step) == int(state.opt_state.step) == 3
    _assert_tree_close(state.params, dict(port_model.named_parameters()),
                       atol=1e-3 * LR, key_bias_atol=1.5 * LR)
    _assert_tree_close(state.ema_params, ema, atol=1e-3 * LR,
                       key_bias_atol=1.5 * LR)
    _assert_tree_close(state.opt_state.mu, optimizer.state_dict()["mu"],
                       atol=1e-5)


def test_a_nan_batch_is_skipped_alike_on_both_sides():
    batches = _batches(3, 8, seed=22)
    clean = _train_steps(2, batches[:2])
    state, port_model, optimizer, ema, metrics = _train_steps(
        2, batches, nan_at=2)
    want, got = metrics[2]
    assert want == got == {"loss": 0.0, "skipped": 1.0}
    assert int(optimizer.step) == int(state.opt_state.step) == 2
    # parameters and optimizer state are those of the two clean steps
    for (n, p), (_, q) in zip(port_model.named_parameters(),
                              clean[1].named_parameters()):
        assert torch.equal(p, q), n
    for slot in ("mu", "nu"):
        for n, t in optimizer.state_dict()[slot].items():
            assert torch.equal(t, clean[2].state_dict()[slot][n]), (slot, n)
    for a, b in zip(jax.tree_util.tree_leaves(state.params),
                    jax.tree_util.tree_leaves(clean[0].params)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    # the EMA still averages in the unchanged parameters, on both sides
    _assert_tree_close(state.ema_params, ema, atol=1e-3 * LR,
                       key_bias_atol=1.5 * LR)
    assert not torch.equal(ema["fc.weight"], clean[3]["fc.weight"])


def test_train_step_sets_train_mode_and_eval_step_sets_eval_mode():
    from simpleaicv_pytorch_training_examples_tpu_torch.engine import (
        make_classification_eval_step)
    _, port_model, _ = _models()
    optimizer, _ = build_optimizer(PortConfig, port_model, 2)
    step = make_train_step(port_model, port_losses.CELoss(), optimizer,
                           compute_dtype=torch.float32)
    images, labels = _batches(1, 4, seed=23, soft=False)[0]
    port_model.eval()
    step(_port_batch(images, labels), 0)
    assert port_model.training
    make_classification_eval_step(port_model, compute_dtype=torch.float32)(
        _port_batch(images, labels))
    assert not port_model.training


# ------------------------------------------------------------ train CLI

TRAIN_CONFIG = """
import torch

from simpleaicv_pytorch_training_examples_tpu_torch.classification import losses
from simpleaicv_pytorch_training_examples_tpu_torch.classification.common import (
    ClassificationCollater, RandomErasing, TorchRandomHorizontalFlip,
    load_state_dict)
from simpleaicv_pytorch_training_examples_tpu_torch.classification.datasets.syntheticdataset import (
    SyntheticClassificationDataset)
from simpleaicv_pytorch_training_examples_tpu_torch.classification.mixupcutmixclassificationcollator import (
    MixupCutmixClassificationCollater)
from simpleaicv_pytorch_training_examples_tpu_torch.data import Compose
from simpleaicv_pytorch_training_examples_tpu_torch.models.backbones.vit import ViT


class config:
    model = ViT(16, 128, 2, 2, image_size=64, num_classes=10,
                global_pool=True, drop_path_prob=0.1, dtype=torch.bfloat16,
                use_fused_attention=True, use_fused_norm=True)
    load_state_dict("{weights}", model)
    train_criterion = losses.{criterion}()
    train_dataset = SyntheticClassificationDataset(
        n={n_train}, image_size=64, num_classes=10, seed=1,
        transform=Compose([TorchRandomHorizontalFlip(prob=0.5),
                           RandomErasing(prob=0.25)]))
    test_dataset = SyntheticClassificationDataset(n=20, image_size=64,
                                                  num_classes=10, seed=1)
    train_collater = {collater}
    test_collater = ClassificationCollater()
    seed = 0
    batch_size = 16
    num_workers = 0
    accumulation_steps = 2
    optimizer = ("AdamW", {{
        "lr": {lr}, "global_weight_decay": False, "weight_decay": 5e-2,
        "lr_layer_decay": 0.65, "lr_layer_decay_block": 2,
        "block_name": "blocks.",
        "no_weight_decay_layer_name_list": ["pos_embed", "cls_token"]}})
    scheduler = {scheduler}
    epochs = {epochs}
    print_interval = 1
    use_amp = True
    use_ema_model = {ema}
    ema_model_decay = 0.5
"""
MIXUP = "MixupCutmixClassificationCollater(num_classes=10)"
COSINE = '("CosineLR", {"warm_up_epochs": 1, "min_lr": 1e-6})'
# a schedule that does not depend on the number of epochs
CONSTANT = ('("MultiStepLR", {"warm_up_epochs": 0, "gamma": 0.1, '
            '"milestones": [100]})')


def _write_config(work_dir, **fields):
    defaults = dict(weights="", criterion="OneHotLabelCELoss", n_train=48,
                    collater=MIXUP, lr=1e-3, epochs=2, ema=True,
                    scheduler=COSINE)
    (work_dir / "train_config.py").write_text(
        TRAIN_CONFIG.format(**dict(defaults, **fields)))


def test_train_cli_runs_saves_resumes_and_best_evaluates(tmp_path):
    _write_config(tmp_path)
    first = train_cli.main(["--work-dir", str(tmp_path)], device="cpu")
    assert first["resumed_from"] is None
    assert [e["epoch"] for e in first["epochs"]] == [1, 2]
    assert all(e["skipped"] == 0 and np.isfinite(e["loss_avg"])
               for e in first["epochs"])
    log = (tmp_path / "log" / "train.log").read_text()
    assert "model params: 0.499 M" in log
    assert len(re.findall(r"param group: lr=0.001 wd=", log)) == 8
    lines = re.findall(r"epoch (\d) iter (\d)/3 lr (\d\.\d{6}) loss "
                       r"(\d+\.\d{4}) avg (\d+\.\d{4}) skipped 0", log)
    assert [(int(e), int(i)) for e, i, *_ in lines] == [
        (1, 1), (1, 2), (1, 3), (2, 1), (2, 2), (2, 3)]
    # the logged lr follows epoch and iteration: warm-up, then the cosine
    assert [l[2] for l in lines[:4]] == ["0.000000", "0.000333", "0.000667",
                                         "0.001000"]
    assert re.search(r"epoch 2: top1 \d+\.\d{3} top5 \d+\.\d{3} train loss "
                     r"avg \d+\.\d{4} hours \d+\.\d{2}", log)
    for name in ("latest.pth", "best.pth"):
        assert (tmp_path / "checkpoints" / name).is_file()
    assert not list((tmp_path / "checkpoints").glob("*.tmp*"))

    latest = torch.load(tmp_path / "checkpoints" / "latest.pth",
                        weights_only=False)
    assert latest["epoch"] == 2 and int(
        latest["optimizer_state_dict"]["step"]) == 6
    assert set(latest["ema_state_dict"]) == set(latest["model_state_dict"])

    _write_config(tmp_path, epochs=3)
    again = train_cli.main(["--work-dir", str(tmp_path)], device="cpu")
    assert again["resumed_from"] == 2
    assert [e["epoch"] for e in again["epochs"]] == [3]
    log = (tmp_path / "log" / "train.log").read_text()
    assert re.search(r"resumed from epoch 2, best acc \d+\.\d{3}", log)
    assert "epoch 3 iter 3/3" in log and "epoch 4" not in log
    latest = torch.load(tmp_path / "checkpoints" / "latest.pth",
                        weights_only=False)
    assert latest["epoch"] == 3 and int(
        latest["optimizer_state_dict"]["step"]) == 9

    # best.pth (the EMA weights) loads through the eval CLI
    eval_dir = tmp_path / "eval"
    eval_dir.mkdir()
    best_path = tmp_path / "checkpoints" / "best.pth"
    (eval_dir / "test_config.py").write_text(TRAIN_CONFIG.format(
        weights=best_path, criterion="CELoss", n_train=4, collater=MIXUP,
        lr=1e-3, epochs=1, ema=True, scheduler=COSINE))
    result = eval_cli.main(["--work-dir", str(eval_dir)], device="cpu")
    assert result["images"] == 20
    assert "pretrained load: 32/32 tensors" in (
        eval_dir / "log" / "test.log").read_text()
    np.testing.assert_allclose(result["top1"], again["best_top1"], atol=5.01)


def test_a_resumed_run_repeats_the_uninterrupted_one(tmp_path):
    """One epoch, then a resume for the second, ends bit for bit where two
    epochs in one run end: the loader order, the transforms' and the
    collater's draws and the drop-path masks follow from the seed, the epoch
    and the iteration, and the optimizer state is restored whole."""
    whole, parts = tmp_path / "whole", tmp_path / "parts"
    for d in (whole, parts):
        d.mkdir()
    _write_config(whole, epochs=2, scheduler=CONSTANT)
    train_cli.main(["--work-dir", str(whole)], device="cpu")
    _write_config(parts, epochs=1, scheduler=CONSTANT)
    train_cli.main(["--work-dir", str(parts)], device="cpu")
    _write_config(parts, epochs=2, scheduler=CONSTANT)
    resumed = train_cli.main(["--work-dir", str(parts)], device="cpu")
    assert resumed["resumed_from"] == 1
    a, b = (torch.load(d / "checkpoints" / "latest.pth", weights_only=False)
            for d in (whole, parts))
    assert a["epoch"] == b["epoch"] == 2
    for key in ("model_state_dict", "ema_state_dict"):
        for name, tensor in a[key].items():
            assert torch.equal(tensor, b[key][name]), (key, name)
    for slot in ("mu", "nu"):
        for name, tensor in a["optimizer_state_dict"][slot].items():
            assert torch.equal(tensor, b["optimizer_state_dict"][slot][name])


def test_golden_overfit_the_loss_falls(tmp_path):
    _write_config(tmp_path, criterion="CELoss", n_train=16,
                  collater="ClassificationCollater()", lr=3e-3, epochs=25,
                  ema=False)
    run = train_cli.main(["--work-dir", str(tmp_path)], device="cpu")
    losses = [e["loss_avg"] for e in run["epochs"]]
    assert len(losses) == 25 and np.isfinite(losses).all()
    assert losses[0] > 2.0                 # ~ln(10) at the start
    assert losses[-1] < 0.5 * losses[0], losses
    assert sum(e["skipped"] for e in run["epochs"]) == 0
