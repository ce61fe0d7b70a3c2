"""The port's DarkNet, VAN, ConvFormer and DINOv3 ConvNeXt backbones and
their configs, against the JAX package on the CPU.

Each model on the same seeded weights (the port's ``*_state_dict_from_jax``
maps), a batch of 4: DarkNet-tiny, -19 and -53 at their published widths
and VAN, ConvFormer and DINOv3 ConvNeXt at tiny widths (8-32 channels, 1-2
blocks a stage), on 64^2 images (DarkNet-53, in float64, on 32^2), so
that the last BatchNorm of a DarkNet normalises at least 4 values, not 2,
whose gradient would be rounding noise. The
port runs in fp32 (DarkNet-53 in float64, see ``FLOAT64``) and JAX in
float64, since JAX's own fp32 DarkNet gradients lie ~1% from its float64
ones. Held at the ResNet tests' scale tolerance: eval and train-mode
outputs 1e-4 of their scale, every gradient 1e-4 of its largest value (a
gradient that is exactly 0, a bias before a BatchNorm, below 1e-6 of the
model's largest in both), the BatchNorm running statistics after one train
forward 1e-5. The VAN,
ConvFormer and ConvNeXt maps are the exact inverses of the JAX package's
``convert_*_state_dict`` (every name and value back bit for bit). The 11
ImageNet configs against their JAX configs as ``test_torch_port_configs``
holds the others.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch


from simpleaicv_pytorch_training_examples_tpu.classification import (
    losses as jax_losses)
from simpleaicv_pytorch_training_examples_tpu.models.backbones import (
    convformer as jax_convformer, darknet as jax_darknet,
    dinov3_convnext as jax_convnext, van as jax_van)
from simpleaicv_pytorch_training_examples_tpu.utils.optimizers import (
    leaf_path_names)
from simpleaicv_pytorch_training_examples_tpu.utils.torch_convert import (
    convert_convformer_state_dict, convert_dinov3_convnext_state_dict,
    convert_van_state_dict)
from simpleaicv_pytorch_training_examples_tpu_torch.classification import (
    losses as port_losses)
from simpleaicv_pytorch_training_examples_tpu_torch.models.backbones import (
    convformer, darknet, dinov3_convnext, van)
from simpleaicv_pytorch_training_examples_tpu_torch.utils.jax_weights import (
    convformer_state_dict_from_jax, darknet_state_dict_from_jax,
    dinov3_convnext_state_dict_from_jax, van_state_dict_from_jax)
from test_torch_port_configs import (  # noqa: F401 (fixture)
    _jax_model, _summary, empty_data_root)
from torch_port_helpers import random_flat, unflatten
from torch_port_helpers import (  # noqa: F401 (autouse)
    drop_work_dir_configs, one_torch_thread)

TINY = ([8, 16, 24, 32], [1, 1, 2, 1])
IMAGES = 4
# a gradient below this share of the model's largest is exactly 0 in float64
ZERO_GRADIENT = 1e-6


def _convnext_map(params, stats):
    return dinov3_convnext_state_dict_from_jax(params)


# kind -> (JAX model, port model, weight map, image size, classifies)
MODELS = {
    "darknettiny": (lambda **kw: jax_darknet.DarknetTiny(num_classes=10,
                                                         **kw),
                    lambda: darknet.DarknetTiny(num_classes=10),
                    darknet_state_dict_from_jax, 64, True),
    "darknet19": (lambda **kw: jax_darknet.Darknet19(num_classes=10, **kw),
                  lambda: darknet.Darknet19(num_classes=10),
                  darknet_state_dict_from_jax, 64, True),
    "darknet53": (lambda **kw: jax_darknet.Darknet53(num_classes=10, **kw),
                  lambda: darknet.Darknet53(num_classes=10,
                                            dtype=torch.float64),
                  darknet_state_dict_from_jax, 32, True),
    "van": (lambda **kw: jax_van.VAN(TINY[0], [2, 2, 2, 2], TINY[1],
                                     num_classes=10, **kw),
            lambda: van.VAN(TINY[0], [2, 2, 2, 2], TINY[1], num_classes=10),
            van_state_dict_from_jax, 64, True),
    "convformer": (lambda **kw: jax_convformer.MetaFormer(
                       TINY[0], TINY[1], num_classes=10, **kw),
                   lambda: convformer.MetaFormer(TINY[0], TINY[1],
                                                 num_classes=10),
                   convformer_state_dict_from_jax, 64, True),
    "convnext": (lambda **kw: jax_convnext.Dinov3ConvNeXtBackbone(
                     embedding_planes=TINY[0], block_nums=TINY[1], **kw),
                 lambda: dinov3_convnext.Dinov3ConvNeXtBackbone(
                     embedding_planes=TINY[0], block_nums=TINY[1]),
                 _convnext_map, 64, False),
}
# DarkNet-53's 23 residual blocks on these O(1) weights are ill-conditioned
# in fp32 (the port's own fp32 and float64 gradients lie up to 20% apart,
# its float64 ones 5e-7 from JAX's): it computes in float64 here (its head
# in fp32, as built)
FLOAT64 = ("darknet53",)
CONVERTERS = {"van": convert_van_state_dict,
              "convformer": convert_convformer_state_dict,
              "convnext": convert_dinov3_convnext_state_dict}


def _flat(tree):
    return dict(zip(leaf_path_names(tree),
                    (np.asarray(l, np.float32)
                     for l in jax.tree_util.tree_leaves(tree))))


def _close(got, want, scale_rtol, name=""):
    want = np.asarray(want)
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    scale = max(np.abs(want).max(), 1e-30)
    np.testing.assert_allclose(got, want, rtol=0, atol=scale_rtol * scale,
                               err_msg=name)


def _nchw(images):
    return torch.from_numpy(images.transpose(0, 3, 1, 2).copy())


def _nhwc(t):
    return t.detach().numpy().transpose(0, 2, 3, 1)


def _loss_jax(out, labels, classifies):
    if classifies:
        return jax_losses.CELoss()(out, labels)
    return sum(jnp.mean(f.astype(jnp.float32) ** 2) for f in out)


def _loss_port(out, labels, classifies):
    if classifies:
        return port_losses.CELoss()(out, labels)
    return sum(f.float().square().mean() for f in out)


@functools.lru_cache(maxsize=None)
def _reference(kind):
    """JAX's weights (fp32 values), inputs and results of one model, once per
    process: (params, stats, images, labels, eval out, train out, loss,
    grads, new stats). The JAX model runs in float64: in fp32 its DarkNet
    gradients lie ~1% from its own float64 ones (the port's fp32 ones lie
    5e-6 from them)."""
    with jax.enable_x64(True):
        return _reference_x64(kind)


def _reference_x64(kind):
    make_jax, _, _, size, classifies = MODELS[kind]
    model = make_jax(dtype=jnp.float64)
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, size, size, 3)))
    params = random_flat(shapes["params"], 1)
    rs = np.random.RandomState(2)
    stats = {n: ((0.1 * rs.standard_normal(v.shape)) if n.endswith("mean")
                 else (1.0 + 0.5 * rs.uniform(size=v.shape))).astype(
                     np.float32)
             for n, v in zip(leaf_path_names(shapes.get("batch_stats", {})),
                             jax.tree_util.tree_leaves(
                                 shapes.get("batch_stats", {})))}
    images = np.random.RandomState(5).standard_normal(
        (IMAGES, size, size, 3)).astype(np.float32)
    labels = np.random.RandomState(6).randint(0, 10, IMAGES)
    f64 = functools.partial(jax.tree.map, lambda a: a.astype(jnp.float64))
    variables = {"params": f64(unflatten(params))}
    if stats:
        variables["batch_stats"] = f64(unflatten(stats))

    def run(variables, x, y):
        eval_out = model.apply(variables, x)

        def loss_fn(p):
            out, new = model.apply({**variables, "params": p}, x, train=True,
                                   mutable=["batch_stats"])
            return _loss_jax(out, y, classifies), (out, new)
        (loss, (train_out, new)), grads = jax.value_and_grad(
            loss_fn, has_aux=True)(variables["params"])
        return eval_out, train_out, loss, grads, new

    eval_out, train_out, loss, grads, new = jax.jit(run)(
        variables, jnp.asarray(images, jnp.float64), jnp.asarray(labels))
    new_stats = _flat(new.get("batch_stats", {})) if stats else {}
    return (params, stats, images, labels, eval_out, train_out, float(loss),
            _flat(grads), new_stats)


def _port(kind):
    _, make_port, weight_map, _, _ = MODELS[kind]
    params, stats = _reference(kind)[:2]
    model = make_port()
    model.load_state_dict(weight_map(params, stats))
    return model.double() if kind in FLOAT64 else model


def _input(kind, images):
    x = torch.from_numpy(images.transpose(0, 3, 1, 2).copy())
    return x.double() if kind in FLOAT64 else x


def _outputs(out, classifies):
    return [out] if classifies else list(out)


@pytest.mark.parametrize("kind", list(MODELS))
def test_outputs_and_gradients_match_jax(kind):
    classifies = MODELS[kind][4]
    (params, stats, images, labels, eval_out, train_out, loss, grads,
     _) = _reference(kind)
    model = _port(kind).eval()
    with torch.no_grad():
        got = model(_input(kind, images))
    for g, w in zip(_outputs(got, classifies), _outputs(eval_out,
                                                        classifies)):
        _close(g if classifies else _nhwc(g), w, 1e-4, "eval")
    model.train()
    got = model(_input(kind, images))
    for g, w in zip(_outputs(got, classifies), _outputs(train_out,
                                                        classifies)):
        _close(g if classifies else _nhwc(g), w, 1e-4, "train")
    port_loss = _loss_port(got, torch.from_numpy(labels), classifies)
    port_loss.backward()
    np.testing.assert_allclose(port_loss.item(), loss, rtol=1e-5)
    want = MODELS[kind][2](grads, {})
    named = dict(model.named_parameters())
    assert set(want) == set(named)
    largest = max(np.abs(w.numpy()).max() for w in want.values())
    for name, w in want.items():
        if np.abs(w.numpy()).max() < ZERO_GRADIENT * largest:
            # a bias before a BatchNorm, whose exact gradient is 0: the
            # port's rounding residue must be as small
            assert named[name].grad.abs().max() < ZERO_GRADIENT * largest
        else:
            _close(named[name].grad.float(), w.numpy(), 1e-4, name)


@pytest.mark.parametrize("kind", ["darknettiny", "darknet53", "van",
                                  "convformer"])
def test_batch_statistics_after_one_train_forward_match_jax(kind):
    """Flax's update by the biased variance, in every BatchNorm."""
    *_, new_stats = _reference(kind)
    images = _reference(kind)[2]
    model = _port(kind).train()
    model(_input(kind, images))
    want = MODELS[kind][2]({}, new_stats)
    got = model.state_dict()
    running = [n for n in want if "running" in n]
    assert running
    for name in running:
        np.testing.assert_allclose(got[name].float().numpy(),
                                   want[name].numpy(),
                                   atol=1e-5, rtol=0, err_msg=name)
    assert all(int(got[n]) == 1 for n in got
               if n.endswith("num_batches_tracked"))


@pytest.mark.parametrize("kind", list(CONVERTERS))
def test_weight_map_is_the_inverse_of_the_jax_converter(kind):
    params, stats = _reference(kind)[:2]
    sd = {k: v.numpy() for k, v in _port(kind).state_dict().items()}
    got_params, got_stats = CONVERTERS[kind](sd)
    assert set(got_params) == set(params)
    assert set(got_stats) == set(stats)
    for name in params:
        np.testing.assert_array_equal(got_params[name], params[name],
                                      err_msg=name)
    for name in stats:
        np.testing.assert_array_equal(got_stats[name], stats[name],
                                      err_msg=name)


def test_darknet_map_covers_every_parameter_and_statistic():
    """DarkNet has no JAX converter: its map must give every tensor of the
    port's models, each in the shape the port holds."""
    for kind in ("darknettiny", "darknet19", "darknet53"):
        params, stats = _reference(kind)[:2]
        sd = darknet_state_dict_from_jax(params, stats)
        want = _port(kind).state_dict()
        assert set(sd) == set(want)
        assert all(sd[n].shape == want[n].shape for n in sd)


def test_darknettiny_last_pool_pads_with_minus_infinity():
    """A map of negative values: zero padding would win the padded column's
    max; -inf keeps the map's own values."""
    x = -torch.rand(1, 2, 3, 3) - 1.0
    padded = torch.nn.functional.pad(x, (0, 1, 0, 1), value=-float("inf"))
    out = torch.nn.functional.max_pool2d(padded, 2, 1)
    assert out.shape == x.shape and (out < 0).all()
    model = darknet.DarknetTiny(num_classes=10).eval()
    feats = {}
    model.conv6.register_forward_hook(lambda m, i, o: feats.setdefault(
        "conv6", o))
    with torch.no_grad():
        model(torch.randn(1, 3, 32, 32))
    assert feats["conv6"].shape[-2:] == (1, 1)


def _port_backbone_model(model):
    """The port model's settings under the JAX module's field names."""
    kind = type(model).__name__
    if kind.startswith("Darknet"):
        fc = getattr(model, "fc", None)
        classes = fc.out_features if fc is not None else \
            model.layer7.layer[0].out_channels
        return {"num_classes": classes}, model.__dict__["_modules"][
            "conv1" if kind != "Darknet19" else "layer1"].layer[0].compute_dtype
    if kind == "VAN":
        block = model.block1[0]
        return {"embedding_planes": [getattr(model, f"norm{i}").weight.numel()
                                     for i in range(1, 5)],
                "mlp_ratios": [getattr(model, f"block{i}")[0].mlp.fc1
                               .out_channels // getattr(model, f"norm{i}")
                               .weight.numel() for i in range(1, 5)],
                "block_nums": model.block_nums,
                "drop_path_prob": model.drop_path_prob,
                "num_classes": model.head.out_features,
                "use_gradient_checkpoint": model.use_gradient_checkpoint,
                }, block.attn.proj_1.compute_dtype
    assert kind == "MetaFormer", kind
    block = model.stages[0][0]
    return {"embedding_planes": model.out_channels,
            "block_nums": [len(s) for s in model.stages],
            "drop_path_prob": model.drop_path_prob,
            "num_classes": model.head.out_features,
            "use_gradient_checkpoint": model.use_gradient_checkpoint,
            }, block.norm1.compute_dtype


CONFIGS = ["darknettiny", "darknet19", "darknet53", "van_b0", "van_b1",
           "van_b2", "van_b3", "convformer_s18", "convformer_s36",
           "convformer_m36", "convformer_b36"]


@pytest.mark.parametrize("name", CONFIGS)
def test_imagenet_config_matches_its_jax_config(name, empty_data_root):
    from pathlib import Path
    import sys

    from simpleaicv_pytorch_training_examples_tpu.utils import (
        load_config_from_work_dir as jax_load_config)
    from simpleaicv_pytorch_training_examples_tpu_torch.utils import (
        load_config_from_work_dir)

    repo = Path(__file__).resolve().parents[1]
    jax_config = jax_load_config(
        str(repo / "00.classification_training/imagenet" / name),
        "train_config")
    want, want_model = _summary(jax_config), _jax_model(jax_config.model)
    port_dir = repo / ("simpleaicv_pytorch_training_examples_tpu_torch/"
                       "experiments/imagenet") / name
    for stem in ("train_config", "test_config"):
        sys.modules.pop("train_config", None)
        sys.modules.pop("test_config", None)
        with torch.device("meta"):
            config = load_config_from_work_dir(str(port_dir), stem)
        got = _summary(config)
        got_model, dtype = _port_backbone_model(config.model)
        assert dtype == torch.bfloat16
        assert got_model == want_model
        assert got == want
