"""The port's Muon optimizer and FLOP counter against the JAX package.

- ``newton_schulz5`` on the same bf16 square, tall and wide matrices;
  ``muon_update`` of a convolution kernel (the port's OIHW against JAX's
  HWIO), a Dense kernel (the port's [out, in] against JAX's [in, out]) and
  a [1, 1, C] token, each mapped back to JAX's layout.
- Three Muon steps of a tiny ViT with a conv patch embed from a mid-run
  state carried across by ``optimizer_state_from_jax``, the Muon/AdamW
  split by name (ViT-B/16's at full size too), and a gated-off step.
- The parameter count exactly and the FLOP count's stated gap on a tiny
  ResNet, a tiny ViT, a tiny MAE and a tiny distillation model; the test
  CLI's line.

Tolerances. Newton-Schulz in bf16 lands 3-7% (relative Frobenius
distance) from the same iteration in float64 at these shapes, and a one-ulp
difference in one product moves it by as much, since each step multiplies
the small singular values' errors by up to 3.4: so the port is held at JAX's
floor, its distance from the float64 iteration at most 1.25x JAX's (the
small shapes come out bit for bit). Muon parameters' change over three
steps within a relative distance of 5e-2 of JAX's (1.0-1.4% measured); the
momentum buffers (fp32) 1e-6; AdamW's half and its moments 5e-6 as the
AdamW test's. FLOPs: the
two counters differ both ways, and the test states each gap. JAX's XLA
``cost_analysis`` also counts elementwise operations, which
``FlopCounterMode`` leaves out (the ViT's port count is 0.982 of JAX's, the
MAE's 0.955); and XLA counts no operation for a convolution tap that falls
on padding, where the port counts every tap of every output (a 3x3
convolution over a 2x2 map: XLA 4/9 of the port's count), so the ResNets at
64^2, whose last stage is 2x2, come out above JAX's (the bottleneck ResNet
1.024, two ResNet-18s 1.305; at 224^2 the share of padded taps is small).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from simpleaicv_pytorch_training_examples_tpu.distillation.distillmodel import (
    KDModel as JaxKDModel)
from simpleaicv_pytorch_training_examples_tpu.masked_image_modeling.models import (
    vit_mae as jax_mae)
from simpleaicv_pytorch_training_examples_tpu.models.backbones import (
    resnet as jax_resnet, vit as jax_vit)
from simpleaicv_pytorch_training_examples_tpu.utils import (
    muon as jax_muon, optimizers as jax_optimizers)
from simpleaicv_pytorch_training_examples_tpu.utils.flops import (
    compute_flops_and_params as jax_flops)
from simpleaicv_pytorch_training_examples_tpu.utils.optimizers import (
    leaf_path_names)
from simpleaicv_pytorch_training_examples_tpu_torch.distillation import KDModel
from simpleaicv_pytorch_training_examples_tpu_torch.masked_image_modeling.models import (
    vit_mae)
from simpleaicv_pytorch_training_examples_tpu_torch.models.backbones import (
    resnet, vit)
from simpleaicv_pytorch_training_examples_tpu_torch.tools import (
    test_classification_model as eval_cli)
from simpleaicv_pytorch_training_examples_tpu_torch.utils import (
    build_optimizer, muon)
from simpleaicv_pytorch_training_examples_tpu_torch.utils.flops import (
    compute_flops_and_params)
from simpleaicv_pytorch_training_examples_tpu_torch.utils.jax_weights import (
    _torch_name, optimizer_state_from_jax, vit_state_dict_from_jax)
from torch_port_helpers import random_flat, unflatten
from torch_port_helpers import (  # noqa: F401 (autouse)
    drop_work_dir_configs, one_torch_thread)

FLOOR_RATIO = 1.25
MUON_STEP_REL = 5e-2
LR = 1e-2


def as_np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def ns_float64(g):
    """The quintic iteration in float64 on the bf16-rounded input: what the
    bf16 iterations approximate."""
    a, b, c = (3.4445, -4.7750, 2.0315)
    x = g.astype(np.float64)
    transposed = x.shape[0] > x.shape[1]
    x = x.T if transposed else x
    x = x / (np.linalg.norm(x) + 1e-7)
    for _ in range(5):
        aa = x @ x.T
        x = a * x + (b * aa + c * aa @ aa) @ x
    return x.T if transposed else x


def rel(a, b):
    return np.linalg.norm(a - b) / np.linalg.norm(b)


def assert_at_jax_floor(got, want, exact):
    """``got`` (the port's bf16 result) lies from the float64 iteration
    ``exact`` no further than FLOOR_RATIO times JAX's ``want`` does."""
    floor = rel(want, exact)
    assert rel(got, exact) <= FLOOR_RATIO * floor, (rel(got, exact), floor)


@pytest.mark.parametrize("shape", [(64, 64), (96, 32), (32, 96), (48, 200)])
def test_newton_schulz_matches_jax(shape):
    g = np.random.RandomState(0).standard_normal(shape).astype(np.float32)
    g16 = jnp.asarray(g, jnp.bfloat16)
    want = as_np(jax.jit(jax_muon.newton_schulz5)(g16))
    exact = ns_float64(as_np(g16))
    got = muon.newton_schulz5(torch.from_numpy(g).bfloat16())
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == shape
    assert_at_jax_floor(as_np(got), want, exact)
    # a stack goes through as its matrices do one by one
    stacked = muon.newton_schulz5(torch.from_numpy(np.stack([g, -g])))
    assert stacked.dtype == torch.float32
    assert torch.equal(stacked[0], got.float())


@pytest.mark.parametrize("kind", ["conv", "dense", "token"])
def test_muon_update_in_each_layout_matches_jax(kind):
    """The port's view of a parameter is JAX's up to a permutation of rows,
    so ``max(A, B)``, the transpose decision and the result are JAX's."""
    rs = np.random.RandomState(1)
    jax_shape = {"conv": (4, 4, 3, 32), "dense": (96, 48),
                 "token": (1, 1, 64)}[kind]
    to_port = {"conv": lambda a: a.transpose(3, 2, 0, 1),
               "dense": lambda a: a.T, "token": lambda a: a}[kind]
    grad, buf = (rs.standard_normal(jax_shape).astype(np.float32)
                 for _ in range(2))
    want, want_buf = jax_muon.muon_update(jnp.asarray(grad), jnp.asarray(buf),
                                          0.95, True, 5)
    got, got_buf = muon.muon_update(
        torch.from_numpy(np.ascontiguousarray(to_port(grad))),
        torch.from_numpy(np.ascontiguousarray(to_port(buf))), 0.95, True, 5,
        out_first=kind != "token")
    eff = grad + 0.95 * (0.95 * buf + grad)
    eff2d = as_np(jnp.asarray(eff.reshape(-1, jax_shape[-1]), jnp.bfloat16))
    exact = ns_float64(eff2d) * 0.2 * max(eff2d.shape) ** 0.5
    assert_at_jax_floor(as_np(got), to_port(as_np(want)),
                        to_port(exact.reshape(jax_shape)))
    np.testing.assert_allclose(as_np(got_buf), to_port(as_np(want_buf)),
                               rtol=0, atol=1e-6)


class JaxConfig:
    optimizer = ("Muon", {"lr": LR, "weight_decay": 5e-2,
                          "exclude_muon_layer_name_list": [
                              "block_1.attn.proj"]})
    scheduler = ("CosineLR", {"warm_up_epochs": 1, "min_lr": 1e-6})
    epochs = 3


class PortConfig(JaxConfig):
    optimizer = ("Muon", {"lr": LR, "weight_decay": 5e-2,
                          "exclude_muon_layer_name_list": [
                              "blocks.1.attn.proj"]})


def _vit_pair(seed=11):
    kwargs = dict(image_size=64, num_classes=10, global_pool=True)
    jax_model = jax_vit.ViT(16, 128, 2, 2, 4, **kwargs)
    port_model = vit.ViT(16, 128, 2, 2, 4, **kwargs)
    shapes = jax.eval_shape(jax_model.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 64, 64, 3)))["params"]
    flat = random_flat(shapes, seed)
    port_model.load_state_dict(vit_state_dict_from_jax(flat))
    return port_model, flat


def _random_like(flat, seed, scale=1.0):
    rs = np.random.RandomState(seed)
    return {n: (scale * rs.standard_normal(v.shape)).astype(np.float32)
            for n, v in flat.items()}


def _muon_split(report):
    return {g["optimizer"]: set(g["name"]) for g in report}


def test_three_muon_steps_of_a_vit_match_jax():
    """Muon on the 2-D+ weights (the conv patch embed, the cls token and the
    position embedding excluded by the stem names, one projection by the
    config), AdamW on the rest, from a carried mid-run state."""
    port_model, flat = _vit_pair()
    jax_params = unflatten(flat)
    tx, jax_report = jax_optimizers.build_optimizer(JaxConfig, jax_params, 2)
    optimizer, report = build_optimizer(PortConfig, port_model, 2)
    want_split = {k: {_torch_name(n) for n in v}
                  for k, v in _muon_split(jax_report).items()}
    assert _muon_split(report) == want_split
    assert {"blocks.0.attn.qkv.weight", "blocks.1.mlp.fc2.weight",
            "fc.weight"} <= want_split["Muon"]
    assert {"patch_embed.proj.weight", "blocks.1.attn.proj.weight",
            "pos_embed", "cls_token"} <= want_split["AdamW"]

    moments = {"muon_buf": _random_like(flat, 1, 0.1),
               "mu": _random_like(flat, 2, 0.1),
               "nu": {n: v ** 2 for n, v in
                      _random_like(flat, 3, 0.1).items()}}
    state = type(tx.init(jax_params))(
        jnp.asarray(3, jnp.int32), *(unflatten(m) for m in moments.values()))
    optimizer.load_state_dict(optimizer_state_from_jax(3, **moments))
    for i in range(3):
        grads = _random_like(flat, 10 + i)
        updates, state = jax.jit(tx.update)(unflatten(grads), state,
                                            jax_params)
        jax_params = jax.tree.map(jnp.add, jax_params, updates)
        port_grads = vit_state_dict_from_jax(grads)
        optimizer.update([port_grads[n] for n in optimizer.names],
                         torch.tensor(True))
    assert int(optimizer.step) == int(state.step) == 6
    want = vit_state_dict_from_jax(
        dict(zip(leaf_path_names(jax_params),
                 map(np.asarray, jax.tree_util.tree_leaves(jax_params)))))
    named = dict(port_model.named_parameters())
    start = vit_state_dict_from_jax(flat)
    for name, w in want.items():
        if name in want_split["Muon"]:
            # the three steps' change, at the bf16 iteration's floor
            moved = as_np(named[name]) - start[name].numpy()
            assert rel(moved, w.numpy() - start[name].numpy()) <= \
                MUON_STEP_REL, name
            continue
        np.testing.assert_allclose(as_np(named[name]), w.numpy(), rtol=0,
                                   atol=5e-6, err_msg=name)
    port_state = optimizer.state_dict()
    for slot, tree in zip(moments, state[1:]):
        flat_tree = dict(zip(leaf_path_names(tree),
                             map(np.asarray, jax.tree_util.tree_leaves(tree))))
        for name, w in vit_state_dict_from_jax(flat_tree).items():
            np.testing.assert_allclose(as_np(port_state[slot][name]),
                                       w.numpy(), rtol=0, atol=5e-6,
                                       err_msg=f"{slot} {name}")


def test_a_gated_off_muon_step_changes_nothing_bit_for_bit():
    port_model, flat = _vit_pair()
    optimizer, _ = build_optimizer(PortConfig, port_model, 2)
    by_name = vit_state_dict_from_jax(_random_like(flat, 3))
    grads = [by_name[n] for n in optimizer.names]
    optimizer.update(grads, torch.tensor(True))
    before = ([p.detach().clone() for p in optimizer.params],
              optimizer.state_dict())
    bad = [g.clone() for g in grads]
    bad[3].view(-1)[0] = float("nan")
    optimizer.update(bad, torch.tensor(False))
    after = optimizer.state_dict()
    assert int(after["step"]) == 1
    assert all(torch.equal(p, q) for p, q in zip(optimizer.params,
                                                 before[0]))
    for slot in ("muon_buf", "mu", "nu"):
        for n in optimizer.names:
            assert torch.equal(after[slot][n], before[1][slot][n])


def test_vit_b16_muon_split_counts_match_jax():
    """ViT-B/16 at full size: the port's report splits the parameters as
    the JAX report does, 49 to Muon (the blocks' four weights and the
    head), 103 to AdamW."""
    class config(JaxConfig):
        optimizer = ("Muon", {"lr": LR, "weight_decay": 5e-2})
    jax_model = jax_vit.vit_base_patch16(global_pool=True)
    shapes = jax.eval_shape(jax_model.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 224, 224, 3)))["params"]
    _, jax_report = jax_optimizers.build_optimizer(config, shapes, 2)
    with torch.device("meta"):
        port_model = vit.vit_base_patch16(global_pool=True)
    _, report = build_optimizer(config, port_model, 2)
    want = {k: {_torch_name(n) for n in v}
            for k, v in _muon_split(jax_report).items()}
    assert _muon_split(report) == want
    assert (len(want["Muon"]), len(want["AdamW"])) == (49, 103)


MAE_TINY = dict(patch_size=8, image_size=32, encoder_embedding_planes=64,
                encoder_block_nums=1, encoder_head_nums=1,
                decoder_embedding_planes=32, decoder_block_nums=1,
                decoder_head_nums=1)


@pytest.mark.parametrize("kind,lo,hi", [
    ("vit", 0.95, 1.0), ("mae", 0.93, 1.0), ("resnet", 1.0, 1.05),
    ("kd", 1.25, 1.35)])
def test_parameter_count_exact_and_flop_gap(kind, lo, hi):
    jax_model, port_model, size = {
        "vit": lambda: (jax_vit.ViT(16, 128, 2, 2, image_size=64,
                                    num_classes=10),
                        vit.ViT(16, 128, 2, 2, image_size=64, num_classes=10,
                                use_fused_attention=True), 64),
        "mae": lambda: (jax_mae.VITMAEPretrainModel(**MAE_TINY),
                        vit_mae.VITMAEPretrainModel(
                            **MAE_TINY, use_fused_attention=True), 32),
        "resnet": lambda: (jax_resnet.ResNet(jax_resnet.Bottleneck,
                                             [1, 1, 1, 1], 8, num_classes=10),
                           resnet.ResNet(resnet.Bottleneck, [1, 1, 1, 1], 8,
                                         num_classes=10), 64),
        "kd": lambda: (JaxKDModel("resnet18", "resnet18", num_classes=10),
                       KDModel("resnet18", "resnet18", num_classes=10), 64),
    }[kind]()
    variables = dict(jax.eval_shape(jax_model.init, jax.random.PRNGKey(0),
                                    jnp.zeros((1, size, size, 3))))
    params = variables.pop("params")
    variables = jax.tree.map(lambda s: jnp.zeros(s.shape, s.dtype),
                             variables)   # closed over: concrete
    want_flops, want_params = jax_flops(jax_model, params, variables,
                                        (1, size, size, 3))
    flops, n_params = compute_flops_and_params(port_model,
                                               (1, 3, size, size))
    assert n_params == want_params
    assert lo * want_flops <= flops <= hi * want_flops, (flops, want_flops)
    # the count runs the plain ops and puts the model's switches back
    assert all(getattr(m, "use_fused_attention", True)
               for m in port_model.modules())


TEST_CONFIG = """
from simpleaicv_pytorch_training_examples_tpu_torch.classification.common import (
    ClassificationCollater)
from simpleaicv_pytorch_training_examples_tpu_torch.classification.datasets.syntheticdataset import (
    SyntheticClassificationDataset)
from simpleaicv_pytorch_training_examples_tpu_torch.models.backbones.resnet import (
    Bottleneck, ResNet)


class config:
    input_image_size = 64
    model = ResNet(Bottleneck, [1, 1, 1, 1], 8, num_classes=10)
    test_dataset = SyntheticClassificationDataset(n=4, image_size=64,
                                                  num_classes=10, seed=0)
    test_collater = ClassificationCollater()
    seed = 0
    batch_size = 4
    num_workers = 0
"""


def test_the_test_cli_logs_the_parameter_and_flop_counts(tmp_path):
    (tmp_path / "test_config.py").write_text(TEST_CONFIG)
    values = eval_cli.main(["--work-dir", str(tmp_path)], device="cpu")
    model = resnet.ResNet(resnet.Bottleneck, [1, 1, 1, 1], 8, num_classes=10)
    flops, n_params = compute_flops_and_params(model, (1, 3, 64, 64))
    assert (values["flops"], values["params"]) == (flops, n_params)
    log = (tmp_path / "log" / "test.log").read_text()
    assert (f"model params: {n_params / 1e6:.3f} M, flops: "
            f"{flops / 1e9:.3f} G") in log
