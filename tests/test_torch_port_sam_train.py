"""The port's SAM training (interactive segmentation) against the JAX
package: the loss function of the train tool (encoder, 1 + decoder_iters
prompt-decoder passes with error clicks and the previous mask fed back,
SAMLoss) and its gradients, the losses, the click sampler, the collater,
the mask noise, the optimizer's per-parameter rules, and the train CLI.

Same weights (random flax parameters mapped by sam_state_dict_from_jax),
same numpy inputs and the same Gumbel draws on both sides, fp32 on the CPU.
Tolerances: the whole loss function and its gradients atol 2e-3 / rtol
1e-3, the JAX package's torch-parity tolerances; the rel-pos attention
layer's gradients (sums over up to 2560 tokens, of magnitude up to 100)
1e-5 relative L2 error per tensor (another summation order only); the
losses 1e-6;
clicks, masks and prompts exact; collated images 1e-4 (cv2's bilinear
resize against torch's, on 0-255 values).
"""

import importlib

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import ndimage

from simpleaicv_pytorch_training_examples_tpu.interactive_segmentation import (
    error_click as jax_click, losses as jax_losses)
from simpleaicv_pytorch_training_examples_tpu.interactive_segmentation.datasets import (
    sam_segmentation_dataset as jax_data)
from simpleaicv_pytorch_training_examples_tpu.interactive_segmentation.models.segment_anything import (
    image_encoder as jax_enc, sam as jax_sam)
from simpleaicv_pytorch_training_examples_tpu.utils import (
    optimizers as jax_optimizers)
from simpleaicv_pytorch_training_examples_tpu.utils.optimizers import (
    leaf_path_names)
from simpleaicv_pytorch_training_examples_tpu_torch.interactive_segmentation import (
    error_click as port_click, losses as port_losses)
from simpleaicv_pytorch_training_examples_tpu_torch.interactive_segmentation.datasets import (
    sam_segmentation_dataset as port_data)
from simpleaicv_pytorch_training_examples_tpu_torch.interactive_segmentation.datasets.syntheticdataset import (
    SyntheticSAMDataset)
from simpleaicv_pytorch_training_examples_tpu_torch.interactive_segmentation.models.segment_anything import (
    image_encoder as port_enc, sam as port_sam)
from simpleaicv_pytorch_training_examples_tpu_torch.tools import (
    train_interactive_segmentation_model as train_tool)
from simpleaicv_pytorch_training_examples_tpu_torch.utils.jax_weights import (
    optimizer_state_from_jax, sam_state_dict_from_jax, vit_state_dict_from_jax)
from simpleaicv_pytorch_training_examples_tpu_torch.utils.optimizers import (
    build_optimizer, compute_wd_and_lr)
from torch_port_helpers import random_flat, unflatten
from torch_port_helpers import (  # noqa: F401 (autouse)
    drop_work_dir_configs, one_torch_thread)

jax_tool = importlib.import_module("tools.train_interactive_segmentation_model")

FP32 = dict(rtol=1e-3, atol=2e-3)
LAYER_REL_L2 = 1e-5
IMAGE = 128
BATCH = 3
TINY = dict(image_size=IMAGE, patch_size=16, image_encoder_embedding_planes=128,
            image_encoder_block_nums=2, image_encoder_head_nums=2,
            image_encoder_global_attn_indexes=(1,),
            prompt_encoder_embedding_planes=64, use_flash_attention=True)
SAM_OPTIMIZER = ("AdamW", {"lr": 1e-4, "global_weight_decay": False,
                           "weight_decay": 1e-4,
                           "no_weight_decay_layer_name_list": []})


def as_np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _port_batch(seed=14):
    """One collated batch of the synthetic dataset: points for one image, a
    box for another, a mask prompt for the third."""
    samples = [SyntheticSAMDataset(BATCH, (96, IMAGE), seed=1)[i]
               for i in range(BATCH)]
    np.random.seed(seed)
    batch = port_data.SAMCollater(resize=IMAGE, n_points=9)(samples)
    assert batch["prompt_box_valid"].sum() >= 1
    assert batch["prompt_mask_valid"].sum() >= 1
    assert (batch["prompt_point"][..., 2] >= 0).any()
    return batch


def _jax_batch(batch):
    out = {k: jnp.asarray(v.numpy()) for k, v in batch.items()}
    out["image"] = jnp.asarray(batch["image"].numpy().transpose(0, 2, 3, 1))
    out["prompt_mask"] = jnp.asarray(
        batch["prompt_mask"].numpy().transpose(0, 2, 3, 1))
    return out


@pytest.fixture(scope="module")
def tiny_sam():
    """A tiny JAX SAM and its port with the same random weights."""
    jnet = jax_sam.SAM(**TINY)
    prompts = {"prompt_point": jnp.full((1, 2, 3), -1.0),
               "prompt_box": jnp.zeros((1, 4)),
               "prompt_box_valid": jnp.zeros((1,)),
               "prompt_mask": jnp.zeros((1, IMAGE // 4, IMAGE // 4, 1)),
               "prompt_mask_valid": jnp.zeros((1,))}
    shapes = jax.eval_shape(jnet.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, IMAGE, IMAGE, 3)), prompts)
    flat = random_flat(shapes["params"], seed=11)
    constants = random_flat(shapes["constants"], seed=12)
    port = port_sam.SAM(**TINY)
    port.load_state_dict(sam_state_dict_from_jax(flat, constants))
    variables = {"constants": unflatten(constants)}
    return jnet, unflatten(flat), variables, port


class _Config:
    decoder_iters = 2
    use_amp = False

    def __init__(self, criterion):
        self.train_criterion = criterion


def _jax_noise(rng, iters, b, n):
    """The Gumbel draws of the JAX loss function's clicks: pass i, image j
    draws from split(fold_in(rng, i), b)[j]."""
    return [np.stack([np.asarray(jax.random.gumbel(key, (n,)))
                      for key in jax.random.split(jax.random.fold_in(rng, i),
                                                  b)]) for i in range(iters)]


def _port_loss_and_grads(port, batch, noise, detach_prompt=False):
    draws = iter(noise)
    loss_fn = train_tool.build_loss_fn(
        port, _Config(port_losses.SAMLoss()),
        click_noise=lambda shape, gen, device: torch.from_numpy(next(draws)))
    port.zero_grad(set_to_none=True)
    interpolate = torch.nn.functional.interpolate
    if detach_prompt:   # a control: the mask prompt cut from the graph
        train_tool.F = type("F", (), {"interpolate": staticmethod(
            lambda *a, **kw: interpolate(*a, **kw).detach())})
    try:
        loss, metrics = loss_fn(port, batch, None)
    finally:
        train_tool.F = torch.nn.functional
    loss.backward()
    return loss, metrics, {n: p.grad for n, p in port.named_parameters()}


@pytest.fixture(scope="module")
def jax_loss_and_grads(tiny_sam):
    jnet, params, variables, _ = tiny_sam
    batch = _port_batch()
    rng = jax.random.PRNGKey(5)
    loss_fn = jax_tool.build_loss_fn(jnet, _Config(jax_losses.SAMLoss()))
    (loss, (_, metrics)), grads = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(params, variables, _jax_batch(batch), rng)
    flat = dict(zip(leaf_path_names(grads), jax.tree_util.tree_leaves(grads)))
    noise = _jax_noise(rng, 2, BATCH, IMAGE * IMAGE)
    return batch, noise, float(loss), metrics, sam_state_dict_from_jax(
        {k: np.asarray(v) for k, v in flat.items()}, {})


def test_loss_fn_and_its_gradients_match_jax(tiny_sam, jax_loss_and_grads):
    *_, port = tiny_sam
    batch, noise, want_loss, want_metrics, want_grads = jax_loss_and_grads
    loss, metrics, grads = _port_loss_and_grads(port, batch, noise)
    np.testing.assert_allclose(loss.item(), want_loss, **FP32)
    for name, value in metrics.items():
        np.testing.assert_allclose(value.item(), float(want_metrics[name]),
                                   **FP32)
    assert set(grads) == set(want_grads)
    for name, grad in grads.items():
        np.testing.assert_allclose(as_np(grad), as_np(want_grads[name]),
                                   err_msg=name, **FP32)
    # the rel-pos tables get their gradient through drel alone
    assert as_np(grads["image_encoder.blocks.0.attn.rel_pos_h"]).any()


def test_a_detached_mask_prompt_would_fail_the_gradient_check(
        tiny_sam, jax_loss_and_grads):
    """The control of the test above: the JAX loop lets each pass's loss
    reach back through the mask prompt, and cutting that path moves some
    gradient past the tolerance."""
    *_, port = tiny_sam
    batch, noise, _, _, want_grads = jax_loss_and_grads
    _, _, grads = _port_loss_and_grads(port, batch, noise, detach_prompt=True)
    assert any(not np.allclose(as_np(g), as_np(want_grads[n]), **FP32)
               for n, g in grads.items())


def test_checkpointing_gives_the_same_gradients(tiny_sam, jax_loss_and_grads):
    *_, port = tiny_sam
    batch, noise, *_ = jax_loss_and_grads
    remat = port_sam.SAM(use_gradient_checkpoint=True, **TINY)
    remat.load_state_dict(port.state_dict())
    loss, _, grads = _port_loss_and_grads(port, batch, noise)
    loss_remat, _, grads_remat = _port_loss_and_grads(remat, batch, noise)
    assert loss.item() == loss_remat.item()
    for name, grad in grads.items():
        torch.testing.assert_close(grads_remat[name], grad, rtol=1e-6,
                                   atol=1e-7)


def test_only_full_recompute_is_ported():
    with pytest.raises(NotImplementedError):
        port_sam.SAM(use_gradient_checkpoint=True,
                     remat_policy="dots_saveable", **TINY)
    port_sam.SAM(use_gradient_checkpoint=True,
                 remat_policy="nothing_saveable", **TINY)


@pytest.mark.parametrize("h,w,c,heads", [
    (14, 14, 128, 2),     # K3's route
    (14, 14, 80, 2),      # K4's route
    (40, 32, 64, 1),      # K5's route: 1280 tokens
])
def test_sam_attention_gradients_match_jax(h, w, c, heads):
    """Each rel-pos attention route's gradients, to the input, qkv, proj
    and the rel-pos tables, against JAX's autodiff of the same layer."""
    rs = np.random.RandomState(h + c + 1)
    x = rs.standard_normal((2, h, w, c)).astype(np.float32)
    g = rs.standard_normal((2, h, w, c)).astype(np.float32)
    jmod = jax_enc.SAMAttention(heads, (h, w), use_flash=True)
    params = jax.eval_shape(jmod.init, jax.random.PRNGKey(0),
                            jnp.asarray(x))["params"]
    flat = random_flat(params, seed=2)
    _, vjp = jax.vjp(lambda p, t: jmod.apply({"params": p}, t),
                     unflatten(flat), jnp.asarray(x))
    want_params, want_x = vjp(jnp.asarray(g))
    want = vit_state_dict_from_jax(dict(zip(
        leaf_path_names(want_params),
        (np.asarray(v) for v in jax.tree_util.tree_leaves(want_params)))))
    port = port_enc.SAMAttention(c, heads, (h, w), use_flash=True)
    port.load_state_dict(vit_state_dict_from_jax(flat))
    tx = torch.from_numpy(x).requires_grad_()
    port(tx).backward(torch.from_numpy(g))
    grads = {"x": (tx.grad, want_x)}
    grads.update((n, (p.grad, want[n])) for n, p in port.named_parameters())
    for name, (got, w) in grads.items():
        got, w = as_np(got), as_np(w)
        assert np.linalg.norm(got - w) <= LAYER_REL_L2 * np.linalg.norm(w), \
            (name, np.linalg.norm(got - w) / np.linalg.norm(w))


def test_error_clicks_match_jax_on_its_gumbel_draws():
    rs = np.random.RandomState(0)
    pred = (rs.rand(4, 24, 20) > 0.5).astype(np.float32)
    gt = (rs.rand(4, 24, 20) > 0.5).astype(np.float32)
    gt[3] = pred[3]                              # no error region
    pred[2] = 0.0                                # false negatives only
    rng = jax.random.PRNGKey(9)
    want = np.asarray(jax_click.sample_error_points_batch(
        rng, jnp.asarray(pred), jnp.asarray(gt)))
    noise = np.stack([np.asarray(jax.random.gumbel(key, (24 * 20,)))
                      for key in jax.random.split(rng, 4)])
    got = port_click.sample_error_points_batch(
        torch.from_numpy(noise), torch.from_numpy(pred), torch.from_numpy(gt))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got[3].numpy(), [-1.0, -1.0, -1.0])
    assert got[2, 2] == 1.0
    one = port_click.sample_error_point(torch.from_numpy(noise[0]),
                                        torch.from_numpy(pred[0]),
                                        torch.from_numpy(gt[0]))
    np.testing.assert_array_equal(one.numpy(), want[0])
    draws = port_click.gumbel_noise((2, 5), torch.Generator().manual_seed(0),
                                    "cpu")
    assert draws.shape == (2, 5) and torch.isfinite(draws).all()


@pytest.mark.parametrize("name,kwargs", [
    ("SAMLoss", {}), ("SAMLoss", {"supervise_all_iou": False}),
    ("SAMMultiLevelLoss", {}),
])
def test_sam_losses_match_jax(name, kwargs):
    rs = np.random.RandomState(4)
    masks = [3 * rs.standard_normal((2, 4, 16, 16)).astype(np.float32)
             for _ in range(3)]
    ious = [rs.rand(2, 4).astype(np.float32) for _ in range(3)]
    target = (rs.rand(2, 1, 16, 16) > 0.6).astype(np.float32)
    want = getattr(jax_losses, name)(**kwargs)(
        ([jnp.asarray(m) for m in masks], [jnp.asarray(i) for i in ious]),
        jnp.asarray(target))
    got = getattr(port_losses, name)(**kwargs)(
        ([torch.from_numpy(m) for m in masks],
         [torch.from_numpy(i) for i in ious]), torch.from_numpy(target))
    assert set(got) == set(want)
    for key in want:
        np.testing.assert_allclose(got[key].item(), float(want[key]),
                                   rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_collater_matches_jax(seed):
    """The same samples and np.random seed: the same batch as the JAX
    collater (cv2), images upsampled from 48 x 64."""
    samples = [SyntheticSAMDataset(6, (48, 64), seed=2)[i] for i in range(6)]
    np.random.seed(seed)
    got = port_data.SAMCollater(resize=IMAGE)(samples)
    np.random.seed(seed)
    want = jax_data.SAMCollater(resize=IMAGE)(samples)
    assert got["image"].shape == (6, 3, IMAGE, IMAGE)
    assert got["prompt_mask"].shape == (6, 1, IMAGE // 4, IMAGE // 4)
    np.testing.assert_allclose(got["image"].numpy().transpose(0, 2, 3, 1),
                               want["image"], rtol=0, atol=1e-4)
    np.testing.assert_array_equal(got["prompt_mask"].numpy().transpose(
        0, 2, 3, 1), want["prompt_mask"])
    for key in ("mask", "prompt_point", "prompt_box", "prompt_box_valid",
                "prompt_mask_valid"):
        np.testing.assert_array_equal(got[key].numpy(), want[key], key)


@pytest.mark.parametrize("seed", range(6))
def test_noise_mask_matches_cv2(seed):
    """Erosion and dilation by odd and even kernels, scipy against cv2, on
    the same draws."""
    yy, xx = np.mgrid[:96, :80]
    mask = (((yy - 40) / 30.0) ** 2 + ((xx - 44) / 25.0) ** 2 <= 1.0)
    want = jax_data.noise_mask(mask.astype(np.float32), 0.2,
                               rs=np.random.RandomState(seed))
    got = port_data.noise_mask(mask.astype(np.float32), 0.2,
                               rs=np.random.RandomState(seed))
    np.testing.assert_array_equal(got, want)
    m = mask.astype(np.float32)
    for size in (2, 3, 4, 7):
        kernel = np.ones((size, size), np.uint8)
        np.testing.assert_array_equal(
            ndimage.minimum_filter(m, size=size, mode="nearest"),
            cv2.erode(m, kernel))
        np.testing.assert_array_equal(
            ndimage.maximum_filter(m, size=size, mode="nearest"),
            cv2.dilate(m, kernel))


def test_weight_decay_and_lr_follow_jax(tiny_sam):
    """The SAM-B config's AdamW rules (no decay on 1-D parameters) give
    every parameter the JAX package's weight decay and lr."""
    _, params, _, port = tiny_sam
    names, wds, lrs, scales = jax_optimizers._compute_wd_and_lr(
        params, SAM_OPTIMIZER[1])
    leaves = jax.tree_util.tree_leaves(params)
    per_param = {}
    for key, values in (("wd", wds), ("lr", lrs), ("scale", scales)):
        per_param[key] = sam_state_dict_from_jax(
            {n: np.full(leaf.shape, v, np.float32)
             for n, leaf, v in zip(names, leaves, values)}, {})
    got = compute_wd_and_lr(list(port.named_parameters()), SAM_OPTIMIZER[1])
    assert set(got[0]) == set(per_param["wd"])
    for name, wd, lr, scale in zip(*got):
        for key, value in (("wd", wd), ("lr", lr), ("scale", scale)):
            assert np.all(per_param[key][name].numpy() == np.float32(value)), \
                (name, key)
    assert 0.0 in got[1] and 1e-4 in got[1]


def test_a_jax_adamw_state_of_sam_loads(tiny_sam):
    _, params, _, port = tiny_sam
    flat = dict(zip(leaf_path_names(params),
                    (np.asarray(v) for v in jax.tree_util.tree_leaves(params))))
    mu = {n: 0.5 * v for n, v in flat.items()}
    nu = {n: v ** 2 for n, v in flat.items()}

    class config:
        optimizer = SAM_OPTIMIZER
        scheduler = ("CosineLR", {"warm_up_epochs": 0, "min_lr": 1e-6})
        epochs = 1
    optimizer, _ = build_optimizer(config, port, 2)
    optimizer.load_state_dict(optimizer_state_from_jax(7, model="sam", mu=mu,
                                                       nu=nu))
    assert int(optimizer.step) == 7
    weights = dict(port.named_parameters())
    for name, m, v in zip(optimizer.names, optimizer.moments["mu"],
                          optimizer.moments["nu"]):
        torch.testing.assert_close(m, 0.5 * weights[name].detach())
        torch.testing.assert_close(v, weights[name].detach() ** 2)


TRAIN_CONFIG = """
from simpleaicv_pytorch_training_examples_tpu_torch.interactive_segmentation import losses
from simpleaicv_pytorch_training_examples_tpu_torch.interactive_segmentation.datasets.sam_segmentation_dataset import (
    SAMCollater)
from simpleaicv_pytorch_training_examples_tpu_torch.interactive_segmentation.datasets.syntheticdataset import (
    SyntheticSAMDataset)
from simpleaicv_pytorch_training_examples_tpu_torch.interactive_segmentation.models import sam_b


class config:
    model = sam_b(image_size=128, image_encoder_block_nums=2,
                  image_encoder_global_attn_indexes=(1,),
                  use_gradient_checkpoint=True, use_flash_attention=True)
    train_criterion = losses.SAMLoss()
    train_dataset = SyntheticSAMDataset(n=8, image_size=(96, 128), seed=0)
    train_collater = SAMCollater(resize=128, n_points=9)
    decoder_iters = 2
    seed = 0
    batch_size = 4
    num_workers = 0
    optimizer = ("AdamW", {{"lr": 1e-4, "global_weight_decay": False,
                           "weight_decay": 1e-4,
                           "no_weight_decay_layer_name_list": []}})
    scheduler = ("CosineLR", {{"warm_up_epochs": 0, "min_lr": 1e-6}})
    epochs = {epochs}
    print_interval = 1
    use_amp = False
"""


def test_train_cli_runs_saves_and_resumes_on_the_cpu(tmp_path):
    (tmp_path / "train_config.py").write_text(TRAIN_CONFIG.format(epochs=2))
    first = train_tool.main(["--work-dir", str(tmp_path)], device="cpu")
    assert first["resumed_from"] is None
    assert [e["epoch"] for e in first["epochs"]] == [1, 2]
    assert all(e["skipped"] == 0 and np.isfinite(e["loss_avg"])
               and np.isfinite(e["focal_loss_avg"])
               for e in first["epochs"])
    log = (tmp_path / "log" / "train.log").read_text()
    assert "epoch 2 iter 2/2 lr" in log and "focal_loss" in log
    for name in ("latest.pth", "best.pth"):
        assert (tmp_path / "checkpoints" / name).is_file()
    (tmp_path / "train_config.py").write_text(TRAIN_CONFIG.format(epochs=3))
    again = train_tool.main(["--work-dir", str(tmp_path)], device="cpu")
    assert again["resumed_from"] == 2
    assert [e["epoch"] for e in again["epochs"]] == [3]
    assert "resumed from epoch 2" in (tmp_path / "log" / "train.log").read_text()
    latest = torch.load(tmp_path / "checkpoints" / "latest.pth",
                        weights_only=False)
    assert latest["epoch"] == 3 and int(
        latest["optimizer_state_dict"]["step"]) == 6


def test_train_cli_asks_for_the_card_by_default(tmp_path, monkeypatch):
    (tmp_path / "train_config.py").write_text(TRAIN_CONFIG.format(epochs=1))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        train_tool.main(["--work-dir", str(tmp_path)])
