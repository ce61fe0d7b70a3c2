"""The port's MAE pretraining against the JAX package, on the CPU.

The same numpy inputs and the same random weights (flax parameters mapped by
``vit_mae_state_dict_from_jax``) go through the JAX modules and the port's:
the sine-cosine table and the collater's labels (exactly), a tiny MAE model
(patch 8 at 64^2: the encoder's 17 tokens at head dim 64 take K1's route,
the decoder's 65 tokens at head dim 32 take K2's) in eval mode, and in
train mode with the same masking noise given to both (JAX's draw replaced
in ``vit_mae``'s namespace), its predictions, mask and gradients, and both
losses. The JAX model runs
its plain attention (``use_fused_attention=False``: the math its kernels'
plain reference computes, without the Pallas interpreter's compile time);
the port's, built with fused attention, runs its kernels' plain versions on
the CPU. Then the port's MAE train CLI on the committed JPEG fixtures, with
an exact resume, and the self-train fine-tune config's load of an MAE
checkpoint against JAX's.

Tolerances: fp32 outputs atol 2e-4 / rtol 1e-4 and gradients 1e-4 of each
parameter's largest gradient (another summation order only); bf16 outputs
atol 5e-2 (a bf16 ulp is 0.8% of |x| and four rounded blocks lie between
input and output); the loss 1e-6 relative; the table, the labels and the
mask exactly.
"""

import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from simpleaicv_pytorch_training_examples_tpu.masked_image_modeling import (
    common as jax_common, losses as jax_losses)
from simpleaicv_pytorch_training_examples_tpu.masked_image_modeling.models import (
    vit_mae as jax_mae)
from simpleaicv_pytorch_training_examples_tpu.models.backbones import vit as jax_vit
from simpleaicv_pytorch_training_examples_tpu.utils.checkpoint import (
    flatten_params, load_params_filtered)
from simpleaicv_pytorch_training_examples_tpu_torch.masked_image_modeling import (
    common as port_common, losses as port_losses)
from simpleaicv_pytorch_training_examples_tpu_torch.masked_image_modeling.models import (
    vit_mae)
from simpleaicv_pytorch_training_examples_tpu_torch.models import common as port_layers
from simpleaicv_pytorch_training_examples_tpu_torch.models.backbones import vit
from simpleaicv_pytorch_training_examples_tpu_torch.tools import (
    train_mae_self_supervised_model as mae_cli)
from simpleaicv_pytorch_training_examples_tpu_torch.utils.checkpoint import (
    load_state_dict_filtered)
from simpleaicv_pytorch_training_examples_tpu_torch.utils.jax_weights import (
    vit_mae_state_dict_from_jax)
from torch_port_helpers import random_flat, unflatten
from torch_port_helpers import (  # noqa: F401 (autouse)
    drop_work_dir_configs, one_torch_thread)

REPO = Path(__file__).resolve().parents[1]
JPEG_FIXTURES = REPO / "tests" / "torch_port_data" / "jpeg"
FP32 = dict(rtol=1e-4, atol=2e-4)
BF16 = dict(rtol=0, atol=5e-2)
TINY = dict(patch_size=8, image_size=64, encoder_embedding_planes=128,
            encoder_block_nums=2, encoder_head_nums=2,
            decoder_embedding_planes=64, decoder_block_nums=2,
            decoder_head_nums=2, use_fused_attention=True)
B, L = 2, 64    # images, patches of a 64^2 image at patch 8


def as_np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def images(seed=0, size=64):
    return np.random.RandomState(seed).uniform(
        0.0, 1.0, (B, size, size, 3)).astype(np.float32)


def tiny_pair(dtype="float32", seed=0):
    """The tiny JAX MAE, its random flax parameters and the port model with
    the same weights."""
    jd, td = {"float32": (jnp.float32, torch.float32),
              "bfloat16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    jax_model = jax_mae.VITMAEPretrainModel(
        **{**TINY, "use_fused_attention": False}, dtype=jd)
    params = jax.eval_shape(jax_model.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 64, 64, 3)))["params"]
    flat = random_flat(params, seed)
    port = vit_mae.VITMAEPretrainModel(**TINY, dtype=td)
    port.load_state_dict(vit_mae_state_dict_from_jax(flat))
    return jax_model, flat, port


def jax_with_noise(noise):
    """A stand-in for ``jax`` in ``vit_mae``'s namespace whose
    ``random.uniform`` returns ``noise``."""
    random = types.SimpleNamespace(
        uniform=lambda key, shape, *a, **k: jnp.asarray(noise))
    return types.SimpleNamespace(random=random)


def test_sincos_table_is_the_jax_packages():
    for planes, grid in ((768, 14), (512, 14), (1280, 16), (64, 8)):
        want = jax_mae.sincos_position_encoding_2d(planes, grid)
        got = vit_mae.sincos_position_encoding_2d(planes, grid)
        assert got.dtype == want.dtype and np.array_equal(got, want)


@pytest.mark.parametrize("norm_label", [True, False])
def test_collater_labels_are_the_jax_packages(norm_label):
    x = images(1, 32)
    samples = [{"image": x[i], "label": 0} for i in range(B)]
    want = jax_common.MAESelfSupervisedPretrainCollater(
        32, 8, norm_label)([dict(s) for s in samples])
    got = port_common.MAESelfSupervisedPretrainCollater(
        32, 8, norm_label)([dict(s) for s in samples])
    assert tuple(got["label"].shape) == (B, 16, 8 * 8 * 3)
    assert np.array_equal(got["label"].numpy(), want["label"])
    assert np.array_equal(got["image"].numpy(),
                          want["image"].transpose(0, 3, 1, 2))


def test_the_layers_route_as_the_jax_packages(monkeypatch):
    """Encoder blocks take K1 (head dim 64, 17 tokens), decoder blocks K2
    (head dim 32), as JAX ``models/common.py``'s rule routes them."""
    _, _, port = tiny_pair()
    calls = []
    for name in ("fused_attention_dense", "fused_attention"):
        real = getattr(port_layers, name)
        monkeypatch.setattr(port_layers, name, lambda *a, _n=name, _f=real,
                            **k: calls.append(_n) or _f(*a, **k))
    port.eval()(torch.from_numpy(images().transpose(0, 3, 1, 2)))
    assert calls == ["fused_attention_dense"] * 2 + ["fused_attention"] * 2


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_eval_forward_matches_jax(dtype):
    jax_model, flat, port = tiny_pair(dtype)
    x = images()
    pred, mask = jax.jit(jax_model.apply)({"params": unflatten(flat)},
                                          jnp.asarray(x))
    got_pred, got_mask = port.eval()(
        torch.from_numpy(x.transpose(0, 3, 1, 2)))
    assert tuple(got_pred.shape) == (B, L, 8 * 8 * 3)
    assert got_pred.dtype == torch.float32
    assert np.array_equal(as_np(got_mask), as_np(mask))
    assert as_np(got_mask)[:, :L // 4].sum() == 0    # eval keeps the first
    np.testing.assert_allclose(as_np(got_pred), as_np(pred),
                               **(FP32 if dtype == "float32" else BF16))


def test_train_forward_loss_and_gradients_match_jax(monkeypatch):
    jax_model, flat, port = tiny_pair()
    x = images(2)
    noise = np.random.RandomState(3).uniform(size=(B, L)).astype(np.float32)
    label = np.random.RandomState(4).standard_normal(
        (B, L, 8 * 8 * 3)).astype(np.float32)
    monkeypatch.setattr(jax_mae, "jax", jax_with_noise(noise))

    def jax_loss(params):
        pred, mask = jax_model.apply({"params": params}, jnp.asarray(x),
                                     train=True,
                                     rngs={"masking": jax.random.PRNGKey(0)})
        return jax_losses.MSELoss()(pred, jnp.asarray(label), mask), (pred,
                                                                      mask)

    (want_loss, (want_pred, want_mask)), want_grads = jax.jit(
        jax.value_and_grad(jax_loss, has_aux=True))(unflatten(flat))
    port.train()
    pred, mask = port(torch.from_numpy(x.transpose(0, 3, 1, 2)),
                      noise=torch.from_numpy(noise))
    loss = port_losses.MSELoss()(pred, torch.from_numpy(label), mask)
    loss.backward()
    assert np.array_equal(as_np(mask), as_np(want_mask))
    assert as_np(mask).sum() == B * (L - L // 4)
    np.testing.assert_allclose(as_np(pred), as_np(want_pred), **FP32)
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-6)
    want = vit_mae_state_dict_from_jax(flatten_params(want_grads))
    named = dict(port.named_parameters())
    assert set(want) == set(named)
    for name, g in want.items():
        got = named[name].grad.numpy()
        scale = np.abs(g.numpy()).max()
        np.testing.assert_allclose(got, g.numpy(), rtol=0,
                                   atol=1e-4 * scale + 1e-12, err_msg=name)


def test_the_noise_draws_from_the_attached_generator():
    """Train mode draws the noise from the generator the train step hands
    the model; the same seed masks the same patches."""
    _, _, port = tiny_pair()
    port.train()
    x = torch.from_numpy(images().transpose(0, 3, 1, 2))
    gen = torch.Generator()
    port_layers.attach_mask_generator(port, gen)
    masks = []
    for seed in (5, 5, 6):
        gen.manual_seed(seed)
        masks.append(port(x)[1])
    assert torch.equal(masks[0], masks[1])
    assert not torch.equal(masks[0], masks[2])
    gen.manual_seed(5)
    want = torch.argsort(torch.rand((B, L), generator=gen), dim=1,
                         stable=True)[:, :L // 4]
    assert (masks[0].gather(1, want) == 0).all()


@pytest.mark.parametrize("name", ["MSELoss", "L1Loss"])
def test_losses_match_jax(name):
    rs = np.random.RandomState(5)
    pred = rs.standard_normal((3, 10, 12)).astype(np.float32)
    label = rs.standard_normal((3, 10, 12)).astype(np.float32)
    mask = (rs.uniform(size=(3, 10)) < 0.75).astype(np.float32)
    want = getattr(jax_losses, name)()(jnp.asarray(pred, jnp.bfloat16),
                                       jnp.asarray(label), jnp.asarray(mask))
    got = getattr(port_losses, name)()(
        torch.from_numpy(pred).bfloat16(), torch.from_numpy(label),
        torch.from_numpy(mask))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)


MAE_CONFIG = """
from simpleaicv_pytorch_training_examples_tpu_torch.classification.common import (
    Normalize, Opencv2PIL, TorchRandomHorizontalFlip, TorchRandomResizedCrop)
from simpleaicv_pytorch_training_examples_tpu_torch.classification.datasets.ilsvrc2012dataset import (
    ILSVRC2012Dataset)
from simpleaicv_pytorch_training_examples_tpu_torch.data import Compose
from simpleaicv_pytorch_training_examples_tpu_torch.masked_image_modeling import (
    losses)
from simpleaicv_pytorch_training_examples_tpu_torch.masked_image_modeling.common import (
    MAESelfSupervisedPretrainCollater)
from simpleaicv_pytorch_training_examples_tpu_torch.masked_image_modeling.models.vit_mae import (
    VITMAEPretrainModel)


class config:
    model = VITMAEPretrainModel(
        patch_size=8, image_size=32, encoder_embedding_planes=64,
        encoder_block_nums=1, encoder_head_nums=1,
        decoder_embedding_planes=32, decoder_block_nums=1,
        decoder_head_nums=1, use_fused_attention=True)
    train_criterion = losses.MSELoss()
    train_dataset = ILSVRC2012Dataset(
        root_dir="{root}", set_name="train",
        transform=Compose([Opencv2PIL(),
                           TorchRandomResizedCrop(resize=32, scale=(0.2, 1.0)),
                           TorchRandomHorizontalFlip(prob=0.5), Normalize()]))
    test_dataset = None
    train_collater = MAESelfSupervisedPretrainCollater(
        image_size=32, patch_size=8, norm_label=True)
    seed = 0
    batch_size = 4
    num_workers = 0
    accumulation_steps = 2
    optimizer = ("AdamW", {{"lr": 6e-4, "global_weight_decay": False,
                            "weight_decay": 5e-2,
                            "no_weight_decay_layer_name_list": [],
                            "beta1": 0.9, "beta2": 0.95}})
    scheduler = ("CosineLR", {{"warm_up_epochs": 1, "min_lr": 1e-6}})
    epochs = {epochs}
    print_interval = 1
    use_amp = {use_amp}
"""


def jpeg_root(root, n=8):
    """root/train/<class>/*.JPEG: ``n`` copies of the committed fixtures in
    two class folders."""
    fixtures = sorted(JPEG_FIXTURES.glob("*.jpg"))
    for i in range(n):
        folder = root / "train" / f"n{i % 2:08d}"
        folder.mkdir(parents=True, exist_ok=True)
        (folder / f"{i:03d}.JPEG").write_bytes(
            fixtures[i % len(fixtures)].read_bytes())


def write_mae_config(work, root, epochs, use_amp=False):
    work.mkdir(exist_ok=True)
    (work / "train_config.py").write_text(MAE_CONFIG.format(
        root=root, epochs=epochs, use_amp=use_amp))


def test_mae_cli_trains_and_resumes_exactly_on_jpeg_files(tmp_path):
    jpeg_root(tmp_path / "data")
    whole, parts = tmp_path / "whole", tmp_path / "parts"
    write_mae_config(whole, tmp_path / "data", epochs=2)
    run = mae_cli.main(["--work-dir", str(whole)], device="cpu")
    assert [e["epoch"] for e in run["epochs"]] == [1, 2]
    assert all(np.isfinite(e["loss_avg"]) and e["skipped"] == 0
               for e in run["epochs"])
    # the best epoch is the one of the lowest train loss
    assert run["best_loss"] == min(e["loss_avg"] for e in run["epochs"])
    write_mae_config(parts, tmp_path / "data", epochs=1)
    mae_cli.main(["--work-dir", str(parts)], device="cpu")
    write_mae_config(parts, tmp_path / "data", epochs=2)
    again = mae_cli.main(["--work-dir", str(parts)], device="cpu")
    assert again["resumed_from"] == 1
    assert again["epochs"][0]["loss_avg"] == run["epochs"][1]["loss_avg"]
    a, b = (torch.load(d / "checkpoints" / "latest.pth", weights_only=False)
            for d in (whole, parts))
    for name, tensor in a["model_state_dict"].items():
        assert torch.equal(tensor, b["model_state_dict"][name]), name
    for slot in ("mu", "nu"):
        for name, tensor in a["optimizer_state_dict"][slot].items():
            assert torch.equal(tensor, b["optimizer_state_dict"][slot][name])


def test_mae_cli_runs_on_cuda_unless_the_cpu_is_asked_for(tmp_path,
                                                          monkeypatch):
    jpeg_root(tmp_path / "data", n=4)
    write_mae_config(tmp_path / "run", tmp_path / "data", epochs=1,
                     use_amp=True)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        mae_cli.main(["--work-dir", str(tmp_path / "run")])
    run = mae_cli.main(["--work-dir", str(tmp_path / "run"), "--device",
                        "cpu"])
    assert np.isfinite(run["epochs"][0]["loss_avg"])


def test_an_mae_checkpoint_loads_into_the_self_train_vit_as_in_jax(tmp_path):
    """The fine-tune config names its ViT's parameters without the MAE
    model's ``encoder.`` prefix, so neither package loads a tensor of an
    MAE checkpoint (and none is skipped for its shape)."""
    kwargs = dict(patch_size=16, image_size=64, encoder_embedding_planes=64,
                  encoder_block_nums=1, encoder_head_nums=1,
                  decoder_embedding_planes=32, decoder_block_nums=1,
                  decoder_head_nums=1)
    jax_model = jax_mae.VITMAEPretrainModel(**kwargs)
    flat = random_flat(jax.eval_shape(
        jax_model.init, jax.random.PRNGKey(0),
        jnp.zeros((1, 64, 64, 3)))["params"], 6)
    jax_vit_model = jax_vit.ViT(16, 64, 1, 1, image_size=64, global_pool=True,
                                num_classes=10)
    vit_params = jax.eval_shape(jax_vit_model.init, jax.random.PRNGKey(1),
                                jnp.zeros((1, 64, 64, 3)))["params"]
    skipped = []
    logger = types.SimpleNamespace(info=skipped.append)
    _, loaded, total = load_params_filtered(flat, vit_params, logger)

    mae = vit_mae.VITMAEPretrainModel(**kwargs)
    mae.load_state_dict(vit_mae_state_dict_from_jax(flat))
    torch.save({"model_state_dict": mae.state_dict()}, tmp_path / "best.pth")
    port_vit = vit.ViT(16, 64, 1, 1, image_size=64, global_pool=True,
                       num_classes=10)
    port_skipped = []
    port_loaded, port_total = load_state_dict_filtered(
        port_vit, torch.load(tmp_path / "best.pth")["model_state_dict"],
        types.SimpleNamespace(info=port_skipped.append))
    assert (port_loaded, len(port_skipped)) == (loaded, len(skipped)) == (0, 0)
    assert port_total == total == len(list(port_vit.parameters()))
