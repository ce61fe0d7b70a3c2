"""The port's SAM2 matting, SAM2Image and the DINOv3 prompt encoders
against the JAX package: the video matting train tool's loss function and
every gradient (SAM2VideoMatting, T = 3, two condition slots, an extra
condition frame, at ``head_dim_padding`` 0 and 64: the plain versions of
K2 or K1 in Hiera and of K6 in the memory attention), the frame-0 recipe,
SAM2ImageMatting, SAM2Image (with the high-res skips, plain and kernel
routes), the DINOv3 SAM and SAM2 encoders, the three collaters, the
matting losses, the seven 14.2 configs and the video matting train CLI.

Same weights on both sides (random flax parameters and head statistics
mapped by ``utils/jax_weights.py``), the same clips and ``np.random``
seeds, fp32 on the CPU. Tolerances: models, the loss function and its
gradients atol 2e-3 / rtol 1e-3 (the JAX package's torch-parity
tolerances); the losses 1e-4 relative (fp32 sums over 18,432 to
55,296 elements in another order); collated images 1e-5 (0-1 values,
cv2's bilinear resize against torch's), alphas 1e-5, trimaps, prompts and
frame roles exact.
"""

import importlib
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from simpleaicv_pytorch_training_examples_tpu.interactive_segmentation.models import (
    dinov3_segment_anything as jax_dinov3_sam)
from simpleaicv_pytorch_training_examples_tpu.utils.optimizers import (
    leaf_path_names)
from simpleaicv_pytorch_training_examples_tpu.video_interactive_segmentation import (
    losses_matting as jax_losses)
from simpleaicv_pytorch_training_examples_tpu.video_interactive_segmentation.datasets import (
    sam2_video_matting_dataset as jax_data)
from simpleaicv_pytorch_training_examples_tpu.video_interactive_segmentation.models import (
    segment_anything2_matting as jax_matting)
from simpleaicv_pytorch_training_examples_tpu.video_interactive_segmentation.models.segment_anything2 import (
    sam2_image as jax_sam2_image)
from simpleaicv_pytorch_training_examples_tpu_torch.interactive_segmentation.models import (
    dinov3_segment_anything as port_dinov3_sam)
from simpleaicv_pytorch_training_examples_tpu_torch.tools import (
    train_video_interactive_matting_model as train_tool)
from simpleaicv_pytorch_training_examples_tpu_torch.utils.jax_weights import (
    sam2_matting_state_dict_from_jax, sam2_state_dict_from_jax,
    sam_state_dict_from_jax)
from simpleaicv_pytorch_training_examples_tpu_torch.video_interactive_segmentation import (
    losses_matting as port_losses)
from simpleaicv_pytorch_training_examples_tpu_torch.video_interactive_segmentation.datasets import (
    sam2_video_matting_dataset as port_data)
from simpleaicv_pytorch_training_examples_tpu_torch.video_interactive_segmentation.models import (
    segment_anything2_matting as port_matting)
from simpleaicv_pytorch_training_examples_tpu_torch.video_interactive_segmentation.models.segment_anything2 import (
    sam2_image as port_sam2_image)
from test_torch_port_matting import (_batch_stats, config_summary,
                                     load_config_pair, seeded_alpha,
                                     write_matting_tree)
from torch_port_helpers import random_flat, unflatten
from torch_port_helpers import (  # noqa: F401 (autouse)
    drop_work_dir_configs, one_torch_thread)

jax_tool = importlib.import_module("tools.train_video_interactive_matting_model")

FP32 = dict(rtol=1e-3, atol=2e-3)
IMAGE, FRAMES, BATCH = 128, 3, 2
COLLATER_SEED = 3     # an extra condition frame (frame 2), point prompts
TINY = dict(image_size=IMAGE, embedding_planes=56, head_nums=1,
            block_nums=(1, 1, 2, 1), window_specification=(4, 2, 4, 2),
            global_attention_blocks=(3,), fpn_planes=32, memory_planes=16,
            memory_mask_nums=3, memory_cond_slots=2, max_object_pointers=4,
            use_flash_attention=True)
IMAGE_TINY = {k: TINY[k] for k in ("image_size", "embedding_planes",
                                   "head_nums", "block_nums",
                                   "window_specification",
                                   "global_attention_blocks", "fpn_planes")}
POINT = {"prompt_point": jnp.full((1, 1, 3), -1.0), "prompt_box": None,
         "prompt_mask": None}


def as_np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _clips(n=BATCH, frames=FRAMES, size=(100, 120), seed=1):
    """Video-matting items: smooth seeded frames and soft moving discs."""
    rs = np.random.RandomState(seed)
    h, w = size
    out = []
    for i in range(n):
        images = [np.clip(rs.uniform(0, 255, (1, 1, 3)) +
                          20 * rs.standard_normal((h, w, 3)), 0, 255)
                  .astype(np.float32) for _ in range(frames)]
        alphas = [seeded_alpha(100 * seed + 10 * i + f, h, w)
                  .astype(np.float32) for f in range(frames)]
        out.append({"images": images, "alphas": alphas})
    return out


def _jax_batch(batch):
    out = {k: jnp.asarray(v.numpy()) for k, v in batch.items()}
    out["image"] = jnp.asarray(np.moveaxis(batch["image"].numpy(), -3, -1))
    if "prompt_mask" in batch:
        out["prompt_mask"] = jnp.asarray(
            np.moveaxis(batch["prompt_mask"].numpy(), -3, -1))
    return out


def _load(jnet, port, args, padding=0, mapper=sam2_matting_state_dict_from_jax,
          seed=7):
    """Random flax weights for ``jnet`` (its shapes from ``args``), loaded
    into ``port``; returns the flax variables."""
    shapes = jax.eval_shape(jnet.init, jax.random.PRNGKey(0), *args)
    flat = random_flat(shapes["params"], seed=seed)
    constants = random_flat(shapes.get("constants", {}), seed=seed + 1)
    stats = _batch_stats(shapes.get("batch_stats", {}), seed + 2)
    if mapper is sam2_matting_state_dict_from_jax:
        sd = mapper(flat, constants, stats, padding)
    else:
        sd = mapper(flat, constants)
    port.load_state_dict(sd)
    variables = {"params": unflatten(flat)}
    if constants:
        variables["constants"] = unflatten(constants)
    if stats:
        variables["batch_stats"] = unflatten(stats)
    return variables


@pytest.fixture(scope="module", params=[0, 64], ids=["d56", "pad64"])
def tiny_video_matting(request):
    tiny = dict(TINY, head_dim_padding=request.param)
    jnet = jax_matting.SAM2VideoMatting(**tiny)
    port = port_matting.SAM2VideoMatting(**tiny)
    variables = _load(jnet, port, (jnp.zeros((1, 2, IMAGE, IMAGE, 3)), POINT),
                      request.param)
    return jnet, variables, port


def _batch(seed=COLLATER_SEED):
    np.random.seed(seed)
    batch = port_data.SAM2VideoMattingBatchCollater(
        resize=IMAGE, frame_nums=FRAMES)(_clips())
    assert batch["is_cond_frame"][0].tolist() == [1.0, 0.0, 1.0]
    assert (batch["prompt_point"][:, 2, :, 2] >= 0).any()
    return batch


class _Config:
    use_amp = False
    train_criterion = None


def _port_loss_and_grads(port, batch):
    config = _Config()
    config.train_criterion = port_losses.SAM2MattingLoss()
    port.zero_grad(set_to_none=True)
    port.train()
    loss, terms = train_tool.build_loss_fn(port, config)(port, batch, None)
    loss.backward()
    return loss, terms, {n: torch.zeros_like(p) if p.grad is None else p.grad
                         for n, p in port.named_parameters()}


def _jax_loss_and_grads(jnet, variables, batch, padding):
    config = _Config()
    config.train_criterion = jax_losses.SAM2MattingLoss()
    loss_fn = jax_tool.build_loss_fn(jnet, config)
    rest = {k: v for k, v in variables.items() if k != "params"}
    (loss, (_, terms)), grads = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(variables["params"], rest, _jax_batch(batch),
                                jax.random.PRNGKey(0))
    grads = sam2_matting_state_dict_from_jax(dict(zip(
        leaf_path_names(grads), (np.asarray(g) for g in
                                 jax.tree_util.tree_leaves(grads)))), {}, {},
        padding)
    return float(loss), terms, grads


def test_video_matting_loss_and_gradients_match_jax(tiny_video_matting):
    """The condition-frame recipe: frame 0 and frame 2 prompted and written
    to the two condition slots, frame 1 tracked; every loss term and every
    parameter's gradient, the memory encoder's and keys' included."""
    jnet, variables, port = tiny_video_matting
    padding = port.head_dim_padding
    batch = _batch()
    want_loss, want_terms, want_grads = _jax_loss_and_grads(
        jnet, variables, batch, padding)
    loss, terms, grads = _port_loss_and_grads(port, batch)
    np.testing.assert_allclose(loss.item(), want_loss, **FP32)
    assert set(terms) == set(want_terms) - {"loss"}
    for name, value in terms.items():
        np.testing.assert_allclose(value.item(), float(want_terms[name]),
                                   err_msg=name, **FP32)
    assert set(grads) == set(want_grads)
    for name, grad in grads.items():
        np.testing.assert_allclose(as_np(grad), as_np(want_grads[name]),
                                   err_msg=name, **FP32)
    for name in ("memory_encoder.out_proj.weight",
                 "memory_attention.layers.0.cross_attn_image.k_proj.weight",
                 "matting_head.global_combine.layer.0.weight",
                 "image_encoder.trunk.blocks.3.attn.qkv.weight"):
        assert as_np(grads[name]).any(), name


def test_frame0_recipe_and_outputs_match_jax():
    """Frame-0 points (SAM2VideoMattingCollater): the model's five outputs
    on every frame, no condition frame after frame 0 (Hiera at d = 56)."""
    jnet = jax_matting.SAM2VideoMatting(**TINY)
    port = port_matting.SAM2VideoMatting(**TINY)
    variables = _load(jnet, port, (jnp.zeros((1, 2, IMAGE, IMAGE, 3)), POINT),
                      seed=47)
    np.random.seed(4)
    batch = port_data.SAM2VideoMattingCollater(resize=IMAGE,
                                               frame_nums=FRAMES)(_clips())
    prompts = {"prompt_point": batch["prompt_point"], "prompt_box": None,
               "prompt_mask": None}
    jbatch = _jax_batch(batch)
    want = jax.jit(lambda v, x, p: jnet.apply(v, x, p))(
        variables, jbatch["image"], {"prompt_point": jbatch["prompt_point"],
                                     "prompt_box": None, "prompt_mask": None})
    port.eval()
    with torch.no_grad():
        got = port(batch["image"], prompts)
    for g, w in zip(got, want):
        w = as_np(w)
        if w.ndim == 5:
            w = np.moveaxis(w, -1, 2)
        np.testing.assert_allclose(as_np(g), w, **FP32)


def test_image_matting_matches_jax():
    jnet = jax_matting.SAM2ImageMatting(**TINY)
    port = port_matting.SAM2ImageMatting(**TINY)
    variables = _load(jnet, port, (jnp.zeros((1, IMAGE, IMAGE, 3)), POINT),
                      seed=17)
    np.random.seed(6)
    batch = port_data.SAM2ImageMattingCollater(resize=IMAGE, n_points=3)(
        [{"image": c["images"][0], "mask": c["alphas"][0]}
         for c in _clips(seed=2)])
    jbatch = _jax_batch(batch)
    prompts = {"prompt_point": batch["prompt_point"], "prompt_box": None,
               "prompt_mask": None}
    want = jax.jit(jnet.apply)(variables, jbatch["image"],
                               {"prompt_point": jbatch["prompt_point"],
                                "prompt_box": None, "prompt_mask": None})
    port.eval()
    with torch.no_grad():
        got = port(batch["image"], prompts)
    for g, w in zip(got, want):
        w = as_np(w)
        np.testing.assert_allclose(
            as_np(g), np.moveaxis(w, -1, 1) if w.ndim == 4 else w, **FP32)


@pytest.mark.parametrize("flash", [False, True], ids=["plain", "kernels"])
def test_sam2_image_matches_jax(flash):
    """SAM2Image with the high-res skips, a point and a box prompt; with
    ``use_flash_attention`` the windows take K2's route (d = 56) in the
    port."""
    kw = dict(IMAGE_TINY, use_high_res_features=True,
              use_flash_attention=flash)
    jnet = jax_sam2_image.SAM2Image(**kw)
    port = port_sam2_image.SAM2Image(**kw)
    variables = _load(jnet, port, (jnp.zeros((1, IMAGE, IMAGE, 3)), POINT),
                      mapper=sam2_state_dict_from_jax, seed=27)
    rs = np.random.RandomState(8)
    x = rs.rand(2, IMAGE, IMAGE, 3).astype(np.float32)
    points = np.array([[[40.0, 50.0, 1.0]], [[-1.0, -1.0, -1.0]]],
                      np.float32)
    boxes = np.array([[0, 0, 0, 0], [20, 30, 90, 100]], np.float32)
    valid = np.array([0.0, 1.0], np.float32)
    want = jax.jit(jnet.apply)(variables, x, {
        "prompt_point": points, "prompt_box": boxes,
        "prompt_box_valid": valid})
    with torch.no_grad():
        got = port(torch.from_numpy(x.transpose(0, 3, 1, 2).copy()), {
            "prompt_point": torch.from_numpy(points),
            "prompt_box": torch.from_numpy(boxes),
            "prompt_box_valid": torch.from_numpy(valid)})
    for g, w in zip(got, want):
        np.testing.assert_allclose(as_np(g), as_np(w), **FP32)
    assert as_np(got[0]).std() > 1e-2
    assert all(m.use_flash == flash for m in port.modules()
               if hasattr(m, "use_flash"))


def test_dinov3_sam_encoder_matches_jax():
    """SAM on a DINOv3 ViT-S/16 encoder at 64^2 (16 tokens) against JAX:
    the masks and IoU predictions of a point prompt."""
    kw = dict(image_size=64, prompt_encoder_embedding_planes=32)
    jnet = jax_dinov3_sam.dinov3_vit_small_patch16_sam(**kw)
    port = port_dinov3_sam.dinov3_vit_small_patch16_sam(**kw)
    prompts = {"prompt_point": np.array([[[20.0, 30.0, 1.0]]] * 2,
                                        np.float32),
               "prompt_box": None, "prompt_mask": None}
    variables = _load(jnet, port, (jnp.zeros((1, 64, 64, 3)), POINT),
                      mapper=sam_state_dict_from_jax, seed=37)
    x = np.random.RandomState(9).rand(2, 64, 64, 3).astype(np.float32)
    want = jax.jit(jnet.apply)(variables, x, prompts)
    port.train()   # the encoder's RoPE stays unaugmented, as in JAX
    with torch.no_grad():
        got = port(torch.from_numpy(x.transpose(0, 3, 1, 2).copy()),
                   {k: None if v is None else torch.from_numpy(v)
                    for k, v in prompts.items()})
    for g, w in zip(got, want):
        np.testing.assert_allclose(as_np(g), as_np(w), **FP32)


# ---- collaters and losses


@pytest.mark.parametrize("seed", [0, 3, 11, 20])
def test_batch_collater_matches_jax(seed):
    """The condition-frame collater at the factor 128 / 120, the seeds
    covering each prompt kind and condition pattern."""
    clips = _clips(3, 4, seed=5)
    np.random.seed(seed)
    got = port_data.SAM2VideoMattingBatchCollater(resize=IMAGE,
                                                  frame_nums=4)(clips)
    np.random.seed(seed)
    want = jax_data.SAM2VideoMattingBatchCollater(resize=IMAGE,
                                                  frame_nums=4)(clips)
    assert set(got) == set(want)
    np.testing.assert_allclose(np.moveaxis(got["image"].numpy(), 2, -1),
                               want["image"], rtol=0, atol=1e-5)
    np.testing.assert_allclose(got["alpha"].numpy(), want["alpha"], rtol=0,
                               atol=1e-5)
    np.testing.assert_array_equal(np.moveaxis(got["prompt_mask"].numpy(), 2,
                                              -1), want["prompt_mask"])
    for key in ("trimap", "prompt_point", "prompt_box", "prompt_box_valid",
                "prompt_mask_valid", "is_cond_frame"):
        np.testing.assert_array_equal(got[key].numpy(), want[key], key)


@pytest.mark.parametrize("image", [False, True], ids=["video", "image"])
def test_frame0_and_image_collaters_match_jax(image):
    if image:
        samples = [{"image": c["images"][0], "mask": c["alphas"][0]}
                   for c in _clips(3, 1, (150, 200), seed=6)]
        make = lambda pkg: pkg.SAM2ImageMattingCollater(  # noqa: E731
            resize=IMAGE, n_points=4)
    else:
        samples = _clips(3, 2, (150, 200), seed=6)
        make = lambda pkg: pkg.SAM2VideoMattingCollater(  # noqa: E731
            resize=IMAGE, frame_nums=2, n_points=3)
    np.random.seed(1)
    got = make(port_data)([dict(s) for s in samples])
    np.random.seed(1)
    want = make(jax_data)([dict(s) for s in samples])
    assert set(got) == set(want)
    np.testing.assert_allclose(np.moveaxis(got["image"].numpy(), -3, -1),
                               want["image"], rtol=0, atol=1e-5)
    np.testing.assert_allclose(got["alpha"].numpy(), want["alpha"], rtol=0,
                               atol=1e-5)
    for key in ("trimap", "prompt_point"):
        np.testing.assert_array_equal(got[key].numpy(), want[key], key)


@pytest.mark.parametrize("name,video", [
    ("SAM2MattingLoss", True), ("SAM2MattingLoss", False),
    ("SAM2MattingMultiLevelLoss", True)])
def test_matting_losses_match_jax(name, video):
    rs = np.random.RandomState(12)
    lead = (2, 3) if video else (2,)
    g = rs.rand(*lead, 64, 48, 3).astype(np.float32)
    l, f = (rs.rand(*lead, 64, 48, 1).astype(np.float32) for _ in range(2))
    alpha = np.stack([seeded_alpha(i, 64, 48) for i in range(
        int(np.prod(lead)))]).reshape(*lead, 64, 48).astype(np.float32)
    trimap = np.where(alpha > 0.95, 255.0, np.where(alpha > 0.05, 128.0,
                                                    0.0)).astype(np.float32)
    kw = dict(global_iou_weight=0.5, fusion_laplacian_weight=2.0)
    want = jax.jit(getattr(jax_losses, name)(**kw))(
        tuple(jnp.asarray(a) for a in (g, l, f)), jnp.asarray(alpha),
        jnp.asarray(trimap))
    got = getattr(port_losses, name)(**kw)(
        tuple(torch.from_numpy(np.moveaxis(a, -1, -3).copy())
              for a in (g, l, f)),
        torch.from_numpy(alpha), torch.from_numpy(trimap))
    assert set(got) == set(want)
    for key in want:
        np.testing.assert_allclose(got[key].item(), float(want[key]),
                                   rtol=1e-4, atol=1e-7, err_msg=key)


# ---- configs and the CLI

VIDEO_CONFIGS = [f"hiera_b_plus_video_matting{s}" for s in (
    "", "_stage1", "_stage2", "_stage3", "_multilevel_stage1",
    "_multilevel_stage2", "_multilevel_stage3")]


@pytest.mark.parametrize("name", VIDEO_CONFIGS)
def test_video_matting_config_matches_its_jax_config(name, tmp_path,
                                                     monkeypatch):
    config, jax_config = load_config_pair(
        f"video_interactive_segmentation/{name}",
        "14.video_interactive_segmentation_training/"
        f"14.2.sam2video_matting_training/{name}", tmp_path, monkeypatch)
    want = config_summary(jax_config)
    got = config_summary(config)
    # the data roots differ between the packages' path conventions
    for summary in (got, want):
        summary["train_dataset"][1].pop("background_videos")
    assert got == want
    model, jax_model = config.model, jax_config.model
    assert type(model).__name__ == type(jax_model).__name__
    trunk = model.image_encoder.trunk
    assert (model.image_size, model.memory_cond_slots,
            model.head_dim_padding, model.memory_mask_nums,
            model.max_object_pointers) == (
        jax_model.image_size, jax_model.memory_cond_slots,
        jax_model.head_dim_padding, jax_model.memory_mask_nums,
        jax_model.max_object_pointers)
    assert [len(s) for s in trunk.stages] == list(jax_model.block_nums) \
        if hasattr(trunk, "stages") else len(trunk.blocks) == sum(
            jax_model.block_nums)
    assert trunk.use_gradient_checkpoint == jax_model.use_gradient_checkpoint
    assert all(m.use_flash for m in model.modules()
               if hasattr(m, "use_flash")) == jax_model.use_flash_attention


TRAIN_CONFIG = """
from simpleaicv_pytorch_training_examples_tpu_torch.video_interactive_segmentation.datasets.sam2_video_matting_dataset import (
    SAM2VideoMattingBatchCollater, SAM2VideoMattingDataset)
from simpleaicv_pytorch_training_examples_tpu_torch.video_interactive_segmentation.losses_matting import (
    SAM2MattingLoss)
from simpleaicv_pytorch_training_examples_tpu_torch.video_interactive_segmentation.models import (
    sam2_hiera_tiny_video_matting)


class config:
    model = sam2_hiera_tiny_video_matting(
        image_size=128, block_nums=(1, 1, 2, 1),
        window_specification=(4, 2, 4, 2), global_attention_blocks=(3,),
        use_gradient_checkpoint=True, use_flash_attention=True,
        head_dim_padding=64, memory_cond_slots=2)
    train_criterion = SAM2MattingLoss()
    train_dataset = SAM2VideoMattingDataset(
        {root!r}, set_name_list=["video_matting", "VideoMatte240K"],
        use_background_video_prob={{"VideoMatte240K": 1.0}},
        background_root_dir={root!r} + "/background_videos",
        image_root_dir={human!r}, image_set_name=["AM2K"], frame_nums=3)
    train_collater = SAM2VideoMattingBatchCollater(resize=128, frame_nums=3,
                                                   n_points=2)
    seed = 0
    batch_size = 1
    num_workers = 0
    optimizer = ("AdamW", {{"lr": 5e-5, "global_weight_decay": False,
                           "weight_decay": 1e-4,
                           "no_weight_decay_layer_name_list": []}})
    scheduler = ("CosineLR", {{"warm_up_epochs": 1, "min_lr": 1e-6}})
    epochs = {epochs}
    print_interval = 1
    use_amp = False
"""


def _write_config(work_dir, root, epochs):
    (work_dir / "train_config.py").write_text(TRAIN_CONFIG.format(
        root=str(root / "video_interactive_segmentation"),
        human=str(root / "human_matting"), epochs=epochs))


def test_train_cli_runs_saves_and_resumes_on_the_cpu(tmp_path):
    """The stage-2 recipe on the three layouts (a matte video, a foreground
    video composited over a background clip, an image matte), read from
    files."""
    root = write_matting_tree(tmp_path / "data")
    work = tmp_path / "work"
    work.mkdir()
    _write_config(work, root, 1)
    first = train_tool.main(["--work-dir", str(work)], device="cpu")
    assert first["resumed_from"] is None and len(first["epochs"]) == 1
    assert all(e["skipped"] == 0 and np.isfinite(e["loss_avg"])
               and np.isfinite(e["fusion_laplacian_loss_avg"])
               for e in first["epochs"])
    for name in ("latest.pth", "best.pth"):
        assert (work / "checkpoints" / name).is_file()
    _write_config(work, root, 2)
    sys.modules.pop("train_config", None)
    again = train_tool.main(["--work-dir", str(work)], device="cpu")
    assert again["resumed_from"] == 1 and [e["epoch"] for e in
                                           again["epochs"]] == [2]
    log = (work / "log" / "train.log").read_text()
    assert "resumed from epoch 1" in log and "epoch 2 iter 3/3" in log


def test_train_cli_asks_for_the_card_by_default(tmp_path, monkeypatch):
    root = write_matting_tree(tmp_path / "data")
    _write_config(tmp_path, root, 1)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        train_tool.main(["--work-dir", str(tmp_path)])
