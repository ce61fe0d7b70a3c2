"""The port's interactive matting (SAM side) and its image files against the
JAX package: the cv2-free reader (``data/image_files.py``) against
``cv2.imread`` and the JAX datasets' items, the five segmentation and
matting datasets read with cv2 unimportable, the matting losses, cv2's
ellipse footprint and the trimap, PFAN matting, the matting head,
``SAMMatting``'s outputs and every gradient through the train tool's loss
function, the SAM matting collater, the three SAM-side configs, and the
matting train CLI.

Same weights on both sides (random flax parameters and batch statistics
mapped by ``utils/jax_weights.py``), the same files and ``np.random``
seeds, fp32 on the CPU. Tolerances: the models, the loss function and its
gradients atol 2e-3 / rtol 1e-3 (the JAX package's torch-parity
tolerances); the losses 1e-5 relative (fp32 sums in another order); PNG
masks, JPEG images (both libraries decode with libjpeg-turbo's default
islow IDCT and fancy upsampling: 0 measured), trimaps, masks and prompts
exact; a colour PNG read as grey within 1 level (Pillow's and cv2's luma
weights round differently); collated images 1e-3 of 0-255 values (cv2's
bilinear resize against torch's).
"""

import importlib
import sys

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from simpleaicv_pytorch_training_examples_tpu.human_matting import (
    losses as jax_losses)
from simpleaicv_pytorch_training_examples_tpu.human_matting.datasets import (
    human_matting_dataset as jax_hm_data)
from simpleaicv_pytorch_training_examples_tpu.interactive_segmentation.datasets import (
    sam_matting_dataset as jax_matting_data,
    sam_segmentation_dataset as jax_seg_data)
from simpleaicv_pytorch_training_examples_tpu.interactive_segmentation.models import (
    segment_anything_matting as jax_matting)
from simpleaicv_pytorch_training_examples_tpu.models import pfan as jax_pfan
from simpleaicv_pytorch_training_examples_tpu.utils import (
    load_config_from_work_dir as jax_load_config)
from simpleaicv_pytorch_training_examples_tpu.utils.optimizers import (
    leaf_path_names)
from simpleaicv_pytorch_training_examples_tpu.video_interactive_segmentation.datasets import (
    sam2_video_matting_dataset as jax_video_matting_data,
    sam2_video_segmentation_dataset as jax_video_seg_data)
from simpleaicv_pytorch_training_examples_tpu_torch.data.image_files import (
    read_gray, read_rgb)
from simpleaicv_pytorch_training_examples_tpu_torch.human_matting import (
    losses as port_losses)
from simpleaicv_pytorch_training_examples_tpu_torch.human_matting.datasets import (
    human_matting_dataset as port_hm_data)
from simpleaicv_pytorch_training_examples_tpu_torch.interactive_segmentation.datasets import (
    sam_matting_dataset as port_matting_data,
    sam_segmentation_dataset as port_seg_data)
from simpleaicv_pytorch_training_examples_tpu_torch.interactive_segmentation.models import (
    segment_anything_matting as port_matting)
from simpleaicv_pytorch_training_examples_tpu_torch.models import (
    pfan as port_pfan)
from simpleaicv_pytorch_training_examples_tpu_torch.tools import (
    train_interactive_matting_model as train_tool)
from simpleaicv_pytorch_training_examples_tpu_torch.utils import (
    load_config_from_work_dir)
from simpleaicv_pytorch_training_examples_tpu_torch.utils.jax_weights import (
    conv_bn_state_dict_from_jax, pfan_state_dict_from_jax,
    sam_matting_state_dict_from_jax)
from simpleaicv_pytorch_training_examples_tpu_torch.video_interactive_segmentation.datasets import (
    sam2_video_matting_dataset as port_video_matting_data,
    sam2_video_segmentation_dataset as port_video_seg_data)
from test_torch_port_configs import RUN_KEYS, _object, _plain
from torch_port_helpers import random_flat, seeded_jpeg, unflatten
from torch_port_helpers import (  # noqa: F401 (autouse)
    drop_work_dir_configs, one_torch_thread)

jax_tool = importlib.import_module("tools.train_interactive_matting_model")

FP32 = dict(rtol=1e-3, atol=2e-3)
IMAGE = 128
TINY = dict(image_size=IMAGE, patch_size=16, image_encoder_embedding_planes=128,
            image_encoder_block_nums=2, image_encoder_head_nums=2,
            image_encoder_global_attn_indexes=(1,),
            prompt_encoder_embedding_planes=64)
# (height, width) of the matting images: factors 128 / 128, 128 / 120 and
# 128 / 200 at resize 128
SIZES = ((96, 128), (100, 120), (150, 200))
LOSS_NAMES = ("GlobalTrimapCELoss", "GloabelTrimapIouLoss", "LocalAlphaLoss",
              "LocalLaplacianLoss", "FusionAlphaLoss", "FusionLaplacianLoss",
              "CompositionLoss")


def as_np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def seeded_alpha(seed, h, w):
    """A soft disc: 1 inside, a ramp several pixels wide, 0 outside."""
    rs = np.random.RandomState(seed)
    cy, cx = rs.uniform(0.35, 0.65) * h, rs.uniform(0.35, 0.65) * w
    radius = rs.uniform(0.2, 0.3) * min(h, w)
    yy, xx = np.mgrid[0:h, 0:w]
    dist = np.sqrt((yy - cy) ** 2 + (xx - cx) ** 2)
    return np.clip((radius - dist) / 6.0 + 0.5, 0.0, 1.0)


def _write_pair(directory, stem, seed, h, w, mask_suffix, binary=False):
    directory.mkdir(parents=True, exist_ok=True)
    (directory / f"{stem}.jpg").write_bytes(seeded_jpeg(seed, h, w))
    alpha = seeded_alpha(seed, h, w)
    if binary:
        alpha = (alpha > 0.5).astype(np.float64)
    cv2.imwrite(str(directory / f"{stem}{mask_suffix}.png"),
                np.round(alpha * 255).astype(np.uint8))


def write_matting_tree(root):
    """Every layout of the slice's datasets under ``root``: human matting
    pairs (``human_matting/Portraits/train/<i>.jpg`` + ``<i>.png``) and an
    image matting set (``human_matting/AM2K/train/<i>.jpg`` +
    ``<i>_alpha.png``); SAM segmentation images
    (``interactive_segmentation/sa/train/<i>.jpg`` + ``<i>_mask0.png``);
    SAM2 segmentation videos (``video_segmentation/vs/train/v0/``); SAM2
    matting videos (``video_interactive_segmentation/{video_matting,
    VideoMatte240K}/train/v0/0000k.jpg`` + ``0000k_alpha.png``) and
    background clips (``.../background_videos/train/b0/0000k.jpg``)."""
    for i, (h, w) in enumerate(SIZES):
        _write_pair(root / "human_matting" / "Portraits" / "train", str(i),
                    10 + i, h, w, "")
        _write_pair(root / "interactive_segmentation" / "sa" / "train",
                    str(i), 20 + i, h, w, "_mask0", binary=True)
    _write_pair(root / "human_matting" / "AM2K" / "train", "0", 30, 90, 120,
                "_alpha")
    for k in range(3):
        _write_pair(root / "video_segmentation" / "vs" / "train" / "v0",
                    f"{k:05d}", 40 + k, 96, 128, "_mask", binary=True)
        for j, name in enumerate(("video_matting", "VideoMatte240K")):
            _write_pair(root / "video_interactive_segmentation" / name /
                        "train" / "v0", f"{k:05d}", 50 + 10 * j + k, 96, 128,
                        "_alpha")
        bg = root / "video_interactive_segmentation" / "background_videos" / \
            "train" / "b0"
        bg.mkdir(parents=True, exist_ok=True)
        (bg / f"{k:05d}.jpg").write_bytes(seeded_jpeg(70 + k, 120, 160))
    return root


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    return write_matting_tree(tmp_path_factory.mktemp("matting_tree"))


def dataset_pairs(root):
    """{name: (port dataset, JAX dataset)} over ``write_matting_tree``."""
    video_matting = dict(
        set_name_list=["video_matting", "VideoMatte240K"],
        use_background_video_prob={"VideoMatte240K": 1.0},
        background_root_dir=str(root / "video_interactive_segmentation" /
                                "background_videos"),
        image_root_dir=str(root / "human_matting"), image_set_name=["AM2K"],
        frame_nums=3)
    return {
        "human_matting": (
            port_hm_data.HumanMattingDataset(
                str(root / "human_matting"), ("Portraits",)),
            jax_hm_data.HumanMattingDataset(
                str(root / "human_matting"), ("Portraits",))),
        "sam_matting": (
            port_matting_data.SAMMattingDataset(
                str(root / "human_matting"), ("Portraits",)),
            jax_matting_data.SAMMattingDataset(
                str(root / "human_matting"), ("Portraits",))),
        "sam_segmentation": (
            port_seg_data.SamSegmentationDataset(
                str(root / "interactive_segmentation"), ["sa"]),
            jax_seg_data.SamSegmentationDataset(
                str(root / "interactive_segmentation"), ["sa"])),
        "sam2_video_segmentation": (
            port_video_seg_data.SAM2VideoSegmentationDataset(
                root_dir=str(root / "video_segmentation"),
                set_name_list=["vs"], frame_nums=3),
            jax_video_seg_data.SAM2VideoSegmentationDataset(
                root_dir=str(root / "video_segmentation"),
                set_name_list=["vs"], frame_nums=3)),
        "sam2_video_matting": (
            port_video_matting_data.SAM2VideoMattingDataset(
                str(root / "video_interactive_segmentation"),
                **video_matting),
            jax_video_matting_data.SAM2VideoMattingDataset(
                str(root / "video_interactive_segmentation"),
                **video_matting)),
    }


def assert_items_equal(got, want, atol=0.0):
    assert set(got) == set(want)
    for key in want:
        g, w = got[key], want[key]
        if isinstance(w, list):
            assert len(g) == len(w)
            for a, b in zip(g, w):
                np.testing.assert_allclose(a, b, rtol=0, atol=atol,
                                           err_msg=key)
        else:
            np.testing.assert_allclose(g, w, rtol=0, atol=atol, err_msg=key)


# ---- the reader


@pytest.mark.parametrize("seed,h,w", [(0, 240, 320), (1, 97, 131),
                                      (2, 64, 48)])
def test_jpeg_reader_matches_cv2(seed, h, w, tmp_path):
    path = tmp_path / "a.jpg"
    path.write_bytes(seeded_jpeg(seed, h, w))
    want = cv2.cvtColor(cv2.imread(str(path)), cv2.COLOR_BGR2RGB)
    got = read_rgb(str(path))
    assert got.dtype == np.float32 and got.shape == (h, w, 3)
    np.testing.assert_array_equal(got, want.astype(np.float32))


def test_png_reader_matches_cv2(tmp_path):
    rs = np.random.RandomState(3)
    grey = (rs.rand(37, 53) * 255).astype(np.uint8)
    cv2.imwrite(str(tmp_path / "m.png"), grey)
    np.testing.assert_array_equal(read_gray(str(tmp_path / "m.png")),
                                  cv2.imread(str(tmp_path / "m.png"),
                                             cv2.IMREAD_GRAYSCALE))
    colour = (rs.rand(37, 53, 3) * 255).astype(np.uint8)
    cv2.imwrite(str(tmp_path / "c.png"), colour)
    diff = read_gray(str(tmp_path / "c.png")).astype(int) - cv2.imread(
        str(tmp_path / "c.png"), cv2.IMREAD_GRAYSCALE)
    assert np.abs(diff).max() <= 1
    assert read_gray(str(tmp_path / "missing.png")) is None
    # a PNG under a .jpg name goes through Pillow, as cv2 sniffs it
    cv2.imwrite(str(tmp_path / "p.png"), colour)
    (tmp_path / "p.jpg").write_bytes((tmp_path / "p.png").read_bytes())
    np.testing.assert_array_equal(
        read_rgb(str(tmp_path / "p.jpg")),
        cv2.cvtColor(cv2.imread(str(tmp_path / "p.jpg")),
                     cv2.COLOR_BGR2RGB).astype(np.float32))


@pytest.mark.parametrize("name", ["human_matting", "sam_matting",
                                  "sam_segmentation",
                                  "sam2_video_segmentation",
                                  "sam2_video_matting"])
def test_dataset_items_match_jax(name, tree):
    """The same files and np.random seed: the same item as the JAX dataset
    (cv2), every entry; the composite's background frames, resized by torch
    where JAX calls cv2, within 1e-3."""
    port, jax_ds = dataset_pairs(tree)[name]
    assert len(port) == len(jax_ds) > 0
    for idx in range(len(port)):
        np.random.seed(idx)
        got = port[idx]
        np.random.seed(idx)
        want = jax_ds[idx]
        assert_items_equal(got, want,
                           atol=1e-3 if name == "sam2_video_matting" else 0.0)


@pytest.mark.parametrize("name", ["human_matting", "sam_matting",
                                  "sam_segmentation",
                                  "sam2_video_segmentation",
                                  "sam2_video_matting"])
def test_datasets_read_with_cv2_unimportable(name, tree, monkeypatch):
    port, _ = dataset_pairs(tree)[name]
    monkeypatch.setitem(sys.modules, "cv2", None)
    with pytest.raises(ImportError):
        import cv2 as _  # noqa: F401
    np.random.seed(0)
    for idx in range(len(port)):
        item = port[idx]
        images = item.get("images", [item.get("image")])
        assert all(np.isfinite(im).all() and im.max() > 0 for im in images)


# ---- trimaps and losses


@pytest.mark.parametrize("k", range(10, 20))
def test_ellipse_footprint_and_trimap_match_cv2(k):
    """Every k of the config's range (np.random.randint(10, 20)): cv2's
    MORPH_ELLIPSE element, and the trimap, whose erode and dilate the JAX
    dataset runs with cv2."""
    np.testing.assert_array_equal(
        port_hm_data.ellipse_footprint(k),
        cv2.getStructuringElement(cv2.MORPH_ELLIPSE, (k, k)).astype(bool))
    alpha = seeded_alpha(k, 90, 110).astype(np.float32)
    alpha[:, :7] = 1.0                     # foreground at the border too
    np.random.seed(k)
    got = port_hm_data.HumanMattingDataset(
        "", kernel_size_range=(k, k + 1))._make_trimap(alpha)
    np.random.seed(k)
    want = jax_hm_data.HumanMattingDataset(
        "", kernel_size_range=(k, k + 1))._make_trimap(alpha)
    np.testing.assert_array_equal(got, want)
    assert set(np.unique(got)) == {0.0, 128.0, 255.0}


def _loss_inputs(seed=4, b=2, h=64, w=48):
    rs = np.random.RandomState(seed)
    alpha = np.stack([seeded_alpha(seed + i, h, w) for i in range(b)]) \
        .astype(np.float32)
    trimap = np.where(alpha > 0.95, 255.0, np.where(alpha > 0.05, 128.0, 0.0))
    trimap[:, :3] = 0.0
    return dict(
        global_pred=rs.rand(b, h, w, 3).astype(np.float32),
        pred=rs.rand(b, h, w, 1).astype(np.float32),
        alpha=alpha, trimap=trimap.astype(np.float32),
        image=(255 * rs.rand(b, h, w, 3)).astype(np.float32),
        fg=(255 * rs.rand(b, h, w, 3)).astype(np.float32),
        bg=(255 * rs.rand(b, h, w, 3)).astype(np.float32))


def _nchw(x):
    return torch.from_numpy(x.transpose(0, 3, 1, 2).copy())


def _call_loss(module, name, x, torch_side):
    loss = getattr(module, name)()
    if not torch_side:
        loss = jax.jit(loss)
    if torch_side:
        t = lambda a: torch.from_numpy(a)  # noqa: E731
        g, p = _nchw(x["global_pred"]), _nchw(x["pred"])
        img, fg, bg = _nchw(x["image"]), _nchw(x["fg"]), _nchw(x["bg"])
    else:
        t = jnp.asarray
        g, p = t(x["global_pred"]), t(x["pred"])
        img, fg, bg = t(x["image"]), t(x["fg"]), t(x["bg"])
    alpha, trimap = t(x["alpha"]), t(x["trimap"])
    if name.startswith(("Global", "Gloabel")):
        return loss(g, trimap)
    if name.startswith("Local"):
        return loss(p, alpha, trimap)
    if name.startswith("Composition"):
        return loss(img, alpha, fg, bg, p)
    return loss(p, alpha)


@pytest.mark.parametrize("name", LOSS_NAMES)
def test_matting_losses_match_jax(name):
    x = _loss_inputs()
    want = float(_call_loss(jax_losses, name, x, False))
    got = _call_loss(port_losses, name, x, True)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.item(), want, rtol=1e-5, atol=1e-7)
    with torch.autocast("cpu", dtype=torch.bfloat16):   # fp32 under autocast
        again = _call_loss(port_losses, name, x, True)
    assert again.dtype == torch.float32
    np.testing.assert_allclose(again.item(), want, rtol=1e-5, atol=1e-7)


# ---- PFAN and the matting head


def _batch_stats(shapes, seed):
    rs = np.random.RandomState(seed)
    out = {}
    for name, leaf in zip(leaf_path_names(shapes),
                          jax.tree_util.tree_leaves(shapes)):
        a = rs.standard_normal(leaf.shape)
        out[name] = (0.1 * a if name.endswith("mean")
                     else 1.0 + 0.2 * np.abs(a)).astype(np.float32)
    return out


@pytest.mark.parametrize("train", [False, True])
def test_pfan_matting_matches_jax(train):
    """ResNet-18 PFAN matting at 64^2: the three outputs, and in training
    the batch statistics the step leaves."""
    x = np.random.RandomState(5).rand(2, 64, 64, 3).astype(np.float32)
    jnet = jax_pfan.PFANMatting("resnet18")
    shapes = jax.eval_shape(jnet.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 64, 64, 3)))
    flat = random_flat(shapes["params"], seed=6)
    stats = _batch_stats(shapes["batch_stats"], 7)
    variables = {"params": unflatten(flat), "batch_stats": unflatten(stats)}
    port = port_pfan.PFANMatting("resnet18")
    port.load_state_dict(pfan_state_dict_from_jax(flat, stats))
    port.train(train)
    with torch.no_grad():
        got = port(torch.from_numpy(x.transpose(0, 3, 1, 2).copy()))
    if train:
        want, new = jax.jit(lambda v, x: jnet.apply(
            v, x, train=True, mutable=["batch_stats"]))(variables, x)
        new_stats = dict(zip(leaf_path_names(new["batch_stats"]),
                             jax.tree_util.tree_leaves(new["batch_stats"])))
        sd = port.state_dict()
        mapped = pfan_state_dict_from_jax(flat, new_stats)
        for name, value in mapped.items():
            if name.endswith(("running_mean", "running_var")):
                np.testing.assert_allclose(as_np(sd[name]), as_np(value),
                                           err_msg=name, **FP32)
    else:
        want = jax.jit(jnet.apply)(variables, x)
    for g, w in zip(got, want):
        np.testing.assert_allclose(as_np(g), as_np(w).transpose(0, 3, 1, 2),
                                   **FP32)
    assert as_np(got[1]).std() > 1e-3


def test_matting_head_matches_jax_and_stays_in_eval():
    rs = np.random.RandomState(8)
    masks = 3 * rs.standard_normal((2, 16, 16, 1)).astype(np.float32)
    feat3 = rs.standard_normal((2, 4, 4, 64)).astype(np.float32)
    feat1 = rs.standard_normal((2, 16, 16, 8)).astype(np.float32)
    head = jax_matting.MattingHead()
    shapes = jax.eval_shape(head.init, jax.random.PRNGKey(0), masks, feat3,
                            feat1)
    flat = random_flat(shapes["params"], seed=9)
    stats = _batch_stats(shapes["batch_stats"], 10)
    want = jax.jit(head.apply)({"params": unflatten(flat),
                                "batch_stats": unflatten(stats)},
                               masks, feat3, feat1)
    port = port_matting.MattingHead(64)
    port.load_state_dict(conv_bn_state_dict_from_jax(flat, stats))
    port.train()
    assert not port.training and not port.global_combine.layer[1].training
    before = {k: v.clone() for k, v in port.state_dict().items()}
    got = port(*(torch.from_numpy(a.transpose(0, 3, 1, 2).copy())
                 for a in (masks, feat3, feat1)))
    for g, w in zip(got, want):
        np.testing.assert_allclose(as_np(g), as_np(w).transpose(0, 3, 1, 2),
                                   **FP32)
    for k, v in port.state_dict().items():
        assert torch.equal(v, before[k]), k


# ---- SAM matting


def _matting_samples(tree, n=3):
    ds = port_matting_data.SAMMattingDataset(str(tree / "human_matting"),
                                             ("Portraits",))
    np.random.seed(0)
    return [ds[i] for i in range(n)]


def _jax_batch(batch):
    out = {k: jnp.asarray(v.numpy()) for k, v in batch.items()}
    for key in ("image", "fg_map", "bg_map", "prompt_mask"):
        out[key] = jnp.asarray(batch[key].numpy().transpose(0, 2, 3, 1))
    return out


@pytest.mark.parametrize("seed", [0, 2, 5])
def test_sam_matting_collater_matches_jax(seed, tree):
    """The same items and np.random seed: the JAX collater's batch (cv2
    resizes at the factors 1, 16/15 and 0.64); the seeds cover each prompt
    kind."""
    samples = _matting_samples(tree)
    np.random.seed(seed)
    got = port_matting_data.SAMMattingCollater(resize=IMAGE)(samples)
    np.random.seed(seed)
    want = jax_matting_data.SAMMattingCollater(resize=IMAGE)(samples)
    want_nchw = {k: (v.transpose(0, 3, 1, 2) if v.ndim == 4 else v)
                 for k, v in want.items()}
    assert set(got) == set(want)
    for key in ("image", "fg_map", "bg_map"):
        np.testing.assert_allclose(got[key].numpy(), want_nchw[key], rtol=0,
                                   atol=1e-3, err_msg=key)
    np.testing.assert_allclose(got["mask"].numpy(), want["mask"], rtol=0,
                               atol=1e-5)
    for key in ("trimap", "prompt_point", "prompt_box", "prompt_box_valid",
                "prompt_mask", "prompt_mask_valid"):
        np.testing.assert_array_equal(got[key].numpy(), want_nchw[key], key)


class _Config:
    use_amp = False

    def __init__(self, criterion):
        self.train_criterion = criterion
        self.loss_ratio = {k: 0.5 + 0.25 * i for i, k in enumerate(criterion)}


@pytest.fixture(scope="module")
def tiny_sam_matting():
    """A tiny JAX SAMMatting and the port with the same random weights and
    head statistics."""
    jnet = jax_matting.SAMMatting(**TINY)
    prompts = {"prompt_point": jnp.full((1, 2, 3), -1.0),
               "prompt_box": jnp.zeros((1, 4)),
               "prompt_box_valid": jnp.zeros((1,)),
               "prompt_mask": jnp.zeros((1, IMAGE // 4, IMAGE // 4, 1)),
               "prompt_mask_valid": jnp.zeros((1,))}
    shapes = jax.eval_shape(jnet.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, IMAGE, IMAGE, 3)), prompts)
    flat = random_flat(shapes["params"], seed=11)
    constants = random_flat(shapes["constants"], seed=12)
    stats = _batch_stats(shapes["batch_stats"], 13)
    port = port_matting.SAMMatting(**TINY)
    port.load_state_dict(sam_matting_state_dict_from_jax(flat, constants,
                                                         stats))
    return jnet, flat, constants, stats, port


def _sam_matting_batch(tree):
    np.random.seed(2)
    return port_matting_data.SAMMattingCollater(resize=IMAGE)(
        _matting_samples(tree))


def test_sam_matting_loss_and_gradients_match_jax(tree, tiny_sam_matting):
    """The train tool's loss function (SAMMatting, each loss at its own
    ratio) against the JAX tool's: every loss term and every parameter's
    gradient; the encoder's attention is the plain one. The trimap IoU loss
    is held on its own below: the JAX tool cannot run it."""
    jnet, flat, constants, stats, port = tiny_sam_matting
    batch = _sam_matting_batch(tree)
    names = [k for k in LOSS_NAMES if k != "GloabelTrimapIouLoss"]
    config = _Config({k: getattr(jax_losses, k)() for k in names})
    loss_fn = jax_tool.build_loss_fn(jnet, config)
    variables = {"constants": unflatten(constants),
                 "batch_stats": unflatten(stats)}
    (want_loss, (_, want_terms)), grads = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(unflatten(flat), variables, _jax_batch(batch),
                                jax.random.PRNGKey(0))
    want_grads = sam_matting_state_dict_from_jax(dict(zip(
        leaf_path_names(grads), (np.asarray(g) for g in
                                 jax.tree_util.tree_leaves(grads)))), {}, {})

    port_config = _Config({k: getattr(port_losses, k)() for k in names})
    port.zero_grad(set_to_none=True)
    port.train()
    loss, terms = train_tool.build_loss_fn(port, port_config)(port, batch,
                                                              None)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want_loss), **FP32)
    assert set(terms) == set(want_terms) - {"loss"}
    for name, value in terms.items():
        np.testing.assert_allclose(value.item(), float(want_terms[name]),
                                   err_msg=name, **FP32)
    named = dict(port.named_parameters())
    assert set(named) == set(want_grads)
    for name, p in named.items():
        # parameters the step never reads get no gradient here, 0 from JAX
        grad = torch.zeros_like(p) if p.grad is None else p.grad
        np.testing.assert_allclose(as_np(grad), as_np(want_grads[name]),
                                   err_msg=name, **FP32)
    for name in ("matting_head.local_up1.deconv.weight",
                 "mask_decoder.output_upscaling.0.weight",
                 "image_encoder.blocks.1.attn.qkv.weight"):
        assert as_np(named[name].grad).any(), name
    assert not any(m.use_flash for m in port.modules()
                   if hasattr(m, "use_flash"))


def test_the_trimap_iou_loss_takes_the_trimap_prediction(tree,
                                                         tiny_sam_matting):
    """The JAX tool dispatches by the prefix "Global", which
    "GloabelTrimapIouLoss" misses: it calls the loss on the fused alpha and
    fails on a shape mismatch. The port's tool gives it the trimap
    prediction (held against JAX's above) and the trimap."""
    jnet, flat, constants, stats, port = tiny_sam_matting
    batch = _sam_matting_batch(tree)
    variables = {"params": unflatten(flat), "constants": unflatten(constants),
                 "batch_stats": unflatten(stats)}
    config = _Config({"GloabelTrimapIouLoss":
                      jax_losses.GloabelTrimapIouLoss()})
    with pytest.raises(TypeError, match="incompatible shapes"):
        jax.jit(jax_tool.build_loss_fn(jnet, config))(
            variables["params"], {k: v for k, v in variables.items()
                                  if k != "params"}, _jax_batch(batch),
            jax.random.PRNGKey(0))
    port_config = _Config({"GloabelTrimapIouLoss":
                           port_losses.GloabelTrimapIouLoss()})
    port.train()
    with torch.no_grad():
        _, terms = train_tool.build_loss_fn(port, port_config)(port, batch,
                                                               None)
        g = port(batch["image"], {k: batch[k] for k in train_tool.PROMPT_KEYS})[0]
    want = port_losses.GloabelTrimapIouLoss()(g, batch["trimap"])
    assert terms["GloabelTrimapIouLoss"].item() == 0.5 * want.item()


# ---- configs and the CLI

SAM_CONFIGS = [
    ("interactive_segmentation/sam_b_matting",
     "13.interactive_segmentation_training/13.2.sam_matting_training/"
     "sam_b_matting"),
    ("interactive_segmentation/sam_b_matting_multilevel_training",
     "13.interactive_segmentation_training/13.2.sam_matting_training/"
     "sam_b_matting_multilevel_training"),
    ("interactive_segmentation/sam_b_multilevel_training",
     "13.interactive_segmentation_training/13.1.sam_segmentation_training/"
     "sam_b_multilevel_training"),
]


def _deep_object(obj):
    """An object as (class name, its public attributes), nested objects
    (a loss's component losses) likewise."""
    if obj is None or isinstance(obj, (int, float, str, bool, list, tuple,
                                       dict, np.ndarray, np.generic)):
        return _plain(obj)
    return (type(obj).__name__, {k: _deep_object(v) for k, v in
                                 vars(obj).items() if not k.startswith("_")})


def config_summary(config):
    """A config's run settings, optimizer, scheduler, dataset, collater and
    criterion, as comparable values."""
    out = {k: _plain(getattr(config, k)) for k in RUN_KEYS + (
        "optimizer", "scheduler", "save_interval", "frame_nums",
        "decoder_iters", "decoder_point_iters", "mask_out_idxs",
        "test_dataset") if hasattr(config, k)}
    out["train_collater"] = _object(config.train_collater)
    dataset = _object(config.train_dataset)
    out["train_dataset"] = (dataset[0], {k: v for k, v in dataset[1].items()
                                         if k != "transform"})
    criterion = config.train_criterion
    out["train_criterion"] = ({k: _deep_object(v)
                               for k, v in criterion.items()}
                              if isinstance(criterion, dict)
                              else _deep_object(criterion))
    return out


def load_config_pair(port_dir, jax_dir, tmp_path, monkeypatch):
    from pathlib import Path
    repo = Path(__file__).resolve().parents[1]
    monkeypatch.setenv("SIMPLEAICV_DATA_ROOT", str(tmp_path / "no_data"))
    sys.modules.pop("tools.path", None)
    jax_config = jax_load_config(str(repo / jax_dir), "train_config")
    with torch.device("meta"):
        config = load_config_from_work_dir(str(
            repo / "simpleaicv_pytorch_training_examples_tpu_torch" /
            "experiments" / port_dir), "train_config")
    sys.modules.pop("tools.path", None)
    return config, jax_config


@pytest.mark.parametrize("port_dir,jax_dir", SAM_CONFIGS,
                         ids=[p for p, _ in SAM_CONFIGS])
def test_sam_config_matches_its_jax_config(port_dir, jax_dir, tmp_path,
                                           monkeypatch):
    config, jax_config = load_config_pair(port_dir, jax_dir, tmp_path,
                                          monkeypatch)
    assert config_summary(config) == config_summary(jax_config)
    model, jax_model = config.model, jax_config.model
    assert type(model).__name__ == type(jax_model).__name__
    enc = model.image_encoder
    assert (enc.pos_embed.shape[-1], len(enc.blocks),
            enc.blocks[0].attn.num_heads if hasattr(enc.blocks[0].attn,
                                                    "num_heads")
            else jax_model.image_encoder_head_nums) == (
        jax_model.image_encoder_embedding_planes,
        jax_model.image_encoder_block_nums, jax_model.image_encoder_head_nums)
    assert model.image_size == jax_model.image_size == 1024
    assert enc.use_gradient_checkpoint == jax_model.use_gradient_checkpoint
    flash = [m.use_flash for m in enc.modules() if hasattr(m, "use_flash")]
    assert all(flash) == bool(getattr(jax_model, "use_flash_attention",
                                      False))


TRAIN_CONFIG = """
from simpleaicv_pytorch_training_examples_tpu_torch.interactive_segmentation import losses_matting
from simpleaicv_pytorch_training_examples_tpu_torch.interactive_segmentation.datasets.sam_matting_dataset import (
    SAMMattingCollater, SAMMattingDataset)
from simpleaicv_pytorch_training_examples_tpu_torch.interactive_segmentation.models import (
    sam_b_matting)


class config:
    model = sam_b_matting(image_size=64, image_encoder_embedding_planes=64,
                          image_encoder_block_nums=2,
                          image_encoder_head_nums=2,
                          image_encoder_global_attn_indexes=(1,),
                          prompt_encoder_embedding_planes=32,
                          use_gradient_checkpoint=True)
    train_criterion = {{
        "GlobalTrimapCELoss": losses_matting.GlobalTrimapCELoss(),
        "LocalAlphaLoss": losses_matting.LocalAlphaLoss(),
        "FusionLaplacianLoss": losses_matting.FusionLaplacianLoss(),
        "CompositionLoss": losses_matting.CompositionLoss(),
    }}
    loss_ratio = {{k: 1.0 for k in train_criterion}}
    train_dataset = SAMMattingDataset({root!r}, ("Portraits",))
    train_collater = SAMMattingCollater(resize=64, n_points=3)
    seed = 0
    batch_size = 1
    num_workers = 0
    optimizer = ("AdamW", {{"lr": 1e-4, "global_weight_decay": False,
                           "weight_decay": 1e-4,
                           "no_weight_decay_layer_name_list": []}})
    scheduler = ("CosineLR", {{"warm_up_epochs": 0, "min_lr": 1e-6}})
    epochs = {epochs}
    print_interval = 1
    use_amp = False
"""


def test_train_cli_runs_saves_and_resumes_on_the_cpu(tree, tmp_path):
    def write(epochs):
        (tmp_path / "train_config.py").write_text(TRAIN_CONFIG.format(
            root=str(tree / "human_matting"), epochs=epochs))
    write(1)
    first = train_tool.main(["--work-dir", str(tmp_path)], device="cpu")
    assert first["resumed_from"] is None and len(first["epochs"]) == 1
    assert all(e["skipped"] == 0 and np.isfinite(e["loss_avg"])
               and np.isfinite(e["CompositionLoss_avg"])
               for e in first["epochs"])
    for name in ("latest.pth", "best.pth"):
        assert (tmp_path / "checkpoints" / name).is_file()
    write(2)
    sys.modules.pop("train_config", None)
    again = train_tool.main(["--work-dir", str(tmp_path)], device="cpu")
    assert again["resumed_from"] == 1 and [e["epoch"] for e in
                                           again["epochs"]] == [2]
    log = (tmp_path / "log" / "train.log").read_text()
    assert "resumed from epoch 1" in log and "epoch 2 iter 3/3" in log


def test_train_cli_asks_for_the_card_by_default(tree, tmp_path, monkeypatch):
    (tmp_path / "train_config.py").write_text(TRAIN_CONFIG.format(
        root=str(tree / "human_matting"), epochs=1))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        train_tool.main(["--work-dir", str(tmp_path)])
