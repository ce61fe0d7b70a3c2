"""The port's input path against the JAX package's, on the CPU.

The native libjpeg core (``data/native_jpeg.py``) against the JAX
package's on JPEG bytes this test writes with cv2: ``decode_jpeg`` at full
size and with a DCT prescale, ``decode_jpeg_batch`` and
``normalize_into_canvas`` bit for bit (both sides build the same
``data_core.cpp`` against this machine's libjpeg); the PNG path through
cv2; the committed fixtures' recorded means. The train loader's batches
against JAX ``DataLoader._epoch_indices`` exactly, the eval loader's order
and short batch; ``ILSVRC2012Dataset``, ``TorchPad`` and
``TorchRandomCrop`` samples bit for bit under one ``np.random`` seed; the
CIFAR readers on pickles the test writes; the ImageNet-21K tree
conversions exactly and ``SemanticSoftmaxLoss`` to 1e-6 (fp32 against
fp32, another order of sums).
"""

import json
import os
import pickle
from pathlib import Path

import cv2
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from simpleaicv_pytorch_training_examples_tpu.classification import (
    common as jax_common, losses as jax_losses)
from simpleaicv_pytorch_training_examples_tpu.classification.datasets import (
    cifar10dataset as jax_cifar10, cifar100dataset as jax_cifar100,
    ilsvrc2012dataset as jax_ilsvrc, imagenet21kdataset as jax_in21k)
from simpleaicv_pytorch_training_examples_tpu.data import (
    DataLoader as JaxDataLoader, Compose as JaxCompose)
from simpleaicv_pytorch_training_examples_tpu.data import (
    native_jpeg as jax_jpeg)
from simpleaicv_pytorch_training_examples_tpu_torch import native
from simpleaicv_pytorch_training_examples_tpu_torch.classification import (
    common as port_common, losses as port_losses)
from simpleaicv_pytorch_training_examples_tpu_torch.classification.datasets import (
    cifar10dataset, cifar100dataset, ilsvrc2012dataset, imagenet21kdataset)
from simpleaicv_pytorch_training_examples_tpu_torch.data import (
    Compose, TrainLoader, build_loader, native_jpeg)
from simpleaicv_pytorch_training_examples_tpu_torch.data.loader import (
    epoch_batches)
from torch_port_helpers import IN21K_TREE, seeded_jpeg, write_in21k_root
from torch_port_helpers import (  # noqa: F401 (autouse)
    drop_work_dir_configs, one_torch_thread)

FIXTURES = Path(__file__).resolve().parent / "torch_port_data" / "jpeg"


# --------------------------------------------------------- the JPEG core


@pytest.mark.parametrize("max_side", [0, 100, 150, 320])
def test_decode_jpeg_matches_jax_bit_for_bit(max_side):
    """0: full size; 100 and 150: a DCT prescale (1/2 of 320) and a bilinear
    finish; 320: no scaling."""
    for seed, (h, w) in enumerate(((240, 320), (320, 240), (97, 131))):
        data = seeded_jpeg(seed, h, w)
        got = native_jpeg.decode_jpeg(data, max_side)
        want = jax_jpeg.decode_jpeg(data, max_side)
        assert got.dtype == np.uint8 and got.shape[2] == 3
        if max_side:
            assert max(got.shape[:2]) == max_side
        np.testing.assert_array_equal(got, want)


def test_decode_jpeg_batch_and_a_path_match_jax(tmp_path):
    blobs = [seeded_jpeg(10 + i, 120 + 8 * i, 160) for i in range(5)]
    got = native_jpeg.decode_jpeg_batch(blobs, max_side=96, n_threads=3)
    want = jax_jpeg.decode_jpeg_batch(blobs, max_side=96, n_threads=3)
    assert len(got) == len(want) == 5
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    path = tmp_path / "a.jpg"
    path.write_bytes(blobs[0])
    np.testing.assert_array_equal(native_jpeg.decode_jpeg(str(path)),
                                  jax_jpeg.decode_jpeg(str(path)))


def test_normalize_into_canvas_matches_jax():
    image = native_jpeg.decode_jpeg(seeded_jpeg(20, 50, 70))
    kwargs = dict(scale=1.0 / 255.0, mean=(0.485, 0.456, 0.406),
                  std=(0.229, 0.224, 0.225))
    got = native_jpeg.normalize_into_canvas(
        image, np.zeros((64, 80, 3), np.float32), **kwargs)
    want = jax_jpeg.normalize_into_canvas(
        image, np.zeros((64, 80, 3), np.float32), **kwargs)
    np.testing.assert_array_equal(got, want)
    assert not got[50:].any() and not got[:, 70:].any()
    with pytest.raises(ValueError, match="does not fit"):
        native_jpeg.normalize_into_canvas(image,
                                          np.zeros((40, 80, 3), np.float32))


def test_png_goes_through_cv2_and_garbage_gives_none(monkeypatch):
    rs = np.random.RandomState(3)
    bgr = rs.randint(0, 255, (30, 40, 3)).astype(np.uint8)
    ok, png = cv2.imencode(".png", bgr)
    got = native_jpeg.decode_jpeg(png.tobytes())
    np.testing.assert_array_equal(got, bgr[..., ::-1])
    np.testing.assert_array_equal(got, jax_jpeg.decode_jpeg(png.tobytes()))
    assert native_jpeg.decode_jpeg(b"not an image") is None
    # without cv2 a file libjpeg rejects raises an error that names it
    monkeypatch.setitem(__import__("sys").modules, "cv2", None)
    with pytest.raises(RuntimeError, match="frame.png"):
        native_jpeg.decode_jpeg(png.tobytes(), name="frame.png")


def test_the_core_builds_outside_the_source_tree_and_names_its_libjpeg():
    native.lib()
    built = sorted(native.BUILD_DIR.glob("libsaicv_data_*.so"))
    assert built and not list(native.NATIVE_DIR.glob("*.so"))
    path, version = native.linked_libjpeg()
    assert "libjpeg" in os.path.basename(path) and ".so" in path
    assert version is None or version[0].isdigit()


def test_a_built_core_is_loaded_without_the_compiler(monkeypatch):
    """A process that finds the core built (a loader worker) only loads it:
    the path depends on the source, the headers and the libjpeg alone."""
    native.lib()

    def no_compiler(*args, **kwargs):
        raise AssertionError(f"compiler started: {args}")
    monkeypatch.setattr(native.subprocess, "run", no_compiler)
    core = native._load()
    assert os.path.dirname(core._name) == str(native.BUILD_DIR)
    assert native.runtime_libjpeg62() is not None


def test_the_fixtures_decode_to_their_recorded_means():
    record = json.loads((FIXTURES / "means.json").read_text())
    assert 8 <= len(record["images"]) <= 16
    total = 0
    for name, entry in record["images"].items():
        data = (FIXTURES / name).read_bytes()
        total += len(data)
        assert len(data) == entry["bytes"] and 80e3 <= len(data) <= 130e3
        pixels = native_jpeg.decode_jpeg(data)
        assert list(pixels.shape) == entry["shape"] == [375, 500, 3]
        np.testing.assert_allclose(pixels.reshape(-1, 3).mean(axis=0),
                                   entry["channel_means"], atol=1e-3)
    assert total < 2 * 2 ** 20


# ------------------------------------------------------------- the loaders


class _Indexed:
    """Sample i is {'image': [i] as a 1x1 image, 'label': i}."""

    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return {"image": np.full((1, 1, 1), i, np.float32), "label": i}


@pytest.mark.parametrize("n,batch", [(23, 4), (64, 8), (101, 10)])
def test_train_loader_batches_are_the_jax_loaders(n, batch):
    dataset = _Indexed(n)
    collater = port_common.ClassificationCollater()
    for seed in (0, 1, 7):
        jax_loader = JaxDataLoader(dataset, batch, None, shuffle=True,
                                   drop_last=True, seed=seed)
        port_loader = TrainLoader(dataset, batch, collater, "cpu", seed=seed)
        assert len(port_loader) == len(jax_loader) == n // batch
        for epoch in (1, 2):
            jax_loader.set_epoch(epoch)
            port_loader.set_epoch(epoch)
            want = [list(b) for b in jax_loader._epoch_indices()]
            assert [b.tolist() for b in epoch_batches(n, batch, seed,
                                                      epoch)] == want
            assert [b["label"].tolist() for b in port_loader] == want


def test_eval_loader_keeps_the_order_and_the_short_batch():
    dataset = _Indexed(23)
    jax_loader = JaxDataLoader(dataset, 4, None, shuffle=False,
                               drop_last=False)
    loader = build_loader(dataset, 4, port_common.ClassificationCollater(),
                          "cpu")
    got = [b["label"].tolist() for b in loader]
    assert got == [list(b) for b in jax_loader._epoch_indices()]
    assert [len(b) for b in got] == [4] * 5 + [3]


# ---------------------------------------------------- datasets, transforms


def _ilsvrc_tree(root, n_classes=3, per_class=2):
    for set_name in ("train", "val"):
        for c in range(n_classes):
            d = root / set_name / f"n0{c}"
            d.mkdir(parents=True)
            for i in range(per_class):
                (d / f"img_{i}.JPEG").write_bytes(
                    seeded_jpeg(100 * c + i, 90 + 10 * i, 120))


def test_ilsvrc_samples_match_jax_under_one_numpy_seed(tmp_path):
    _ilsvrc_tree(tmp_path)
    transforms = lambda common: [
        common.TorchRandomResizedCrop(resize=64),
        common.TorchRandomHorizontalFlip(prob=0.5),
        common.TorchMeanStdNormalize(mean=[0.485, 0.456, 0.406],
                                     std=[0.229, 0.224, 0.225])]
    port = ilsvrc2012dataset.ILSVRC2012Dataset(
        str(tmp_path), "train", Compose(transforms(port_common)))
    jax_set = jax_ilsvrc.ILSVRC2012Dataset(
        str(tmp_path), "train", JaxCompose(transforms(jax_common)))
    assert len(port) == len(jax_set) == 6
    assert port.image_paths == jax_set.image_paths
    np.testing.assert_array_equal(port.labels, jax_set.labels)
    for i in range(len(port)):
        np.random.seed(40 + i)
        got = port[i]
        np.random.seed(40 + i)
        want = jax_set[i]
        assert got["label"] == want["label"]
        np.testing.assert_array_equal(got["image"], want["image"])
    raw = ilsvrc2012dataset.ILSVRC2012Dataset(str(tmp_path), "val")[5]
    assert raw["image"].dtype == np.uint8 and raw["label"] == 2


def test_pad_and_random_crop_match_jax_under_one_numpy_seed():
    rs = np.random.RandomState(5)
    image = rs.uniform(0, 255, (32, 32, 3)).astype(np.float32)
    for mode, fill in (("reflect", 0), ("constant", 7)):
        port = Compose([port_common.PIL2Opencv(),
                        port_common.TorchPad(4, fill, mode),
                        port_common.TorchRandomCrop(resize=32)])
        jax_t = JaxCompose([jax_common.PIL2Opencv(),
                            jax_common.TorchPad(4, fill, mode),
                            jax_common.TorchRandomCrop(resize=32)])
        for seed in range(4):
            np.random.seed(seed)
            got = port({"image": image.copy(), "label": 1})
            after = np.random.rand()
            np.random.seed(seed)
            want = jax_t({"image": image.copy(), "label": 1})
            assert np.random.rand() == after
            assert got["image"].shape == (32, 32, 3)
            np.testing.assert_array_equal(got["image"], want["image"])


def _cifar_pickles(root, n=10):
    rs = np.random.RandomState(9)
    c100 = root / "cifar-100-python"
    c10 = root / "cifar-10-batches-py"
    c100.mkdir(parents=True)
    c10.mkdir(parents=True)
    for name, count in (("train", n), ("test", n // 2)):
        with open(c100 / name, "wb") as f:
            pickle.dump({b"data": rs.randint(0, 256, (count, 3072)).astype(
                np.uint8), b"fine_labels": rs.randint(0, 100, count).tolist()},
                f)
    for name in ("data_batch_1", "data_batch_3", "test_batch"):
        with open(c10 / name, "wb") as f:
            pickle.dump({b"data": rs.randint(0, 256, (4, 3072)).astype(
                np.uint8), b"labels": rs.randint(0, 10, 4).tolist()}, f)


@pytest.mark.parametrize("name", ["cifar100", "cifar10"])
def test_cifar_readers_match_jax(tmp_path, name):
    _cifar_pickles(tmp_path)
    port_cls, jax_cls = {
        "cifar100": (cifar100dataset.CIFAR100Dataset,
                     jax_cifar100.CIFAR100Dataset),
        "cifar10": (cifar10dataset.CIFAR10Dataset,
                    jax_cifar10.CIFAR10Dataset)}[name]
    for set_name, n in (("train", 10 if name == "cifar100" else 8),
                        ("test", 5 if name == "cifar100" else 4)):
        port, want = port_cls(str(tmp_path), set_name), jax_cls(
            str(tmp_path), set_name)
        assert len(port) == len(want) == n
        for i in (0, n - 1):
            a, b = port[i], want[i]
            assert a["label"] == b["label"]
            assert a["image"].shape == (32, 32, 3)
            assert a["image"].dtype == np.float32
            np.testing.assert_array_equal(a["image"], b["image"])
    assert len(port_cls(str(tmp_path / "missing"), "train")) == 0


@pytest.mark.parametrize("tree", [IN21K_TREE, None])
def test_imagenet21k_tree_conversions_and_semantic_loss_match_jax(tmp_path,
                                                                   tree):
    write_in21k_root(tmp_path, tree)
    port = imagenet21kdataset.ImageNet21KSemanticTreeLabelDataset(
        str(tmp_path), "train")
    want = jax_in21k.ImageNet21KSemanticTreeLabelDataset(
        str(tmp_path), "train")
    assert port.max_hierarchy == want.max_hierarchy == (3 if tree else 1)
    assert port.normalization_factor_list == want.normalization_factor_list
    np.testing.assert_array_equal(port.semantic_label_table,
                                  want.semantic_label_table)
    for a, b in zip(port.hierarchy_class_lists, want.hierarchy_class_lists):
        np.testing.assert_array_equal(a, b)
    rs = np.random.RandomState(4)
    n_classes = len(port.class_tree_list)
    labels = rs.randint(0, n_classes, 16)
    np.testing.assert_array_equal(
        port.convert_single_labels_to_semantic_labels(labels),
        want.convert_single_labels_to_semantic_labels(labels))
    logits = rs.standard_normal((16, n_classes)).astype(np.float32) * 3
    port_levels = port.convert_outputs_to_semantic_outputs(
        torch.from_numpy(logits))
    jax_levels = want.convert_outputs_to_semantic_outputs(logits)
    for a, b in zip(port_levels, jax_levels):
        np.testing.assert_array_equal(a.numpy(), b)
    semantic = want.convert_single_labels_to_semantic_labels(labels)
    got = port_losses.SemanticSoftmaxLoss(port.normalization_factor_list)(
        port_levels, torch.from_numpy(semantic))
    expected = jax_losses.SemanticSoftmaxLoss(want.normalization_factor_list)(
        [jnp.asarray(x) for x in jax_levels], jnp.asarray(semantic))
    np.testing.assert_allclose(got.item(), float(expected), rtol=1e-6)
    sample = port[0]
    assert sample["image"].dtype == np.float32
    np.testing.assert_array_equal(sample["image"], want[0]["image"])
