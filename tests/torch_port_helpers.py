"""Shared helpers of the port's parity tests (tests/test_torch_port_*.py)."""

import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from simpleaicv_pytorch_training_examples_tpu.utils.optimizers import (
    leaf_path_names)


def random_flat(params, seed):
    """Flat flax params (or their shapes) -> O(1)-scale numpy values, so
    every layer matters in the output (flax's own init leaves the head at
    2e-5)."""
    rs = np.random.RandomState(seed)
    out = {}
    for name, leaf in zip(leaf_path_names(params),
                          jax.tree_util.tree_leaves(params)):
        shape = leaf.shape
        if name.endswith("scale"):
            a = 1.0 + 0.1 * rs.standard_normal(shape)
        elif name.endswith("bias"):
            a = 0.1 * rs.standard_normal(shape)
        elif name.endswith("kernel"):
            a = rs.standard_normal(shape) / np.sqrt(np.prod(shape[:-1]))
        else:  # cls token, position encoding
            a = 0.5 * rs.standard_normal(shape)
        out[name] = a.astype(np.float32)
    return out


def unflatten(flat):
    tree = {}
    for name, value in flat.items():
        node = tree
        *parents, leaf = name.split(".")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = jnp.asarray(value)
    return tree


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Torch's CPU ops on one intra-op thread for a test module that imports
    this fixture: the suite runs several worker processes at once, and more
    threads only contend for the same cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def drop_work_dir_configs():
    """The CLIs import a work dir's ``train_config.py`` / ``test_config.py``
    by module name from ``sys.path``; for a test module that imports this
    fixture, drop both after each test, so that a later test in the same
    process (another package's config importing ``train_config`` by name)
    does not find this test's."""
    path = list(sys.path)
    yield
    for name in ("train_config", "test_config"):
        sys.modules.pop(name, None)
    sys.path[:] = path


def seeded_jpeg(seed, h=240, w=320, quality=90):
    """JPEG bytes of a smooth seeded image with some grain, written by
    cv2."""
    import cv2

    rs = np.random.RandomState(seed)
    small = rs.uniform(0, 255, (6, 8, 3)).astype(np.float32)
    image = cv2.resize(small, (w, h), interpolation=cv2.INTER_CUBIC)
    image += rs.standard_normal(image.shape).astype(np.float32) * 8.0
    ok, data = cv2.imencode(".jpg", np.clip(image, 0, 255).astype(np.uint8),
                            [cv2.IMWRITE_JPEG_QUALITY, quality])
    assert ok
    return data.tobytes()


# an ImageNet-21K semantic tree: classes 0-1 at the root level, 2-5 under
# them, 6 two levels down
IN21K_TREE = [[0], [1], [0, 2], [0, 3], [1, 4], [1, 5], [1, 5, 6]]


def write_in21k_root(root, tree):
    """{train,val}/<wnid>/a.JPEG, one image a class (three classes without
    a tree), and the tree file where ``tree`` is given."""
    for set_name in ("train", "val"):
        for c in range(len(tree) if tree else 3):
            d = root / set_name / f"n1{c:02d}"
            d.mkdir(parents=True)
            (d / "a.JPEG").write_bytes(seeded_jpeg(200 + c, 64, 64))
    if tree:
        torch.save({"class_tree_list": tree,
                    "class_list": [f"n1{c:02d}" for c in range(len(tree))]},
                   root / "imagenet21k_miil_tree.pth")
