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
