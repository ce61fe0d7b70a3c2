"""Shared helpers of the port's parity tests (tests/test_torch_port_*.py)."""

import jax
import jax.numpy as jnp
import numpy as np

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
