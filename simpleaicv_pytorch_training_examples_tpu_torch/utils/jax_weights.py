"""JAX-package parameters -> the port's ``state_dict``.

Maps the flat flax parameter names of the JAX package (dotted paths, as its
``utils/checkpoint.py::flatten_params`` writes them) onto the port's torch
names. It is the inverse of the JAX package's torch->flax ViT converter:
``patch_embedding`` -> ``patch_embed.proj``, ``position_encoding`` ->
``pos_embed``, ``block_{i}`` -> ``blocks.{i}``, ``kernel`` -> ``weight``
(HWIO -> OIHW for convolutions, [in, out] -> [out, in] for Dense), and a
norm's ``scale`` -> ``weight``. Names of submodules (``fc1.kernel``,
``attn.qkv.bias``, ...) map the same way, so a single block or layer loads
too.
"""

import re

import numpy as np
import torch

_BLOCK = re.compile(r"^block_(\d+)$")
_MODULE_RENAMES = {"patch_embedding": "patch_embed.proj",
                   "position_encoding": "pos_embed"}


def _torch_name(name: str) -> str:
    parts = []
    for part in name.split("."):
        match = _BLOCK.match(part)
        if match:
            parts += ["blocks", match.group(1)]
        else:
            parts.append(_MODULE_RENAMES.get(part, part))
    if parts[-1] in ("kernel", "scale"):
        parts[-1] = "weight"
    return ".".join(parts)


def _torch_value(name: str, value) -> torch.Tensor:
    array = np.asarray(value)
    if name.endswith(".kernel") or name == "kernel":
        if array.ndim == 2:          # Dense [in, out] -> Linear [out, in]
            array = array.T
        elif array.ndim == 4:        # Conv HWIO -> OIHW
            array = array.transpose(3, 2, 0, 1)
    return torch.from_numpy(np.ascontiguousarray(array))


def vit_state_dict_from_jax(flat: dict) -> dict:
    """{flax dotted name: ndarray} -> {torch name: tensor} for the port."""
    return {_torch_name(name): _torch_value(name, value)
            for name, value in flat.items()}
