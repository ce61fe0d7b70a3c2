"""Torch checkpoint import: name- and shape-filtered loading with a ViT
position-embedding resize for new input sizes.

Counterpart of the JAX package's ``utils/checkpoint.py`` load path. The
resize matches its ``jax.image.resize(..., "cubic")``: Keys' cubic kernel
with a = -0.5, antialiased (the kernel widened by the scale factor) when it
shrinks. ``F.interpolate(mode="bicubic")`` uses a = -0.75 and does not
antialias, so it would not give the JAX package's embeddings.
"""

import os
from typing import Optional

import numpy as np
import torch


def load_torch_state_dict(path: str) -> Optional[dict]:
    """Load a torch ``.pth`` state dict to {name: tensor} on the CPU; None if
    the path is empty or missing."""
    if not path or not os.path.exists(path):
        return None
    sd = torch.load(path, map_location="cpu", weights_only=False)
    if isinstance(sd, dict) and "model_state_dict" in sd:
        sd = sd["model_state_dict"]
    return {k: v for k, v in sd.items() if isinstance(v, torch.Tensor)}


def _keys_cubic(x):
    """Keys' cubic convolution kernel, a = -0.5, for x >= 0."""
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = torch.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return torch.where(x >= 2.0, torch.zeros_like(x), out)


def _resize_weights(in_size: int, out_size: int) -> torch.Tensor:
    """[in_size, out_size] interpolation weights of jax.image.resize's
    'cubic' method along one axis (scale out/in, no translation)."""
    inv_scale = in_size / out_size
    kernel_scale = max(inv_scale, 1.0)  # widen the kernel when shrinking
    sample = (torch.arange(out_size, dtype=torch.float64) + 0.5) \
        * inv_scale - 0.5
    x = (sample[None, :] - torch.arange(in_size, dtype=torch.float64)[:, None]
         ).abs() / kernel_scale
    weights = _keys_cubic(x)
    total = weights.sum(dim=0, keepdim=True)
    eps = 1000.0 * float(np.finfo(np.float32).eps)
    weights = torch.where(total.abs() > eps,
                          weights / torch.where(total != 0, total, 1.0),
                          torch.zeros_like(weights))
    inside = (sample >= -0.5) & (sample <= in_size - 0.5)
    return torch.where(inside[None, :], weights, torch.zeros_like(weights))


def resize_position_embedding(src: torch.Tensor, dst_shape) -> torch.Tensor:
    """Bicubic 2-D resize of a ViT pos-embed [1, N(+1), C] to dst_shape's
    token count; a leading cls token (token count not a square) is kept."""
    n_src = src.shape[1]
    cls_tok = None
    side = int(round(n_src ** 0.5))
    if side * side != n_src:
        cls_tok, src = src[:, :1], src[:, 1:]
        n_src -= 1
        side = int(round(n_src ** 0.5))
    n_dst = dst_shape[1]
    dst_side = int(round(n_dst ** 0.5))
    take_cls = dst_side * dst_side != n_dst
    if take_cls:
        dst_side = int(round((n_dst - 1) ** 0.5))
    c = src.shape[-1]
    grid = src.reshape(side, side, c).double()
    if dst_side != side:
        w = _resize_weights(side, dst_side)
        grid = torch.einsum("hwc,hH,wW->HWc", grid, w, w)
    out = grid.reshape(1, dst_side * dst_side, c).to(src.dtype)
    if take_cls and cls_tok is not None:
        out = torch.cat([cls_tok, out], dim=1)
    return out


def load_state_dict_filtered(model, saved: dict, logger=None):
    """Load the entries of ``saved`` whose name and shape match the model;
    a ``pos_embed`` of another token count is resized. Returns
    (num_loaded, num_total)."""
    state = model.state_dict()
    loaded = 0
    for name, current in state.items():
        if name not in saved:
            continue
        src = saved[name]
        if tuple(src.shape) == tuple(current.shape):
            state[name] = src.to(current.dtype)
            loaded += 1
            continue
        if "pos_embed" in name and src.ndim == 3 and current.ndim == 3 \
                and src.shape[-1] == current.shape[-1]:
            resized = resize_position_embedding(src, current.shape)
            if tuple(resized.shape) == tuple(current.shape):
                state[name] = resized.to(current.dtype)
                loaded += 1
                if logger:
                    logger.info(f"resized position embedding {name}: "
                                f"{tuple(src.shape)} -> {tuple(current.shape)}")
                continue
        if logger:
            logger.info(f"skip {name}: shape {tuple(src.shape)} != "
                        f"{tuple(current.shape)}")
    model.load_state_dict(state)
    return loaded, len(state)
