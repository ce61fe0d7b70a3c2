"""Torch checkpoints: name- and shape-filtered loading with a ViT
position-embedding resize for new input sizes, SAM checkpoints (whole or
encoder only), SAM2 checkpoints (Hiera heads zero-padded to the model's
``head_dim_padding``), and the train run's ``latest.pth`` / ``best.pth``
store.

Counterpart of the JAX package's ``utils/checkpoint.py``. The
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


def load_sam_checkpoint(model, path: str, logger=None):
    """A SAM ``.pth`` in the reference torch layout into the port's SAM: the
    whole model, or only its ``image_encoder.``-prefixed keys, name- and
    shape-filtered. Returns (num_loaded, num_total); raises if the file is
    missing."""
    saved = load_torch_state_dict(path)
    if saved is None:
        raise FileNotFoundError(f"no SAM checkpoint at {path!r}")
    return load_state_dict_filtered(model, saved, logger)


HIERA_HEAD_DIM = 56  # planes // heads at every Hiera stage


def pad_hiera_heads(sd: dict, head_dim_padding: int) -> dict:
    """Zero-pad the Hiera qkv and proj tensors of ``sd`` (a SAM2 state dict
    in the reference torch layout) whose heads are narrower than
    ``head_dim_padding``, as the JAX package's converter pads them: exact,
    since padded q and k columns add nothing to the scores and padded v
    columns meet zero proj columns. Heads already that wide pass as they
    are. Returns a new dict."""
    sd = dict(sd)
    suffix = ".attn.qkv.weight"
    for name in [n for n in sd if n.startswith("image_encoder.trunk.")
                 and n.endswith(suffix)]:
        prefix = name[:-len(".qkv.weight")]
        proj = sd[f"{prefix}.proj.weight"]              # [planes, nh * hd]
        nh = proj.shape[0] // HIERA_HEAD_DIM
        hd = proj.shape[1] // nh
        if hd >= head_dim_padding:
            continue
        pad = (0, head_dim_padding - hd)
        qkv = sd[name]
        sd[name] = torch.nn.functional.pad(
            qkv.reshape(3, nh, hd, -1).transpose(2, 3), pad).transpose(
                2, 3).reshape(3 * nh * head_dim_padding, -1)
        sd[f"{prefix}.qkv.bias"] = torch.nn.functional.pad(
            sd[f"{prefix}.qkv.bias"].reshape(3, nh, hd), pad).reshape(-1)
        sd[f"{prefix}.proj.weight"] = torch.nn.functional.pad(
            proj.reshape(-1, nh, hd), pad).reshape(proj.shape[0], -1)
    return sd


def load_sam2_checkpoint(model, path: str, logger=None):
    """A SAM2 ``.pth`` in the reference torch layout into the port's
    ``SAM2Video``, name- and shape-filtered, its Hiera heads zero-padded to
    the model's ``head_dim_padding`` (``pad_hiera_heads``). Keys the port does not have
    (``no_memory_position_encoder``, which the reference never reads) are
    skipped. Returns (num_loaded, num_total); raises if the file is
    missing."""
    saved = load_torch_state_dict(path)
    if saved is None:
        raise FileNotFoundError(f"no SAM2 checkpoint at {path!r}")
    return load_state_dict_filtered(
        model, pad_hiera_heads(saved, model.head_dim_padding), logger)


class CheckpointStore:
    """``latest.pth`` (everything a run needs to resume) and ``best.pth``
    (the weights to evaluate) under one checkpoint dir, as torch files.

    Counterpart of the JAX package's ``CheckpointStore``. Each file is
    written under a temporary name and renamed into place, so a run killed
    mid-write leaves the previous file whole.
    """

    def __init__(self, checkpoint_dir: str):
        self.dir = os.path.abspath(checkpoint_dir)
        os.makedirs(self.dir, exist_ok=True)
        self.latest_path = os.path.join(self.dir, "latest.pth")
        self.best_path = os.path.join(self.dir, "best.pth")

    @staticmethod
    def _save(payload: dict, path: str) -> None:
        tmp = f"{path}.tmp.{os.getpid()}"
        torch.save(payload, tmp)
        os.replace(tmp, path)

    def has_latest(self) -> bool:
        return os.path.exists(self.latest_path)

    def has_best(self) -> bool:
        return os.path.exists(self.best_path)

    def save_latest(self, payload: dict) -> None:
        """payload: model_state_dict, optimizer_state_dict, ema_state_dict
        (or None), epoch, best_acc, train_hours."""
        self._save(payload, self.latest_path)

    def restore_latest(self, device="cpu") -> dict:
        return torch.load(self.latest_path, map_location=device,
                          weights_only=False)

    def save_best(self, model_state_dict: dict) -> None:
        """Weights only, under the key the eval CLI's loader reads."""
        self._save({"model_state_dict": model_state_dict}, self.best_path)
