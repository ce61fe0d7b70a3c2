"""JAX-package parameters -> the port's ``state_dict``.

Maps the flat Flax parameter names of the JAX package (dotted paths, as its
``utils/checkpoint.py::flatten_params`` writes them) onto the port's torch
names. It is the inverse of the JAX package's torch-to-Flax ViT converter:
``patch_embedding`` -> ``patch_embed.proj``, ``position_encoding`` ->
``pos_embed``, ``block_{i}`` -> ``blocks.{i}``, ``kernel`` -> ``weight``
(HWIO -> OIHW for convolutions, [in, out] -> [out, in] for Dense), and a
norm's ``scale`` -> ``weight``. Names of submodules (``fc1.kernel``,
``attn.qkv.bias``, ...) map the same way, so a single block or layer loads
too. The optimizer's moments have their parameters' names and layouts, so
``optimizer_state_from_jax`` carries an AdamW or SGD state across through
the same map (the ViT's or the SAM's).

``sam_state_dict_from_jax`` does the same for SAM: it is the inverse of the
JAX package's ``convert_sam_state_dict`` (reference torch layout -> Flax),
and also undoes that converter's spatial flip of the ConvTranspose kernels
(Flax's ``ConvTranspose`` does not flip its kernel; torch's does).
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
    array = np.array(value)  # a writable copy
    if name.endswith(".kernel") or name == "kernel":
        if array.ndim == 2:          # Dense [in, out] -> Linear [out, in]
            array = array.T
        elif array.ndim == 4:        # Conv HWIO -> OIHW
            array = array.transpose(3, 2, 0, 1)
    return torch.from_numpy(np.ascontiguousarray(array))


def vit_state_dict_from_jax(flat: dict) -> dict:
    """{Flax dotted name: ndarray} -> {torch name: tensor} for the port."""
    return {_torch_name(name): _torch_value(name, value)
            for name, value in flat.items()}


def optimizer_state_from_jax(step, model="vit", **moments) -> dict:
    """The JAX package's optimizer state, as numpy arrays -> the state dict
    of the port's ``Optimizer``: ``step`` is the update count and each
    keyword (``mu`` and ``nu`` for AdamW, ``momentum_buf`` for SGD) a
    {Flax dotted name: ndarray} of one moment, mapped onto the port's names
    and layouts as the weights of ``model`` ("vit" or "sam") are."""
    to_torch = {"vit": vit_state_dict_from_jax,
                "sam": lambda flat: sam_state_dict_from_jax(flat, {})}[model]
    state = {"step": int(step)}
    for slot, flat in moments.items():
        state[slot] = to_torch(flat)
    return state


# the JAX package's SAM names -> the reference torch layout's
_SAM_RENAMES = tuple((re.compile(pattern), repl) for pattern, repl in (
    (r"^image_encoder\.block_(\d+)\.lin([12])\.",
     r"image_encoder.blocks.\1.mlp.lin\2."),
    (r"^image_encoder\.block_(\d+)\.", r"image_encoder.blocks.\1."),
    (r"^image_encoder\.patch_embedding\.",
     "image_encoder.patch_embed.proj."),
    (r"^image_encoder\.position_encoding$", "image_encoder.pos_embed"),
    (r"^image_encoder\.neck_conv1\.", "image_encoder.neck.0."),
    (r"^image_encoder\.neck_ln1\.", "image_encoder.neck.1."),
    (r"^image_encoder\.neck_conv2\.", "image_encoder.neck.2."),
    (r"^image_encoder\.neck_ln2\.", "image_encoder.neck.3."),
    (r"^prompt_encoder\.mask_conv1\.", "prompt_encoder.mask_downscaling.0."),
    (r"^prompt_encoder\.mask_ln1\.", "prompt_encoder.mask_downscaling.1."),
    (r"^prompt_encoder\.mask_conv2\.", "prompt_encoder.mask_downscaling.3."),
    (r"^prompt_encoder\.mask_ln2\.", "prompt_encoder.mask_downscaling.4."),
    (r"^prompt_encoder\.mask_conv3\.", "prompt_encoder.mask_downscaling.6."),
    (r"^prompt_encoder\.(not_a_point_embed|no_mask_embed)$",
     r"prompt_encoder.\1.weight"),
    (r"^mask_decoder\.(iou_token|mask_tokens)$", r"mask_decoder.\1.weight"),
    (r"^mask_decoder\.transformer\.layer_(\d+)\.mlp_lin([12])\.",
     r"mask_decoder.transformer.layers.\1.mlp.lin\2."),
    (r"^mask_decoder\.transformer\.layer_(\d+)\.",
     r"mask_decoder.transformer.layers.\1."),
    (r"^mask_decoder\.upscale_conv1\.", "mask_decoder.output_upscaling.0."),
    (r"^mask_decoder\.upscale_ln\.", "mask_decoder.output_upscaling.1."),
    (r"^mask_decoder\.upscale_conv2\.", "mask_decoder.output_upscaling.3."),
    (r"^mask_decoder\.hyper_mlp_(\d+)\.layer_(\d+)\.",
     r"mask_decoder.output_hypernetworks_mlps.\1.layers.\2."),
    (r"^mask_decoder\.iou_prediction_head\.layer_(\d+)\.",
     r"mask_decoder.iou_prediction_head.layers.\1."),
))
_SAM_CONV_TRANSPOSE = ("mask_decoder.upscale_conv1.kernel",
                       "mask_decoder.upscale_conv2.kernel")


def sam_state_dict_from_jax(params_flat: dict, constants_flat: dict) -> dict:
    """The JAX package's SAM parameters and constants ({Flax dotted name:
    ndarray}, as ``flatten_params`` names them) -> the port's SAM
    ``state_dict`` (the reference torch layout). ``point_embeddings [4, C]``
    becomes four ``nn.Embedding(1, C)`` weights; the Gaussian matrix of the
    position encoding comes from ``constants_flat``."""
    sd = {}
    for name, value in params_flat.items():
        array = np.array(value)
        if name == "prompt_encoder.point_embeddings":
            for i, row in enumerate(array):
                sd[f"prompt_encoder.point_embeddings.{i}.weight"] = \
                    torch.from_numpy(np.ascontiguousarray(row[None]))
            continue
        if name in _SAM_CONV_TRANSPOSE:  # [kh, kw, in, out], flipped
            array = array[::-1, ::-1].transpose(2, 3, 0, 1)
        elif name.endswith(".kernel") and array.ndim == 2:
            array = array.T
        elif name.endswith(".kernel") and array.ndim == 4:
            array = array.transpose(3, 2, 0, 1)
        torch_name = name
        for pattern, repl in _SAM_RENAMES:
            torch_name = pattern.sub(repl, torch_name)
        if torch_name.endswith((".kernel", ".scale")):
            torch_name = torch_name.rsplit(".", 1)[0] + ".weight"
        sd[torch_name] = torch.from_numpy(np.ascontiguousarray(array))
    for name, value in constants_flat.items():
        sd[name] = torch.from_numpy(np.array(value))
    return sd
