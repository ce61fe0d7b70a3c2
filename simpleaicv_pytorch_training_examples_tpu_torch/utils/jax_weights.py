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
the same map (the ViT's, the SAM's or the SAM2's).

``resnet_state_dict_from_jax`` maps a ResNet's parameters and batch
statistics onto the reference torch ResNet's names (the inverse of the JAX
package's ``convert_resnet_state_dict``): ``stem`` -> ``conv1``,
``layer{s}_{i}`` -> ``layer{s}.{i}``, ``downsample`` -> ``downsample_conv``,
``conv.kernel`` -> ``layer.0.weight`` (HWIO -> OIHW), ``bn.scale`` /
``bn.bias`` -> ``layer.1.weight`` / ``layer.1.bias``, the batch statistics'
``bn.mean`` / ``bn.var`` -> ``layer.1.running_mean`` / ``running_var``.

``vit_mae_state_dict_from_jax`` maps the MAE pretraining model (the
encoder's and the decoder's blocks by the ViT's rules, under ``encoder.``
and ``decoder.``). ``kd_state_dict_from_jax`` maps a distillation model's
two ResNets, parameters and batch statistics, under ``teacher.`` and
``student.``.

``sam_state_dict_from_jax`` does the same for SAM: it is the inverse of the
JAX package's ``convert_sam_state_dict`` (reference torch layout -> Flax),
and also undoes that converter's spatial flip of the ConvTranspose kernels
(Flax's ``ConvTranspose`` does not flip its kernel; torch's does).
``sam2_state_dict_from_jax`` is the inverse of ``convert_sam2_state_dict``
for SAM2's video model, with the same flip.
"""

import re

import numpy as np
import torch

from .checkpoint import pad_hiera_heads

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


def optimizer_state_from_jax(step, model="vit", head_dim_padding=0,
                             **moments) -> dict:
    """The JAX package's optimizer state, as numpy arrays -> the state dict
    of the port's ``Optimizer``: ``step`` is the update count and each
    keyword (``mu`` and ``nu`` for AdamW, ``momentum_buf`` for SGD,
    ``muon_buf``, ``mu`` and ``nu`` for Muon) a {Flax dotted name: ndarray}
    of one moment, mapped onto the port's names and layouts as the weights
    of ``model`` ("vit", "vit_mae", "resnet", "kd", "sam" or "sam2") are;
    for "sam2", ``head_dim_padding`` is the port model's, and moments of
    narrower Hiera heads are zero-padded as their weights are."""
    to_torch = {"vit": vit_state_dict_from_jax,
                "vit_mae": vit_mae_state_dict_from_jax,
                "resnet": lambda flat: resnet_state_dict_from_jax(flat, {}),
                "kd": lambda flat: kd_state_dict_from_jax(flat, {}),
                "sam": lambda flat: sam_state_dict_from_jax(flat, {}),
                "sam2": lambda flat: sam2_state_dict_from_jax(
                    flat, {}, head_dim_padding)}[model]
    state = {"step": int(step)}
    for slot, flat in moments.items():
        state[slot] = to_torch(flat)
    return state


_RESNET_MODULE = re.compile(r"^layer(\d)_(\d+)\.")
_RESNET_LEAVES = {"conv.kernel": "layer.0.weight", "conv.bias": "layer.0.bias",
                  "bn.scale": "layer.1.weight", "bn.bias": "layer.1.bias",
                  "bn.mean": "layer.1.running_mean",
                  "bn.var": "layer.1.running_var"}


def _resnet_name(name: str) -> str:
    if name.startswith("fc."):
        return "fc.weight" if name == "fc.kernel" else name
    name = _RESNET_MODULE.sub(r"layer\1.\2.", name)
    name = re.sub(r"^stem\.", "conv1.", name)
    name = name.replace(".downsample.", ".downsample_conv.")
    parts = name.split(".")
    return ".".join(parts[:-2] + [_RESNET_LEAVES[".".join(parts[-2:])]])


def resnet_state_dict_from_jax(params_flat: dict,
                               batch_stats_flat: dict) -> dict:
    """A JAX ResNet's (or CIFAR ResNet's) parameters and batch statistics
    ({Flax dotted name: ndarray}) -> the port's ResNet ``state_dict``; every
    BatchNorm whose statistics are given also gets ``num_batches_tracked``
    (0: the JAX package does not count batches)."""
    sd = {}
    for name, value in {**params_flat, **batch_stats_flat}.items():
        sd[_resnet_name(name)] = _torch_value(name, value)
        if name.endswith(".bn.mean"):
            sd[_resnet_name(name).replace("running_mean",
                                          "num_batches_tracked")] = \
                torch.zeros((), dtype=torch.long)
    return sd


def vit_mae_state_dict_from_jax(flat: dict) -> dict:
    """The JAX package's MAE pretraining model ({Flax dotted name: ndarray})
    -> the port's ``VITMAEPretrainModel`` state_dict: ``encoder.`` and
    ``decoder.`` names map by the ViT's rules (``patch_embedding``,
    ``block_{i}``, ``kernel``, ``scale``); ``cls_token`` and ``mask_token``
    keep their names and shapes."""
    return vit_state_dict_from_jax(flat)


def kd_state_dict_from_jax(params_flat: dict, batch_stats_flat: dict) -> dict:
    """A JAX ``KDModel``'s parameters and batch statistics -> the port's
    ``KDModel`` state_dict: each of ``teacher.`` and ``student.`` through
    ``resnet_state_dict_from_jax``."""
    sd = {}
    for prefix in ("teacher.", "student."):
        part = lambda flat: {k[len(prefix):]: v for k, v in flat.items()
                             if k.startswith(prefix)}
        sd.update({prefix + k: v for k, v in resnet_state_dict_from_jax(
            part(params_flat), part(batch_stats_flat)).items()})
    return sd


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


# the JAX package's SAM2 names -> the reference torch layout's (the prompt
# encoder's and most of the mask decoder's follow SAM's rules above)
_SAM2_RENAMES = tuple((re.compile(pattern), repl) for pattern, repl in (
    (r"^image_encoder\.trunk\.patch_embed\.",
     "image_encoder.trunk.patch_embed.proj."),
    (r"^image_encoder\.trunk\.block_(\d+)\.mlp([12])\.",
     lambda m: f"image_encoder.trunk.blocks.{m[1]}.mlp.layers."
               f"{int(m[2]) - 1}."),
    (r"^image_encoder\.trunk\.block_(\d+)\.",
     r"image_encoder.trunk.blocks.\1."),
    (r"^image_encoder\.conv(\d)\.", r"image_encoder.neck.convs.\1.conv."),
    (r"^mask_decoder\.obj_score_token$",
     "mask_decoder.obj_score_token.weight"),
    (r"^mask_decoder\.transformer\.layer_(\d+)\.mlp_lin([12])\.",
     lambda m: f"mask_decoder.transformer.layers.{m[1]}.mlp.layers."
               f"{int(m[2]) - 1}."),
    (r"^mask_decoder\.pred_obj_score_head\.layer_(\d+)\.",
     r"mask_decoder.pred_obj_score_head.layers.\1."),
    (r"^memory_attention\.layer_(\d+)\.", r"memory_attention.layers.\1."),
    (r"^memory_encoder\.mask_down_(\d)\.",
     lambda m: f"memory_encoder.mask_downsampler.encoder.{3 * int(m[1])}."),
    (r"^memory_encoder\.mask_down_ln_(\d)\.",
     lambda m: f"memory_encoder.mask_downsampler.encoder."
               f"{3 * int(m[1]) + 1}."),
    (r"^memory_encoder\.mask_down_out\.",
     "memory_encoder.mask_downsampler.encoder.12."),
    (r"^memory_encoder\.fuser_(\d+)\.", r"memory_encoder.fuser.layers.\1."),
    (r"^object_pointer_projection\.layer_(\d+)\.",
     r"object_pointer_projection.layers.\1."),
    (r"^mask_downsample_(kernel|bias)$", r"mask_downsample.\1"),
))
# reference shapes of the embeddings the JAX model keeps flat
_SAM2_RESHAPE = {
    "mask_memory_time_position_encoder": lambda a: a[:, None, None],
    "no_memory_embedding": lambda a: a[None]}
def sam2_state_dict_from_jax(params_flat: dict, constants_flat: dict,
                             head_dim_padding: int = 0) -> dict:
    """The JAX package's SAM2 video-model parameters and constants ({Flax
    dotted name: ndarray}) -> the port's ``SAM2Video`` state_dict (the
    reference torch layout). SAM2's own names are renamed here, keeping
    their ``.kernel``/``.scale`` suffixes, and everything then goes through
    ``sam_state_dict_from_jax``'s layout rules (the prompt encoder and SAM's
    part of the mask decoder by its renames). ``head_dim_padding`` is the
    port model's: Hiera heads narrower than it are zero-padded, as the JAX
    package's converter pads a reference checkpoint; heads already that
    wide (a JAX model built with the same ``head_dim_padding``, whose pads
    training may have filled) are carried as they are."""
    sd, renamed = {}, {}
    for name, value in params_flat.items():
        array = np.array(value)
        if name in ("image_encoder.trunk.pos_embed",
                    "image_encoder.trunk.pos_embed_window"):   # NHWC -> NCHW
            sd[name] = torch.from_numpy(np.ascontiguousarray(
                array.transpose(0, 3, 1, 2)))
        elif name in _SAM2_RESHAPE:
            sd[name] = torch.from_numpy(np.ascontiguousarray(
                _SAM2_RESHAPE[name](array)))
        else:
            for pattern, repl in _SAM2_RENAMES:
                name = pattern.sub(repl, name)
            renamed[name] = array
    sd.update(sam_state_dict_from_jax(renamed, constants_flat))
    return pad_hiera_heads(sd, head_dim_padding)


# --- DarkNet, VAN, ConvFormer, DINOv3 ConvNeXt and ViT ---------------------
#
# Each map renames the JAX package's module paths (regex rules, applied in
# turn) and its leaves (``kernel`` / ``scale`` -> ``weight``, BatchNorm's
# ``mean`` / ``var`` -> ``running_mean`` / ``running_var``, with a
# ``num_batches_tracked`` of 0 beside each), and lays the kernels out as
# torch does (Dense [in, out] -> [out, in], Conv HWIO -> OIHW, depth-wise
# [k, k, 1, C] -> [C, 1, k, k]). The VAN, ConvFormer and DINOv3 maps are the
# inverses of the JAX package's ``convert_{van,convformer,dinov3_convnext,
# dinov3_vit}_state_dict``; DarkNet has no such converter, so its torch
# names are the JAX module paths in ``ConvBnAct``'s layout.

_LEAF_RENAMES = {"kernel": "weight", "scale": "weight",
                 "mean": "running_mean", "var": "running_var"}


def _mapped_state_dict(flat: dict, rules, conv_transpose=()) -> dict:
    """{Flax dotted name: ndarray} -> {torch name: tensor} by ``rules``
    ((compiled pattern, replacement), ...); names in ``conv_transpose`` are
    Flax ConvTranspose kernels, flipped spatially for torch."""
    sd = {}
    for name, value in flat.items():
        if name in conv_transpose:   # [kh, kw, in, out], flipped
            tensor = torch.from_numpy(np.ascontiguousarray(
                np.array(value)[::-1, ::-1].transpose(2, 3, 0, 1)))
        else:
            tensor = _torch_value(name, value)
        torch_name = name
        for pattern, repl in rules:
            torch_name = pattern.sub(repl, torch_name)
        parts = torch_name.split(".")
        parts[-1] = _LEAF_RENAMES.get(parts[-1], parts[-1])
        torch_name = ".".join(parts)
        sd[torch_name] = tensor
        if parts[-1] == "running_mean":
            sd[torch_name.replace("running_mean", "num_batches_tracked")] = \
                torch.zeros((), dtype=torch.long)
    return sd


def _rules(*pairs):
    return tuple((re.compile(p), r) for p, r in pairs)


# ConvBnAct's conv and bn -> layer.0 / layer.1
_CONV_BN_RULES = (
    (r"\.conv\.(kernel|bias)$", r".layer.0.\1"),
    (r"\.bn\.(scale|bias|mean|var)$", r".layer.1.\1"),
)
_DARKNET_RULES = _rules(*_CONV_BN_RULES)


def darknet_state_dict_from_jax(params_flat: dict,
                                batch_stats_flat: dict) -> dict:
    """A JAX DarkNet's parameters and batch statistics -> the port's
    ``darknettiny`` / ``darknet19`` / ``darknet53`` state_dict."""
    return _mapped_state_dict({**params_flat, **batch_stats_flat},
                              _DARKNET_RULES)


_VAN_RULES = _rules(
    (r"^patch_embed(\d+)\.", r"patch_embed\1.proj."),
    (r"^patch_norm(\d+)\.", r"patch_embed\1.norm."),
    (r"^block(\d+)_(\d+)\.", r"block\1.\2."),
    (r"\.mlp\.dwconv\.", ".mlp.dwconv.dwconv."),
)


def van_state_dict_from_jax(params_flat: dict, batch_stats_flat: dict) -> dict:
    """A JAX VAN's parameters and batch statistics -> the port's VAN
    state_dict (the inverse of ``convert_van_state_dict``)."""
    return _mapped_state_dict({**params_flat, **batch_stats_flat},
                              _VAN_RULES)


def _convformer_stage(match):
    return f"stages.{int(match.group(1)) - 1}.{match.group(2)}."


_CONVFORMER_RULES = _rules(
    (r"^downsample_postnorm0\.", "downsample_layers.0.post_norm."),
    (r"^downsample_prenorm(\d+)\.", r"downsample_layers.\1.pre_norm."),
    (r"^downsample(\d+)\.", r"downsample_layers.\1.conv."),
) + ((re.compile(r"^block(\d+)_(\d+)\."), _convformer_stage),)


def convformer_state_dict_from_jax(params_flat: dict,
                                   batch_stats_flat: dict) -> dict:
    """A JAX ConvFormer's parameters and batch statistics -> the port's
    ConvFormer state_dict (the inverse of
    ``convert_convformer_state_dict``)."""
    return _mapped_state_dict({**params_flat, **batch_stats_flat},
                              _CONVFORMER_RULES)


_CONVNEXT_RULES = _rules(
    (r"^stem_conv\.", "downsample_layers.0.0."),
    (r"^stem_norm\.", "downsample_layers.0.1."),
    (r"^downsample(\d+)_norm\.", r"downsample_layers.\1.0."),
    (r"^downsample(\d+)_conv\.", r"downsample_layers.\1.1."),
    (r"^stage(\d+)_block(\d+)\.", r"stages.\1.\2."),
)


def dinov3_convnext_state_dict_from_jax(params_flat: dict) -> dict:
    """A JAX DINOv3 ConvNeXt's parameters -> the port's state_dict (the
    inverse of ``convert_dinov3_convnext_state_dict``; LayerNorms only, no
    batch statistics)."""
    return _mapped_state_dict(params_flat, _CONVNEXT_RULES)


_DINOV3_VIT_RULES = _rules(
    (r"(^|\.)patch_embedding\.", r"\1patch_embed.proj."),
    (r"(^|\.)block_(\d+)\.", r"\1blocks.\2."),
    (r"\.mlp_fc([12])\.", r".mlp.fc\1."),
    (r"\.swiglu\.(w[123])\.", r".mlp.\1."),
)
_DINOV3_NECK_TRANSPOSED = ("neck.p2_up1.kernel", "neck.p2_up2.kernel",
                           "neck.p3_up.kernel")


def dinov3_vit_state_dict_from_jax(params_flat: dict) -> dict:
    """A JAX DINOv3 ViT's parameters (``DinoVisionTransformer``, or a
    ``DINOv3MultiScaleBackbone``'s ``vit.`` and ``neck.``) -> the port's
    state_dict (for the ViT, the inverse of
    ``convert_dinov3_vit_state_dict``): SwiGLU's fused ``w12`` splits into
    ``w1`` and ``w2``, the neck's ConvTranspose kernels are flipped."""
    flat = {}
    for name, value in params_flat.items():
        match = re.match(r"^(.*)\.swiglu\.w12\.(kernel|bias)$", name)
        if match is None:
            flat[name] = value
            continue
        for w, part in zip(("w1", "w2"),
                           np.split(np.array(value), 2, axis=-1)):
            flat[f"{match.group(1)}.swiglu.{w}.{match.group(2)}"] = part
    return _mapped_state_dict(flat, _DINOV3_VIT_RULES,
                              conv_transpose=_DINOV3_NECK_TRANSPOSED)
