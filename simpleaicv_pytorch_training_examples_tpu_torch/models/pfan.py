"""PFAN dense-prediction family: a backbone's four feature maps through one
or two PFAN decoders to full resolution, NCHW.

Counterpart of the JAX package's ``models/pfan.py``: ``CPFE`` (a 1x1 and
three dilated 3x3 convolutions, concatenated and fused by a 3x3
ConvBnAct), ``ConvTransposeBnAct``, ``PFANDecoder`` (CPFE pyramids on C4
and C5, upsampled to C2, a low-level path on C2 and C3, concatenated,
reduced and brought up 4x by two 2x2 / 2 transposed convolutions),
``PFANSemanticSegmentation`` (``num_classes`` logits),
``PFANSegmentation`` (one sigmoid map), ``PFANMatting`` (a global 3-channel
sigmoid trimap, a local alpha whose decoder also takes the global path's
features, and their ``collaborative_matting`` fusion), and the
per-backbone factories (``make_pfan_factories``).

Module names are the JAX package's; ``ConvBnAct`` is the port's
(``layer.0`` the convolution, ``layer.1`` Flax's BatchNorm). The
transposed convolutions are torch's, whose kernel is the spatial flip of
Flax's ``ConvTranspose`` kernel (``utils/jax_weights.py`` flips it). The
bilinear resizes are ``jax.image.resize(..., "bilinear")``'s: half-pixel
centres, antialiased where they shrink (``resize_bilinear``). The heads'
prediction convolutions compute in fp32 (autocast off), as the JAX heads
do.
"""

import torch
import torch.nn.functional as F
from torch import nn

from .common import BatchNorm2d, Conv2d, ConvBnAct, ConvTranspose2d

__all__ = ["resize_bilinear", "PredConv", "CPFE",
           "ConvTransposeBnAct", "PFANDecoder", "PFANSemanticSegmentation",
           "PFANSegmentation", "PFANMatting", "collaborative_matting",
           "make_pfan_factories"]


def resize_bilinear(x, size):
    """``jax.image.resize(x, ..., "bilinear")`` of NCHW ``x`` to ``size``
    (h, w): half-pixel centres, the edge value at the border, antialiased
    where it shrinks."""
    if tuple(x.shape[-2:]) == tuple(size):
        return x
    shrink = size[0] < x.shape[-2] or size[1] < x.shape[-1]
    return F.interpolate(x, size, mode="bilinear", align_corners=False,
                         antialias=shrink)


class PredConv(Conv2d):
    """A head's 3x3 prediction convolution (with bias), fp32 with autocast
    off; the kernel starts from Flax's ``lecun_normal``."""

    def __init__(self, inplanes, planes):
        super().__init__(inplanes, planes, 3, 1, 1, init_std=(
            9 * inplanes) ** -0.5)

    def forward(self, x):
        with torch.autocast(x.device.type, enabled=False):
            return super().forward(x.float())


class CPFE(nn.Module):
    """Context-aware pyramid feature extraction: a 1x1 and three dilated 3x3
    convolutions (no bias), concatenated, then a 3x3 ConvBnAct."""

    def __init__(self, inplanes, planes=32, dilation_rate_list=(3, 5, 7),
                 dtype=torch.float32):
        super().__init__()
        self.dilation_rate_list = tuple(dilation_rate_list)
        self.conv_1_1 = Conv2d(inplanes, planes, 1, bias=False, dtype=dtype)
        for d in self.dilation_rate_list:
            setattr(self, f"conv_dil_{d}",
                    Conv2d(inplanes, planes, 3, 1, d, d, bias=False,
                           dtype=dtype))
        self.conv = ConvBnAct(planes * (1 + len(self.dilation_rate_list)),
                              planes, 3, 1, 1, dtype=dtype)

    def forward(self, x):
        outs = [self.conv_1_1(x)] + [getattr(self, f"conv_dil_{d}")(x)
                                     for d in self.dilation_rate_list]
        return self.conv(torch.cat(outs, dim=1))


class ConvTransposeBnAct(nn.Module):
    def __init__(self, inplanes, planes, kernel_size=2, stride=2,
                 has_act=True, dtype=torch.float32):
        super().__init__()
        self.deconv = ConvTranspose2d(inplanes, planes, kernel_size, stride,
                                      bias=False, dtype=dtype)
        self.bn = BatchNorm2d(planes, dtype=dtype)
        self.has_act = has_act

    def forward(self, x):
        x = self.bn(self.deconv(x))
        return F.relu(x) if self.has_act else x


class PFANDecoder(nn.Module):
    """One PFAN decoder path: (C2, C3, C4, C5) of ``in_planes`` channels ->
    (the full-resolution map, the high-level and the low-level features at
    C2's size). The matting local path also concatenates the global path's
    low- and high-level features (``extra_low_planes``,
    ``extra_high_planes``)."""

    def __init__(self, in_planes, cpfe_planes=32, extra_low_planes=0,
                 extra_high_planes=0, dtype=torch.float32):
        super().__init__()
        c1, c2, c3, c4 = in_planes
        p = cpfe_planes
        self.high_level_cpfe_4 = CPFE(c4, p, dtype=dtype)
        self.high_level_cpfe_3 = CPFE(c3, p, dtype=dtype)
        self.high_level_conv = ConvBnAct(2 * p, p, 1, 1, 0, has_act=False,
                                         dtype=dtype)
        self.low_level_conv_1 = ConvBnAct(c1, p, 3, 1, 1, dtype=dtype)
        self.low_level_conv_2 = ConvBnAct(c2, p, 3, 1, 1, dtype=dtype)
        self.low_level_conv = ConvBnAct(2 * p, p, 1, 1, 0, has_act=False,
                                        dtype=dtype)
        self.reduce_conv1 = ConvBnAct(
            2 * p + extra_low_planes + extra_high_planes, p, 1, 1, 0,
            has_act=False, dtype=dtype)
        self.upsample_conv1 = ConvTransposeBnAct(p, p, dtype=dtype)
        self.upsample_conv2 = ConvBnAct(p, p, 3, 1, 1, dtype=dtype)
        self.upsample_conv3 = ConvTransposeBnAct(p, p, dtype=dtype)

    def forward(self, feats, extra_high=None, extra_low=None):
        x1, x2, x3, x4 = feats
        size1 = x1.shape[-2:]
        x4_g = resize_bilinear(self.high_level_cpfe_4(x4), x3.shape[-2:])
        x3_g = self.high_level_cpfe_3(x3)
        high = self.high_level_conv(torch.cat([x3_g, x4_g], dim=1))
        high = resize_bilinear(high, size1)
        x1_g = self.low_level_conv_1(x1)
        x2_g = resize_bilinear(self.low_level_conv_2(x2), size1)
        low = self.low_level_conv(torch.cat([x1_g, x2_g], dim=1))
        cat = [low] + ([extra_low] if extra_low is not None else []) + \
            [high] + ([extra_high] if extra_high is not None else [])
        fused = self.reduce_conv1(torch.cat(cat, dim=1))
        fused = self.upsample_conv3(self.upsample_conv2(
            self.upsample_conv1(fused)))
        return fused, high, low


def _feature_planes(backbone):
    """Channels of the backbone's four feature maps."""
    planes = getattr(backbone, "out_channels", None)
    if planes is None:   # VAN: its stages' norms
        planes = [getattr(backbone, f"norm{i + 1}").weight.numel()
                  for i in range(len(backbone.block_nums))]
    return list(planes)


class _PFANBase(nn.Module):
    def __init__(self, backbone_type, backbone_pretrained_path="",
                 cpfe_planes=32, use_gradient_checkpoint=False,
                 dtype=torch.float32):
        super().__init__()
        from . import backbones
        self.backbone_type = backbone_type
        self.backbone_pretrained_path = backbone_pretrained_path
        self.cpfe_planes = cpfe_planes
        self.backbone = backbones.__dict__[backbone_type](
            dtype=dtype, use_gradient_checkpoint=use_gradient_checkpoint)
        for head in ("fc", "head"):   # the classifier: the JAX model has none
            if isinstance(getattr(self.backbone, head, None), nn.Module):
                delattr(self.backbone, head)
        self.in_planes = _feature_planes(self.backbone)

    def features(self, x):
        return self.backbone(x, return_features=True)


class PFANSemanticSegmentation(_PFANBase):
    def __init__(self, backbone_type, backbone_pretrained_path="",
                 cpfe_planes=32, num_classes=151,
                 use_gradient_checkpoint=False, dtype=torch.float32):
        super().__init__(backbone_type, backbone_pretrained_path,
                         cpfe_planes, use_gradient_checkpoint, dtype)
        self.decoder = PFANDecoder(self.in_planes, cpfe_planes, dtype=dtype)
        self.pred_conv = PredConv(cpfe_planes, num_classes)

    def forward(self, x):
        out, _, _ = self.decoder(self.features(x))
        return self.pred_conv(out)


class PFANSegmentation(_PFANBase):
    """Salient-object detection: one sigmoid map [B, 1, H, W]."""

    def __init__(self, backbone_type, backbone_pretrained_path="",
                 cpfe_planes=32, use_gradient_checkpoint=False,
                 dtype=torch.float32):
        super().__init__(backbone_type, backbone_pretrained_path,
                         cpfe_planes, use_gradient_checkpoint, dtype)
        self.decoder = PFANDecoder(self.in_planes, cpfe_planes, dtype=dtype)
        self.pred_conv = PredConv(cpfe_planes, 1)

    def forward(self, x):
        out, _, _ = self.decoder(self.features(x))
        return torch.sigmoid(self.pred_conv(out))


def collaborative_matting(global_pred, local_pred):
    """Trimap classes 0 background, 1 transition (the local alpha), 2
    foreground (1): global [B, 3, H, W], local [B, 1, H, W] -> fused [B, 1,
    H, W]."""
    max_cls = global_pred.argmax(dim=1, keepdim=True)
    trimap_mask = (max_cls == 1).to(local_pred.dtype)
    fg_mask = (max_cls == 2).to(local_pred.dtype)
    return local_pred * trimap_mask + fg_mask


class PFANMatting(_PFANBase):
    """Human matting: (global trimap [B, 3, H, W], local alpha [B, 1, H, W],
    fused alpha [B, 1, H, W]), each a sigmoid output."""

    def __init__(self, backbone_type, backbone_pretrained_path="",
                 cpfe_planes=32, use_gradient_checkpoint=False,
                 dtype=torch.float32):
        super().__init__(backbone_type, backbone_pretrained_path,
                         cpfe_planes, use_gradient_checkpoint, dtype)
        p = cpfe_planes
        self.global_decoder = PFANDecoder(self.in_planes, p, dtype=dtype)
        self.global_pred_conv = PredConv(p, 3)
        self.local_decoder = PFANDecoder(self.in_planes, p, extra_low_planes=p,
                                         extra_high_planes=p, dtype=dtype)
        self.local_pred_conv = PredConv(p, 1)

    collaborative_matting = staticmethod(collaborative_matting)

    def forward(self, x):
        feats = self.features(x)
        g_out, g_high, g_low = self.global_decoder(feats)
        global_pred = torch.sigmoid(self.global_pred_conv(g_out))
        l_out, _, _ = self.local_decoder(feats, extra_high=g_high,
                                         extra_low=g_low)
        local_pred = torch.sigmoid(self.local_pred_conv(l_out))
        return global_pred, local_pred, collaborative_matting(global_pred,
                                                              local_pred)


_BACKBONE_PLANES = {
    "resnet18": "resnet18", "resnet34": "resnet34", "resnet50": "resnet50",
    "resnet101": "resnet101", "resnet152": "resnet152",
    "vanb0": "van_b0", "vanb1": "van_b1", "vanb2": "van_b2",
    "vanb3": "van_b3",
    "convformers18": "convformer_s18", "convformers36": "convformer_s36",
    "convformerm36": "convformer_m36", "convformerb36": "convformer_b36",
    # DINOv3 ViT with the pyramid neck (the multi-scale backbone)
    "dinov3_vit_small_patch16": "dinov3_vit_small_patch16_det_backbone",
    "dinov3_vit_small_plus_patch16":
        "dinov3_vit_small_plus_patch16_det_backbone",
    "dinov3_vit_base_patch16": "dinov3_vit_base_patch16_det_backbone",
    "dinov3_vit_large_patch16": "dinov3_vit_large_patch16_det_backbone",
    "dinov3_vit_large_plus_patch16":
        "dinov3_vit_large_plus_patch16_det_backbone",
    "dinov3_vit_huge_plus_patch16":
        "dinov3_vit_huge_plus_patch16_det_backbone",
}


def make_pfan_factories(model_cls, suffix):
    """The per-backbone factories {"<short>_<suffix>": factory}."""
    out = {}
    for short, backbone in _BACKBONE_PLANES.items():
        def factory(backbone_pretrained_path="", _bb=backbone, **kwargs):
            return model_cls(backbone_type=_bb,
                             backbone_pretrained_path=backbone_pretrained_path,
                             **kwargs)
        out[f"{short}_{suffix}"] = factory
    return out
