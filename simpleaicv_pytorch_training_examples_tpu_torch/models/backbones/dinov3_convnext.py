"""DINOv3 ConvNeXt detection backbones (tiny/small/base/large): NCHW images
in, the four stage maps (strides 4/8/16/32) out.

Counterpart of the JAX package's ``models/backbones/dinov3_convnext.py``:
a 4x4 / 4 stem conv and a channel LayerNorm, per stage a channel LayerNorm
and a 2x2 / 2 conv (after the first), ConvNeXt blocks (depth-wise 7x7,
LayerNorm, pointwise 4x, exact-erf GELU, pointwise back, layer scale
``gamma`` starting at 1e-6, drop path, residual). Every LayerNorm has
epsilon 1e-6, fp32 statistics and its output in ``dtype``.

Parameter names are the reference torch ConvNeXt's, so that
``utils/torch_convert.convert_dinov3_convnext_state_dict`` maps them onto
the JAX package's: ``downsample_layers.0.{0 conv,1 norm}``,
``downsample_layers.{i}.{0 norm,1 conv}``, ``stages.{i}.{j}.{dwconv,norm,
pwconv1,pwconv2,gamma}``. The norms and pointwise layers run on a
channels-last view (free on CUDA, whose activations are channels_last).
"""

import torch
import torch.nn.functional as F
from torch import nn

from ..common import (Conv2d, DropPath, FusedLayerNorm, Linear,
                      drop_path_rates, remat_call)

__all__ = [
    "dinov3convnexttinybackbone",
    "dinov3convnextsmallbackbone",
    "dinov3convnextbasebackbone",
    "dinov3convnextlargebackbone",
    "Dinov3ConvNeXtBackbone",
]

_LN_EPS = 1e-6


class ChannelLayerNorm(FusedLayerNorm):
    """LayerNorm over the channels of an NCHW map."""

    def forward(self, x):
        return super().forward(x.permute(0, 2, 3, 1)).permute(0, 3, 1, 2)


class ConvNeXtBlock(nn.Module):
    """dw7x7 -> LN -> pw 4x -> GELU -> pw -> gamma -> drop-path residual."""

    def __init__(self, planes, drop_path_prob=0.0, dtype=torch.float32):
        super().__init__()
        self.dwconv = Conv2d(planes, planes, 7, padding=3, groups=planes,
                             dtype=dtype, init_std=0.02)
        self.norm = FusedLayerNorm(planes, _LN_EPS, dtype)
        self.pwconv1 = Linear(planes, 4 * planes, dtype)
        self.pwconv2 = Linear(4 * planes, planes, dtype)
        self.gamma = nn.Parameter(torch.full((planes,), 1e-6))
        self.drop_path = DropPath(drop_path_prob)

    def init_weights_(self, generator):
        nn.init.constant_(self.gamma, 1e-6)

    def forward(self, x):
        h = self.dwconv(x).permute(0, 2, 3, 1)
        h = self.pwconv2(F.gelu(self.pwconv1(self.norm(h))))
        h = (self.gamma.to(h.dtype) * h).permute(0, 3, 1, 2)
        return x + self.drop_path(h)


class Dinov3ConvNeXtBackbone(nn.Module):

    def __init__(self, embedding_planes=(96, 192, 384, 768),
                 block_nums=(3, 3, 9, 3), drop_path_prob=0.0,
                 use_gradient_checkpoint=False, dtype=torch.float32):
        super().__init__()
        self.embedding_planes = list(embedding_planes)
        self.use_gradient_checkpoint = use_gradient_checkpoint
        dprs = drop_path_rates(drop_path_prob, sum(block_nums))
        downsample, stages, inplanes, idx = [], [], 3, 0
        for i, (planes, n_blocks) in enumerate(zip(embedding_planes,
                                                   block_nums)):
            if i == 0:
                downsample.append(nn.Sequential(
                    Conv2d(3, planes, 4, 4, dtype=dtype, init_std=0.02),
                    ChannelLayerNorm(planes, _LN_EPS, dtype)))
            else:
                downsample.append(nn.Sequential(
                    ChannelLayerNorm(inplanes, _LN_EPS, dtype),
                    Conv2d(inplanes, planes, 2, 2, dtype=dtype,
                           init_std=0.02)))
            stages.append(nn.Sequential(*[
                ConvNeXtBlock(planes, dprs[idx + j], dtype)
                for j in range(n_blocks)]))
            inplanes, idx = planes, idx + n_blocks
        self.downsample_layers = nn.ModuleList(downsample)
        self.stages = nn.ModuleList(stages)

    @property
    def out_channels(self):
        return list(self.embedding_planes)

    def forward(self, x, return_features=True):
        if x.is_cuda:
            x = x.contiguous(memory_format=torch.channels_last)
        remat = self.use_gradient_checkpoint and torch.is_grad_enabled()
        outs = []
        for down, stage in zip(self.downsample_layers, self.stages):
            x = down(x)
            for block in stage:
                x = remat_call(block, x) if remat else block(x)
            outs.append(x.contiguous())
        return outs if return_features else outs[-1]


def dinov3convnexttinybackbone(pretrained_path="", **kwargs):
    return Dinov3ConvNeXtBackbone(embedding_planes=(96, 192, 384, 768),
                                  block_nums=(3, 3, 9, 3), **kwargs)


def dinov3convnextsmallbackbone(pretrained_path="", **kwargs):
    return Dinov3ConvNeXtBackbone(embedding_planes=(96, 192, 384, 768),
                                  block_nums=(3, 3, 27, 3), **kwargs)


def dinov3convnextbasebackbone(pretrained_path="", **kwargs):
    return Dinov3ConvNeXtBackbone(embedding_planes=(128, 256, 512, 1024),
                                  block_nums=(3, 3, 27, 3), **kwargs)


def dinov3convnextlargebackbone(pretrained_path="", **kwargs):
    return Dinov3ConvNeXtBackbone(embedding_planes=(192, 384, 768, 1536),
                                  block_nums=(3, 3, 27, 3), **kwargs)
