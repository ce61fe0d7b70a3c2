"""ConvFormer (MetaFormer with the SepConv mixer) s18/s36/m36/b36: NCHW
images in, logits or four stage maps out.

Counterpart of the JAX package's ``models/backbones/convformer.py``: four
stages of strided-conv downsampling (7x7 / 4 with padding 2 and a
BatchNorm after it; then a BatchNorm before a 3x3 / 2) and MetaFormer
blocks [BatchNorm -> SepConv -> residual, BatchNorm -> MLP -> residual].
SepConv is a pointwise Dense with no bias, ReLU, a depth-wise 7x7 with no
bias and a pointwise Dense; the MLP two Dense layers with no bias around a
ReLU. Drop path grows linearly over all blocks. BatchNorm statistics are the
global batch's in a process group.

The pointwise layers are ``Linear`` over the channels of a channels-last
view (on CUDA the activations are channels_last, so the view is free).
Parameter names are the reference torch ConvFormer's, so that
``utils/torch_convert.convert_convformer_state_dict`` maps them onto the
JAX package's: ``downsample_layers.{i}.{conv,pre_norm,post_norm}``,
``stages.{s}.{j}.{norm1,token_mixer.{pwconv1,dwconv,pwconv2},norm2,
mlp.{fc1,fc2}}``, ``head``. ``forward(x, return_features=True)`` returns
the four stages' outputs, NCHW.
"""

import torch
import torch.nn.functional as F
from torch import nn

from ..common import (BatchNorm2d, Conv2d, Dropout, DropPath, Linear,
                      avg_pool_global, drop_path_rates, remat_call)

__all__ = ["convformer_s18", "convformer_s36", "convformer_m36",
           "convformer_b36"]


def channels_last_linear(layer, x):
    """A ``Linear`` over the channel dim of NCHW ``x``."""
    return layer(x.permute(0, 2, 3, 1)).permute(0, 3, 1, 2)


class SepConv(nn.Module):
    """pw-Linear expand -> ReLU -> DW 7x7 -> pw-Linear project."""

    def __init__(self, planes, expand_ratio=2.0, dtype=torch.float32):
        super().__init__()
        mid = int(expand_ratio * planes)
        self.pwconv1 = Linear(planes, mid, dtype, bias=False)
        self.dwconv = Conv2d(mid, mid, 7, padding=3, groups=mid, bias=False,
                             dtype=dtype, init_std=0.02)
        self.pwconv2 = Linear(mid, planes, dtype, bias=False)

    def forward(self, x):
        x = F.relu(channels_last_linear(self.pwconv1, x))
        return channels_last_linear(self.pwconv2, self.dwconv(x))


class ConvFormerMlp(nn.Module):

    def __init__(self, planes, mlp_ratio=4.0, dropout_prob=0.0,
                 dtype=torch.float32):
        super().__init__()
        self.fc1 = Linear(planes, int(planes * mlp_ratio), dtype, bias=False)
        self.fc2 = Linear(int(planes * mlp_ratio), planes, dtype, bias=False)
        self.drop = Dropout(dropout_prob)

    def forward(self, x):
        x = self.drop(F.relu(channels_last_linear(self.fc1, x)))
        return self.drop(channels_last_linear(self.fc2, x))


class MetaFormerBlock(nn.Module):

    def __init__(self, planes, dropout_prob=0.0, drop_path_prob=0.0,
                 dtype=torch.float32):
        super().__init__()
        self.norm1 = BatchNorm2d(planes, dtype=dtype)
        self.token_mixer = SepConv(planes, 2.0, dtype)
        self.norm2 = BatchNorm2d(planes, dtype=dtype)
        self.mlp = ConvFormerMlp(planes, 4.0, dropout_prob, dtype)
        self.drop_path = DropPath(drop_path_prob)

    def forward(self, x):
        x = x + self.drop_path(self.token_mixer(self.norm1(x)))
        return x + self.drop_path(self.mlp(self.norm2(x)))


class _Downsample(nn.Module):
    """Stage 0: conv 7x7 / 4 then ``post_norm``; later: ``pre_norm`` then
    conv 3x3 / 2."""

    def __init__(self, inplanes, planes, first, dtype):
        super().__init__()
        self.first = first
        if first:
            self.conv = Conv2d(inplanes, planes, 7, 4, 2, dtype=dtype,
                               init_std=0.02)
            self.post_norm = BatchNorm2d(planes, dtype=dtype)
        else:
            self.pre_norm = BatchNorm2d(inplanes, dtype=dtype)
            self.conv = Conv2d(inplanes, planes, 3, 2, 1, dtype=dtype,
                               init_std=0.02)

    def forward(self, x):
        if self.first:
            return self.post_norm(self.conv(x))
        return self.conv(self.pre_norm(x))


class MetaFormer(nn.Module):

    def __init__(self, embedding_planes, block_nums, dropout_prob=0.0,
                 drop_path_prob=0.0, num_classes=1000,
                 use_gradient_checkpoint=False, dtype=torch.float32):
        super().__init__()
        self.dropout_prob, self.drop_path_prob = dropout_prob, drop_path_prob
        self.use_gradient_checkpoint = use_gradient_checkpoint
        dprs = drop_path_rates(drop_path_prob, sum(block_nums))
        downsample, stages, inplanes, idx = [], [], 3, 0
        for i, n_blocks in enumerate(block_nums):
            planes = embedding_planes[i]
            downsample.append(_Downsample(inplanes, planes, i == 0, dtype))
            stages.append(nn.Sequential(*[
                MetaFormerBlock(planes, dropout_prob, dprs[idx + j], dtype)
                for j in range(n_blocks)]))
            inplanes, idx = planes, idx + n_blocks
        self.downsample_layers = nn.ModuleList(downsample)
        self.stages = nn.ModuleList(stages)
        self.head = Linear(inplanes, num_classes, torch.float32)

    @property
    def out_channels(self):
        return [stage[0].norm1.weight.numel() for stage in self.stages]

    def forward(self, x, return_features=False):
        if x.is_cuda:
            x = x.contiguous(memory_format=torch.channels_last)
        remat = self.use_gradient_checkpoint and torch.is_grad_enabled()
        features = []
        for down, stage in zip(self.downsample_layers, self.stages):
            x = down(x)
            for block in stage:
                x = remat_call(block, x) if remat else block(x)
            features.append(x)
        if return_features:
            return [f.contiguous() for f in features]
        return self.head(avg_pool_global(x.float()))


def _metaformer(block_nums, embedding_planes, **kwargs):
    return MetaFormer(embedding_planes, block_nums, **kwargs)


def convformer_s18(**kwargs):
    return _metaformer([3, 3, 9, 3], [64, 128, 320, 512], **kwargs)


def convformer_s36(**kwargs):
    return _metaformer([3, 12, 18, 3], [64, 128, 320, 512], **kwargs)


def convformer_m36(**kwargs):
    return _metaformer([3, 12, 18, 3], [96, 192, 384, 576], **kwargs)


def convformer_b36(**kwargs):
    return _metaformer([3, 12, 18, 3], [128, 256, 512, 768], **kwargs)
