"""VAN (Visual Attention Network) b0-b6: NCHW images in, logits out.

Counterpart of the JAX package's ``models/backbones/van.py``: four stages
of an overlapping patch embed (7x7 / 4, then 3x3 / 2) with BatchNorm, blocks
of [BatchNorm -> attention -> layer-scaled residual, BatchNorm -> conv MLP
-> layer-scaled residual] and a stage BatchNorm. The attention is a 1x1
convolution, ReLU, the large-kernel attention (depth-wise 5x5, then
depth-wise 7x7 at dilation 3 and padding 9, then 1x1, multiplied into its
input), a 1x1 convolution and a residual; the MLP is 1x1, depth-wise 3x3,
ReLU, 1x1. BatchNorm is Flax's with momentum 0.9 (torch's 0.1), its
statistics the global batch's in a process group. ``layer_scale_1`` and
``layer_scale_2`` start at 1e-5.

Parameter names are the reference torch VAN's, so that
``utils/torch_convert.convert_van_state_dict`` maps them onto the JAX
package's: ``patch_embed{i}.{proj,norm}``, ``block{i}.{j}.{norm1,
attn.{proj_1,spatial_gating_unit.{conv0,conv_spatial,conv1},proj_2},
layer_scale_1,norm2,mlp.{fc1,dwconv.dwconv,fc2},layer_scale_2}``,
``norm{i}``, ``head``. The convolutions compute in ``dtype`` over fp32
parameters; the pooled features and the head run in fp32.
``use_gradient_checkpoint`` recomputes each block in the backward.
"""

import torch
import torch.nn.functional as F
from torch import nn

from ..common import (BatchNorm2d, Conv2d, Dropout, DropPath, Linear,
                      avg_pool_global, drop_path_rates, remat_call)

__all__ = ["van_b0", "van_b1", "van_b2", "van_b3", "van_b4", "van_b5",
           "van_b6"]


class LKA(nn.Module):
    """Large-kernel attention: DW 5x5 -> DW 7x7 dilated 3 -> 1x1, gated."""

    def __init__(self, planes, dtype=torch.float32):
        super().__init__()
        self.conv0 = Conv2d(planes, planes, 5, padding=2, groups=planes,
                            dtype=dtype)
        self.conv_spatial = Conv2d(planes, planes, 7, padding=9, dilation=3,
                                   groups=planes, dtype=dtype)
        self.conv1 = Conv2d(planes, planes, 1, dtype=dtype)

    def forward(self, x):
        return x * self.conv1(self.conv_spatial(self.conv0(x)))


class VANAttention(nn.Module):

    def __init__(self, planes, dtype=torch.float32):
        super().__init__()
        self.proj_1 = Conv2d(planes, planes, 1, dtype=dtype)
        self.spatial_gating_unit = LKA(planes, dtype)
        self.proj_2 = Conv2d(planes, planes, 1, dtype=dtype)

    def forward(self, x):
        h = self.spatial_gating_unit(F.relu(self.proj_1(x)))
        return self.proj_2(h) + x.to(h.dtype)


class _DepthWise(nn.Module):
    """The reference's ``DWConv`` wrapper (its conv is ``dwconv.dwconv``)."""

    def __init__(self, planes, dtype):
        super().__init__()
        self.dwconv = Conv2d(planes, planes, 3, padding=1, groups=planes,
                             dtype=dtype)

    def forward(self, x):
        return self.dwconv(x)


class VANMlp(nn.Module):
    """1x1 conv -> DW 3x3 -> ReLU -> 1x1 conv, dropout after each 1x1."""

    def __init__(self, planes, hidden_planes, dropout_prob=0.0,
                 dtype=torch.float32):
        super().__init__()
        self.fc1 = Conv2d(planes, hidden_planes, 1, dtype=dtype)
        self.dwconv = _DepthWise(hidden_planes, dtype)
        self.fc2 = Conv2d(hidden_planes, planes, 1, dtype=dtype)
        self.drop = Dropout(dropout_prob)

    def forward(self, x):
        x = self.drop(F.relu(self.dwconv(self.fc1(x))))
        return self.drop(self.fc2(x))


class VANBlock(nn.Module):

    def __init__(self, planes, mlp_ratio=4.0, dropout_prob=0.0,
                 drop_path_prob=0.0, dtype=torch.float32):
        super().__init__()
        self.norm1 = BatchNorm2d(planes, dtype=dtype)
        self.attn = VANAttention(planes, dtype)
        self.layer_scale_1 = nn.Parameter(torch.full((planes,), 1e-5))
        self.norm2 = BatchNorm2d(planes, dtype=dtype)
        self.mlp = VANMlp(planes, int(planes * mlp_ratio), dropout_prob,
                          dtype)
        self.layer_scale_2 = nn.Parameter(torch.full((planes,), 1e-5))
        self.drop_path = DropPath(drop_path_prob)

    def init_weights_(self, generator):
        nn.init.constant_(self.layer_scale_1, 1e-5)
        nn.init.constant_(self.layer_scale_2, 1e-5)

    def forward(self, x):
        h = self.attn(self.norm1(x))
        x = x + self.drop_path(self.layer_scale_1.to(x.dtype)[:, None, None]
                               * h)
        h = self.mlp(self.norm2(x))
        return x + self.drop_path(self.layer_scale_2.to(x.dtype)[:, None, None]
                                  * h)


class _OverlapPatchEmbed(nn.Module):

    def __init__(self, inplanes, planes, kernel, stride, dtype):
        super().__init__()
        self.proj = Conv2d(inplanes, planes, kernel, stride, kernel // 2,
                           dtype=dtype)
        self.norm = BatchNorm2d(planes, dtype=dtype)

    def forward(self, x):
        return self.norm(self.proj(x))


class VAN(nn.Module):

    def __init__(self, embedding_planes, mlp_ratios, block_nums,
                 dropout_prob=0.0, drop_path_prob=0.0, num_classes=1000,
                 use_gradient_checkpoint=False, dtype=torch.float32):
        super().__init__()
        self.block_nums = list(block_nums)
        self.dropout_prob, self.drop_path_prob = dropout_prob, drop_path_prob
        self.use_gradient_checkpoint = use_gradient_checkpoint
        dprs = drop_path_rates(drop_path_prob, sum(block_nums))
        inplanes, idx = 3, 0
        for i, n_blocks in enumerate(block_nums):
            k, s = (7, 4) if i == 0 else (3, 2)
            planes = embedding_planes[i]
            setattr(self, f"patch_embed{i + 1}",
                    _OverlapPatchEmbed(inplanes, planes, k, s, dtype))
            setattr(self, f"block{i + 1}", nn.ModuleList([
                VANBlock(planes, mlp_ratios[i], dropout_prob, dprs[idx + j],
                         dtype) for j in range(n_blocks)]))
            setattr(self, f"norm{i + 1}", BatchNorm2d(planes, dtype=dtype))
            inplanes, idx = planes, idx + n_blocks
        self.head = Linear(inplanes, num_classes, torch.float32)

    def forward(self, x, return_features=False):
        if x.is_cuda:
            x = x.contiguous(memory_format=torch.channels_last)
        remat = self.use_gradient_checkpoint and torch.is_grad_enabled()
        features = []
        for i in range(len(self.block_nums)):
            x = getattr(self, f"patch_embed{i + 1}")(x)
            for block in getattr(self, f"block{i + 1}"):
                x = remat_call(block, x) if remat else block(x)
            x = getattr(self, f"norm{i + 1}")(x)
            features.append(x)
        if return_features:
            return [f.contiguous() for f in features]
        return self.head(avg_pool_global(x.float()))


def _van(embedding_planes, mlp_ratios, block_nums, **kwargs):
    return VAN(embedding_planes, mlp_ratios, block_nums, **kwargs)


def van_b0(**kwargs):
    return _van([32, 64, 160, 256], [8, 8, 4, 4], [3, 3, 5, 2], **kwargs)


def van_b1(**kwargs):
    return _van([64, 128, 320, 512], [8, 8, 4, 4], [2, 2, 4, 2], **kwargs)


def van_b2(**kwargs):
    return _van([64, 128, 320, 512], [8, 8, 4, 4], [3, 3, 12, 3], **kwargs)


def van_b3(**kwargs):
    return _van([64, 128, 320, 512], [8, 8, 4, 4], [3, 5, 27, 3], **kwargs)


def van_b4(**kwargs):
    return _van([64, 128, 320, 512], [8, 8, 4, 4], [3, 6, 40, 3], **kwargs)


def van_b5(**kwargs):
    return _van([96, 192, 480, 768], [8, 8, 4, 4], [3, 3, 24, 3], **kwargs)


def van_b6(**kwargs):
    return _van([96, 192, 384, 768], [8, 8, 4, 4], [6, 6, 90, 6], **kwargs)
