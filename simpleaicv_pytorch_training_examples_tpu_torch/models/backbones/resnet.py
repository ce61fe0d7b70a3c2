"""ResNet backbones (18/34/50/101/152): NCHW images in, logits out.

Counterpart of the JAX package's ``models/backbones/resnet.py``: a 7x7
stem with max pool, four stages of ``BasicBlock`` or ``Bottleneck``, global
average pool and fc. Parameter names follow the reference torch ResNet, so
its ``.pth`` files load unchanged: ``conv1.layer.{0,1}`` (the stem),
``layer{s}.{i}.conv{k}.layer.{0,1}``, ``layer{s}.{i}.downsample_conv
.layer.{0,1}``, ``fc``.

dtype policy (as the JAX package): the convolutions and the blocks compute
in ``dtype`` over fp32 parameters, BatchNorm keeps fp32 statistics
(``models/common.BatchNorm2d``: Flax's update by the biased variance); the
pooled features and the fc run in fp32.

Layout: the parameters are NCHW (OIHW), and so are the inputs and the
features returned; on CUDA the activations run in ``memory_format``,
channels_last by default (the image is made channels_last at the stem;
cuDNN's NHWC kernels then take every convolution), which times faster on
an H100 than NCHW (``chip_smoke.py``'s ``[resnet50 train step 256]`` line
times both; PERF.md keeps the numbers).

``stage_strides`` sets each stage's first stride (an int or a pair; None is
the classification default (1, 2, 2, 2)); ``forward(x,
return_features=True)`` returns the four stages' outputs, whose channels
are ``out_channels``. ``use_gradient_checkpoint`` runs each block under
``torch.utils.checkpoint`` (non-reentrant) while grad is enabled, the JAX
package's ``nn.remat`` of the block; the recompute leaves the running
statistics as the first forward left them.
"""

import torch
import torch.nn.functional as F
from torch import nn

from ..common import ConvBnAct, Linear, avg_pool_global, max_pool, remat_call

__all__ = ["resnet18", "resnet34", "resnet50", "resnet101", "resnet152"]


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, inplanes, planes, stride=1, dtype=torch.float32):
        super().__init__()
        self.conv1 = ConvBnAct(inplanes, planes, 3, stride, 1, dtype=dtype)
        self.conv2 = ConvBnAct(planes, planes, 3, 1, 1, has_act=False,
                               dtype=dtype)
        self.downsample = stride != 1 or inplanes != planes
        if self.downsample:
            self.downsample_conv = ConvBnAct(inplanes, planes, 1, stride, 0,
                                             has_act=False, dtype=dtype)

    def forward(self, x):
        identity = self.downsample_conv(x) if self.downsample else x
        return F.relu(self.conv2(self.conv1(x)) + identity)


class Bottleneck(nn.Module):
    expansion = 4

    def __init__(self, inplanes, planes, stride=1, dtype=torch.float32):
        super().__init__()
        out_planes = planes * self.expansion
        self.conv1 = ConvBnAct(inplanes, planes, 1, 1, 0, dtype=dtype)
        self.conv2 = ConvBnAct(planes, planes, 3, stride, 1, dtype=dtype)
        self.conv3 = ConvBnAct(planes, out_planes, 1, 1, 0, has_act=False,
                               dtype=dtype)
        self.downsample = stride != 1 or inplanes != out_planes
        if self.downsample:
            self.downsample_conv = ConvBnAct(inplanes, out_planes, 1, stride,
                                             0, has_act=False, dtype=dtype)

    def forward(self, x):
        identity = self.downsample_conv(x) if self.downsample else x
        return F.relu(self.conv3(self.conv2(self.conv1(x))) + identity)


def make_stages(block, layer_nums, inplanes, stage_strides, dtype):
    """``layer1``...``layer4``: stage s has planes ``inplanes * 2**s`` and
    its first block takes the stage's stride."""
    stages, channels = [], inplanes
    for s, n_blocks in enumerate(layer_nums):
        planes = inplanes * 2 ** s
        stride = stage_strides[s] if stage_strides is not None else (
            2 if s > 0 else 1)
        if isinstance(stride, list):
            stride = tuple(stride)
        blocks = []
        for i in range(n_blocks):
            blocks.append(block(channels, planes, stride if i == 0 else 1,
                                dtype))
            channels = planes * block.expansion
        stages.append(nn.Sequential(*blocks))
    return stages, channels


def run_blocks(stage, x, remat):
    """A stage's blocks in turn; under ``remat`` each block checkpointed."""
    for block in stage:
        x = remat_call(block, x) if remat else block(x)
    return x


class ResNet(nn.Module):
    # the activations' layout on CUDA (CPU runs stay NCHW)
    memory_format = torch.channels_last

    def __init__(self, block, layer_nums, inplanes=64, num_classes=1000,
                 use_gradient_checkpoint=False, stage_strides=None,
                 dtype=torch.float32):
        super().__init__()
        self.block = block
        self.inplanes = inplanes
        self.use_gradient_checkpoint = use_gradient_checkpoint
        self.conv1 = ConvBnAct(3, inplanes, 7, 2, 3, dtype=dtype)
        stages, channels = make_stages(block, layer_nums, inplanes,
                                       stage_strides, dtype)
        self.layer1, self.layer2, self.layer3, self.layer4 = stages
        self.fc = Linear(channels, num_classes, torch.float32,
                         init_std=channels ** -0.5)

    @property
    def out_channels(self):
        """Channels of each stage's output (the necks' inputs)."""
        return [self.inplanes * 2 ** i * self.block.expansion
                for i in range(4)]

    def forward(self, x, return_features=False):
        if x.is_cuda:
            x = x.contiguous(memory_format=self.memory_format)
        x = max_pool(self.conv1(x), 3, 2, 1)
        remat = self.use_gradient_checkpoint and torch.is_grad_enabled()
        features = []
        for stage in (self.layer1, self.layer2, self.layer3, self.layer4):
            x = run_blocks(stage, x, remat)
            features.append(x)
        if return_features:
            return [f.contiguous() for f in features]
        return self.fc(avg_pool_global(x.float()))


def resnet18(**kwargs):
    return ResNet(BasicBlock, [2, 2, 2, 2], 64, **kwargs)


def resnet34(**kwargs):
    return ResNet(BasicBlock, [3, 4, 6, 3], 64, **kwargs)


def resnet50(**kwargs):
    return ResNet(Bottleneck, [3, 4, 6, 3], 64, **kwargs)


def resnet101(**kwargs):
    return ResNet(Bottleneck, [3, 4, 23, 3], 64, **kwargs)


def resnet152(**kwargs):
    return ResNet(Bottleneck, [3, 8, 36, 3], 64, **kwargs)
