"""CIFAR ResNets: a 3x3 stem, no max pool, four stages, fc.

Counterpart of the JAX package's ``models/backbones/resnetcifar.py``, with
``resnet.py``'s blocks, names (the stem is ``conv1``), dtype policy and
channels_last activations on CUDA.
"""

import torch
from torch import nn

from ..common import ConvBnAct, Linear, avg_pool_global
from .resnet import BasicBlock, Bottleneck, make_stages, run_blocks

__all__ = ["resnet18cifar", "resnet34cifar", "resnet50cifar",
           "resnet101cifar", "resnet152cifar"]


class ResNetCifar(nn.Module):
    memory_format = torch.channels_last

    def __init__(self, block, layer_nums, inplanes=64, num_classes=100,
                 dtype=torch.float32):
        super().__init__()
        self.conv1 = ConvBnAct(3, inplanes, 3, 1, 1, dtype=dtype)
        stages, channels = make_stages(block, layer_nums, inplanes, None,
                                       dtype)
        self.layer1, self.layer2, self.layer3, self.layer4 = stages
        self.fc = Linear(channels, num_classes, torch.float32,
                         init_std=channels ** -0.5)

    def forward(self, x):
        if x.is_cuda:
            x = x.contiguous(memory_format=self.memory_format)
        x = self.conv1(x)
        for stage in (self.layer1, self.layer2, self.layer3, self.layer4):
            x = run_blocks(stage, x, False)
        return self.fc(avg_pool_global(x.float()))


def resnet18cifar(**kwargs):
    return ResNetCifar(BasicBlock, [2, 2, 2, 2], 64, **kwargs)


def resnet34cifar(**kwargs):
    return ResNetCifar(BasicBlock, [3, 4, 6, 3], 64, **kwargs)


def resnet50cifar(**kwargs):
    return ResNetCifar(Bottleneck, [3, 4, 6, 3], 64, **kwargs)


def resnet101cifar(**kwargs):
    return ResNetCifar(Bottleneck, [3, 4, 23, 3], 64, **kwargs)


def resnet152cifar(**kwargs):
    return ResNetCifar(Bottleneck, [3, 8, 36, 3], 64, **kwargs)
