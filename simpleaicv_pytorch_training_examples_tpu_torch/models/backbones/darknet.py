"""DarkNet backbones (tiny, 19, 53): NCHW images in, logits out.

Counterpart of the JAX package's ``models/backbones/darknet.py``: 3x3 and
1x1 convolutions with BatchNorm and leaky ReLU (slope 0.1), max pools,
global average pool. DarkNet-tiny's last pool pads the right and bottom
with -inf before its 2x2 pool at stride 1, so the map keeps its size and a
padded cell never wins; DarkNet-19 ends in a 1x1 convolution to the classes
(with a bias, no BatchNorm) before the pool; DarkNet-53 stacks residual
blocks (1x1 squeeze, 3x3 expand) and ends in an fc.

Parameter names follow the JAX package's module names in the reference
torch layout of ``models/common.ConvBnAct``: ``conv{k}.layer.{0,1}``,
``layer{k}.conv{i}.layer.{0,1}``, ``block{s}_{i}.conv{1,2}.layer.{0,1}``,
``fc`` (``utils/jax_weights.darknet_state_dict_from_jax``). The
convolutions compute in ``dtype`` over fp32 parameters, BatchNorm keeps fp32
statistics (the global batch's in a process group), the pooled features and
the fc run in fp32. On CUDA the activations run channels_last, as the
ResNets'.
"""

import torch
import torch.nn.functional as F
from torch import nn

from ..common import ConvBnAct, Linear, avg_pool_global, max_pool

__all__ = ["darknettiny", "darknet19", "darknet53"]


def _leaky(x):
    return F.leaky_relu(x, 0.1)


def _conv(inplanes, planes, k, s, p, dtype, has_bn=True, has_act=True):
    return ConvBnAct(inplanes, planes, k, s, p, has_bn=has_bn,
                     has_act=has_act, act=_leaky, dtype=dtype)


def _channels_last(x):
    return x.contiguous(memory_format=torch.channels_last) if x.is_cuda \
        else x


class Darknet53Block(nn.Module):
    """1x1 squeeze + 3x3 expand residual block."""

    def __init__(self, planes, dtype=torch.float32):
        super().__init__()
        self.conv1 = _conv(planes, planes // 2, 1, 1, 0, dtype)
        self.conv2 = _conv(planes // 2, planes, 3, 1, 1, dtype)

    def forward(self, x):
        return self.conv2(self.conv1(x)) + x


class DarknetTiny(nn.Module):

    def __init__(self, num_classes=1000, dtype=torch.float32):
        super().__init__()
        widths, inplanes = [16, 32, 64, 128, 256, 512], 3
        for i, w in enumerate(widths):
            setattr(self, f"conv{i + 1}", _conv(inplanes, w, 3, 1, 1, dtype))
            inplanes = w
        self.fc = Linear(512, num_classes, torch.float32,
                         init_std=512 ** -0.5)

    def forward(self, x):
        x = _channels_last(x)
        for i in range(6):
            x = getattr(self, f"conv{i + 1}")(x)
            if i < 5:
                x = max_pool(x, 2, 2)
            else:
                x = max_pool(F.pad(x, (0, 1, 0, 1), value=-float("inf")),
                             2, 1)
        return self.fc(avg_pool_global(x.float()))


class Darknet19Block(nn.Module):
    """Alternating 3x3 / 1x1 conv stack, optional trailing max pool."""

    def __init__(self, inplanes, planes, layer_num, use_maxpool=True,
                 dtype=torch.float32):
        super().__init__()
        self.layer_num, self.use_maxpool = layer_num, use_maxpool
        channels = inplanes
        for i in range(layer_num):
            if i % 2 == 0:
                conv = _conv(channels, planes, 3, 1, 1, dtype)
                channels = planes
            else:
                conv = _conv(channels, inplanes, 1, 1, 0, dtype)
                channels = inplanes
            setattr(self, f"conv{i}", conv)

    def forward(self, x):
        for i in range(self.layer_num):
            x = getattr(self, f"conv{i}")(x)
        return max_pool(x, 2, 2) if self.use_maxpool else x


class Darknet19(nn.Module):

    def __init__(self, num_classes=1000, dtype=torch.float32):
        super().__init__()
        self.layer1 = _conv(3, 32, 3, 1, 1, dtype)
        self.layer2 = Darknet19Block(32, 64, 1, True, dtype)
        self.layer3 = Darknet19Block(64, 128, 3, True, dtype)
        self.layer4 = Darknet19Block(128, 256, 3, True, dtype)
        self.layer5 = Darknet19Block(256, 512, 5, True, dtype)
        self.layer6 = Darknet19Block(512, 1024, 5, False, dtype)
        self.layer7 = _conv(1024, num_classes, 1, 1, 0, dtype, has_bn=False,
                            has_act=False)

    def forward(self, x):
        x = max_pool(self.layer1(_channels_last(x)), 2, 2)
        for k in range(2, 8):
            x = getattr(self, f"layer{k}")(x)
        return avg_pool_global(x.float())


class Darknet53(nn.Module):

    STAGES = ((64, 1), (128, 2), (256, 8), (512, 8), (1024, 4))

    def __init__(self, num_classes=1000, dtype=torch.float32):
        super().__init__()
        self.conv1 = _conv(3, 32, 3, 1, 1, dtype)
        self.conv2 = _conv(32, 64, 3, 2, 1, dtype)
        inplanes = 64
        for stage, (planes, n_blocks) in enumerate(self.STAGES):
            if stage > 0:
                setattr(self, f"conv{stage + 2}",
                        _conv(inplanes, planes, 3, 2, 1, dtype))
            for i in range(n_blocks):
                setattr(self, f"block{stage + 1}_{i}",
                        Darknet53Block(planes, dtype))
            inplanes = planes
        self.fc = Linear(1024, num_classes, torch.float32,
                         init_std=1024 ** -0.5)

    def forward(self, x, return_features=False):
        x = self.conv2(self.conv1(_channels_last(x)))
        features = []
        for stage, (_, n_blocks) in enumerate(self.STAGES):
            if stage > 0:
                x = getattr(self, f"conv{stage + 2}")(x)
            for i in range(n_blocks):
                x = getattr(self, f"block{stage + 1}_{i}")(x)
            features.append(x)
        if return_features:
            return [f.contiguous() for f in features[-3:]]
        return self.fc(avg_pool_global(x.float()))


def darknettiny(**kwargs):
    return DarknetTiny(**kwargs)


def darknet19(**kwargs):
    return Darknet19(**kwargs)


def darknet53(**kwargs):
    return Darknet53(**kwargs)
