"""Classification backbone registry (re-export for the config UX).

Configs do ``backbones.__dict__[network](**kwargs)``: every backbone of
the JAX package's registry, the ResNets (``resnet18``...``resnet152``,
``resnet18cifar``...``resnet152cifar``), the ViTs, DarkNet, VAN,
ConvFormer, and the DINOv3 ViTs and ConvNeXts.
"""

from ..models.backbones import *  # noqa: F401,F403
