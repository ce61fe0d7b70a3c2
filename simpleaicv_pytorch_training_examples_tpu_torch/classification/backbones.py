"""Classification backbone registry (re-export for the config UX).

Configs do ``backbones.__dict__[network](**kwargs)``. Ported so far: the
ResNets (``resnet18``...``resnet152``, ``resnet18cifar``...
``resnet152cifar``) and the ViTs.
"""

from ..models.backbones import *  # noqa: F401,F403
