"""Classification backbone registry (re-export for the config UX).

Configs do ``backbones.__dict__[network](**kwargs)``. Only the ViT family is
ported so far.
"""

from ..models.backbones import *  # noqa: F401,F403
