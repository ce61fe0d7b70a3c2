from .resnet import *  # noqa: F401,F403
from .resnetcifar import *  # noqa: F401,F403
from .vit import *  # noqa: F401,F403
