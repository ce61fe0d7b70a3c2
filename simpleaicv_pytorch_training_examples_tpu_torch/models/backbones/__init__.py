from .resnet import *  # noqa: F401,F403
from .resnetcifar import *  # noqa: F401,F403
from .vit import *  # noqa: F401,F403
from .darknet import *  # noqa: F401,F403
from .van import *  # noqa: F401,F403
from .convformer import *  # noqa: F401,F403
from .dinov3_vit import *  # noqa: F401,F403
from .dinov3_convnext import *  # noqa: F401,F403
