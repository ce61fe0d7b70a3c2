from .vit import *  # noqa: F401,F403
