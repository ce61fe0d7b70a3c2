from .loader import Compose, build_loader

__all__ = ["Compose", "build_loader"]
