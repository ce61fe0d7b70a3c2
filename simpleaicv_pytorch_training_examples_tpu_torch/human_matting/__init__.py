"""Human matting: the port of the JAX package's ``human_matting`` losses and
dataset (the trimap / alpha loss family that SAM and SAM2 matting share)."""

from . import losses

__all__ = ["losses"]
