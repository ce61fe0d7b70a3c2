"""Interactive segmentation (SAM): the port of the JAX package's
``interactive_segmentation``. Inference for now; the losses, click
simulation and datasets of training come with SAM training."""

from . import models

__all__ = ["models"]
