"""Interactive segmentation (SAM): the port of the JAX package's
``interactive_segmentation``: the SAM model, its losses, the error-click
sampler of the training loop, and the datasets."""

from . import models

__all__ = ["models"]
