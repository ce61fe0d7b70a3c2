"""Video interactive segmentation (SAM2): the port of the JAX package's
``video_interactive_segmentation``. Ported so far: the SAM2 video tracker's
inference (``models.segment_anything2``)."""

from . import models

__all__ = ["models"]
