"""Video interactive segmentation (SAM2): the port of the JAX package's
``video_interactive_segmentation``: the SAM2 video model
(``models.segment_anything2``: streaming tracking and the training
forward), its losses, and the video datasets and collaters."""

from . import models

__all__ = ["models"]
