"""SAM2 encoder distillation loss: the SAM encoder distillation's
``MSELoss`` on the /16 FPN maps (the JAX package's
``video_interactive_segmentation/distill_losses.py``)."""

from ..interactive_segmentation.distill_losses import MSELoss

__all__ = ["MSELoss"]
