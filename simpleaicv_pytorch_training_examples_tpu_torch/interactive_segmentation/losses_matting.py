"""SAM matting losses: the human-matting trimap / alpha family
(``human_matting/losses.py``), which the matting train tool dispatches by
name. Counterpart of the JAX package's
``interactive_segmentation/losses_matting.py``."""

from ..human_matting.losses import (CompositionLoss, FusionAlphaLoss,
                                    FusionLaplacianLoss, GlobalTrimapCELoss,
                                    GloabelTrimapIouLoss, LocalAlphaLoss,
                                    LocalLaplacianLoss)

__all__ = [
    "GlobalTrimapCELoss", "GloabelTrimapIouLoss", "LocalAlphaLoss",
    "LocalLaplacianLoss", "FusionAlphaLoss", "FusionLaplacianLoss",
    "CompositionLoss",
]
