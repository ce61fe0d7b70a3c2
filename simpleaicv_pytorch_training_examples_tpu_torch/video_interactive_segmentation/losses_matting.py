"""SAM2 matting losses, image and video.

Counterpart of the JAX package's ``video_interactive_segmentation/
losses_matting.py``: ``SAM2MattingLoss`` is the weighted sum of the matting
family (``human_matting/losses.py``: global trimap CE and IoU, local alpha
and Laplacian, fusion alpha and Laplacian) over the (global, local, fused)
predictions, image-shaped (NCHW) or video-shaped ([B, T, C, H, W], time
folded into the batch); alpha and trimap are [B, H, W] or [B, T, H, W].
It returns each weighted term and their sum, ``loss``.
``SAM2MattingMultiLevelLoss`` averages over a list of per-level triples;
``SAM2VideoMatting`` returns one triple, so in both packages it equals
``SAM2MattingLoss``.
"""

import torch

from ..human_matting.losses import (FusionAlphaLoss, FusionLaplacianLoss,
                                    GlobalTrimapCELoss,
                                    GloabelTrimapIouLoss, LocalAlphaLoss,
                                    LocalLaplacianLoss)

__all__ = ["SAM2MattingLoss", "SAM2MattingMultiLevelLoss"]


class SAM2MattingLoss:

    def __init__(self, global_ce_weight=1.0, global_iou_weight=1.0,
                 local_alpha_weight=1.0, local_laplacian_weight=1.0,
                 fusion_alpha_weight=1.0, fusion_laplacian_weight=1.0):
        self.weights = {
            "global_trimap_ce_loss": global_ce_weight,
            "global_trimap_iou_loss": global_iou_weight,
            "local_alpha_loss": local_alpha_weight,
            "local_laplacian_loss": local_laplacian_weight,
            "fusion_alpha_loss": fusion_alpha_weight,
            "fusion_laplacian_loss": fusion_laplacian_weight,
        }
        self.global_ce = GlobalTrimapCELoss()
        self.global_iou = GloabelTrimapIouLoss()
        self.local_alpha = LocalAlphaLoss()
        self.local_laplacian = LocalLaplacianLoss()
        self.fusion_alpha = FusionAlphaLoss()
        self.fusion_laplacian = FusionLaplacianLoss()

    def __call__(self, preds, alpha, trimap):
        g, l, f = preds
        if g.dim() == 5:   # video: fold time into the batch
            g, l, f, alpha, trimap = (x.flatten(0, 1)
                                      for x in (g, l, f, alpha, trimap))
        raw = {
            "global_trimap_ce_loss": self.global_ce(g, trimap),
            "global_trimap_iou_loss": self.global_iou(g, trimap),
            "local_alpha_loss": self.local_alpha(l, alpha, trimap),
            "local_laplacian_loss": self.local_laplacian(l, alpha, trimap),
            "fusion_alpha_loss": self.fusion_alpha(f, alpha),
            "fusion_laplacian_loss": self.fusion_laplacian(f, alpha),
        }
        out = {k: v * self.weights[k] for k, v in raw.items()}
        out["loss"] = sum(out.values(), torch.zeros((), device=g.device))
        return out


class SAM2MattingMultiLevelLoss(SAM2MattingLoss):
    """The matting family on every level of a list of triples, averaged;
    one triple is ``SAM2MattingLoss``."""

    def __call__(self, preds, alpha, trimap):
        if isinstance(preds[0], (list, tuple)):
            dicts = [SAM2MattingLoss.__call__(self, p, alpha, trimap)
                     for p in preds]
            inv = 1.0 / len(dicts)
            return {k: sum(d[k] for d in dicts) * inv for k in dicts[0]}
        return SAM2MattingLoss.__call__(self, preds, alpha, trimap)
