"""SAM2 video losses: per frame, SAM's focal, dice and IoU losses of the
frame's mask outputs against its target, and a binary cross-entropy of the
object score logit against whether the target is non-empty on that frame
(the occlusion head), each averaged over the frames.

Counterpart of the JAX package's ``video_interactive_segmentation/
losses.py`` (``SAM2Loss``, ``SAM2MultiLevelLoss``), on the port's
``interactive_segmentation/losses.py``. Computed in fp32. Predictions:
mask logits [B, T, M, H, W], IoU predictions [B, T, M], object score logits
[B, T, 1]; targets [B, T, H, W].
"""

import torch

from ..interactive_segmentation.losses import SAMLoss, SAMMultiLevelLoss

__all__ = ["SAM2Loss", "SAM2MultiLevelLoss"]

_EPS = 1e-4


class SAM2Loss:
    """Per frame, SAMLoss's best-mask selection (one decoder pass a frame)
    and the object score's cross-entropy (times ``object_score_loss_weight``)."""

    def __init__(self, alpha=0.25, gamma=2, focal_loss_weight=20,
                 dice_loss_weight=1, iou_predict_loss_weight=1,
                 object_score_loss_weight=1, supervise_all_iou=True,
                 mask_threshold=0.0):
        self.sam_loss = SAMLoss(alpha, gamma, focal_loss_weight,
                                dice_loss_weight, iou_predict_loss_weight,
                                supervise_all_iou, mask_threshold)
        self.object_score_loss_weight = object_score_loss_weight

    def __call__(self, preds, targets):
        """preds (masks, ious, object logits); targets [B, T, H, W]. Returns
        {focal_loss, dice_loss, iou_predict_loss, object_score_loss}."""
        masks, ious, obj_logits = preds
        t_frames = masks.shape[1]
        totals = {"focal_loss": 0.0, "dice_loss": 0.0,
                  "iou_predict_loss": 0.0}
        obj_total = 0.0
        for t in range(t_frames):
            target = targets[:, t].float()
            frame = self.sam_loss(([masks[:, t]], [ious[:, t]]),
                                  target[:, None])
            totals = {k: v + frame[k] for k, v in totals.items()}
            present = (target.sum(dim=(1, 2)) > 0).float()
            p = torch.sigmoid(obj_logits[:, t, 0].float()).clamp(
                _EPS, 1.0 - _EPS)
            obj_total = obj_total - (present * torch.log(p) + (1 - present)
                                     * torch.log(1 - p)).mean()
        out = {k: v / t_frames for k, v in totals.items()}
        out["object_score_loss"] = (self.object_score_loss_weight * obj_total
                                    / t_frames)
        return out


class SAM2MultiLevelLoss(SAM2Loss):
    """SAM2Loss with every mask output of a frame supervised and the losses
    averaged over the outputs (SAMMultiLevelLoss) instead of the best one
    chosen; the object score term is kept."""

    def __init__(self, alpha=0.25, gamma=2, focal_loss_weight=20,
                 dice_loss_weight=1, iou_predict_loss_weight=1,
                 object_score_loss_weight=1, mask_threshold=0.0):
        super().__init__(alpha, gamma, focal_loss_weight, dice_loss_weight,
                         iou_predict_loss_weight, object_score_loss_weight,
                         mask_threshold=mask_threshold)
        self.sam_loss = SAMMultiLevelLoss(
            alpha, gamma, focal_loss_weight, dice_loss_weight,
            iou_predict_loss_weight, mask_threshold=mask_threshold)
