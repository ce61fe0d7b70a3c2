"""SAM losses: per decoder iteration, sigmoid focal and dice losses of the
predicted masks against the target mask, the best of the multimask outputs
chosen by focal * weight + dice * weight, and the squared error between the
predicted IoU and the IoU of the thresholded mask (of every output when
``supervise_all_iou``).

Counterpart of the JAX package's ``interactive_segmentation/losses.py``
(``SAMLoss``, ``SAMMultiLevelLoss``). Computed in fp32 whatever the dtype
of the predictions. Mask logits [B, M, H, W], IoU predictions [B, M],
targets [B, 1, H, W].
"""

import torch

__all__ = ["SAMLoss", "SAMMultiLevelLoss"]

_EPS = 1e-4


class SAMLoss:

    def __init__(self, alpha=0.25, gamma=2, focal_loss_weight=20,
                 dice_loss_weight=1, iou_predict_loss_weight=1,
                 supervise_all_iou=True, mask_threshold=0.0):
        self.alpha = alpha
        self.gamma = gamma
        self.focal_loss_weight = focal_loss_weight
        self.dice_loss_weight = dice_loss_weight
        self.iou_predict_loss_weight = iou_predict_loss_weight
        self.supervise_all_iou = supervise_all_iou
        self.mask_threshold = mask_threshold

    def _per_mask_losses(self, mask_logits, iou_preds, targets):
        """Focal, dice and IoU squared error per mask, each [B, M]."""
        logits = mask_logits.float()
        t = targets.float().expand_as(logits)
        p = torch.sigmoid(logits).clamp(_EPS, 1.0 - _EPS)
        positive = t == 1.0
        alpha = torch.where(positive, self.alpha, 1.0 - self.alpha)
        pt = torch.where(positive, p, 1.0 - p)
        bce = -(t * torch.log(p) + (1.0 - t) * torch.log(1.0 - p))
        focal = (alpha * (1.0 - pt) ** self.gamma * bce).mean(dim=(2, 3))
        inter = (p * t).sum(dim=(2, 3))
        dice = 1.0 - (2.0 * inter + _EPS) / (
            p.sum(dim=(2, 3)) + t.sum(dim=(2, 3)) + _EPS)
        binary = (logits > self.mask_threshold).float()
        overlap = (binary * t).sum(dim=(2, 3))
        union = (binary.sum(dim=(2, 3)) + t.sum(dim=(2, 3)) - overlap).clamp_min(
            _EPS)
        iou_mse = (iou_preds.float() - overlap / union) ** 2
        return focal, dice, iou_mse

    def _select(self, focal, dice, iou_mse):
        """The best mask's focal and dice losses and the IoU term, each [B]."""
        if focal.shape[1] == 1:
            return focal[:, 0], dice[:, 0], iou_mse[:, 0]
        combine = focal * self.focal_loss_weight + dice * self.dice_loss_weight
        best = combine.argmin(dim=-1, keepdim=True)
        iou = iou_mse.mean(dim=-1) if self.supervise_all_iou \
            else iou_mse.gather(1, best)[:, 0]
        return focal.gather(1, best)[:, 0], dice.gather(1, best)[:, 0], iou

    def _totals(self, all_iter_preds, targets, reduce):
        all_masks, all_ious = all_iter_preds
        totals = [0.0, 0.0, 0.0]
        for mask_logits, iou_preds in zip(all_masks, all_ious):
            terms = reduce(*self._per_mask_losses(mask_logits, iou_preds,
                                                  targets))
            totals = [total + term.mean() for total, term in zip(totals, terms)]
        n_iter = len(all_masks)
        return {
            "focal_loss": self.focal_loss_weight * totals[0] / n_iter,
            "dice_loss": self.dice_loss_weight * totals[1] / n_iter,
            "iou_predict_loss": self.iou_predict_loss_weight * totals[2] / n_iter,
        }

    def __call__(self, all_iter_preds, targets):
        """all_iter_preds: (list of mask logits [B, M, H, W], list of IoU
        predictions [B, M]), one entry a decoder iteration; targets
        [B, 1, H, W]. Returns {focal_loss, dice_loss, iou_predict_loss}."""
        return self._totals(all_iter_preds, targets, self._select)


class SAMMultiLevelLoss(SAMLoss):
    """Every mask output supervised against the target, the losses averaged
    over the outputs, instead of the best one chosen."""

    def __call__(self, all_iter_preds, targets):
        return self._totals(all_iter_preds, targets,
                            lambda focal, dice, iou_mse: (focal, dice, iou_mse))
