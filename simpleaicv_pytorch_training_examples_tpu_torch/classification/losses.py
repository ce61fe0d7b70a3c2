"""Classification losses on torch tensors.

Counterpart of the JAX package's ``classification/losses.py``: CELoss,
FocalCELoss, LabelSmoothCELoss, OneHotLabelCELoss and ImageNet-21K's
SemanticSoftmaxLoss. Every loss computes in fp32 whatever the dtype of the
logits, takes [B, C] logits (the semantic loss one [B, C_level] per level
of the tree) and returns the scalar mean. Loss objects are plain callables
without parameters.
"""

import torch
import torch.nn.functional as F

__all__ = ["CELoss", "FocalCELoss", "LabelSmoothCELoss", "OneHotLabelCELoss",
           "SemanticSoftmaxLoss"]


class CELoss:
    """Softmax cross entropy with integer labels, mean over the batch."""

    def __call__(self, pred, label):
        logp = F.log_softmax(pred.float(), dim=-1)
        return -logp.gather(-1, label[:, None].long())[:, 0].mean()


class FocalCELoss:

    def __init__(self, gamma=2.0):
        self.gamma = gamma

    def __call__(self, pred, label):
        pred = F.softmax(pred.float(), dim=-1)
        one_hot = F.one_hot(label.long(), pred.shape[-1]).float()
        pt = torch.where(one_hot == 1.0, pred, 1.0 - pred)
        focal_weight = (1.0 - pt) ** self.gamma
        loss = -torch.log(pred.clamp(min=1e-12)) * one_hot * focal_weight
        return loss.sum(dim=-1).mean()


class LabelSmoothCELoss:

    def __init__(self, smoothing=0.1):
        self.smoothing = smoothing

    def __call__(self, pred, label):
        num_classes = pred.shape[-1]
        logp = F.log_softmax(pred.float(), dim=-1)
        one_hot = F.one_hot(label.long(), num_classes).float()
        smoothed = (1.0 - self.smoothing) * one_hot + \
            self.smoothing / num_classes
        return (-logp * smoothed).sum(dim=-1).mean()


class OneHotLabelCELoss:
    """CE with one-hot / soft labels (the Mixup/CutMix path)."""

    def __call__(self, pred, label):
        logp = F.log_softmax(pred.float(), dim=-1)
        return (-label.float() * logp).sum(dim=-1).mean()


class SemanticSoftmaxLoss:
    """ImageNet-21K's hierarchical semantic softmax: over the tree's levels,
    the label-smoothed cross entropy of the level's logits [B, C_level]
    (``semantic_outputs``) at the level's labels (``semantic_labels[:,
    level]``, -1 where a sample's class does not reach the level, which
    then counts 0 in the batch mean), weighted by
    ``normalization_factor_list``."""

    def __init__(self, normalization_factor_list, smoothing=0.1):
        self.normalization_factor_list = normalization_factor_list
        self.smoothing = smoothing

    def __call__(self, semantic_outputs, semantic_labels):
        total = 0.0
        for i, logits in enumerate(semantic_outputs):
            labels = semantic_labels[:, i].long()
            valid = (labels >= 0).float()
            num_classes = logits.shape[-1]
            logp = F.log_softmax(logits.float(), dim=-1)
            one_hot = F.one_hot(labels.clamp(min=0), num_classes).float()
            smoothed = one_hot * (1.0 - self.smoothing) + \
                self.smoothing / num_classes
            ce = (-smoothed * logp).sum(dim=-1) * valid
            total = total + ce.mean() * self.normalization_factor_list[i]
        return total
