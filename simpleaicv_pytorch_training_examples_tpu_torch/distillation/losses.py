"""Distillation losses.

Counterpart of the JAX package's ``distillation/losses.py``: ``CELoss`` and
``OneHotLabelCELoss`` (re-exported from classification), ``KDLoss`` (the KL
divergence of the teacher's T-softened probabilities from the student's,
summed and divided by the batch, times T^2), ``DMLLoss`` (the two KL
divergences' mean) and ``L2Loss`` (the mean squared difference of the
logits). All in fp32, the probabilities clamped to [1e-4, 1 - 1e-4].
"""

import torch

from ..classification.losses import CELoss, OneHotLabelCELoss

__all__ = ["CELoss", "OneHotLabelCELoss", "KDLoss", "DMLLoss", "L2Loss"]


def _clamped_softmax(logits, t):
    p = torch.softmax(logits.float() / t, dim=1)
    return p.clamp(1e-4, 1.0 - 1e-4)


def _kl_batchmean(log_p, q):
    """sum q * (log q - log_p) / B, as ``F.kl_div(log_p, q,
    reduction='batchmean')``."""
    return (q * (torch.log(q) - log_p)).sum() / log_p.shape[0]


class KDLoss:

    def __init__(self, T):
        self.t = T

    def __call__(self, stu_preds, tea_preds):
        s = torch.log(_clamped_softmax(stu_preds, self.t))
        t = _clamped_softmax(tea_preds, self.t)
        return _kl_batchmean(s, t) * (self.t ** 2)


class DMLLoss:

    def __init__(self, T):
        self.t = T

    def __call__(self, stu_preds, tea_preds):
        s = _clamped_softmax(stu_preds, self.t)
        t = _clamped_softmax(tea_preds, self.t)
        return (_kl_batchmean(torch.log(s), t) * (self.t ** 2) +
                _kl_batchmean(torch.log(t), s) * (self.t ** 2)) / 2.0


class L2Loss:

    def __call__(self, stu_preds, tea_preds):
        return ((stu_preds.float() - tea_preds.float()) ** 2).mean()
