"""MAE reconstruction losses over the masked patches.

Counterpart of the JAX package's ``masked_image_modeling/losses.py``:
``pred`` and ``label`` [B, L, p * p * 3], ``mask`` [B, L] with 1 marking a
masked patch; in fp32, each patch's error averaged over its pixels, then
summed over the masked patches and divided by ``mask.sum() + 1e-4``.
"""

import torch

__all__ = ["MSELoss", "L1Loss"]


class MSELoss:

    def __call__(self, pred, label, mask):
        mask = mask.float()
        loss = ((pred.float() - label.float()) ** 2).mean(dim=-1)
        return (loss * mask).sum() / (mask.sum() + 1e-4)


class L1Loss:

    def __call__(self, pred, label, mask):
        mask = mask.float()
        loss = (pred.float() - label.float()).abs().mean(dim=-1)
        return (loss * mask).sum() / (mask.sum() + 1e-4)
