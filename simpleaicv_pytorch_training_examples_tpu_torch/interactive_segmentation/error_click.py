"""Error-driven click sampling of the SAM iterative-prompt training loop.

Counterpart of the JAX package's ``interactive_segmentation/
error_click.py``: a point drawn uniformly from the error region (false
negatives and false positives of the predicted mask against the target)
as a Gumbel-max over the region, with label 1 on a false negative (a
positive click) and 0 on a false positive, and (-1, -1, -1) where the
prediction has no error. The Gumbel noise is an argument, so a test can
feed both packages the same draws; ``gumbel_noise`` draws it on the
masks' device from a ``torch.Generator``. Nothing here waits for the host.
"""

import torch

__all__ = ["gumbel_noise", "sample_error_point", "sample_error_points_batch"]


def gumbel_noise(shape, generator, device):
    """Standard Gumbel noise -log(-log(u)), u uniform in [tiny, 1), fp32,
    drawn on ``device`` from ``generator`` (as ``jax.random.gumbel``)."""
    u = torch.rand(shape, generator=generator, device=device)
    u = u.clamp_min(torch.finfo(torch.float32).tiny)
    return -torch.log(-torch.log(u))


def sample_error_points_batch(gumbel, pred_masks, gt_masks):
    """gumbel [B, H * W], pred_masks and gt_masks [B, H, W] {0, 1} -> [B, 3]
    (x, y, label) fp32: the error pixel with the largest noise."""
    b, h, w = pred_masks.shape
    fn = (gt_masks > 0.5) & (pred_masks <= 0.5)
    fp = (gt_masks <= 0.5) & (pred_masks > 0.5)
    error = (fn | fp).reshape(b, h * w)
    scores = torch.where(error, gumbel.float(), float("-inf"))
    idx = scores.argmax(dim=-1)
    x = (idx % w).float()
    y = torch.div(idx, w, rounding_mode="floor").float()
    label = fn.reshape(b, h * w).gather(1, idx[:, None])[:, 0].float()
    point = torch.stack([x, y, label], dim=-1)
    return torch.where(error.any(dim=-1, keepdim=True), point,
                       torch.full_like(point, -1.0))


def sample_error_point(gumbel, pred_mask, gt_mask):
    """One mask: gumbel [H * W], pred_mask and gt_mask [H, W] -> [3]."""
    return sample_error_points_batch(gumbel[None], pred_mask[None],
                                     gt_mask[None])[0]
