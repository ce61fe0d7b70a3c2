"""Human matting losses, NCHW.

Counterpart of the JAX package's ``human_matting/losses.py``:
``GlobalTrimapCELoss`` (binary cross-entropy of the 3-channel sigmoid
trimap against the pixel trimap 0/128/255 read as classes 0/1/2),
``GloabelTrimapIouLoss`` (per-pixel soft IoU over the three classes),
``LocalAlphaLoss`` (Charbonnier distance ``sqrt(d^2 + 1e-12)`` on the
transition band), ``LocalLaplacianLoss`` and ``FusionLaplacianLoss`` (L1
over a 5-level Laplacian pyramid: a 5x5 Gaussian of sigma 1 over an
edge-replicated border, then a VALID 2x2 average), ``FusionAlphaLoss`` and
``CompositionLoss``.

Predictions are NCHW: the global trimap [B, 3, H, W], the local and fused
alphas [B, 1, H, W]; ``alpha`` and ``trimap`` are [B, H, W]; the image and
the foreground and background plates [B, 3, H, W]. Every loss computes in
fp32, under autocast too.
"""

import numpy as np
import torch
import torch.nn.functional as F

__all__ = [
    "GlobalTrimapCELoss", "GloabelTrimapIouLoss", "LocalAlphaLoss",
    "LocalLaplacianLoss", "FusionAlphaLoss", "FusionLaplacianLoss",
    "CompositionLoss",
]

_EPS = 1e-4


def _fp32(fn):
    """Run ``fn`` with autocast off."""
    def wrapped(self, *args):
        device = next(a for a in args if isinstance(a, torch.Tensor)).device
        with torch.autocast(device.type, enabled=False):
            return fn(self, *args)
    wrapped.__doc__ = fn.__doc__
    return wrapped


def _one_hot_trimap(trimap):
    """[B, H, W] pixel trimap 0/128/255 -> fp32 one-hot [B, 3, H, W] of the
    classes 0 (background) / 1 (transition) / 2 (foreground)."""
    cls = torch.where(trimap == 255, 2, torch.where(trimap == 0, 0, 1))
    return F.one_hot(cls.long(), 3).permute(0, 3, 1, 2).float()


def _clipped(pred):
    return pred.float().clamp(_EPS, 1.0 - _EPS)


class GlobalTrimapCELoss:

    @_fp32
    def __call__(self, global_pred, trimap):
        p = _clipped(global_pred)
        one_hot = _one_hot_trimap(trimap)
        bce = -(one_hot * torch.log(p) + (1.0 - one_hot) * torch.log(1.0 - p))
        return bce.mean()


class GloabelTrimapIouLoss:

    def __init__(self, smooth=1e-4):
        self.smooth = smooth

    @_fp32
    def __call__(self, global_pred, trimap):
        p = _clipped(global_pred)
        one_hot = _one_hot_trimap(trimap)
        inter = (p * one_hot).sum(dim=1)
        iou = (inter + self.smooth) / (
            p.sum(dim=1) + one_hot.sum(dim=1) - inter + self.smooth)
        return (1.0 - iou).mean()


class LocalAlphaLoss:

    @_fp32
    def __call__(self, local_pred, alpha, trimap):
        p = _clipped(local_pred)[:, 0]
        weighted = (trimap == 128).float()
        diff = (p - alpha.float()) * weighted
        loss = torch.sqrt(diff ** 2 + 1e-12)
        return loss.sum() / (weighted.sum() + 1.0)


def _gauss_kernel(size=5, sigma=1.0):
    grid = np.float32(np.mgrid[0:size, 0:size].T)
    gaussian = lambda x: np.exp(-((x - size // 2) ** 2) / (2 * sigma ** 2))
    kernel = np.sum(gaussian(grid), axis=2)
    kernel /= np.sum(kernel)
    return kernel.astype(np.float32)


def _conv_gauss(img, kernel):
    """img [B, 1, H, W]: replicate-pad, then the 5x5 Gaussian (``kernel``
    a float32 numpy array)."""
    pad = kernel.shape[0] // 2
    img = F.pad(img, (pad, pad, pad, pad), mode="replicate")
    weight = torch.from_numpy(kernel).to(img.device)[None, None]
    return F.conv2d(img, weight)


def _laplacian_pyramid(img, kernel, max_levels=5):
    current = img
    pyr = []
    for _ in range(max_levels):
        filtered = _conv_gauss(current, kernel)
        pyr.append(current - filtered)
        current = F.avg_pool2d(filtered, 2, 2)
    pyr.append(current)
    return pyr


def _pyramid_l1(a, p, kernel):
    return sum(torch.abs(x - y).mean() for x, y in zip(
        _laplacian_pyramid(a, kernel), _laplacian_pyramid(p, kernel)))


class LocalLaplacianLoss:

    def __init__(self):
        self.kernel = _gauss_kernel(5, 1.0)

    @_fp32
    def __call__(self, local_pred, alpha, trimap):
        weighted = (trimap == 128).float()[:, None]
        p = _clipped(local_pred) * weighted
        a = alpha.float()[:, None] * weighted
        return _pyramid_l1(a, p, self.kernel)


class FusionAlphaLoss:

    @_fp32
    def __call__(self, fusion_pred, alpha):
        diff = _clipped(fusion_pred)[:, 0] - alpha.float()
        loss = torch.sqrt(diff ** 2 + 1e-12)
        return loss.sum() / alpha.numel()


class FusionLaplacianLoss:

    def __init__(self):
        self.kernel = _gauss_kernel(5, 1.0)

    @_fp32
    def __call__(self, fusion_pred, alpha):
        return _pyramid_l1(alpha.float()[:, None], _clipped(fusion_pred),
                           self.kernel)


class CompositionLoss:

    @_fp32
    def __call__(self, image, alpha, fg_map, bg_map, fusion_pred):
        p = _clipped(fusion_pred)
        composition = p * fg_map.float() + (1.0 - p) * bg_map.float()
        loss = torch.sqrt((composition - image.float()) ** 2 + 1e-12)
        return loss.sum() / alpha.numel()
