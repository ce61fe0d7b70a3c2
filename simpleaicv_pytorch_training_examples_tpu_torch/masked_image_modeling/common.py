"""MAE collater: the batch's images and their per-patch normalised pixels.

Counterpart of the JAX package's ``masked_image_modeling/common.py``
(``MAESelfSupervisedPretrainCollater``). The labels are the JAX package's,
computed from the same HWC samples: [B, gh * gw, p * p * C], patches in row
order, each patch's pixels in (p, p, C) order, normalised by the patch's
mean and biased variance plus 1e-4. The images go out NCHW.
"""

import numpy as np
import torch

__all__ = ["MAESelfSupervisedPretrainCollater"]


class MAESelfSupervisedPretrainCollater:

    def __init__(self, image_size=224, patch_size=16, norm_label=True):
        assert image_size % patch_size == 0
        self.patch_size = patch_size
        self.patch_nums = image_size // patch_size
        self.norm_label = norm_label

    def __call__(self, samples):
        images = np.stack([s["image"] for s in samples]).astype(np.float32)
        b, h, w, c = images.shape
        p, g = self.patch_size, self.patch_nums
        # NHWC -> [B, gh, p, gw, p, C] -> [B, gh*gw, p*p*C]
        labels = images.reshape(b, g, p, g, p, c)
        labels = labels.transpose(0, 1, 3, 2, 4, 5).reshape(b, g * g,
                                                            p * p * c)
        if self.norm_label:
            mean = labels.mean(axis=-1, keepdims=True)
            var = labels.var(axis=-1, keepdims=True)
            labels = (labels - mean) / (var + 1e-4) ** 0.5
        return {"image": torch.from_numpy(images).permute(0, 3, 1, 2)
                .contiguous(),
                "label": torch.from_numpy(labels.astype(np.float32))}
