"""SAM matting dataset and collater.

Counterpart of the JAX package's ``interactive_segmentation/datasets/
sam_matting_dataset.py``: ``SAMMattingDataset`` is
``HumanMattingDataset`` (image and alpha pairs, the trimap from the alpha,
the foreground and background plates), and ``SAMMattingCollater`` builds
fixed-shape batches with one prompt kind an image, drawn with
``prompt_probs`` from the binarised alpha (points, the noised box, or the
noised mask downsampled 4x), as ``SAMCollater`` does.

The collater works in NCHW, as ``SAMCollater``: image, fg_map and bg_map
[B, 3, r, r] of 0-255 values, mask (the alpha) and trimap [B, r, r],
prompt_point [B, n_points, 3], prompt_box [B, 4], prompt_box_valid [B],
prompt_mask [B, 1, r/4, r/4], prompt_mask_valid [B]. The JAX collater
resizes with cv2 at the factor r / max(h, w): INTER_LINEAR, which does not
antialias, is bilinear ``F.interpolate`` with ``antialias=False``, and
INTER_NEAREST for the trimap is torch's "nearest". It draws from the
global ``np.random`` in the JAX collater's order.
"""

import numpy as np
import torch

from ...human_matting.datasets.human_matting_dataset import (
    HumanMattingDataset)
from .sam_segmentation_dataset import (_resize, load_points, mask_to_box,
                                       noise_box, noise_mask)

__all__ = ["SAMMattingDataset", "SAMMattingCollater"]


class SAMMattingDataset(HumanMattingDataset):
    """``HumanMattingDataset``'s disk layout and items; the collater adds
    the prompts."""


class SAMMattingCollater:

    def __init__(self, resize=1024, n_points=9,
                 prompt_probs=(0.5, 0.25, 0.25)):
        self.resize = resize
        self.n_points = n_points
        self.prompt_probs = prompt_probs

    def __call__(self, samples):
        n = len(samples)
        r = self.resize
        rq = r // 4
        image = torch.zeros((n, 3, r, r))
        mask = torch.zeros((n, r, r))
        trimap = torch.zeros((n, r, r))
        fg_map = torch.zeros((n, 3, r, r))
        bg_map = torch.zeros((n, 3, r, r))
        points = np.full((n, self.n_points, 3), -1.0, np.float32)
        boxes = np.zeros((n, 4), np.float32)
        boxes_valid = np.zeros((n,), np.float32)
        prompt_masks = torch.zeros((n, 1, rq, rq))
        masks_valid = np.zeros((n,), np.float32)
        for i, s in enumerate(samples):
            h, w = s["image"].shape[:2]
            factor = r / max(h, w)
            rh, rw = int(round(h * factor)), int(round(w * factor))
            chw = lambda x: np.asarray(x).transpose(2, 0, 1)  # noqa: E731
            image[i, :, :rh, :rw] = _resize(chw(s["image"]), (rh, rw),
                                            "bilinear")
            mask[i, :rh, :rw] = _resize(s["mask"], (rh, rw), "bilinear")
            trimap[i, :rh, :rw] = _resize(s["trimap"], (rh, rw), "nearest")
            fg_map[i, :, :rh, :rw] = _resize(chw(s["fg_map"]), (rh, rw),
                                             "bilinear")
            bg_map[i, :, :rh, :rw] = _resize(chw(s["bg_map"]), (rh, rw),
                                             "bilinear")

            binary = (mask[i].numpy() > 0.5).astype(np.float32)
            ptype = np.random.choice(3, p=self.prompt_probs)
            if ptype == 0:
                k = np.random.randint(1, self.n_points + 1)
                points[i, :k] = load_points(binary, k)[:k]
            elif ptype == 1:
                box, ok = mask_to_box(binary)
                if ok:
                    boxes[i] = noise_box(box, (r, r))
                    boxes_valid[i] = 1.0
            else:
                small = _resize(noise_mask(binary), (rq, rq), "bilinear")
                prompt_masks[i, 0] = (small > 0.5).float()
                masks_valid[i] = 1.0
        return {
            "image": image,
            "mask": mask,
            "trimap": trimap,
            "fg_map": fg_map,
            "bg_map": bg_map,
            "prompt_point": torch.from_numpy(points),
            "prompt_box": torch.from_numpy(boxes),
            "prompt_box_valid": torch.from_numpy(boxes_valid),
            "prompt_mask": prompt_masks,
            "prompt_mask_valid": torch.from_numpy(masks_valid),
        }
