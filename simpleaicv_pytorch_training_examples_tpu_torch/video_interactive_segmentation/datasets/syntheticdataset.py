"""Seeded synthetic video clips for SAM2.

Stands in for SA-V where no videos are at hand (smoke runs, tests), as
``interactive_segmentation/datasets/syntheticdataset.py`` does for SA-1B.
The clips are the video prediction tool's: discs of flat colours moving a
fixed number of pixels a frame over noise (``moving_discs``). Clip ``i`` is
made from ``seed`` and ``i`` alone: two or three discs of random centres,
radii, speeds and colours; its target is the first disc, the part of it
that the later discs leave visible, so that the target may shrink or vanish
for a frame (the occlusion head's case). The default 384 x 512 frames are
not square, so the collater's resize-and-pad path runs. Items are
{"images": [T, H, W, 3] float32 0-255 RGB, "masks": [T, H, W] float32
{0, 1}}, the layout of ``SAM2VideoSegmentationDataset``'s items.
"""

import numpy as np

__all__ = ["moving_discs", "SyntheticSAM2VideoDataset"]


def moving_discs(frames, height, width, discs, rs):
    """``frames`` frames of noise (0-50) drawn from ``rs`` with ``discs``
    painted over it in order, each (cx, cy, radius, vx, vy, (r, g, b))
    moving (vx, vy) pixels a frame from (cx, cy). Returns the clip [T, H, W,
    3] float32 of 0-255 integers and the label map [T, H, W] int (k + 1
    where disc k is visible, 0 elsewhere)."""
    yy, xx = np.mgrid[:height, :width]
    clip = np.empty((frames, height, width, 3), np.float32)
    labels = np.zeros((frames, height, width), np.int64)
    for t in range(frames):
        img = (rs.rand(height, width, 3) * 50).astype(np.float32)
        for k, (cx, cy, r, vx, vy, colour) in enumerate(discs):
            disc = (xx - (cx + vx * t)) ** 2 + (yy - (cy + vy * t)) ** 2 \
                <= r * r
            img[disc] = colour
            labels[t][disc] = k + 1
        clip[t] = img.astype(np.uint8)
    return clip, labels


class SyntheticSAM2VideoDataset:

    def __init__(self, n=8, frame_nums=8, image_size=(384, 512), seed=0,
                 transform=None):
        self.n = n
        self.frame_nums = frame_nums
        self.image_size = tuple(image_size)
        self.seed = seed
        self.transform = transform

    def __len__(self):
        return self.n

    def __getitem__(self, idx):
        rs = np.random.RandomState((self.seed * 1000003 + idx) % (2 ** 31))
        h, w = self.image_size
        side = min(h, w)
        discs = []
        for _ in range(rs.randint(2, 4)):
            discs.append((int(rs.uniform(0.25, 0.75) * w),
                          int(rs.uniform(0.25, 0.75) * h),
                          int(rs.uniform(0.08, 0.2) * side),
                          int(rs.uniform(-0.02, 0.02) * w),
                          int(rs.uniform(-0.02, 0.02) * h),
                          tuple(rs.uniform(60, 255, 3).astype(np.float32))))
        clip, labels = moving_discs(self.frame_nums, h, w, discs, rs)
        sample = {"images": clip,
                  "masks": (labels == 1).astype(np.float32)}
        if self.transform is not None:
            sample = self.transform(sample)
        return sample
