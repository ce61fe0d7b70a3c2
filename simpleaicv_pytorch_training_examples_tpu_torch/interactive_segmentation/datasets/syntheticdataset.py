"""Seeded synthetic SAM dataset.

Stands in for SA-1B where no images are at hand (smoke runs, tests), as
``classification/datasets/syntheticdataset.py`` does for ImageNet. Sample
``i`` is made from ``seed`` and ``i`` alone: an H x W x 3 float32 RGB image
of 0-255 values (noise around a random background colour) with two to four
filled ellipses of random colours, and as its mask one of the ellipses
(float32 {0, 1}, the parts of it that later ellipses cover included). The
default 768 x 1024 is not square, so the collater's resize-and-pad path
runs.
"""

import numpy as np


class SyntheticSAMDataset:

    def __init__(self, n=32, image_size=(768, 1024), seed=0, transform=None):
        self.n = n
        self.image_size = tuple(image_size)
        self.seed = seed
        self.transform = transform

    def __len__(self):
        return self.n

    def __getitem__(self, idx):
        rs = np.random.RandomState((self.seed * 1000003 + idx) % (2 ** 31))
        h, w = self.image_size
        image = rs.uniform(0, 255, 3).astype(np.float32) + rs.normal(
            0.0, 12.0, (h, w, 3)).astype(np.float32)
        yy, xx = np.mgrid[:h, :w].astype(np.float32)
        blobs = []
        for _ in range(rs.randint(2, 5)):
            cy, cx = rs.uniform(0.2, 0.8) * h, rs.uniform(0.2, 0.8) * w
            ry, rx = rs.uniform(0.08, 0.3) * h, rs.uniform(0.08, 0.3) * w
            blob = ((yy - cy) / ry) ** 2 + ((xx - cx) / rx) ** 2 <= 1.0
            image[blob] = rs.uniform(0, 255, 3).astype(np.float32)
            blobs.append(blob)
        mask = blobs[rs.randint(len(blobs))].astype(np.float32)
        sample = {"image": np.clip(image, 0.0, 255.0), "mask": mask,
                  "size": np.array([h, w], np.float32)}
        if self.transform is not None:
            sample = self.transform(sample)
        return sample
