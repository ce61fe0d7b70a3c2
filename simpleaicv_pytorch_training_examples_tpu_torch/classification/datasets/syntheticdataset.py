"""Seeded synthetic classification dataset.

Stands in for ImageNet where no images are at hand (smoke runs, tests):
sample ``i`` is a normalised-scale HWC float32 image of Gaussian noise plus
a class-dependent offset, made from ``seed`` and ``i`` alone, so any worker
makes the same sample and a model can tell the classes apart.
"""

import numpy as np


class SyntheticClassificationDataset:

    def __init__(self, n=768, image_size=224, num_classes=1000, seed=0,
                 transform=None):
        self.n = n
        self.image_size = image_size
        self.num_classes = num_classes
        self.seed = seed
        self.transform = transform
        self.labels = np.random.RandomState(seed).randint(
            0, num_classes, n).astype(np.int64)

    def __len__(self):
        return self.n

    def __getitem__(self, idx):
        rs = np.random.RandomState((self.seed * 1000003 + idx) % (2**31))
        label = int(self.labels[idx])
        image = rs.standard_normal(
            (self.image_size, self.image_size, 3)).astype(np.float32)
        image += 2.0 * label / self.num_classes - 1.0
        sample = {"image": image, "label": label}
        if self.transform is not None:
            sample = self.transform(sample)
        return sample
