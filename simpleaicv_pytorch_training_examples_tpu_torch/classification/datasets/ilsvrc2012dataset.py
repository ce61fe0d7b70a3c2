"""ILSVRC2012 (ImageNet-1K) folder-per-class dataset.

root_dir/{train,val}/<wnid>/*.JPEG, labels from sorted class-dir order,
decoded to RGB uint8 by the native libjpeg core (``data/native_jpeg.py``),
as the JAX package's does. The core is built in the constructor, in the
process that makes the dataset, before any loader worker starts; where it
cannot be built, a dataset with images raises there.
"""

import os

import numpy as np

from ...data.native_jpeg import decode_jpeg
from ...native import lib


def list_class_folders(set_dir):
    """(class name -> index, image paths, int64 labels) of a
    folder-per-class tree; empty where the folder is missing, so configs
    stay importable on machines without the data."""
    class_names = sorted(os.listdir(set_dir)) \
        if os.path.isdir(set_dir) else []
    class_to_idx = {c: i for i, c in enumerate(class_names)}
    paths, labels = [], []
    for cls in class_names:
        cls_dir = os.path.join(set_dir, cls)
        if not os.path.isdir(cls_dir):
            continue
        for name in sorted(os.listdir(cls_dir)):
            paths.append(os.path.join(cls_dir, name))
            labels.append(class_to_idx[cls])
    return class_to_idx, paths, np.asarray(labels, dtype=np.int64)


def decode_image(path):
    """RGB uint8 of an image file; raises where it cannot be decoded."""
    image = decode_jpeg(path)
    if image is None:
        raise ValueError(f"{path}: not an image that libjpeg or cv2 reads")
    return image


class ILSVRC2012Dataset:

    def __init__(self, root_dir, set_name="train", transform=None):
        assert set_name in ("train", "val")
        self.transform = transform
        self.class_to_idx, self.image_paths, self.labels = \
            list_class_folders(os.path.join(root_dir, set_name))
        if self.image_paths:
            lib()

    def __len__(self):
        return len(self.image_paths)

    def __getitem__(self, idx):
        # stays uint8 through crop/resize; the float conversion belongs to
        # TorchMeanStdNormalize
        sample = {"image": decode_image(self.image_paths[idx]),
                  "label": int(self.labels[idx])}
        if self.transform is not None:
            sample = self.transform(sample)
        return sample
