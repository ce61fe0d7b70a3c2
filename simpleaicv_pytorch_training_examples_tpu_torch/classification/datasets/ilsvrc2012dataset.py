"""ILSVRC2012 (ImageNet-1K) folder-per-class dataset.

root_dir/{train,val}/<wnid>/*.JPEG, labels from sorted class-dir order,
decoded to RGB uint8 with cv2 (the native libjpeg front-end of the JAX
package is not ported yet).
"""

import os

import numpy as np


class ILSVRC2012Dataset:

    def __init__(self, root_dir, set_name="train", transform=None):
        assert set_name in ("train", "val")
        self.transform = transform
        set_dir = os.path.join(root_dir, set_name)
        # tolerate a missing dataset root: configs must stay importable on
        # machines without the data (the loader errors on first use)
        class_names = sorted(os.listdir(set_dir)) \
            if os.path.isdir(set_dir) else []
        self.class_to_idx = {c: i for i, c in enumerate(class_names)}
        self.image_paths = []
        self.labels = []
        for cls in class_names:
            cls_dir = os.path.join(set_dir, cls)
            if not os.path.isdir(cls_dir):
                continue
            for name in sorted(os.listdir(cls_dir)):
                self.image_paths.append(os.path.join(cls_dir, name))
                self.labels.append(self.class_to_idx[cls])
        self.labels = np.asarray(self.labels, dtype=np.int64)

    def __len__(self):
        return len(self.image_paths)

    def __getitem__(self, idx):
        import cv2
        data = np.fromfile(self.image_paths[idx], dtype=np.uint8)
        image = cv2.cvtColor(cv2.imdecode(data, cv2.IMREAD_COLOR),
                             cv2.COLOR_BGR2RGB)
        # stays uint8 through crop/resize; the float conversion belongs to
        # TorchMeanStdNormalize
        sample = {"image": image, "label": int(self.labels[idx])}
        if self.transform is not None:
            sample = self.transform(sample)
        return sample
