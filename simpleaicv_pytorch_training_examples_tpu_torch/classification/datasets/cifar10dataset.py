"""CIFAR-10 in the pickled ``cifar-10-batches-py`` layout.

Counterpart of the JAX package's ``cifar10dataset.py``: the train set is
``data_batch_1``...``data_batch_5``, the test set ``test_batch`` (``data``
[N, 3072] uint8 in CHW order, ``labels``); dict samples {'image': HWC
float32, 'label': int}. Missing files are skipped, so configs stay
importable on machines without the data.
"""

import os

import numpy as np

from .cifar100dataset import load_pickle


class CIFAR10Dataset:

    def __init__(self, root_dir, set_name="train", transform=None):
        assert set_name in ("train", "test")
        self.transform = transform
        base = os.path.join(root_dir, "cifar-10-batches-py")
        files = ([f"data_batch_{i}" for i in range(1, 6)]
                 if set_name == "train" else ["test_batch"])
        images, labels = [], []
        for name in files:
            path = os.path.join(base, name)
            if os.path.exists(path):
                entry = load_pickle(path)
                images.append(entry[b"data"])
                labels.extend(entry[b"labels"])
        data = np.concatenate(images) if images else np.zeros(
            (0, 3072), np.uint8)
        self.images = data.reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1)
        self.labels = np.asarray(labels, dtype=np.int64)

    def __len__(self):
        return len(self.images)

    def __getitem__(self, idx):
        sample = {"image": self.images[idx].astype(np.float32),
                  "label": int(self.labels[idx])}
        if self.transform is not None:
            sample = self.transform(sample)
        return sample
