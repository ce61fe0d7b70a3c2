"""CIFAR-100 in the pickled ``cifar-100-python`` layout.

Counterpart of the JAX package's ``cifar100dataset.py``: reads
root_dir/cifar-100-python/{train,test} (``data`` [N, 3072] uint8 in CHW
order, ``fine_labels``) and gives dict samples {'image': HWC float32,
'label': int}. A missing file gives an empty dataset, so configs stay
importable on machines without the data.
"""

import os
import pickle

import numpy as np


def load_pickle(path):
    with open(path, "rb") as f:
        return pickle.load(f, encoding="bytes")


class CIFAR100Dataset:

    def __init__(self, root_dir, set_name="train", transform=None):
        assert set_name in ("train", "test")
        self.transform = transform
        path = os.path.join(root_dir, "cifar-100-python", set_name)
        if os.path.exists(path):
            entry = load_pickle(path)
            data, labels = entry[b"data"], entry[b"fine_labels"]
        else:
            data, labels = np.zeros((0, 3072), np.uint8), []
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
