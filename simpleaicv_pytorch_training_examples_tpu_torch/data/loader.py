"""Host-side input pipeline.

Counterpart of the JAX package's ``data/loader.py``: ``Compose`` over dict
samples, and batching through ``torch.utils.data.DataLoader`` with the
config's collater. Worker processes start with the ``spawn`` method (no fork
of a process that holds CUDA state and threads); batches are pinned when
they go to a CUDA device, so the copy to the card can be asynchronous.
"""

import multiprocessing
import os

import torch
from torch.utils.data import DataLoader


class Compose:
    """transforms.Compose over dict samples."""

    def __init__(self, transforms):
        self.transforms = transforms

    def __call__(self, sample):
        for t in self.transforms:
            sample = t(sample)
        return sample


def build_loader(dataset, batch_size, collater, device, num_workers=0):
    """Eval DataLoader over a map-style dataset of dict samples: in order,
    the last batch kept even when short. ``num_workers`` is capped at the
    host's core count; 0 loads in the calling process."""
    num_workers = max(0, min(num_workers, os.cpu_count() or 1))
    return DataLoader(
        dataset, batch_size=batch_size, shuffle=False, collate_fn=collater,
        num_workers=num_workers, drop_last=False,
        pin_memory=torch.device(device).type == "cuda",
        multiprocessing_context=(multiprocessing.get_context("spawn")
                                 if num_workers > 0 else None))
