"""Host-side input pipeline.

Counterpart of the JAX package's ``data/loader.py``: ``Compose`` over dict
samples, and batching through ``torch.utils.data.DataLoader`` with the
config's collater: ``build_loader`` for eval (in order, the short last
batch kept), ``TrainLoader`` for training, whose batches are the JAX
loader's (``DataLoader._epoch_indices``): the permutation of
``np.random.RandomState((seed + epoch) % 2**31)`` cut into batches, the
last short one dropped.

The samples are made in worker *processes* (the JAX package uses a thread
pool): they keep the numpy transforms off one interpreter lock, and each
worker's ``np.random`` is seeded from ``seed + epoch``, so an epoch of a
resumed run is the epoch an uninterrupted run would have had, which threads
drawing from one global ``np.random`` could not give. Workers are started
anew each epoch (never persistent, which would keep the last epoch's
seeds) and prefetch ``PREFETCH`` batches each (the JAX loader's
``prefetch``). They are forked from a forkserver: a fresh process, started
once, that holds no CUDA state and has imported torch and this module
(``PRELOAD``): 8 workers start in under 2 s on the H100's host, where
``spawn``-ed ones, each importing torch anew every epoch, took over a
minute (PERF.md). Batches are pinned when they go to a CUDA
device, so the copy to the card can be asynchronous.

Data parallelism (``parallel/mesh.py``): ``batch_size`` is the global
batch, and with ``process_count`` > 1 each process loads only its
contiguous slice of each global batch, rows ``[process_index * local,
(process_index + 1) * local)`` (the JAX loader's ``_epoch_indices``;
``parallel/mesh.shard_batch``). Each
rank's workers are seeded apart (rank 0 keeps the one-process seeds). The
eval loader slices the short last batch the same way and skips a rank's
empty slice.
"""

import multiprocessing
import os

import numpy as np
import torch
from torch.utils.data import DataLoader, Sampler

from ..parallel.mesh import shard_batch

PREFETCH = 4
PRELOAD = ("torch", "numpy", __name__)


class Compose:
    """transforms.Compose over dict samples."""

    def __init__(self, transforms):
        self.transforms = transforms

    def __call__(self, sample):
        for t in self.transforms:
            sample = t(sample)
        return sample


def _workers(num_workers):
    return max(0, min(num_workers, os.cpu_count() or 1))


def _worker_options(num_workers):
    if num_workers == 0:
        return {}
    context = multiprocessing.get_context("forkserver")
    context.set_forkserver_preload(list(PRELOAD))
    return {"multiprocessing_context": context, "prefetch_factor": PREFETCH}


def _seed_worker_numpy(worker_id):
    """Seed a worker's global ``np.random`` (which the transforms and the
    collater draw from) from the seed torch gave the worker."""
    np.random.seed(torch.initial_seed() % 2 ** 32)


def epoch_batches(n, batch_size, seed, epoch):
    """The JAX loader's training batches of one epoch: index arrays of
    ``np.random.RandomState((seed + epoch) % 2**31).permutation(n)`` cut
    into ``batch_size`` pieces, the last short piece dropped."""
    order = np.random.RandomState((seed + epoch) % 2 ** 31).permutation(n)
    return [order[b * batch_size:(b + 1) * batch_size]
            for b in range(n // batch_size)]


class _EpochBatchSampler(Sampler):
    """``epoch_batches`` of the loader's current epoch, this process's slice
    of each, as index lists."""

    def __init__(self, n, batch_size, seed, process_index=0,
                 process_count=1):
        self.n, self.batch_size, self.seed = n, batch_size, seed
        self.process_index, self.process_count = process_index, process_count
        self.epoch = 0

    def __len__(self):
        return self.n // self.batch_size

    def __iter__(self):
        for batch in epoch_batches(self.n, self.batch_size, self.seed,
                                   self.epoch):
            yield shard_batch(batch, self.batch_size, self.process_index,
                              self.process_count).tolist()


class _EvalBatchSampler(Sampler):
    """In order, the short last batch kept: this process's slice of each
    global batch, empty slices skipped."""

    def __init__(self, n, batch_size, process_index, process_count):
        self.n, self.batch_size = n, batch_size
        self.process_index, self.process_count = process_index, process_count

    def __iter__(self):
        for start in range(0, self.n, self.batch_size):
            rows = shard_batch(
                np.arange(start, min(start + self.batch_size, self.n)),
                self.batch_size, self.process_index, self.process_count)
            if len(rows):
                yield rows.tolist()


class TrainLoader:
    """Train DataLoader in the JAX loader's batch order, reseeded for each
    epoch through ``set_epoch``.

    The batches, the workers' torch seeds and, through them, their numpy
    seeds all follow from ``seed + epoch``. With ``num_workers=0`` the
    transforms and the collater run in the calling process, whose global
    ``np.random`` is then seeded at the start of each epoch.
    """

    def __init__(self, dataset, batch_size, collater, device, seed=0,
                 num_workers=0, process_index=0, process_count=1):
        self.seed = seed
        self.process_index = process_index
        self.num_workers = _workers(num_workers)
        self.generator = torch.Generator()
        self.sampler = _EpochBatchSampler(len(dataset), batch_size, seed,
                                          process_index, process_count)
        self.loader = DataLoader(
            dataset, batch_sampler=self.sampler, collate_fn=collater,
            num_workers=self.num_workers,
            pin_memory=torch.device(device).type == "cuda",
            generator=self.generator, worker_init_fn=_seed_worker_numpy,
            **_worker_options(self.num_workers))

    @property
    def epoch(self):
        return self.sampler.epoch

    def set_epoch(self, epoch: int):
        self.sampler.epoch = epoch

    def __len__(self):
        return len(self.sampler)

    def __iter__(self):
        epoch_seed = (self.seed + self.epoch
                      + 1000003 * self.process_index) % 2 ** 31
        self.generator.manual_seed(epoch_seed)
        if self.num_workers == 0:
            np.random.seed(epoch_seed)
        return iter(self.loader)


def build_loader(dataset, batch_size, collater, device, num_workers=0,
                 process_index=0, process_count=1):
    """Eval DataLoader over a map-style dataset of dict samples: in order,
    the last batch kept even when short; with ``process_count`` > 1 this
    process's slice of each global batch of ``batch_size``. ``num_workers``
    is capped at the host's core count; 0 loads in the calling process."""
    num_workers = _workers(num_workers)
    if process_count > 1:
        batching = {"batch_sampler": _EvalBatchSampler(
            len(dataset), batch_size, process_index, process_count)}
    else:
        batching = {"batch_size": batch_size, "shuffle": False,
                    "drop_last": False}
    return DataLoader(
        dataset, collate_fn=collater, num_workers=num_workers,
        pin_memory=torch.device(device).type == "cuda",
        **batching, **_worker_options(num_workers))
