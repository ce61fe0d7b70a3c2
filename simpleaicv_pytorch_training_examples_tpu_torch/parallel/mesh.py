"""Data parallelism over processes: one process per GPU (``torchrun``), NCCL
between them, or ``gloo`` between CPU processes.

Counterpart of the JAX package's ``parallel/mesh.py``. There the global
batch is one array sharded over a ``data`` axis under ``jit``: the loss is
the mean over the global batch, so the gradients and the BatchNorm
statistics are those of the global batch. Here each process holds its
contiguous slice of the global batch (``data/loader.py``), and the port
computes the same global quantities explicitly:

- the train step averages the gradients (and the loss and metrics) over the
  world once per optimizer step, in one bucketed ``all_reduce``
  (``all_reduce_mean_``, ``engine/engine.py``);
- ``models/common.BatchNorm2d`` reduces its batch statistics over the world
  in training, and its backward reduces their gradients, so every rank
  normalises by the global batch's mean and biased variance (plain DDP, or
  ``nn.SyncBatchNorm`` with its torch update, would not give Flax's
  numbers);
- the evaluator pads each batch (``pad_batch_to_multiple``), counts only the
  real rows and sums the counts over the world;
- with ``use_zero1`` the optimizer's moments are sharded on the dimension
  that ``zero1_shard_dims`` picks (``utils/optimizers.py``).

Without torchrun's ``RANK`` / ``WORLD_SIZE`` / ``LOCAL_RANK`` nothing is
initialised: the world is one process and no collective runs.
"""

import os

import numpy as np
import torch
import torch.distributed as dist

__all__ = ["distributed_init", "process_group", "world_size", "rank",
           "is_main_process", "shard_batch", "pad_batch_to_multiple",
           "zero1_shard_dims", "all_reduce_mean_"]


def distributed_init(device=None, init_method="env://"):
    """Join torchrun's process group; returns the device this process runs
    on.

    Reads ``RANK``, ``WORLD_SIZE`` and ``LOCAL_RANK``; without them (or when
    the group is already up) it initialises nothing and returns ``device``
    as it is. On CUDA the group is NCCL's and the device ``cuda:LOCAL_RANK``;
    on the CPU it is ``gloo``'s. ``init_method`` is torchrun's ``env://``
    rendezvous by default (``MASTER_ADDR`` / ``MASTER_PORT``); a test passes
    a ``file://`` one."""
    device = torch.device("cuda" if device is None else device)
    if dist.is_available() and dist.is_initialized():
        return _local_device(device)
    if "RANK" not in os.environ or "WORLD_SIZE" not in os.environ:
        return device
    if device.type == "cuda":
        device = _local_device(device)
        torch.cuda.set_device(device)
        backend = "nccl"
    else:
        backend = "gloo"
    dist.init_process_group(backend, init_method=init_method,
                            rank=int(os.environ["RANK"]),
                            world_size=int(os.environ["WORLD_SIZE"]))
    return device


def _local_device(device):
    if device.type != "cuda":
        return device
    return torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))


def process_group():
    """True while a process group is up (torchrun, at any world size)."""
    return dist.is_available() and dist.is_initialized()


def world_size() -> int:
    return dist.get_world_size() if process_group() else 1


def rank() -> int:
    return dist.get_rank() if process_group() else 0


def is_main_process() -> bool:
    """Rank 0 logs and writes the checkpoints."""
    return rank() == 0


def shard_batch(rows, batch_size=None, index=None, count=None):
    """This rank's contiguous rows of one global batch of ``batch_size``
    (``len(rows)`` by default): ``[index * local, (index + 1) * local)``
    with ``local = batch_size // count``, fewer or none in a short last
    batch (the JAX loader's ``process_index * local_batch_size`` slice).
    ``rows`` is anything sliced on its first dimension: the loader's index
    arrays, or a batch's tensors."""
    index = rank() if index is None else index
    count = world_size() if count is None else count
    batch_size = len(rows) if batch_size is None else batch_size
    assert batch_size % count == 0, (
        f"global batch {batch_size} % devices {count} != 0")
    local = batch_size // count
    return rows[index * local:(index + 1) * local]


def pad_batch_to_multiple(batch, multiple: int):
    """Pad every entry's leading dim with zeros up to a multiple of
    ``multiple``; returns ``(padded batch, real row count)``."""
    sizes = {v.shape[0] for v in batch.values()}
    assert len(sizes) == 1, "ragged batch"
    n = sizes.pop()
    target = ((n + multiple - 1) // multiple) * multiple
    if target == n:
        return batch, n

    def pad(x):
        if torch.is_tensor(x):
            extra = x.new_zeros((target - n,) + tuple(x.shape[1:]))
            return torch.cat([x, extra])
        return np.pad(x, [(0, target - n)] + [(0, 0)] * (x.ndim - 1))

    return {k: pad(v) for k, v in batch.items()}, n


def zero1_shard_dims(shapes, n_dp: int):
    """ZeRO-1's layout: for each moment shape, the first dimension of size
    at least ``n_dp`` that ``n_dp`` divides, or None (a small or indivisible
    leaf stays replicated), as the JAX package's
    ``zero1_opt_state_sharding``."""
    dims = []
    for shape in shapes:
        dims.append(next((axis for axis, s in enumerate(shape)
                          if s >= n_dp and s % n_dp == 0), None))
    return dims


def all_reduce_mean_(tensors):
    """Average ``tensors`` (fp32, one device) over the world in place, through
    one ``all_reduce`` of a flat bucket; nothing runs without a process
    group."""
    if not process_group() or not tensors:
        return tensors
    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(flat)
    flat.div_(world_size())
    offset = 0
    for t in tensors:
        t.copy_(flat[offset:offset + t.numel()].view_as(t))
        offset += t.numel()
    return tensors
