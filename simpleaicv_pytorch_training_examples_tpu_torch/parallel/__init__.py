from .mesh import (all_reduce_mean_, distributed_init, is_main_process,
                   pad_batch_to_multiple, process_group, rank, shard_batch,
                   world_size, zero1_shard_dims)

__all__ = ["all_reduce_mean_", "distributed_init", "is_main_process",
           "pad_batch_to_multiple", "process_group", "rank", "shard_batch",
           "world_size", "zero1_shard_dims"]
