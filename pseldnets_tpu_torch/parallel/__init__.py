"""Data parallelism over processes (parallel/mesh.py) and tensor
parallelism over a 2-D (data, model) layout of them (parallel/tp.py)."""

from .mesh import (all_reduce_mean_, all_reduce_sum, barrier, batch_rows, broadcast_flag,
                   broadcast_state, data_rank, data_world, init_data_parallel, init_layout,
                   is_up, local_rank, model_rank, model_world, rank, rank_device, shutdown,
                   world)

__all__ = ["all_reduce_mean_", "all_reduce_sum", "barrier", "batch_rows", "broadcast_flag",
           "broadcast_state", "data_rank", "data_world", "init_data_parallel", "init_layout",
           "is_up", "local_rank", "model_rank", "model_world", "rank", "rank_device",
           "shutdown", "world"]
