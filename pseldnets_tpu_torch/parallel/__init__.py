"""Data parallelism over processes (parallel/mesh.py). Tensor parallelism
(the JAX package's parallel/tp.py) is not ported yet: ROADMAP.md queue A,
step 11, and ``trainer.tensor_parallel`` > 1 raises in train/module.py."""

from .mesh import (all_reduce_mean_, all_reduce_sum, barrier, batch_rows, broadcast_flag,
                   broadcast_state, init_data_parallel, is_up, local_rank, rank, rank_device,
                   shutdown, world)

__all__ = ["all_reduce_mean_", "all_reduce_sum", "barrier", "batch_rows", "broadcast_flag",
           "broadcast_state", "init_data_parallel", "is_up", "local_rank", "rank",
           "rank_device", "shutdown", "world"]
