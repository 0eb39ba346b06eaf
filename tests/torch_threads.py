"""CPU thread pools for the port's tests under pytest-xdist.

Each xdist worker is a process of its own, and torch's OpenMP pool and
numpy's BLAS pool each start one thread per core in every worker. With
several workers on the machine, their spinning threads outnumber the cores
many times over and a small torch or numpy call can take seconds. Importing
this module gives each worker its share of the cores instead (at least one
thread); outside xdist, or with one worker, nothing changes. The numbers a
test computes do not depend on it beyond float32 summation order, which no
test's bound rests on.
"""

import os

import torch

_WORKERS = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1") or 1)

if _WORKERS > 1:
    THREADS = max(1, (os.cpu_count() or 1) // _WORKERS)
    torch.set_num_threads(THREADS)
    try:
        from threadpoolctl import threadpool_limits
    except ImportError:  # numpy's BLAS keeps its pool
        pass
    else:
        threadpool_limits(THREADS, user_api="blas")
