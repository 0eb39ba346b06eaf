"""Data parallelism over processes, one device each: the counterpart of the
JAX package's parallel/mesh.py (:1-77).

The reference's only parallelism is Lightning's DDP (configs/trainer/
gpu.yaml: ``strategy: ddp``, ``sync_batchnorm: True``). The JAX package
runs it as one program over a 1-D ``('data',)`` mesh: the batch is sharded
over the axis, the parameters are replicated, GSPMD sums the gradients and
makes the BatchNorm statistics global. The port runs it as W processes in
a ``torch.distributed`` group, one device each (NCCL on the card, gloo on
the CPU; the backend is the caller's choice, never a fallback), with the
collectives of that program written out:

- ``broadcast_state``: rank 0's parameters and buffers to every rank (the
  JAX ``replicate``);
- ``all_reduce_mean_``: the gradients' mean over ranks, one flat buffer a
  dtype;
- ``all_reduce_sum``: a differentiable all-reduce, the sum forward and the
  sum of the ranks' upstream gradients backward, which the training
  BatchNorm takes its global statistics through (models/common.py
  ``TorchBatchNorm.batch_forward``);
- ``batch_rows``: a per-clip random draw of the global batch (W * B rows)
  of which each rank keeps rows ``rank::W``, the rows that the sampler
  (data/sampler.py:52-54) gives it, so a W-rank step draws what one process
  draws on the global batch.

A step of W ranks on B clips each is then the one-process step on the
global batch of W * B clips (rank r's clips at rows r, r + W, ...), up to
float32 summation order, as the JAX step over the mesh is. Without a group
every function here is the one-process identity and ``world()`` is 1.
"""

from typing import Callable, Iterable, List, Optional

import torch
import torch.distributed as dist

__all__ = ["init_data_parallel", "shutdown", "is_up", "world", "rank", "local_rank",
           "rank_device", "all_reduce_mean_", "all_reduce_sum", "broadcast_state",
           "barrier", "broadcast_flag", "batch_rows"]


def is_up() -> bool:
    """Whether a process group is up in this process."""
    return dist.is_available() and dist.is_initialized()


def world() -> int:
    """The group's size, 1 without a group."""
    return dist.get_world_size() if is_up() else 1


def rank() -> int:
    """This process's rank, 0 without a group."""
    return dist.get_rank() if is_up() else 0


def local_rank() -> int:
    """This process's rank on its host: ``LOCAL_RANK`` where a launcher
    (torchrun) set it, else the group rank."""
    import os

    return int(os.environ["LOCAL_RANK"]) if "LOCAL_RANK" in os.environ else rank()


def rank_device(device_type: str, local: int) -> torch.device:
    """The device of local rank ``local``: ``cuda:{local}`` on the card (an
    explicit index: ``cuda`` alone means the current device, which is not
    the rank's), the CPU otherwise."""
    if device_type == "cuda":
        return torch.device("cuda", local)
    return torch.device(device_type)


def init_data_parallel(rank_: int, world_: int, backend: str, init_method: str,
                       device: Optional[torch.device] = None) -> None:
    """Join a group of ``world_`` processes as ``rank_`` over ``backend``
    ("nccl" on the card, "gloo" on the CPU) at ``init_method``
    (``tcp://localhost:<port>``, ``file://<path>`` or ``env://``). On the
    card ``device`` is this rank's (the current device is set to it, and
    NCCL binds it)."""
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"backend {backend!r}: the port runs nccl on the card, gloo on the CPU")
    if is_up():
        raise RuntimeError("a process group is already up in this process")
    kw = {}
    if device is not None and device.type == "cuda":
        torch.cuda.set_device(device)
        if backend == "nccl":
            kw["device_id"] = device
    dist.init_process_group(backend, init_method=init_method, rank=int(rank_),
                            world_size=int(world_), **kw)


def shutdown() -> None:
    """Leave the group (the teardown of ``init_data_parallel``); nothing
    without one."""
    if is_up():
        dist.destroy_process_group()


def barrier() -> None:
    if is_up():
        dist.barrier()


def all_reduce_mean_(tensors: Iterable[torch.Tensor]) -> List[torch.Tensor]:
    """Each tensor replaced in place by its mean over the ranks: the tensors
    of one dtype packed into one flat buffer, one all-reduce a dtype (not
    one a tensor), the sum divided by the world size. With a group of one
    the values come back bit for bit. Without a group, nothing."""
    tensors = list(tensors)
    if not is_up() or not tensors:
        return tensors
    W = world()
    by_dtype = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for group in by_dtype.values():
        flat = torch.cat([t.reshape(-1) for t in group])
        dist.all_reduce(flat)
        if W > 1:
            flat.div_(W)
        _unflatten_into(flat, group)
    return tensors


def _unflatten_into(flat: torch.Tensor, tensors: List[torch.Tensor]) -> None:
    """Copy consecutive slices of ``flat`` into ``tensors``, in one
    multi-tensor copy (a launch a chunk of tensors, not one a tensor)."""
    views = list(torch.split(flat, [t.numel() for t in tensors]))
    torch._foreach_copy_(tensors, [v.view_as(t) for v, t in zip(views, tensors)])


class _AllReduceSum(torch.autograd.Function):
    """All-reduce SUM forward; backward, the all-reduce SUM of the upstream
    gradients, so each rank's input gets the sum over ranks of what its
    output fed (torch's SyncBatchNorm rule). The ranks run their backwards
    in one order, so their collectives pair."""

    @staticmethod
    def forward(ctx, x):
        y = x.clone()
        dist.all_reduce(y)
        return y

    @staticmethod
    def backward(ctx, grad):
        g = grad.contiguous().clone()
        dist.all_reduce(g)
        return g


def all_reduce_sum(x: torch.Tensor) -> torch.Tensor:
    """The sum of ``x`` over the ranks, differentiable (``_AllReduceSum``);
    ``x`` itself without a group."""
    return _AllReduceSum.apply(x) if is_up() else x


def broadcast_state(module: torch.nn.Module) -> None:
    """Rank 0's parameters and buffers to every rank, one broadcast a dtype
    (the JAX ``replicate``): after ``init_state``, whether it initialised,
    loaded a pretrained file or resumed, every rank holds rank 0's state."""
    if not is_up():
        return
    by_dtype = {}
    for t in list(module.parameters()) + list(module.buffers()):
        by_dtype.setdefault(t.dtype, []).append(t)
    with torch.no_grad():
        for group in by_dtype.values():
            flat = torch.cat([t.detach().reshape(-1) for t in group])
            dist.broadcast(flat, 0)
            _unflatten_into(flat, group)


def broadcast_flag(flag: bool, device: torch.device) -> bool:
    """Rank 0's ``flag`` on every rank (one int32 broadcast on ``device``);
    ``flag`` itself without a group."""
    if not is_up():
        return bool(flag)
    t = torch.tensor([int(bool(flag))], dtype=torch.int32, device=device)
    dist.broadcast(t, 0)
    return bool(t.item())


def batch_rows(draw: Callable[[int], torch.Tensor], B: int, axis: int = 0) -> torch.Tensor:
    """A per-clip random draw of this rank's B clips: ``draw(n)`` draws for
    n clips along ``axis``; under W ranks it draws for the global W * B and
    this rank keeps rows ``rank::W`` (the sampler's rows), so every rank
    advances its generator as one process on the global batch would, and
    the W ranks' rows together are that process's draw. Without a group,
    or with one rank, ``draw(B)`` itself."""
    W = world()
    if W == 1:
        return draw(B)
    full = draw(W * B)
    index = (slice(None),) * axis + (slice(rank(), None, W),)
    return full[index].contiguous()
