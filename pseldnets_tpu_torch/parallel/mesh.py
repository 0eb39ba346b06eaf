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

Tensor parallelism (parallel/tp.py) lays the W ranks out as the JAX
package's 2-D mesh, ``reshape(n_data, n_model)`` in row-major order
(its parallel/tp.py:39-46): ``init_layout(tp)`` makes rank r the data
index r // tp and the model index r % tp, with one group a model row (the
tp ranks that hold one batch's rows and split the layers) and one a data
column (the ranks that hold one part of the split layers). Then the data
parallelism above runs over the data column: ``all_reduce_mean_`` and
``all_reduce_sum`` reduce over it, and ``batch_rows`` and the sampler take
the data index and the data world (``data_rank``, ``data_world``), so the
tp ranks of a row see one batch and draw alike. Without a layout (tp = 1)
the data column is the whole group, as before.
"""

from dataclasses import dataclass
from typing import Any, Callable, Iterable, List, Optional

import torch
import torch.distributed as dist

__all__ = ["init_data_parallel", "shutdown", "is_up", "world", "rank", "local_rank",
           "rank_device", "all_reduce_mean_", "all_reduce_sum", "broadcast_state",
           "barrier", "broadcast_flag", "batch_rows", "init_layout", "data_world",
           "data_rank", "model_world", "model_rank", "data_group", "model_group"]


@dataclass(frozen=True)
class _Layout:
    """The (data, model) layout of the group (``init_layout``)."""

    tp: int
    n_data: int
    data_index: int
    model_index: int
    data_group: Any
    model_group: Any


_LAYOUT: Optional[_Layout] = None


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
    """Leave the group (the teardown of ``init_data_parallel``) and drop its
    layout; nothing without one."""
    global _LAYOUT
    _LAYOUT = None
    if is_up():
        dist.destroy_process_group()


def init_layout(tp: int) -> None:
    """Lay the group's W ranks out as ``W / tp`` data rows of ``tp`` model
    ranks (rank r: data index r // tp, model index r % tp; the JAX
    package's ``make_mesh_2d``) and make the groups of each model row and
    each data column; every rank calls it, with the same ``tp``. ``tp``
    must divide W (ValueError otherwise, as the JAX task raises,
    train/module.py:108-111); tp = 1 is no layout. Called again with the
    same ``tp`` it does nothing; with another, the groups are made anew."""
    global _LAYOUT
    tp, W = int(tp), world()
    if tp < 1 or W % tp:
        raise ValueError(f"tensor_parallel={tp} does not divide the {W} process(es)")
    if tp == 1:
        _LAYOUT = None
        return
    if _LAYOUT is not None and _LAYOUT.tp == tp:
        return
    n_data, r = W // tp, rank()
    # every rank makes every group, in one order, as new_group asks
    rows = [dist.new_group([d * tp + m for m in range(tp)]) for d in range(n_data)]
    cols = [dist.new_group([d * tp + m for d in range(n_data)]) for m in range(tp)]
    _LAYOUT = _Layout(tp, n_data, r // tp, r % tp, cols[r % tp], rows[r // tp])


def data_world() -> int:
    """The ranks of this rank's data column (the batch's shards): the
    world without a layout."""
    return _LAYOUT.n_data if _LAYOUT is not None else world()


def data_rank() -> int:
    """This rank's data index: its rank without a layout."""
    return _LAYOUT.data_index if _LAYOUT is not None else rank()


def model_world() -> int:
    """The ranks of this rank's model row (tp): 1 without a layout."""
    return _LAYOUT.tp if _LAYOUT is not None else 1


def model_rank() -> int:
    """This rank's model index: 0 without a layout."""
    return _LAYOUT.model_index if _LAYOUT is not None else 0


def data_group():
    """The data column's group (None, the whole group, without a layout)."""
    return _LAYOUT.data_group if _LAYOUT is not None else None


def model_group():
    """The model row's group (None without a layout)."""
    return _LAYOUT.model_group if _LAYOUT is not None else None


def barrier() -> None:
    if is_up():
        dist.barrier()


def all_reduce_mean_(tensors: Iterable[torch.Tensor]) -> List[torch.Tensor]:
    """Each tensor replaced in place by its mean over the data column: the
    tensors of one dtype packed into one flat buffer, one all-reduce a dtype
    (not one a tensor), the sum divided by the data world. With a group of
    one the values come back bit for bit. Without a group, or with a
    layout of one data row, nothing."""
    tensors = list(tensors)
    if not is_up() or not tensors or (_LAYOUT is not None and _LAYOUT.n_data == 1):
        return tensors
    W, group = data_world(), data_group()
    by_dtype = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for same in by_dtype.values():
        flat = torch.cat([t.reshape(-1) for t in same])
        dist.all_reduce(flat, group=group)
        if W > 1:
            flat.div_(W)
        _unflatten_into(flat, same)
    return tensors


def _unflatten_into(flat: torch.Tensor, tensors: List[torch.Tensor]) -> None:
    """Copy consecutive slices of ``flat`` into ``tensors``, in one
    multi-tensor copy (a launch a chunk of tensors, not one a tensor)."""
    views = list(torch.split(flat, [t.numel() for t in tensors]))
    torch._foreach_copy_(tensors, [v.view_as(t) for v, t in zip(views, tensors)])


class _AllReduceSum(torch.autograd.Function):
    """All-reduce SUM over ``group`` forward; backward, the all-reduce SUM of
    the upstream gradients, so each rank's input gets the sum over ranks of
    what its output fed (torch's SyncBatchNorm rule). The ranks run their
    backwards in one order, so their collectives pair."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        y = x.clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, grad):
        g = grad.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


def all_reduce_sum(x: torch.Tensor) -> torch.Tensor:
    """The sum of ``x`` over the data column, differentiable
    (``_AllReduceSum``); ``x`` itself without a group."""
    return _AllReduceSum.apply(x, data_group()) if is_up() else x


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
    n clips along ``axis``; under W data ranks it draws for the global W *
    B and this rank keeps rows ``data_rank::W`` (the sampler's rows), so
    every rank advances its generator as one process on the global batch
    would, and the W ranks' rows together are that process's draw. Without
    a group, or with one data rank, ``draw(B)`` itself."""
    W = data_world()
    if W == 1:
        return draw(B)
    full = draw(W * B)
    index = (slice(None),) * axis + (slice(data_rank(), None, W),)
    return full[index].contiguous()
