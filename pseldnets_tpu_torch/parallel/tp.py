"""Tensor parallelism over processes: the counterpart of the JAX package's
parallel/tp.py (:1-116).

The JAX module only annotates shardings: ``P(None, 'model')`` for the
``fc1``/``qkv`` kernels and their biases (column-parallel), ``P('model',
None)`` for ``fc2``/``proj``/``reduction`` (row-parallel), a dim split
only where it divides, and GSPMD computes the replicated program. The port
writes that program out, as Megatron does, over the (data, model) layout
of parallel/mesh.py (``init_layout``): a step over ``data x model`` ranks
is the one-process step on the global batch, up to float32 summation
order. Its contract is numerical, not a layout, so it splits whole units:

- an attention (HTSAT's ``WindowAttention``, PaSST's ``Attention``) by
  heads, where its head count divides by tp: a model rank holds the q, k
  and v rows of its ``nh / tp`` heads in ``qkv`` (weight and bias), the
  matching input columns of ``proj`` and, for HTSAT, the matching columns
  of the relative-position bias table (a parameter that each head uses
  alone, so its shard's grad is the rank's own). JAX splits ``qkv`` by
  contiguous columns, which is legal only because GSPMD computes the global
  program; a block whose heads do not divide keeps its attention whole;
- an MLP pair (``fc1`` -> ``fc2``): the ViT ``Mlp`` of HTSAT and PaSST,
  the AdapterBit bottlenecks (``Adapter``) and the conformer's feed-forward
  modules (``sequential.1``/``sequential.4``, which the JAX package names
  fc1/fc2: its models/conformer.py:43-47), where the hidden width divides:
  a contiguous block of ``fc1``'s rows and ``fc2``'s columns;
- HTSAT's ``reduction`` (PatchMerging), row-parallel on its replicated
  input, where 4C divides: a contiguous block of its input columns.

A layer with a LoRA term stays whole (with the unit it belongs to). The
EINV2 heads' two encoders split as the single ones do. Every other
parameter (LayerNorms, the embeds, convolutions, BatchNorms, the heads,
the row-parallel biases, adapter scalars, the conformer's attention,
CrossStitch) is replicated on every model rank.

The collectives are ``torch.autograd.Function``s on the model row's group:
``copy_to_model`` (identity forward, all-reduce-sum backward) before every
column-parallel layer, ``reduce_from_model`` (all-reduce-sum forward,
identity backward) after every row-parallel one, whose bias is added once
after the reduce. Both reduce in float32. Under bf16 autocast the split
layers' products (``_split_linear``) take bf16 operands, as autocast's
Linear does, but keep the float32 accumulator as their output, in the
forward and in the input-grad product of the backward: the partials a rank
adds up are never rounded to bf16 (a sum of heads' parts that nearly
cancel would keep each part's rounding error), and the sum is rounded to
the compute dtype once after the all-reduce, as the one process rounds
its product once.

Random draws: every model rank draws at full width from the same generator
and keeps its part (``tp_part`` on a split unit: the attention-dropout
mask's heads, the MLP dropout's columns after ``fc1``); drop-path and the
dropouts after ``fc2``/``proj`` act on whole tensors. Per-clip draws and
the sampler's rows follow the data index (parallel/mesh.py).

Replicated parameters get identical grads on every model rank (everything
after a ``reduce_from_model`` is replicated, and ``copy_to_model``'s
backward sums the partial input grads), so only the split ones are the
rank's own: ``clip_by_global_norm_`` (train/optim.py) sums their squares
over the model row and counts the replicated ones once, and the optimizer
runs on the shards. ``gather_into`` and ``gather_tensors`` collect the
full parameters (eval, checkpoints) and ``split_tensor`` takes a rank's
part again (a load).

At tp = 2 the full-width HTSAT (configs/model/htsat.yaml: heads 4, 8, 16,
32) splits every unit: 12 attentions, 12 MLPs and 3 reductions, 87
parameter tensors (``tp_plan``); so does tp = 4.
"""

import copy
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
import torch.nn as nn
import torch.nn.functional as F

from .mesh import model_group, model_world

# the JAX rules' module names (its tp.py:35-37): column- and row-parallel
_COL_MODULES = ("fc1", "qkv")
_ROW_MODULES = ("fc2", "proj", "reduction")


class _CopyToModel(torch.autograd.Function):
    """Identity forward; backward, the float32 all-reduce-sum of the
    upstream grads over the model row (the partial input grads of a
    column-parallel layer)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        g = grad.to(torch.float32, copy=True)
        dist.all_reduce(g, group=ctx.group)
        return g.to(grad.dtype), None


class _ReduceFromModel(torch.autograd.Function):
    """Float32 all-reduce-sum forward over the model row (the partial
    outputs of a row-parallel layer); identity backward."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.dtype = x.dtype
        y = x.to(torch.float32, copy=True)
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, grad):
        return grad.to(ctx.dtype), None


def copy_to_model(x: torch.Tensor) -> torch.Tensor:
    """``x`` (replicated on the model row) as a column-parallel layer's
    input; ``x`` itself without a layout."""
    return _CopyToModel.apply(x, model_group()) if model_world() > 1 else x


def reduce_from_model(x: torch.Tensor) -> torch.Tensor:
    """The float32 sum over the model row of the partial outputs ``x``."""
    return _ReduceFromModel.apply(x, model_group()) if model_world() > 1 else x.float()


@torch.no_grad()
def sum_over_model_(t: torch.Tensor) -> torch.Tensor:
    """``t`` summed in place over the model row (no autograd)."""
    if model_world() > 1:
        dist.all_reduce(t, group=model_group())
    return t


def _mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b of two 2-D tensors of one dtype, accumulated and returned in
    float32 (cuBLAS's float32 output of bf16 operands on the card; the
    CPU computes the same products of the bf16 values in float32)."""
    if a.is_cuda and a.dtype != torch.float32:
        return torch.mm(a, b, out_dtype=torch.float32)
    return torch.mm(a.float(), b.float())


class _SplitLinear(torch.autograd.Function):
    """x W^T (+ b) of a split layer with ``dtype`` operands and a float32
    output; backward the input grad dy W and the weight grad dy^T x with
    the same operands, each a float32 output, and the bias grad's float32
    sum."""

    @staticmethod
    def forward(ctx, x, weight, bias, dtype):
        ctx.save_for_backward(x, weight)
        ctx.dtype, ctx.has_bias, ctx.x_dtype = dtype, bias is not None, x.dtype
        with torch.autocast(x.device.type, enabled=False):
            y = _mm(x.reshape(-1, x.shape[-1]).to(dtype), weight.to(dtype).t())
            if bias is not None:
                y = y + bias.float()
        return y.reshape(*x.shape[:-1], -1)

    @staticmethod
    def backward(ctx, grad):
        x, weight = ctx.saved_tensors
        with torch.autocast(x.device.type, enabled=False):
            dy = grad.reshape(-1, grad.shape[-1])
            dx = _mm(dy.to(ctx.dtype), weight.to(ctx.dtype)).reshape(x.shape)
            dw = _mm(dy.to(ctx.dtype).t(), x.reshape(-1, x.shape[-1]).to(ctx.dtype))
            db = dy.float().sum(0) if ctx.has_bias else None
        return dx.to(ctx.x_dtype), dw.to(weight.dtype), db, None


def _split_linear(x: torch.Tensor, weight: torch.Tensor,
                  bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """A split layer's product: ``F.linear`` without autocast (float32, as
    the one process), or under it ``_SplitLinear`` with the autocast dtype's
    operands and the float32 output."""
    if not torch.is_autocast_enabled(x.device.type):
        return F.linear(x, weight, bias)
    return _SplitLinear.apply(x, weight, bias, torch.get_autocast_dtype(x.device.type))


def _param(t: torch.Tensor, like: nn.Parameter) -> nn.Parameter:
    return nn.Parameter(t.detach().clone(), requires_grad=like.requires_grad)


class ColumnParallelLinear(nn.Module):
    """Rows ``index`` of a Linear (its output features; for ``qkv`` the q, k
    and v rows of the rank's heads), the input through ``copy_to_model``.
    Its parameters keep the Linear's names (``weight``, ``bias``)."""

    def __init__(self, full: nn.Linear, index: torch.Tensor):
        super().__init__()
        index = index.to(full.weight.device)
        self.in_features, self.out_features = full.in_features, len(index)
        self.weight = _param(full.weight.index_select(0, index), full.weight)
        if full.bias is None:
            self.register_parameter("bias", None)
        else:
            self.bias = _param(full.bias.index_select(0, index), full.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = _split_linear(copy_to_model(x), self.weight, self.bias)
        # the output in the dtype autocast's Linear gives (its own rows: no sum)
        return y.to(torch.get_autocast_dtype(x.device.type)
                    if torch.is_autocast_enabled(x.device.type) else y.dtype)


class RowParallelLinear(nn.Module):
    """Input columns ``index`` of a Linear: the partial product of the
    rank's input part, summed over the model row in float32, plus the bias
    once, rounded to the dtype autocast's Linear gives. ``scatter``: the input is
    replicated (HTSAT's ``reduction``) and the rank takes its columns of it
    (through ``copy_to_model``, whose backward sums the ranks' parts of the
    input grad); otherwise the input is already the rank's part."""

    def __init__(self, full: nn.Linear, index: torch.Tensor, scatter: bool = False):
        super().__init__()
        index = index.to(full.weight.device)
        self.in_features, self.out_features = len(index), full.out_features
        self.scatter = scatter
        self.register_buffer("index", index.clone(), persistent=False)
        self.weight = _param(full.weight.index_select(1, index), full.weight)
        if full.bias is None:
            self.register_parameter("bias", None)
        else:
            self.bias = _param(full.bias, full.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.scatter:
            x = copy_to_model(x).index_select(-1, self.index)
        dtype = (torch.get_autocast_dtype(x.device.type)
                 if torch.is_autocast_enabled(x.device.type) else x.dtype)
        y = reduce_from_model(_split_linear(x, self.weight))
        if self.bias is not None:
            y = y + self.bias.float()
        return y.to(dtype)


@dataclass(frozen=True)
class Shard:
    """How a parameter is split: along ``dim`` of the full tensor, model
    rank m holding the positions ``parts[m]`` (in its own order)."""

    dim: int
    parts: Tuple[torch.Tensor, ...]

    def full_shape(self, local: Sequence[int]) -> Tuple[int, ...]:
        shape = list(local)
        shape[self.dim] = sum(len(p) for p in self.parts)
        return tuple(shape)


@dataclass(frozen=True)
class _Unit:
    kind: str          # "heads", "pair" or "row"
    name: str          # the module's qualified name ("" for the root)
    module: nn.Module  # the attention, the MLP or the PatchMerging
    paths: Dict[str, str]  # JAX name -> attribute path of its split linears


# where a module's linears are not named as the JAX package names them
_ALIASES = {"FeedForwardModule": {"fc1": "sequential.1", "fc2": "sequential.4"}}


def _child(module: nn.Module, path: str) -> Optional[nn.Module]:
    for part in path.split("."):
        module = getattr(module, part, None)
        if not isinstance(module, nn.Module):
            return None
    return module


def _plain_linear(m: Optional[nn.Module]) -> bool:
    """A Linear without a LoRA term (split only such)."""
    return isinstance(m, nn.Linear) and getattr(m, "lora_r", 0) == 0


def _units(model: nn.Module, tp: int) -> List[_Unit]:
    """The units of ``model`` that split over ``tp`` model ranks, in module
    order."""
    out = []
    for name, mod in model.named_modules():
        paths = _ALIASES.get(type(mod).__name__) or {n: n for n in _COL_MODULES + _ROW_MODULES}
        kids = {j: _child(mod, p) for j, p in paths.items()}
        if _plain_linear(kids.get("qkv")) and _plain_linear(kids.get("proj")):
            if mod.num_heads % tp == 0:
                out.append(_Unit("heads", name, mod, {j: paths[j] for j in ("qkv", "proj")}))
        if _plain_linear(kids.get("fc1")) and _plain_linear(kids.get("fc2")):
            hidden = kids["fc1"].out_features
            if hidden % tp == 0 and kids["fc2"].in_features == hidden:
                out.append(_Unit("pair", name, mod, {j: paths[j] for j in ("fc1", "fc2")}))
        if _plain_linear(kids.get("reduction")) and kids["reduction"].in_features % tp == 0:
            out.append(_Unit("row", name, mod, {"reduction": paths["reduction"]}))
    return out


def _chunks(n: int, tp: int) -> Tuple[torch.Tensor, ...]:
    k = n // tp
    return tuple(torch.arange(m * k, (m + 1) * k) for m in range(tp))


def _unit_shards(u: _Unit, tp: int) -> Dict[str, Shard]:
    """{parameter path inside the unit's module: its Shard}."""
    if u.kind == "heads":
        qkv = _child(u.module, u.paths["qkv"])
        D, nh = qkv.in_features, u.module.num_heads
        hd, per = D // nh, nh // tp
        cols = tuple(torch.arange(m * per * hd, (m + 1) * per * hd) for m in range(tp))
        rows = tuple(torch.cat([s * D + c for s in range(3)]) for c in cols)
        got = {f"{u.paths['qkv']}.weight": Shard(0, rows),
               f"{u.paths['proj']}.weight": Shard(1, cols)}
        if qkv.bias is not None:
            got[f"{u.paths['qkv']}.bias"] = Shard(0, rows)
        if isinstance(getattr(u.module, "relative_position_bias_table", None), nn.Parameter):
            got["relative_position_bias_table"] = Shard(1, _chunks(nh, tp))
        return got
    if u.kind == "pair":
        fc1 = _child(u.module, u.paths["fc1"])
        parts = _chunks(fc1.out_features, tp)
        got = {f"{u.paths['fc1']}.weight": Shard(0, parts),
               f"{u.paths['fc2']}.weight": Shard(1, parts)}
        if fc1.bias is not None:
            got[f"{u.paths['fc1']}.bias"] = Shard(0, parts)
        return got
    red = _child(u.module, u.paths["reduction"])
    return {f"{u.paths['reduction']}.weight": Shard(1, _chunks(red.in_features, tp))}


def tp_plan(model: nn.Module, tp: int) -> Dict[str, Shard]:
    """{qualified parameter name: its Shard} of every parameter that
    ``split_model`` splits over ``tp`` model ranks, in module order (the
    counterpart of the JAX ``tp_shardings``)."""
    plan = {}
    for u in _units(model, tp):
        pre = f"{u.name}." if u.name else ""
        plan.update({pre + k: v for k, v in _unit_shards(u, tp).items()})
    return plan


def _set_child(module: nn.Module, path: str, new: nn.Module) -> None:
    *up, last = path.split(".")
    for part in up:
        module = getattr(module, part)
    setattr(module, last, new)


def split_model(full: nn.Module, tp: int, m: int) -> nn.Module:
    """A copy of ``full`` with model rank ``m``'s part of every split unit:
    ``ColumnParallelLinear``/``RowParallelLinear`` in place of the split
    linears (the parameter names stay), the bias table's heads, and each
    split unit's ``tp_part`` (the axis, the full width and the rank's first
    position of its dropout site after the split layer). ``full`` is left
    as it is."""
    model = copy.deepcopy(full)
    for u in _units(model, tp):
        shards = _unit_shards(u, tp)
        mod = u.module
        if u.kind == "heads":
            per = mod.num_heads // tp
            mod.tp_part = (1, mod.num_heads, m * per)
            _set_child(mod, u.paths["qkv"], ColumnParallelLinear(
                _child(mod, u.paths["qkv"]), shards[f"{u.paths['qkv']}.weight"].parts[m]))
            _set_child(mod, u.paths["proj"], RowParallelLinear(
                _child(mod, u.paths["proj"]), shards[f"{u.paths['proj']}.weight"].parts[m]))
            if "relative_position_bias_table" in shards:
                t = mod.relative_position_bias_table
                mod.relative_position_bias_table = _param(
                    split_tensor(t, shards["relative_position_bias_table"], m), t)
        elif u.kind == "pair":
            part = shards[f"{u.paths['fc1']}.weight"].parts[m]
            mod.tp_part = (-1, _child(mod, u.paths["fc1"]).out_features, int(part[0]))
            _set_child(mod, u.paths["fc1"], ColumnParallelLinear(_child(mod, u.paths["fc1"]),
                                                                 part))
            _set_child(mod, u.paths["fc2"], RowParallelLinear(_child(mod, u.paths["fc2"]), part))
        else:
            path = u.paths["reduction"]
            _set_child(mod, path, RowParallelLinear(
                _child(mod, path), shards[f"{path}.weight"].parts[m], scatter=True))
    return model


def split_tensor(full: torch.Tensor, shard: Shard, m: int) -> torch.Tensor:
    """Model rank ``m``'s part of a full tensor."""
    return full.index_select(shard.dim, shard.parts[m].to(full.device))


@torch.no_grad()
def gather_tensors(tensors: Sequence[torch.Tensor], shards: Sequence[Shard]
                   ) -> List[torch.Tensor]:
    """The full tensors of this rank's parts ``tensors`` (one dtype), in one
    all-gather over the model row: every rank gets them all."""
    tensors = list(tensors)
    if not tensors:
        return []
    tp = model_world()
    flat = torch.cat([t.reshape(-1) for t in tensors])
    pieces = [torch.empty_like(flat) for _ in range(tp)]
    dist.all_gather(pieces, flat, group=model_group())
    out, off = [], 0
    for t, sh in zip(tensors, shards):
        full = t.new_empty(sh.full_shape(t.shape))
        for m in range(tp):
            full.index_copy_(sh.dim, sh.parts[m].to(t.device),
                             pieces[m][off:off + t.numel()].view(t.shape))
        out.append(full)
        off += t.numel()
    return out


@torch.no_grad()
def gather_into(split: nn.Module, full: nn.Module, plan: Dict[str, Shard]) -> None:
    """Copy the split model's state into the full-width ``full``: the split
    parameters gathered over the model row (one collective; every rank of
    the row calls it), the replicated ones and the buffers as they are."""
    sp = dict(split.named_parameters())
    fp = dict(full.named_parameters())
    names = list(plan)
    for n, t in zip(names, gather_tensors([sp[n] for n in names], [plan[n] for n in names])):
        fp[n].copy_(t)
    for n, p in sp.items():
        if n not in plan:
            fp[n].copy_(p)
    fb = dict(full.named_buffers())
    for n, b in split.named_buffers():
        if n in fb:
            fb[n].copy_(b)
