"""Weight bridge: the JAX package's flax variables -> the port's state_dict.

``jax_to_torch_state_dict`` maps a ``{"params": ..., "batch_stats": ...}``
tree of numpy arrays onto the port's module. Keys come from
``flax_to_torch_key``, a copy of the JAX package's train/checkpoint.py:67 key
map with its conformer rewrite (``_CONFORMER_MAP``, :43-63), so the port's
parameter names are the reference's torch keys and a later change can load
the released checkpoints with no second map (the fused ScalarBN (C, F) is
the one exception, see models.common.ScalarBN).

``save_training_ckpt`` writes the port's own training checkpoint in the
reference's Lightning layout (one ``torch.save`` of a dict, written to a
temporary name and renamed): ``state_dict`` holds the model under the
reference's keys with the ``net.`` prefix and every fused ScalarBN unstacked
into its per-channel rows (``unstack_scalar_rows``), so either package's
``load_seld_inference_ckpt`` reads it; a ``last.ckpt`` also carries
``optimizer_states``, ``global_step``, ``epoch`` and ``best_score``
(``is_training_ckpt``), which ``restore_training_ckpt`` puts back bit for
bit. This replaces the JAX package's orbax directories (train/loop.py:431-457).

``load_seld_inference_ckpt`` loads a reference-format SELD checkpoint (a
``.ckpt``/``.pth`` written by torch: Lightning's ``state_dict``, a
``model`` entry or a raw dict) into the port's model, as the JAX package's
train/checkpoint.py:146-167, :414-420 reads one: the ``sed_model.``,
``net.`` and ``_orig_mod.`` prefixes stripped, ``af_extractor.*`` dropped,
the reference's per-channel ScalarBN rows ``scalar.{c}.<leaf>`` stacked into
the fused (C, F) leaves (the JAX side: checkpoint.py:201-216), then a strict
load that raises on any key missing or left over. Values invert the layout
rules of that package's ``_to_flax_value`` (:119): Dense (in, out) -> Linear
(out, in), or Conv1d (out, in, 1) for the conformer's pointwise convs; conv
HWIO -> OIHW; a depthwise kernel (k, 1, C) -> Conv1d (C, 1, k); LayerNorm
scale -> weight; the EINV2 heads' CrossStitch ``weight`` (C, 2, 2) passes
through as it is. The q/k/v/out DenseGeneral kernels of a flax attention
under ``self_attn`` pack into nn.MultiheadAttention's ``in_proj_weight`` /
``in_proj_bias`` and ``out_proj`` (the inverse of :220-251).
"""

import os
import re
from collections import OrderedDict
from pathlib import Path
from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np
import torch

_LIST_NAMES = ("layers", "blocks", "stitch", "stitch1", "stitch2",
               "sed_decoder", "doa_decoder", "fc_sed", "fc_doa")
_IDX_RE = re.compile(r"^(%s)_(\d+)$" % "|".join(_LIST_NAMES))

# conformer: flax submodule path -> torch sequential path (per ConformerBlock)
_CONFORMER_MAP = {
    ("ff1", "norm"): "sequential.0.module.sequential.0",
    ("ff1", "fc1"): "sequential.0.module.sequential.1",
    ("ff1", "fc2"): "sequential.0.module.sequential.4",
    ("attn_norm",): "sequential.1.module.layer_norm",
    ("attn", "query_proj"): "sequential.1.module.attention.query_proj",
    ("attn", "key_proj"): "sequential.1.module.attention.key_proj",
    ("attn", "value_proj"): "sequential.1.module.attention.value_proj",
    ("attn", "pos_proj"): "sequential.1.module.attention.pos_proj",
    ("attn", "out_proj"): "sequential.1.module.attention.out_proj",
    ("attn", "u_bias"): "sequential.1.module.attention.u_bias",
    ("attn", "v_bias"): "sequential.1.module.attention.v_bias",
    ("conv", "norm"): "sequential.2.module.sequential.0",
    ("conv", "pw_conv1"): "sequential.2.module.sequential.2.conv",
    ("conv", "dw_conv"): "sequential.2.module.sequential.4.conv",
    ("conv", "bn"): "sequential.2.module.sequential.5",
    ("conv", "pw_conv2"): "sequential.2.module.sequential.7.conv",
    ("ff2", "norm"): "sequential.3.module.sequential.0",
    ("ff2", "fc1"): "sequential.3.module.sequential.1",
    ("ff2", "fc2"): "sequential.3.module.sequential.4",
    ("final_norm",): "sequential.4",
}
# flax Dense layers that the reference stores as Conv1d(k=1)
_POINTWISE = ("pw_conv1", "pw_conv2")
_QKV = ("query", "key", "value")


def flax_to_torch_key(path: Tuple[str, ...]) -> Optional[str]:
    """Translate a flax variable path (without the collection prefix) into the
    reference's torch state_dict key (the JAX package's key map)."""
    parts = list(path)
    leaf = parts[-1]
    if leaf == "kernel":
        parts[-1] = "weight"
    elif leaf == "scale" and len(parts) >= 2:
        parts[-1] = "weight"

    out = []
    for p in parts:
        if p == "base":  # AdaptDense/AdaptConv wrapper
            continue
        if p == "bn" and out and (out[-1].startswith("bn") or out[-1] == "scalar"
                                  or out[-1].startswith("scalar")):
            continue  # TorchBatchNorm inner module of BatchNorm2d/ScalarBN
        m = _IDX_RE.match(p)
        if m:
            out.extend([m.group(1), m.group(2)])
        elif p == "head_0":
            out.extend(["head", "0"])
        elif p.startswith("decoder_layers_"):
            out.extend(["decoder", "layers", p.rsplit("_", 1)[1]])
        else:
            out.append(p)
    # conformer rewrite, only right after layers.N: ...layers.N.<flax names>
    # -> ...layers.N.sequential...
    for span in (2, 1):
        for j in range(2, len(out) - span + 1):
            key = tuple(out[j:j + span])
            if key in _CONFORMER_MAP and out[j - 2] == "layers" and out[j - 1].isdigit():
                return ".".join(out[:j] + _CONFORMER_MAP[key].split(".") + out[j + span:])
    return ".".join(out) if out else None


def _flatten(tree: Mapping, prefix: Tuple[str, ...] = ()) -> Dict[Tuple[str, ...], np.ndarray]:
    flat = {}
    for k, v in tree.items():
        if isinstance(v, Mapping):
            flat.update(_flatten(v, prefix + (str(k),)))
        else:
            flat[prefix + (str(k),)] = np.asarray(v)
    return flat


def _to_torch_value(path: Tuple[str, ...], val: np.ndarray) -> np.ndarray:
    """Invert the JAX package's _to_flax_value layout rules for one leaf."""
    v = np.array(val, dtype=np.float32)  # a writable copy
    if path[-1] == "kernel":
        if v.ndim == 2 and len(path) >= 2 and path[-2] in _POINTWISE:
            v = v.T[:, :, None]  # Dense (in, out) -> pointwise Conv1d (out, in, 1)
        elif v.ndim == 2:
            v = v.T  # Dense (in, out) -> Linear (out, in)
        elif v.ndim == 3:
            v = v.transpose(2, 1, 0)  # conv1d (k, in / groups, out) -> (out, in / groups, k)
        elif v.ndim == 4:
            v = v.transpose(3, 2, 0, 1)  # conv HWIO -> OIHW
        else:
            raise ValueError(f"unexpected kernel rank {v.ndim} at {'/'.join(path)}")
    return np.ascontiguousarray(v)


def _attention_piece(path: Tuple[str, ...]) -> Optional[Tuple[str, str, int]]:
    """For a leaf of a flax attention under ``self_attn`` (DenseGeneral
    ``query``/``key``/``value``/``out``): (torch key, slot, part), where the
    q/k/v parts (0-2) of one key are concatenated; else None."""
    if "self_attn" not in path[:-2] or path[-1] not in ("kernel", "bias"):
        return None
    i = path.index("self_attn")
    proj, leaf = path[i + 1], path[-1]
    if len(path) != i + 3 or proj not in _QKV + ("out",):
        return None
    base = flax_to_torch_key(path[:i + 1] + ("x",)).rsplit(".", 1)[0]
    if proj == "out":
        return f"{base}.out_proj.{'weight' if leaf == 'kernel' else 'bias'}", leaf, -1
    return f"{base}.in_proj_{'weight' if leaf == 'kernel' else 'bias'}", leaf, _QKV.index(proj)


def _attention_value(leaf: str, part: int, val: np.ndarray) -> np.ndarray:
    """flax DenseGeneral layout -> torch rows: q/k/v kernel (E, H, D) ->
    (E', E) rows of in_proj_weight, bias (H, D) -> (E',); out kernel
    (H, D, E) -> out_proj.weight (E, E'), bias as it is."""
    v = np.array(val, dtype=np.float32)
    if leaf == "kernel":
        v = v.reshape(v.shape[0], -1).T if part >= 0 else v.reshape(-1, v.shape[-1]).T
    elif part >= 0:
        v = v.reshape(-1)
    return np.ascontiguousarray(v)


def jax_to_torch_state_dict(variables: Mapping,
                            model: Optional[torch.nn.Module] = None) -> "OrderedDict[str, torch.Tensor]":
    """flax ``{"params", "batch_stats"}`` tree (numpy leaves) -> state_dict.

    Raises on a leaf with no torch key, on two leaves mapping to one key, and,
    when ``model`` is given, on any key or shape that the model does not have
    or any model key the tree does not fill.
    """
    unknown = set(variables) - {"params", "batch_stats"}
    if unknown:
        raise ValueError(f"unexpected variable collections {sorted(unknown)}")
    sd: "OrderedDict[str, torch.Tensor]" = OrderedDict()
    packed: Dict[str, Dict[int, np.ndarray]] = {}
    for coll in ("params", "batch_stats"):
        for path, val in _flatten(variables.get(coll, {})).items():
            piece = _attention_piece(path)
            key = flax_to_torch_key(path) if piece is None else piece[0]
            if key is None:
                raise KeyError(f"no torch key for {coll}/{'/'.join(path)}")
            if piece is not None and piece[2] >= 0:
                parts = packed.setdefault(key, {})
                if piece[2] in parts:
                    raise KeyError(f"{coll}/{'/'.join(path)} maps onto {key} twice")
                parts[piece[2]] = _attention_value(*piece[1:], val)
                continue
            if key in sd:
                raise KeyError(f"{coll}/{'/'.join(path)} maps onto {key} twice")
            sd[key] = torch.from_numpy(_attention_value(*piece[1:], val) if piece
                                       else _to_torch_value(path, val))
    for key, parts in packed.items():
        if sorted(parts) != [0, 1, 2]:
            raise KeyError(f"{key}: the tree lacks parts {sorted({0, 1, 2} - set(parts))} "
                           f"of (query, key, value)")
        sd[key] = torch.from_numpy(np.concatenate([parts[i] for i in range(3)], axis=0))
    if model is not None:
        want = model.state_dict()
        missing = sorted(set(want) - set(sd))
        unused = sorted(set(sd) - set(want))
        if missing or unused:
            raise KeyError(f"bridge mismatch: model keys not filled {missing}, "
                           f"tree keys the model lacks {unused}")
        for k, t in want.items():
            if tuple(t.shape) != tuple(sd[k].shape):
                raise ValueError(f"shape mismatch for {k}: tree {tuple(sd[k].shape)} "
                                 f"vs model {tuple(t.shape)}")
    return sd


def load_jax_variables(model: torch.nn.Module, variables: Mapping) -> torch.nn.Module:
    """Copy a flax variable tree into ``model`` (strict both ways)."""
    model.load_state_dict(jax_to_torch_state_dict(variables, model), strict=True)
    return model


# buffers a reference checkpoint carries that the port rebuilds and does not
# store (the JAX loader leaves them unused too, train/checkpoint.py:281-284)
_REBUILT_SUFFIXES = ("num_batches_tracked", ".pe", "relative_position_index", "attn_mask")
_BN_LEAVES = ("weight", "bias", "running_mean", "running_var")


def strip_prefixes(sd: Mapping[str, Any]) -> Dict[str, Any]:
    """Drop the reference's wrapper prefixes from every key (the JAX
    package's strip_prefixes, checkpoint.py:161-167)."""
    out = {}
    for k, v in sd.items():
        for pre in ("sed_model.", "net.", "_orig_mod."):
            k = k.replace(pre, "")
        out[k] = v
    return out


def unwrap_state_dict(ckpt: Any) -> Dict[str, torch.Tensor]:
    """A loaded checkpoint's weights on the CPU under the reference's unwrap
    rules (``ckpt["state_dict"]``, else ``ckpt["model"]``, else the raw
    dict) and the prefix strips."""
    if isinstance(ckpt, dict) and "state_dict" in ckpt:
        sd = ckpt["state_dict"]
    elif isinstance(ckpt, dict) and "model" in ckpt:
        sd = ckpt["model"]
    else:
        sd = ckpt
    return strip_prefixes({k: v.detach().cpu() if isinstance(v, torch.Tensor)
                           else torch.as_tensor(np.asarray(v)) for k, v in sd.items()})


def load_torch_state_dict(path) -> Dict[str, torch.Tensor]:
    """``torch.load`` on the CPU, then ``unwrap_state_dict``."""
    return unwrap_state_dict(torch.load(str(path), map_location="cpu", weights_only=False))


def stack_scalar_rows(sd: Mapping[str, torch.Tensor],
                      model: torch.nn.Module) -> Dict[str, torch.Tensor]:
    """The reference's per-channel rows ``<name>.{c}.<leaf>`` of every fused
    ScalarBN of ``model`` stacked into its (C, F) ``<name>.<leaf>``; raises
    where a row is missing."""
    from ..models.common import ScalarBN

    out = dict(sd)
    for name, mod in model.named_modules():
        if not isinstance(mod, ScalarBN):
            continue
        for leaf in _BN_LEAVES:
            rows = [f"{name}.{c}.{leaf}" for c in range(mod.weight.shape[0])]
            missing = [r for r in rows if r not in out]
            if missing:
                raise KeyError(f"checkpoint lacks ScalarBN rows {missing}")
            out[f"{name}.{leaf}"] = torch.stack(
                [torch.as_tensor(out.pop(r), dtype=torch.float32) for r in rows], dim=0)
    return out


def load_seld_inference_ckpt(model: torch.nn.Module, ckpt_path,
                             ckpt: Optional[Any] = None) -> torch.nn.Module:
    """Load a reference-format SELD checkpoint (the whole model, heads
    included) into ``model`` for inference (the JAX package's
    load_seld_inference_ckpt, checkpoint.py:414-420); ``ckpt``, where given,
    is the file already loaded. Strict: a model key the checkpoint does not
    fill, or a checkpoint key the model lacks (other than the rebuilt
    buffers), raises ``KeyError``."""
    sd = (load_torch_state_dict(ckpt_path) if ckpt is None else unwrap_state_dict(ckpt))
    sd = {k: v for k, v in sd.items() if not k.startswith("af_extractor")}
    sd = stack_scalar_rows(sd, model)
    want = model.state_dict()
    sd = {k: v for k, v in sd.items() if k in want or not k.endswith(_REBUILT_SUFFIXES)}
    missing = sorted(set(want) - set(sd))
    unused = sorted(set(sd) - set(want))
    if missing or unused:
        raise KeyError(f"checkpoint {ckpt_path}: model keys it lacks {missing[:20]} "
                       f"({len(missing)} in all), keys the model lacks {unused[:20]} "
                       f"({len(unused)} in all)")
    model.load_state_dict({k: v.to(want[k].dtype) for k, v in sd.items()}, strict=True)
    return model

def unstack_scalar_rows(sd: Mapping[str, torch.Tensor],
                        model: torch.nn.Module) -> "OrderedDict[str, torch.Tensor]":
    """The inverse of ``stack_scalar_rows``: each fused ScalarBN leaf
    ``<name>.<leaf>`` (C, F) of ``model`` as the reference's rows
    ``<name>.{c}.<leaf>`` (F,), the other keys as they are, in order."""
    from ..models.common import ScalarBN

    fused = {f"{name}.{leaf}": name for name, mod in model.named_modules()
             if isinstance(mod, ScalarBN) for leaf in _BN_LEAVES}
    out: "OrderedDict[str, torch.Tensor]" = OrderedDict()
    for k, v in sd.items():
        if k not in fused:
            out[k] = v
            continue
        for c in range(v.shape[0]):
            out[f"{fused[k]}.{c}.{k.rsplit('.', 1)[1]}"] = v[c].clone()
    return out


# what a port last.ckpt carries besides the weights (an exact resume)
TRAINING_KEYS = ("optimizer_states", "global_step", "epoch", "best_score")


def model_state_rows(model: torch.nn.Module) -> "OrderedDict[str, torch.Tensor]":
    """``model``'s weights and statistics on the CPU under the reference's
    Lightning keys: ``net.`` prefixed, ScalarBN rows unstacked."""
    sd = unstack_scalar_rows({k: v.detach().to("cpu", copy=True)
                              for k, v in model.state_dict().items()}, model)
    return OrderedDict((f"net.{k}", v) for k, v in sd.items())


def optimizer_state(opt: torch.optim.Optimizer) -> Dict[str, Any]:
    """``opt.state_dict()`` on the CPU without the groups' ``lr_fn``
    schedules (closures, which do not pickle; ``build_optimizer`` makes them
    again on load)."""
    sd = opt.state_dict()
    return {"state": {i: {k: v.detach().to("cpu", copy=True) if isinstance(v, torch.Tensor) else v
                          for k, v in st.items()} for i, st in sd["state"].items()},
            "param_groups": [{k: v for k, v in g.items() if k != "lr_fn"}
                             for g in sd["param_groups"]]}


def save_training_ckpt(path, model: torch.nn.Module,
                       optimizer: Optional[torch.optim.Optimizer] = None,
                       **fields: Any) -> int:
    """One ``torch.save`` of {"state_dict": ``model_state_rows(model)``,
    "optimizer_states": [``optimizer_state``] when ``optimizer`` is given,
    and ``fields`` (``global_step``, ``epoch``, ``best_score``)} to a
    temporary name, then renamed onto ``path``. -> bytes written."""
    path = Path(path)
    ckpt: Dict[str, Any] = {"state_dict": model_state_rows(model)}
    if optimizer is not None:
        ckpt["optimizer_states"] = [optimizer_state(optimizer)]
    ckpt.update(fields)
    tmp = path.with_name(path.name + ".tmp")
    torch.save(ckpt, str(tmp))
    os.replace(tmp, path)
    return path.stat().st_size


def is_training_ckpt(ckpt: Any) -> bool:
    """Whether a loaded checkpoint is a port ``last.ckpt``: a dict that
    carries every one of ``TRAINING_KEYS``."""
    return isinstance(ckpt, dict) and all(k in ckpt for k in TRAINING_KEYS)


def restore_training_ckpt(path, model: torch.nn.Module, optimizer: torch.optim.Optimizer,
                          ckpt: Optional[Any] = None) -> Dict[str, Any]:
    """Exact resume from a port ``last.ckpt`` (``ckpt``, where given, is the
    file already loaded): the weights and statistics (strictly, through
    ``load_seld_inference_ckpt``) and the optimizer's state, each group
    keeping its ``lr_fn``. -> {"global_step", "epoch", "best_score"}."""
    if ckpt is None:
        ckpt = torch.load(str(path), map_location="cpu", weights_only=False)
    if not is_training_ckpt(ckpt):
        raise KeyError(f"{path} is not a training checkpoint: it lacks "
                       f"{[k for k in TRAINING_KEYS if k not in ckpt]}")
    load_seld_inference_ckpt(model, path, ckpt)
    fns = [g["lr_fn"] for g in optimizer.param_groups]
    optimizer.load_state_dict(ckpt["optimizer_states"][0])
    for g, fn in zip(optimizer.param_groups, fns):
        g["lr_fn"] = fn
    return {"global_step": int(ckpt["global_step"]), "epoch": int(ckpt["epoch"]),
            "best_score": float(ckpt["best_score"])}
