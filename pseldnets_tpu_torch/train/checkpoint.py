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
In a process group rank 0 alone writes (``save_training_ckpt`` refuses on
another rank) and every rank reads: a resume loads ``last.ckpt`` on each.

``load_pretrained`` is the JAX package's load-time surgery
(train/checkpoint.py:297-411) on the port's keys: an AudioSet file's patch
embed (or CNN14's first conv) repeated over the input channels and divided
by their count, bn0 copied into every ScalarBN row, PaSST's pos-embeds
centre-cropped or linearly resized, the per-backbone skips; or a
SELD-pretrained whole model with the head skips. It returns the JAX
report: missing, skipped and unused keys.

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

from ..parallel import rank

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


_LORA = ("lora_A", "lora_B")


def _torch_key(path: Tuple[str, ...], val: np.ndarray) -> Optional[str]:
    """A leaf's torch key: ``flax_to_torch_key``, plus ``.weight`` for a
    conv LoRA factor (4-D), which the port and the reference hold as a
    Conv2d (the suffix the JAX loader adds, checkpoint.py:264-269)."""
    key = flax_to_torch_key(path)
    return f"{key}.weight" if path[-1] in _LORA and np.ndim(val) == 4 else key


def _to_torch_value(path: Tuple[str, ...], val: np.ndarray) -> np.ndarray:
    """Invert the JAX package's _to_flax_value layout rules for one leaf."""
    v = np.array(val, dtype=np.float32)  # a writable copy
    if path[-1] in _LORA:
        # dense (in, r) / (r, out) -> (r, in) / (out, r); conv HWIO -> OIHW
        v = v.T if v.ndim == 2 else v.transpose(3, 2, 0, 1)
    elif path[-1] == "kernel":
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
            key = _torch_key(path, val) if piece is None else piece[0]
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

# ---------------------------------------------------------------------------
# load-time surgery (the JAX package's train/checkpoint.py:179-411)
# ---------------------------------------------------------------------------
def convert_state_dict(model: torch.nn.Module, torch_sd: Mapping[str, torch.Tensor],
                       skip=lambda k: False, special: Optional[Dict[str, Any]] = None,
                       strict: bool = True) -> Dict[str, list]:
    """Fill ``model`` from a reference-keyed torch state dict (the JAX
    package's convert_state_dict, checkpoint.py:179-291, on the port's own
    keys, which are the reference's): each fused ScalarBN leaf (C, F) from
    the rows ``scalar.{c}.<leaf>``, a key in ``special`` from
    ``special[key](torch_sd, model shape)``, a key that ``skip`` names kept at its
    initial value, every other key copied as it is (its shape must be the
    model's). -> the report {"missing", "skipped", "unused"}: model keys
    the dict lacks (a ScalarBN leaf as ``scalar.*.<leaf>``), model keys
    skipped, and dict keys not used (the rebuilt buffers left out). Where
    the JAX report lists a q/k/v-packed attention key once per part, this
    one lists it once. ``strict`` raises ``KeyError`` on any missing key,
    before anything is written."""
    from ..models.common import ScalarBN

    special = special or {}
    scalar = {name for name, mod in model.named_modules() if isinstance(mod, ScalarBN)}
    want = model.state_dict()
    new: Dict[str, torch.Tensor] = {}
    missing, skipped, used = [], [], set()
    for key, init in want.items():
        mod, leaf = key.rsplit(".", 1) if "." in key else ("", key)
        if mod in scalar:
            rows = []
            for c in range(init.shape[0]):
                rk = f"scalar.{c}.{leaf}"
                if rk not in torch_sd:
                    break
                rows.append(torch.as_tensor(torch_sd[rk], dtype=torch.float32))
                used.add(rk)
            if len(rows) == init.shape[0]:
                new[key] = torch.stack(rows, dim=0)
            else:
                missing.append("scalar.*." + leaf)
            continue
        if key in special:
            new[key] = special[key](torch_sd, tuple(init.shape))
            used.add(key)
        elif skip(key):
            skipped.append(key)
            continue
        elif key not in torch_sd:
            missing.append(key)
            continue
        else:
            new[key] = torch.as_tensor(torch_sd[key])
            used.add(key)
        if tuple(new[key].shape) != tuple(init.shape):
            raise ValueError(f"shape mismatch for {key}: {tuple(new[key].shape)} vs "
                             f"{tuple(init.shape)}")
    # unused: the rebuilt buffers left out, as the JAX report does (:281-285)
    report = {"missing": missing, "skipped": skipped,
              "unused": [k for k in torch_sd if k not in used
                         and not k.endswith(_REBUILT_SUFFIXES)]}
    if strict and missing:
        raise KeyError(f"missing torch keys for the model: {missing[:20]} ({len(missing)} total)")
    with torch.no_grad():
        for key, v in new.items():
            want[key].copy_(v.to(want[key].dtype))
    return report


def _replicate_patch_embed(in_channels: int):
    """patch_embed.proj.weight (O, 1, kh, kw) repeated across the C input
    channels and divided by C (reference accdoa.py:179-181; a (O, C0, kh,
    kw) weight tiled C / C0 times and divided by C / C0)."""

    def fn(sd, target_shape):
        w = torch.as_tensor(sd["patch_embed.proj.weight"], dtype=torch.float32)
        rep = in_channels if w.shape[1] == 1 else in_channels // w.shape[1]
        return w.repeat(1, rep, 1, 1) / rep

    return fn


def _resize_pos_embed(key: str, axis: int):
    """PaSST pos-embed (1, E, F, 1) or (1, E, 1, T) to the model's length
    along ``axis`` (reference accdoa.py:277-298): a centre crop where the
    file's grid is at least as long, else the linear resize of
    ``jax.image.resize(..., "linear")`` when growing: half-pixel centres,
    the edges held (``F.interpolate``, bilinear, align_corners False)."""

    def fn(sd, target_shape):
        v = torch.as_tensor(sd[key], dtype=torch.float32)
        ori, tgt = v.shape[axis], target_shape[axis]
        if ori >= tgt:
            start = int((ori - tgt) / 2)
            return v.narrow(axis, start, tgt)
        size = list(v.shape[2:])
        size[axis - 2] = tgt
        return torch.nn.functional.interpolate(v, size=tuple(size), mode="bilinear",
                                               align_corners=False)

    return fn


def _replicate_cnn_first_conv(in_channels: int):
    """conv_block1.conv1.weight (O, 1|C0, 3, 3) tiled to C input channels
    and divided by the repeat (the JAX package's checkpoint.py:433-440)."""

    def fn(sd, target_shape):
        w = torch.as_tensor(sd["conv_block1.conv1.weight"], dtype=torch.float32)
        rep = in_channels // w.shape[1]
        return w.repeat(1, rep, 1, 1) / rep

    return fn


def _wrap_prefixed(fn, prefix):
    """``fn`` on the dict with ``prefix`` stripped from the keys that carry
    it (the stripped keys win over unprefixed ones, as in checkpoint.py:423-430)."""

    def wrapped(sd, target_shape):
        merged = dict(sd)
        merged.update({k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)})
        return fn(merged, target_shape)

    return wrapped


def _bn0_rows(sd, in_ch: int) -> Dict[str, Any]:
    """bn0's statistics and affine copied into every ScalarBN row
    (reference accdoa.py:186-191)."""
    return {f"scalar.{c}.{leaf}": sd[f"bn0.{leaf}"] for c in range(in_ch) for leaf in _BN_LEAVES}


def load_pretrained(model: torch.nn.Module, ckpt_path, meta: Mapping[str, Any],
                    strict: bool = True) -> Dict[str, list]:
    """The reference's ``load_ckpts`` for every (method, backbone): the JAX
    package's load_pretrained (checkpoint.py:333-411) on the port's model,
    ``meta`` from models.factory.build_model. AudioSet files
    (``audioset_pretrain``): HTSAT and HTSAT_SEDDOA under ``encoder.``, the
    EINV2 HTSAT's two encoders under ``sed_encoder.`` (4 channels) and
    ``doa_encoder.`` (``in_channels``), the patch embed replicated; PaSST
    likewise with its pos-embeds cropped or resized and ``head.0`` kept;
    CRNN and ConvConformer under ``convs.`` (``sed_convs.``/``doa_convs.``
    for EINV2), the first conv replicated; bn0 into every ScalarBN row; the
    per-backbone skips as regexes (checkpoint.py:356-401). Otherwise a
    SELD-pretrained whole model with the head, tscam, adapter, LoRA and
    ``af_extractor`` keys skipped, not strict (:406-411). -> the report of
    ``convert_state_dict``."""
    sd = load_torch_state_dict(ckpt_path)
    backbone = meta["backbone"]
    in_ch = meta["in_channels"]
    if meta.get("audioset_pretrain", True):
        dual = meta.get("method") == "einv2"
        if backbone in ("HTSAT", "HTSAT_SEDDOA"):
            encs = ((("sed_encoder.", 4), ("doa_encoder.", in_ch)) if dual and backbone == "HTSAT"
                    else (("encoder.", in_ch),))
            special = {pre + "patch_embed.proj.weight": _wrap_prefixed(_replicate_patch_embed(c),
                                                                        pre)
                       for pre, c in encs}
            torch_like = {f"{pre}{k}": v for pre, _ in encs for k, v in sd.items()}
            torch_like.update({k: v for k, v in sd.items() if k.startswith("bn0")})
            torch_like.update(_bn0_rows(sd, in_ch))
            skip = lambda k: (".tscam_conv" in k or k.startswith("tscam_conv")  # noqa: E731
                              or "head" in k or "adapter" in k or "lora" in k
                              or k.startswith("fc."))
            return convert_state_dict(model, torch_like, skip=skip, special=special,
                                      strict=strict)
        if backbone == "PASST":
            encs = ((("sed_encoder.", 4), ("doa_encoder.", in_ch)) if dual
                    else (("encoder.", in_ch),))
            special = {}
            for pre, c in encs:
                special[pre + "patch_embed.proj.weight"] = _wrap_prefixed(
                    _replicate_patch_embed(c), pre)
                special[pre + "time_new_pos_embed"] = _wrap_prefixed(
                    _resize_pos_embed("time_new_pos_embed", 3), pre)
                special[pre + "freq_new_pos_embed"] = _wrap_prefixed(
                    _resize_pos_embed("freq_new_pos_embed", 2), pre)
            torch_like = {f"{pre}{k}": v for pre, _ in encs for k, v in sd.items()}
            if "bn0.weight" in sd:
                torch_like.update(_bn0_rows(sd, in_ch))
            # PaSST files: 'head.0.*' (a LayerNorm) is loaded, other head keys skipped
            skip = lambda k: (("head" in k and not re.search(r"head\.0\.(weight|bias)$", k))  # noqa: E731
                              or "adapter" in k or "lora" in k
                              or re.search(r"(^|\.)fc(_sed|_doa)?\.", k) is not None
                              or "stitch" in k or re.search(r"(^|\.)decoder", k) is not None)
            return convert_state_dict(model, torch_like, skip=skip, special=special,
                                      strict=strict)
        if backbone in ("CRNN", "ConvConformer"):
            encs = (("sed_convs.", 4), ("doa_convs.", in_ch)) if dual else (("convs.", in_ch),)
            torch_like, special = {}, {}
            for pre, c in encs:
                torch_like.update({pre + k: v for k, v in sd.items()})
                special[pre + "conv_block1.conv1.weight"] = _wrap_prefixed(
                    _replicate_cnn_first_conv(c), pre)
            torch_like.update(_bn0_rows(sd, in_ch))
            skip = lambda k: (re.search(r"(^|\.)fc", k) is not None or "stitch" in k  # noqa: E731
                              or re.search(r"(^|\.)decoder", k) is not None
                              or re.search(r"(sed|doa)_track", k) is not None)
            return convert_state_dict(model, torch_like, skip=skip, special=special,
                                      strict=strict)
        raise NotImplementedError(backbone)

    # DataSynthSELD-pretrained: whole-model state dict with head skips
    # (reference accdoa.py:192-202 / einv2.py:264-272)
    skip = lambda k: (k.startswith(("fc.", "head", "tscam_conv.", "sed_tscam_conv."))  # noqa: E731
                      or "lora" in k or "adapter" in k or k.startswith("fc_sed")
                      or k.startswith("af_extractor"))
    return convert_state_dict(model, sd, skip=skip, strict=False)


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
    temporary name, then renamed onto ``path``. -> bytes written. In a
    process group only rank 0 writes; another rank raises."""
    if rank() != 0:
        raise RuntimeError(f"rank {rank()} asked to write {path}: only rank 0 writes checkpoints")
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
