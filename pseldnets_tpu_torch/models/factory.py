"""Model factory: (method, backbone) -> torch module, the counterpart of the
JAX package's models/factory.py: the ACCDOA/mACCDOA CRNN, ConvConformer,
HTSAT and PaSST heads, and the EINV2 CRNN, ConvConformer, HTSAT,
HTSAT_SEDDOA and PaSST heads.

Mirrors the reference's lookup (src/models/model_module.py:13-34) including the
audio_feature -> in_channels mapping (:24-31).
"""

import math

import torch
import torch.nn as nn

from ..ops._cuda import resolve_device
from . import einv2_heads, heads
from .adapters import AdaptConfig, AdaptConv, AdaptDense, Adapter
from .common import CrossStitch, TorchBatchNorm
from .conformer import RelativeMultiHeadAttention
from .htsat import WindowAttention
from .passt import PaSSTEncoder

# PaSST encoder kwargs the module does not take (the JAX package's
# models/factory.py:18)
_PASST_DROP = ("representation_size", "norm_layer", "act_layer", "attn_drop_rate")


def in_channels_for(audio_feature: str) -> int:
    if audio_feature in ("logmelIV", "salsa", "salsalite"):
        return 7
    if audio_feature in ("logmelgcc",):
        return 10
    if audio_feature in ("logmel",):
        return 1
    raise ValueError(f"unknown audio_feature '{audio_feature}'")


def init_weights(model: nn.Module, generator: torch.Generator) -> None:
    """Deterministic random weights from ``generator``, scaled so activations
    stay O(1) through every layer: Linear/Conv/GRU/packed-attention weights
    N(0, 1/fan_in) truncated at 2 sigma with N(0, 0.02) biases, LayerNorm
    and BatchNorm affines 1 + N(0, 0.1) and N(0, 0.1), relative-position
    tables N(0, 0.5) so the bias visibly shapes attention, the conformer's
    u/v biases xavier-uniform (as flax), CrossStitch weights U(0.1, 0.9)
    (the JAX init's range). BN running stats stay (0, 1).
    An adapter's fc2 stays zero and a learnable adapter scale one, a LoRA
    ``lora_A`` is N(0, 1/fan_in) and its ``lora_B`` zero, as the JAX package
    initializes them (so a fresh adapter or LoRA term adds nothing)."""
    def randn(p, std, base=0.0):
        p.copy_(base + std * torch.randn(p.shape, generator=generator))

    def drawn(p, init, **kw):
        # drawn into a CPU tensor, then copied: the values do not depend on
        # the device p lives on (a CPU generator cannot fill a CUDA tensor)
        t = torch.empty(p.shape, dtype=p.dtype)
        init(t, generator=generator, **kw)
        p.copy_(t)

    def fan_in_normal(w):
        w.copy_(torch.randn(w.shape, generator=generator).clamp_(-2, 2)
                / math.sqrt(w[0].numel()))

    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, (nn.Linear, nn.Conv1d, nn.Conv2d)):
                fan_in_normal(mod.weight)
                if mod.bias is not None:
                    randn(mod.bias, 0.02)
            elif isinstance(mod, (nn.GRU, nn.MultiheadAttention)):
                for name, p in mod.named_parameters(recurse=False):
                    if "weight" in name:
                        fan_in_normal(p)
                    else:
                        randn(p, 0.02)
            elif isinstance(mod, RelativeMultiHeadAttention):
                drawn(mod.u_bias, nn.init.xavier_uniform_)
                drawn(mod.v_bias, nn.init.xavier_uniform_)
            elif isinstance(mod, (nn.LayerNorm, TorchBatchNorm)):
                randn(mod.weight, 0.1, 1.0)
                randn(mod.bias, 0.1)
            elif isinstance(mod, CrossStitch):
                mod.weight.copy_(0.1 + 0.8 * torch.rand(mod.weight.shape, generator=generator))
            elif isinstance(mod, WindowAttention):
                randn(mod.relative_position_bias_table, 0.5)
            elif isinstance(mod, PaSSTEncoder):
                for p in (mod.cls_token, mod.dist_token, mod.new_pos_embed,
                          mod.freq_new_pos_embed, mod.time_new_pos_embed):
                    if p is not None:
                        drawn(p, nn.init.trunc_normal_, std=0.02, a=-0.04, b=0.04)
        for mod in model.modules():
            if isinstance(mod, Adapter):
                mod.fc2.weight.zero_()
                mod.fc2.bias.zero_()
                if mod.scale is None:
                    mod.weight.fill_(1.0)
            elif isinstance(mod, AdaptDense) and mod.lora_r:
                fan_in_normal(mod.lora_A)
                mod.lora_B.zero_()
            elif isinstance(mod, AdaptConv) and mod.lora_r:
                mod.lora_B.weight.zero_()


def build_model(cfg, num_classes: int, *, device="cuda", seed: int = 0):
    """Returns (module, meta): the eval-mode module on ``device`` with seeded
    random weights (load real ones with train.checkpoint), and the
    checkpoint-loading info. Raises when ``device`` is CUDA and no card is
    present."""
    device = resolve_device(device)
    method = cfg["model"]["method"]
    backbone = cfg["model"]["backbone"]
    data = cfg["data"]
    in_channels = in_channels_for(data["audio_feature"])
    mel_bins = int(data["n_mels"])
    pred_res = int(data["sample_rate"] / data["hoplen"] * 0.1)
    kwargs = dict(cfg["model"].get("kwargs", {}) or {})
    pretrained_path = kwargs.pop("pretrained_path", None)
    audioset_pretrain = kwargs.pop("audioset_pretrain", True)
    tgt_output_frames = int(kwargs.pop("tgt_output_frames", 100))
    adapt = AdaptConfig(cfg.get("adapt"))  # the HTSAT heads' AdapterBit or LoRA

    if method == "einv2":
        model = _einv2_model(cfg, backbone, num_classes, in_channels, mel_bins, pred_res,
                             tgt_output_frames, adapt, dict(kwargs))
    elif method not in ("accdoa", "multi_accdoa") or backbone not in (
            "CRNN", "ConvConformer", "HTSAT", "PASST"):
        raise NotImplementedError(f"backbone '{backbone}' for method '{method}'")
    elif backbone in ("CRNN", "ConvConformer"):
        cls = heads.ConvConformer if backbone == "ConvConformer" else heads.CRNN
        model = cls(num_classes=num_classes, in_channels=in_channels,
                    **_crnn_kwargs(cfg, kwargs, mel_bins, pred_res),
                    num_tracks=_num_tracks(method))
    elif backbone == "PASST":  # takes no adapters, as in the JAX package
        model = heads.PASST(num_classes=num_classes, in_channels=in_channels,
                            mel_bins=mel_bins, num_tracks=_num_tracks(method),
                            encoder_kwargs=_passt_kwargs(kwargs))
    else:
        model = heads.HTSAT(num_classes=num_classes, in_channels=in_channels,
                            mel_bins=mel_bins, pred_res=pred_res,
                            num_tracks=_num_tracks(method),
                            tgt_output_frames=tgt_output_frames,
                            encoder_kwargs=_htsat_kwargs(kwargs), adapt=adapt)
    init_weights(model, torch.Generator().manual_seed(seed))
    meta = {"pretrained_path": pretrained_path,
            "audioset_pretrain": audioset_pretrain,
            "method": method, "backbone": backbone, "in_channels": in_channels}
    return model.to(device).eval(), meta


def _num_tracks(method: str) -> int:
    return 3 if method == "multi_accdoa" else 1


def _crnn_kwargs(cfg, kwargs, mel_bins: int, pred_res: int, decoder=None):
    return dict(encoder=kwargs.get("encoder", "CNN8"),
                num_features=tuple(kwargs.get("num_features", (32, 64, 128, 256))),
                decoder=decoder or cfg["model"].get("decoder"),
                num_decoder_layers=int(cfg["model"].get("num_decoder_layers", 2)),
                mel_bins=mel_bins, pred_res=pred_res)


def _htsat_kwargs(kwargs):
    enc = dict(kwargs)
    enc["depths"] = tuple(enc.get("depths", (2, 2, 6, 2)))
    enc["num_heads"] = tuple(enc.get("num_heads", (4, 8, 16, 32)))
    enc["patch_stride"] = tuple(enc.get("patch_stride", (4, 4)))
    enc["mlp_ratio"] = float(enc.get("mlp_ratio", 4.0))
    return enc


def _passt_kwargs(kwargs):
    enc = {k: v for k, v in kwargs.items() if k not in _PASST_DROP}
    enc["img_size"] = tuple(enc.get("img_size", (64, 1001)))
    enc["mlp_ratio"] = float(enc.get("mlp_ratio", 4.0))
    return enc


def _einv2_model(cfg, backbone, num_classes, in_channels, mel_bins, pred_res,
                 tgt_output_frames, adapt, kwargs):
    """The EINV2 heads (the JAX package's models/factory.py:98-130)."""
    if backbone in ("CRNN", "ConvConformer"):
        decoder = "conformer" if backbone == "ConvConformer" else None
        return einv2_heads.CRNN(num_classes=num_classes, in_channels=in_channels,
                                **_crnn_kwargs(cfg, kwargs, mel_bins, pred_res, decoder))
    if backbone in ("HTSAT", "HTSAT_SEDDOA"):
        cls = einv2_heads.HTSAT if backbone == "HTSAT" else einv2_heads.HTSAT_SEDDOA
        return cls(num_classes=num_classes, in_channels=in_channels, mel_bins=mel_bins,
                   pred_res=pred_res, tgt_output_frames=tgt_output_frames,
                   encoder_kwargs=_htsat_kwargs(kwargs), adapt=adapt)
    if backbone == "PASST":
        return einv2_heads.PASST(num_classes=num_classes, in_channels=in_channels,
                                 mel_bins=mel_bins, ps_gap=int(cfg["model"].get("ps_gap", 2)),
                                 decoder=cfg["model"].get("decoder"),
                                 num_decoder_layers=int(cfg["model"].get("num_decoder_layers", 2)),
                                 encoder_kwargs=_passt_kwargs(kwargs))
    raise NotImplementedError(f"backbone '{backbone}' for method 'einv2'")
