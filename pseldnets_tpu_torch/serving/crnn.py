"""Fused-kernel CRNN (CNN8/CNN12 + conformer) inference in PyTorch, the
counterpart of the JAX package's serving/crnn.py: the eval forward of
models.heads.CRNN with every ConvBlock of the trunk run by kernel K7
(ops/conv_block.py, the pair mode: both convs, bias and ReLU) and, from the
waveform, the features, the eval ScalarBN and the compute-dtype cast run by
kernel K1 (ops/frontend.py).

As in the JAX package, the eval BatchNorms fold into the conv weights and
biases (``fold_conv_bn``: the kernel scaled in float32, then cast; the shift
in float32) and into the conformer's depthwise kernel. The rest is plain
PyTorch, rounded where the JAX path rounds: the avg-pools as float32 sums
rounded once (floor: 1001 frames -> 500), the frequency mean in float32,
the conformer block with flattened denses (compute-dtype operands, float32
accumulation and bias, one rounding), LayerNorm, softmax, GLU and SiLU in
float32, the interpolate + frame mean as one (T_out, T') matrix, fc, and
tanh in float32. The TPU knobs of the JAX path (``conv_impl``,
``pallas_max_weight_mb``, ``conv_out``, ``pool``, ``ffn_barrier``) are not
ported: they choose between TPU schedules of the same arithmetic.

Eval only; decoders conformer or None (gru and transformer raise).
``use_kernels=False`` calls K1's and K7's plain versions on the same device:
the reference a card run is held against.
"""

import math
from dataclasses import dataclass
from functools import lru_cache
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..models.backbone import ConvBlock
from ..models.common import NO_DECODER, TorchBatchNorm
from ..models.conformer import ConformerBlock, relative_shift, sinusoid_position_encoding
from ..models.heads import CRNN
from ..ops._cuda import resolve_device
from ..ops.conv_block import conv3x3_bias_relu, conv3x3_bias_relu_plain, padded_channels
from .htsat import folded_wav_features, scalar_bn_affine


@dataclass
class ConvBlockParams:
    """One ConvBlock with its eval BNs folded: HWIO kernels in the compute
    dtype, float32 shifts, the avg-pool (time, freq)."""

    w1: torch.Tensor
    b1: torch.Tensor
    w2: torch.Tensor
    b2: torch.Tensor
    pool: Tuple[int, int]


@dataclass
class CRNNParams:
    blocks: List[ConvBlockParams]
    decoder: List[Dict[str, torch.Tensor]]  # one dict per conformer block
    num_heads: int = 8


def fold_conv_bn(conv: nn.Conv2d, bn: TorchBatchNorm,
                 dtype: torch.dtype) -> Tuple[torch.Tensor, torch.Tensor]:
    """conv (no bias) + eval BN -> (HWIO kernel * inv in float32, cast to
    ``dtype``; float32 shift) (serving/crnn.py:39-53 of the JAX package)."""
    inv, shift = bn.eval_affine()
    k = conv.weight.float().permute(2, 3, 1, 0) * inv
    return k.to(dtype).contiguous(), shift.contiguous()


def prepare_conv_block(blk: ConvBlock, dtype: torch.dtype, cin_pad: int = 0) -> ConvBlockParams:
    """Fold one ConvBlock; ``cin_pad`` zero-pads conv1's input channels (the
    stem's 7 -> 8 for K7: zero channels add nothing)."""
    w1, b1 = fold_conv_bn(blk.conv1, blk.bn1, dtype)
    w2, b2 = fold_conv_bn(blk.conv2, blk.bn2, dtype)
    if cin_pad > w1.shape[2]:
        w1 = F.pad(w1, (0, 0, 0, cin_pad - w1.shape[2])).contiguous()
    return ConvBlockParams(w1, b1, w2, b2, blk.pool_size)


def prepare_conformer_block(layer: ConformerBlock, dtype: torch.dtype) -> Dict[str, torch.Tensor]:
    """One conformer block's weights: dense weights (out, in) in ``dtype``,
    biases, LayerNorm affines and u/v biases in float32, the depthwise kernel
    (C, k) with its eval BN folded (float32 product, cast) and the BN shift."""
    ff1, mhsa, conv, ff2, final = (layer.sequential[i] for i in range(5))
    ff1, mhsa, conv, ff2 = ff1.module, mhsa.module, conv.module, ff2.module
    att = mhsa.attention
    f32 = lambda t: t.detach().float().contiguous()  # noqa: E731
    cd = lambda t: t.detach().float().to(dtype).contiguous()  # noqa: E731
    p: Dict[str, torch.Tensor] = {}

    def dense(name, lin_w, lin_b=None):
        p[name + ".w"] = cd(lin_w)
        if lin_b is not None:
            p[name + ".b"] = f32(lin_b)

    def norm(name, ln):
        p[name + ".w"], p[name + ".b"] = f32(ln.weight), f32(ln.bias)

    for tag, ff in (("ff1", ff1), ("ff2", ff2)):
        norm(tag + ".norm", ff.sequential[0])
        dense(tag + ".fc1", ff.sequential[1].weight, ff.sequential[1].bias)
        dense(tag + ".fc2", ff.sequential[4].weight, ff.sequential[4].bias)
    norm("attn_norm", mhsa.layer_norm)
    for name in ("query_proj", "key_proj", "value_proj", "out_proj"):
        lin = getattr(att, name)
        dense("attn." + name, lin.weight, lin.bias)
    dense("attn.pos_proj", att.pos_proj.weight)
    p["attn.u_bias"], p["attn.v_bias"] = f32(att.u_bias), f32(att.v_bias)
    seq = conv.sequential
    norm("conv.norm", seq[0])
    dense("conv.pw_conv1", seq[2].conv.weight[:, :, 0], seq[2].conv.bias)
    inv, shift = seq[5].eval_affine()
    p["conv.dw"] = (seq[4].conv.weight[:, 0].float() * inv[:, None]).to(dtype).contiguous()
    p["conv.dw_shift"] = shift.contiguous()
    dense("conv.pw_conv2", seq[7].conv.weight[:, :, 0], seq[7].conv.bias)
    norm("final_norm", final)
    return p


def prepare_crnn(model: CRNN, compute_dtype: torch.dtype = torch.bfloat16) -> CRNNParams:
    """Every ConvBlock folded (the stem padded to 8 input channels) and
    every conformer block laid out for :func:`crnn_fused_forward`."""
    with torch.no_grad():
        blocks = [prepare_conv_block(blk, compute_dtype,
                                     padded_channels(model.in_channels) if i == 0 else 0)
                  for i, blk in enumerate(model.convs.blocks)]
        if model.decoder_kind != "conformer":
            return CRNNParams(blocks, [])
        layers = model.decoder.layers
        return CRNNParams(blocks, [prepare_conformer_block(layer, compute_dtype)
                                   for layer in layers],
                          layers[0].sequential[1].module.attention.num_heads)


def avg_pool(x: torch.Tensor, pool: Tuple[int, int]) -> torch.Tensor:
    """NHWC avg-pool with floor semantics: float32 sums of the window,
    times 1 / (pt pf), rounded once (the JAX path's _pool_slice)."""
    pt, pf = pool
    if pt == 1 and pf == 1:
        return x
    B, T, Fq, C = x.shape
    T2, F2 = T // pt, Fq // pf
    parts = x[:, :T2 * pt, :F2 * pf].reshape(B, T2, pt, F2, pf, C)
    s = None
    for i in range(pt):
        for j in range(pf):
            part = parts[:, :, i, :, j].float()
            s = part if s is None else s + part
    return (s * (1.0 / (pt * pf))).to(x.dtype)


def _dense(x: torch.Tensor, p: Dict[str, torch.Tensor], name: str,
           cd: torch.dtype) -> torch.Tensor:
    """x (..., in) in the compute dtype times the weight (out, in):
    float32 accumulation, + float32 bias, one rounding to the compute dtype
    (the JAX path's _dense2d). On the card a bf16 product goes to one cuBLAS
    call with a float32 result; elsewhere the operands go up to float32 (the
    same arithmetic: bf16 products are exact in float32)."""
    w = p[name + ".w"]
    x2 = x.reshape(-1, x.shape[-1])
    if x2.is_cuda and cd == torch.bfloat16:
        y = torch.mm(x2, w.t(), out_dtype=torch.float32)
    else:
        y = torch.matmul(x2.float(), w.float().t())
    if name + ".b" in p:
        y = y + p[name + ".b"]
    return y.to(cd).reshape(*x.shape[:-1], -1)


def _norm(x: torch.Tensor, p: Dict[str, torch.Tensor], name: str) -> torch.Tensor:
    """float32 LayerNorm (eps 1e-5), rounded to x's dtype: one fused kernel on
    the card (the two-pass ops.swin_block._ln costs ~9 launches per norm)."""
    y = F.layer_norm(x.float(), x.shape[-1:], p[name + ".w"], p[name + ".b"], 1e-5)
    return y.to(x.dtype)


def _rel_mhsa(x: torch.Tensor, p: Dict[str, torch.Tensor], nh: int,
              cd: torch.dtype) -> torch.Tensor:
    """Transformer-XL relative MHSA, eval (the JAX path's _rel_mhsa)."""
    B, T, C = x.shape
    D = C // nh
    q = _dense(x, p, "attn.query_proj", cd).reshape(B, T, nh, D)
    k = _dense(x, p, "attn.key_proj", cd).reshape(B, T, nh, D)
    v = _dense(x, p, "attn.value_proj", cd).reshape(B, T, nh, D)
    pos_tab = torch.as_tensor(sinusoid_position_encoding(T, C), device=x.device).to(cd)
    pp = _dense(pos_tab, p, "attn.pos_proj", cd).reshape(1, T, nh, D)
    qu = (q + p["attn.u_bias"].to(cd)).float()
    qv = (q + p["attn.v_bias"].to(cd)).float()
    content = torch.einsum("bthd,bshd->bhts", qu, k.float())
    pos = relative_shift(torch.einsum("bthd,zshd->bhts", qv, pp.float()))
    score = (content + pos) * (1.0 / math.sqrt(C))
    attn = torch.softmax(score, dim=-1).to(cd)
    ctx = torch.einsum("bhts,bshd->bthd", attn.float(), v.float()).to(cd)
    return _dense(ctx.reshape(B, T, C), p, "attn.out_proj", cd)


def _depthwise(h: torch.Tensor, dw: torch.Tensor, shift: torch.Tensor) -> torch.Tensor:
    """SAME depthwise conv of (B, T, C) with a (C, k) kernel as k shifted
    float32 multiply-adds (no library conv on the served path), + shift."""
    k = dw.shape[1]
    pad = (k - 1) // 2
    T = h.shape[1]
    hp = F.pad(h.float(), (0, 0, pad, k - 1 - pad))
    wf = dw.float()
    acc = hp[:, 0:T] * wf[:, 0]
    for j in range(1, k):
        acc.addcmul_(hp[:, j:j + T], wf[:, j])
    return acc + shift


def conformer_block(x: torch.Tensor, p: Dict[str, torch.Tensor], nh: int,
                    cd: torch.dtype) -> torch.Tensor:
    """Eval conformer block on (B, T, C) with flattened denses (the JAX
    path's _conformer_block)."""
    def ffn(h, tag):
        f = _dense(_norm(h, p, tag + ".norm"), p, tag + ".fc1", cd).float()
        f = (f * torch.sigmoid(f)).to(cd)
        return _dense(f, p, tag + ".fc2", cd)

    x = x + 0.5 * ffn(x, "ff1")
    x = x + _rel_mhsa(_norm(x, p, "attn_norm"), p, nh, cd)
    C = x.shape[-1]
    h = _dense(_norm(x, p, "conv.norm"), p, "conv.pw_conv1", cd)
    h = (h[..., :C].float() * torch.sigmoid(h[..., C:].float())).to(cd)
    h = _depthwise(h, p["conv.dw"], p["conv.dw_shift"])
    h = (h * torch.sigmoid(h)).to(cd)
    x = x + _dense(h, p, "conv.pw_conv2", cd)
    x = x + 0.5 * ffn(x, "ff2")
    return _norm(x, p, "final_norm")


@lru_cache(maxsize=8)
def interp_mean_matrix(t_in: int, ratio: int, pred_res: int, t_raw: int) -> np.ndarray:
    """(T_out, t_in) matrix equal to repeat-interpolate(ratio) then the mean
    over ``pred_res`` frames (heads.CRNN), T_out = t_raw // pred_res (the
    JAX path's _interp_mean_matrix)."""
    t_out = t_raw // pred_res
    m = np.zeros((t_out, t_in), np.float32)
    for s in range(t_out):
        for i in range(s * pred_res, (s + 1) * pred_res):
            m[s, min(i // ratio, t_in - 1)] += 1.0 / pred_res
    return m


def trunk_input(x: torch.Tensor, compute_dtype: torch.dtype, channels: int) -> torch.Tensor:
    """Normalized (B, C, T, F) features -> the trunk's NHWC input in the
    compute dtype, channels zero-padded to ``channels``, in one copy."""
    x = x.to(compute_dtype).permute(0, 2, 3, 1)
    return F.pad(x, (0, channels - x.shape[-1])).contiguous()


def _check_decoder(model: CRNN) -> None:
    if model.decoder_kind != "conformer" and model.decoder_kind not in NO_DECODER:
        raise NotImplementedError(
            f"crnn_fused_forward supports the conformer and null decoders, not "
            f"'{model.decoder_kind}'")


@torch.no_grad()
def crnn_fused_forward(model: CRNN, x: torch.Tensor, *,
                       compute_dtype: torch.dtype = torch.bfloat16,
                       pre_normalized: bool = False,
                       params: Optional[CRNNParams] = None,
                       use_kernels: bool = True) -> Dict[str, torch.Tensor]:
    """Eval forward equal to ``model(x)`` up to compute-dtype rounding;
    ``x`` (B, C, T, F) features.

    ``pre_normalized``: ``x`` already carries the eval ScalarBN (folded into
    the frontend kernel). ``params``: :func:`prepare_crnn` of this model and
    dtype, to skip folding the weights on every call."""
    _check_decoder(model)
    cd = compute_dtype
    if params is None:
        params = prepare_crnn(model, cd)
    conv_fn = conv3x3_bias_relu if use_kernels else conv3x3_bias_relu_plain
    B, _, T, _ = x.shape
    output_frames = T // model.pred_res
    if not pre_normalized:
        inv, shift = scalar_bn_affine(model)
        x = x.float() * inv[None, :, None, :] + shift[None, :, None, :]
    h = trunk_input(x, cd, params.blocks[0].w1.shape[2])
    for blk in params.blocks:
        h = avg_pool(conv_fn(h, blk.w1, blk.b1, blk.w2, blk.b2, compute_dtype=cd), blk.pool)
    h = h.float().mean(dim=2).to(cd)  # (B, T', C)
    for p in params.decoder:
        h = conformer_block(h, p, params.num_heads, cd)
    m = torch.as_tensor(interp_mean_matrix(h.shape[1], 8, model.pred_res, T),
                        device=h.device).to(cd)
    h = torch.matmul(m.float(), h.float()).to(cd)[:, :output_frames]
    y = torch.matmul(h.float(), model.fc.weight.to(cd).float().t()) + model.fc.bias.float()
    return {model.output_key: torch.tanh(y.to(cd).float())}


@torch.no_grad()
def crnn_fused_forward_from_wav(model: CRNN, wav, *,
                                compute_dtype: torch.dtype = torch.bfloat16,
                                device="cuda", params: Optional[CRNNParams] = None,
                                use_kernels: bool = True,
                                **frontend_kwargs) -> Dict[str, torch.Tensor]:
    """Full serving step from the FOA waveform (B, 4, S) float32: kernel K1
    (features + eval ScalarBN + cast, 1 + S // hop frames, no frame pad) then
    the fused model (K7 on every ConvBlock). ``device`` defaults to the card
    and raises when CUDA is absent; ``model`` must already live there."""
    _check_decoder(model)
    device = resolve_device(device)
    wav = torch.as_tensor(wav, dtype=torch.float32, device=device)
    if model.scalar.weight.device != wav.device:
        raise ValueError(f"model is on {model.scalar.weight.device}, "
                         f"serving device is {wav.device}")
    feats = folded_wav_features(model, wav, compute_dtype=compute_dtype,
                                use_kernels=use_kernels, **frontend_kwargs)
    return crnn_fused_forward(model, feats, compute_dtype=compute_dtype, pre_normalized=True,
                              params=params, use_kernels=use_kernels)
