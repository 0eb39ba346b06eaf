"""Swin block with AdapterBit bottleneck adapters: kernels K4 (forward) and
K5 (backward), their plain versions, and the ``torch.autograd.Function``
that pairs them. The counterpart of the JAX package's
``ops/pallas/swin_block_adapt_vjp.py`` (``swin_block_adapt_eval``,
``swin_block_train_adapt``; ``_fwd_kernel``, ``_bwd_kernel``).

With s the constant adapter scalar and drop-path masks m (B, 2) float32
(all ones when serving):

    a      = window reverse + unshift of proj(attention(LN1 x))     (compute dtype)
    branch = a + s * (gelu(a Wsa1 + bsa1) Wsa2 + bsa2)                  (float32)
    y      = x + m0 * branch                                            (float32)
    h2     = LN2(y)                                                     (compute dtype)
    mo     = fc2(gelu(fc1 h2)) + s * (gelu(h2 Wma1 + bma1) Wma2 + bma2) (float32)
    out    = y + m1 * mo                                   (rounded once, at the end)

Unlike K2, the residual stream y stays float32 (swin_block_adapt_vjp.py:
126-152). The plain versions mirror ``_fwd_kernel`` and ``_bwd_kernel`` step
by step, at the same rounding points, with K3's two deliberate differences
(ops/swin_block_vjp.py): exact-erf GELU in both dtypes, and the q-scale
folded into the qkv weights.

The adapter width C * mlp_ratio is padded with zeros to a multiple of 32 (the
kernels' GEMM step; 48 -> 64 at stage 0): zero columns of Wa1 and ba1, zero
rows of Wa2. The padded units compute gelu(0) = 0, an exact no-op, and their
grads are cut off before they are returned. A block whose tree has one
adapter gets a zero-filled slot for the other (swin_block_adapt_vjp.py:
371-385), and no grads for it come back.

On a CUDA tensor ``swin_block_adapt_fused`` launches K4
(``csrc/swin_block_adapt.cu``: TMA-fed wgmma on the Hopper forward layer
``csrc/swin_fwd_sm90.cuh``, a launch a phase, the tile choices of ``TILES``)
and ``swin_block_adapt_backward`` K5 (``csrc/swin_block_adapt_bwd.cu``,
TMA-fed wgmma on the Hopper backward layer ``csrc/swin_bwd_sm90.cuh``, K3's
``TILES``), bf16 only, or raise; on a CPU tensor they run the plain
versions. ``swin_block_adapt_phases_plain`` chains the plain versions of
K4's phases (``branch_gemm_plain``, ``adapt_out_gemm_plain`` and K2's) as
its C entry chains its launches. The backward takes ``want``, the grads to
compute (None: all, the Pallas kernel's set); AdapterBit training asks for
the biases and adapters only, so the frozen weights' grads cost nothing.
"""

import ctypes
from dataclasses import dataclass
from typing import Dict, Iterable, List, Optional, Tuple

import torch
import torch.nn.functional as F

from ..models.adapters import check_kernels
from ..models.htsat import SwinTransformerBlock, window_partition, window_reverse
from . import swin_fwd_plan as plan
from ._cuda import CudaKernel, check_cuda_tensor, f32, i32, ptr
from .swin_block import (SwinBlockParams, _check_masks, _ln, _mm, attention_plain,
                         attention_rows, fwd_gemm_plain, ln_rows_plain, prepare_block)
from .swin_block_vjp import (GRAD_KEYS, _INV_SQRT2, _INV_SQRT2PI, _ln_bwd, _ln_fwd, _mlp_rows,
                             block_parameters, check_aligned, module_grads, tile_args, wanted,
                             wanted_keys)

_WS = [i32] * 9 + [ctypes.POINTER(ctypes.c_longlong)]
FWD_KERNEL = CudaKernel("swin_block_adapt.cu", {
    "swin_block_adapt_forward_workspace": _WS,
    "swin_block_adapt_forward": [ptr] * 24 + [f32, ptr, ptr] + [i32] * 15 + [ptr],
    "swin_adapt_gemm": [i32] * 3 + [ptr] * 3 + [i32] + [ptr] * 7 + [f32, ptr] + [i32] * 10
    + [ptr],
    "swin_adapt_ln_rows": [ptr] * 4 + [i32] * 2 + [ptr],
})

# K4's bf16 GEMMs' tile widths (128-row tiles of 64, 128 or 192 columns) at
# each stage width C, and the ring depth (0: as deep as fits): each GEMM's
# fastest width at B=32 (scripts/torch_k4_tiles.py). sa2 and fc2 + ma2, the
# float32 forms, run at width 64 (plan.F32_BN).
TILES = {
    96: {"qkv": 64, "proj": 128, "sa1": 64, "fc1": 128, "ma1": 64, "stages": 0},
    192: {"qkv": 128, "proj": 64, "sa1": 128, "fc1": 128, "ma1": 128, "stages": 0},
    384: {"qkv": 128, "proj": 64, "sa1": 128, "fc1": 128, "ma1": 128, "stages": 0},
    768: {"qkv": 128, "proj": 128, "sa1": 64, "fc1": 128, "ma1": 64, "stages": 0},
}
DEFAULT_TILES = {"qkv": 128, "proj": 128, "sa1": 64, "fc1": 128, "ma1": 64, "stages": 0}


def fwd_tile_args(C: int) -> Tuple[int, ...]:
    """K4's tile choices at stage width C (``TILES``, else
    ``DEFAULT_TILES``) as its C entry takes them (``plan.ADAPT_TILE_KEYS``)."""
    t = TILES.get(C, DEFAULT_TILES)
    plan.check_adapt_tiles(t)
    return tuple(int(t[k]) for k in plan.ADAPT_TILE_KEYS)
BWD_KERNEL = CudaKernel("swin_block_adapt_bwd.cu", {
    "swin_block_adapt_backward_workspace": [i32] * 15 + [ctypes.POINTER(ctypes.c_longlong)],
    "swin_block_adapt_backward": [ptr] * 25 + [f32] + [ptr] * 23 + [i32] * 15 + [ptr],
})

ADAPTER_KEYS = {"attn": ("sa1_w", "sa1_b", "sa2_w", "sa2_b"),
                "mlp": ("ma1_w", "ma1_b", "ma2_w", "ma2_b")}
ALL_KEYS = GRAD_KEYS + ADAPTER_KEYS["attn"] + ADAPTER_KEYS["mlp"]  # the C entry's order
PAD = 32  # the adapter width is padded to a multiple of this


@dataclass
class AdaptBlockParams:
    """One adapter block's weights in the kernels' layout: K2's
    ``SwinBlockParams`` (no merge fold) plus the spatial (sa) and MLP (ma)
    adapters' (in, out) matrices in the compute dtype and float32 biases,
    padded to width ``ch_pad``; ``ch`` is the true width, ``where`` the
    adapters the module has ("attn", "mlp")."""

    base: SwinBlockParams
    scale: float
    ch: int
    where: Tuple[str, ...]
    sa1_w: torch.Tensor
    sa1_b: torch.Tensor
    sa2_w: torch.Tensor
    sa2_b: torch.Tensor
    ma1_w: torch.Tensor
    ma1_b: torch.Tensor
    ma2_w: torch.Tensor
    ma2_b: torch.Tensor

    @property
    def ch_pad(self) -> int:
        return self.sa1_w.shape[1]


def block_adapters(block: SwinTransformerBlock) -> Dict[str, torch.nn.Module]:
    """The block's adapter modules by place ("attn", "mlp")."""
    return {w: m.adapter for w, m in (("attn", block.attn), ("mlp", block.mlp))
            if m.adapter is not None}


def has_adapters(block: SwinTransformerBlock) -> bool:
    return bool(block_adapters(block))


def prepare_adapt_block(block: SwinTransformerBlock,
                        compute_dtype: torch.dtype) -> AdaptBlockParams:
    """K2's prepared weights of ``block`` plus its adapters, padded, with a
    zero-filled slot for an adapter the block does not have."""
    ads = block_adapters(block)
    if not ads:
        raise ValueError("the block carries no adapter: use ops.swin_block")
    check_kernels(block)
    scales = {m.scale for m in ads.values()}
    if len(scales) != 1:
        raise ValueError(f"the block's adapters have different scalars {sorted(scales)}")
    C = block.dim
    ch = next(iter(ads.values())).fc1.out_features
    chp = -(-ch // PAD) * PAD
    dev = block.norm1.weight.device
    mats = {}
    with torch.no_grad():
        for where, (k1w, k1b, k2w, k2b) in ADAPTER_KEYS.items():
            w1, b1 = torch.zeros(C, chp, device=dev), torch.zeros(chp, device=dev)
            w2, b2 = torch.zeros(chp, C, device=dev), torch.zeros(C, device=dev)
            if where in ads:
                ad = ads[where]
                w1[:, :ch] = ad.fc1.weight.detach().float().t()
                b1[:ch] = ad.fc1.bias.detach().float()
                w2[:ch] = ad.fc2.weight.detach().float().t()
                b2.copy_(ad.fc2.bias.detach().float())
            mats.update({k1w: w1.to(compute_dtype).contiguous(), k1b: b1,
                         k2w: w2.to(compute_dtype).contiguous(), k2b: b2})
    return AdaptBlockParams(base=prepare_block(block, compute_dtype), scale=scales.pop(),
                            ch=ch, where=tuple(ads), **mats)


def _gelu_pair(f1: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(gelu(f1), gelu'(f1)) in float32, exact erf form."""
    cdf = 0.5 * (1.0 + torch.erf(f1 * _INV_SQRT2))
    return f1 * cdf, cdf + f1 * (torch.exp(-0.5 * f1 * f1) * _INV_SQRT2PI)


def _ones(x: torch.Tensor) -> torch.Tensor:
    return torch.ones((x.shape[0], 2), device=x.device, dtype=torch.float32)


def swin_block_adapt_plain(x: torch.Tensor, p: AdaptBlockParams,
                           dp_masks: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain PyTorch version of kernel K4, on any device: x (B, H*W, C) ->
    (B, H*W, C) in the compute dtype; ``dp_masks`` (B, 2) float32, ones
    when None (serving)."""
    b = p.base
    cd = b.qkv_w.dtype
    B, L, C = x.shape
    masks = _ones(x) if dp_masks is None else dp_masks
    _check_masks(masks, p.base, B)
    m0, m1 = (masks[:, i].reshape(B, 1, 1) for i in range(2))
    s = p.scale
    x0 = x.to(cd)
    a = attention_rows(x0, b)[-1]
    gs = F.gelu(_mm(a, p.sa1_w) + p.sa1_b, approximate="none").to(cd)
    branch = a.float() + s * (_mm(gs, p.sa2_w) + p.sa2_b)
    y = x0.float() + m0 * branch.reshape(B, L, C)
    h2 = _ln(y, b.ln2_w, b.ln2_b).to(cd)
    fg = F.gelu(_mm(h2, b.fc1_w) + b.fc1_b, approximate="none").to(cd)
    gm = F.gelu(_mm(h2, p.ma1_w) + p.ma1_b, approximate="none").to(cd)
    mo = (_mm(fg, b.fc2_w) + b.fc2_b) + s * (_mm(gm, p.ma2_w) + p.ma2_b)
    return (y + m1 * mo).to(cd)


def _image_rows(masks_col: torch.Tensor, M: int, L: int) -> torch.Tensor:
    """The mask of each row's image (row r in image r // L), as a column."""
    return masks_col[torch.arange(M, device=masks_col.device) // L][:, None]


def branch_gemm_plain(a: torch.Tensor, w: torch.Tensor, bias: torch.Tensor, x: torch.Tensor,
                      add: torch.Tensor, masks0: torch.Tensor, s: float, L: int) -> torch.Tensor:
    """Plain version of K4's F_BRANCH GEMM form (sa2): float32 y = x + m0
    (add + s (a w + bias)) over rows r, m0 = masks0[r // L] unrounded, x
    and add (M, N) in the compute dtype."""
    t = _mm(a, w) + bias
    return x.float() + _image_rows(masks0, a.shape[0], L) * (add.float() + s * t)


def adapt_out_gemm_plain(a: torch.Tensor, w: torch.Tensor, bias: torch.Tensor, a1: torch.Tensor,
                         w1: torch.Tensor, bias1: torch.Tensor, y: torch.Tensor,
                         masks1: torch.Tensor, s: float, L: int) -> torch.Tensor:
    """Plain version of K4's F_ADAPT_OUT GEMM form (fc2 and ma2 on one
    tile): cd(y + m1 ((a w + bias) + s (a1 w1 + bias1))) over rows r, m1 =
    masks1[r // L] unrounded, y (M, N) float32, cd a's dtype."""
    mo = (_mm(a, w) + bias) + s * (_mm(a1, w1) + bias1)
    return (y + _image_rows(masks1, a.shape[0], L) * mo).to(a.dtype)


def swin_block_adapt_phases_plain(x: torch.Tensor, p: AdaptBlockParams,
                                  dp_masks: Optional[torch.Tensor] = None) -> torch.Tensor:
    """K4's phases in plain PyTorch, chained as ``swin_block_adapt_forward``
    chains its launches (``plan.ADAPT_PHASES``), through ``swin_fwd_plan``'s
    row maps: LN1 rows in window order, qkv, the window attention, proj
    through the window -> token map, sa1 + GELU, sa2's branch into the
    float32 y, LN2 rows of y, fc1 and ma1 + GELU, fc2 and ma2 into the
    output. Gives ``swin_block_adapt_plain``'s bits (the CPU tests hold it
    there)."""
    b = p.base
    cd = b.qkv_w.dtype
    B, L, C = x.shape
    masks = _ones(x) if dp_masks is None else dp_masks
    _check_masks(masks, b, B)
    s = p.scale
    x0 = x.to(cd).reshape(B * L, C)
    rows = plan.window_rows(B, b.H, b.W, b.window, b.shift)
    h1 = ln_rows_plain(x0, b.ln1_w, b.ln1_b, rows)
    qkv = fwd_gemm_plain(h1, b.qkv_w, b.qkv_b)
    attn = attention_plain(qkv, b, B)
    a = fwd_gemm_plain(attn, b.proj_w, b.proj_b, rows_out=rows)
    gs = fwd_gemm_plain(a, p.sa1_w, p.sa1_b, gelu=True)
    y = branch_gemm_plain(gs, p.sa2_w, p.sa2_b, x0, a, masks[:, 0], s, L)
    h2 = ln_rows_plain(y, b.ln2_w, b.ln2_b, dtype=cd)
    fg = fwd_gemm_plain(h2, b.fc1_w, b.fc1_b, gelu=True)
    gm = fwd_gemm_plain(h2, p.ma1_w, p.ma1_b, gelu=True)
    out = adapt_out_gemm_plain(fg, b.fc2_w, b.fc2_b, gm, p.ma2_w, p.ma2_b, y, masks[:, 1], s, L)
    return out.reshape(B, L, C)


def _cut(p: AdaptBlockParams, grads: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """K3's grads plus those of the adapters the block has, unpadded (the
    keys ``grads`` holds)."""
    out = {k: grads[k] for k in GRAD_KEYS if k in grads}
    ch = p.ch
    cut = (lambda t: t[:, :ch], lambda t: t[:ch], lambda t: t[:ch], lambda t: t)
    for where in p.where:
        out.update({k: f(grads[k]) for k, f in zip(ADAPTER_KEYS[where], cut) if k in grads})
    return out


def swin_block_adapt_backward_plain(x: torch.Tensor, p: AdaptBlockParams,
                                    dp_masks: torch.Tensor, dout: torch.Tensor,
                                    want: Optional[Iterable[str]] = None
                                    ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Plain PyTorch version of kernel K5, on any device: x, dout (B, H*W,
    C), dp_masks (B, 2) float32 -> (dx in x's dtype, float32 grads in the
    kernels' layout: ``GRAD_KEYS`` and the present adapters'
    ``ADAPTER_KEYS``, only those ``want`` asks for)."""
    keys = wanted(want, ALL_KEYS)
    b = p.base
    cd = b.qkv_w.dtype
    B, L, C = x.shape
    H, W, w, sh, nh = b.H, b.W, b.window, b.shift, b.nh
    N, hd = w * w, C // nh
    _check_masks(dp_masks, p.base, B)
    m0, m1 = (dp_masks[:, i].float().reshape(B, 1, 1) for i in range(2))
    s = p.scale

    # ---- recompute the forward
    x0 = x.to(cd)
    xhat1, r1 = _ln_fwd(x0.float())
    win, q, k, v, pr, attn, a = attention_rows(x0, b)
    f1s = _mm(a, p.sa1_w) + p.sa1_b
    gsf, dgelus = _gelu_pair(f1s)
    gs = gsf.to(cd)
    branch = a.float() + s * (_mm(gs, p.sa2_w) + p.sa2_b)
    y = x0.float() + m0 * branch.reshape(B, L, C)
    yhat2, r2 = _ln_fwd(y)
    h2 = (yhat2 * b.ln2_w + b.ln2_b).to(cd).reshape(-1, C)

    # ---- MLP branch and MLP adapter, chunked by rows
    g = dout.float()
    df2f = (m1 * g).reshape(-1, C)
    df2 = df2f.to(cd)
    g2mf = s * df2f
    g2m = g2mf.to(cd)
    hidden, chp = b.fc1_w.shape[1], p.ch_pad
    grads = {k_: torch.zeros(n, device=x.device) for k_, n in (
        ("fc2_w", (hidden, C)), ("fc2_b", (C,)), ("fc1_w", (C, hidden)), ("fc1_b", (hidden,)),
        ("ma2_w", (chp, C)), ("ma2_b", (C,)), ("ma1_w", (C, chp)), ("ma1_b", (chp,)))}
    dh2 = torch.empty(B * L, C, device=x.device)
    rows = _mlp_rows(L)
    for r0 in range(0, B * L, rows):
        sl = slice(r0, r0 + rows)
        h2c = h2[sl]
        fgf, dgelu = _gelu_pair(_mm(h2c, b.fc1_w) + b.fc1_b)
        fg = fgf.to(cd)
        if "fc2_w" in keys:
            grads["fc2_w"] += _mm(fg.t(), df2[sl])
        grads["fc2_b"] += df2f[sl].sum(0)
        df1 = (_mm(df2[sl], b.fc2_w.t()) * dgelu).to(cd)
        if "fc1_w" in keys:
            grads["fc1_w"] += _mm(h2c.t(), df1)
        grads["fc1_b"] += df1.float().sum(0)
        dh2c = _mm(df1, b.fc1_w.t())
        gmf, dgelum = _gelu_pair(_mm(h2c, p.ma1_w) + p.ma1_b)
        gm = gmf.to(cd)
        if "ma2_w" in keys:
            grads["ma2_w"] += _mm(gm.t(), g2m[sl])
        grads["ma2_b"] += g2mf[sl].sum(0)
        df1m = (_mm(g2m[sl], p.ma2_w.t()) * dgelum).to(cd)
        if "ma1_w" in keys:
            grads["ma1_w"] += _mm(h2c.t(), df1m)
        grads["ma1_b"] += df1m.float().sum(0)
        dh2[sl] = dh2c + _mm(df1m, p.ma1_w.t())
    dh2 = dh2.reshape(B, L, C)
    grads["ln2_w"] = (dh2 * yhat2).sum((0, 1))
    grads["ln2_b"] = dh2.sum((0, 1))
    dy = g + _ln_bwd(dh2, yhat2, r2, b.ln2_w)

    # ---- spatial adapter, at branch = a + s * adapter(a), token order
    dbranch = (m0 * dy).reshape(-1, C)
    g2sf = s * dbranch
    g2s = g2sf.to(cd)
    if "sa2_w" in keys:
        grads["sa2_w"] = _mm(gs.t(), g2s)
    grads["sa2_b"] = g2sf.sum(0)
    df1s = (_mm(g2s, p.sa2_w.t()) * dgelus).to(cd)
    if "sa1_w" in keys:
        grads["sa1_w"] = _mm(a.t(), df1s)
    grads["sa1_b"] = df1s.float().sum(0)
    da = dbranch + _mm(df1s, p.sa1_w.t())

    # ---- attention branch (K3's, from the grad at proj's output)
    dbr = da.reshape(B, H, W, C)
    if sh:
        dbr = torch.roll(dbr, shifts=(-sh, -sh), dims=(1, 2))
    dA = window_partition(dbr, w).reshape(-1, C).to(cd)
    if "proj_w" in keys:
        grads["proj_w"] = _mm(attn.t(), dA)
    grads["proj_b"] = dA.float().sum(0)
    dattn = _mm(dA, b.proj_w.t()).to(cd)
    dO = dattn.reshape(-1, N, nh, hd).transpose(1, 2).float()
    pf = pr.float()
    dP = torch.matmul(dO, v.float().transpose(-1, -2))
    dV = torch.matmul(pf.transpose(-1, -2), dO)
    dS = pf * (dP - (dP * pf).sum(-1, keepdim=True))
    grads["bias"] = dS.sum(0)
    dSc = dS.to(cd).float()
    dq = torch.matmul(dSc, k.float())
    dk = torch.matmul(dSc.transpose(-1, -2), q.float())
    dqkv = torch.cat([t.transpose(1, 2).reshape(-1, C) for t in (dq, dk, dV)], -1).to(cd)
    if "qkv_w" in keys:
        grads["qkv_w"] = _mm(win.t(), dqkv)
    grads["qkv_b"] = dqkv.float().sum(0)
    dwin = _mm(dqkv, b.qkv_w.t()).to(cd)
    dh = window_reverse(dwin.reshape(-1, N, C), w, H, W)
    if sh:
        dh = torch.roll(dh, shifts=(sh, sh), dims=(1, 2))
    dh = dh.reshape(B, L, C).float()
    grads["ln1_w"] = (dh * xhat1).sum((0, 1))
    grads["ln1_b"] = dh.sum((0, 1))
    dx = dy + _ln_bwd(dh, xhat1, r1, b.ln1_w)
    return dx.to(x.dtype), _cut(p, {k_: grads[k_] for k_ in keys})


def _check_cuda_params(p: AdaptBlockParams, B: int) -> Tuple[int, ...]:
    """Raise unless ``p`` has the layout and shapes the kernels take; returns
    the shape arguments of the C entry points."""
    b = p.base
    C, H, W, w, nh = b.C, b.H, b.W, b.window, b.nh
    N, hd, hidden, chp = w * w, C // nh, b.fc1_w.shape[1], p.ch_pad
    if N != 64 or hd != 24 or C % 32 or hidden % 32 or chp % 32 or H % w or W % w:
        raise NotImplementedError(
            f"the adapter block kernels take 8x8 windows, head dim 24, C, hidden and the "
            f"padded adapter width % 32 == 0 and whole windows (got window={w}, hd={hd}, "
            f"C={C}, hidden={hidden}, adapter {chp}, {H}x{W})")
    if b.merge:
        raise ValueError("the adapter block has no merge fold")
    mats = {"qkv_w": (C, 3 * C), "proj_w": (C, C), "fc1_w": (C, hidden), "fc2_w": (hidden, C)}
    for name, shape in mats.items():
        check_cuda_tensor(name, getattr(b, name), torch.bfloat16, shape)
    for name, n in {"ln1_w": C, "ln1_b": C, "qkv_b": 3 * C, "proj_b": C, "ln2_w": C,
                    "ln2_b": C, "fc1_b": hidden, "fc2_b": C}.items():
        check_cuda_tensor(name, getattr(b, name), torch.float32, (n,))
    for w1, b1, w2, b2 in ADAPTER_KEYS.values():
        check_cuda_tensor(w1, getattr(p, w1), torch.bfloat16, (C, chp))
        check_cuda_tensor(b1, getattr(p, b1), torch.float32, (chp,))
        check_cuda_tensor(w2, getattr(p, w2), torch.bfloat16, (chp, C))
        check_cuda_tensor(b2, getattr(p, b2), torch.float32, (C,))
    check_cuda_tensor("bias", b.bias, torch.float32, (nh, N, N))
    if b.mask is not None:
        check_cuda_tensor("mask", b.mask, torch.float32, ((H // w) * (W // w), N, N))
    return B, H, W, C, nh, w, b.shift, hidden, chp


def _weight_ptrs(p: AdaptBlockParams) -> List[int]:
    b = p.base
    return [t.data_ptr() for t in (
        b.ln1_w, b.ln1_b, b.qkv_w, b.qkv_b, b.proj_w, b.proj_b, b.ln2_w, b.ln2_b,
        b.fc1_w, b.fc1_b, b.fc2_w, b.fc2_b, p.sa1_w, p.sa1_b, p.sa2_w, p.sa2_b,
        p.ma1_w, p.ma1_b, p.ma2_w, p.ma2_b, b.bias)] + [
        b.mask.data_ptr() if b.mask is not None else None]


def _workspace(kernel: CudaKernel, query: str, shapes: Tuple[int, ...], device) -> torch.Tensor:
    """The scratch the kernel's C entry needs at these shapes (its size query)."""
    nbytes = ctypes.c_longlong()
    if getattr(kernel.lib(), query)(*shapes, ctypes.byref(nbytes)) != 0:
        raise ValueError(f"{query} refused shapes {shapes}")
    return torch.empty(nbytes.value, device=device, dtype=torch.uint8)


def swin_block_adapt_fused(x: torch.Tensor, p: AdaptBlockParams,
                           dp_masks: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One Swin block with adapters (drop-path masks (B, 2) float32 in
    training, ones when None). A CPU tensor takes ``swin_block_adapt_plain``;
    a CUDA tensor launches kernel K4 (bfloat16) or raises."""
    if x.device.type == "cpu":
        return swin_block_adapt_plain(x, p, dp_masks)
    B, L, C = x.shape
    b = p.base
    check_cuda_tensor("x", x, torch.bfloat16, (B, b.H * b.W, C))
    masks = _ones(x) if dp_masks is None else dp_masks
    _check_masks(masks, b, B)
    check_cuda_tensor("dp_masks", masks, torch.float32, (B, 2))
    shapes = _check_cuda_params(p, B)
    plan.check_adapt_block(b.H, b.W, C, b.nh, b.window, b.fc1_w.shape[1], p.ch_pad)
    check_aligned({"x": x, "dp_masks": masks, "mask": b.mask, **{
        k_: getattr(b, k_) for k_ in GRAD_KEYS}, **{
        k_: getattr(p, k_) for k_ in ALL_KEYS[len(GRAD_KEYS):]}})
    tiles = fwd_tile_args(C)
    ws = _workspace(FWD_KERNEL, "swin_block_adapt_forward_workspace", shapes, x.device)
    out = torch.empty_like(x)
    FWD_KERNEL.launches += 1
    FWD_KERNEL.call("swin_block_adapt_forward", x.data_ptr(), masks.data_ptr(), *_weight_ptrs(p),
                    p.scale, out.data_ptr(), ws.data_ptr(), *shapes, *tiles)
    return out


def adapt_gemm(form: str, a: torch.Tensor, w: torch.Tensor, bias: torch.Tensor,
               gelu: bool = False, geometry: Optional[Tuple[int, int, int, int]] = None,
               x: Optional[torch.Tensor] = None, add: Optional[torch.Tensor] = None,
               a1: Optional[torch.Tensor] = None, w1: Optional[torch.Tensor] = None,
               bias1: Optional[torch.Tensor] = None, y: Optional[torch.Tensor] = None,
               masks: Optional[torch.Tensor] = None, col: int = 0, s: float = 0.0, L: int = 0,
               bn: int = plan.F32_BN, stages: int = 0) -> torch.Tensor:
    """One of K4's GEMM forms alone on the card (the C entry
    ``swin_adapt_gemm``), as its plain version computes it: ``form`` "out"
    (``fwd_gemm_plain``'s F_OUT, the output rows through the window -> token
    map of ``geometry`` (H, W, window, shift) when given), "branch"
    (``branch_gemm_plain``: x, add) or "adapt_out" (``adapt_out_gemm_plain``:
    a1, w1, bias1, y); a (M, K), w (K, N) bf16, biases float32, masks (images,
    2) float32 read at column ``col``, image of row r being r // L. The
    float32 forms take width ``plan.F32_BN`` only."""
    M, K = a.shape
    N = w.shape[1]
    K1 = a1.shape[1] if a1 is not None else 0
    epi = {"out": 0, "branch": 2, "adapt_out": 3}[form]
    H, W, win, shift = geometry if geometry is not None else (0, 0, 0, 0)
    if geometry is not None:
        L = H * W
    images = -(-M // L) if L > 0 else 0
    checks = {"a": (a, torch.bfloat16, (M, K)), "w": (w, torch.bfloat16, (K, N)),
              "bias": (bias, torch.float32, (N,)), "x": (x, torch.bfloat16, (M, N)),
              "add": (add, torch.bfloat16, (M, N)), "a1": (a1, torch.bfloat16, (M, K1)),
              "w1": (w1, torch.bfloat16, (K1, N)), "bias1": (bias1, torch.float32, (N,)),
              "y": (y, torch.float32, (M, N)), "masks": (masks, torch.float32, (images, 2))}
    for name, (t, dt, shape) in checks.items():
        if t is not None:
            check_cuda_tensor(name, t, dt, shape)
    check_aligned({k_: t for k_, (t, _, _) in checks.items()})
    if col not in (0, 1):
        raise ValueError(f"col: the masks' column, 0 or 1, got {col}")
    out = torch.empty((M, N), device=a.device,
                      dtype=torch.float32 if form == "branch" else torch.bfloat16)
    opt = lambda t: t.data_ptr() if t is not None else None  # noqa: E731
    m = masks.data_ptr() + 4 * col if masks is not None else None
    FWD_KERNEL.call("swin_adapt_gemm", epi, bn, stages, a.data_ptr(), w.data_ptr(), opt(bias),
                    int(gelu), opt(a1), opt(w1), opt(bias1), opt(x), opt(add), opt(y), m,
                    float(s), out.data_ptr(), M, N, K, K1, L, H, W, win, shift,
                    int(geometry is not None))
    return out


def adapt_ln_rows(y: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """K4's LN2 row pass alone on the card (the C entry
    ``swin_adapt_ln_rows``): float32 rows y (R, C) -> bf16 (R, C), as
    ``ln_rows_plain(y, w, b, dtype=torch.bfloat16)`` computes it."""
    R, C = y.shape
    for name, t, dt, shape in (("y", y, torch.float32, (R, C)), ("w", w, torch.float32, (C,)),
                               ("b", b, torch.float32, (C,))):
        check_cuda_tensor(name, t, dt, shape)
    check_aligned({"y": y, "w": w, "b": b})
    h = torch.empty((R, C), device=y.device, dtype=torch.bfloat16)
    FWD_KERNEL.call("swin_adapt_ln_rows", y.data_ptr(), w.data_ptr(), b.data_ptr(), h.data_ptr(),
                    R, C)
    return h


def swin_block_adapt_backward(x: torch.Tensor, p: AdaptBlockParams, dp_masks: torch.Tensor,
                              dout: torch.Tensor, want: Optional[Iterable[str]] = None
                              ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Backward of one Swin block with adapters, the grads ``want`` asks for
    (all when None). A CPU tensor takes ``swin_block_adapt_backward_plain``;
    a CUDA tensor launches kernel K5 (bfloat16) or raises."""
    if x.device.type == "cpu":
        return swin_block_adapt_backward_plain(x, p, dp_masks, dout, want)
    B, L, C = x.shape
    b = p.base
    check_cuda_tensor("x", x, torch.bfloat16, (B, b.H * b.W, C))
    check_cuda_tensor("dout", dout, torch.bfloat16, (B, b.H * b.W, C))
    _check_masks(dp_masks, p.base, B)
    check_cuda_tensor("dp_masks", dp_masks, torch.float32, (B, 2))
    shapes = _check_cuda_params(p, B) + tile_args()
    check_aligned({"x": x, "dout": dout, "dp_masks": dp_masks, "mask": b.mask, **{
        k_: getattr(b, k_) for k_ in GRAD_KEYS if k_ != "bias"}, "bias": b.bias, **{
        k_: getattr(p, k_) for k_ in ALL_KEYS[len(GRAD_KEYS):]}})
    hidden, chp, N = b.fc1_w.shape[1], p.ch_pad, b.window ** 2
    ws = _workspace(BWD_KERNEL, "swin_block_adapt_backward_workspace", shapes, x.device)
    sizes = {"ln1_w": (C,), "ln1_b": (C,), "qkv_w": (C, 3 * C), "qkv_b": (3 * C,),
             "proj_w": (C, C), "proj_b": (C,), "ln2_w": (C,), "ln2_b": (C,),
             "fc1_w": (C, hidden), "fc1_b": (hidden,), "fc2_w": (hidden, C), "fc2_b": (C,),
             "bias": (b.nh, N, N)}
    for w1, b1, w2, b2 in ADAPTER_KEYS.values():
        sizes.update({w1: (C, chp), b1: (chp,), w2: (chp, C), b2: (C,)})
    keys = wanted(want, ALL_KEYS)
    grads = {k_: torch.empty(sizes[k_], device=x.device, dtype=torch.float32) for k_ in keys}
    dx = torch.empty_like(x)
    BWD_KERNEL.launches += 1
    BWD_KERNEL.call("swin_block_adapt_backward", x.data_ptr(), dout.data_ptr(), dp_masks.data_ptr(),
                *_weight_ptrs(p), p.scale, dx.data_ptr(),
                *(grads[k_].data_ptr() if k_ in grads else None for k_ in ALL_KEYS),
                ws.data_ptr(), *shapes)
    return dx, _cut(p, grads)


def adapt_block_parameters(block: SwinTransformerBlock) -> List[torch.nn.Parameter]:
    """The block's parameters in the order ``SwinBlockAdaptTrain`` returns
    their grads: K3's ``block_parameters``, then each present adapter's
    fc1.weight, fc1.bias, fc2.weight, fc2.bias (attn before mlp)."""
    out = block_parameters(block)
    for ad in block_adapters(block).values():
        out += [ad.fc1.weight, ad.fc1.bias, ad.fc2.weight, ad.fc2.bias]
    return out


def adapt_param_keys(block: SwinTransformerBlock) -> Tuple[str, ...]:
    """The grad keys of ``adapt_block_parameters(block)``, in its order."""
    return GRAD_KEYS + sum((ADAPTER_KEYS[w] for w in block_adapters(block)), ())


def adapt_module_grads(block: SwinTransformerBlock,
                       g: Dict[str, torch.Tensor]) -> List[Optional[torch.Tensor]]:
    """Kernel-layout grads -> grads of ``adapt_block_parameters(block)``;
    None for a key ``g`` lacks."""
    out = module_grads(block, g)
    for where in block_adapters(block):
        w1, b1, w2, b2 = ADAPTER_KEYS[where]
        out += [g[w1].t() if w1 in g else None, g.get(b1), g[w2].t() if w2 in g else None,
                g.get(b2)]
    return out


class SwinBlockAdaptTrain(torch.autograd.Function):
    """One training Swin block with adapters: K4 with drop-path masks
    forward, K5 backward (on the CPU, or with ``use_kernels=False``, their
    plain versions). Saves only x and the masks; the backward recomputes the
    forward. Grads come back for x and ``adapt_block_parameters(block)``
    (None where autograd needs none: frozen parameters), none for the masks.

        y = SwinBlockAdaptTrain.apply(x, masks, block, compute_dtype, use_kernels,
                                      *adapt_block_parameters(block))
    """

    @staticmethod
    def forward(ctx, x, dp_masks, block, compute_dtype, use_kernels, *params):
        p = prepare_adapt_block(block, compute_dtype)
        ctx.block, ctx.prepared, ctx.use_kernels = block, p, use_kernels
        ctx.save_for_backward(x, dp_masks)
        x = x.to(compute_dtype)
        fn = swin_block_adapt_fused if use_kernels else swin_block_adapt_plain
        return fn(x, p, dp_masks)

    @staticmethod
    def backward(ctx, dout):
        x, dp_masks = ctx.saved_tensors
        p = ctx.prepared
        cd = p.base.qkv_w.dtype
        fn = swin_block_adapt_backward if ctx.use_kernels else swin_block_adapt_backward_plain
        want = wanted_keys(adapt_param_keys(ctx.block), ctx.needs_input_grad[5:])
        dx, g = fn(x.to(cd), p, dp_masks, dout.to(cd).contiguous(), want)
        grads = [gr if need else None for gr, need in
                 zip(adapt_module_grads(ctx.block, g), ctx.needs_input_grad[5:])]
        return (dx.to(x.dtype), None, None, None, None, *grads)


def swin_block_adapt_train(x: torch.Tensor, block: SwinTransformerBlock, dp_masks: torch.Tensor,
                           compute_dtype: torch.dtype, use_kernels: bool = True) -> torch.Tensor:
    """Differentiable training block with adapters and drop-path masks (B, 2)
    float32."""
    return SwinBlockAdaptTrain.apply(x, dp_masks, block, compute_dtype, use_kernels,
                                     *adapt_block_parameters(block))
