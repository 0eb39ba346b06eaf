"""Training Swin block: kernel K3 (the block's backward), its plain version,
and the ``torch.autograd.Function`` that pairs it with K2. The counterpart of
the JAX package's ``ops/pallas/swin_block_vjp.py`` (``swin_block_train``,
``_bwd_call`` -> ``_bwd_kernel``).

Forward: K2 with per-image drop-path masks (B, 2) float32 (y = x + m0 * attn,
out = y + m1 * mlp; reference model_utilities.py:216-231). Backward: the
forward is recomputed from x alone, then dx and every parameter gradient.
``swin_block_backward_plain`` mirrors ``_bwd_kernel`` step by step, with the
same rounding points: y recomputed in float32 (swin_block_vjp.py:127), the MLP
chunked by rows, GELU' in the exact erf form, weight-grad products on
compute-dtype operands with float32 accumulation, P rounded before P V, dS,
dqkv, the attention-output grad and the window-order input grad rounded to the
compute dtype, and dx returned in x's dtype.

Two deliberate differences from the Pallas kernel: GELU and its derivative
use the exact erf in both dtypes (its bf16 path uses a fast erf,
swin_block_vjp.py:143-144), and the q-scale is folded into the qkv weights as
K2 reads them (ops/swin_block.py), so q is rounded once (the Pallas backward
rounds q, then q * scale) and the q-column gradients come out per folded
weight; ``module_grads`` multiplies them by the scale.

On a CUDA tensor ``swin_block_backward`` launches the hand-written kernels of
``csrc/swin_block_bwd.cu`` (bf16 only; TMA-fed wgmma on the Hopper layer
``csrc/swin_bwd_sm90.cuh``, with the tile choices of ``TILES``) or raises;
on a CPU tensor it runs ``swin_block_backward_plain``. Both take ``want``,
the grads to compute (None: all of ``GRAD_KEYS``, the Pallas kernel's set);
training passes what autograd asks for, so frozen parameters cost nothing.
"""

import ctypes
import math
from functools import lru_cache
from typing import Dict, Iterable, List, Optional, Tuple

import torch

from ..models.htsat import (SwinTransformerBlock, relative_position_index,
                            window_partition, window_reverse)
from ._cuda import CudaKernel, check_cuda_tensor, i32, ptr
from .swin_block import (LN_EPS, SwinBlockParams, _mm, attention_rows, check_aligned,
                         prepare_block, swin_block_fused, swin_block_plain)

# The kernels' tile choices (scripts/torch_k35_tiles.py sweeps them), shared
# by K3 and K5: the tile width (64 or 128 columns, 128 rows) of the recompute
# GEMMs h W (nn), the activation-grad GEMMs dY W^T (nt, also the two-pair
# K5 dh2), the dual GEMMs (fc1's recompute with fc2's activation grad, and
# the adapters'), the weight-grad GEMMs A^T dY (tt), the work items the
# weight grads' row split aims at (the rows are cut into equal multiples of
# 64, at least 8 k-blocks each; a pure function of the shape), and the
# GEMMs' ring depth (stages; 0: as deep as shared memory allows, at most 6).
TILES = {"bn_nn": 128, "bn_nt": 128, "bn_dual": 64, "bn_tt": 128, "tt_items": 132, "stages": 0}
TILE_KEYS = ("bn_nn", "bn_nt", "bn_dual", "bn_tt", "tt_items", "stages")

KERNEL = CudaKernel("swin_block_bwd.cu", {
    "swin_block_backward": [ptr] * 32 + [i32] * 14 + [ptr],
    "swin_block_backward_workspace": [i32] * 14 + [ctypes.POINTER(ctypes.c_longlong)],
    "swin_bwd_gemm": [i32] * 3 + [ptr, ptr, i32, ptr, ptr] + [i32] * 3 + [ptr, i32] + [ptr] * 5
    + [ptr],
    "swin_bwd_gemm_workspace": [i32] * 5 + [ctypes.POINTER(ctypes.c_longlong)],
})
# the backward layer's GEMM forms, as swin_bwd_gemm numbers them
GEMM_FORMS = ("nn", "nn_f32", "nt", "nt_f32", "cat", "dual", "tt")

GRAD_KEYS = ("ln1_w", "ln1_b", "qkv_w", "qkv_b", "proj_w", "proj_b", "ln2_w", "ln2_b",
             "fc1_w", "fc1_b", "fc2_w", "fc2_b", "bias")
_INV_SQRT2 = 1.0 / math.sqrt(2.0)
_INV_SQRT2PI = 1.0 / math.sqrt(2.0 * math.pi)


def _ln_fwd(xf: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """float32 LayerNorm without affine: (xhat, 1/sigma)."""
    m = xf.mean(-1, keepdim=True)
    c = xf - m
    r = torch.rsqrt((c * c).mean(-1, keepdim=True) + LN_EPS)
    return c * r, r


def _ln_bwd(dout: torch.Tensor, xhat: torch.Tensor, r: torch.Tensor,
            gamma: torch.Tensor) -> torch.Tensor:
    dxhat = dout * gamma
    return r * (dxhat - dxhat.mean(-1, keepdim=True)
                - xhat * (dxhat * xhat).mean(-1, keepdim=True))


def wanted(want: Optional[Iterable[str]], keys: Iterable[str]) -> Tuple[str, ...]:
    """The keys of ``keys`` that ``want`` asks for (all when None), in order."""
    if want is None:
        return tuple(keys)
    want = set(want)
    return tuple(k for k in keys if k in want)


def tile_args() -> Tuple[int, ...]:
    """``TILES`` as the kernels' C entries take them."""
    return tuple(int(TILES[k]) for k in TILE_KEYS)


def _mlp_rows(L: int) -> int:
    """Rows per MLP chunk: the Pallas kernel's split of an image's L rows
    into max(1, min(4, L // 512)) chunks."""
    return L // max(1, min(4, L // 512))


def swin_block_backward_plain(x: torch.Tensor, p: SwinBlockParams, dp_masks: torch.Tensor,
                              dout: torch.Tensor, want: Optional[Iterable[str]] = None
                              ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Plain PyTorch version of kernel K3, on any device: x, dout (B, H*W, C),
    dp_masks (B, 2) float32 -> (dx in x's dtype, float32 grads in K2's
    layout keyed by ``GRAD_KEYS``, only those ``want`` asks for)."""
    keys = wanted(want, GRAD_KEYS)
    cd = p.qkv_w.dtype
    B, L, C = x.shape
    H, W, w, s, nh = p.H, p.W, p.window, p.shift, p.nh
    N, hd = w * w, C // nh
    m0 = dp_masks[:, 0].float().reshape(B, 1, 1)
    m1 = dp_masks[:, 1].float().reshape(B, 1, 1)

    # ---- recompute the forward
    x0 = x.to(cd)
    xhat1, r1 = _ln_fwd(x0.float())
    win, q, k, v, pr, attn, a = attention_rows(x0, p)
    y = x0.float() + m0 * a.reshape(B, L, C).float()
    yhat2, r2 = _ln_fwd(y)
    h2 = (yhat2 * p.ln2_w + p.ln2_b).to(cd).reshape(-1, C)

    # ---- MLP branch, chunked by rows
    g = dout.float()
    df2_all = (m1 * g).to(cd).reshape(-1, C)
    hidden = p.fc1_w.shape[1]
    grads = {k_: torch.zeros(n, device=x.device) for k_, n in (
        ("fc2_w", (hidden, C)), ("fc2_b", (C,)), ("fc1_w", (C, hidden)), ("fc1_b", (hidden,)))}
    dh2 = torch.empty(B * L, C, device=x.device)
    rows = _mlp_rows(L)
    for r0 in range(0, B * L, rows):
        h2c, df2 = h2[r0:r0 + rows], df2_all[r0:r0 + rows]
        f1 = _mm(h2c, p.fc1_w) + p.fc1_b
        cdf = 0.5 * (1.0 + torch.erf(f1 * _INV_SQRT2))
        fg = (f1 * cdf).to(cd)
        dgelu = cdf + f1 * (torch.exp(-0.5 * f1 * f1) * _INV_SQRT2PI)
        if "fc2_w" in keys:
            grads["fc2_w"] += _mm(fg.t(), df2)
        grads["fc2_b"] += df2.float().sum(0)
        df1 = (_mm(df2, p.fc2_w.t()) * dgelu).to(cd)
        if "fc1_w" in keys:
            grads["fc1_w"] += _mm(h2c.t(), df1)
        grads["fc1_b"] += df1.float().sum(0)
        dh2[r0:r0 + rows] = _mm(df1, p.fc1_w.t())
    dh2 = dh2.reshape(B, L, C)
    grads["ln2_w"] = (dh2 * yhat2).sum((0, 1))
    grads["ln2_b"] = dh2.sum((0, 1))
    dy = g + _ln_bwd(dh2, yhat2, r2, p.ln2_w)

    # ---- attention branch
    dbr = (m0 * dy).reshape(B, H, W, C)
    if s:
        dbr = torch.roll(dbr, shifts=(-s, -s), dims=(1, 2))
    dA = window_partition(dbr, w).reshape(-1, C).to(cd)
    if "proj_w" in keys:
        grads["proj_w"] = _mm(attn.t(), dA)
    grads["proj_b"] = dA.float().sum(0)
    dattn = _mm(dA, p.proj_w.t()).to(cd)
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
    dwin = _mm(dqkv, p.qkv_w.t()).to(cd)
    dh = window_reverse(dwin.reshape(-1, N, C), w, H, W)
    if s:
        dh = torch.roll(dh, shifts=(s, s), dims=(1, 2))
    dh = dh.reshape(B, L, C).float()
    grads["ln1_w"] = (dh * xhat1).sum((0, 1))
    grads["ln1_b"] = dh.sum((0, 1))
    dx = dy + _ln_bwd(dh, xhat1, r1, p.ln1_w)
    return dx.to(x.dtype), {k_: grads[k_] for k_ in keys}


def swin_block_backward(x: torch.Tensor, p: SwinBlockParams, dp_masks: torch.Tensor,
                        dout: torch.Tensor, want: Optional[Iterable[str]] = None
                        ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Backward of one training Swin block, the grads ``want`` asks for (all
    when None). A CPU tensor takes ``swin_block_backward_plain``; a CUDA
    tensor launches kernel K3 (bfloat16) or raises."""
    if x.device.type == "cpu":
        return swin_block_backward_plain(x, p, dp_masks, dout, want)
    B, L, C = x.shape
    H, W, w, nh = p.H, p.W, p.window, p.nh
    N, hd, hidden = w * w, C // nh, p.fc1_w.shape[1]
    check_cuda_tensor("x", x, torch.bfloat16, (B, H * W, C))
    check_cuda_tensor("dout", dout, torch.bfloat16, (B, H * W, C))
    check_cuda_tensor("dp_masks", dp_masks, torch.float32, (B, 2))
    if N != 64 or hd != 24 or C % 32 or hidden % 32 or H % w or W % w:
        raise NotImplementedError(
            f"the Swin block backward kernel takes 8x8 windows, head dim 24, "
            f"C % 32 == 0 and whole windows (got window={w}, hd={hd}, C={C}, {H}x{W})")
    if p.merge:
        raise ValueError("the training block has no merge fold")
    for name, shape in {"qkv_w": (C, 3 * C), "proj_w": (C, C), "fc1_w": (C, hidden),
                        "fc2_w": (hidden, C)}.items():
        check_cuda_tensor(name, getattr(p, name), torch.bfloat16, shape)
    for name, n in {"ln1_w": C, "ln1_b": C, "qkv_b": 3 * C, "proj_b": C, "ln2_w": C,
                    "ln2_b": C, "fc1_b": hidden, "fc2_b": C}.items():
        check_cuda_tensor(name, getattr(p, name), torch.float32, (n,))
    check_cuda_tensor("bias", p.bias, torch.float32, (nh, N, N))
    nW = (H // w) * (W // w)
    if p.mask is not None:
        check_cuda_tensor("mask", p.mask, torch.float32, (nW, N, N))
    check_aligned({"x": x, "dout": dout, "dp_masks": dp_masks, "mask": p.mask, **{
        k_: getattr(p, k_) for k_ in ("qkv_w", "proj_w", "fc1_w", "fc2_w", "ln1_w", "ln1_b",
                                      "qkv_b", "proj_b", "ln2_w", "ln2_b", "fc1_b", "fc2_b",
                                      "bias")}})

    shapes = (B, H, W, C, nh, w, p.shift, hidden) + tile_args()
    nbytes = ctypes.c_longlong()
    rc = KERNEL.lib().swin_block_backward_workspace(*shapes, ctypes.byref(nbytes))
    if rc != 0:
        raise ValueError(f"swin_block_backward_workspace refused shapes {shapes}")
    dev = x.device
    ws = torch.empty(nbytes.value, device=dev, dtype=torch.uint8)
    dx = torch.empty_like(x)
    sizes = {"ln1_w": (C,), "ln1_b": (C,), "qkv_w": (C, 3 * C), "qkv_b": (3 * C,),
             "proj_w": (C, C), "proj_b": (C,), "ln2_w": (C,), "ln2_b": (C,),
             "fc1_w": (C, hidden), "fc1_b": (hidden,), "fc2_w": (hidden, C), "fc2_b": (C,),
             "bias": (nh, N, N)}
    keys = wanted(want, GRAD_KEYS)
    grads = {k_: torch.empty(sizes[k_], device=dev, dtype=torch.float32) for k_ in keys}
    KERNEL.launches += 1
    KERNEL.call("swin_block_backward",
                x.data_ptr(), dout.data_ptr(), dp_masks.data_ptr(), p.ln1_w.data_ptr(),
                p.ln1_b.data_ptr(), p.qkv_w.data_ptr(), p.qkv_b.data_ptr(),
                p.proj_w.data_ptr(), p.proj_b.data_ptr(), p.ln2_w.data_ptr(),
                p.ln2_b.data_ptr(), p.fc1_w.data_ptr(), p.fc1_b.data_ptr(),
                p.fc2_w.data_ptr(), p.fc2_b.data_ptr(), p.bias.data_ptr(),
                p.mask.data_ptr() if p.mask is not None else None, dx.data_ptr(),
                *(grads[k_].data_ptr() if k_ in grads else None for k_ in GRAD_KEYS),
                ws.data_ptr(), *shapes)
    return dx, grads


def bwd_gemm_plain(form: str, a0: torch.Tensor, b0: torch.Tensor,
                   a1: Optional[torch.Tensor] = None, b1: Optional[torch.Tensor] = None,
                   bias: Optional[torch.Tensor] = None,
                   gelu: bool = False) -> Dict[str, torch.Tensor]:
    """Plain version of one GEMM form of K3/K5's backward layer
    (``GEMM_FORMS``), float32 sums of the bf16 operands: nn a0 b0 (+ bias,
    GELU), rounded ("out") or float32 ("out_f32"); nt a0 b0^T the same; cat
    a0 b0^T + a1 b1^T (float32); dual: out = bf16(gelu(a0 b0 + bias)), out1 =
    bf16((a1 b1^T) gelu'(a0 b0 + bias)) and colsum, the column sums of out1;
    tt a0^T b0 (float32)."""
    cd = a0.dtype
    if form == "tt":
        return {"out_f32": _mm(a0.t(), b0)}
    if form == "dual":
        f1 = _mm(a0, b0) + bias
        cdf = 0.5 * (1.0 + torch.erf(f1 * _INV_SQRT2))
        d = (_mm(a1, b1.t()) * (cdf + f1 * (torch.exp(-0.5 * f1 * f1) * _INV_SQRT2PI))).to(cd)
        return {"out": (f1 * cdf).to(cd), "out1": d, "colsum": d.float().sum(0)}
    f = _mm(a0, b0) if form.startswith("nn") else _mm(a0, b0.t())
    if form == "cat":
        return {"out_f32": f + _mm(a1, b1.t())}
    if bias is not None:
        f = f + bias
    if gelu:
        f = 0.5 * f * (1.0 + torch.erf(f * _INV_SQRT2))
    return {"out_f32": f} if form.endswith("_f32") else {"out": f.to(cd)}


def bwd_gemm(form: str, a0: torch.Tensor, b0: torch.Tensor, a1: Optional[torch.Tensor] = None,
             b1: Optional[torch.Tensor] = None, bias: Optional[torch.Tensor] = None,
             gelu: bool = False, bn: int = 128,
             tt_items: int = TILES["tt_items"]) -> Dict[str, torch.Tensor]:
    """One GEMM form of the backward layer alone, as ``bwd_gemm_plain``: a
    CPU tensor takes the plain version, CUDA bf16 operands launch the
    kernel (tile width ``bn``; tt split for ``tt_items`` work items) or
    raise. Operands: nn b0 (K, N); nt, cat, the dual's b1 (N, K); tt a0
    (rows, Ka), b0 (rows, N)."""
    if a0.device.type == "cpu":
        return bwd_gemm_plain(form, a0, b0, a1, b1, bias, gelu)
    if form not in GEMM_FORMS or bn not in (64, 128):
        raise NotImplementedError(f"forms {GEMM_FORMS}, bn 64 or 128 (got {form!r}, {bn})")
    for name, t in (("a0", a0), ("b0", b0), ("a1", a1), ("b1", b1)):
        if t is not None:
            check_cuda_tensor(name, t, torch.bfloat16)
    if form == "tt":
        K0, M, N = a0.shape[0], a0.shape[1], b0.shape[1]
    else:
        M, K0 = a0.shape
        N = b0.shape[1] if form.startswith("nn") or form == "dual" else b0.shape[0]
    K1 = a1.shape[1] if a1 is not None else 8
    if bias is not None:
        check_cuda_tensor("bias", bias, torch.float32, (N,))
    dev = a0.device
    outs = {}
    if form in ("nn", "nt", "dual"):
        outs["out"] = torch.empty(M, N, device=dev, dtype=torch.bfloat16)
    if form == "dual":
        outs["out1"] = torch.empty(M, N, device=dev, dtype=torch.bfloat16)
        outs["colsum"] = torch.empty(-(-M // 128), N, device=dev)
    if form in ("nn_f32", "nt_f32", "cat", "tt"):
        outs["out_f32"] = torch.empty(M, N, device=dev)
    nbytes = ctypes.c_longlong()
    KERNEL.lib().swin_bwd_gemm_workspace(K0, M, N, bn, tt_items, ctypes.byref(nbytes))
    ws = torch.empty(max(nbytes.value, 4), device=dev, dtype=torch.uint8)
    dp = lambda t: t.data_ptr() if t is not None else None  # noqa: E731
    KERNEL.call("swin_bwd_gemm", GEMM_FORMS.index(form), bn, tt_items, dp(a0), dp(b0), K0,
                dp(a1), dp(b1), K1, M, N, dp(bias), int(gelu), dp(outs.get("out")),
                dp(outs.get("out1")), dp(outs.get("out_f32")), dp(outs.get("colsum")),
                ws.data_ptr())
    if form == "dual":
        outs["colsum"] = outs["colsum"].sum(0)
    return outs


@lru_cache(maxsize=8)
def _table_fold(window: int, device: torch.device) -> torch.Tensor:
    """(table rows, N*N) float32 0/1 matrix: the index-add of the gathered
    bias grad onto the relative-position table (``segment_sum`` at
    swin_block_vjp.py:317-321) as one product, so the sum has a fixed order
    on every device."""
    idx = torch.as_tensor(relative_position_index(window).reshape(-1))
    fold = torch.zeros((2 * window - 1) ** 2, idx.numel())
    fold[idx, torch.arange(idx.numel())] = 1.0
    return fold.to(device)


def block_parameters(block: SwinTransformerBlock) -> List[torch.nn.Parameter]:
    """The block's parameters in the order ``module_grads`` returns them."""
    a, m = block.attn, block.mlp
    return [block.norm1.weight, block.norm1.bias, a.qkv.weight, a.qkv.bias,
            a.proj.weight, a.proj.bias, block.norm2.weight, block.norm2.bias,
            m.fc1.weight, m.fc1.bias, m.fc2.weight, m.fc2.bias,
            a.relative_position_bias_table]


def module_grads(block: SwinTransformerBlock,
                 g: Dict[str, torch.Tensor]) -> List[Optional[torch.Tensor]]:
    """Kernel-layout grads -> grads of ``block_parameters(block)``: (in, out)
    matrices transposed to the Linear (out, in) layout, the q columns of
    qkv multiplied by the q-scale folded into the kernel's weights, and the
    (nh, N, N) bias grad folded onto the relative-position table; None for a
    key ``g`` lacks."""
    C, nh, w = block.dim, block.num_heads, block.window_size
    dev = next(iter(g.values())).device
    qs = torch.ones(3 * C, device=dev)
    qs[:C] = (C // nh) ** -0.5
    dtable = None
    if "bias" in g:
        dbias = g["bias"].permute(1, 2, 0).reshape(w ** 4, nh)
        dtable = torch.matmul(_table_fold(w, dbias.device), dbias)
    layout = {"qkv_w": lambda t: t.t() * qs[:, None], "qkv_b": lambda t: t * qs,
              "proj_w": lambda t: t.t(), "fc1_w": lambda t: t.t(), "fc2_w": lambda t: t.t()}
    out = [layout.get(k, lambda t: t)(g[k]) if k in g else None for k in GRAD_KEYS[:-1]]
    return out + [dtable]


def wanted_keys(keys: Iterable[str], needs: Iterable[bool]) -> Tuple[str, ...]:
    """The grad keys whose parameters autograd asks for (``needs``, in the
    parameters' order)."""
    return tuple(k for k, need in zip(keys, needs) if need)


class SwinBlockTrain(torch.autograd.Function):
    """One training Swin block: K2 with drop-path masks forward, K3 backward
    (on the CPU, or with ``use_kernels=False``, their plain versions).
    Saves only x and the masks; the backward recomputes the forward. Grads
    come back for x and ``block_parameters(block)``, none for the masks.

        y = SwinBlockTrain.apply(x, masks, block, compute_dtype, use_kernels,
                                 *block_parameters(block))
    """

    @staticmethod
    def forward(ctx, x, dp_masks, block, compute_dtype, use_kernels, *params):
        p = prepare_block(block, compute_dtype)
        ctx.block, ctx.prepared, ctx.use_kernels = block, p, use_kernels
        ctx.save_for_backward(x, dp_masks)
        x = x.to(compute_dtype)
        return (swin_block_fused if use_kernels else swin_block_plain)(x, p, dp_masks)

    @staticmethod
    def backward(ctx, dout):
        x, dp_masks = ctx.saved_tensors
        p = ctx.prepared
        fn = swin_block_backward if ctx.use_kernels else swin_block_backward_plain
        want = wanted_keys(GRAD_KEYS, ctx.needs_input_grad[5:])
        dx, g = fn(x.to(p.qkv_w.dtype), p, dp_masks, dout.to(p.qkv_w.dtype).contiguous(), want)
        return (dx.to(x.dtype), None, None, None, None, *module_grads(ctx.block, g))


def swin_block_train(x: torch.Tensor, block: SwinTransformerBlock, dp_masks: torch.Tensor,
                     compute_dtype: torch.dtype, use_kernels: bool = True) -> torch.Tensor:
    """Differentiable training block with drop-path masks (B, 2) float32."""
    return SwinBlockTrain.apply(x, dp_masks, block, compute_dtype, use_kernels,
                                *block_parameters(block))
