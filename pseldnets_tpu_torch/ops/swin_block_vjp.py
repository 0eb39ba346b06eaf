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
``csrc/swin_block_bwd.cu`` (bf16 only) or raises; on a CPU tensor it runs
``swin_block_backward_plain``.
"""

import ctypes
import math
from functools import lru_cache
from typing import Dict, List, Tuple

import torch

from ..models.htsat import (SwinTransformerBlock, relative_position_index,
                            window_partition, window_reverse)
from ._cuda import CudaKernel, check_cuda_tensor, i32, ptr
from .swin_block import (LN_EPS, SwinBlockParams, _mm, attention_rows, prepare_block,
                         swin_block_fused, swin_block_plain)

KERNEL = CudaKernel("swin_block_bwd.cu", {
    "swin_block_backward": [ptr] * 32 + [i32] * 8 + [ptr],
    "swin_block_backward_workspace": [i32] * 8 + [ctypes.POINTER(ctypes.c_longlong)],
})

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


def _mlp_rows(L: int) -> int:
    """Rows per MLP chunk: the Pallas kernel's split of an image's L rows
    into max(1, min(4, L // 512)) chunks."""
    return L // max(1, min(4, L // 512))


def swin_block_backward_plain(x: torch.Tensor, p: SwinBlockParams, dp_masks: torch.Tensor,
                              dout: torch.Tensor) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Plain PyTorch version of kernel K3, on any device: x, dout (B, H*W, C),
    dp_masks (B, 2) float32 -> (dx in x's dtype, float32 grads in K2's
    layout keyed by ``GRAD_KEYS``)."""
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
        grads["fc2_w"] += _mm(fg.t(), df2)
        grads["fc2_b"] += df2.float().sum(0)
        df1 = (_mm(df2, p.fc2_w.t()) * dgelu).to(cd)
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
    return dx.to(x.dtype), {k_: grads[k_] for k_ in GRAD_KEYS}


def swin_block_backward(x: torch.Tensor, p: SwinBlockParams, dp_masks: torch.Tensor,
                        dout: torch.Tensor) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Backward of one training Swin block. A CPU tensor takes
    ``swin_block_backward_plain``; a CUDA tensor launches kernel K3
    (bfloat16) or raises."""
    if x.device.type == "cpu":
        return swin_block_backward_plain(x, p, dp_masks, dout)
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

    shapes = (B, H, W, C, nh, w, p.shift, hidden)
    nbytes = ctypes.c_longlong()
    KERNEL.lib().swin_block_backward_workspace(*shapes, ctypes.byref(nbytes))
    dev = x.device
    ws = torch.empty(nbytes.value, device=dev, dtype=torch.uint8)
    dx = torch.empty_like(x)
    sizes = {"ln1_w": (C,), "ln1_b": (C,), "qkv_w": (C, 3 * C), "qkv_b": (3 * C,),
             "proj_w": (C, C), "proj_b": (C,), "ln2_w": (C,), "ln2_b": (C,),
             "fc1_w": (C, hidden), "fc1_b": (hidden,), "fc2_w": (hidden, C), "fc2_b": (C,),
             "bias": (nh, N, N)}
    grads = {k_: torch.empty(sizes[k_], device=dev, dtype=torch.float32) for k_ in GRAD_KEYS}
    KERNEL.launches += 1
    KERNEL.call("swin_block_backward",
                x.data_ptr(), dout.data_ptr(), dp_masks.data_ptr(), p.ln1_w.data_ptr(),
                p.ln1_b.data_ptr(), p.qkv_w.data_ptr(), p.qkv_b.data_ptr(),
                p.proj_w.data_ptr(), p.proj_b.data_ptr(), p.ln2_w.data_ptr(),
                p.ln2_b.data_ptr(), p.fc1_w.data_ptr(), p.fc1_b.data_ptr(),
                p.fc2_w.data_ptr(), p.fc2_b.data_ptr(), p.bias.data_ptr(),
                p.mask.data_ptr() if p.mask is not None else None, dx.data_ptr(),
                *(grads[k_].data_ptr() for k_ in GRAD_KEYS), ws.data_ptr(), *shapes)
    return dx, grads


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


def module_grads(block: SwinTransformerBlock, g: Dict[str, torch.Tensor]) -> List[torch.Tensor]:
    """Kernel-layout grads -> grads of ``block_parameters(block)``: (in, out)
    matrices transposed to the Linear (out, in) layout, the q columns of
    qkv multiplied by the q-scale folded into the kernel's weights, and the
    (nh, N, N) bias grad folded onto the relative-position table."""
    C, nh, w = block.dim, block.num_heads, block.window_size
    qs = torch.ones(3 * C, device=g["qkv_b"].device)
    qs[:C] = (C // nh) ** -0.5
    dbias = g["bias"].permute(1, 2, 0).reshape(w ** 4, nh)
    dtable = torch.matmul(_table_fold(w, dbias.device), dbias)
    return [g["ln1_w"], g["ln1_b"], g["qkv_w"].t() * qs[:, None], g["qkv_b"] * qs,
            g["proj_w"].t(), g["proj_b"], g["ln2_w"], g["ln2_b"], g["fc1_w"].t(),
            g["fc1_b"], g["fc2_w"].t(), g["fc2_b"], dtable]


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
        dx, g = fn(x.to(p.qkv_w.dtype), p, dp_masks, dout.to(p.qkv_w.dtype).contiguous())
        return (dx.to(x.dtype), None, None, None, None, *module_grads(ctx.block, g))


def swin_block_train(x: torch.Tensor, block: SwinTransformerBlock, dp_masks: torch.Tensor,
                     compute_dtype: torch.dtype, use_kernels: bool = True) -> torch.Tensor:
    """Differentiable training block with drop-path masks (B, 2) float32."""
    return SwinBlockTrain.apply(x, dp_masks, block, compute_dtype, use_kernels,
                                *block_parameters(block))
