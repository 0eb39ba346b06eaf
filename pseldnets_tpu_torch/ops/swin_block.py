"""Fused Swin block: kernel K2 and its plain version. The counterpart of the
JAX package's ``ops/pallas/swin_block.py::swin_block_fused`` (exact softmax,
with the PatchMerging fold of ``merge_params`` for serving, or the per-image
drop-path masks ``dp_masks`` for training).

    LN1 -> cyclic shift -> window partition -> qkv (q-scale folded) -> per-head
    scores + relative-position bias + shift mask -> max-subtracted softmax ->
    PV -> proj -> window reverse + unshift -> residual -> LN2 -> fc1 -> exact
    GELU -> fc2 -> residual [-> 2x2 merge -> LN(4C) -> 4C->2C reduction]

Numerics follow the Pallas kernel: matmul operands in the compute dtype with
float32 accumulation, LayerNorm and softmax in float32, and every activation
(qkv, attention output, proj, hidden, residual sums) rounded to the compute
dtype where the kernel rounds it. GELU is the exact erf form in both dtypes
(the Pallas kernel's bf16 path uses a polynomial within 5.2e-5 of it - below
bf16 rounding). With drop-path masks m (B, 2) float32 the residual adds are
``x + cd(m0) * proj`` and ``y + cd(m1) * mlp``, each product rounded to the
compute dtype, as the Pallas forward computes them (swin_block.py:351, :389).

On a CUDA tensor ``swin_block_fused`` launches the hand-written kernels of
``csrc/swin_block.cu`` (bf16 only); on a CPU tensor it runs
``swin_block_plain``.
"""

from dataclasses import dataclass
from typing import Optional

import torch
import torch.nn.functional as F

from ..models.htsat import (PatchMerging, SwinTransformerBlock, window_partition,
                            window_reverse)
from ._cuda import CudaKernel, check_cuda_tensor, i32, ptr

KERNEL = CudaKernel("swin_block.cu", {
    "swin_block_forward": [ptr] * 26 + [i32] * 8 + [ptr],
})

LN_EPS = 1e-5


@dataclass
class SwinBlockParams:
    """One block's weights in the layout the kernel reads: (in, out) matrices
    in the compute dtype, biases and norms in float32, the attention q-scale
    folded into the q columns of qkv (in float32, before the cast), the
    relative-position bias gathered to (nh, N, N) and the shift mask (nW, N, N)."""

    H: int
    W: int
    nh: int
    window: int
    shift: int
    ln1_w: torch.Tensor
    ln1_b: torch.Tensor
    qkv_w: torch.Tensor
    qkv_b: torch.Tensor
    proj_w: torch.Tensor
    proj_b: torch.Tensor
    ln2_w: torch.Tensor
    ln2_b: torch.Tensor
    fc1_w: torch.Tensor
    fc1_b: torch.Tensor
    fc2_w: torch.Tensor
    fc2_b: torch.Tensor
    bias: torch.Tensor
    mask: Optional[torch.Tensor] = None
    merge_ln_w: Optional[torch.Tensor] = None
    merge_ln_b: Optional[torch.Tensor] = None
    merge_w: Optional[torch.Tensor] = None

    @property
    def C(self) -> int:
        return self.ln1_w.shape[0]

    @property
    def merge(self) -> bool:
        return self.merge_w is not None


def prepare_block(block: SwinTransformerBlock, compute_dtype: torch.dtype,
                  merge: Optional[PatchMerging] = None) -> SwinBlockParams:
    """Fold and lay out one block's (and optionally its stage's PatchMerging)
    weights for ``swin_block_fused``: the counterpart of the host-side prep in
    the JAX package's swin_block_fused (q-scale fold, ``_rel_bias``, the
    shift mask)."""
    with torch.no_grad():
        f = lambda t: t.detach().float().contiguous()  # noqa: E731
        cd = lambda t: t.detach().float().t().contiguous().to(compute_dtype)  # noqa: E731
        H, W = block.input_resolution
        C, nh, w, shift = block.dim, block.num_heads, block.window_size, block.shift_size
        scale = (C // nh) ** -0.5
        qs = torch.ones(3 * C, device=block.norm1.weight.device)
        qs[:C] = scale
        qkv_w = block.attn.qkv.weight.detach().float() * qs[:, None]
        qkv_b = block.attn.qkv.bias.detach().float() * qs
        p = SwinBlockParams(
            H=H, W=W, nh=nh, window=w, shift=shift,
            ln1_w=f(block.norm1.weight), ln1_b=f(block.norm1.bias),
            qkv_w=cd(qkv_w), qkv_b=qkv_b.contiguous(),
            proj_w=cd(block.attn.proj.weight), proj_b=f(block.attn.proj.bias),
            ln2_w=f(block.norm2.weight), ln2_b=f(block.norm2.bias),
            fc1_w=cd(block.mlp.fc1.weight), fc1_b=f(block.mlp.fc1.bias),
            fc2_w=cd(block.mlp.fc2.weight), fc2_b=f(block.mlp.fc2.bias),
            bias=block.attn.rel_bias().contiguous(),
            mask=block.attn_mask)
        if merge is not None:
            p.merge_ln_w, p.merge_ln_b = f(merge.norm.weight), f(merge.norm.bias)
            p.merge_w = cd(merge.reduction.weight)
    return p


def _ln(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, eps: float = LN_EPS) -> torch.Tensor:
    """float32 LayerNorm over the last axis (two-pass moments)."""
    xf = x.float()
    m = xf.mean(-1, keepdim=True)
    v = ((xf - m) ** 2).mean(-1, keepdim=True)
    return (xf - m) * torch.rsqrt(v + eps) * w + b


def _mm(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Compute-dtype operands, float32 accumulation (bf16 values are exact
    in float32, so a float32 product of the rounded operands is the same
    arithmetic)."""
    return torch.matmul(a.float(), w.float())


def _check_masks(dp_masks: Optional[torch.Tensor], p: SwinBlockParams, B: int) -> None:
    if dp_masks is None:
        return
    if p.merge:
        raise ValueError("drop-path masks do not combine with the merge fold "
                         "(training calls the block without merge_params)")
    if tuple(dp_masks.shape) != (B, 2) or dp_masks.dtype != torch.float32:
        raise ValueError(f"dp_masks: expected float32 ({B}, 2), got "
                         f"{dp_masks.dtype} {tuple(dp_masks.shape)}")


def _masked(branch: torch.Tensor, dp_masks: Optional[torch.Tensor], col: int) -> torch.Tensor:
    """``cd(m[:, col]) * branch`` per image, rounded to the compute dtype."""
    if dp_masks is None:
        return branch
    m = dp_masks[:, col].to(branch.dtype).reshape(-1, *([1] * (branch.ndim - 1)))
    return m * branch


def attention_rows(x0: torch.Tensor, p: SwinBlockParams):
    """The attention half of the plain block, at K2's rounding points: LN1
    -> shift -> window partition -> qkv -> attention -> proj -> window
    reverse + unshift, on x0 (B, H*W, C) in the compute dtype. Returns the
    window-order LN1 rows (B*L, C), q, k, v (B*nW, nh, N, hd; q carries the
    scale), P (B*nW, nh, N, N), the window-order attention output (B*L, C)
    and the token-order proj output a (B*L, C), each in the compute dtype."""
    cd = p.qkv_w.dtype
    B, L, C = x0.shape
    H, W, w, s, nh = p.H, p.W, p.window, p.shift, p.nh
    N, hd = w * w, C // nh
    img = _ln(x0, p.ln1_w, p.ln1_b).to(cd).reshape(B, H, W, C)
    if s:
        img = torch.roll(img, shifts=(-s, -s), dims=(1, 2))
    win = window_partition(img, w).reshape(-1, C)
    qkv = (_mm(win, p.qkv_w) + p.qkv_b).to(cd)
    q, k, v = (qkv[:, i * C:(i + 1) * C].reshape(-1, N, nh, hd).transpose(1, 2)
               for i in range(3))
    sc = torch.matmul(q.float(), k.float().transpose(-1, -2)) + p.bias[None]
    if p.mask is not None:
        nW = p.mask.shape[0]
        sc = (sc.reshape(B, nW, nh, N, N) + p.mask[None, :, None]).reshape(-1, nh, N, N)
    pr = torch.softmax(sc, dim=-1).to(cd)
    attn = torch.matmul(pr.float(), v.float()).to(cd).transpose(1, 2).reshape(-1, C)
    a = (_mm(attn, p.proj_w) + p.proj_b).to(cd)
    img2 = window_reverse(a.reshape(-1, N, C), w, H, W)
    if s:
        img2 = torch.roll(img2, shifts=(s, s), dims=(1, 2))
    return win, q, k, v, pr, attn, img2.reshape(-1, C)


def swin_block_plain(x: torch.Tensor, p: SwinBlockParams,
                     dp_masks: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain PyTorch version of kernel K2, on any device: x (B, H*W, C) in the
    compute dtype (the dtype of ``p.qkv_w``) -> (B, H*W, C), or
    (B, H*W/4, 2C) with the merge fold; ``dp_masks`` (B, 2) float32 scale
    the attention and MLP branches per image."""
    cd = p.qkv_w.dtype
    B, L, C = x.shape
    _check_masks(dp_masks, p, B)
    H, W = p.H, p.W
    x0 = x.to(cd)
    a = attention_rows(x0, p)[-1]
    y = x0 + _masked(a.reshape(B, L, C), dp_masks, 0)
    h = _ln(y, p.ln2_w, p.ln2_b).to(cd)
    h = F.gelu(_mm(h, p.fc1_w) + p.fc1_b, approximate="none").to(cd)
    out = y + _masked((_mm(h, p.fc2_w) + p.fc2_b).to(cd), dp_masks, 1)
    if not p.merge:
        return out
    v4 = out.reshape(B, H, W, C)
    v4 = torch.cat([v4[:, 0::2, 0::2], v4[:, 1::2, 0::2],
                    v4[:, 0::2, 1::2], v4[:, 1::2, 1::2]], dim=-1)
    v4 = _ln(v4.reshape(B, L // 4, 4 * C), p.merge_ln_w, p.merge_ln_b).to(cd)
    return _mm(v4, p.merge_w).to(cd)


def swin_block_fused(x: torch.Tensor, p: SwinBlockParams,
                     dp_masks: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One Swin block (+ PatchMerging when ``p.merge``, or drop-path masks
    (B, 2) float32 in training). A CPU tensor takes ``swin_block_plain``; a
    CUDA tensor launches kernel K2 (bfloat16) or raises."""
    if x.device.type == "cpu":
        return swin_block_plain(x, p, dp_masks)
    B, L, C = x.shape
    _check_masks(dp_masks, p, B)
    H, W, w, nh = p.H, p.W, p.window, p.nh
    N, hd, hidden = w * w, C // nh, p.fc1_w.shape[1]
    check_cuda_tensor("x", x, torch.bfloat16, (B, H * W, C))
    if N != 64 or hd != 24 or C % 32 or H % w or W % w:
        raise NotImplementedError(
            f"the Swin block kernel takes 8x8 windows, head dim 24, C % 32 "
            f"== 0 and whole windows (got window={w}, hd={hd}, C={C}, {H}x{W})")
    if p.merge and (H % 2 or W % 2):
        raise ValueError(f"PatchMerging needs an even map, got {H}x{W}")
    mats = {"qkv_w": (C, 3 * C), "proj_w": (C, C), "fc1_w": (C, hidden),
            "fc2_w": (hidden, C)}
    if p.merge:
        mats["merge_w"] = (4 * C, 2 * C)
    for name, shape in mats.items():
        check_cuda_tensor(name, getattr(p, name), torch.bfloat16, shape)
    vecs = {"ln1_w": C, "ln1_b": C, "qkv_b": 3 * C, "proj_b": C, "ln2_w": C,
            "ln2_b": C, "fc1_b": hidden, "fc2_b": C}
    if p.merge:
        vecs.update(merge_ln_w=4 * C, merge_ln_b=4 * C)
    for name, n in vecs.items():
        check_cuda_tensor(name, getattr(p, name), torch.float32, (n,))
    check_cuda_tensor("bias", p.bias, torch.float32, (nh, N, N))
    nW = (H // w) * (W // w)
    if p.mask is not None:
        check_cuda_tensor("mask", p.mask, torch.float32, (nW, N, N))
    if dp_masks is not None:
        check_cuda_tensor("dp_masks", dp_masks, torch.float32, (B, 2))

    M = B * L
    dev = x.device
    stats = torch.empty((2, M), device=dev, dtype=torch.float32)
    qkv = torch.empty((M, 3 * C), device=dev, dtype=torch.bfloat16)
    attn = torch.empty((M, C), device=dev, dtype=torch.bfloat16)
    y = torch.empty((M, C), device=dev, dtype=torch.bfloat16)
    hid = torch.empty((M, hidden), device=dev, dtype=torch.bfloat16)
    z = torch.empty((M, C), device=dev, dtype=torch.bfloat16)
    if p.merge:
        out = torch.empty((B, L // 4, 2 * C), device=dev, dtype=torch.bfloat16)
    else:
        out = z.view(B, L, C)
    opt = lambda t: t.data_ptr() if t is not None else None  # noqa: E731
    KERNEL.launches += 1
    KERNEL.call("swin_block_forward",
                x.data_ptr(), p.ln1_w.data_ptr(), p.ln1_b.data_ptr(),
                p.qkv_w.data_ptr(), p.qkv_b.data_ptr(), p.proj_w.data_ptr(),
                p.proj_b.data_ptr(), p.ln2_w.data_ptr(), p.ln2_b.data_ptr(),
                p.fc1_w.data_ptr(), p.fc1_b.data_ptr(), p.fc2_w.data_ptr(),
                p.fc2_b.data_ptr(), p.bias.data_ptr(), opt(p.mask), opt(dp_masks),
                opt(p.merge_ln_w), opt(p.merge_ln_b), opt(p.merge_w),
                stats.data_ptr(), qkv.data_ptr(), attn.data_ptr(), y.data_ptr(),
                hid.data_ptr(), z.data_ptr(), out.data_ptr() if p.merge else None,
                B, H, W, C, nh, w, p.shift, hidden)
    return out
