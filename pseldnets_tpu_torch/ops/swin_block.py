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
``csrc/swin_block.cu`` (bf16 only; TMA-fed wgmma on the Hopper forward layer
``csrc/swin_fwd_sm90.cuh``, with the tile choices of ``TILES``) or raises;
on a CPU tensor it runs ``swin_block_plain``. ``swin_block_phases_plain``
chains the plain versions of the kernel's phases (``ln_rows_plain``,
``fwd_gemm_plain``, ``attention_plain``) through the row maps of
``swin_fwd_plan`` as the C entry chains its launches.
"""

from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..models.htsat import (PatchMerging, SwinTransformerBlock, window_partition,
                            window_reverse)
from . import swin_fwd_plan as plan
from ._cuda import CudaKernel, check_cuda_tensor, i32, ptr

KERNEL = CudaKernel("swin_block.cu", {
    "swin_block_forward": [ptr] * 26 + [i32] * 14 + [ptr],
    "swin_fwd_gemm": [i32] * 3 + [ptr] * 3 + [i32] + [ptr] * 3 + [i32] * 9 + [ptr],
})

LN_EPS = 1e-5

# The GEMMs' tile widths (128-row tiles of 64, 128 or 192 columns) at each
# stage width C, and the ring depth (stages; 0: as deep as shared memory
# allows, at most 6); scripts/torch_k2_tiles.py sweeps them (each GEMM's
# fastest width at B=32 over two rounds). K11 takes the same widths at the same
# C, so a stage gives K2's bits, and takes only 64 and 128: the merge, K2's
# alone, may take 192.
TILES = {
    96: {"qkv": 64, "proj": 128, "fc1": 128, "fc2": 64, "merge": 128, "stages": 0},
    192: {"qkv": 64, "proj": 64, "fc1": 128, "fc2": 64, "merge": 64, "stages": 0},
    384: {"qkv": 64, "proj": 128, "fc1": 128, "fc2": 64, "merge": 192, "stages": 0},
    768: {"qkv": 128, "proj": 64, "fc1": 128, "fc2": 128, "merge": 128, "stages": 0},
}
DEFAULT_TILES = {"qkv": 128, "proj": 128, "fc1": 128, "fc2": 128, "merge": 128, "stages": 0}


def tiles_for(C: int) -> Dict[str, int]:
    """The tile choices at stage width C (``TILES``, else ``DEFAULT_TILES``)."""
    return dict(TILES.get(C, DEFAULT_TILES))


def tile_args(C: int) -> Tuple[int, ...]:
    """``tiles_for(C)`` as the C entries take them (``plan.TILE_KEYS``)."""
    t = tiles_for(C)
    plan.check_tiles(t)
    return tuple(int(t[k]) for k in plan.TILE_KEYS)


def check_aligned(tensors: Dict[str, Optional[torch.Tensor]]) -> None:
    """Raise unless every tensor starts on a 16-byte boundary (the kernels'
    vector loads and TMA descriptors need it)."""
    for name, t in tensors.items():
        if t is not None and t.data_ptr() % 16:
            raise ValueError(f"{name}: the Swin block kernels need 16-byte aligned tensors")


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


def ln_rows_plain(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                  rows: Optional[np.ndarray] = None,
                  dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Plain version of the forward layer's LN rows phase: x (tokens, C) in
    the compute dtype (or float32: K4's y); rows None (token order), (R,)
    (the token each row reads) or (R, 4) (the merge's 4C gather) -> (R, K)
    cd((x - mean) rstd w + b), cd ``dtype`` or x's."""
    cd = dtype or x.dtype
    if rows is None:
        return _ln(x, w, b).to(cd)
    idx = torch.as_tensor(rows, device=x.device)
    if idx.ndim == 1:
        return _ln(x, w, b).to(cd)[idx]
    return _ln(x[idx].reshape(idx.shape[0], -1), w, b).to(cd)


def fwd_gemm_plain(a: torch.Tensor, w: torch.Tensor, bias: Optional[torch.Tensor] = None,
                   gelu: bool = False, resid: Optional[torch.Tensor] = None,
                   scale: Optional[torch.Tensor] = None, L: int = 0,
                   rows_out: Optional[np.ndarray] = None) -> torch.Tensor:
    """Plain version of K2's GEMM forms: a (M, K) . w (K, N) with float32
    sums in the compute dtype; without ``resid`` (F_OUT) out[row r's place]
    = bf16(acc + bias) or bf16(gelu(acc + bias)); with it (F_RES) out[row
    r's place] = bf16(resid + bf16(bf16(scale[r // L]) bf16(acc + bias))),
    the place ``rows_out[r]`` (the window -> token map) or r, scale
    (images, ) float32 or None."""
    cd = a.dtype
    v = _mm(a, w)
    if bias is not None:
        v = v + bias
    dst = slice(None) if rows_out is None else torch.as_tensor(rows_out, device=a.device)
    if resid is None:
        v = (F.gelu(v, approximate="none") if gelu else v).to(cd)
        if rows_out is None:
            return v
        out = torch.empty_like(v)
        out[dst] = v
        return out
    v = v.to(cd)
    if scale is not None:
        img = torch.arange(a.shape[0], device=a.device) // L
        v = scale.to(cd)[img][:, None] * v
    out = torch.empty_like(resid)
    out[dst] = resid[dst] + v
    return out


def attention_plain(qkv: torch.Tensor, p: SwinBlockParams, B: int) -> torch.Tensor:
    """Plain version of the forward layer's window attention phase: qkv
    (B*L, 3C) in window order, the compute dtype -> the heads (B*L, C),
    window order: scores + bias (+ shift mask), float32 softmax, P and the
    heads rounded, as ``attention_rows`` computes them."""
    cd = qkv.dtype
    C = qkv.shape[1] // 3
    N, nh = p.window ** 2, p.nh
    q, k, v = (qkv[:, i * C:(i + 1) * C].reshape(-1, N, nh, C // nh).transpose(1, 2)
               for i in range(3))
    sc = torch.matmul(q.float(), k.float().transpose(-1, -2)) + p.bias[None]
    if p.mask is not None:
        nW = p.mask.shape[0]
        sc = (sc.reshape(B, nW, nh, N, N) + p.mask[None, :, None]).reshape(-1, nh, N, N)
    pr = torch.softmax(sc, dim=-1).to(cd)
    return torch.matmul(pr.float(), v.float()).to(cd).transpose(1, 2).reshape(-1, C)


def swin_block_phases_plain(x: torch.Tensor, p: SwinBlockParams,
                            dp_masks: Optional[torch.Tensor] = None) -> torch.Tensor:
    """K2's phases in plain PyTorch, chained as ``swin_block_forward``
    chains its launches, through ``swin_fwd_plan``'s row maps: LN1 rows in
    window order, qkv, the window attention, proj with the residual through
    the window -> token map, LN2 rows, fc1 + GELU, fc2 with the residual,
    then the merge's LN rows over the 4C gather and its GEMM. Gives
    ``swin_block_plain``'s bits (the CPU tests hold it there)."""
    cd = p.qkv_w.dtype
    B, L, C = x.shape
    _check_masks(dp_masks, p, B)
    H, W, w, s = p.H, p.W, p.window, p.shift
    x0 = x.to(cd).reshape(B * L, C)
    win_rows = plan.window_rows(B, H, W, w, s)
    h1 = ln_rows_plain(x0, p.ln1_w, p.ln1_b, win_rows)
    qkv = fwd_gemm_plain(h1, p.qkv_w, p.qkv_b)
    attn = attention_plain(qkv, p, B)
    m = dp_masks
    y = fwd_gemm_plain(attn, p.proj_w, p.proj_b, resid=x0,
                       scale=None if m is None else m[:, 0], L=L, rows_out=win_rows)
    h2 = ln_rows_plain(y, p.ln2_w, p.ln2_b)
    hid = fwd_gemm_plain(h2, p.fc1_w, p.fc1_b, gelu=True)
    z = fwd_gemm_plain(hid, p.fc2_w, p.fc2_b, resid=y,
                       scale=None if m is None else m[:, 1], L=L)
    if not p.merge:
        return z.reshape(B, L, C)
    hm = ln_rows_plain(z, p.merge_ln_w, p.merge_ln_b, plan.merge_rows(B, H, W))
    return fwd_gemm_plain(hm, p.merge_w).reshape(B, L // 4, 2 * C)


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
    N, hidden = w * w, p.fc1_w.shape[1]
    check_cuda_tensor("x", x, torch.bfloat16, (B, H * W, C))
    plan.check_block(H, W, C, nh, w, hidden, p.merge, dp_masks is not None)
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
    check_aligned({"x": x, "dp_masks": dp_masks, "mask": p.mask,
                   **{k: getattr(p, k) for k in (*mats, *vecs, "bias")}})
    tiles = tile_args(C)

    M = B * L
    dev = x.device
    h = torch.empty((M, C), device=dev, dtype=torch.bfloat16)
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
                h.data_ptr(), qkv.data_ptr(), attn.data_ptr(), y.data_ptr(),
                hid.data_ptr(), z.data_ptr(), out.data_ptr() if p.merge else None,
                B, H, W, C, nh, w, p.shift, hidden, *tiles)
    return out


def fwd_gemm(a: torch.Tensor, w: torch.Tensor, bias: Optional[torch.Tensor] = None,
             gelu: bool = False, resid: Optional[torch.Tensor] = None,
             scale: Optional[torch.Tensor] = None, L: int = 0,
             geometry: Optional[Tuple[int, int, int, int]] = None, bn: int = 128,
             stages: int = 0) -> torch.Tensor:
    """One of K2's GEMM forms alone on the card (the C entry
    ``swin_fwd_gemm``), as ``fwd_gemm_plain`` computes it: a (M, K) and w
    (K, N) bf16; bias (N,) float32; with ``resid`` (M, N) bf16 the residual
    form, ``scale`` (images, 2) float32 (column 0 read, the image of row r
    being r // L), and the output rows through the window -> token map of
    ``geometry`` (H, W, window, shift) when given."""
    M, K = a.shape
    N = w.shape[1]
    check_cuda_tensor("a", a, torch.bfloat16)
    check_cuda_tensor("w", w, torch.bfloat16, (K, N))
    for name, t, dt in (("bias", bias, torch.float32), ("resid", resid, torch.bfloat16),
                        ("scale", scale, torch.float32)):
        if t is not None:
            check_cuda_tensor(name, t, dt)
    check_aligned({"a": a, "w": w, "bias": bias, "resid": resid, "scale": scale})
    H, W, win, shift = geometry if geometry is not None else (0, 0, 0, 0)
    if geometry is not None:
        L = H * W
    out = torch.empty((M, N), device=a.device, dtype=torch.bfloat16)
    opt = lambda t: t.data_ptr() if t is not None else None  # noqa: E731
    KERNEL.call("swin_fwd_gemm", int(resid is not None), bn, stages, a.data_ptr(),
                w.data_ptr(), opt(bias), int(gelu), opt(resid), opt(scale), out.data_ptr(),
                M, N, K, L, H, W, win, shift, int(geometry is not None))
    return out
