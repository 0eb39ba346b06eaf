"""Whole-stage Swin: kernel K11 and its plain version. The counterpart of the
JAX package's ``ops/pallas/swin_block.py::swin_stage_fused`` (any 0/base
shift per block) and ``swin_stage_fused_v2`` (shifts 0, s, 0, s only): every
eval block of one Swin stage in one call, equal to ``swin_block_fused`` run
block after block without the merge fold. No drop-path, no adapters.

The weights are K2's (``prepare_block``: q-scale folded into qkv, (in, out)
matrices in the compute dtype, float32 vectors), stacked on a leading depth
axis; the relative-position bias is per block, (depth, nh, N, N), and one
shift mask (nW, N, N) of the base shift serves every shifted block, as the
JAX wrappers build them (swin_block.py:799-845).

On a CUDA tensor ``swin_stage_fused`` launches ``csrc/swin_stage.cu`` once
(bf16 only): one cooperative launch that runs every block on K2's Hopper
phases (``csrc/swin_fwd_sm90.cuh``) with K2's tile widths at the stage's
width (``swin_block.tiles_for``), so it gives K2's bits. On a CPU tensor it
runs ``swin_stage_plain``.
"""

from dataclasses import dataclass
from typing import Optional, Tuple

import torch

from ..models.adapters import check_kernels
from . import swin_fwd_plan as plan
from ._cuda import CudaKernel, check_cuda_tensor, i32, ptr
from .swin_block import (SwinBlockParams, check_aligned, prepare_block, swin_block_plain,
                         tiles_for)

KERNEL = CudaKernel("swin_stage.cu", {
    "swin_stage_forward": [ptr] * 22 + [i32] * 15 + [ptr],
})

# the per-block tensors of SwinBlockParams that StageParams stacks on depth
STACKED = ("ln1_w", "ln1_b", "qkv_w", "qkv_b", "proj_w", "proj_b", "ln2_w", "ln2_b",
           "fc1_w", "fc1_b", "fc2_w", "fc2_b", "bias")


@dataclass
class StageParams:
    """One stage's weights for ``swin_stage_fused``: each of ``STACKED`` with
    a leading depth axis (bias (depth, nh, N, N)), the per-block shifts (0 or
    ``base_shift``) and the base shift's mask (nW, N, N), or None when no
    block is shifted."""

    H: int
    W: int
    nh: int
    window: int
    shifts: Tuple[int, ...]
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

    @property
    def depth(self) -> int:
        return len(self.shifts)

    @property
    def base_shift(self) -> int:
        return max(self.shifts)

    @property
    def C(self) -> int:
        return self.ln1_w.shape[1]

    @property
    def hidden(self) -> int:
        return self.fc1_w.shape[2]

    def block(self, d: int) -> SwinBlockParams:
        """Block d's weights as ``swin_block_fused`` takes them (views)."""
        return SwinBlockParams(H=self.H, W=self.W, nh=self.nh, window=self.window,
                               shift=self.shifts[d],
                               mask=self.mask if self.shifts[d] else None,
                               **{name: getattr(self, name)[d] for name in STACKED})


def prepare_stage(layer, compute_dtype: torch.dtype) -> StageParams:
    """``prepare_block`` of every block of ``layer`` (anything with
    ``.blocks``: the port's ``BasicLayer``), stacked on depth; the stage's
    PatchMerging is not folded. Raises on blocks with adapters (the JAX
    stage kernels have none), on blocks of differing geometry and on shifts
    other than 0 and one base shift."""
    blocks = list(layer.blocks)
    for b in blocks:
        check_kernels(b, adapters=False)
    ps = [prepare_block(b, compute_dtype) for b in blocks]
    geo = {(p.H, p.W, p.nh, p.window, p.C, p.fc1_w.shape[1]) for p in ps}
    if len(geo) != 1:
        raise ValueError(f"a stage's blocks share one geometry, got {sorted(geo)}")
    shifts = tuple(p.shift for p in ps)
    if set(shifts) - {0, max(shifts)}:
        raise ValueError(f"shifts must be 0 or one base shift, got {shifts}")
    first = ps[0]
    masks = [p.mask for p in ps if p.shift]
    with torch.no_grad():
        stacked = {name: torch.stack([getattr(p, name) for p in ps]).contiguous()
                   for name in STACKED}
    return StageParams(H=first.H, W=first.W, nh=first.nh, window=first.window,
                       shifts=shifts, mask=masks[0] if masks else None, **stacked)


def swin_stage_plain(x: torch.Tensor, sp: StageParams) -> torch.Tensor:
    """Plain PyTorch version of kernel K11, on any device: ``swin_block_plain``
    of each block in turn, x (B, H*W, C) in the compute dtype -> (B, H*W, C)."""
    for d in range(sp.depth):
        x = swin_block_plain(x, sp.block(d))
    return x


def swin_stage_fused(x: torch.Tensor, sp: StageParams) -> torch.Tensor:
    """Every block of a Swin stage, any 0/base shift per block. A CPU tensor
    takes ``swin_stage_plain``; a CUDA tensor launches kernel K11
    (bfloat16) once, or raises."""
    if x.device.type == "cpu":
        return swin_stage_plain(x, sp)
    B, L, C = x.shape
    H, W, w, nh, depth, hidden = sp.H, sp.W, sp.window, sp.nh, sp.depth, sp.hidden
    N = w * w
    check_cuda_tensor("x", x, torch.bfloat16, (B, H * W, C))
    plan.check_stage(H, W, C, nh, w, hidden, sp.shifts)
    mats = {"qkv_w": (C, 3 * C), "proj_w": (C, C), "fc1_w": (C, hidden),
            "fc2_w": (hidden, C)}
    for name, shape in mats.items():
        check_cuda_tensor(name, getattr(sp, name), torch.bfloat16, (depth, *shape))
    vecs = {"ln1_w": C, "ln1_b": C, "qkv_b": 3 * C, "proj_b": C, "ln2_w": C,
            "ln2_b": C, "fc1_b": hidden, "fc2_b": C}
    for name, n in vecs.items():
        check_cuda_tensor(name, getattr(sp, name), torch.float32, (depth, n))
    check_cuda_tensor("bias", sp.bias, torch.float32, (depth, nh, N, N))
    shift_bits = sum(1 << d for d, s in enumerate(sp.shifts) if s)
    if shift_bits:
        if sp.mask is None:
            raise ValueError("shifted blocks need the shift mask")
        check_cuda_tensor("mask", sp.mask, torch.float32, ((H // w) * (W // w), N, N))
    check_aligned({"x": x, "mask": sp.mask, **{k: getattr(sp, k) for k in STACKED}})
    t = tiles_for(C)
    plan.check_stage_tiles(t)
    tiles = tuple(t[k] for k in ("qkv", "proj", "fc1", "fc2", "stages"))  # no merge in a stage

    M = B * L
    dev = x.device
    h = torch.empty((M, C), device=dev, dtype=torch.bfloat16)
    qkv = torch.empty((M, 3 * C), device=dev, dtype=torch.bfloat16)
    attn = torch.empty((M, C), device=dev, dtype=torch.bfloat16)
    y = torch.empty((M, C), device=dev, dtype=torch.bfloat16)
    hid = torch.empty((M, hidden), device=dev, dtype=torch.bfloat16)
    tmp = torch.empty((M, C), device=dev, dtype=torch.bfloat16)
    out = torch.empty((B, L, C), device=dev, dtype=torch.bfloat16)
    KERNEL.launches += 1
    KERNEL.call("swin_stage_forward",
                x.data_ptr(), *(getattr(sp, name).data_ptr() for name in STACKED),
                sp.mask.data_ptr() if shift_bits else None,
                h.data_ptr(), qkv.data_ptr(), attn.data_ptr(), y.data_ptr(),
                hid.data_ptr(), tmp.data_ptr(), out.data_ptr(),
                B, H, W, C, nh, w, sp.base_shift, shift_bits, depth, hidden, *tiles)
    return out


def swin_stage_fused_v2(x: torch.Tensor, sp: StageParams) -> torch.Tensor:
    """``swin_stage_fused`` for the alternating pattern 0, s, 0, s, ... only
    (the JAX package's grid-over-depth form); raises ``ValueError`` on any
    other, where the JAX package asserts (swin_block.py:979-980). The same
    kernel K11 serves both."""
    if any(s != (0 if j % 2 == 0 else sp.base_shift) for j, s in enumerate(sp.shifts)):
        raise ValueError(f"swin_stage_fused_v2 takes shifts 0, s, 0, s, ...; got "
                         f"{sp.shifts} (swin_stage_fused takes any 0/s pattern)")
    return swin_stage_fused(x, sp)

