"""Fused pre-LN ViT block (PaSST's): kernel K6 and its plain version. The
counterpart of the JAX package's ``ops/pallas/vit_block.py::vit_block_fused``
with the exact softmax (``attn_impl="exact"``).

    LN1 -> qkv -> per head softmax((q * D^-0.5) K^T) V -> proj -> residual
    -> LN2 -> fc1 -> exact GELU -> fc2 -> residual

Numerics follow the Pallas kernel (vit_block.py:47-115): matmul operands in
the compute dtype with float32 accumulation, LayerNorm (eps 1e-6) and the
max-subtracted softmax in float32, and every activation (qkv, q * scale,
probabilities, heads, proj, residual sums, GELU output) rounded to the
compute dtype where the kernel rounds it. GELU is the exact erf form in both
dtypes (the Pallas kernel's bf16 path uses a polynomial within 5.2e-5 of it,
below bf16 rounding). The TPU-only knobs (``exp2``, ``sum_pv``, ``nomax``,
``group``, ``mlp_min_rows``) re-associate the same softmax for TPU layouts
and are not ported.

On a CUDA tensor ``vit_block_fused`` launches the hand-written kernels of
``csrc/vit_block.cu`` (bf16, head dim 64: LayerNorm row passes, the Hopper
GEMM core of ``csrc/sm90_gemm.cuh`` and a wgmma attention); on a CPU tensor
it runs ``vit_block_plain``. ``gemm`` exposes the GEMM core alone, and
``vit_block_phases`` times the block's seven launches.
"""

import ctypes
from dataclasses import dataclass
from typing import Dict, Optional

import torch
import torch.nn.functional as F

from ..models.passt import Block
from ._cuda import CudaKernel, check_cuda_tensor, f32, i32, ptr
from .swin_block import _ln, _mm

BLOCK_ARGS = [ptr] * 19 + [i32] * 5 + [f32]
KERNEL = CudaKernel("vit_block.cu", {
    "vit_block_forward": BLOCK_ARGS + [ptr],
    "vit_block_phases": BLOCK_ARGS + [ptr, i32, ptr],
    "vit_gemm": [ptr] * 5 + [i32] * 5 + [ptr],
})

HEAD_DIM = 64        # the kernel's head dim
MAX_IMAGES = 65535   # the attention grid's z dimension
# the GEMM core's output tiles: 128 x BN shared by its two consumer
# warpgroups (BN 128, 192, 256), or 128 x 128 each, ping-pong (-128)
GEMM_TILES = (128, 192, 256, -128)
EPILOGUES = {"bias": 0, "resid": 1, "gelu": 2}
PHASES = ("ln1", "qkv", "attention", "proj", "ln2", "fc1", "fc2")


@dataclass
class VitBlockParams:
    """One block's weights in the layout the kernel reads: nn.Linear's (out,
    in) matrices (K-major, wgmma's B operand as it stands) in the compute
    dtype, biases and norms in float32."""

    nh: int
    eps: float
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

    @property
    def C(self) -> int:
        return self.ln1_w.shape[0]

    @property
    def hidden(self) -> int:
        return self.fc1_w.shape[0]


def prepare_vit_block(block: Block, compute_dtype: torch.dtype) -> VitBlockParams:
    """Lay out one block's weights for ``vit_block_fused`` (the host-side
    prep of the JAX package's vit_block_fused: matrices cast to the compute
    dtype in nn.Linear's (out, in) layout, vectors float32)."""
    with torch.no_grad():
        f = lambda t: t.detach().float().contiguous()  # noqa: E731
        cd = lambda t: t.detach().to(compute_dtype, copy=True).contiguous()  # noqa: E731
        return VitBlockParams(
            nh=block.num_heads, eps=block.norm1.eps,
            ln1_w=f(block.norm1.weight), ln1_b=f(block.norm1.bias),
            qkv_w=cd(block.attn.qkv.weight), qkv_b=f(block.attn.qkv.bias),
            proj_w=cd(block.attn.proj.weight), proj_b=f(block.attn.proj.bias),
            ln2_w=f(block.norm2.weight), ln2_b=f(block.norm2.bias),
            fc1_w=cd(block.mlp.fc1.weight), fc1_b=f(block.mlp.fc1.bias),
            fc2_w=cd(block.mlp.fc2.weight), fc2_b=f(block.mlp.fc2.bias))


def vit_block_plain(x: torch.Tensor, p: VitBlockParams) -> torch.Tensor:
    """Plain PyTorch version of kernel K6, on any device, any N and head
    dim: x (B, N, C) -> (B, N, C) in the compute dtype (that of
    ``p.qkv_w``)."""
    cd = p.qkv_w.dtype
    B, N, C = x.shape
    nh = p.nh
    hd = C // nh
    x0 = x.to(cd)
    h = _ln(x0, p.ln1_w, p.ln1_b, p.eps).to(cd)
    qkv = (_mm(h, p.qkv_w.t()) + p.qkv_b).to(cd)
    q, k, v = (qkv[..., i * C:(i + 1) * C].reshape(B, N, nh, hd).transpose(1, 2)
               for i in range(3))
    q = q * torch.tensor(hd ** -0.5, dtype=cd, device=x.device)
    pr = torch.softmax(torch.matmul(q.float(), k.float().transpose(-1, -2)), dim=-1).to(cd)
    o = torch.matmul(pr.float(), v.float()).to(cd).transpose(1, 2).reshape(B, N, C)
    y = x0 + (_mm(o, p.proj_w.t()) + p.proj_b).to(cd)
    h = _ln(y, p.ln2_w, p.ln2_b, p.eps).to(cd)
    h = F.gelu(_mm(h, p.fc1_w.t()) + p.fc1_b, approximate="none").to(cd)
    return y + (_mm(h, p.fc2_w.t()) + p.fc2_b).to(cd)


def _check_block(x: torch.Tensor, p: VitBlockParams) -> None:
    """Raise unless the kernel takes x and p: the design's limits (head dim
    64, 16-byte rows for TMA, B <= MAX_IMAGES), contiguous CUDA tensors of
    the right dtype and shape at 16-byte aligned addresses."""
    B, N, C = x.shape
    hidden = p.hidden
    if (C != p.nh * HEAD_DIM or hidden % 8 or not 1 <= B <= MAX_IMAGES or N < 1
            or B * N >= 2 ** 31):
        raise NotImplementedError(
            f"the ViT block kernel takes head dim {HEAD_DIM}, hidden % 8 == 0, "
            f"1 <= B <= {MAX_IMAGES}, N >= 1 and B*N < 2^31 (got C={C}, heads={p.nh}, "
            f"hidden={hidden}, B={B}, N={N})")
    check_cuda_tensor("x", x, torch.bfloat16, (B, N, C))
    mats = {"qkv_w": (3 * C, C), "proj_w": (C, C), "fc1_w": (hidden, C),
            "fc2_w": (C, hidden)}
    for name, shape in mats.items():
        check_cuda_tensor(name, getattr(p, name), torch.bfloat16, shape)
    vecs = {"ln1_w": C, "ln1_b": C, "qkv_b": 3 * C, "proj_b": C, "ln2_w": C,
            "ln2_b": C, "fc1_b": hidden, "fc2_b": C}
    for name, n in vecs.items():
        check_cuda_tensor(name, getattr(p, name), torch.float32, (n,))
    for name in ("x", *mats, *vecs):  # TMA boxes, and vector loads of the norms
        t = x if name == "x" else getattr(p, name)
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: the kernel needs a 16-byte aligned address")


def _block_args(x: torch.Tensor, p: VitBlockParams):
    """The C entries' arguments up to eps, with fresh scratch and output."""
    B, N, C = x.shape
    M, dev = B * N, x.device
    scratch = [torch.empty((M, n), device=dev, dtype=torch.bfloat16)
               for n in (C, 3 * C, C, C, p.hidden)]  # h, qkv, attn, y, hid
    out = torch.empty((B, N, C), device=dev, dtype=torch.bfloat16)
    args = [x.data_ptr(), *(getattr(p, n).data_ptr() for n in (
        "ln1_w", "ln1_b", "qkv_w", "qkv_b", "proj_w", "proj_b", "ln2_w", "ln2_b",
        "fc1_w", "fc1_b", "fc2_w", "fc2_b")), *(t.data_ptr() for t in scratch),
        out.data_ptr(), B, N, C, p.nh, p.hidden, p.eps]
    return args, scratch, out


def vit_block_fused(x: torch.Tensor, p: VitBlockParams) -> torch.Tensor:
    """One ViT block. A CPU tensor takes ``vit_block_plain``; a CUDA tensor
    launches kernel K6 (bfloat16, head dim 64, hidden % 8 == 0, 1 <= B <=
    MAX_IMAGES) or raises."""
    if x.device.type == "cpu":
        return vit_block_plain(x, p)
    _check_block(x, p)
    args, _scratch, out = _block_args(x, p)
    KERNEL.launches += 1
    KERNEL.call("vit_block_forward", *args)
    return out


def vit_block_phases(x: torch.Tensor, p: VitBlockParams, reps: int = 5) -> Dict[str, float]:
    """K6 on a CUDA tensor ``reps`` times with CUDA events around each of
    its seven launches: mean device ms by phase (``PHASES``)."""
    _check_block(x, p)
    args, _scratch, _out = _block_args(x, p)
    ms = (ctypes.c_float * len(PHASES))()
    KERNEL.launches += reps
    KERNEL.call("vit_block_phases", *args, ctypes.addressof(ms), reps)
    return dict(zip(PHASES, ms))


def gemm_plain(a: torch.Tensor, w: torch.Tensor, bias: torch.Tensor,
               resid: Optional[torch.Tensor] = None, epilogue: str = "bias") -> torch.Tensor:
    """Plain version of the GEMM core: (M, K) . (N, K)^T in float32 + bias,
    then rounded ("bias"), rounded + resid and rounded ("resid"), or exact
    GELU and rounded ("gelu"), in a's dtype."""
    f = _mm(a, w.t()) + bias
    if epilogue == "gelu":
        f = F.gelu(f, approximate="none")
    f = f.to(a.dtype)
    return resid + f if epilogue == "resid" else f


def gemm(a: torch.Tensor, w: torch.Tensor, bias: torch.Tensor,
         resid: Optional[torch.Tensor] = None, epilogue: str = "bias",
         bn: int = 192) -> torch.Tensor:
    """K6's GEMM core alone on a 128 x ``bn`` tile (``GEMM_TILES``): a CPU tensor takes
    ``gemm_plain``; CUDA bf16 (M, K) and (N, K) with K % 8 == 0 and N % 8 ==
    0 launch the kernel or raise."""
    if a.device.type == "cpu":
        return gemm_plain(a, w, bias, resid, epilogue)
    M, K = a.shape
    N = w.shape[0]
    if bn not in GEMM_TILES or epilogue not in EPILOGUES or K % 8 or N % 8:
        raise NotImplementedError(f"the GEMM core takes bn in {GEMM_TILES}, an epilogue in "
                                  f"{tuple(EPILOGUES)}, K % 8 == 0 and N % 8 == 0 "
                                  f"(got bn={bn}, {epilogue!r}, K={K}, N={N})")
    check_cuda_tensor("a", a, torch.bfloat16, (M, K))
    check_cuda_tensor("w", w, torch.bfloat16, (N, K))
    check_cuda_tensor("bias", bias, torch.float32, (N,))
    if (resid is None) != (epilogue != "resid"):
        raise ValueError("resid is given with, and only with, the 'resid' epilogue")
    if resid is not None:
        check_cuda_tensor("resid", resid, torch.bfloat16, (M, N))
    out = torch.empty((M, N), device=a.device, dtype=torch.bfloat16)
    KERNEL.launches += 1
    KERNEL.call("vit_gemm", a.data_ptr(), w.data_ptr(), bias.data_ptr(),
                0 if resid is None else resid.data_ptr(), out.data_ptr(), M, N, K,
                EPILOGUES[epilogue], bn)
    return out
