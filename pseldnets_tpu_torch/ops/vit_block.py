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
``csrc/vit_block.cu`` (bf16, head dim 64); on a CPU tensor it runs
``vit_block_plain``.
"""

from dataclasses import dataclass

import torch
import torch.nn.functional as F

from ..models.passt import Block
from ._cuda import CudaKernel, check_cuda_tensor, f32, i32, ptr
from .swin_block import _ln, _mm

KERNEL = CudaKernel("vit_block.cu", {
    "vit_block_forward": [ptr] * 19 + [i32] * 5 + [f32, ptr],
})

HEAD_DIM = 64      # the kernel's head dim
MAX_TOKENS = 3392  # csrc/vit_block.cu MAX_TOKENS: the scores of 16 query rows


@dataclass
class VitBlockParams:
    """One block's weights in the layout the kernel reads: (in, out)
    matrices in the compute dtype, biases and norms in float32."""

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
        return self.fc1_w.shape[1]


def prepare_vit_block(block: Block, compute_dtype: torch.dtype) -> VitBlockParams:
    """Lay out one block's weights for ``vit_block_fused`` (the host-side
    prep of the JAX package's vit_block_fused: matrices cast to the compute
    dtype, vectors float32)."""
    with torch.no_grad():
        f = lambda t: t.detach().float().contiguous()  # noqa: E731
        cd = lambda t: t.detach().float().t().contiguous().to(compute_dtype)  # noqa: E731
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
    qkv = (_mm(h, p.qkv_w) + p.qkv_b).to(cd)
    q, k, v = (qkv[..., i * C:(i + 1) * C].reshape(B, N, nh, hd).transpose(1, 2)
               for i in range(3))
    q = q * torch.tensor(hd ** -0.5, dtype=cd, device=x.device)
    pr = torch.softmax(torch.matmul(q.float(), k.float().transpose(-1, -2)), dim=-1).to(cd)
    o = torch.matmul(pr.float(), v.float()).to(cd).transpose(1, 2).reshape(B, N, C)
    y = x0 + (_mm(o, p.proj_w) + p.proj_b).to(cd)
    h = _ln(y, p.ln2_w, p.ln2_b, p.eps).to(cd)
    h = F.gelu(_mm(h, p.fc1_w) + p.fc1_b, approximate="none").to(cd)
    return y + (_mm(h, p.fc2_w) + p.fc2_b).to(cd)


def vit_block_fused(x: torch.Tensor, p: VitBlockParams) -> torch.Tensor:
    """One ViT block. A CPU tensor takes ``vit_block_plain``; a CUDA tensor
    launches kernel K6 (bfloat16, head dim 64, C % 32 == 0, hidden % 32 ==
    0, 1 <= N <= MAX_TOKENS) or raises."""
    if x.device.type == "cpu":
        return vit_block_plain(x, p)
    B, N, C = x.shape
    hidden = p.hidden
    if C != p.nh * HEAD_DIM or C % 32 or hidden % 32 or not 1 <= N <= MAX_TOKENS:
        raise NotImplementedError(
            f"the ViT block kernel takes head dim {HEAD_DIM}, C % 32 == 0, hidden % 32 "
            f"== 0 and 1 <= N <= {MAX_TOKENS} (got C={C}, heads={p.nh}, "
            f"hidden={hidden}, N={N})")
    check_cuda_tensor("x", x, torch.bfloat16, (B, N, C))
    mats = {"qkv_w": (C, 3 * C), "proj_w": (C, C), "fc1_w": (C, hidden),
            "fc2_w": (hidden, C)}
    for name, shape in mats.items():
        check_cuda_tensor(name, getattr(p, name), torch.bfloat16, shape)
    vecs = {"ln1_w": C, "ln1_b": C, "qkv_b": 3 * C, "proj_b": C, "ln2_w": C,
            "ln2_b": C, "fc1_b": hidden, "fc2_b": C}
    for name, n in vecs.items():
        check_cuda_tensor(name, getattr(p, name), torch.float32, (n,))

    M = B * N
    dev = x.device
    stats = torch.empty((2, M), device=dev, dtype=torch.float32)
    qkv = torch.empty((M, 3 * C), device=dev, dtype=torch.bfloat16)
    attn = torch.empty((M, C), device=dev, dtype=torch.bfloat16)
    y = torch.empty((M, C), device=dev, dtype=torch.bfloat16)
    hid = torch.empty((M, hidden), device=dev, dtype=torch.bfloat16)
    out = torch.empty((B, N, C), device=dev, dtype=torch.bfloat16)
    KERNEL.launches += 1
    KERNEL.call("vit_block_forward",
                x.data_ptr(), p.ln1_w.data_ptr(), p.ln1_b.data_ptr(),
                p.qkv_w.data_ptr(), p.qkv_b.data_ptr(), p.proj_w.data_ptr(),
                p.proj_b.data_ptr(), p.ln2_w.data_ptr(), p.ln2_b.data_ptr(),
                p.fc1_w.data_ptr(), p.fc1_b.data_ptr(), p.fc2_w.data_ptr(),
                p.fc2_b.data_ptr(), stats.data_ptr(), qkv.data_ptr(), attn.data_ptr(),
                y.data_ptr(), hid.data_ptr(), out.data_ptr(),
                B, N, C, p.nh, hidden, p.eps)
    return out
