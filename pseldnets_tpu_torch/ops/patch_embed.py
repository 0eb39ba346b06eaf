"""The HTSAT patch embed as one kernel: kernel K8 and its plain version. The
counterpart of the JAX package's ``ops/pallas/patch_embed.py::
patch_embed_tokens``, which its ``htsat_fused_forward(...,
patch_embed="kernel")`` calls; the port's served HTSAT paths call it by
default (serving/htsat.py).

(B, C, T, F) normalized features in the compute dtype -> (B, L, E) stage-0
tokens in the compute dtype: reshape_wav2img (frames zero-padded from T to
spec_size * freq_ratio), the 4 x 4 stride-4 VALID conv on compute-dtype
operands with float32 accumulation, the bias, the LayerNorm in float32
(eps 1e-5), and one rounding to the compute dtype, tokens row-major in (g,
fp, tp) as kernel K2 reads them. The JAX kernel rounds once, after the
LayerNorm; the einsum embed (serving/htsat.py ``embed_tokens``) rounds the
conv output before its LayerNorm, so the two differ by up to one rounding
in bf16.

On a CUDA tensor ``patch_embed_tokens`` launches ``csrc/patch_embed.cu``
(bf16: a persistent TMA-fed wgmma kernel, two blocks an SM walking the
128-token tiles; float32: CUDA-core FMA) at 64, 128 or 256 mel bins
(HTSAT's spec_size 256 at freq_ratio 4, 2 or 1); on a CPU tensor it runs
``patch_embed_tokens_plain``, which nothing on the card's served path calls.
``prepare_patch_embed`` lays the weights out once per encoder and dtype, in
the kernel's k order (c, kw, kh), which the plain version reads too.
"""

from dataclasses import dataclass

import torch
import torch.nn.functional as F

from ..models.adapters import check_kernels
from ._cuda import CudaKernel, check_cuda_tensor, i32, ptr

KERNEL = CudaKernel("patch_embed.cu", {
    "patch_embed_tokens": [ptr] * 6 + [i32] * 7 + [ptr],
})

LN_EPS = 1e-5
# the kernel's shapes: HTSAT's published embed width, mel bins and (bf16)
# channels; a tile is 128 tokens (F / 4 frequency patches of tile_patches(F)
# time patches: 8 of 32 frames at F = 64)
KERNEL_E, KERNEL_FS, KERNEL_C = 96, (64, 128, 256), 7
TILE_TOKENS = 128


def tile_patches(F: int) -> int:
    """Time patches in one of the kernel's tiles at F mel bins."""
    return TILE_TOKENS // (F // 4)


@dataclass
class PatchEmbedParams:
    """The patch embed's weights in the kernel's layout: ``w`` (C * 16, E)
    in the compute dtype with w[(c * 4 + kw) * 4 + kh, e] the conv kernel
    (kh along frequency, kw along time: a k pair (2i, 2i + 1) is two
    adjacent mel bins of one frame); bias and LayerNorm (E,) float32;
    the reshape_wav2img geometry (``t_img`` = spec_size * freq_ratio)."""

    w: torch.Tensor
    bias: torch.Tensor
    ln_w: torch.Tensor
    ln_b: torch.Tensor
    freq_ratio: int
    t_img: int

    @property
    def dtype(self) -> torch.dtype:
        return self.w.dtype


def prepare_patch_embed(enc, compute_dtype: torch.dtype = torch.bfloat16) -> PatchEmbedParams:
    """K8's weights from an HTSAT encoder (models.htsat.HTSATEncoder);
    raises unless the patch embed is the 4 x 4 stride-4 one the kernel
    takes, without LoRA."""
    if enc.patch_size != 4 or tuple(enc.patch_stride) != (4, 4):
        raise NotImplementedError("the fused forward takes the 4x4/4 patch embed")
    check_kernels(enc.patch_embed)
    proj, norm = enc.patch_embed.proj, enc.patch_embed.norm
    E = proj.weight.shape[0]
    with torch.no_grad():
        w = proj.weight.detach().transpose(2, 3).reshape(E, -1).t().contiguous().to(compute_dtype)
        f32 = lambda t: t.detach().float().contiguous()  # noqa: E731
        return PatchEmbedParams(w=w, bias=f32(proj.bias), ln_w=f32(norm.weight),
                                ln_b=f32(norm.bias), freq_ratio=enc.freq_ratio,
                                t_img=enc.spec_size * enc.freq_ratio)


def patch_embed_tokens_plain(x: torch.Tensor, p: PatchEmbedParams) -> torch.Tensor:
    """Plain version of K8 on any device: wav2img, the conv as an einsum of
    compute-dtype operands in float32, bias, float32 LayerNorm, one cast."""
    B, C, T, Fq = x.shape
    fr = p.freq_ratio
    xf = F.pad(x.to(p.dtype).float(), (0, 0, 0, p.t_img - T))
    x7 = xf.reshape(B, C, fr, p.t_img // fr // 4, 4, Fq // 4, 4)  # b c g tp kw fp kh
    w = p.w.float().t().reshape(-1, C, 4, 4)                      # e c kw kh
    tok = torch.einsum("bcgtufv,ecuv->bgfte", x7, w) + p.bias
    tok = F.layer_norm(tok, (tok.shape[-1],), p.ln_w, p.ln_b, eps=LN_EPS)
    return tok.reshape(B, -1, tok.shape[-1]).to(p.dtype)


def check_kernel_shape(C: int, F: int, p: PatchEmbedParams) -> None:
    """Raise ``NotImplementedError`` on what the kernel does not take: an
    embed width other than 96, mel bins other than 64, 128 or 256, a
    wav2img group of frames that is not whole tiles, bf16 with other than 7
    channels."""
    E = p.w.shape[1]
    tg = p.t_img // p.freq_ratio
    if (E != KERNEL_E or F not in KERNEL_FS or p.t_img % p.freq_ratio
            or tg % (4 * tile_patches(F)) or (p.dtype == torch.bfloat16 and C != KERNEL_C)):
        raise NotImplementedError(
            f"the patch-embed kernel takes E={KERNEL_E}, F in {KERNEL_FS}, {KERNEL_C} "
            f"channels in bf16 and a wav2img group of whole tiles of frames (got E={E}, "
            f"F={F}, C={C}, {tg} frames): use patch_embed=\"einsum\"")


def patch_embed_tokens(x: torch.Tensor, p: PatchEmbedParams) -> torch.Tensor:
    """(B, C, T, F) -> (B, L, E) in the compute dtype, T <= spec_size *
    freq_ratio (the rest is the zero pad): kernel K8 on a CUDA tensor, the
    plain version on a CPU tensor. On the card a shape the kernel does not
    take raises before any launch."""
    B, C, T, Fq = x.shape
    if T > p.t_img:
        raise ValueError(f"{T} frames > spec_size * freq_ratio = {p.t_img}")
    if x.device.type == "cpu":
        return patch_embed_tokens_plain(x, p)
    check_cuda_tensor("x", x, p.dtype, (B, C, T, Fq))
    check_kernel_shape(C, Fq, p)
    if p.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"compute dtype must be float32 or bfloat16, got {p.dtype}")
    for name, t in (("w", p.w), ("bias", p.bias), ("ln_w", p.ln_w), ("ln_b", p.ln_b)):
        check_cuda_tensor(name, t, p.dtype if name == "w" else torch.float32)
    if any(t.data_ptr() % 16 for t in (x, p.w)):
        raise ValueError("the patch-embed kernel reads x and w from 16-byte aligned addresses")
    E, tg = p.w.shape[1], p.t_img // p.freq_ratio
    out = torch.empty((B, p.freq_ratio * (Fq // 4) * (tg // 4), E), device=x.device,
                      dtype=p.dtype)
    KERNEL.launches += 1
    KERNEL.call("patch_embed_tokens", x.data_ptr(), p.w.data_ptr(), p.bias.data_ptr(),
                p.ln_w.data_ptr(), p.ln_b.data_ptr(), out.data_ptr(), B, C, T, p.t_img,
                p.freq_ratio, Fq, int(p.dtype == torch.bfloat16))
    return out
