"""The HTSAT patch embed as one kernel: kernel K8 and its plain version. The
counterpart of the JAX package's ``ops/pallas/patch_embed.py::
patch_embed_tokens``, which ``htsat_fused_forward(..., patch_embed="kernel")``
calls (serving/htsat.py:119-135).

(B, C, T, F) normalized features in the compute dtype -> (B, L, E) stage-0
tokens in the compute dtype: reshape_wav2img (frames zero-padded from T to
spec_size * freq_ratio), the 4 x 4 stride-4 VALID conv on compute-dtype
operands with float32 accumulation, the bias, the LayerNorm in float32
(eps 1e-5), and one rounding to the compute dtype, tokens row-major in (g,
fp, tp) as kernel K2 reads them. The JAX kernel rounds once, after the
LayerNorm; the einsum embed (serving/htsat.py ``embed_tokens``) rounds the
conv output before its LayerNorm, so the two differ by up to one rounding
in bf16.

On a CUDA tensor ``patch_embed_tokens`` launches ``csrc/patch_embed.cu``;
on a CPU tensor it runs ``patch_embed_tokens_plain``, which nothing on the
card's served path calls. ``prepare_patch_embed`` lays the weights out once
per model and dtype.
"""

from dataclasses import dataclass

import torch
import torch.nn.functional as F

from ._cuda import CudaKernel, check_cuda_tensor, i32, ptr

KERNEL = CudaKernel("patch_embed.cu", {
    "patch_embed_tokens": [ptr] * 6 + [i32] * 6 + [ptr],
})

LN_EPS = 1e-5
# the kernel's shapes: HTSAT's published embed width and mel bins
KERNEL_E, KERNEL_F, KERNEL_TPB = 96, 64, 8


@dataclass
class PatchEmbedParams:
    """The patch embed's weights in the kernel's layout: ``w`` (C * 16, E)
    in the compute dtype with w[(c * 4 + kh) * 4 + kw, e] the conv kernel
    (kh along frequency, kw along time); bias and LayerNorm (E,) float32;
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


def prepare_patch_embed(model, compute_dtype: torch.dtype = torch.bfloat16) -> PatchEmbedParams:
    """K8's weights from an HTSAT head (``model.encoder``); raises unless
    the patch embed is the 4 x 4 stride-4 one the kernel takes."""
    enc = model.encoder
    if enc.patch_size != 4 or tuple(enc.patch_stride) != (4, 4):
        raise NotImplementedError("the fused forward takes the 4x4/4 patch embed")
    proj, norm = enc.patch_embed.proj, enc.patch_embed.norm
    E = proj.weight.shape[0]
    with torch.no_grad():
        w = proj.weight.detach().reshape(E, -1).t().contiguous().to(compute_dtype)
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
    w = p.w.float().t().reshape(-1, C, 4, 4)                      # e c kh kw
    tok = torch.einsum("bcgtufv,ecvu->bgfte", x7, w) + p.bias
    tok = F.layer_norm(tok, (tok.shape[-1],), p.ln_w, p.ln_b, eps=LN_EPS)
    return tok.reshape(B, -1, tok.shape[-1]).to(p.dtype)


def patch_embed_tokens(x: torch.Tensor, p: PatchEmbedParams) -> torch.Tensor:
    """(B, C, T, F) -> (B, L, E) in the compute dtype, T <= spec_size *
    freq_ratio (the rest is the zero pad): kernel K8 on a CUDA tensor, the
    plain version on a CPU tensor."""
    B, C, T, Fq = x.shape
    if T > p.t_img:
        raise ValueError(f"{T} frames > spec_size * freq_ratio = {p.t_img}")
    if x.device.type == "cpu":
        return patch_embed_tokens_plain(x, p)
    check_cuda_tensor("x", x, p.dtype, (B, C, T, Fq))
    E = p.w.shape[1]
    tg = p.t_img // p.freq_ratio
    if (E, Fq) != (KERNEL_E, KERNEL_F) or p.t_img % p.freq_ratio or tg % (4 * KERNEL_TPB):
        raise NotImplementedError(
            f"the patch-embed kernel takes E={KERNEL_E}, F={KERNEL_F} and a wav2img group "
            f"of a multiple of {4 * KERNEL_TPB} frames (got E={E}, F={Fq}, {tg})")
    if p.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"compute dtype must be float32 or bfloat16, got {p.dtype}")
    for name, t in (("w", p.w), ("bias", p.bias), ("ln_w", p.ln_w), ("ln_b", p.ln_b)):
        check_cuda_tensor(name, t, p.dtype if name == "w" else torch.float32)
    out = torch.empty((B, p.freq_ratio * (Fq // 4) * (tg // 4), E), device=x.device,
                      dtype=p.dtype)
    KERNEL.launches += 1
    KERNEL.call("patch_embed_tokens", x.data_ptr(), p.w.data_ptr(), p.bias.data_ptr(),
                p.ln_w.data_ptr(), p.ln_b.data_ptr(), out.data_ptr(), B, C, T, p.t_img,
                p.freq_ratio, int(p.dtype == torch.bfloat16))
    return out
