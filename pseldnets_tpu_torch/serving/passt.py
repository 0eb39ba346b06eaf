"""Fused-kernel PaSST inference in PyTorch, the counterpart of the JAX
package's serving/passt.py: the eval forward of models.heads.PASST with every
ViT block run by kernel K6 (ops/vit_block.py) and, from the waveform, the
features, the eval ScalarBN and the compute-dtype cast run by kernel K1
(ops/frontend.py).

The patch-embed conv, the position-embedding adds, the token concat, the
final LayerNorm, the frequency mean, ``head.0``, ``fc`` and the tanh stay
plain PyTorch, as the JAX package runs them through its flax submodules
outside the kernel; they round to the compute dtype where those submodules
round at the model's dtype (a conv or dense product, then its bias add, each
rounded; LayerNorm and the mean in float32, rounded once).

Eval only; 10 s clips (the frame count must fill ``img_size``).
``use_kernels=False`` calls the kernels' plain versions on the same device:
the reference a card run is held against.
"""

from typing import Dict, List, Optional

import torch
import torch.nn.functional as F

from ..models.heads import PASST
from ..ops._cuda import resolve_device
from ..ops.vit_block import VitBlockParams, prepare_vit_block, vit_block_fused, vit_block_plain
from .htsat import _ln, folded_wav_features


def prepare_vit_blocks(model: PASST,
                       compute_dtype: torch.dtype = torch.bfloat16) -> List[VitBlockParams]:
    """Every block's kernel-layout weights, in order."""
    return [prepare_vit_block(blk, compute_dtype) for blk in model.encoder.blocks]


def passt_tokens(model: PASST, x: torch.Tensor, compute_dtype: torch.dtype) -> torch.Tensor:
    """Normalized (B, C, T, F) features -> the first block's input tokens
    (B, num_tokens + F'T', E) in the compute dtype: the patch-embed conv on
    compute-dtype operands with float32 accumulation, rounded, + bias,
    rounded; the position embeddings and the prefix tokens added in the
    compute dtype (models.passt.PaSSTEncoder.forward_before, eval)."""
    enc = model.encoder
    cd = compute_dtype
    x = x.to(cd).transpose(2, 3)  # (B, C, F, T)
    if tuple(x.shape[2:]) != enc.img_size:
        raise ValueError(f"input {tuple(x.shape[2:])} != img_size {enc.img_size}")
    proj = enc.patch_embed.proj
    y = F.conv2d(x.float(), proj.weight.to(cd).float(), stride=proj.stride,
                 padding=proj.padding).to(cd)
    y = y + proj.bias.to(cd)[None, :, None, None]
    return enc.add_pos_embed(y)


def passt_head(model: PASST, h: torch.Tensor,
               compute_dtype: torch.dtype) -> Dict[str, torch.Tensor]:
    """Last block's tokens -> the head's output dict: final LayerNorm,
    frequency mean of the token map, ``head.0`` LayerNorm, ``fc`` and tanh
    (models.heads.PASST, eval)."""
    enc = model.encoder
    cd = compute_dtype
    fm = enc.token_map(_ln(h, enc.norm).float()).to(cd)
    fm = _ln(fm, enc.head[0])
    y = torch.matmul(fm.float(), model.fc.weight.to(cd).float().t()).to(cd)
    y = y + model.fc.bias.to(cd)
    return {model.output_key: torch.tanh(y.float())}


@torch.no_grad()
def passt_fused_forward(model: PASST, x: torch.Tensor, *,
                        compute_dtype: torch.dtype = torch.bfloat16,
                        pre_normalized: bool = False,
                        blocks: Optional[List[VitBlockParams]] = None,
                        use_kernels: bool = True) -> Dict[str, torch.Tensor]:
    """Eval forward equal to ``model(x)`` up to compute-dtype rounding.

    ``pre_normalized``: ``x`` already carries the eval ScalarBN (folded into
    the frontend kernel). ``blocks``: :func:`prepare_vit_blocks` of this model
    and dtype, to skip preparing the weights on every call."""
    cd = compute_dtype
    if blocks is None:
        blocks = prepare_vit_blocks(model, cd)
    block_fn = vit_block_fused if use_kernels else vit_block_plain
    x = x.to(cd) if pre_normalized else model.scalar(x).to(cd)
    h = passt_tokens(model, x, cd)
    for p in blocks:
        h = block_fn(h, p)
    return passt_head(model, h, cd)


@torch.no_grad()
def passt_fused_forward_from_wav(model: PASST, wav, *,
                                 compute_dtype: torch.dtype = torch.bfloat16,
                                 device="cuda",
                                 blocks: Optional[List[VitBlockParams]] = None,
                                 use_kernels: bool = True,
                                 **frontend_kwargs) -> Dict[str, torch.Tensor]:
    """Full serving step from the FOA waveform (B, 4, S) float32: kernel K1
    (features + eval ScalarBN + cast) then the fused model (K6 per block).
    The clip's frame count, 1 + S // hop, must equal ``img_size[1]`` (1001
    frames, 10 s at 24 kHz, in the served configuration). ``device`` defaults
    to the card and raises when CUDA is absent; ``model`` must already live
    there."""
    device = resolve_device(device)
    wav = torch.as_tensor(wav, dtype=torch.float32, device=device)
    if model.scalar.weight.device != wav.device:
        raise ValueError(f"model is on {model.scalar.weight.device}, "
                         f"serving device is {wav.device}")
    n_frames = 1 + wav.shape[-1] // frontend_kwargs.get("hop", 240)
    if n_frames != model.encoder.img_size[1]:
        raise ValueError(f"passt_fused_forward_from_wav needs {model.encoder.img_size[1]} "
                         f"frames (img_size), got {n_frames}")
    feats = folded_wav_features(model, wav, compute_dtype=compute_dtype,
                                use_kernels=use_kernels, **frontend_kwargs)
    return passt_fused_forward(model, feats, compute_dtype=compute_dtype,
                               pre_normalized=True, blocks=blocks,
                               use_kernels=use_kernels)
