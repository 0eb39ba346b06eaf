"""Fused-kernel EINV2 dual-HTSAT inference in PyTorch, the counterpart of the
JAX package's serving/einv2.py: the eval forward of models.einv2_heads.HTSAT
with every Swin block of both encoders run by kernel K2 (ops/swin_block.py),
each stage's PatchMerging folded into its last block, and the CrossStitch
exchange before every stage; from the waveform, the features, the eval
ScalarBN, the compute-dtype cast and the reshape_wav2img frame pad run by
kernel K1 (ops/frontend.py).

Order (the JAX package's serving/einv2.py:48-96): ScalarBN (or K1's fold),
the SED encoder's patch embed on channels 0-3 and the DOA encoder's on all
seven, then per stage the stitch and each branch's blocks, then per branch
the final LayerNorm, token map, tscam conv, bilinear interpolation and frame
mean (serving/htsat.py ``head_tail``), with tanh on the DOA branch only.

The DOA branch embeds through kernel K8 (ops/patch_embed.py); the SED
branch's four channels take the einsum embed (serving/htsat.py
``embed_tokens``), since K8 in bf16 takes seven channels only. Around the
kernels everything is plain PyTorch, as the JAX package leaves it outside
its kernels; the stitch runs in float32 on the compute-dtype tokens and
rounds to the compute dtype before the next stage.

Eval only, no adapters (as the JAX package's path), block by block: the
JAX package's EINV2 path has no stage form, and ``swin="stage"`` raises.
10 s or 5 s clips from features, 10 s clips from the waveform.
``use_kernels=False`` calls the kernels' plain versions on the same device.
"""

from dataclasses import dataclass
from typing import Dict, List, Optional

import torch

from ..models.adapters import check_kernels
from ..models.einv2_heads import HTSAT, SED_IN_CHANNELS
from ..models.htsat import HTSATEncoder
from ..ops.patch_embed import (PatchEmbedParams, patch_embed_tokens,
                               patch_embed_tokens_plain, prepare_patch_embed)
from ..ops.swin_block import SwinBlockParams, swin_block_fused, swin_block_plain
from .htsat import (clip_features, embed_tokens, head_tail, normalized_input, prepare_blocks,
                    run_blocks)


@dataclass
class Einv2Branch:
    """One encoder's served weights: K2's per block (merges folded) and
    K8's patch embed, or None for the einsum embed."""

    blocks: List[SwinBlockParams]
    embed: Optional[PatchEmbedParams]


@dataclass
class Einv2Params:
    sed: Einv2Branch
    doa: Einv2Branch


def prepare_einv2(model: HTSAT, compute_dtype: torch.dtype = torch.bfloat16) -> Einv2Params:
    """Both encoders' kernel-layout weights: K2's per block, K8's for the
    DOA branch's embed (the SED branch takes the einsum embed). Raises on
    an encoder with adapters or LoRA, which the JAX package's EINV2 forward
    takes neither."""
    for enc in (model.sed_encoder, model.doa_encoder):
        check_kernels(enc, adapters=False)
    return Einv2Params(sed=Einv2Branch(prepare_blocks(model.sed_encoder, compute_dtype), None),
                       doa=Einv2Branch(prepare_blocks(model.doa_encoder, compute_dtype),
                                       prepare_patch_embed(model.doa_encoder, compute_dtype)))


def _check_swin(swin: str) -> None:
    if swin != "block":
        raise NotImplementedError(f"swin={swin!r}: EINV2 serves block by block (swin='block'); "
                                  "the JAX package's EINV2 path has no stage form")


def _embed(enc: HTSATEncoder, branch: Einv2Branch, x: torch.Tensor,
           compute_dtype: torch.dtype, use_kernels: bool) -> torch.Tensor:
    if branch.embed is None:
        return embed_tokens(enc, x, compute_dtype)
    return (patch_embed_tokens if use_kernels else patch_embed_tokens_plain)(x, branch.embed)


@torch.no_grad()
def einv2_htsat_fused_forward(model: HTSAT, x: torch.Tensor, *,
                              compute_dtype: torch.dtype = torch.bfloat16,
                              pre_normalized: bool = False,
                              params: Optional[Einv2Params] = None,
                              use_kernels: bool = True,
                              swin: str = "block") -> Dict[str, torch.Tensor]:
    """Eval forward equal to ``model(x)`` up to compute-dtype rounding:
    {"sed": (B, T, 3, K) logits, "doa": (B, T, 3, 3)}, float32.

    ``pre_normalized``: ``x`` already carries the eval ScalarBN (folded into
    the frontend kernel) and may be zero-padded to the full reshape_wav2img
    frame count - 10 s clips only. ``params``: :func:`prepare_einv2` of this
    model and dtype, to skip preparing the weights on every call."""
    _check_swin(swin)
    cd = compute_dtype
    if params is None:
        params = prepare_einv2(model, cd)
    block_fn = swin_block_fused if use_kernels else swin_block_plain
    sed_enc, doa_enc = model.sed_encoder, model.doa_encoder

    B = x.shape[0]
    output_frames, five_sec, x = normalized_input(model, x, cd, pre_normalized)
    x_sed = _embed(sed_enc, params.sed, x[:, :SED_IN_CHANNELS], cd, use_kernels)
    x_doa = _embed(doa_enc, params.doa, x, cd, use_kernels)
    for i, stitch in enumerate(model.stitch1):
        x_sed, x_doa = (t.to(cd) for t in stitch(x_sed, x_doa))
        x_sed = run_blocks(sed_enc, params.sed.blocks, i, x_sed, block_fn, None, cd)
        x_doa = run_blocks(doa_enc, params.doa.blocks, i, x_doa, block_fn, None, cd)
    sed = head_tail(model, sed_enc, model.sed_tscam_conv, x_sed, cd, B, output_frames, five_sec)
    doa = head_tail(model, doa_enc, model.doa_tscam_conv, x_doa, cd, B, output_frames, five_sec)
    return {"sed": sed.float().reshape(B, output_frames, 3, -1),
            "doa": torch.tanh(doa.float()).reshape(B, output_frames, 3, 3)}


@torch.no_grad()
def einv2_htsat_fused_forward_from_wav(model: HTSAT, wav, *,
                                       compute_dtype: torch.dtype = torch.bfloat16,
                                       device="cuda", params: Optional[Einv2Params] = None,
                                       use_kernels: bool = True, swin: str = "block",
                                       **frontend_kwargs) -> Dict[str, torch.Tensor]:
    """Full serving step from the FOA waveform (B, 4, N) float32: kernel K1
    (features + ScalarBN + cast + frame pad), then the fused model: the SED
    branch's einsum embed and the DOA branch's K8 embed, K2 on every block
    of both encoders, the stitches between. 10-second clips only.
    ``device`` defaults to the card and raises when CUDA is absent;
    ``model`` must already live there."""
    _check_swin(swin)
    feats = clip_features(model, model.doa_encoder, wav, "einv2_htsat_fused_forward_from_wav",
                          compute_dtype=compute_dtype, device=device,
                          use_kernels=use_kernels, **frontend_kwargs)
    return einv2_htsat_fused_forward(model, feats, compute_dtype=compute_dtype,
                                     pre_normalized=True, params=params,
                                     use_kernels=use_kernels)
