"""Fused-kernel HTSAT inference in PyTorch, the counterpart of the JAX
package's serving/htsat.py: the eval forward of models.heads.HTSAT with every
Swin block (and each stage's PatchMerging, folded into its last block) run by
kernel K2 (ops/swin_block.py), and, from the waveform, the features, the eval
ScalarBN, the compute-dtype cast and the reshape_wav2img frame pad run by
kernel K1 (ops/frontend.py). An AdapterBit model (blocks that carry
adapters) runs every block on kernel K4 (ops/swin_block_adapt.py, masks 1)
without the merge fold, and each PatchMerging unfolded (``patch_merging``),
as the JAX package does (serving/htsat.py:78-86, :187-215).

``swin="stage"`` runs each Swin stage in one launch of kernel K11
(ops/swin_stage.py, every block of the stage) and each PatchMerging
unfolded (``patch_merging``), as the JAX package's probe composes its stage
kernel (scripts/perf_r3a_probe.py:53-120); ``swin="block"``, the default,
runs K2 per block with the merge folds. The stage path takes no adapters.

The patch embed is kernel K8 (``patch_embed="kernel"``, the default:
ops/patch_embed.py, wav2img, conv, bias and LayerNorm in one pass; the JAX
package's Pallas embed, opt-in there) or one reshape + einsum
(``patch_embed="einsum"``, the JAX package's default). The served paths
take K8 because it was measured faster on the card (PERF.md §6); on the
card a shape K8 does not take raises, naming ``patch_embed="einsum"``, and
on a CPU tensor the default runs K8's plain version. The final LayerNorm,
the token-map finalize, the tscam conv, the interpolation matmul, the frame
mean and the tanh stay plain PyTorch, as the JAX package leaves them
outside its kernels.
``prepare_blocks``, ``embed_tokens`` and ``head_tail`` take the encoder (and
the tscam conv) they work on, so the EINV2 heads' two encoders share them
(serving/einv2.py). ``embed_tokens`` and ``head_tail`` carry autograd: the
fused training forward (train/fused_forward.py) shares them; the serving
callers run under no_grad.

Eval only; plain and constant-scalar AdapterBit checkpoints (models/adapters.py
raises on the rest at build time); 10 s or 5 s clips (the reference's two
supported shapes).
``use_kernels=False`` calls the kernels' plain versions on the same device:
the reference a card run is held against.
"""

from typing import Dict, List, Optional, Tuple, Union

import torch
import torch.nn.functional as F

from ..models.adapters import check_kernels
from ..models.common import _linear_upsample_matrix, layer_norm
from ..models.heads import HTSAT, concat_5s
from ..models.htsat import HTSATEncoder, PatchMerging
from ..ops._cuda import resolve_device
from ..ops.frontend import fused_logmel_iv, fused_logmel_iv_plain
from ..ops.patch_embed import (PatchEmbedParams, patch_embed_tokens,
                               patch_embed_tokens_plain, prepare_patch_embed)
from ..ops.swin_block import (SwinBlockParams, prepare_block, swin_block_fused,
                              swin_block_plain)
from ..ops.swin_block_adapt import (AdaptBlockParams, has_adapters,
                                    prepare_adapt_block, swin_block_adapt_fused,
                                    swin_block_adapt_plain)
from ..ops.swin_stage import (StageParams, prepare_stage, swin_stage_fused_v2,
                              swin_stage_plain)

BlockParams = Union[SwinBlockParams, AdaptBlockParams]


def prepare_blocks(enc: HTSATEncoder,
                   compute_dtype: torch.dtype = torch.bfloat16) -> List[BlockParams]:
    """Every block's kernel-layout weights of encoder ``enc``, in order:
    K2's, where the last block of each stage but the last carries the
    stage's PatchMerging, or, for a block with adapters, K4's (no merge
    fold)."""
    out = []
    for layer in enc.layers:
        for j, blk in enumerate(layer.blocks):
            check_kernels(blk)
            if has_adapters(blk):
                out.append(prepare_adapt_block(blk, compute_dtype))
                continue
            last = j == len(layer.blocks) - 1
            out.append(prepare_block(blk, compute_dtype,
                                     layer.downsample if last else None))
    return out


def prepare_stages(enc: HTSATEncoder,
                   compute_dtype: torch.dtype = torch.bfloat16) -> List[StageParams]:
    """Every stage's K11 weights of encoder ``enc``, in order (no merge
    folds); raises on an AdapterBit encoder."""
    return [prepare_stage(layer, compute_dtype) for layer in enc.layers]


def patch_merging(mod: PatchMerging, x: torch.Tensor, compute_dtype: torch.dtype) -> torch.Tensor:
    """2x2 concat -> float32 LayerNorm -> 4C -> 2C reduction on compute-dtype
    operands with float32 accumulation; output in the compute dtype (the
    JAX package's unfolded merge, serving/htsat.py:201-215)."""
    H, W = mod.input_resolution
    B, L, C = x.shape
    v = x.reshape(B, H, W, C)
    v = torch.cat([v[:, 0::2, 0::2], v[:, 1::2, 0::2], v[:, 0::2, 1::2], v[:, 1::2, 1::2]],
                  dim=-1).reshape(B, L // 4, 4 * C)
    v = layer_norm(v, mod.norm).to(compute_dtype)
    w = mod.reduction.weight.to(compute_dtype).float()
    return torch.matmul(v.float(), w.t()).to(compute_dtype)


def _ln(x: torch.Tensor, ln: torch.nn.LayerNorm) -> torch.Tensor:
    """float32 LayerNorm, result in the input's dtype."""
    return layer_norm(x, ln).to(x.dtype)


def embed_tokens(enc: HTSATEncoder, x: torch.Tensor,
                 compute_dtype: torch.dtype) -> torch.Tensor:
    """Normalized (B, C, T, F) features -> encoder ``enc``'s patch-embedded,
    LayerNormed tokens (B, H*W, E) in the compute dtype.

    reshape_wav2img + the 4x4/4 conv as one row-major reshape + einsum: image
    row g*F+f, column t'' with t = g*(T/fr)+t''; patch row g*(F/4)+f//4,
    column t''//4 - splitting the trailing (T, F) axes in place yields every
    patch index without a transpose (the JAX package's serving/htsat.py:136-157).
    """
    fr, spec_size = enc.freq_ratio, enc.spec_size
    sh, sw = enc.patch_stride
    if enc.patch_size != 4 or (sh, sw) != (4, 4):
        raise NotImplementedError("the fused forward takes the 4x4/4 patch embed")
    check_kernels(enc.patch_embed)
    Bc, Cc, Tcur, Fc = x.shape
    x = F.pad(x.to(compute_dtype), (0, 0, 0, spec_size * fr - Tcur))
    x7 = x.reshape(Bc, Cc, fr, spec_size // sw, sw, Fc // sh, sh)
    proj = enc.patch_embed.proj
    tok = torch.einsum("bcgtufv,ecvu->bgfte", x7.float(),
                       proj.weight.to(compute_dtype).float())
    tok = (tok + proj.bias.float()).to(compute_dtype)
    return _ln(tok.reshape(Bc, -1, tok.shape[-1]), enc.patch_embed.norm)


PATCH_EMBEDS = ("einsum", "kernel")
SWINS = ("block", "stage")


@torch.no_grad()
def htsat_fused_forward(model: HTSAT, x: torch.Tensor, *,
                        compute_dtype: torch.dtype = torch.bfloat16,
                        pre_normalized: bool = False,
                        blocks: Optional[List[BlockParams]] = None,
                        use_kernels: bool = True, patch_embed: str = "kernel",
                        embed: Optional[PatchEmbedParams] = None, swin: str = "block",
                        stages: Optional[List[StageParams]] = None) -> Dict[str, torch.Tensor]:
    """Eval forward equal to ``model(x)`` up to compute-dtype rounding.

    ``pre_normalized``: ``x`` already carries the eval ScalarBN (folded into
    the frontend kernel) and may be zero-padded to the full reshape_wav2img
    frame count - 10 s clips only. ``blocks``: :func:`prepare_blocks` of this
    model's encoder and dtype, to skip preparing the weights on every call.
    ``patch_embed``: "kernel" (K8, the default; ``embed``: its
    :func:`prepare_patch_embed` of the encoder and dtype, likewise) or
    "einsum".
    ``swin``: "block" (K2 per block, merges folded; K4 with adapters) or
    "stage" (K11 per stage, merges unfolded; ``stages``: its
    :func:`prepare_stages` of the encoder and dtype, likewise).
    """
    enc = model.encoder
    cd = compute_dtype
    if patch_embed not in PATCH_EMBEDS:
        raise NotImplementedError(f"patch_embed={patch_embed!r}: the port takes {PATCH_EMBEDS}")
    if swin not in SWINS:
        raise NotImplementedError(f"swin={swin!r}: the port takes {SWINS}")
    if swin == "stage":
        check_kernels(enc, adapters=False)  # an AdapterBit model serves with swin='block'
        if stages is None:
            stages = prepare_stages(enc, cd)
    elif blocks is None:
        blocks = prepare_blocks(enc, cd)
    if patch_embed == "kernel" and embed is None:
        embed = prepare_patch_embed(enc, cd)
    block_fn = swin_block_fused if use_kernels else swin_block_plain
    stage_fn = swin_stage_fused_v2 if use_kernels else swin_stage_plain
    adapt_fn = swin_block_adapt_fused if use_kernels else swin_block_adapt_plain

    B = x.shape[0]
    output_frames, five_sec, x = normalized_input(model, x, cd, pre_normalized)
    if patch_embed == "kernel":
        x = (patch_embed_tokens if use_kernels else patch_embed_tokens_plain)(x, embed)
    else:
        x = embed_tokens(enc, x, cd)
    if swin == "stage":
        for layer, sp in zip(enc.layers, stages):
            x = stage_fn(x, sp)
            if layer.downsample is not None:
                x = patch_merging(layer.downsample, x, cd)
    else:
        for i in range(enc.num_layers):
            x = run_blocks(enc, blocks, i, x, block_fn, adapt_fn, cd)
    x = head_tail(model, enc, model.tscam_conv, x, cd, B, output_frames, five_sec)
    return {model.output_key: torch.tanh(x.float())}


def normalized_input(model: torch.nn.Module, x: torch.Tensor, compute_dtype: torch.dtype,
                     pre_normalized: bool) -> Tuple[int, bool, torch.Tensor]:
    """An HTSAT head's (B, C, T, F) input -> (output_frames, five_sec, the
    encoder's normalized input in the compute dtype): the 5 s trick and the
    eval ScalarBN, or, ``pre_normalized``, the input as it is (10 s clips,
    possibly zero-padded past the label frames)."""
    if pre_normalized:
        return min(x.shape[2] // model.pred_res, model.tgt_output_frames), False, \
            x.to(compute_dtype)
    x, output_frames, five_sec = concat_5s(x, model.pred_res, model.tgt_output_frames)
    return output_frames, five_sec, model.scalar(x).to(compute_dtype)


def run_blocks(enc: HTSATEncoder, blocks: List[BlockParams], i: int, x: torch.Tensor,
               block_fn, adapt_fn, compute_dtype: torch.dtype) -> torch.Tensor:
    """Stage ``i`` of encoder ``enc`` on its :func:`prepare_blocks` weights:
    ``block_fn`` (K2 or its plain version) on each block, the merge folded
    into the last, or ``adapt_fn`` (K4 or its plain version) on a block with
    adapters and the merge unfolded."""
    start = sum(enc.depths[:i])
    layer = enc.layers[i]
    for p in blocks[start:start + enc.depths[i]]:
        x = adapt_fn(x, p) if isinstance(p, AdaptBlockParams) else block_fn(x, p)
    if layer.downsample is not None and isinstance(p, AdaptBlockParams):
        x = patch_merging(layer.downsample, x, compute_dtype)
    return x


def head_tail(model: torch.nn.Module, enc: HTSATEncoder, conv: torch.nn.Conv2d,
              x: torch.Tensor, compute_dtype: torch.dtype, B: int, output_frames: int,
              five_sec: bool) -> torch.Tensor:
    """Encoder ``enc``'s last-stage tokens (B', L, C) -> the (B,
    output_frames, out) head output before its activation: final LayerNorm,
    token map, tscam conv ``conv``, bilinear interpolation and frame mean
    (models.heads.tscam_head, with ``model``'s tgt_output_frames and
    pred_res), rounded to the compute dtype where the JAX package's fused
    forwards round."""
    cd = compute_dtype
    x = enc.token_map(_ln(x, enc.norm))

    # tscam conv head + bilinear interpolate + pooling (models.heads.tscam_head)
    tw = conv.weight.to(cd).float()
    x = F.conv2d(x.float(), tw, conv.bias.float(), padding=conv.padding).to(cd)
    x = x.flatten(2).transpose(1, 2)  # (B', ST, out)
    m = torch.as_tensor(_linear_upsample_matrix(x.shape[1], enc.time_res),
                        device=x.device).to(cd)
    x = torch.matmul(m.float(), x.float()).to(cd)
    x = x[:, : model.tgt_output_frames * model.pred_res]
    if five_sec:
        half = output_frames * model.pred_res
        x = torch.cat([x[:, :half], x[:, half:]], dim=0)
    return x.reshape(B, output_frames, model.pred_res, -1).float().mean(dim=2).to(cd)


def scalar_bn_affine(model: torch.nn.Module) -> Tuple[torch.Tensor, torch.Tensor]:
    """Eval ScalarBN (``model.scalar``, any head that has one) as a
    per-(channel, mel) affine: y = x * inv + shift."""
    return model.scalar.eval_affine()


def folded_wav_features(model: torch.nn.Module, wav: torch.Tensor, *,
                        compute_dtype: torch.dtype = torch.bfloat16,
                        t_out: Optional[int] = None, use_kernels: bool = True,
                        **frontend_kwargs) -> torch.Tensor:
    """FOA waveform -> eval-normalized (B, 7, T, mel) features in one kernel:
    the frontend with the eval ScalarBN of any head that has one (HTSAT,
    PaSST, CRNN; post_affine), the compute-dtype cast and optionally the
    reshape_wav2img zero-tail (t_out) folded in."""
    fn = fused_logmel_iv if use_kernels else fused_logmel_iv_plain
    return fn(wav, post_affine=scalar_bn_affine(model), out_dtype=compute_dtype,
              t_out=t_out, **frontend_kwargs)


@torch.no_grad()
def htsat_fused_forward_from_wav(model: HTSAT, wav, *,
                                 compute_dtype: torch.dtype = torch.bfloat16,
                                 device="cuda",
                                 blocks: Optional[List[BlockParams]] = None,
                                 use_kernels: bool = True, patch_embed: str = "kernel",
                                 embed: Optional[PatchEmbedParams] = None,
                                 swin: str = "block",
                                 stages: Optional[List[StageParams]] = None,
                                 **frontend_kwargs) -> Dict[str, torch.Tensor]:
    """Full serving step from the FOA waveform (B, 4, N) float32: kernel K1
    (features + ScalarBN + cast + frame pad) then the fused model: the patch
    embed (``patch_embed``: kernel K8, the default, or "einsum"), then K2,
    or K4 for an AdapterBit model (``swin="block"``), or K11 per stage and
    the unfolded merges (``swin="stage"``). 10-second clips only.
    ``device`` defaults to the card and raises when CUDA is absent;
    ``model`` must already live there."""
    feats = clip_features(model, model.encoder, wav, "htsat_fused_forward_from_wav",
                          compute_dtype=compute_dtype, device=device,
                          use_kernels=use_kernels, **frontend_kwargs)
    return htsat_fused_forward(model, feats, compute_dtype=compute_dtype,
                               pre_normalized=True, blocks=blocks,
                               use_kernels=use_kernels, patch_embed=patch_embed,
                               embed=embed, swin=swin, stages=stages)


def clip_features(model: torch.nn.Module, enc: HTSATEncoder, wav, caller: str, *,
                  compute_dtype: torch.dtype, device, use_kernels: bool,
                  **frontend_kwargs) -> torch.Tensor:
    """10 s FOA waveforms (B, 4, N) -> kernel K1's eval-normalized features
    of an HTSAT head, zero-padded to encoder ``enc``'s reshape_wav2img frame
    count, on ``device`` (the card by default; raises when CUDA is absent or
    ``model`` lives elsewhere, or on a clip of another length)."""
    device = resolve_device(device)
    wav = torch.as_tensor(wav, dtype=torch.float32, device=device)
    if model.scalar.weight.device != wav.device:
        raise ValueError(f"model is on {model.scalar.weight.device}, "
                         f"serving device is {wav.device}")
    n_frames = 1 + wav.shape[-1] // frontend_kwargs.get("hop", 240)
    if (n_frames - 1) // model.pred_res != model.tgt_output_frames:
        raise ValueError(f"{caller} supports 10-second clips only "
                         f"({model.tgt_output_frames} label frames), got {n_frames} frames")
    return folded_wav_features(model, wav, compute_dtype=compute_dtype,
                               t_out=enc.spec_size * enc.freq_ratio,
                               use_kernels=use_kernels, **frontend_kwargs)
