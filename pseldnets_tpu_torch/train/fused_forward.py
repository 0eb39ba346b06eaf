"""Fused-kernel training forward for HTSAT, the counterpart of the JAX
package's train/fused_forward.py (:34-159).

Every Swin block runs as ``SwinBlockTrain``: kernel K2 with drop-path masks
forward, kernel K3 backward (ops/swin_block_vjp.py); a block that carries
AdapterBit adapters runs as ``SwinBlockAdaptTrain``: K4 forward, K5 backward
(ops/swin_block_adapt.py, fused_forward.py:129-135). Around them, plain
PyTorch with autograd: the 5 s clip trick, the train-mode ScalarBN, the
patch embed (serving/htsat.py::embed_tokens), the unfolded PatchMerging
between stages (as the JAX package leaves it to XLA, fused_forward.py:
139-140), the final LayerNorm, token map, tscam conv, interpolation and
frame mean (serving/htsat.py::head_tail), and the tanh.

The math equals the eager ``model.train()`` forward with the same masks, up
to the kernels' compute-dtype rounding. The masks come from the caller
(``dp_masks``, one (B', 2) float32 mask per block) or from ``generator``;
torch's generator cannot replay the JAX package's draw order
(``fold_in(dropout_rng, bi)``, fused_forward.py:119-128), so tests inject
that package's masks.

Under data parallelism each rank runs K2 and K3 on its own clips (the JAX
package's shard_map block runner, train/fused_forward.py:47-71): its masks
are its rows of the global batch's (``drop_path_masks`` through
``parallel.batch_rows``), and the ScalarBN's statistics are the global
batch's (models/common.py ``TorchBatchNorm.batch_forward``).
"""

from typing import Dict, List, Optional, Sequence, Tuple

import torch

from ..models.adapters import kernel_refusal
from ..models.heads import HTSAT, concat_5s
from ..models.common import drop_path_masks
from ..ops.swin_block_adapt import has_adapters, swin_block_adapt_train
from ..ops.swin_block_vjp import swin_block_train
from ..serving.htsat import embed_tokens, head_tail, patch_merging

__all__ = ["supports_fused_train", "drop_path_masks", "htsat_fused_train_forward"]


def supports_fused_train(model) -> bool:
    """An HTSAT whose adapters the kernels run (``kernel_refusal``: no LoRA,
    no eager-only adapter setting) with zero attention / projection
    / position dropout (the JAX package's train/fused_forward.py:34-44)."""
    if not isinstance(model, HTSAT) or kernel_refusal(model) is not None:
        return False
    enc = model.encoder
    return enc.drop_rate == 0.0 and enc.attn_drop_rate == 0.0


def htsat_fused_train_forward(model: HTSAT, feats: torch.Tensor, *,
                              dp_masks: Optional[Sequence[torch.Tensor]] = None,
                              generator: Optional[torch.Generator] = None,
                              compute_dtype: torch.dtype = torch.bfloat16,
                              use_kernels: bool = True
                              ) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
    """Train-mode forward of ``model`` on features (B, C, T, F) with every
    Swin block on kernels K2/K3 (K4/K5 with adapters). Returns ``(preds, batch-stat update)``: the
    head's output dict and the ScalarBN's new ``running_mean`` /
    ``running_var`` (not yet written into the model). ``use_kernels=False``
    runs the kernels' plain versions on the same device."""
    if not supports_fused_train(model):
        raise ValueError("the fused training forward takes an HTSAT without LoRA, eager-only "
                         "adapter settings or dropout")
    enc = model.encoder
    cd = compute_dtype
    B = feats.shape[0]
    x, output_frames, five_sec = concat_5s(feats, model.pred_res, model.tgt_output_frames)
    x, new_mean, new_var = model.scalar.batch_forward(x)
    x = embed_tokens(enc, x, cd)

    rates = enc.block_rates()
    if dp_masks is None:
        if generator is None and any(rates):
            raise ValueError("drop-path needs dp_masks or a generator")
        dp_masks = drop_path_masks(generator, x.shape[0], rates, x.device)
    masks: List[torch.Tensor] = list(dp_masks)
    if len(masks) != len(rates):
        raise ValueError(f"expected {len(rates)} drop-path masks, got {len(masks)}")
    bi = 0
    for layer in enc.layers:
        for blk in layer.blocks:
            m = masks[bi].to(x.device, torch.float32).contiguous()
            run = swin_block_adapt_train if has_adapters(blk) else swin_block_train
            x = run(x, blk, m, cd, use_kernels)
            bi += 1
        if layer.downsample is not None:
            x = patch_merging(layer.downsample, x, cd)
    x = head_tail(model, enc, model.tscam_conv, x, cd, B, output_frames, five_sec)
    preds = {model.output_key: torch.tanh(x.float())}
    return preds, {"running_mean": new_mean, "running_var": new_var}
