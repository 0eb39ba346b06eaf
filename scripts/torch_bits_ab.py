#!/usr/bin/env python3
"""Bitwise comparison of the port's kernels across two checkouts on one card.

Runs, in each checkout and in a process of its own, K1 (the frontend, two
10 s clips, in its training, served HTSAT and PaSST forms), K9 and K10 (the
flat and DIF forms at the shapes the routing gives them), K6 (the PaSST ViT block,
B=4 x 602 tokens, and its GEMM core at the block's four served GEMM shapes
with each tile), K7 (the CNN12 trunk's six ConvBlocks, pair mode, B=2), K2
(the Swin block at each stage shape, B=2, served with the merge fold where
HTSAT has one, and with drop-path masks), K4 (the block with AdapterBit
adapters, B=2, with masks), K11 (each whole eval Swin stage, B=2), K3 and
K5 (the block backwards, B=2, dx and every grad) and K8 (the patch embed,
B=3, 1024 and 1000 frames, bf16), and the HTSAT paths around them through
their entry points (served with K8, with the einsum embed and with
swin="stage", the eager model, AdapterBit served, the fused training
forward and its grads; full width, B=2) on inputs made from fixed
seeds, saves the outputs in a temporary directory (about 2 GB), and prints
for each output whether the two checkouts gave the same bits. Exits
non-zero when a run fails; a difference is reported, not an error (a change
to a kernel's arithmetic may be meant; ``--meant K3,K5`` labels the kernels
whose differences are expected).

    python3 scripts/torch_bits_ab.py _archive/parent .
    python3 scripts/torch_bits_ab.py _archive/parent . --meant K1

Needs one CUDA card and nvcc.
"""

import argparse
import json
import subprocess
import sys
import tempfile
from pathlib import Path

RUN = r"""
import sys, torch
sys.path.insert(0, '.')
from pseldnets_tpu_torch.models.factory import init_weights
from pseldnets_tpu_torch.models.passt import Block
from pseldnets_tpu_torch.config import compose
from pseldnets_tpu_torch.models.adapters import Adapter, AdaptConfig
from pseldnets_tpu_torch.models.htsat import PatchMerging, SwinTransformerBlock
from pseldnets_tpu_torch.ops import (conv_block, frontend, frontend_forms, patch_embed,
                                     swin_block, swin_block_adapt, swin_block_vjp, swin_stage,
                                     vit_block)

g = torch.Generator().manual_seed(0)
out = {}
wav = (torch.randn(2, 4, 240000, generator=g) * 0.1).cuda()
aff = tuple((torch.rand(7, 64, generator=g) + 0.5 * i).cuda() for i in (1, 0))
out["K1 training form"] = frontend.fused_logmel_iv(wav)
out["K1 served form"] = frontend.fused_logmel_iv(wav, post_affine=aff, out_dtype=torch.bfloat16,
                                                 t_out=1024)
out["K1 PaSST form"] = frontend.fused_logmel_iv(wav, post_affine=aff, out_dtype=torch.bfloat16)
out["K9 flat"] = frontend.fused_logmel_iv(wav, radix2=False)
out["K9 flat n_fft 2048 folded"] = frontend.fused_logmel_iv(
    wav, n_fft=2048, post_affine=aff, out_dtype=torch.bfloat16, t_out=1024)
out["K10 dif"] = frontend.fused_logmel_iv(wav, variant="dif")
out["K10 dif n_fft 512 hop 100"] = frontend.fused_logmel_iv(wav, n_fft=512, hop=100,
                                                            variant="dif")
blk = Block(768, 12)
init_weights(blk, g)
p = vit_block.prepare_vit_block(blk.cuda().eval(), torch.bfloat16)
x = torch.randn(4, 602, 768, generator=g).cuda().bfloat16()
out["K6 block B=4 N=602"] = vit_block.vit_block_fused(x, p)
for name, (N, K, epi) in {"qkv": (2304, 768, "bias"), "proj": (768, 768, "resid"),
                          "fc1": (3072, 768, "gelu"), "fc2": (768, 3072, "resid")}.items():
    a = (torch.randn(19264, K, generator=g) * 0.5).cuda().bfloat16()
    w = (torch.randn(N, K, generator=g) / K ** 0.5).cuda().bfloat16()
    bias = (torch.randn(N, generator=g) * 0.1).cuda()
    resid = torch.randn(19264, N, generator=g).cuda().bfloat16() if epi == "resid" else None
    for bn in vit_block.GEMM_TILES:
        out[f"K6 GEMM {name} bn={bn}"] = vit_block.gemm(a, w, bias, resid, epi, bn)
for T, F, cin, cout in ((1001, 64, 7, 64), (500, 32, 64, 128), (250, 16, 128, 256),
                        (125, 8, 256, 512), (125, 4, 512, 1024), (125, 2, 1024, 2048)):
    cp = conv_block.padded_channels(cin)
    x = torch.randn(2, T, F, cp, generator=g)
    x[..., cin:] = 0.0
    w1 = torch.randn(3, 3, cp, cout, generator=g) / (9 * cin) ** 0.5
    w1[:, :, cin:] = 0.0
    w2 = torch.randn(3, 3, cout, cout, generator=g) / (9 * cout) ** 0.5
    b1, b2 = torch.randn(cout, generator=g).cuda(), torch.randn(cout, generator=g).cuda()
    out[f"K7 pair T={T} F={F} {cin}->{cout}"] = conv_block.conv3x3_bias_relu(
        x.cuda().bfloat16(), w1.cuda().bfloat16(), b1, w2.cuda().bfloat16(), b2)
adapt = AdaptConfig(compose('configs', 'train', ['adapt=adapter'])['adapt'])
m = torch.tensor([[1 / 0.9, 0.0], [0.0, 1 / 0.9]]).cuda()
for i in range(4):
    H, C, nh = 64 >> i, 96 << i, 4 << i
    shifts = (0, 4) if i < 3 else (0,)
    for shift in shifts:
        blk = SwinTransformerBlock(C, (H, H), nh, 8, shift_size=shift)
        init_weights(blk, g)
        mrg = PatchMerging((H, H), C) if i < 3 else None
        if mrg is not None:
            init_weights(mrg, g)
            mrg = mrg.cuda().eval()
        blk = blk.cuda().eval()
        x = torch.randn(2, H * H, C, generator=g).cuda().bfloat16()
        dout = torch.randn(2, H * H, C, generator=g).cuda().bfloat16()
        p = swin_block.prepare_block(blk, torch.bfloat16)
        out[f"K2 stage {i} shift {shift}"] = swin_block.swin_block_fused(x, p)
        out[f"K2 stage {i} shift {shift} masks"] = swin_block.swin_block_fused(x, p, m)
        if mrg is not None:
            out[f"K2 stage {i} shift {shift} merge"] = swin_block.swin_block_fused(
                x, swin_block.prepare_block(blk, torch.bfloat16, mrg))
        dx, gr = swin_block_vjp.swin_block_backward(x, p, m, dout)
        out[f"K3 stage {i} shift {shift} dx"] = dx
        out.update({f"K3 stage {i} shift {shift} {k}": v for k, v in gr.items()})
        ablk = SwinTransformerBlock(C, (H, H), nh, 8, shift_size=shift, adapt=adapt)
        init_weights(ablk, g)
        with torch.no_grad():
            for ad in [a for a in ablk.modules() if isinstance(a, Adapter)]:
                ad.fc2.weight.copy_(torch.randn(ad.fc2.weight.shape, generator=g) * 0.1)
        ap = swin_block_adapt.prepare_adapt_block(ablk.cuda(), torch.bfloat16)
        out[f"K4 stage {i} shift {shift} masks"] = swin_block_adapt.swin_block_adapt_fused(x, ap, m)
        dx, gr = swin_block_adapt.swin_block_adapt_backward(x, ap, m, dout)
        out[f"K5 stage {i} shift {shift} dx"] = dx
        out.update({f"K5 stage {i} shift {shift} {k}": v for k, v in gr.items()})
    layer = torch.nn.Module()
    layer.blocks = torch.nn.ModuleList(  # HTSAT's stage: shifts 0, 4, ... (none at 8x8)
        [SwinTransformerBlock(C, (H, H), nh, 8, shift_size=4 if j % 2 and i < 3 else 0)
         for j in range((2, 2, 6, 2)[i])])
    init_weights(layer, g)
    sp = swin_stage.prepare_stage(layer.cuda().eval(), torch.bfloat16)
    x = torch.randn(2, H * H, C, generator=g).cuda().bfloat16()
    out[f"K11 stage {i}"] = swin_stage.swin_stage_fused_v2(x, sp)
vec = lambda s, o: (torch.randn(96, generator=g) * s + o).cuda()
pe = patch_embed.PatchEmbedParams(
    w=(torch.randn(112, 96, generator=g) * 0.1).cuda().bfloat16(), bias=vec(0.1, 0.0),
    ln_w=vec(0.1, 1.0), ln_b=vec(0.1, 0.0), freq_ratio=4, t_img=1024)
x = torch.randn(3, 7, 1024, 64, generator=g).cuda().bfloat16()
out["K8 served form B=3"] = patch_embed.patch_embed_tokens(x, pe)
out["K8 5 s trick B=3"] = patch_embed.patch_embed_tokens(x[:, :, :1000].contiguous(), pe)
# the HTSAT paths around the kernels, through their entry points
from pseldnets_tpu_torch.models import build_model
from pseldnets_tpu_torch.models.common import drop_path_masks
from pseldnets_tpu_torch.serving import htsat_fused_forward_from_wav
from pseldnets_tpu_torch.train.fused_forward import htsat_fused_train_forward
over = ["loss=multi_accdoa", "model.kwargs.pretrained_path=null"]
model, _ = build_model(compose("configs", "train", over), 13, device="cuda", seed=0)
with torch.no_grad():
    out["HTSAT served (K1, K8, K2)"] = htsat_fused_forward_from_wav(model, wav)["multi_accdoa"]
    out["HTSAT served, einsum embed"] = htsat_fused_forward_from_wav(
        model, wav, patch_embed="einsum")["multi_accdoa"]
    out["HTSAT served, swin=stage (K11)"] = htsat_fused_forward_from_wav(
        model, wav, swin="stage")["multi_accdoa"]
    feats = frontend.fused_logmel_iv(wav)
    out["HTSAT eager"] = model(feats)["multi_accdoa"]
am, _ = build_model(compose("configs", "train", over + ["adapt=adapter"]), 13, device="cuda",
                    seed=1)
for mod in am.modules():
    if isinstance(mod, Adapter):
        mod.fc2.weight.data.copy_(torch.randn(mod.fc2.weight.shape, generator=g) * 0.05)
with torch.no_grad():
    out["AdapterBit served (K4)"] = htsat_fused_forward_from_wav(am, wav)["multi_accdoa"]
model.train()
masks = [m.cuda() for m in drop_path_masks(torch.Generator().manual_seed(1), 2,
                                           model.encoder.block_rates())]
preds, _ = htsat_fused_train_forward(model, feats, dp_masks=masks)
out["HTSAT fused training forward (K2 masks)"] = preds["multi_accdoa"]
grads = torch.autograd.grad(preds["multi_accdoa"].square().mean(), list(model.parameters()))
out["HTSAT fused training grads (K3)"] = torch.cat([t.flatten() for t in grads])
torch.cuda.synchronize()
torch.save({k: v.cpu() for k, v in out.items()}, sys.argv[1])
"""


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("a", type=Path)
    ap.add_argument("b", type=Path)
    ap.add_argument("--meant", default="", help="kernels whose differences are meant, e.g. K3,K5")
    args = ap.parse_args()
    meant = tuple(k + " " for k in args.meant.split(",") if k)
    import torch

    with tempfile.TemporaryDirectory() as tmp:
        saved = []
        for tag, checkout in (("a", args.a), ("b", args.b)):
            path = Path(tmp) / f"{tag}.pt"
            r = subprocess.run([sys.executable, "-c", RUN, str(path)], cwd=checkout,
                               capture_output=True, text=True)
            if r.returncode != 0:
                sys.exit(f"run in {checkout} failed:\n{r.stdout}\n{r.stderr}")
            saved.append(path)
        a, b = (torch.load(p) for p in saved)
    same = {k: bool(k in b and a[k].shape == b[k].shape and torch.equal(a[k], b[k])) for k in a}
    for k, v in same.items():
        note = "same bits" if v else (
            "different (meant)" if k.startswith(meant) else "DIFFERENT")
        print(f"{k}: {note}", flush=True)
    unmeant = [k for k, v in same.items() if not v and not k.startswith(meant)]
    print(json.dumps({"same_bits": same, "unmeant_differences": unmeant}))


if __name__ == "__main__":
    main()
