#!/usr/bin/env python3
"""Bitwise comparison of the port's kernels across two checkouts on one card.

Runs, in each checkout and in a process of its own, K6 (the PaSST ViT block,
B=4 x 602 tokens, and its GEMM core at the block's four served GEMM shapes
with each tile) and K7 (the CNN12 trunk's six ConvBlocks, pair mode, B=2) on
inputs made from fixed seeds, saves the outputs in a temporary directory
(about 2 GB), and prints for each output whether the two checkouts gave the
same bits. Exits
non-zero when a run fails; a difference is reported, not an error (a change
to a kernel's arithmetic may be meant).

    python3 scripts/torch_bits_ab.py _archive/parent .

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
from pseldnets_tpu_torch.ops import conv_block, vit_block

g = torch.Generator().manual_seed(0)
out = {}
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
torch.cuda.synchronize()
torch.save({k: v.cpu() for k, v in out.items()}, sys.argv[1])
"""


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("a", type=Path)
    ap.add_argument("b", type=Path)
    args = ap.parse_args()
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
        print(f"{k}: {'same bits' if v else 'DIFFERENT'}", flush=True)
    print(json.dumps({"same_bits": same}))


if __name__ == "__main__":
    main()
