#!/usr/bin/env python3
"""Tile-shape sweep of kernel K7 (csrc/conv_block.cu) on one card.

Builds one copy of conv_block.cu per tile shape (the source with its
``using Big = ...`` and ``using Small = ...`` lines replaced), runs each on
the CRNN trunk's six ConvBlocks (pair mode, B=32, 10 s clips: the shapes of
chip_smoke.py's CRNN_BLOCKS, the stem padded to 16 channels), checks it
against the plain version (2^-6 of scale) and times it with CUDA events, in
rounds that alternate the order of the shapes (forward, then backward). A
cuDNN conv pair per ConvBlock is timed once beside them. Prints one line per
shape and round, then one JSON line with each shape's K7 x6 ms per round.

    python3 scripts/torch_k7_tiles.py --rounds 2

Needs one CUDA card and nvcc.
"""

import argparse
import json
import re
import subprocess
import sys
from pathlib import Path

import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from pseldnets_tpu_torch.ops import _cuda, conv_block  # noqa: E402

# name -> (Big, Small) tile configs: Cfg<BK, BN, WM, WN, STAGES>
SHAPES = {
    "first_128x64": ("Cfg<32, 64, 32, 32, 3>", "Cfg<32, 64, 32, 32, 3>"),
    "A_8warps_64x32": ("Cfg<32, 128, 64, 32, 4>", "Cfg<32, 64, 32, 32, 3>"),
    "B_8warps_64x32_bk64": ("Cfg<64, 128, 64, 32, 3>", "Cfg<32, 64, 32, 32, 3>"),
    "C_4warps_64x64": ("Cfg<32, 128, 64, 64, 4>", "Cfg<32, 64, 32, 32, 3>"),
    "D_4warps_64x64_bk64": ("Cfg<64, 128, 64, 64, 3>", "Cfg<64, 64, 32, 32, 3>"),
}
BLOCKS = ((1001, 64, 16, 64), (500, 32, 64, 128), (250, 16, 128, 256), (125, 8, 256, 512),
          (125, 4, 512, 1024), (125, 2, 1024, 2048))
B = 32


def variant_kernel(name, big, small):
    src = (_cuda.CSRC / "conv_block.cu").read_text()
    src, n_big = re.subn(r"^using Big = .*;$", f"using Big = {big};", src, flags=re.M)
    src, n_small = re.subn(r"^using Small = .*;$", f"using Small = {small};", src, flags=re.M)
    if n_big != 1 or n_small != 1:
        raise RuntimeError("conv_block.cu no longer declares one Big and one Small")
    out = _cuda.BUILD / "k7_tiles" / f"{name}.cu"
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(src)
    k = _cuda.CudaKernel("conv_block.cu", conv_block.KERNEL.functions)
    k.source = out
    return k


def cuda_ms(fn, reps=5):
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("torch_k7_tiles: CUDA is not available")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(f"card: {smi}", flush=True)
    kernels = {n: variant_kernel(n, *cfg) for n, cfg in SHAPES.items()}
    _cuda.build_all(list(kernels.values()))
    g = torch.Generator().manual_seed(0)
    data = []
    for T, Fq, cin, cout in BLOCKS:
        x = torch.randn(B, T, Fq, cin, generator=g).cuda().bfloat16()
        w1 = (torch.randn(3, 3, cin, cout, generator=g) / (9 * cin) ** 0.5).cuda().bfloat16()
        w2 = (torch.randn(3, 3, cout, cout, generator=g) / (9 * cout) ** 0.5).cuda().bfloat16()
        b1 = (torch.randn(cout, generator=g) * 0.5 + 0.5).cuda()
        b2 = (torch.randn(cout, generator=g) * 0.5).cuda()
        ref = conv_block.conv3x3_bias_relu_plain(x, w1, b1, w2, b2).float()
        xl = x.permute(0, 3, 1, 2)
        wl1, wl2 = (w.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
                    for w in (w1, w2))
        lib = cuda_ms(lambda: F.relu(F.conv2d(F.relu(F.conv2d(xl, wl1, b1.bfloat16(), padding=1)),
                                              wl2, b2.bfloat16(), padding=1)))
        data.append(((x, w1, b1, w2, b2), ref, 2 * B * T * Fq * 9 * cout * (cin + cout), lib))
    print("cuDNN pair per ConvBlock ms: " + ", ".join(f"{d[3]:.3f}" for d in data)
          + f"; x6 {sum(d[3] for d in data):.3f}", flush=True)
    totals = {n: [] for n in kernels}
    launch = conv_block.KERNEL
    try:
        for rnd in range(args.rounds):
            order = list(kernels.items())
            for name, k in (order if rnd % 2 == 0 else order[::-1]):
                conv_block.KERNEL = k
                row = []
                for a, ref, flops, _ in data:
                    got = conv_block.conv3x3_bias_relu(*a).float()
                    err = (got - ref).abs().max().item() / ref.abs().max().item()
                    if err > 2.0 ** -6:
                        raise AssertionError(f"{name}: {err:.3g} of scale from the plain version")
                    t = cuda_ms(lambda: conv_block.conv3x3_bias_relu(*a))
                    row.append((t, flops / t / 1e9))
                totals[name].append(sum(t for t, _ in row))
                print(f"round {rnd} {name}: " + ", ".join(f"{t:.3f} ({tf:.0f})" for t, tf in row)
                      + f" ms (TFLOP/s); x6 {totals[name][-1]:.3f} ms", flush=True)
    finally:
        conv_block.KERNEL = launch
    print(json.dumps({"card": smi, "k7_x6_ms": totals}))


if __name__ == "__main__":
    main()
