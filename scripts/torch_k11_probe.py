#!/usr/bin/env python3
"""Where the time of kernel K11 (csrc/swin_stage.cu, a whole Swin stage in
one cooperative launch on K2's phases, csrc/swin_fwd_sm90.cuh) goes, on one
card.

Builds copies of the source with one change each and times them on the four
HTSAT stages at full width and depth (2, 2, 6, 2), B=32 random bf16 tokens,
seeded random weights, with CUDA events, beside K2 (csrc/swin_block.cu) run
block after block on the same inputs, in rounds that alternate the order:

- ``shipped``: the source as it is (one block of 384 threads a SM);
- ``half_grid``: the grid cut to half the SMs (every phase's items and
  rows fall to other blocks; the output must not change);
- ``barriers_only``: every phase given no work (no rows, tiles or windows),
  so the time left is the launch and its grid barriers';
- ``no_rows``: the LayerNorm row phases given no rows;
- ``no_gemms``: the GEMM phases given no tiles;
- ``no_attention``: the attention phase given no windows.

The last four give wrong outputs, which are not checked; ``half_grid`` must
give the shipped output bit for bit (the same tiles in the same order; only
their assignment to blocks changes). Prints each copy's registers, spills
and ptxas's notes on serialised wgmma, one line per variant and round, then
one JSON line with each variant's ms per round (the sum over the four
stages) and the card.

    python3 scripts/torch_k11_probe.py --rounds 2

Needs one CUDA card and nvcc.
"""

import argparse
import json
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from pseldnets_tpu_torch.models.factory import init_weights  # noqa: E402
from pseldnets_tpu_torch.models.htsat import BasicLayer  # noqa: E402
from pseldnets_tpu_torch.ops import _cuda, swin_block, swin_stage  # noqa: E402

DEPTHS = (2, 2, 6, 2)
B = 32
NO_ROWS = ("a.h, M, g);", "a.h, 0, g);", 2)
NO_WINDOWS = ("a.B * nW, a.att_groups", "0, a.att_groups", 1)
NO_TILES = ("p.M = M;", "p.M = 0;", 1)
# name -> (old, new, occurrences)
EDITS = {
    "shipped": (),
    "half_grid": (("const int grid = per_sm * sms;", "const int grid = per_sm * sms / 2;", 1),),
    "barriers_only": (NO_ROWS, NO_WINDOWS, NO_TILES),
    "no_rows": (NO_ROWS,),
    "no_gemms": (NO_TILES,),
    "no_attention": (NO_WINDOWS,),
}
UNCHECKED = ("shipped", "barriers_only", "no_rows", "no_gemms", "no_attention")


def variant(name):
    """A CudaKernel of K11's source with the ``name`` change."""
    src = swin_stage.KERNEL.source.read_text()
    # the copy lives in the build directory: include the shared header by path
    edits = EDITS[name] + (('#include "swin_fwd_sm90.cuh"',
                            f'#include "{_cuda.CSRC / "swin_fwd_sm90.cuh"}"', 1),)
    for old, new, n in edits:
        if src.count(old) != n:
            raise RuntimeError(f"swin_stage.cu no longer holds {n} `{old}`")
        src = src.replace(old, new)
    out = _cuda.BUILD / "k11_probe" / f"swin_stage_{name}.cu"
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(src)
    k = _cuda.CudaKernel("swin_stage.cu", swin_stage.KERNEL.functions)
    k.source = out
    return k


def cuda_ms(fn, reps=10):
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def k2_chained(x, sp):
    for d in range(sp.depth):
        x = swin_block.swin_block_fused(x, sp.block(d))
    return x


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("torch_k11_probe: needs a CUDA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    print(f"card: {smi}", flush=True)

    kernels = {name: variant(name) for name in EDITS}
    secs = _cuda.build_all(list(kernels.values()) + [swin_block.KERNEL])
    print(f"build: {secs:.1f} s", flush=True)
    for name, k in kernels.items():
        entry = ""
        for line in k.build_log.splitlines():
            if "Compiling entry function" in line:
                entry = line
            elif ("registers" in line or "spill" in line) and "swin_stage_kernel" in entry:
                print(f"  {name}: {line.strip()}", flush=True)
            elif "Potential Performance Loss" in line and "swin_stage_kernel" in line:
                # ptxas's notes: C7515 / C7510 a wgmma pipeline serialised
                print(f"  {name}: {line.strip()[:130]}", flush=True)

    gen = torch.Generator().manual_seed(7)
    stages = []
    for i, depth in enumerate(DEPTHS):
        H, C, nh = 64 >> i, 96 << i, 4 << i
        layer = BasicLayer(C, (H, H), depth, nh, 8)
        init_weights(layer, gen)
        sp = swin_stage.prepare_stage(layer.cuda().eval(), torch.bfloat16)
        x = torch.randn(B, H * H, C, generator=gen).cuda().bfloat16()
        stages.append((x, sp))

    with torch.no_grad():
        swin_stage.KERNEL = kernels["shipped"]
        ref = [swin_stage.swin_stage_fused(x, sp) for x, sp in stages]
        for name, k in kernels.items():
            if name in UNCHECKED:
                continue
            swin_stage.KERNEL = k
            same = all(torch.equal(swin_stage.swin_stage_fused(x, sp), r)
                       for (x, sp), r in zip(stages, ref))
            print(f"{name}: output bitwise equal to shipped: {same}", flush=True)
            if not same:
                sys.exit(f"torch_k11_probe: {name} changed the output")

        times = {name: [] for name in list(kernels) + ["k2_chained"]}
        order = list(times)
        for r in range(args.rounds):
            for name in (order if r % 2 == 0 else order[::-1]):
                per_stage = []
                for x, sp in stages:
                    if name == "k2_chained":
                        per_stage.append(cuda_ms(lambda x=x, sp=sp: k2_chained(x, sp)))
                    else:
                        swin_stage.KERNEL = kernels[name]
                        per_stage.append(cuda_ms(
                            lambda x=x, sp=sp: swin_stage.swin_stage_fused(x, sp)))
                times[name].append(sum(per_stage))
                print(f"round {r} {name:14s} {sum(per_stage):.3f} ms "
                      f"(stages {', '.join(f'{t:.3f}' for t in per_stage)})", flush=True)
    print(json.dumps({"card": smi, "B": B, "ms": times}))


if __name__ == "__main__":
    main()
