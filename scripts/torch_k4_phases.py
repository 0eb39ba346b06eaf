#!/usr/bin/env python3
"""Where the time of kernel K4 (the Swin block with AdapterBit adapters,
forward) goes, by phase, in one or more checkouts.

For each checkout, in a process of its own, at B=32 and each block form of
the AdapterBit HTSAT's twelve (stage 0: 64x64 tokens, C 96, the 48-wide
adapter padded to 64; stage 1: 32x32, C 192; stage 2: 16x16, C 384; stage 3:
8x8, C 768; configs/adapt/adapter.yaml's adapters on every block, seeded
random weights), served (masks of ones) and in the training form (drop-path
masks with zeros), it times one call with CUDA events (mean of 5 after one
warm-up), then runs 3 calls under torch.profiler and takes the device time
of each of the call's launches in launch order. A design launches its
phases in a fixed order, so the n-th launch is the n-th phase:
  10 launches (the Hopper design): ln1, qkv, attention, proj, sa1, sa2,
     ln2, fc1, ma1, fc2 (fc2 and ma2 on one tile)
  12 launches (the WMMA design): ln1_moments, qkv (LN1 in its prologue),
     attention, proj, sa1, sa2, residual_ln2 (y and h2), fc1, ma1, fc2,
     ma2, output
Per form it prints each phase's ms and TFLOP/s (bf16 FLOPs at the padded
adapter width over the phase's time), then the sums over the 12 blocks
(each form times its count) with the card's name and power limit, and one
JSON line per checkout.

    python3 scripts/torch_k4_phases.py _archive/parent .

Needs one CUDA card and nvcc.
"""

import argparse
import json
import subprocess
import sys
from pathlib import Path

RUN = r"""
import json, math, os, re, sys, tempfile, torch
sys.path.insert(0, '.')
from torch.profiler import ProfilerActivity, profile
from pseldnets_tpu_torch.config import compose
from pseldnets_tpu_torch.models.adapters import Adapter, AdaptConfig
from pseldnets_tpu_torch.models.factory import init_weights
from pseldnets_tpu_torch.models.htsat import SwinTransformerBlock
from pseldnets_tpu_torch.ops import _cuda, swin_block_adapt as sa

NAMES = {10: ("ln1", "qkv", "attention", "proj", "sa1", "sa2", "ln2", "fc1", "ma1", "fc2"),
         12: ("ln1_moments", "qkv", "attention", "proj", "sa1", "sa2", "residual_ln2", "fc1",
              "ma1", "fc2", "ma2", "output")}
# (stage, shift, masks, count in the 12 blocks)
FORMS = [(i, s, m, n) for m in (False, True) for i, s, n in (
    (0, 0, 1), (0, 4, 1), (1, 0, 1), (1, 4, 1), (2, 0, 3), (2, 4, 3), (3, 0, 2))]
B = 32


def flops(M, C, hidden, ch):
    f = {"qkv": 6 * M * C * C, "attention": 4 * M * 64 * C, "proj": 2 * M * C * C,
         "sa1": 2 * M * C * ch, "sa2": 2 * M * ch * C, "fc1": 2 * M * C * hidden,
         "ma1": 2 * M * C * ch, "fc2": 2 * M * hidden * C, "ma2": 2 * M * ch * C}
    return f


def kernel_events(fn, reps):
    fn()
    torch.cuda.synchronize()
    marker = torch.zeros(1, device="cuda")
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        marker.add_(1)  # the profiler may miss the first kernel of its window
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    prof.export_chrome_trace(path)
    with open(path) as f:  # the kernel's own launches: not PyTorch's (marker, masks' fill)
        ev = [e for e in json.load(f)["traceEvents"]
              if e.get("cat") == "kernel" and not re.search(r"\bat::", e["name"])]
    os.unlink(path)
    ev.sort(key=lambda e: e["ts"])
    return ev


def by_launch(fn, reps=3):
    # reps + 1 calls, the last reps taken (the profiler may miss the first
    # kernel of its window): n launches a call
    ev = kernel_events(fn, reps + 1)
    n = round(len(ev) / (reps + 1))
    ev = ev[-n * reps:]
    if len(ev) != n * reps or any(e["name"] != ev[i % n]["name"] for i, e in enumerate(ev)):
        raise SystemExit(f"expected {reps} calls of {n} launches in order")
    ms = [0.0] * n
    for i, e in enumerate(ev):
        ms[i % n] += e["dur"] / 1e3 / reps
    return ms, [e["name"] for e in ev[:n]]


def timed(fn):
    fn()
    torch.cuda.synchronize()
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(5):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / 5


_cuda.build_all([sa.FWD_KERNEL])
adapt = AdaptConfig(compose("configs", "train", ["adapt=adapter"])["adapt"])
gen = torch.Generator().manual_seed(13)
rows = []
for i, shift, masks, count in FORMS:
    H, C, nh = 64 >> i, 96 << i, 4 << i
    blk = SwinTransformerBlock(C, (H, H), nh, 8, shift_size=shift, adapt=adapt)
    init_weights(blk, gen)
    with torch.no_grad():  # random adapters (a zero fc2 is the init)
        for ad in [m for m in blk.modules() if isinstance(m, Adapter)]:
            for fc in (ad.fc1, ad.fc2):
                fc.weight.copy_(torch.randn(fc.weight.shape, generator=gen).clamp_(-2, 2)
                                / math.sqrt(fc.weight.shape[1]))
                fc.bias.copy_(0.02 * torch.randn(fc.bias.shape, generator=gen))
    p = sa.prepare_adapt_block(blk.cuda(), torch.bfloat16)
    x = torch.randn(B, H * H, C, generator=gen).cuda().bfloat16()
    m = None
    if masks:
        m = torch.full((B, 2), 1 / 0.9)
        m[0, 1] = m[1, 0] = 0.0
        m = m.cuda()
    fn = lambda: sa.swin_block_adapt_fused(x, p, m)
    ms = timed(fn)
    ph, kernels = by_launch(fn)
    names = NAMES.get(len(ph), tuple(f"launch{k}" for k in range(len(ph))))
    f = flops(B * H * H, C, 4 * C, p.ch_pad)
    if len(ph) == 10:  # fc2 and ma2 on one tile
        f["fc2"] += f.pop("ma2")
    row = {"stage": i, "shift": shift, "masks": masks, "count": count, "ms": ms,
           "phases": dict(zip(names, ph)), "flops": {k: v for k, v in f.items() if k in names},
           "kernels": [k[:80] for k in kernels]}
    rows.append(row)
    form = "training" if masks else "served"
    print(f"{form} stage {i} {H}x{H} C={C} shift={shift}: {ms:.4f} ms (launches sum "
          f"{sum(ph):.4f}); " + ", ".join(
              f"{k} {v:.4f}" + (f" ({row['flops'][k] / v / 1e9:.0f} TFLOP/s)"
                                if k in row["flops"] else "")
              for k, v in zip(names, ph)), flush=True)
print("RESULT " + json.dumps(rows))
"""


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("checkouts", type=Path, nargs="+")
    args = ap.parse_args()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip().splitlines()[0]
    print(f"card: {smi}", flush=True)
    for checkout in args.checkouts:
        r = subprocess.run([sys.executable, "-c", RUN], cwd=checkout, capture_output=True,
                           text=True)
        sys.stdout.write(r.stdout.replace("RESULT ", "# "))
        if r.returncode != 0:
            sys.exit(f"run in {checkout} failed:\n{r.stderr[-4000:]}")
        rows = json.loads(next(l for l in r.stdout.splitlines() if l.startswith("RESULT "))[7:])
        summary = {}
        for row in rows:
            s = summary.setdefault("training" if row["masks"] else "served",
                                   {"ms": 0.0, "phases": {}, "flops": {}})
            s["ms"] += row["count"] * row["ms"]
            for k, v in row["phases"].items():
                s["phases"][k] = s["phases"].get(k, 0.0) + row["count"] * v
            for k, v in row["flops"].items():
                s["flops"][k] = s["flops"].get(k, 0) + row["count"] * v
        for form, s in summary.items():
            print(f"{checkout}: K4 x12 {form} {s['ms']:.3f} ms (launches sum "
                  f"{sum(s['phases'].values()):.3f}); " + ", ".join(
                      f"{k} {v:.3f}" + (f" ({s['flops'][k] / v / 1e9:.0f} TFLOP/s)"
                                        if k in s["flops"] else "")
                      for k, v in s["phases"].items()) + f" ({smi})", flush=True)
        print(json.dumps({"checkout": str(checkout), "card": smi, "x12": summary,
                          "blocks": rows}), flush=True)


if __name__ == "__main__":
    main()
