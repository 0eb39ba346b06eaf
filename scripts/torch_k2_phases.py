#!/usr/bin/env python3
"""Where the time of kernel K2 (the Swin block forward) goes, by phase, in
one or more checkouts.

For each checkout, in a process of its own, at B=32 and each block form of
HTSAT's twelve (stage 0: 64x64 tokens, C 96; stage 1: 32x32, C 192; stage
2: 16x16, C 384; stage 3: 8x8, C 768), with seeded random weights:
  served    eval, shifts 0 and 4, the PatchMerging fold in the last block
            of stages 0-2 (as serving/htsat.py::prepare_blocks builds them)
  training  drop-path masks (B, 2) with zeros, no merge
it times one call with CUDA events (mean of 5 after one warm-up), then runs
3 calls under torch.profiler and takes the device time of each of the
call's launches in launch order. K2 launches its phases in the same order
in every design of the port so far, so the n-th launch is the n-th phase:
  ln1, qkv, attention, proj, ln2, fc1, fc2 (+ merge_ln, merge)
(the WMMA design's "ln" launches are LayerNorm moments, the Hopper design's
are LayerNorm rows written in bf16). Per form it prints each phase's ms,
TFLOP/s (the phase's bf16 FLOPs over its time) and share of the block's
FLOPs (chip_smoke.py::k2_work counts the same FLOPs), then the sums over the
12 blocks (each form times its count in HTSAT) with the card's name and
power limit, and one JSON line per checkout.

    python3 scripts/torch_k2_phases.py _archive/parent .

Needs one CUDA card and nvcc.
"""

import argparse
import json
import subprocess
import sys
from pathlib import Path

RUN = r"""
import json, os, re, sys, tempfile, torch
sys.path.insert(0, '.')
from torch.profiler import ProfilerActivity, profile
from pseldnets_tpu_torch.models.factory import init_weights
from pseldnets_tpu_torch.models.htsat import PatchMerging, SwinTransformerBlock
from pseldnets_tpu_torch.ops import _cuda, swin_block as sb

PHASES = ("ln1", "qkv", "attention", "proj", "ln2", "fc1", "fc2", "merge_ln", "merge")
# (stage, shift, merge, masks, count in the 12 blocks)
FORMS = [(0, 0, False, False, 1), (0, 4, True, False, 1), (1, 0, False, False, 1),
         (1, 4, True, False, 1), (2, 0, False, False, 3), (2, 4, False, False, 2),
         (2, 4, True, False, 1), (3, 0, False, False, 2),
         (0, 0, False, True, 1), (0, 4, False, True, 1), (1, 0, False, True, 1),
         (1, 4, False, True, 1), (2, 0, False, True, 3), (2, 4, False, True, 3),
         (3, 0, False, True, 2)]
B = 32


def flops(M, C, merge):
    f = {"qkv": 6 * M * C * C, "attention": 4 * M * 64 * C, "proj": 2 * M * C * C,
         "fc1": 8 * M * C * C, "fc2": 8 * M * C * C}
    if merge:
        f["merge"] = 2 * (M // 4) * 4 * C * 2 * C
    return f


def by_launch(fn, n, reps=3):
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
    with open(path) as f:
        ev = [e for e in json.load(f)["traceEvents"] if e.get("cat") == "kernel"]
    os.unlink(path)
    ev.sort(key=lambda e: e["ts"])
    ev = ev[-n * reps:]
    if len(ev) != n * reps or any(e["name"] != ev[i % n]["name"] for i, e in enumerate(ev)):
        raise SystemExit(f"expected {reps} calls of {n} launches in order, got "
                         + ", ".join(e["name"][:40] for e in ev[:2 * n]))
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


_cuda.build_all([sb.KERNEL])
gen = torch.Generator().manual_seed(13)
rows = []
for i, shift, merge, masks, count in FORMS:
    H, C, nh = 64 >> i, 96 << i, 4 << i
    blk = SwinTransformerBlock(C, (H, H), nh, 8, shift_size=shift)
    init_weights(blk, gen)
    mrg = None
    if merge:
        mrg = PatchMerging((H, H), C)
        init_weights(mrg, gen)
        mrg = mrg.cuda().eval()
    p = sb.prepare_block(blk.cuda().eval(), torch.bfloat16, mrg)
    x = torch.randn(B, H * H, C, generator=gen).cuda().bfloat16()
    m = None
    if masks:
        m = torch.full((B, 2), 1 / 0.9)
        m[0, 1] = m[1, 0] = 0.0
        m = m.cuda()
    fn = lambda: sb.swin_block_fused(x, p, m)
    n = 9 if merge else 7
    ms = timed(fn)
    ph, names = by_launch(fn, n)
    row = {"stage": i, "shift": shift, "merge": merge, "masks": masks, "count": count,
           "ms": ms, "phases": dict(zip(PHASES, ph)), "flops": flops(B * H * H, C, merge),
           "kernels": [k[:80] for k in names]}
    rows.append(row)
    total = sum(row["flops"].values())
    form = "training" if masks else "served"
    print(f"{form} stage {i} {H}x{H} C={C} shift={shift} merge={int(merge)}: {ms:.4f} ms "
          f"(launches sum {sum(ph):.4f}); " + ", ".join(
              f"{k} {v:.4f}" + (f" ({row['flops'][k] / v / 1e9:.0f} TFLOP/s, "
                                f"{100 * row['flops'][k] / total:.1f}% of FLOPs)"
                                if k in row["flops"] else "")
              for k, v in zip(PHASES, ph)), flush=True)
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
            total = sum(s["flops"].values())
            print(f"{checkout}: K2 x12 {form} {s['ms']:.3f} ms (launches sum "
                  f"{sum(s['phases'].values()):.3f}); " + ", ".join(
                      f"{k} {v:.3f}" + (f" ({s['flops'][k] / v / 1e9:.0f} TFLOP/s, "
                                        f"{100 * s['flops'][k] / total:.1f}% of FLOPs)"
                                        if k in s["flops"] else "")
                      for k, v in s["phases"].items()) + f" ({smi})", flush=True)
        print(json.dumps({"checkout": str(checkout), "card": smi, "x12": summary,
                          "blocks": rows}), flush=True)


if __name__ == "__main__":
    main()
