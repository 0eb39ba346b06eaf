#!/usr/bin/env python3
"""A/B timing of two checkouts of the PyTorch/CUDA port on one card.

Runs ``python3 chip_smoke.py`` in the checkout A and the checkout B in turns,
A B B A repeated ``--rounds`` times, each run a process of its own, keeps each
run's output under ``--out``, reads the times that chip_smoke.py prints (the
served batch, the training step, the kernels per batch or step (K1 in each
form, beside cuFFT's rfft of the same frames), the served batch of 128, and the
AdapterBit, PaSST, CRNN, K8, frontend-form, one-stage-per-launch and EINV2
lines, each path's batch of 128, where the checkout has them) and prints, per
checkout, the median and the range of each over its runs as one JSON line. Exits non-zero when a run
fails.

    python3 scripts/torch_chip_ab.py _archive/parent . --rounds 3 --out ab_logs
"""

import argparse
import json
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

PATTERNS = {
    "served_ms": r"^served: ([\d.]+) ms/batch",
    "k1_served_ms": r"^per batch of \d+ .*?: K1 ([\d.]+) ms",
    "k1_train_ms": r"^per step of \d+ .*?: K1 \(float32\) ([\d.]+) ms",
    "k1_passt_ms": r"^PaSST per batch of \d+ .*?: K1 ([\d.]+) ms",
    "k1_crnn_ms": r"^CRNN per batch of \d+ .*?: K1 ([\d.]+) ms",
    "k1_cufft_rfft_ms": r"^K1 at B=\d+: .*?cuFFT rfft .*? ([\d.]+) ms \(",
    "served_b128_ms": r"^served at B=128: ([\d.]+) ms/batch",
    "k1_b128_ms": r"^served at B=128: .*?; K1 ([\d.]+) ms",
    "k2_x12_ms": r"^per batch of \d+ .*?K2 x12 ([\d.]+) ms",
    "train_ms": r"^training: ([\d.]+) ms/step",
    "k2_masks_x12_ms": r"^per step of \d+ .*?K2 with masks x12 ([\d.]+) ms",
    "k3_x12_ms": r"^per step of \d+ .*?K3 x12 ([\d.]+) ms",
    "train_rest_ms": r"^per step of \d+ .*?rest ([-\d.]+) ms",
    "adapter_served_ms": r"^AdapterBit served: ([\d.]+) ms/batch",
    "k4_x12_ms": r"^AdapterBit per batch of \d+ .*?K4 x12 ([\d.]+) ms",
    "adapter_train_ms": r"^AdapterBit training: ([\d.]+) ms/step",
    "k4_masks_x12_ms": r"^AdapterBit per step of \d+ .*?K4 with masks x12 ([\d.]+) ms",
    "k5_x12_ms": r"^AdapterBit per step of \d+ .*?K5 x12 ([\d.]+) ms",
    "k5_training_form_x12_ms": r"^AdapterBit per step of \d+ .*?K5 x12 in the training form "
                               r"([\d.]+) ms",
    "adapter_rest_ms": r"^AdapterBit per step of \d+ .*?rest ([-\d.]+) ms",
    "passt_served_ms": r"^PaSST served: ([\d.]+) ms/batch",
    "k6_x7_ms": r"^PaSST per batch of \d+ .*?K6 x7 ([\d.]+) ms",
    "k6_library_ms": r"^PaSST per batch of \d+ .*?K6 x7 .*?library ([\d.]+),",
    "passt_rest_ms": r"^PaSST per batch of \d+ .*?rest ([-\d.]+) ms",
    "crnn_served_ms": r"^CRNN served: ([\d.]+) ms/batch",
    "k7_x6_ms": r"^CRNN per batch of \d+ .*?K7 x6 ([\d.]+) ms",
    "k7_library_ms": r"^CRNN per batch of \d+ .*?K7 x6 .*?library ([\d.]+),",
    "crnn_rest_ms": r"^CRNN per batch of \d+ .*?rest ([-\d.]+) ms",
    "patch_served_ms": r"^served with the K8 embed: ([\d.]+) ms/batch",
    "einsum_served_ms": r"^served with the K8 embed: .*?; einsum embed ([\d.]+) ms/batch",
    "k8_ms": r"^K8 at B=\d+: .*?; ([\d.]+) ms \(plain",
    "k8_einsum_embed_ms": r"^K8 at B=\d+: .*?einsum embed ([\d.]+), bound",
    "k8_cudnn_conv_ms": r"^K8 at B=\d+: .*?\(yardstick\) ([\d.]+) ms",
    "k8_device_ms": r"^K8 at B=\d+: .*?sleeping kernel: K8 ([\d.]+) ms",
    "k8_einsum_device_ms": r"^K8 at B=\d+: .*?sleeping kernel: .*?einsum embed ([\d.]+),",
    "k8_host_ms": r"^K8 at B=\d+: .*?; host ([\d.]+) ms a K8 call",
    "adapter_served_b128_ms": r"^AdapterBit served at B=128: ([\d.]+) ms/batch",
    "stage_served_b128_ms": r"^served with swin='stage' at B=128: ([\d.]+) ms/batch",
    "k9_ms": r"^K9 at B=\d+ .*?IV; ([\d.]+) ms \(",
    "k10_ms": r"^K10 at B=\d+ .*?IV; ([\d.]+) ms \(",
    "stage_served_ms": r"^served with swin='stage': ([\d.]+) ms/batch",
    "k11_x4_ms": r"^per batch of \d+ .*?K11 x4 ([\d.]+) ms",
    "einv2_served_ms": r"^EINV2 served: ([\d.]+) ms/batch",
    "einv2_k2_x24_ms": r"^EINV2 per batch of \d+ .*?K2 x24 ([\d.]+) ms",
    "einv2_served_b128_ms": r"^EINV2 served at B=128: ([\d.]+) ms/batch",
    "einv2_train_ms": r"^EINV2 training: ([\d.]+) ms/step",
}


def run(checkout: Path, out: Path, tag: str) -> dict:
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=checkout, capture_output=True,
                       text=True)
    secs = time.perf_counter() - t0
    (out / f"{tag}.log").write_text(r.stdout + "\n--- stderr ---\n" + r.stderr)
    lines = r.stdout.splitlines()
    ok = r.returncode == 0 and bool(lines) and json.loads(lines[-1]).get("ok") is True
    vals = {"seconds": secs}
    for key, pat in PATTERNS.items():
        for line in lines:
            m = re.search(pat, line)
            if m:
                vals[key] = float(m.group(1))
                break
    print(json.dumps({"run": tag, "ok": ok, **vals}), flush=True)
    if not ok:
        sys.stderr.write(f"{tag} failed (exit {r.returncode}); see {out / (tag + '.log')}\n")
        sys.exit(1)
    return vals


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("a", type=Path, help="checkout A (the parent)")
    ap.add_argument("b", type=Path, help="checkout B (the change)")
    ap.add_argument("--rounds", type=int, default=3, help="A B B A rounds")
    ap.add_argument("--out", type=Path, required=True, help="directory for the run logs")
    args = ap.parse_args()
    args.out.mkdir(parents=True, exist_ok=True)
    runs = {"A": [], "B": []}
    for _ in range(args.rounds):
        for side in ("A", "B", "B", "A"):
            checkout = args.a if side == "A" else args.b
            runs[side].append(run(checkout.resolve(), args.out, f"{side}{len(runs[side])}"))
    summary = {}
    for side, vals in runs.items():
        keys = sorted({k for v in vals for k in v})
        summary[side] = {k: {"median": statistics.median([v[k] for v in vals if k in v]),
                             "min": min(v[k] for v in vals if k in v),
                             "max": max(v[k] for v in vals if k in v),
                             "n": sum(k in v for v in vals)} for k in keys}
    print(json.dumps({"ab": summary}))


if __name__ == "__main__":
    main()
