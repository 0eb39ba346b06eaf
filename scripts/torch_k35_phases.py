#!/usr/bin/env python3
"""Where the time of kernels K3 and K5 (the Swin block backward, plain and
with AdapterBit adapters) goes, by phase, in one or more checkouts.

For each checkout, in a process of its own, at B=32 and each of HTSAT's
(stage, shift) block shapes (stage 0: 64x64 tokens, C 96; stage 1: 32x32,
C 192; stage 2: 16x16, C 384; stage 3: 8x8, C 768; shifts 0 and 4, the last
stage unshifted), with seeded random weights (random adapters for K5):
times one launch with CUDA events (mean of 5 after one warm-up), then runs 3
launches under torch.profiler and sums the device time of each of the
launch's kernels into its phase by the kernel's name:
  recompute     the forward GEMMs recomputed (qkv, proj, fc1, adapters')
  attn_fwd      the window attention recomputed
  act_grad      the activation-grad GEMMs (dY W^T)
  mlp_dual      fc1's recompute and fc2's activation grad in one GEMM (and
                the MLP adapter's), where the checkout has it
  weight_grad   the weight-grad GEMMs (A^T dY, split over the rows)
  reduce        the ordered reductions of split partials
  col_sums      the column sums (bias and LayerNorm grads)
  rows          LayerNorm forward and backward and the other row passes
  attn_bwd      the window attention backward
Where the checkout's wrappers take ``want`` (the grads to write), K5 is
also timed in the AdapterBit training form (only the trained grads) and K3
in the same masked form. Per (stage, shift) it prints one line per kernel
and form, then the sums over the 12 blocks of HTSAT (depths 2, 2, 6, 2) and
one JSON line per checkout, with the card's name and power limit; at stage 0
(shift 4), each kernel's own time.

    python3 scripts/torch_k35_phases.py _archive/parent .

Needs one CUDA card and nvcc.
"""

import argparse
import json
import subprocess
import sys
from pathlib import Path

RUN = r"""
import inspect, json, re, sys, torch
sys.path.insert(0, '.')
from torch.profiler import ProfilerActivity, profile
from pseldnets_tpu_torch.config import compose
from pseldnets_tpu_torch.models.adapters import Adapter, AdaptConfig
from pseldnets_tpu_torch.models.factory import init_weights
from pseldnets_tpu_torch.models.htsat import SwinTransformerBlock
from pseldnets_tpu_torch.ops import _cuda, swin_block_adapt as sa, swin_block_vjp as sv

# the parent's kernel names (WMMA: gemm_kernel<0, BT, ...>, gemm_tn_kernel)
# and the Hopper layer's (bw_gemm<BN, FORM, EPI>: 0 NN, 1 NT, 2 CAT, 3 DUAL,
# 4 TT)
PHASES = (("attn_bwd", r"attention_bwd"), ("attn_fwd", r"attention"),
          ("mlp_dual", r"bw_gemm<\d+, 3,"), ("weight_grad", r"gemm_tn|bw_gemm<\d+, 4,"),
          ("recompute", r"gemm_kernel<0, false|bw_gemm<\d+, 0,"),
          ("act_grad", r"gemm_kernel<0, true|bw_gemm<\d+, [12],"),
          ("reduce", r"reduce"), ("col_sums", r"col_sums"), ("rows", r"."))
ADAPT_TRAINED = {"ln1_b", "qkv_b", "proj_b", "ln2_b", "fc1_b", "fc2_b", "sa1_w", "sa1_b",
                 "sa2_w", "sa2_b", "ma1_w", "ma1_b", "ma2_w", "ma2_b"}


def phase(name):
    return next(p for p, pat in PHASES if re.search(pat, name))


def timed(fn):
    fn()
    torch.cuda.synchronize()
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(5):
        fn()
    e1.record()
    torch.cuda.synchronize()
    ms = e0.elapsed_time(e1) / 5
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
    by, names = {}, {}
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0:
            p = phase(e.key)
            by[p] = by.get(p, 0.0) + e.self_device_time_total / 3e3
            names[e.key] = (e.self_device_time_total / 3e3, e.count // 3)
    return ms, by, names


adapt = AdaptConfig(compose('configs', 'train', ['adapt=adapter'])['adapt'])
_cuda.build_all([sv.KERNEL, sa.BWD_KERNEL])
for k in (sv.KERNEL, sa.BWD_KERNEL):  # registers and spills by kernel (ptxas -v)
    entry = None
    for line in k.build_log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            entry = m.group(1)
        elif entry and ("registers" in line or "spill" in line):
            print(f"  {k.source.name} {entry[:60]}: {line.split(':', 1)[-1].strip()}", flush=True)
masked = 'want' in inspect.signature(sv.swin_block_backward).parameters
gen = torch.Generator().manual_seed(31)
out = []
for i in range(4):
    for shift in ((0, 4) if i < 3 else (0,)):
        H, C, nh = 64 >> i, 96 << i, 4 << i
        x = torch.randn(32, H * H, C, generator=gen).cuda().bfloat16()
        dout = torch.randn(32, H * H, C, generator=gen).cuda().bfloat16()
        m = torch.full((32, 2), 1 / 0.9)
        m[0, 1] = m[1, 0] = 0.0
        m = m.cuda()
        blk = SwinTransformerBlock(C, (H, H), nh, 8, shift_size=shift)
        init_weights(blk, gen)
        p = sv.prepare_block(blk.cuda(), torch.bfloat16)
        ablk = SwinTransformerBlock(C, (H, H), nh, 8, shift_size=shift, adapt=adapt)
        init_weights(ablk, gen)
        with torch.no_grad():
            for ad in [mm for mm in ablk.modules() if isinstance(mm, Adapter)]:
                ad.fc2.weight.copy_(torch.randn(ad.fc2.weight.shape, generator=gen) * 0.1)
        ap = sa.prepare_adapt_block(ablk.cuda(), torch.bfloat16)
        runs = {"K3": lambda: sv.swin_block_backward(x, p, m, dout),
                "K5": lambda: sa.swin_block_adapt_backward(x, ap, m, dout)}
        if masked:
            bias_keys = {k for k in sv.GRAD_KEYS if k.endswith("_b")}
            runs["K3 masked"] = lambda: sv.swin_block_backward(x, p, m, dout, want=bias_keys)
            runs["K5 masked"] = lambda: sa.swin_block_adapt_backward(x, ap, m, dout,
                                                                     want=ADAPT_TRAINED)
        for name, fn in runs.items():
            ms, by, names = timed(fn)
            if i == 0 and shift == 4:  # each launch at the largest shape
                for k, (v, n) in sorted(names.items(), key=lambda kv: -kv[1][0]):
                    print(f"  {name} stage 0 shift 4: {v:.4f} ms x{n} {k[:110]}", flush=True)
            out.append({"kernel": name, "stage": i, "shift": shift, "ms": ms, "phases": by})
            print(f"{name} stage {i} {H}x{H} C={C} shift={shift}: {ms:.4f} ms; " + ", ".join(
                f"{k} {v:.4f}" for k, v in sorted(by.items(), key=lambda kv: -kv[1])), flush=True)
print("RESULT " + json.dumps(out))
"""

DEPTHS = (2, 2, 6, 2)


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
        # the 12 blocks: each stage's depth split evenly between its shifts
        summary = {}
        for row in rows:
            shifts = 2 if row["stage"] < 3 else 1
            n = DEPTHS[row["stage"]] / shifts
            s = summary.setdefault(row["kernel"], {"ms": 0.0, "phases": {}})
            s["ms"] += n * row["ms"]
            for k, v in row["phases"].items():
                s["phases"][k] = s["phases"].get(k, 0.0) + n * v
        for name, s in summary.items():
            print(f"{checkout}: {name} x12 {s['ms']:.3f} ms; " + ", ".join(
                f"{k} {v:.3f}" for k, v in sorted(s["phases"].items(), key=lambda kv: -kv[1])),
                flush=True)
        print(json.dumps({"checkout": str(checkout), "card": smi, "x12": summary,
                          "blocks": rows}), flush=True)


if __name__ == "__main__":
    main()
