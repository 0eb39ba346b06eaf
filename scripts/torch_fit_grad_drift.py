#!/usr/bin/env python3
"""How far kernel K3 (csrc/swin_block_bwd.cu) lies from its plain versions
as ``fit`` trains, on one card.

Runs chip_smoke.py's fit configuration (HTSAT mACCDOA at full width,
bf16-mixed, fused forward, drop-path 0.1, B=32, chip_smoke's FitDataModule
with its in-memory validation files) one epoch of 4 steps at a time. After
each epoch it records the inputs of every block's backward in one step on
the fit's second batch (chip_smoke's ``record_block_backwards``) and runs
K3, its plain version in bf16 and its plain version in float32 on them.
For each epoch it prints, over the twelve blocks and every output (dx and
the grads), the largest distance of K3 from the plain bf16 version as a
share of that output's scale (chip_smoke's rule: 2^-6), which output and
block it was, the same output's distances of K3 and of the plain bf16
version from float32, and the relative-position bias grad's scale; then
one JSON line with every epoch's numbers and the card.

    python3 scripts/torch_fit_grad_drift.py --epochs 10

Needs one CUDA card and nvcc.
"""

import argparse
import copy
import dataclasses
import json
import sys
import tempfile
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as c  # noqa: E402


def block_errors(x, p, m, dout):
    """{output: (|k - p16| / s16, |k - p32| / s32, |p16 - p32| / s32, s16)}
    of one block's backward."""
    from pseldnets_tpu_torch.ops import swin_block_vjp as v

    dx, gr = v.swin_block_backward(x, p, m, dout)
    dx0, g0 = v.swin_block_backward_plain(x, p, m, dout)
    p32 = dataclasses.replace(p, **{f.name: getattr(p, f.name).float()
                                    for f in dataclasses.fields(p)
                                    if torch.is_tensor(getattr(p, f.name))})
    dx1, g1 = v.swin_block_backward_plain(x.float(), p32, m, dout.float())
    out = {}
    for name, k, b, f in [("dx", dx, dx0, dx1)] + [(n, gr[n], g0[n], g1[n]) for n in gr]:
        k, b, f = k.float(), b.float(), f.float()
        s16, s32 = b.abs().max().item(), f.abs().max().item()
        out[name] = ((k - b).abs().max().item() / s16, (k - f).abs().max().item() / s32,
                     (b - f).abs().max().item() / s32, s16)
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--epochs", type=int, default=10)
    args = ap.parse_args()
    smi = c.phase_device()
    c.phase_build()
    from pseldnets_tpu_torch.config import compose
    from pseldnets_tpu_torch.train import loop
    from pseldnets_tpu_torch.train.module import DatasetSpec, SELDTask

    tmp = tempfile.TemporaryDirectory()
    cfg = compose(str(ROOT / "configs"), "train", c.TRAIN_OVERRIDES + [
        "logger=csv", f"paths.log_dir={tmp.name}/logs"])
    cfg["post_processing"] = "move_avg"
    cfg["data"]["test_hoplen_sec"] = c.EVAL_HOP_SEC
    dm = c.FitDataModule(70)
    task = SELDTask(cfg, DatasetSpec(num_classes=13), steps_per_epoch=c.FIT_STEPS,
                    device="cuda")
    task.init_state(0)
    w1 = torch.from_numpy(dm.train[1]["data"]).cuda()
    lab1 = {"adpit_label": torch.from_numpy(dm.train[1]["adpit_label"]).cuda()}
    rows = []
    for epoch in range(1, args.epochs + 1):
        run_cfg = copy.deepcopy(cfg)
        run_cfg["trainer"]["max_epochs"] = epoch
        loop.fit(task, dm, run_cfg, Path(tmp.name) / "run")
        errs = [block_errors(x, p, m, dout) for x, p, m, dout, _ in
                reversed(c.record_block_backwards(task, w1, lab1, 72))]
        j, name = max(((j, n) for j, e in enumerate(errs) for n in e),
                      key=lambda jn: errs[jn[0]][jn[1]][0])
        worst = errs[j][name]
        bias_scale = min(e["bias"][3] for e in errs)
        rows.append({"epoch": epoch, "worst_of_plain16": worst[0], "output": name, "block": j,
                     "kernel_of_f32": worst[1], "plain16_of_f32": worst[2],
                     "smallest_bias_grad_scale": bias_scale,
                     "holds_2^-6": worst[0] <= 2.0 ** -6})
        c.log(f"epoch {epoch}: K3 worst {worst[0]:.4g} of the plain bf16 scale ({name}, block "
              f"{j}; 2^-6 = 0.01562); from float32 K3 {worst[1]:.4g}, plain bf16 "
              f"{worst[2]:.4g}; smallest bias grad scale {bias_scale:.3g}")
    tmp.cleanup()
    print(json.dumps({"epochs": rows, "card": smi}))


if __name__ == "__main__":
    main()
