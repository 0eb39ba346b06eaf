#!/usr/bin/env python3
"""Tile sweep of kernels K2 and K11 (the Swin block forward and the whole
eval stage, on the Hopper forward layer csrc/swin_fwd_sm90.cuh) on one card.

1. Each GEMM of the block alone (``swin_block.fwd_gemm``) at B=32 and each
   of HTSAT's stage shapes (qkv, proj with its residual through the shifted
   window -> token map, fc1 with GELU, fc2 with its residual, the merge of
   stages 0-2), in each form: tile width 64, 128 and 192 at the deepest
   ring, and ring depth 2, 3 and 4 at the shipped width (one change to
   ``swin_block.TILES`` a form). Every form is held against its plain
   version (2^-7 of the output's largest magnitude) and a second launch for
   equal bits, then timed with CUDA events in rounds that alternate the
   order of the forms.
2. The whole table: the shipped ``TILES`` and the table that takes each
   GEMM's fastest width (medians over the rounds; of the widths K11 takes
   for the GEMMs it shares with K2), each checked (K2 against
   its plain version at B=4 at every served and trained block form, 2^-6 of
   scale, and a second launch for equal bits; K11 bitwise equal to K2
   chained at every stage) and timed in rounds: K2 x12 served and with
   masks, and K11 x4, at B=32.
Prints one line per measurement and one JSON line at the end, with the
card's name and power limit.

    python3 scripts/torch_k2_tiles.py --rounds 2

Needs one CUDA card and nvcc.
"""

import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from pseldnets_tpu_torch.models.factory import init_weights  # noqa: E402
from pseldnets_tpu_torch.models.htsat import (BasicLayer, PatchMerging,  # noqa: E402
                                              SwinTransformerBlock)
from pseldnets_tpu_torch.ops import _cuda, swin_block, swin_fwd_plan, swin_stage  # noqa: E402

B = 32
DEPTHS = (2, 2, 6, 2)
SHIPPED = {C: dict(t) for C, t in swin_block.TILES.items()}
GEMMS = ("qkv", "proj", "fc1", "fc2", "merge")


def cuda_ms(fn, reps=10):
    fn()
    torch.cuda.synchronize()
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / reps


def gemm_case(stage, name, gen):
    """A GEMM of a stage-``stage`` block at B=32: (kernel kwargs, plain
    kwargs, a, w, bias)."""
    H, C = 64 >> stage, 96 << stage
    M, L = B * H * H, H * H
    K, N = {"qkv": (C, 3 * C), "proj": (C, C), "fc1": (C, 4 * C), "fc2": (4 * C, C),
            "merge": (4 * C, 2 * C)}[name]
    if name == "merge":
        M //= 4
    a = torch.randn(M, K, generator=gen).cuda().bfloat16()
    w = (torch.randn(K, N, generator=gen) / K ** 0.5).cuda().bfloat16()
    bias = None if name == "merge" else (torch.randn(N, generator=gen) * 0.3).cuda()
    kw, plain = {"gelu": name == "fc1"}, {"gelu": name == "fc1"}
    if name in ("proj", "fc2"):
        resid = torch.randn(M, N, generator=gen).cuda().bfloat16()
        kw.update(resid=resid, L=L)
        plain.update(resid=resid, L=L)
        if name == "proj":
            shift = 4 if stage < 3 else 0
            kw["geometry"] = (H, H, 8, shift)
            plain["rows_out"] = swin_fwd_plan.window_rows(B, H, H, 8, shift)
    return kw, plain, a, w, bias


def gemm_forms(C, name):
    """(label, bn, stages) forms of one GEMM: each width at the deepest
    ring, each ring depth at the shipped width."""
    t = SHIPPED.get(C, swin_block.DEFAULT_TILES)
    return ([(f"bn={bn}", bn, 0) for bn in swin_fwd_plan.BNS]
            + [(f"stages={s}", t[name], s) for s in (2, 3, 4)])


def sweep_gemms(rounds, gen):
    cases = {}
    for i in range(4):
        for name in GEMMS:
            if name == "merge" and i == 3:
                continue
            cases[(i, name)] = gemm_case(i, name, gen)
    # checks, once per form
    for (i, name), (kw, plain, a, w, bias) in cases.items():
        ref = swin_block.fwd_gemm_plain(a, w, bias, **plain).float()
        for label, bn, st in gemm_forms(96 << i, name):
            got = swin_block.fwd_gemm(a, w, bias, bn=bn, stages=st, **kw)
            again = swin_block.fwd_gemm(a, w, bias, bn=bn, stages=st, **kw)
            err = (got.float() - ref).abs().max().item() / ref.abs().max().item()
            ok = torch.equal(got, again) and err <= 2.0 ** -7
            print(f"check stage {i} {name} {label}: {err:.3g} of scale, equal bits "
                  f"{torch.equal(got, again)}", flush=True)
            if not ok:
                sys.exit(f"stage {i} {name} {label} disagrees with its plain version")
    times = {}
    for rnd in range(rounds):
        keys = list(cases)
        for i, name in (keys if rnd % 2 == 0 else keys[::-1]):
            kw, _, a, w, bias = cases[(i, name)]
            forms = gemm_forms(96 << i, name)
            for label, bn, st in (forms if rnd % 2 == 0 else forms[::-1]):
                ms = cuda_ms(lambda: swin_block.fwd_gemm(a, w, bias, bn=bn, stages=st, **kw))
                times.setdefault(f"{i}|{name}|{label}", []).append(ms)
    best = {}
    for (i, name) in cases:
        row = {label: statistics.median(times[f"{i}|{name}|{label}"])
               for label, _, _ in gemm_forms(96 << i, name)}
        widths = {int(k[3:]): v for k, v in row.items() if k.startswith("bn=")}
        best[(i, name)] = min(widths, key=widths.get)
        print(f"stage {i} {name}: " + ", ".join(f"{k} {v:.4f}" for k, v in row.items())
              + f" ms; fastest width {best[(i, name)]}", flush=True)
    return times, best


def blocks(gen):
    """HTSAT's twelve served blocks (merges folded) and their training
    forms, full width, seeded weights: (stage, shift, merge) -> block,
    merge module."""
    out = {}
    for i in range(4):
        H, C, nh = 64 >> i, 96 << i, 4 << i
        for d in range(DEPTHS[i]):
            shift = 4 if (d % 2 and i < 3) else 0
            merge = i < 3 and d == DEPTHS[i] - 1
            blk = SwinTransformerBlock(C, (H, H), nh, 8, shift_size=shift)
            init_weights(blk, gen)
            mrg = None
            if merge:
                mrg = PatchMerging((H, H), C)
                init_weights(mrg, gen)
                mrg = mrg.cuda().eval()
            out[(i, d)] = (blk.cuda().eval(), mrg)
    return out


def set_table(table):
    swin_block.TILES.clear()
    swin_block.TILES.update({C: dict(t) for C, t in table.items()})


def check_table(table, blks, stages, gen):
    """K2 at B=4 against its plain version (served and with masks) and for
    equal bits; K11 bitwise equal to K2 chained at B=4."""
    set_table(table)
    m = torch.full((4, 2), 1 / 0.9)
    m[0, 1] = m[1, 0] = 0.0
    m = m.cuda()
    for (i, d), (blk, mrg) in blks.items():
        H, C = 64 >> i, 96 << i
        x = torch.randn(4, H * H, C, generator=gen).cuda().bfloat16()
        for p, mm in ((swin_block.prepare_block(blk, torch.bfloat16, mrg), None),
                      (swin_block.prepare_block(blk, torch.bfloat16), m)):
            got = swin_block.swin_block_fused(x, p, mm)
            again = swin_block.swin_block_fused(x, p, mm)
            ref = swin_block.swin_block_plain(x, p, mm).float()
            err = (got.float() - ref).abs().max().item() / ref.abs().max().item()
            if not torch.equal(got, again) or err > 2.0 ** -6:
                sys.exit(f"K2 stage {i} block {d}: {err:.3g} of scale, equal bits "
                         f"{torch.equal(got, again)}")
    for i, sp in enumerate(stages):
        x = torch.randn(4, sp.H * sp.W, sp.C, generator=gen).cuda().bfloat16()
        got = swin_stage.swin_stage_fused(x, sp)
        xs = x
        for d in range(sp.depth):
            xs = swin_block.swin_block_fused(xs, sp.block(d))
        if not torch.equal(got, xs):
            sys.exit(f"K11 stage {i} differs from K2 chained")


def time_table(blks, stages, xs, m):
    served = train = 0.0
    for (i, d), (blk, mrg) in blks.items():
        p = swin_block.prepare_block(blk, torch.bfloat16, mrg)
        p2 = swin_block.prepare_block(blk, torch.bfloat16)
        served += cuda_ms(lambda: swin_block.swin_block_fused(xs[i], p), reps=5)
        train += cuda_ms(lambda: swin_block.swin_block_fused(xs[i], p2, m), reps=5)
    k11 = sum(cuda_ms(lambda: swin_stage.swin_stage_fused(xs[i], sp), reps=5)
              for i, sp in enumerate(stages))
    return {"k2_served_x12": served, "k2_train_x12": train, "k11_x4": k11}


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip().splitlines()[0]
    print(f"card: {smi}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    _cuda.build_all([swin_block.KERNEL, swin_stage.KERNEL])
    gen = torch.Generator().manual_seed(17)
    times, best = sweep_gemms(args.rounds, gen)

    fastest = {C: dict(t) for C, t in SHIPPED.items()}
    for (i, name), bn in best.items():
        fastest[96 << i][name] = bn
        if name != "merge" and bn not in swin_fwd_plan.STAGE_BNS:  # K11 takes K2's widths
            row = {w: statistics.median(times[f"{i}|{name}|bn={w}"])
                   for w in swin_fwd_plan.STAGE_BNS}
            fastest[96 << i][name] = min(row, key=row.get)
    blks = blocks(gen)
    stages = []
    for i in range(4):
        layer = BasicLayer(96 << i, (64 >> i, 64 >> i), DEPTHS[i], 4 << i, 8)
        init_weights(layer, gen)
        stages.append(swin_stage.prepare_stage(layer.cuda().eval(), torch.bfloat16))
    xs = [torch.randn(B, (64 >> i) ** 2, 96 << i, generator=gen).cuda().bfloat16()
          for i in range(4)]
    m = torch.full((B, 2), 1 / 0.9)
    m[0, 1] = m[1, 0] = 0.0
    m = m.cuda()
    tables = {"shipped": SHIPPED, "fastest": fastest}
    for name, table in tables.items():
        check_table(table, blks, stages, gen)
        print(f"table {name}: {json.dumps({str(C): t for C, t in table.items()})}; checked",
              flush=True)
    whole = {}
    for rnd in range(args.rounds):
        for name in (list(tables) if rnd % 2 == 0 else list(tables)[::-1]):
            set_table(tables[name])
            for k, v in time_table(blks, stages, xs, m).items():
                whole.setdefault(name, {}).setdefault(k, []).append(v)
    set_table(SHIPPED)
    for name, r in whole.items():
        print(f"table {name} ({smi}): " + ", ".join(
            f"{k} {statistics.median(v):.3f} ms ({', '.join(f'{x:.3f}' for x in v)})"
            for k, v in r.items()), flush=True)
    print(json.dumps({"card": smi, "gemms": times,
                      "fastest": {f"{i}|{n}": bn for (i, n), bn in best.items()},
                      "tables": {k: {str(C): t for C, t in v.items()} for k, v in tables.items()},
                      "whole": whole}))


if __name__ == "__main__":
    main()
