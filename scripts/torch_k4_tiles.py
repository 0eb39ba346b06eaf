#!/usr/bin/env python3
"""Tile sweep of kernel K4 (the Swin block with AdapterBit adapters,
forward, on the Hopper forward layer csrc/swin_fwd_sm90.cuh) on one card.

1. Each GEMM of the block alone (``swin_block_adapt.adapt_gemm``, K4's own
   library) at B=32 and each of HTSAT's stage shapes, the adapter at
   configs/adapt/adapter.yaml's width padded to 32 (64, 96, 192, 384): qkv,
   proj through the shifted window -> token map, sa1 with GELU (N = ch),
   sa2 into the float32 y (F_BRANCH, K = ch), fc1 and ma1 with GELU, fc2
   and ma2 on one tile (F_ADAPT_OUT). In each form: tile width 64, 128 and
   192 at the deepest ring (the float32 forms sa2 and fc2 + ma2: 64 only),
   and ring depth 2, 3 and 4 at the shipped width (one change to
   ``swin_block_adapt.TILES`` a form).
   Every form is held against its plain version (2^-7 of the output's
   largest magnitude) and a second launch for equal bits, then timed on the
   device (CUDA events around 20 calls queued behind a sleeping kernel: a
   Python call costs the host more than many of these launches take) in
   rounds that alternate the order of the forms.
2. The whole table: the shipped ``TILES`` and the table that takes each
   GEMM's fastest width (medians over the rounds), each checked (K4 against
   its plain version at B=4 at every block form, served and with masks,
   2^-6 of scale, and a second launch for equal bits) and timed in rounds:
   K4 x12 served and with masks at B=32, with CUDA events around the calls
   as they are launched and as queued behind a sleeping kernel.
Prints one line per measurement and one JSON line at the end, with the
card's name and power limit.

    python3 scripts/torch_k4_tiles.py --rounds 2

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

from pseldnets_tpu_torch.config import compose  # noqa: E402
from pseldnets_tpu_torch.models.adapters import AdaptConfig  # noqa: E402
from pseldnets_tpu_torch.models.factory import init_weights  # noqa: E402
from pseldnets_tpu_torch.models.htsat import SwinTransformerBlock  # noqa: E402
from pseldnets_tpu_torch.ops import _cuda, swin_block, swin_fwd_plan  # noqa: E402
from pseldnets_tpu_torch.ops import swin_block_adapt as sa  # noqa: E402

B = 32
DEPTHS = (2, 2, 6, 2)
SHIPPED = {C: dict(t) for C, t in sa.TILES.items()}
GEMMS = ("qkv", "proj", "sa1", "sa2", "fc1", "ma1", "fc2")
S = 0.1  # the adapter scalar (configs/adapt/adapter.yaml)


def device_ms(fn, reps=20):
    """Device ms of one call of fn: CUDA events around ``reps`` calls queued
    behind a kernel that sleeps while the host launches them (so the host's
    cost a call does not show)."""
    fn()
    torch.cuda.synchronize()
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(100_000_000)  # ~60 ms at the card's clock
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / reps


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
    """A GEMM of a stage-``stage`` block at B=32: (kernel call of (bn,
    stages), its plain output)."""
    H, C = 64 >> stage, 96 << stage
    ch = -(-C // 2 // 32) * 32
    M, L = B * H * H, H * H
    K, N = {"qkv": (C, 3 * C), "proj": (C, C), "sa1": (C, ch), "sa2": (ch, C),
            "fc1": (C, 4 * C), "ma1": (C, ch), "fc2": (4 * C, C)}[name]
    rnd = lambda *shape: torch.randn(*shape, generator=gen).cuda()  # noqa: E731
    a, w, bias = rnd(M, K).bfloat16(), (rnd(K, N) / K ** 0.5).bfloat16(), rnd(N) * 0.3
    masks = torch.full((B, 2), 1 / 0.9)
    masks[0, 1] = masks[1, 0] = 0.0
    masks = masks.cuda()
    if name in ("qkv", "proj", "sa1", "fc1", "ma1"):
        form, kw, plain = "out", {"gelu": name in ("sa1", "fc1", "ma1")}, {}
        plain.update(kw)
        if name == "proj":
            shift = 4 if stage < 3 else 0
            kw["geometry"] = (H, H, 8, shift)
            plain["rows_out"] = swin_fwd_plan.window_rows(B, H, H, 8, shift)
        ref = swin_block.fwd_gemm_plain(a, w, bias, **plain)
    elif name == "sa2":
        form = "branch"
        x, add = rnd(M, N).bfloat16(), rnd(M, N).bfloat16()
        kw = dict(x=x, add=add, masks=masks, col=0, s=S, L=L)
        ref = sa.branch_gemm_plain(a, w, bias, x, add, masks[:, 0], S, L)
    else:
        form = "adapt_out"
        a1, w1, bias1 = rnd(M, ch).bfloat16(), (rnd(ch, N) / ch ** 0.5).bfloat16(), rnd(N) * 0.3
        kw = dict(a1=a1, w1=w1, bias1=bias1, y=rnd(M, N), masks=masks, col=1, s=S, L=L)
        ref = sa.adapt_out_gemm_plain(a, w, bias, a1, w1, bias1, kw["y"], masks[:, 1], S, L)
    return (lambda bn, st: sa.adapt_gemm(form, a, w, bias, bn=bn, stages=st, **kw)), ref.float()


def gemm_forms(C, name):
    """(label, bn, stages) forms of one GEMM: each width at the deepest
    ring, each ring depth at the shipped width."""
    if name in ("sa2", "fc2"):  # the float32 forms
        widths, width = (swin_fwd_plan.F32_BN,), swin_fwd_plan.F32_BN
    else:
        widths, width = swin_fwd_plan.BNS, SHIPPED.get(C, sa.DEFAULT_TILES)[name]
    return ([(f"bn={bn}", bn, 0) for bn in widths]
            + [(f"stages={s}", width, s) for s in (2, 3, 4)])


def sweep_gemms(rounds, gen):
    cases = {(i, name): gemm_case(i, name, gen) for i in range(4) for name in GEMMS}
    for (i, name), (run, ref) in cases.items():  # checks, once per form
        for label, bn, st in gemm_forms(96 << i, name):
            got, again = run(bn, st), run(bn, st)
            err = (got.float() - ref).abs().max().item() / ref.abs().max().item()
            print(f"check stage {i} {name} {label}: {err:.3g} of scale, equal bits "
                  f"{torch.equal(got, again)}", flush=True)
            if not torch.equal(got, again) or err > 2.0 ** -7:
                sys.exit(f"stage {i} {name} {label} disagrees with its plain version")
    times = {}
    for rnd in range(rounds):
        keys = list(cases)
        for i, name in (keys if rnd % 2 == 0 else keys[::-1]):
            run = cases[(i, name)][0]
            forms = gemm_forms(96 << i, name)
            for label, bn, st in (forms if rnd % 2 == 0 else forms[::-1]):
                times.setdefault(f"{i}|{name}|{label}", []).append(
                    device_ms(lambda: run(bn, st)))
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
    """The AdapterBit HTSAT's twelve blocks, full width, seeded weights and
    random adapters: (stage, depth) -> the prepared bf16 block."""
    adapt = AdaptConfig(compose(str(ROOT / "configs"), "train", ["adapt=adapter"])["adapt"])
    out = {}
    for i in range(4):
        H, C, nh = 64 >> i, 96 << i, 4 << i
        for d in range(DEPTHS[i]):
            blk = SwinTransformerBlock(C, (H, H), nh, 8, shift_size=4 if d % 2 and i < 3 else 0,
                                       adapt=adapt)
            init_weights(blk, gen)
            with torch.no_grad():
                for ad in sa.block_adapters(blk).values():
                    ad.fc2.weight.copy_(torch.randn(ad.fc2.weight.shape, generator=gen) * 0.1)
            out[(i, d)] = sa.prepare_adapt_block(blk.cuda(), torch.bfloat16)
    return out


def set_table(table):
    sa.TILES.clear()
    sa.TILES.update({C: dict(t) for C, t in table.items()})


def check_table(table, blks, gen):
    set_table(table)
    m = torch.full((4, 2), 1 / 0.9)
    m[0, 1] = m[1, 0] = 0.0
    m = m.cuda()
    for (i, d), p in blks.items():
        x = torch.randn(4, (64 >> i) ** 2, 96 << i, generator=gen).cuda().bfloat16()
        for mm in (None, m):
            got, again = sa.swin_block_adapt_fused(x, p, mm), sa.swin_block_adapt_fused(x, p, mm)
            ref = sa.swin_block_adapt_plain(x, p, mm).float()
            err = (got.float() - ref).abs().max().item() / ref.abs().max().item()
            if not torch.equal(got, again) or err > 2.0 ** -6:
                sys.exit(f"K4 stage {i} block {d}: {err:.3g} of scale, equal bits "
                         f"{torch.equal(got, again)}")


def time_table(blks, xs, m):
    out = {}
    for form, mm in (("served", None), ("train", m)):
        calls = [lambda i=i, p=p: sa.swin_block_adapt_fused(xs[i], p, mm)
                 for (i, _), p in blks.items()]
        out[f"k4_{form}_x12"] = sum(cuda_ms(f, reps=5) for f in calls)
        out[f"k4_{form}_x12_queued"] = sum(device_ms(f, reps=5) for f in calls)
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip().splitlines()[0]
    print(f"card: {smi}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    _cuda.build_all([sa.FWD_KERNEL])
    gen = torch.Generator().manual_seed(17)
    times, best = sweep_gemms(args.rounds, gen)
    fastest = {C: dict(t) for C, t in SHIPPED.items()}
    for (i, name), bn in best.items():
        if name in swin_fwd_plan.ADAPT_TILE_KEYS:  # the float32 forms' width is fixed
            fastest[96 << i][name] = bn
    blks = blocks(gen)
    xs = [torch.randn(B, (64 >> i) ** 2, 96 << i, generator=gen).cuda().bfloat16()
          for i in range(4)]
    m = torch.full((B, 2), 1 / 0.9)
    m[0, 1] = m[1, 0] = 0.0
    m = m.cuda()
    tables = {"shipped": SHIPPED, "fastest": fastest}
    for name, table in tables.items():
        check_table(table, blks, gen)
        print(f"table {name}: {json.dumps({str(C): t for C, t in table.items()})}; checked",
              flush=True)
    whole = {}
    for rnd in range(args.rounds):
        for name in (list(tables) if rnd % 2 == 0 else list(tables)[::-1]):
            set_table(tables[name])
            for k, v in time_table(blks, xs, m).items():
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
