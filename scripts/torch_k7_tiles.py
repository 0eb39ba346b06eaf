#!/usr/bin/env python3
"""Tile sweep and probes of kernel K7 (csrc/conv_block.cu, the CNN trunk's
ConvBlock as a TMA-fed wgmma implicit GEMM) on one card.

Builds K7 and two probe copies of its source (sm90_gemm.cuh pasted in), each
with one change, under ``_build/k7_probe/``, all in parallel:
  no_mma   the consumers issue no wgmma (the ring, the TMA loads, the
           epilogue and its stores)
  no_load  the producer loads nothing (the ring turns; wgmma on whatever
           shared memory holds, the epilogue)

Then, at the CRNN trunk's six ConvBlocks (pair mode, B=32, 10 s clips: the
shapes of chip_smoke.py's CRNN_BLOCKS, the stem's 7 channels padded to 8),
for each tile form below (``conv_block.TILES`` with one entry changed from
the shipped table): checks K7 against its plain version (2^-6 of scale) and
a second launch for equal bits, and times each ConvBlock with CUDA events in
rounds that alternate the order of the forms. The forms:
  bn_cout64   the stem's two convs (Cout 64): 64 cooperative, 64 ping-pong
              (-64)
  bn_cout128  block 1 (Cout 128): 128, 256 cooperative, 128 ping-pong
  bn_wider    blocks 2-5 (Cout 256-2048): 128, 192, 256 cooperative, 128
              ping-pong
  bk_cin16    the stem's conv1 (Cin 8): K steps of 16 or 64 channels
  stages      ring depth 3 or 4 (0: as deep as shared memory allows)
  resident    the stem's weights resident in shared memory, its A boxes
              serving three taps each (True), or the ring of one box and
              one weight tile per tap (False)
A cuDNN conv pair per ConvBlock (``F.conv2d`` + ReLU twice, bf16,
channels_last) and the two probes at the shipped form are timed once beside
them. Prints one line per measurement and one JSON line at the end, with the
card's name and power limit.

    python3 scripts/torch_k7_tiles.py --rounds 2

Needs one CUDA card and nvcc.
"""

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from pseldnets_tpu_torch.ops import _cuda, conv_block  # noqa: E402

BLOCKS = ((1001, 64, 7, 64), (500, 32, 64, 128), (250, 16, 128, 256), (125, 8, 256, 512),
          (125, 4, 512, 1024), (125, 2, 1024, 2048))
B = 32
SHIPPED = dict(conv_block.TILES)
# name -> the TILES entries it changes
FORMS = {"shipped": {}}
for key, values in (("bn_cout64", (64, -64)), ("bn_cout128", (128, -128, 256)),
                    ("bn_wider", (128, 192, 256, -128)), ("bk_cin16", (16, 64)),
                    ("stages", (3, 4)), ("resident", (True, False))):
    FORMS.update({f"{key}={v}": {key: v} for v in values if v != SHIPPED[key]})

WGMMA = """              wgmma_ss<BN, 1>(acc[h], da + (64 * C::ROW_BYTES >> 4) * h + 2 * kk,
                              db + 128 * kk, ks > 0 || dt > 0 || kk > 0);"""
LOADS = "          mbar_expect_tx(full + 8 * s, bytes);\n"
PROBES = {"no_mma": (WGMMA, "              ;"),
          "no_load": (LOADS, "          mbar_arrive(full + 8 * s);\n          if (false)\n")}


def probe_kernel(name):
    """A copy of conv_block.cu, sm90_gemm.cuh pasted in, with probe
    ``name``'s change, as a kernel of its own."""
    old, new = PROBES[name]
    inc = '#include "sm90_gemm.cuh"'
    src = (_cuda.CSRC / "conv_block.cu").read_text()
    if src.count(old) != 1 or src.count(inc) != 1:
        raise RuntimeError(f"probe {name}: the text it changes is not in conv_block.cu once")
    out = _cuda.BUILD / "k7_probe" / f"{name}.cu"
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(src.replace(old, new).replace(inc, (_cuda.CSRC / "sm90_gemm.cuh").read_text()))
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


def with_form(form, kernel=None):
    """Set conv_block.TILES to the shipped table with ``form``'s changes
    (and conv_block.KERNEL to ``kernel``); returns a function that restores
    both."""
    launch = conv_block.KERNEL
    conv_block.TILES.clear()
    conv_block.TILES.update(SHIPPED, **FORMS[form])
    if kernel is not None:
        conv_block.KERNEL = kernel

    def restore():
        conv_block.TILES.clear()
        conv_block.TILES.update(SHIPPED)
        conv_block.KERNEL = launch
    return restore


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("torch_k7_tiles: CUDA is not available")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(f"card: {smi}", flush=True)
    torch.backends.cudnn.allow_tf32 = False
    probes = {name: probe_kernel(name) for name in PROBES}
    t0 = time.perf_counter()
    _cuda.build_all([conv_block.KERNEL, *probes.values()])
    print(f"build of conv_block.cu and its {len(probes)} probe copies (in parallel): "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    for k in (conv_block.KERNEL, *probes.values()):
        for line in k.build_log.splitlines():
            if "registers" in line or "spill" in line or "arning" in line or "C75" in line:
                print(f"  {k.source.name}: {line.strip()}", flush=True)

    g = torch.Generator().manual_seed(0)
    data = []
    for T, Fq, cin, cout in BLOCKS:
        cp = conv_block.padded_channels(cin)
        x = torch.randn(B, T, Fq, cp, generator=g)
        x[..., cin:] = 0.0
        w1 = torch.randn(3, 3, cp, cout, generator=g) / (9 * cin) ** 0.5
        w1[:, :, cin:] = 0.0
        w2 = torch.randn(3, 3, cout, cout, generator=g) / (9 * cout) ** 0.5
        b1 = (torch.randn(cout, generator=g) * 0.5 + 0.5).cuda()
        b2 = (torch.randn(cout, generator=g) * 0.5).cuda()
        x, w1, w2 = (t.cuda().bfloat16() for t in (x, w1, w2))
        ref = conv_block.conv3x3_bias_relu_plain(x, w1, b1, w2, b2).float()
        xl = x.permute(0, 3, 1, 2)
        wl1, wl2 = (w.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
                    for w in (w1, w2))
        lib = cuda_ms(lambda: F.relu(F.conv2d(F.relu(F.conv2d(xl, wl1, b1.bfloat16(), padding=1)),
                                              wl2, b2.bfloat16(), padding=1)))
        flops = 2 * B * T * Fq * 9 * cout * (cin + cout)
        data.append(((x, w1, b1, w2, b2), ref, flops, lib))
    print("cuDNN pair per ConvBlock ms: " + ", ".join(f"{d[3]:.3f}" for d in data)
          + f"; x6 {sum(d[3] for d in data):.3f}", flush=True)

    # every form against the plain version, and a second launch bitwise
    worst = 0.0
    for form in FORMS:
        restore = with_form(form)
        try:
            for i, (a, ref, _, _) in enumerate(data):
                got = conv_block.conv3x3_bias_relu(*a)
                again = conv_block.conv3x3_bias_relu(*a)
                torch.cuda.synchronize()
                err = (got.float() - ref).abs().max().item() / ref.abs().max().item()
                worst = max(worst, err)
                if err > 2.0 ** -6 or not torch.equal(got, again):
                    raise SystemExit(f"K7 {form} block {i}: {err:.3g} of scale from the plain "
                                     f"version, repeat bitwise {torch.equal(got, again)}")
        finally:
            restore()
    print(f"every form within {worst:.3g} of scale of the plain version (<= 2^-6), "
          f"two launches bitwise equal", flush=True)

    times = {form: [] for form in FORMS}
    for rnd in range(args.rounds):
        order = list(FORMS) if rnd % 2 == 0 else list(FORMS)[::-1]
        for form in order:
            restore = with_form(form)
            try:
                row = [cuda_ms(lambda: conv_block.conv3x3_bias_relu(*a)) for a, *_ in data]
            finally:
                restore()
            times[form].append(row)
            print(f"round {rnd} {form}: " + ", ".join(
                f"{t:.3f} ({d[2] / t / 1e9:.0f})" for t, d in zip(row, data))
                + f" ms (TFLOP/s); x6 {sum(row):.3f} ms", flush=True)
    probe_times = {}
    for name, k in probes.items():
        restore = with_form("shipped", k)
        try:
            probe_times[name] = [cuda_ms(lambda: conv_block.conv3x3_bias_relu(*a))
                                 for a, *_ in data]
        finally:
            restore()
        print(f"probe {name} at the shipped form: " + ", ".join(
            f"{t:.3f}" for t in probe_times[name]) + f" ms; x6 {sum(probe_times[name]):.3f}",
            flush=True)
    print(json.dumps({"card": smi, "shipped": SHIPPED, "worst_err_of_scale": worst,
                      "k7_ms_by_block": times, "probe_ms_by_block": probe_times,
                      "cudnn_ms_by_block": [d[3] for d in data]}))


if __name__ == "__main__":
    main()
