#!/usr/bin/env python3
"""Tile sweep and probes of kernels K3 and K5 (the Swin block backward,
plain and with AdapterBit adapters, on the Hopper layer
csrc/swin_bwd_sm90.cuh) on one card.

Builds K3 and K5 and probe copies of both (the layer's header and
sm90_gemm.cuh pasted in), each with one change to every GEMM of the layer,
under ``_build/k35_probe/``, all in parallel:
  no_mma   the consumers issue no wgmma (the ring, the TMA loads, the
           epilogues and their stores)
  no_load  the producer loads nothing (the ring turns; wgmma on whatever
           shared memory holds, the epilogues)
  no_epi   the consumers skip the epilogue (no stores, no column sums)

Then, at B=32 and the 12 blocks' (stage, shift) shapes of HTSAT (seeded
random weights, random adapters for K5), for each tile form below
(``swin_block_vjp.TILES`` with one entry changed from the shipped table):
checks K3 and K5 in the full and the AdapterBit training (masked) forms
against their plain versions at B=4 (2^-6 of scale) and a second launch for
equal bits, and times the four x12 (each stage's depth, shifts evenly) with
CUDA events in rounds that alternate the order of the forms. The forms:
  bn_nn, bn_nt, bn_tt            64 (shipped 128) for the recompute,
                                 activation-grad and weight-grad GEMMs
  bn_dual                        128 (shipped 64) for the dual GEMMs
  tt_items                       264 and 528 (shipped 132): the weight
                                 grads' row split
  stages                         ring depth 2 and 3 (shipped: as deep as
                                 shared memory allows, at most 6)
The probes are timed at the shipped form by phase (torch.profiler). Prints
one line per measurement and one JSON line at the end, with the card's name
and power limit.

    python3 scripts/torch_k35_tiles.py --rounds 2

Needs one CUDA card and nvcc.
"""

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from pseldnets_tpu_torch.config import compose  # noqa: E402
from pseldnets_tpu_torch.models.adapters import Adapter, AdaptConfig  # noqa: E402
from pseldnets_tpu_torch.models.factory import init_weights  # noqa: E402
from pseldnets_tpu_torch.models.htsat import SwinTransformerBlock  # noqa: E402
from pseldnets_tpu_torch.ops import _cuda, swin_bwd_plan  # noqa: E402
from pseldnets_tpu_torch.ops import swin_block_adapt as sa  # noqa: E402
from pseldnets_tpu_torch.ops import swin_block_vjp as sv  # noqa: E402

SHAPES = [(i, s) for i in range(4) for s in ((0, 4) if i < 3 else (0,))]
DEPTHS = (2, 2, 6, 2)
SHIPPED = dict(sv.TILES)
FORMS = {"shipped": {}}
for key, values in (("bn_nn", (64,)), ("bn_nt", (64,)), ("bn_tt", (64,)),
                    ("tt_items", (264, 528)), ("stages", (2, 3)),
                    ("bn_dual", (64, 128))):
    FORMS.update({f"{key}={v}": {key: v} for v in values if v != SHIPPED[key]})
ADAPT_TRAINED = ("ln1_b", "qkv_b", "proj_b", "ln2_b", "fc1_b", "fc2_b") + tuple(
    k for keys in sa.ADAPTER_KEYS.values() for k in keys)

HEADER = '#include "swin_bwd_sm90.cuh"'
CORE = '#include "sm90_gemm.cuh"'
PROBES = {  # name: the (old, new) texts of the layer's header it changes
    "no_mma": [("""          bw_mma<BN, FORM, false>(acc, sa, sb, wg, kk, kb > 0 || kk > 0);
          if constexpr (TWO)""", """          if constexpr (false)""")],
    "no_load": [("          mbar_expect_tx(full + 8 * s, T::STAGE);\n",
                 "          mbar_arrive(full + 8 * s);\n"),
                ("          const uint32_t bar = full + 8 * s;\n",
                 "          const uint32_t bar = full + 8 * s;\n          if (false)\n")],
    "no_epi": [("      if (kbs == 0) {  // an empty split: zeros\n",
                "      continue;\n      if (kbs == 0) {  // an empty split: zeros\n")],
}


def probe_kernel(kernel, name):
    """A copy of ``kernel``'s source, the layer's header and sm90_gemm.cuh
    pasted in, with probe ``name``'s change, as a kernel of its own."""
    hdr = (_cuda.CSRC / "swin_bwd_sm90.cuh").read_text()
    src = kernel.source.read_text()
    for old, new in PROBES[name]:
        if hdr.count(old) != 1:
            raise RuntimeError(f"probe {name}: the text it changes is not there once")
        hdr = hdr.replace(old, new)
    if src.count(HEADER) != 1 or hdr.count(CORE) != 1:
        raise RuntimeError(f"probe {name}: the includes it pastes are not there once")
    hdr = hdr.replace(CORE, (_cuda.CSRC / "sm90_gemm.cuh").read_text())
    out = _cuda.BUILD / "k35_probe" / f"{kernel.source.stem}_{name}.cu"
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(src.replace(HEADER, hdr))
    k = _cuda.CudaKernel(kernel.source.name, kernel.functions)
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


def blocks(B, gen, adapt):
    """Per (stage, shift): x, dout, masks, K3's and K5's prepared weights."""
    out = []
    for i, shift in SHAPES:
        H, C, nh = 64 >> i, 96 << i, 4 << i
        x = torch.randn(B, H * H, C, generator=gen).cuda().bfloat16()
        dout = torch.randn(B, H * H, C, generator=gen).cuda().bfloat16()
        m = torch.full((B, 2), 1 / 0.9)
        m[0, 1] = m[1, 0] = 0.0
        blk = SwinTransformerBlock(C, (H, H), nh, 8, shift_size=shift)
        init_weights(blk, gen)
        ablk = SwinTransformerBlock(C, (H, H), nh, 8, shift_size=shift, adapt=adapt)
        init_weights(ablk, gen)
        with torch.no_grad():
            for ad in [mm for mm in ablk.modules() if isinstance(mm, Adapter)]:
                ad.fc2.weight.copy_(torch.randn(ad.fc2.weight.shape, generator=gen) * 0.1)
        out.append((x, dout, m.cuda(), sv.prepare_block(blk.cuda(), torch.bfloat16),
                    sa.prepare_adapt_block(ablk.cuda(), torch.bfloat16)))
    return out


def runs(x, dout, m, p, ap):
    """The four launches timed: K3 and K5, full and AdapterBit's training form."""
    bias_keys = tuple(k for k in sv.GRAD_KEYS if k.endswith("_b"))
    return {"K3": lambda: sv.swin_block_backward(x, p, m, dout),
            "K5": lambda: sa.swin_block_adapt_backward(x, ap, m, dout),
            "K3 masked": lambda: sv.swin_block_backward(x, p, m, dout, bias_keys),
            "K5 masked": lambda: sa.swin_block_adapt_backward(x, ap, m, dout, ADAPT_TRAINED)}


def weight(i):
    return DEPTHS[i] / (2 if i < 3 else 1)


def with_form(form, kernels=None):
    """TILES set to the shipped table with ``form``'s changes (and the two
    kernels to ``kernels``); returns a function that restores both."""
    saved = (sv.KERNEL, sa.BWD_KERNEL)
    sv.TILES.clear()
    sv.TILES.update(SHIPPED, **FORMS[form])
    if kernels is not None:
        sv.KERNEL, sa.BWD_KERNEL = kernels

    def restore():
        sv.TILES.clear()
        sv.TILES.update(SHIPPED)
        sv.KERNEL, sa.BWD_KERNEL = saved
    return restore


def check(form, small):
    """K3 and K5, full and masked, against the plain versions at B=4 and a
    second launch bitwise; returns the worst error as a share of scale."""
    worst = 0.0
    for (i, shift), (x, dout, m, p, ap) in zip(SHAPES, small):
        for name, fn in runs(x, dout, m, p, ap).items():
            want = None if "masked" not in name else (
                tuple(k for k in sv.GRAD_KEYS if k.endswith("_b")) if name.startswith("K3")
                else ADAPT_TRAINED)
            plain = (sv.swin_block_backward_plain(x, p, m, dout, want) if name.startswith("K3")
                     else sa.swin_block_adapt_backward_plain(x, ap, m, dout, want))
            (dx, g), (dx2, g2) = fn(), fn()
            torch.cuda.synchronize()
            same = torch.equal(dx, dx2) and all(torch.equal(g[k], g2[k]) for k in g)
            for k, a, b in [("dx", dx, plain[0])] + [(k, g[k], plain[1][k]) for k in plain[1]]:
                err = (a.float() - b.float()).abs().max().item() / max(
                    b.float().abs().max().item(), 1e-30)
                worst = max(worst, err)
                if err > 2.0 ** -6 or not same:
                    raise SystemExit(f"{name} {form} stage {i} shift {shift} {k}: {err:.3g} "
                                     f"of scale, repeat bitwise {same}")
    return worst


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("torch_k35_tiles: CUDA is not available")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(f"card: {smi}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    probes = {name: (probe_kernel(sv.KERNEL, name), probe_kernel(sa.BWD_KERNEL, name))
              for name in PROBES}
    t0 = time.perf_counter()
    _cuda.build_all([sv.KERNEL, sa.BWD_KERNEL, *(k for ks in probes.values() for k in ks)])
    print(f"build of K3, K5 and their {2 * len(probes)} probe copies (in parallel): "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    adapt = AdaptConfig(compose(str(ROOT / "configs"), "train", ["adapt=adapter"])["adapt"])
    gen = torch.Generator().manual_seed(41)
    small, data = blocks(4, gen, adapt), blocks(32, gen, adapt)

    worst = 0.0
    for form in FORMS:
        restore = with_form(form)
        try:
            worst = max(worst, check(form, small))
        finally:
            restore()
    print(f"every form within {worst:.3g} of scale of the plain versions (<= 2^-6), two "
          f"launches bitwise equal", flush=True)

    times = {form: [] for form in FORMS}
    for rnd in range(args.rounds):
        order = list(FORMS) if rnd % 2 == 0 else list(FORMS)[::-1]
        for form in order:
            restore = with_form(form)
            try:
                row = {}
                for (i, _), d in zip(SHAPES, data):
                    for name, fn in runs(*d).items():
                        row[name] = row.get(name, 0.0) + weight(i) * cuda_ms(fn)
            finally:
                restore()
            times[form].append(row)
            print(f"round {rnd} {form}: " + ", ".join(f"{k} x12 {v:.3f}" for k, v in row.items())
                  + " ms", flush=True)
    probe_phases = {}
    for name, ks in [("shipped", None)] + list(probes.items()):
        restore = with_form("shipped", ks)
        try:
            by = {}
            for (i, _), d in zip(SHAPES, data):
                for kname, fn in runs(*d).items():
                    if "masked" in kname:
                        continue
                    for ph, v in swin_bwd_plan.phases_ms(fn).items():
                        key = f"{kname} {ph}"
                        by[key] = by.get(key, 0.0) + weight(i) * v
        finally:
            restore()
        probe_phases[name] = by
        print(f"by phase x12, {name}: " + ", ".join(f"{k} {v:.3f}" for k, v in sorted(by.items()))
              + " ms", flush=True)
    print(json.dumps({"card": smi, "shipped": SHIPPED, "worst_err_of_scale": worst,
                      "x12_ms": times, "phases_x12_ms": probe_phases}))


if __name__ == "__main__":
    main()
