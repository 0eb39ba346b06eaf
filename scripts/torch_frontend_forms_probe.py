#!/usr/bin/env python3
"""Where the time of kernels K9 and K10 (csrc/frontend_{flat,dif}.cu) goes,
on one card, in one or more checkouts.

For each checkout, in a process of its own, builds copies of its K9 and K10
sources under ``_build/forms_probe/`` with one change each, all with one
nvcc each in parallel, and times them at the frontend-forms cell's shape (32
ten-second clips, n_fft 1024, hop 240, hann, float32 out) with CUDA events,
in rounds that alternate the order.

The split-TF32 wgmma design (its ``frontend_common.cuh`` has the FE_* knobs)
gets, besides ``shipped``:

- the phases, each copy with one cut (FE_PROBE; outputs wrong, unchecked):
  ``no_a_loads`` (the waveform fetched for the first k-block only: the A
  staging's copies), ``no_split`` (hi = the raw float, lo = 0: the split's
  arithmetic), ``no_epilogue`` (the per-tile values, mel GEMM and sums: the
  GEMM alone), ``no_table_reads`` (the producer arrives without its TMA
  loads: the tables' L2 reads), ``one_level`` (no running sum: the cost of
  draining the accumulator every two k-blocks), ``bare_gemm`` (the wgmma
  mainloop alone: no loads, split, running sum or epilogue);
- the sweep, each copy checked against the plain version (8e-4 dB / 7e-5 IV)
  and for the shipped copy's bits: ``stages2`` (ring depth; 3 ships: the
  waveform's staging takes the room of deeper rings), ``frames16`` (one consumer warpgroup, 16 frames a block: twice the
  table reads), ``cluster2`` (pairs of CTAs sharing each table tile by TMA
  multicast; run in a child process of its own under a time limit).

With ``--accuracy``, only the arithmetic's variants instead: ``chunk2``,
``chunk4`` (two or four k-blocks summed in the tensor cores before the
running sum; one ships) and ``four_products`` (a_lo b_lo added too), each
timed and held against the float64 DFT and the plain version on
chip_smoke.py's check data (n_fft 512 / hop 100 and 1024 / 240), at each
mel width of ``--mels`` (64 by default; over 64 the kernels' wide form).

The former float32 FMA design gets ``one_level`` (the DFT summed in one
level) and ``one_epilogue`` (the per-tile epilogue run once a block: the
GEMM loop's time), made by editing the copy's text as before.

Prints one line per copy and round, and one JSON line per checkout with the
card's name and power limit, each copy's ms per round and the registers and
spills ptxas reported.

    python3 scripts/torch_frontend_forms_probe.py _archive/parent . --rounds 2
    python3 scripts/torch_frontend_forms_probe.py --accuracy --mels 64 128 256

Needs one CUDA card and nvcc.
"""

import argparse
import json
import subprocess
import sys
from pathlib import Path

# the split-TF32 design's copies: the macros defined before the header
NEW = {"shipped": {}, "no_a_loads": {"FE_PROBE": 1}, "no_split": {"FE_PROBE": 2},
       "no_epilogue": {"FE_PROBE": 4}, "no_table_reads": {"FE_PROBE": 8},
       "one_level": {"FE_PROBE": 16}, "bare_gemm": {"FE_PROBE": 1 | 2 | 4 | 16},
       "stages2": {"FE_STAGES": 2}, "frames16": {"FE_CWG": 1},
       "cluster2": {"FE_CLUSTER": 2}, "chunk2": {"FE_CHUNK": 2}, "chunk4": {"FE_CHUNK": 4},
       "four_products": {"FE_PRODUCTS": 4}}
# the arithmetic's variants, held against the float64 DFT (--accuracy)
ACCURACY = ("shipped", "chunk2", "chunk4", "four_products")
CHECKED = ("shipped", "stages2", "frames16", "cluster2")
ALONE = ("cluster2",)  # run in a child of their own: a new multicast path may hang
# the former design's copies: text edits of its sources
OLD = {"shipped": {}, "one_level": {}, "one_epilogue": {}}

RUN = r'''
import json, sys, torch
from pathlib import Path
sys.path.insert(0, ".")
from pseldnets_tpu_torch.ops import _cuda, frontend_forms

names = json.loads(sys.argv[1]); rounds = int(sys.argv[2])
src = {"K9": frontend_forms.FLAT_KERNEL, "K10": frontend_forms.DIF_KERNEL}
common = (_cuda.CSRC / "frontend_common.cuh").read_text()
new = "FE_PROBE" in common
defines = json.loads(sys.argv[3])
ONE_LEVEL = {"frontend_flat.cu": ("p[r][ci * 4 + e] = kk == 0 ? ar[r] * bl[e] : "
                                  "fmaf(ar[r], bl[e], p[r][ci * 4 + e]);",
                                  "c[r][ci * 4 + e] = fmaf(ar[r], bl[e], c[r][ci * 4 + e]);"),
             "frontend_dif.cu": ("p[r][ci * 4 + e] = kk == 0 ? ar * bl[e] : "
                                 "fmaf(ar, bl[e], p[r][ci * 4 + e]);",
                                 "c[r][ci * 4 + e] = fmaf(ar, bl[e], c[r][ci * 4 + e]);")}

def copy(kernel, name):
    text = kernel.source.read_text()
    edits = [('#include "frontend_common.cuh"', f'#include "{_cuda.CSRC / "frontend_common.cuh"}"')]
    if new:
        head = "".join(f"#define {k} {v}\n" for k, v in defines[name].items())
        edits[0] = (edits[0][0], head + edits[0][1])
    elif name == "one_level":
        edits += [ONE_LEVEL[kernel.source.name], ("c[r][j] += p[r][j];", ";")]
    elif name == "one_epilogue":
        edits += [("if ((s + 1) % ksteps == 0) {", "if (s + 1 == nsteps) {")]
    for old, rep in edits:
        if text.count(old) != 1:
            raise RuntimeError(f"{kernel.source.name} no longer holds one `{old}`")
        text = text.replace(old, rep)
    out = _cuda.BUILD / "forms_probe" / f"{kernel.source.stem}_{name}.cu"
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(text)
    k = _cuda.CudaKernel(kernel.source.name, kernel.functions)
    k.source = out
    return k

kernels = {(f, n): copy(src[f], n) for f in src for n in names}
_cuda.build_all(list(kernels.values()))
regs = {f"{f} {n}": " | ".join(ln.strip() for ln in k.build_log.splitlines()
                               if "registers" in ln or "spill" in ln)
        for (f, n), k in kernels.items()}
torch.backends.cuda.matmul.allow_tf32 = False
x = torch.randn(32, 4, 240000, device="cuda",
                generator=torch.Generator(device="cuda").manual_seed(0)) * 0.1
kw = dict(n_fft=1024, hop=240)
wrap = {"K9": (frontend_forms.logmel_iv_flat, frontend_forms.logmel_iv_flat_plain, "FLAT_KERNEL"),
        "K10": (frontend_forms.logmel_iv_dif, frontend_forms.logmel_iv_dif_plain, "DIF_KERNEL")}

def run(f, n):
    attr = wrap[f][2]
    orig = getattr(frontend_forms, attr)
    setattr(frontend_forms, attr, kernels[f, n])
    try:
        return wrap[f][0](x, **kw)
    finally:
        setattr(frontend_forms, attr, orig)

checks = {}
for f in src:
    ref = wrap[f][1](x, **kw)
    base = run(f, names[0])
    for n in names:
        if n in json.loads(sys.argv[4]):
            got = run(f, n)
            d = (got - ref).abs()
            checks[f"{f} {n}"] = {"db": d[:, :4].max().item(), "iv": d[:, 4:].max().item(),
                                  "bits_of_first": bool(torch.equal(got, base))}
    del ref

def ms(f, n, reps=5):
    run(f, n)
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        run(f, n)
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps

times = {f"{f} {n}": [] for f in src for n in names}
order = [(f, n) for f in src for n in names]
for r in range(rounds):
    for f, n in (order if r % 2 == 0 else order[::-1]):
        times[f"{f} {n}"].append(ms(f, n))
acc = {}
if json.loads(sys.argv[5]):
    # chip_smoke.py's check data: 4 ten-second clips (seed 46, a silent
    # stretch), at n_fft 512 / hop 100 and 1024 / 240, against the float64
    # DFT and the plain version
    from pseldnets_tpu_torch.ops.features import logmel_iv_filterbank, logmel_iv_from_spectrum
    g = torch.Generator(device="cuda").manual_seed(46)
    xa = torch.randn(4, 4, 240000, device="cuda", generator=g) * 0.1
    xa[-1, :, :60000] = 0.0
    for n_fft, hop in ((512, 100), (1024, 240)):
        spec64 = frontend_forms.flat_spectrum(xa.double(), n_fft, hop)
        for n_mels in json.loads(sys.argv[6]):
            kw = dict(n_fft=n_fft, hop=hop, n_mels=n_mels)
            fb64 = torch.as_tensor(logmel_iv_filterbank(24000, n_fft, n_mels), device="cuda")
            f64 = logmel_iv_from_spectrum(*spec64, fb64.double())
            tag = f"{n_fft}/{hop}" + ("" if n_mels == 64 else f" {n_mels} mels")
            for f in src:
                plain = wrap[f][1](xa, **kw)
                for n in names:
                    attr = wrap[f][2]
                    orig = getattr(frontend_forms, attr)
                    setattr(frontend_forms, attr, kernels[f, n])
                    got = wrap[f][0](xa, **kw)
                    setattr(frontend_forms, attr, orig)
                    e = lambda r: (got.double() - r.double()).abs()[:, :4].max().item()
                    acc[f"{f} {n} {tag}"] = {"f64": e(f64), "plain": e(plain)}
                acc[f"{f} plain {tag}"] = {"f64": (plain.double() - f64).abs()[:, :4].max().item()}
            del f64
        del spec64
print(json.dumps({"new": new, "times": times, "checks": checks, "regs": regs, "acc": acc}))
'''


def child(checkout, names, rounds, checked, timeout, accuracy=False, mels=(64,)):
    r = subprocess.run([sys.executable, "-c", RUN, json.dumps(names), str(rounds),
                        json.dumps(NEW), json.dumps(checked), json.dumps(accuracy),
                        json.dumps(list(mels))],
                       cwd=checkout, capture_output=True, text=True, timeout=timeout)
    if r.returncode != 0:
        raise RuntimeError(r.stderr[-4000:])
    return json.loads(r.stdout.strip().splitlines()[-1])


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("checkouts", type=Path, nargs="*", default=[Path(".")])
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--timeout", type=int, default=240,
                    help="seconds for each child process")
    ap.add_argument("--accuracy", action="store_true",
                    help="only the arithmetic's variants, against the float64 DFT on "
                         "chip_smoke.py's check data, and timed")
    ap.add_argument("--mels", type=int, nargs="+", default=[64],
                    help="the mel widths of --accuracy")
    args = ap.parse_args()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(f"card: {smi}", flush=True)
    for checkout in args.checkouts:
        new = "FE_PROBE" in (checkout / "pseldnets_tpu_torch/csrc/frontend_common.cuh").read_text()
        groups = ([[n for n in NEW if n not in ALONE and n not in ACCURACY[1:]]]
                  + [["shipped", n] for n in ALONE] if new else [list(OLD)])
        if new and args.accuracy:
            groups = [list(ACCURACY)]
        out = {"checkout": str(checkout), "card": smi, "design": "split-TF32 wgmma" if new
               else "float32 FMA", "ms": {}, "checks": {}, "regs": {}, "failed": {}}
        for names in groups:
            checked = [n for n in names if n in CHECKED] if new else ["shipped", "one_level"]
            try:
                res = child(checkout, names, args.rounds, checked, args.timeout,
                            args.accuracy and new, args.mels)
            except (RuntimeError, subprocess.TimeoutExpired) as e:
                out["failed"][" ".join(names)] = str(e)[-2000:]
                print(f"{checkout}: {names} failed: {str(e)[-600:]}", flush=True)
                continue
            tag = "" if names == groups[0] else f" (beside {names[-1]})"
            for key, ms in res["times"].items():
                out["ms"][key + tag] = ms
                print(f"{checkout}: {key}{tag}: " + ", ".join(f"{v:.3f}" for v in ms)
                      + f" ms ({smi})", flush=True)
            out["checks"].update(res["checks"])
            out["regs"].update(res["regs"])
            for key, a in res.get("acc", {}).items():
                out.setdefault("acc", {})[key] = a
                print(f"{checkout}: max |dB| of {key}: " + ", ".join(
                    f"vs {k} {v:.3g}" for k, v in a.items()), flush=True)
        for key, c in out["checks"].items():
            ok = (c["db"] <= 8e-4 and c["iv"] <= 7e-5
                  and (c["bits_of_first"] or out["design"] == "float32 FMA"))
            print(f"{checkout}: {key}: vs plain {c['db']:.3g} dB / {c['iv']:.3g} IV, "
                  f"bits of shipped {c['bits_of_first']}{'' if ok else '  <- FAILED'}", flush=True)
        print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
