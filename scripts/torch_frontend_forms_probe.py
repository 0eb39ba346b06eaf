#!/usr/bin/env python3
"""Where the time of kernels K9 and K10 (csrc/frontend_{flat,dif}.cu) goes,
on one card.

Builds copies of each source with one change each and times them at the
frontend-forms cell's shape (32 ten-second clips, n_fft 1024, hop 240, hann,
float32 out) with CUDA events, in rounds that alternate the order:

- ``shipped``: the source as it is;
- ``one_level``: the DFT summed in one level (every product into the running
  sum; the two-level partials and their 64 registers gone);
- ``one_epilogue``: the per-tile epilogue (per-bin values, the DIF 3-tap,
  the mel scatter and their barriers) run once per block instead of once per
  column tile, so the time left is the GEMM loop's (the output is wrong and
  is not checked).

``shipped`` and ``one_level`` are checked against the plain versions (8e-4 dB
/ 7e-5 IV). Prints one line per variant and round, then one JSON line with
each variant's ms per round.

    python3 scripts/torch_frontend_forms_probe.py --rounds 2

Needs one CUDA card and nvcc.
"""

import argparse
import json
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from pseldnets_tpu_torch.ops import _cuda, frontend_forms  # noqa: E402

EPILOGUE = {"frontend_flat.cu": "if ((s + 1) % ksteps == 0) {",
            "frontend_dif.cu": "if ((s + 1) % ksteps == 0) {"}
ONE_LEVEL = {"frontend_flat.cu": ("p[r][ci * 4 + e] = kk == 0 ? ar[r] * bl[e] : "
                                  "fmaf(ar[r], bl[e], p[r][ci * 4 + e]);",
                                  "c[r][ci * 4 + e] = fmaf(ar[r], bl[e], c[r][ci * 4 + e]);"),
             "frontend_dif.cu": ("p[r][ci * 4 + e] = kk == 0 ? ar * bl[e] : "
                                 "fmaf(ar, bl[e], p[r][ci * 4 + e]);",
                                 "c[r][ci * 4 + e] = fmaf(ar, bl[e], c[r][ci * 4 + e]);")}
ADD_PARTIALS = "c[r][j] += p[r][j];"


def variant(kernel, name):
    """A CudaKernel of ``kernel``'s source with the ``name`` change."""
    src_name = kernel.source.name
    src = kernel.source.read_text()
    if name == "one_level":
        old, new = ONE_LEVEL[src_name]
        edits = ((old, new), (ADD_PARTIALS, ";"))
    elif name == "one_epilogue":
        edits = ((EPILOGUE[src_name], "if (s + 1 == nsteps) {"),)
    else:
        edits = ()
    # the copy lives in the build directory: include the shared header by path
    edits += (('#include "frontend_common.cuh"',
               f'#include "{_cuda.CSRC / "frontend_common.cuh"}"'),)
    for old, new in edits:
        if src.count(old) != 1:
            raise RuntimeError(f"{src_name} no longer holds one `{old}`")
        src = src.replace(old, new)
    out = _cuda.BUILD / "forms_probe" / f"{Path(src_name).stem}_{name}.cu"
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(src)
    k = _cuda.CudaKernel(src_name, kernel.functions)
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


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(f"card: {smi}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    forms = {"K9": (frontend_forms.FLAT_KERNEL, frontend_forms.logmel_iv_flat,
                    frontend_forms.logmel_iv_flat_plain),
             "K10": (frontend_forms.DIF_KERNEL, frontend_forms.logmel_iv_dif,
                     frontend_forms.logmel_iv_dif_plain)}
    names = ("shipped", "one_level", "one_epilogue")
    kernels = {(f, n): variant(forms[f][0], n) for f in forms for n in names}
    _cuda.build_all(list(kernels.values()))
    for (f, n), k in kernels.items():
        regs = [ln.strip() for ln in k.build_log.splitlines() if "registers" in ln or "spill" in ln]
        print(f"{f} {n}: {' | '.join(regs)}", flush=True)

    x = torch.randn(32, 4, 240000, device="cuda",
                    generator=torch.Generator(device="cuda").manual_seed(0)) * 0.1
    kw = dict(n_fft=1024, hop=240)
    times = {f"{f} {n}": [] for f in forms for n in names}
    for f, (orig, wrapper, plain) in forms.items():
        ref = plain(x, **kw)
        for n in names:
            setattr(frontend_forms, "FLAT_KERNEL" if f == "K9" else "DIF_KERNEL", kernels[f, n])
            got = wrapper(x, **kw)
            torch.cuda.synchronize()
            if n != "one_epilogue":
                d = (got - ref).abs()
                db, iv = d[:, :4].max().item(), d[:, 4:].max().item()
                print(f"{f} {n}: vs plain {db:.3g} dB / {iv:.3g} IV", flush=True)
                if db > 8e-4 or iv > 7e-5:
                    sys.exit(f"{f} {n} disagrees with its plain version")
        setattr(frontend_forms, "FLAT_KERNEL" if f == "K9" else "DIF_KERNEL", orig)
    for r in range(args.rounds):
        order = [(f, n) for f in forms for n in names]
        for f, n in (order if r % 2 == 0 else order[::-1]):
            attr = "FLAT_KERNEL" if f == "K9" else "DIF_KERNEL"
            orig = getattr(frontend_forms, attr)
            setattr(frontend_forms, attr, kernels[f, n])
            ms = cuda_ms(lambda: forms[f][1](x, **kw))
            setattr(frontend_forms, attr, orig)
            times[f"{f} {n}"].append(ms)
            print(f"round {r}: {f} {n} {ms:.3f} ms ({smi})", flush=True)
    print(json.dumps({"card": smi, "ms": times}))


if __name__ == "__main__":
    main()
