#!/usr/bin/env python3
"""Tile sweep and probes of kernel K1 (csrc/frontend.cu, the fused log-mel
+ FOA intensity-vector frontend) on one card.

Forms, one change each from the shipped one:
  warps=1, 2, 4      frames (one warp each) per block (``frontend.TILES``);
                     the shared memory per warp (about 17 KB) and the
                     register cap (168, three blocks of 4 warps) allow 10-12
                     warps an SM
  unaligned          the mel gather windows from each band's first bin
                     (``TILES["aligned_windows"]`` False: fewer steps, bank
                     conflicts)
  span_one_wait      a copy that waits for both signals' spans before signal
                     0 starts (no overlap of signal 1's copy)
  twiddles_31        a copy that loads each of the 31 twiddles of a lane
                     from the table, not 10 rows and their products
  regs_uncapped      a copy without the register cap (minimum blocks per SM
                     in ``__launch_bounds__``): more registers, fewer warps
  direct_stores      a copy of the source whose mel lanes apply the affine
                     and store their outputs straight to device memory
                     (four values of a row per lane group), without the
                     staged contiguous rows
  span_scalar        a copy that stages the block's waveform span with one
                     load and one store a sample (the edge blocks' path)
                     instead of 16-byte ``cp.async`` copies
  one_sum            a copy whose mel gathers run one sum instead of two
                     interleaved ones (a longer dependent chain)
The copies are built under ``_build/k1_tiles/`` (one nvcc each, in
parallel). Each form is checked in the served HTSAT form (32 ten-second
clips, ScalarBN affine, bf16, 1024 frames) against the plain version (one
bf16 ulp, exact zeros from frame 1001 on) and for equal bits on a second
launch, then timed with CUDA events in rounds that alternate the order; the
shipped form also in the training form (float32, no folds). Prints one line
per measurement and one JSON line with the card's name and power limit.

    python3 scripts/torch_k1_tiles.py --rounds 2

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

from pseldnets_tpu_torch.ops import _cuda, frontend  # noqa: E402

SHIPPED = dict(frontend.TILES)
COPIES = {
    "direct_stores": (
        ("      if (q < 7 && m < n_mels) o_s[q * n_mels + m] = s;\n",
         "      if (q < 7 && m < n_mels) {\n"
         "        if (q < 4) s = 10.f * log10f(fmaxf(s, 1e-10f));\n"
         "        if (aff != nullptr) s = s * __ldg(aff + q * n_mels + m)"
         " + __ldg(aff + (7 + q) * n_mels + m);\n"
         "        const long o = ((long)(b * 7 + q) * t_out + frame) * n_mels + m;\n"
         "        if (out_bf16) static_cast<__nv_bfloat16*>(out)[o] = __float2bfloat16_rn(s);\n"
         "        else static_cast<float*>(out)[o] = s;\n      }\n"),
        ("  const bool zero = frame >= n_frames;\n",
         "  const bool zero = frame >= n_frames;\n  if (!zero) return;\n")),
    "span_scalar": (
        ("      if (inside && (span & 3) == 0 && (reinterpret_cast<size_t>(src + j0) & 15) == 0) {",
         "      if (false) {"),),
    "span_one_wait": (
        ('    asm volatile("cp.async.wait_group 1;" ::: "memory");\n',
         '    asm volatile("cp.async.wait_group 0;" ::: "memory");\n'),),
    "twiddles_31": (
        ("                           : cmul(a[r], h == 0 ? tl[l] : l == 0 ? th[h] : "
         "cmul(th[h], tl[l]));\n",
         "                           : cmul(a[r], __ldg(tw + k1 * R + lane));\n"),),
    "regs_uncapped": (
        ("__launch_bounds__(MAX_WARPS * 32, 3)", "__launch_bounds__(MAX_WARPS * 32)"),),
    "one_sum": (
        ("        s1 = fmaf(vv[i + 1], w.y, s1);\n", "        s0 = fmaf(vv[i + 1], w.y, s0);\n"),),
}


def copy_kernel(name):
    src = frontend.KERNEL.source.read_text()
    for old, new in COPIES[name]:
        if src.count(old) != 1:
            sys.exit(f"frontend.cu no longer holds one `{old.strip()}`")
        src = src.replace(old, new)
    out = _cuda.BUILD / "k1_tiles" / f"frontend_{name}.cu"
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(src)
    k = _cuda.CudaKernel("frontend.cu", frontend.KERNEL.functions)
    k.source = out
    return k


def cuda_ms(fn, reps=20):
    fn()
    torch.cuda.synchronize()
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / reps


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(f"card: {smi}", flush=True)
    # the plain version's STFT is a float32 convolution: no TF32
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    kernels = {"shipped": frontend.KERNEL, **{n: copy_kernel(n) for n in COPIES}}
    _cuda.build_all(list(kernels.values()))
    for n, k in kernels.items():
        regs = [ln.strip() for ln in k.build_log.splitlines() if "registers" in ln or "spill" in ln]
        print(f"{n}: {' | '.join(regs) or 'built before'}", flush=True)

    g = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn(32, 4, 240000, device="cuda", generator=g) * 0.1
    x[-1, :, :60000] = 0.0
    aff = (torch.rand(7, 64, device="cuda", generator=g) + 0.5,
           torch.randn(7, 64, device="cuda", generator=g))
    served = dict(post_affine=aff, out_dtype=torch.bfloat16, t_out=1024)
    forms = {f"warps={w}": ("shipped", {"warps": w}) for w in (1, 2, 4)}
    forms["unaligned"] = ("shipped", {"aligned_windows": False})
    forms.update({n: (n, {}) for n in COPIES})

    def use(form):
        kname, tiles = forms[form]
        frontend.KERNEL = kernels[kname]
        frontend.TILES.update(SHIPPED)
        frontend.TILES.update(tiles)

    ref = frontend.fused_logmel_iv_plain(x, **served).float()
    errs = {}
    for form in forms:
        use(form)
        got = frontend.fused_logmel_iv(x, **served)
        again = frontend.fused_logmel_iv(x, **served)
        got32 = got.float()
        err = ((got32 - ref).abs() / ref.abs().clamp(min=1.0)).max().item()
        same = bool(torch.equal(got, again))
        tail = not bool(got32[:, :, 1001:].any())
        errs[form] = {"err": err, "two_launches_equal": same}
        print(f"{form}: vs plain {err:.3g} of max(|x|, 1) (<= 2^-7), two launches "
              f"{'equal' if same else 'DIFFER'}, zero tail {tail}", flush=True)
        if err > 2.0 ** -7 or not same or not tail:
            sys.exit(f"{form} fails its check")
    del ref, got, again, got32
    times = {f: [] for f in forms}
    times["shipped float32"] = []
    order = list(times)
    for r in range(args.rounds):
        for form in (order if r % 2 == 0 else order[::-1]):
            use(form if form != "shipped float32" else f"warps={SHIPPED['warps']}")
            kw = {} if form == "shipped float32" else served
            times[form].append(cuda_ms(lambda: frontend.fused_logmel_iv(x, **kw)))
            print(f"round {r}: {form} {times[form][-1]:.4f} ms ({smi})", flush=True)
    frontend.KERNEL = kernels["shipped"]
    frontend.TILES.update(SHIPPED)
    print(json.dumps({"card": smi, "shipped": SHIPPED, "ms": times, "checks": errs}))


if __name__ == "__main__":
    main()
