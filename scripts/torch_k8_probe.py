#!/usr/bin/env python3
"""Where the time of kernel K8 (csrc/patch_embed.cu, the HTSAT patch embed)
goes, in one or more checkouts, at the served shape: (32, 7, 1024, 64) bf16
-> (32, 4096, 96) bf16.

For each checkout, in a process of its own, builds copies of its
``csrc/patch_embed.cu`` under ``_build/k8_probe/``, each with one change
(made here, in the copy's text: the shipped source has no switches), one
nvcc each in parallel, and times each with CUDA events in rounds that
alternate the order, each call queued behind a sleeping kernel so that
the times are the device's, not the host's launch rate (chip_smoke.py
prints the host's cost a call through the wrapper). The copies for the float32-FMA design (the
kernel before its Hopper redesign):

  no_gather    the patch gather into shared memory skipped
  no_weights   the per-block reload of the weights skipped
  no_products  the 112-step FMA loop skipped

and for the TMA-fed wgmma design:

  no_loads     the TMA loads skipped (the ring's barriers still arrive)
  no_mma       the wgmma products skipped (the fragment loads kept)
  no_epilogue  bias, LayerNorm and the staging stores skipped
  no_store     the TMA stores skipped
  compute_only no TMA loads and no TMA stores
  setup_only   no tiles: the launch, the weights' and parameters' fill
  early_refill the next tile's load issued once the fragments are read,
               before the products (must give the same bits)
  stages3      a 3-stage ring, one block an SM (must give the same bits)
  cta1         the 2-stage ring, one block an SM (must give the same bits)

Cut copies compute wrong outputs, which are not checked. Each kernel is
timed twice: on one input (as chip_smoke.py does, so part of it may stay
in the 50 MB L2) and rotating over four inputs (117 MB, more than L2).
Beside them: cuDNN's conv of the same wav2img image alone (a yardstick of
the conv, not of the whole function). One JSON line per checkout, with the
card's name and power limit.

    python3 scripts/torch_k8_probe.py _archive/parent . --rounds 2

Needs one CUDA card and nvcc.
"""

import argparse
import json
import subprocess
import sys
from pathlib import Path

# the wgmma design's refill: stage s read by every thread, the staging tile
# by the previous store, then the next load into stage s
REFILL = ("    if (tid == 0) bulk_wait_read();  // the previous tile's store has read the staging "
          "tile\n    __syncthreads();                 // and every thread has read stage s\n"
          "    if (tid == 0 && t + STAGES * gridDim.x < tiles) load(t + STAGES * gridDim.x, s);\n")

# each design's copies: (anchor, replacement), each anchor found once
VERSIONS = {
    "fma": {
        "marker": "patch_embed_kernel(",
        "cuts": {
            "no_gather": [("  for (int i = tid; i < C * TPB * 4 * 64; i += THREADS) {",
                           "  for (int i = tid; i < (T_img < 0 ? C * TPB * 4 * 64 : 0); "
                           "i += THREADS) {")],
            "no_weights": [("  for (int i = tid; i < K * E; i += THREADS)",
                            "  for (int i = tid; i < (T_img < 0 ? K * E : 0); i += THREADS)")],
            "no_products": [("  for (int k = 0; k < K; ++k) {",
                             "  for (int k = 0; k < (T_img < 0 ? K : 0); ++k) {")],
        },
    },
    "wgmma": {
        "marker": "patch_embed_wgmma(",
        "cuts": {
            "no_loads": [("    mbar_expect_tx(full + 8 * s, STAGE_BYTES);\n",
                          "    mbar_arrive(full + 8 * s);\n"),
                         ("    tma_load_4d(sX + s * STAGE_BYTES, mx, 0, g * tg + 4 * tp0, 0, b, "
                          "full + 8 * s);\n", "")],
            "no_mma": [("    for (int c = 0; c < NC; ++c) wgmma_rs_n96(acc, a[c], "
                        "desc_sw32(sW + c * SLICE_BYTES), c);\n",
                        "    for (int c = 0; c < NC; ++c) acc[c] += __uint_as_float(a[c][0] ^ "
                        "a[c][1] ^ a[c][2] ^ a[c][3]);\n")],
            "no_epilogue": [("    for (int h = 0; h < 2; ++h) {\n      float v[24];",
                             "    for (int h = 0; h < (acc[0] == 1.2345e-30f ? 2 : 0); ++h) {\n"
                             "      float v[24];")],
            "no_store": [("      tma_store_4d(&tma_out, sOut, 0, tp0, g * FP, b);",
                          "      if (b < 0) tma_store_4d(&tma_out, sOut, 0, tp0, g * FP, b);")],
            "compute_only": [("    mbar_expect_tx(full + 8 * s, STAGE_BYTES);\n",
                              "    mbar_arrive(full + 8 * s);\n"),
                             ("    tma_load_4d(sX + s * STAGE_BYTES, mx, 0, g * tg + 4 * tp0, 0, "
                              "b, full + 8 * s);\n", ""),
                             ("      tma_store_4d(&tma_out, sOut, 0, tp0, g * FP, b);",
                              "      if (b < 0) tma_store_4d(&tma_out, sOut, 0, tp0, g * FP, b);")],
            "setup_only": [("      if (blockIdx.x + s * gridDim.x < tiles) load(",
                            "      if (tiles < 0) load("),
                           ("  for (int t = blockIdx.x; t < tiles; t += gridDim.x, ++it) {",
                            "  for (int t = blockIdx.x; t < (tiles < 0 ? tiles : 0); "
                            "t += gridDim.x, ++it) {")],
            "early_refill": [(REFILL, ""),
                             ("    wgmma_fence();\n",
                              "    fence_async_shared();\n" + REFILL + "    wgmma_fence();\n")],
            "stages3": [("constexpr int STAGES = 2;", "constexpr int STAGES = 3;"),
                        ("constexpr int CTAS_PER_SM = 2;", "constexpr int CTAS_PER_SM = 1;")],
            "cta1": [("constexpr int CTAS_PER_SM = 2;", "constexpr int CTAS_PER_SM = 1;")],
        },
        "same_bits": ("early_refill", "stages3", "cta1"),
    },
}

RUN = r"""
import json, sys, torch
import torch.nn.functional as F
sys.path.insert(0, '.')
from pseldnets_tpu_torch.ops import _cuda, patch_embed
VERSIONS, ROUNDS = json.loads(sys.argv[1]), int(sys.argv[2])
src = patch_embed.KERNEL.source.read_text()
name, ver = next((n, v) for n, v in VERSIONS.items() if v["marker"] in src)
print(f"kernel design: {name}", flush=True)
kernels = {"shipped": patch_embed.KERNEL}
for cut, edits in ver["cuts"].items():
    text = src
    for anchor, new in edits:
        if text.count(anchor) != 1:
            sys.exit(f"{name}: the source no longer holds one `{anchor.strip()}`")
        text = text.replace(anchor, new)
    out = _cuda.BUILD / "k8_probe" / f"patch_embed_{cut}.cu"
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(text.replace('#include "', f'#include "{_cuda.CSRC}/'))
    k = _cuda.CudaKernel("patch_embed.cu", patch_embed.KERNEL.functions)
    k.source = out
    kernels[cut] = k
_cuda.build_all(list(kernels.values()))
for cut, k in kernels.items():
    for ln in k.build_log.splitlines():
        if "registers" in ln or "spill" in ln:
            print(f"{cut}: {ln.split(':', 1)[-1].strip()}", flush=True)

dev = torch.device("cuda")
g = torch.Generator(device=dev).manual_seed(0)
vec = lambda s, o: torch.randn(96, device=dev, generator=g) * s + o
p = patch_embed.PatchEmbedParams(
    w=(torch.randn(112, 96, device=dev, generator=g) * 0.1).bfloat16(), bias=vec(0.1, 0.0),
    ln_w=vec(0.1, 1.0), ln_b=vec(0.1, 0.0), freq_ratio=4, t_img=1024)
xs = [torch.randn(32, 7, 1024, 64, device=dev, generator=g).bfloat16() for _ in range(4)]


def run(cut, x):
    patch_embed.KERNEL = kernels[cut]
    return patch_embed.patch_embed_tokens(x, p)


shipped = run("shipped", xs[0])
ref = patch_embed.patch_embed_tokens_plain(xs[0], p).float()
err = ((shipped.float() - ref).abs() / ref.abs().clamp(min=1.0)).max().item()
print(f"shipped vs plain: {err:.3g} of max(|x|, 1) (2^-7 = 0.0078)", flush=True)
for cut in ver.get("same_bits", ()):
    same = bool(torch.equal(run(cut, xs[0]), shipped))
    print(f"{cut}: {'same bits' if same else 'DIFFERENT'} as shipped", flush=True)
    if not same:
        sys.exit(f"{cut} does not give the shipped kernel's bits")


# device ms a call (chip_smoke.py::device_ms): the calls queued behind a
# kernel that sleeps while the host launches them, so the host's cost a call
# (the wrapper, two tensor-map encodings) does not show
def device_ms(fn, reps=40):
    fn(0)
    torch.cuda.synchronize()
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(100_000_000)  # ~60 ms at the card's clock
    e0.record()
    for i in range(reps):
        fn(i)
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / reps


ms = {f"{c} {how}": [] for c in kernels for how in ("one input", "rotating")}
for r in range(ROUNDS):
    order = list(ms)
    for key in (order if r % 2 == 0 else order[::-1]):
        cut, how = key.split(" ", 1)
        ms[key].append(device_ms(lambda i: run(cut, xs[i % 4 if how == "rotating" else 0])))
        print(f"round {r}: {key} {ms[key][-1]:.4f} ms", flush=True)
patch_embed.KERNEL = kernels["shipped"]
# reshape_wav2img (models/htsat.py): (B, C, T, F) -> (B, C, 4 F, T / 4)
img = xs[0].transpose(2, 3).reshape(32, 7, 64, 4, 256).transpose(2, 3).reshape(32, 7, 256, 256)
img = img.contiguous()
cw, cb = (p.w.t().reshape(96, 7, 4, 4).transpose(2, 3).contiguous().bfloat16(),
          p.bias.bfloat16())
conv = [device_ms(lambda i: F.conv2d(img, cw, cb, stride=4)) for _ in range(ROUNDS)]
print("cuDNN conv of the wav2img image alone: " + ", ".join(f"{t:.4f}" for t in conv) + " ms",
      flush=True)
print("RESULT " + json.dumps({"design": name, "ms": ms, "cudnn_conv_ms": conv,
                              "shipped_err": err}))
"""


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("checkouts", type=Path, nargs="+")
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip().splitlines()[0]
    print(f"card: {smi}", flush=True)
    for checkout in args.checkouts:
        r = subprocess.run([sys.executable, "-c", RUN, json.dumps(VERSIONS), str(args.rounds)],
                           cwd=checkout, capture_output=True, text=True)
        sys.stdout.write(r.stdout.replace("RESULT ", "# "))
        if r.returncode != 0:
            sys.exit(f"run in {checkout} failed:\n{r.stderr[-4000:]}")
        res = json.loads(next(ln for ln in r.stdout.splitlines()
                              if ln.startswith("RESULT "))[7:])
        med = {k: sorted(v)[len(v) // 2] for k, v in res["ms"].items()}
        print(f"{checkout} ({res['design']}): " + ", ".join(
            f"{k} {v:.4f}" for k, v in med.items()) + f" ms ({smi})", flush=True)
        print(json.dumps({"checkout": str(checkout), "card": smi, "median_ms": med, **res}),
              flush=True)


if __name__ == "__main__":
    main()
