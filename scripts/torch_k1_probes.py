#!/usr/bin/env python3
"""Where the time of kernel K1 (csrc/frontend.cu, the fused log-mel + FOA
intensity-vector frontend) goes, by phase, in one or more checkouts.

For each checkout, in a process of its own, builds copies of its
``csrc/frontend.cu`` under ``_build/k1_probe/``, each cut after one phase
(the cut is made here, in the copy's text: the shipped source has no
switches), all with one nvcc each in parallel:

  load      the samples read and windowed
  fft1      plus the first 32-point FFTs
  fft2      plus the twiddles, the transpose and the second 32-point FFTs
  values    plus the unpacking of the packed spectra, power and the IV
  mel       plus the mel sums (dB and the affine; nothing stored)
  full      plus the stores: the kernel as shipped

A cut copy keeps its live values alive through a sink that stores only on
an impossible value, so the compiler cannot drop the work; the zero-tail
frames past ``n_frames`` are stored in every copy. The cut copies compute
wrong outputs, which are not checked; ``full`` is checked for the shipped
kernel's bits, and the shipped kernel's largest error from the plain
version is printed. Each copy is timed with CUDA events in the
served form (32 ten-second clips, ScalarBN affine, bf16, 1024 frames), in
rounds that alternate the order; ``full`` also in the training form
(float32, no folds). Per copy it prints the registers and spills (ptxas)
and the resident blocks and warps per SM from
``cudaOccupancyMaxActiveBlocksPerMultiprocessor`` (an entry point appended
to the copy). As a yardstick of the FFT phase alone it times
``torch.fft.rfft`` (cuFFT) of the same 32 x 4 x 1001 windowed 1024-point
frames, made beforehand (the port never calls it). One JSON line per
checkout, with the card's name and power limit.

    python3 scripts/torch_k1_probes.py _archive/parent . --rounds 2

Needs one CUDA card and nvcc.
"""

import argparse
import json
import subprocess
import sys
from pathlib import Path

CUTS = ("load", "fft1", "fft2", "values", "mel", "full")

# Each kernel version's cuts: (anchor, text inserted before it or replacing
# it), found by the anchor strings, and the occupancy entry appended to the
# copy. K1_CUT is the index of the cut in CUTS, plus one (6: the full
# kernel); SINK stores only on a value no run produces.
SINK = "1.2345e-30f"
VERSIONS = {
    # the first four-step kernel: one warp per frame, both packed signals
    # through the same shared-memory slots
    "four_step_v1": {
        "marker": "constexpr int WARP_SLOTS",
        "edits": [
            ("  const int frame = blockIdx.x * TF + warp;\n", "  float k1_sink = 0.f;\n", "after"),
            ("    fft32(a);  // a[r] = Y[k1 = rev5(r)] of column n2 = lane\n",
             "    if (K1_CUT == 1) {\n#pragma unroll\n      for (int r = 0; r < R; ++r)"
             " k1_sink += a[r].x + a[r].y;\n      continue;\n    }\n", "before"),
            ("    fft32(a);  // a[r] = Y[k1 = rev5(r)] of column n2 = lane\n",
             "    if (K1_CUT == 2) {\n#pragma unroll\n      for (int r = 0; r < R; ++r)"
             " k1_sink += a[r].x + a[r].y;\n      continue;\n    }\n", "after"),
            ("    fft32(a);  // a[r] = X[lane + 32 rev5(r)]\n",
             "    if (K1_CUT == 3) {\n#pragma unroll\n      for (int r = 0; r < R; ++r)"
             " k1_sink += a[r].x + a[r].y;\n      continue;\n    }\n", "after"),
            ("  // bins k and n_fft - k of the two packed spectra",
             f"  if (K1_CUT <= 3) {{\n    if (k1_sink == {SINK}) store(0, lane, k1_sink);\n"
             "    return;\n  }\n", "before"),
            ("  // mel outputs widest band first (sched)",
             "  if (K1_CUT == 4) {\n    const float* vs = reinterpret_cast<const float*>(spec);\n"
             "    k1_sink += vs[lane] + vs[lane + 2 * SPEC];\n"
             f"    if (k1_sink == {SINK}) store(0, lane, k1_sink);\n    return;\n  }}\n",
             "before"),
            ("    store(q, mi, s);\n  }\n}\n",
             "    if (K1_CUT == 5) k1_sink += s;\n    else store(q, mi, s);\n  }\n"
             f"  if (K1_CUT == 5 && k1_sink == {SINK}) store(0, lane, k1_sink);\n}}\n",
             "replace"),
        ],
        "occupancy": """
extern "C" int k1_probe_occupancy(int n_w, int* blocks, int* threads, int* smem) {
  const size_t bytes = (size_t)TF * WARP_SLOTS * sizeof(float2) + (size_t)n_w * sizeof(float);
  cudaFuncSetAttribute(logmel_iv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  *threads = THREADS;
  *smem = (int)bytes;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, logmel_iv_kernel, THREADS,
                                                            bytes);
}
""",
        "occupancy_arg": "int(frontend._kernel_tables(1024, 'hann', 64, 24000, dev)[2].numel())",
    },
    # the staged-span kernel: one warp per frame, the block's waveform span in
    # shared memory, the unpacking in registers (shuffles), the mel sums as
    # gathers in fixed band groups
    "four_step_v2": {
        "marker": "// K1 phase: values",
        "edits": [
            ("  // (7, n_mels)\n", "  float k1_sink = 0.f;\n", "after"),
            ("// K1 phase: fft1\n",
             "if (K1_CUT == 1) {\n#pragma unroll\n      for (int r = 0; r < R; ++r)"
             " k1_sink += a[r].x + a[r].y;\n      continue;\n    }\n", "before"),
            ("// K1 phase: fft2\n",
             "if (K1_CUT == 2) {\n#pragma unroll\n      for (int r = 0; r < R; ++r)"
             " k1_sink += a[r].x + a[r].y;\n      continue;\n    }\n", "before"),
            ("// K1 phase: unpack\n",
             "if (K1_CUT == 3) {\n#pragma unroll\n      for (int r = 0; r < R; ++r)"
             " k1_sink += a[r].x + a[r].y;\n      continue;\n    }\n", "before"),
            ("// K1 phase: values\n",
             f"if (K1_CUT <= 3) {{\n    if (k1_sink == {SINK}) o_s[lane] = k1_sink;\n"
             "    return;\n  }\n", "before"),
            ("// K1 phase: mel\n",
             "if (K1_CUT == 4) {\n    k1_sink += v_lo[lane] + v_hi[4 * VLD + lane];\n"
             f"    if (k1_sink == {SINK}) o_s[lane] = k1_sink;\n    return;\n  }}\n",
             "before"),
            ("// K1 phase: store\n",
             "if (K1_CUT == 5 && frame < n_frames) {\n"
             "    k1_sink += o_s[lane] + o_s[4 * n_mels + lane];\n"
             f"    if (k1_sink == {SINK}) v_lo[lane] = k1_sink;\n    return;\n  }}\n",
             "before"),
        ],
        "occupancy": """
extern "C" int k1_probe_occupancy(int n_w, int* blocks, int* threads, int* smem) {
  const size_t bytes = block_bytes(MAX_WARPS, 64, n_w, 16);
  cudaFuncSetAttribute(logmel_iv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  *threads = MAX_WARPS * 32;
  *smem = (int)bytes;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, logmel_iv_kernel,
                                                            MAX_WARPS * 32, bytes);
}
""",
        "occupancy_arg": "int(frontend._kernel_tables(1024, 'hann', 64, 24000, dev)[2].numel())",
    },
}

RUN = r"""
import ctypes, json, sys, torch
sys.path.insert(0, '.')
from pseldnets_tpu_torch.ops import _cuda, frontend
VERSIONS, CUTS, ROUNDS = json.loads(sys.argv[1]), json.loads(sys.argv[2]), int(sys.argv[3])
src = frontend.KERNEL.source.read_text()
name, ver = next((n, v) for n, v in VERSIONS.items() if v["marker"] in src)
print(f"kernel version: {name}", flush=True)
dev = torch.device("cuda")
# the plain version's STFT is a float32 convolution: no TF32
torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False
kernels = {}
for i, cut in enumerate(CUTS):
    text = src
    for anchor, new, where in ver["edits"]:
        if text.count(anchor) != 1:
            sys.exit(f"{name}: the source no longer holds one `{anchor.strip()}`")
        text = text.replace(anchor, {"after": anchor + new, "before": new + anchor,
                                     "replace": new}[where])
    text = f"#define K1_CUT {i + 1}\n" + text.replace(
        '#include "', f'#include "{_cuda.CSRC}/') + ver["occupancy"]
    out = _cuda.BUILD / "k1_probe" / f"frontend_{cut}.cu"
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(text)
    k = _cuda.CudaKernel("frontend.cu", frontend.KERNEL.functions)
    k.source = out
    kernels[cut] = k
_cuda.build_all(list(kernels.values()))
occ = {}
for cut, k in kernels.items():
    regs = [ln.split(":", 1)[-1].strip() for ln in k.build_log.splitlines()
            if "registers" in ln or "spill" in ln]
    fn = k.lib().k1_probe_occupancy
    fn.argtypes = [ctypes.c_int] + [ctypes.POINTER(ctypes.c_int)] * 3
    blocks, threads, smem = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    rc = fn(eval(ver["occupancy_arg"]), blocks, threads, smem)
    occ[cut] = {"blocks_per_sm": blocks.value, "threads": threads.value, "smem": smem.value,
                "warps_per_sm": blocks.value * threads.value // 32, "rc": rc, "ptxas": regs}
    print(f"{cut}: {' | '.join(regs)}; {blocks.value} blocks x {threads.value} threads "
          f"({blocks.value * threads.value // 32} warps) per SM, {smem.value} B shared",
          flush=True)

g = torch.Generator(device=dev).manual_seed(0)
x = torch.randn(32, 4, 240000, device=dev, generator=g) * 0.1
aff = (torch.rand(7, 64, device=dev, generator=g) + 0.5, torch.randn(7, 64, device=dev, generator=g))
served = dict(post_affine=aff, out_dtype=torch.bfloat16, t_out=1024)
orig = frontend.KERNEL
shipped = frontend.fused_logmel_iv(x, **served)
frontend.KERNEL = kernels["full"]
same = bool(torch.equal(frontend.fused_logmel_iv(x, **served), shipped))
frontend.KERNEL = orig
print(f"full copy vs the shipped kernel: {'same bits' if same else 'DIFFERENT'}", flush=True)
if not same:
    sys.exit("the full copy does not give the shipped kernel's bits")
ref = frontend.fused_logmel_iv_plain(x, **served).float()
d = (shipped.float() - ref).abs() / ref.abs().clamp(min=1.0)
err = d.max().item()
at = [int(i) for i in torch.unravel_index(d.argmax(), d.shape)]
print(f"shipped vs plain (served form): {err:.3g} of max(|x|, 1) (2^-7 = 0.0078) at "
      f"(clip, channel, frame, mel) {at}: {shipped.float()[tuple(at)].item():.6g} against "
      f"{ref[tuple(at)].item():.6g}", flush=True)
del shipped, ref, d


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


ms = {c: [] for c in CUTS}
ms["full float32"] = []
for r in range(ROUNDS):
    order = list(CUTS) + ["full float32"]
    for c in (order if r % 2 == 0 else order[::-1]):
        frontend.KERNEL = kernels["full" if c == "full float32" else c]
        kw = {} if c == "full float32" else served
        ms[c].append(cuda_ms(lambda: frontend.fused_logmel_iv(x, **kw)))
        print(f"round {r}: {c} {ms[c][-1]:.4f} ms", flush=True)
frontend.KERNEL = orig
# cuFFT yardstick: the windowed frames made beforehand, only the rfft timed
from pseldnets_tpu_torch.ops.frontend_forms import padded_signal
from pseldnets_tpu_torch.ops.windows import get_window
win = torch.as_tensor(get_window("hann", 1024), dtype=torch.float32, device=dev)
frames = padded_signal(x, 1024, 240).unfold(-1, 1024, 240)[..., :1001, :] * win
frames = frames.contiguous()
rfft = [cuda_ms(lambda: torch.fft.rfft(frames), reps=10) for _ in range(ROUNDS)]
print(f"cuFFT rfft of {tuple(frames.shape)} windowed frames: "
      + ", ".join(f"{t:.4f}" for t in rfft) + " ms", flush=True)
print("RESULT " + json.dumps({"version": name, "ms": ms, "occupancy": occ, "rfft_ms": rfft,
                              "full_err": err}))
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
        r = subprocess.run([sys.executable, "-c", RUN, json.dumps(VERSIONS), json.dumps(CUTS),
                            str(args.rounds)], cwd=checkout, capture_output=True, text=True)
        sys.stdout.write(r.stdout.replace("RESULT ", "# "))
        if r.returncode != 0:
            sys.exit(f"run in {checkout} failed:\n{r.stderr[-4000:]}")
        res = json.loads(next(ln for ln in r.stdout.splitlines()
                              if ln.startswith("RESULT "))[7:])
        med = {c: sorted(v)[len(v) // 2] for c, v in res["ms"].items()}
        prev, phases = 0.0, {}
        for c in CUTS:
            phases[c] = med[c] - prev
            prev = med[c]
        print(f"{checkout} ({res['version']}): " + ", ".join(
            f"{c} +{v:.4f}" for c, v in phases.items()) + f" ms; full {med['full']:.4f} ms, "
            f"float32 {med['full float32']:.4f} ms ({smi})", flush=True)
        print(json.dumps({"checkout": str(checkout), "card": smi, "median_ms": med,
                          "phase_ms": phases, **res}), flush=True)


if __name__ == "__main__":
    main()
