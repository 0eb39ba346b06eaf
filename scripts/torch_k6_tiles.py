#!/usr/bin/env python3
"""Tile sweep and probes of kernel K6 (csrc/vit_block.cu with its Hopper GEMM
core csrc/sm90_gemm.cuh) on one card.

Builds K6 and four probe copies of its source, each with one change (under
``_build/k6_probe/``, all in parallel):
  no_mma     the GEMM consumers issue no wgmma (the ring, loads, epilogue)
  no_load    the GEMM producer loads nothing (the ring turns; wgmma and the
             epilogue on whatever shared memory holds)
  att_kt128  the attention on 128-key tiles, one block per SM (K6 takes
             64-key tiles, two blocks per SM)
  att_no_exp the attention's exp2f replaced by a multiply (its output is not
             the block's, so it is only timed)

Then, for each of the PaSST block's four GEMMs at the served shape (B=32
clips of 602 tokens: M = 19264 rows; qkv 2304 x 768 with bias, proj 768 x
768 with bias + residual, fc1 3072 x 768 with bias + GELU, fc2 768 x 3072
with bias + residual) and each output tile of the core (128 x BN shared by
the two consumer warpgroups, BN 128, 192, 256; or 128 x 128 per warpgroup,
ping-pong, -128): checks the core against its plain version (2^-7 of the
output's largest magnitude, at M = 1000 and the served M, two launches
bitwise equal) and times it with CUDA events in rounds that alternate the
order of the tiles; times the no_mma and no_load copies once beside it, and
one ``F.linear`` (cuBLAS, bf16, no epilogue) per shape as a yardstick.
Last, checks K6 and att_kt128 against the plain block and times K6's seven
launches by phase (the events its C entry records) for K6 and the attention
copies in turns. Prints one line per measurement and one JSON line at the
end, with the card's name and power limit.

    python3 scripts/torch_k6_tiles.py --rounds 2

Needs one CUDA card and nvcc.
"""

import argparse
import ctypes
import json
import subprocess
import sys
import time
from pathlib import Path

import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from pseldnets_tpu_torch.ops import _cuda, vit_block  # noqa: E402

M_SERVED = 32 * 602
C, HIDDEN = 768, 3072
# name -> (N, K, epilogue)
GEMMS = {"qkv": (3 * C, C, "bias"), "proj": (C, C, "resid"), "fc1": (HIDDEN, C, "gelu"),
         "fc2": (C, HIDDEN, "resid")}
TILES = vit_block.GEMM_TILES

WGMMA = "wgmma_ss<BN>(acc[h], da + 512 * h + 2 * kk, db + 2 * kk, kb > 0 || kk > 0);"
LOADS = """          mbar_expect_tx(full + 8 * s, T::STAGE);
          tma_load_2d(sA + s * T::A_BYTES, &tma_a, kb * GEMM_BK, m0, full + 8 * s);
          tma_load_2d(sB + s * T::B_BYTES, &tma_b, kb * GEMM_BK, n0, full + 8 * s);"""
# name -> (text put first, [(file, text, replacement)]) of each probe copy
PROBES = {
    "no_mma": ("", [("cuh", WGMMA, ";")]),
    "no_load": ("", [("cuh", LOADS, "          mbar_arrive(full + 8 * s);")]),
    "att_kt128": ("", [("cu", "constexpr int KT = 64;", "constexpr int KT = 128;")]),
    "att_no_exp": ("#define exp2f(x) ((x) * 0.5f)\n", []),
}
CHECKED = ("shipped", "att_kt128")  # the forms that compute the block


def probe_kernel(name):
    """A copy of vit_block.cu, sm90_gemm.cuh pasted in, with probe ``name``'s
    changes, as a kernel of its own."""
    first, changes = PROBES[name]
    inc = '#include "sm90_gemm.cuh"'
    srcs = {"cu": (_cuda.CSRC / "vit_block.cu").read_text(),
            "cuh": (_cuda.CSRC / "sm90_gemm.cuh").read_text()}
    for where, old, new in changes:
        if srcs[where].count(old) != 1:
            raise RuntimeError(f"probe {name}: the text it changes is not in the source once")
        srcs[where] = srcs[where].replace(old, new)
    if srcs["cu"].count(inc) != 1:
        raise RuntimeError("vit_block.cu no longer includes sm90_gemm.cuh once")
    out = _cuda.BUILD / "k6_probe" / f"{name}.cu"
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(first + srcs["cu"].replace(inc, srcs["cuh"]))
    k = _cuda.CudaKernel("vit_block.cu", vit_block.KERNEL.functions)
    k.source = out
    return k


def block_out(k, x, p):
    """K6's C entry of kernel k on x: the block's output."""
    args, _scratch, out = vit_block._block_args(x, p)
    k.call("vit_block_forward", *args)
    return out


def block_phases(k, x, p, reps):
    """K6's phase-timing C entry of kernel k: mean ms by phase."""
    args, _scratch, _out = vit_block._block_args(x, p)
    ms = (ctypes.c_float * len(vit_block.PHASES))()
    k.call("vit_block_phases", *args, ctypes.addressof(ms), reps)
    return dict(zip(vit_block.PHASES, ms))


def probe_gemm(k, a, w, bias, resid, epi, bn):
    out = torch.empty(a.shape[0], w.shape[0], device="cuda", dtype=torch.bfloat16)
    k.call("vit_gemm", a.data_ptr(), w.data_ptr(), bias.data_ptr(),
           0 if resid is None else resid.data_ptr(), out.data_ptr(), a.shape[0], w.shape[0],
           a.shape[1], vit_block.EPILOGUES[epi], bn)


def cuda_ms(fn, reps=10):
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def operands(gen, M, N, K, epilogue):
    a = (torch.randn(M, K, generator=gen) * 0.5).cuda().bfloat16()
    w = (torch.randn(N, K, generator=gen) / K ** 0.5).cuda().bfloat16()
    bias = (torch.randn(N, generator=gen) * 0.1).cuda()
    resid = (torch.randn(M, N, generator=gen)).cuda().bfloat16() if epilogue == "resid" else None
    return a, w, bias, resid


def check(name, M, N, K, epilogue, bn, gen):
    a, w, bias, resid = operands(gen, M, N, K, epilogue)
    got = vit_block.gemm(a, w, bias, resid, epilogue, bn).float()
    again = vit_block.gemm(a, w, bias, resid, epilogue, bn).float()
    ref = vit_block.gemm_plain(a, w, bias, resid, epilogue).float()
    torch.cuda.synchronize()
    err = (got - ref).abs().max().item()
    scale = ref.abs().max().item()
    ok = err <= 2.0 ** -7 * scale and torch.equal(got, again)
    print(f"check {name} M={M} N={N} K={K} {epilogue} bn={bn}: |k-plain| {err:.3g} "
          f"(<= {2.0 ** -7 * scale:.3g}), repeat bitwise {torch.equal(got, again)}", flush=True)
    if not ok:
        raise SystemExit(f"GEMM core disagrees: {name} bn={bn}")
    return err / scale


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(f"card: {smi}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    probes = {name: probe_kernel(name) for name in PROBES}
    t0 = time.perf_counter()
    _cuda.build_all([vit_block.KERNEL, *probes.values()])
    print(f"build of vit_block.cu and its {len(probes)} probe copies (in parallel): "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    for k in (vit_block.KERNEL, *probes.values()):
        for line in k.build_log.splitlines():
            if "registers" in line or "spill" in line or "arning" in line or "C75" in line:
                print(f"  {k.source.name}: {line.strip()}", flush=True)

    gen = torch.Generator().manual_seed(5)
    worst = 0.0
    for name, (N, K, epi) in GEMMS.items():
        for bn in TILES:
            for M in (1000, M_SERVED):
                worst = max(worst, check(name, M, N, K, epi, bn, gen))

    times = {name: {bn: [] for bn in TILES} for name in GEMMS}
    probe_times = {name: {bn: {} for bn in TILES} for name in GEMMS}
    library = {}
    for r in range(args.rounds):
        order = TILES if r % 2 == 0 else TILES[::-1]
        for name, (N, K, epi) in GEMMS.items():
            a, w, bias, resid = operands(gen, M_SERVED, N, K, epi)
            flop = 2.0 * M_SERVED * N * K
            for bn in order:
                ms = cuda_ms(lambda: vit_block.gemm(a, w, bias, resid, epi, bn))
                times[name][bn].append(ms)
                print(f"round {r} {name} bn={bn}: {ms:.4f} ms, "
                      f"{flop / ms / 1e9:.1f} TFLOP/s", flush=True)
                if r == 0:
                    for pname in ("no_mma", "no_load"):
                        k = probes[pname]
                        pms = cuda_ms(lambda: probe_gemm(k, a, w, bias, resid, epi, bn))
                        probe_times[name][bn][pname] = pms
                        print(f"  probe {pname}: {pms:.4f} ms", flush=True)
            if r == 0:
                library[name] = cuda_ms(lambda: F.linear(a, w))
                print(f"  {name} F.linear (cuBLAS, bf16, no epilogue): {library[name]:.4f} ms, "
                      f"{flop / library[name] / 1e9:.1f} TFLOP/s", flush=True)

    # the whole block at the served shape
    from pseldnets_tpu_torch.models.factory import init_weights
    from pseldnets_tpu_torch.models.passt import Block

    blk = Block(C, 12)
    init_weights(blk, torch.Generator().manual_seed(6))
    p = vit_block.prepare_vit_block(blk.cuda().eval(), torch.bfloat16)
    x = torch.randn(32, 602, C, generator=gen).cuda().bfloat16()
    kernels = {"shipped": vit_block.KERNEL, "att_kt128": probes["att_kt128"],
               "att_no_exp": probes["att_no_exp"]}
    ref = vit_block.vit_block_plain(x, p).float()
    for kname in CHECKED:
        err = (block_out(kernels[kname], x, p).float() - ref).abs().max().item()
        print(f"K6 {kname} at B=32 N=602: |k-plain| {err:.3g} (<= "
              f"{2.0 ** -6 * ref.abs().max().item():.3g})", flush=True)
        if err > 2.0 ** -6 * ref.abs().max().item():
            raise SystemExit(f"K6 {kname} disagrees with its plain version")
    phases = {kname: [] for kname in kernels}
    for r in range(args.rounds):
        for kname in (list(kernels) if r % 2 == 0 else list(kernels)[::-1]):
            block_phases(kernels[kname], x, p, 2)
            ph = block_phases(kernels[kname], x, p, 10)
            phases[kname].append(ph)
            print(f"round {r} K6 {kname} phases at B=32 N=602 (ms): " + ", ".join(
                f"{n} {v:.4f}" for n, v in ph.items()) + f"; sum {sum(ph.values()):.4f}",
                flush=True)
    print(json.dumps({"card": smi, "worst_err_of_scale": worst,
                      "ms": times, "probe_ms": probe_times, "f_linear_ms": library,
                      "k6_phases_ms": phases}))


if __name__ == "__main__":
    main()
