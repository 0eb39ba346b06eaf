"""What K3 and K5 (``csrc/swin_block_bwd.cu``, ``csrc/swin_block_adapt_bwd.cu``
on the Hopper layer ``csrc/swin_bwd_sm90.cuh``) decide on the host and in
their index arithmetic, in Python, so the CPU tests can hold it to its
rules: the weight grads' row split (``tt_split``), the fixed order of the
final reduction (``reduce_order``), the window-order <-> token-order row maps
of the shifted window partition (``window_token``, ``token_window``), the
GEMM launches of a block with their TMA boxes (``block_gemms``) and the ring
that fits shared memory (``ring_stages``). Each mirrors one C function named
in its docstring; change them together. ``phases_ms`` times a launch by
phase (chip_smoke.py's "K3/K5 by phase" lines, scripts/torch_k35_tiles.py).
"""

import re
from typing import Callable, Dict, List, Tuple

import numpy as np

BM, BK = 128, 64          # rows of an output tile; k-block of the ring (one 128-byte row)
SMEM_LIMIT = 232448       # bytes of shared memory a block can have
RING_BUDGET = 230400      # what the ring and its buffers may take (BwTile)


def tt_split(rows: int, Ka: int, N: int, bn: int, items: int) -> Tuple[int, int]:
    """(rows per split, splits) of a weight grad dW (Ka, N) = A^T dY over
    ``rows`` (swin_bwd_sm90.cuh::tt_split): the nearest whole number of
    splits a tile to ``items`` work items over the 128 x bn tiles, at least 8
    k-blocks a split, splits of equal multiples of 64 rows, the last one
    short."""
    tiles = -(-Ka // BM) * -(-N // bn)
    want = (items + tiles // 2) // tiles
    most = max(1, rows // (8 * BK))
    want = max(1, min(want, most))
    r = -(-rows // want)
    r = -(-r // BK) * BK
    return r, -(-rows // r)


def reduce_order(S: int) -> List[Tuple[int, int]]:
    """The order reduce_jobs sums S partials of an output in
    (swin_bwd_sm90.cuh::reduce_jobs): consecutive ranges [s0, s1), each in
    order, then the ranges in order; one range below 64 partials, else 8."""
    if S < 64:
        return [(0, S)]
    per = -(-S // 8)
    return [(min(S, w * per), min(S, w * per + per)) for w in range(8)]


def window_token(r: np.ndarray, L: int, H: int, W: int, win: int, shift: int) -> np.ndarray:
    """Token of window-order row r (swin_bwd_sm90.cuh::window_token): the
    window partition of the map rolled by -shift."""
    n = win * win
    b, rr = r // L, r % L
    wid, t = rr // n, rr % n
    nww = W // win
    wi, wj = wid // nww, wid % nww
    ti, tj = t // win, t % win
    h = (wi * win + ti + shift) % H
    w = (wj * win + tj + shift) % W
    return b * L + h * W + w


def token_window(t: np.ndarray, L: int, H: int, W: int, win: int, shift: int) -> np.ndarray:
    """Window-order row of token t (swin_bwd_sm90.cuh::token_window), the
    inverse of ``window_token``: window reverse + unshift read backwards."""
    b, tt = t // L, t % L
    h, w = (tt // W - shift) % H, (tt % W - shift) % W
    wi, ti, wj, tj = h // win, h % win, w // win, w % win
    return b * L + (wi * (W // win) + wj) * win * win + ti * win + tj


def ring_stages(bn: int, form: str, out: str) -> Tuple[int, int]:
    """(stages, shared-memory bytes) of a GEMM form's ring at tile width bn
    with output ``out`` ("bf16", "f32", "dual" or "part")
    (swin_bwd_sm90.cuh::BwTile): A 128 x 64 and B bn x 64 bf16 a stage (two
    pairs for DUAL), the per-warp column sums, the staged output rows of the
    two consumer warpgroups (64 rows of bn elements + 16 bytes each; two
    outputs for dual, none for the weight grads' partials) and their 8-byte
    global offsets, the mbarriers, 1024 bytes of alignment."""
    stage = (2 if form == "DUAL" else 1) * (BM * BK * 2 + bn * BK * 2)
    red = 8 * bn * 4
    outs = {"dual": 2, "part": 0}.get(out, 1)
    stg = 2 * outs * 64 * (bn * (4 if out == "f32" else 2) + 16) + 2 * 64 * 8
    stages = min(6, (RING_BUDGET - red - stg) // stage)
    return stages, stages * stage + red + stg + 16 * stages + 1024


def _maps(form: str, M: int, N: int, K: int, bn: int, rows: int = 0) -> List[Tuple[int, ...]]:
    """The TMA boxes of one launch (bw_gemm_launch): (rows, cols, box_rows,
    box_cols) of each bf16 row-major operand, pair 0 then pair 1."""
    if form == "TT":  # A (rows, Ka = M), dY (rows, N), 64 x 64 boxes
        return [(rows, M, 64, 64), (rows, N, 64, 64)]
    a = (M, K, BM, 64)
    b = (K, N, 64, 64) if form == "NN" else (N, K, bn, 64)
    return [a, b]


def block_gemms(kernel: str, B: int, H: int, W: int, C: int, hidden: int, ch: int,
                tiles: Dict[str, int]) -> List[Dict]:
    """The GEMM launches of one K3 or K5 call (swin_block_backward,
    swin_block_adapt_backward), full form, in launch order: name, form, output
    (M, N), depth K, tile width and the TMA boxes."""
    M = B * H * W
    nn, nt, dual, tt = tiles["bn_nn"], tiles["bn_nt"], tiles["bn_dual"], tiles["bn_tt"]
    out = []

    def add(name, form, m, n, k, bn, o, pairs=None, rows=0):
        maps = _maps(form, m, n, k, bn, rows)
        for f, km in pairs or ():
            maps += _maps(f, m, n, km, bn)
        out.append({"name": name, "form": form, "M": m, "N": n, "K": k, "bn": bn, "out": o,
                    "maps": maps})

    add("qkv", "NN", M, 3 * C, C, nn, "bf16")
    add("proj", "NN", M, C, C, nn, "bf16")
    if kernel == "K5":
        add("sa1", "NN", M, ch, C, nn, "bf16")
        add("sa2", "NN", M, C, ch, nn, "f32")
    add("fc1|fc2", "DUAL", M, hidden, C, dual, "dual", [("NT", C)])
    if kernel == "K5":
        add("ma1|ma2", "DUAL", M, ch, C, dual, "dual", [("NT", C)])
        add("dh2", "CAT", M, C, hidden, nt, "f32", [("NT", ch)])
    else:
        add("dh2", "NT", M, C, hidden, nt, "f32")
    wgrads = [("fc2_w", hidden, C), ("fc1_w", C, hidden)]
    if kernel == "K5":
        wgrads += [("ma2_w", ch, C), ("ma1_w", C, ch)]
        add("sa1|sa2", "DUAL", M, ch, C, dual, "dual", [("NT", C)])
        add("dA", "NT", M, C, ch, nt, "bf16")
        wgrads += [("sa2_w", ch, C), ("sa1_w", C, ch)]
    add("dattn", "NT", M, C, C, nt, "bf16")
    add("dh", "NT", M, C, 3 * C, nt, "bf16")
    for name, ka, n in wgrads + [("proj_w", C, C), ("qkv_w", C, 3 * C)]:
        add(name, "TT", ka, n, 0, tt, "part", rows=M)
    return out


# a launch's kernels by phase, from the kernel's name (bw_gemm<BN, FORM, EPI>
# with FORM 0 NN, 1 NT, 2 CAT, 3 DUAL, 4 TT)
PHASES = (("attn_bwd", r"attention_bwd"), ("attn_fwd", r"attention_fwd"),
          ("mlp_dual", r"bw_gemm<\d+, 3,"), ("weight_grad", r"bw_gemm<\d+, 4,"),
          ("recompute", r"bw_gemm<\d+, 0,"), ("act_grad", r"bw_gemm<\d+, [12],"),
          ("reduce", r"reduce_jobs"), ("rows", r"."))


def kernel_phase(name: str) -> str:
    return next(p for p, pat in PHASES if re.search(pat, name))


def phases_ms(fn: Callable[[], object], reps: int = 3) -> Dict[str, float]:
    """Device ms of one call of ``fn`` by phase: torch.profiler over
    ``reps`` calls (after one), each kernel's time summed into its phase."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out: Dict[str, float] = {}
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0:
            k = kernel_phase(e.key)
            out[k] = out.get(k, 0.0) + e.self_device_time_total / reps / 1e3
    return out
