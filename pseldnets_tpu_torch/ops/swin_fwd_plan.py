"""What kernels K2, K11 and K4 (``csrc/swin_block.cu``, ``csrc/swin_stage.cu``,
``csrc/swin_block_adapt.cu`` on the Hopper forward layer
``csrc/swin_fwd_sm90.cuh``) decide on the host and in their index
arithmetic, in Python, so the CPU tests can hold it to its rules: the shapes
they take (``check_block``, ``check_stage``, ``check_adapt_block``), the tile
choices they take (``check_tiles``, ``check_adapt_tiles``), the launches of
one K2 or K4 call with their GEMMs' TMA boxes (``block_launches``,
``adapt_launches``), the GEMM ring that fits shared memory beside its bf16
or float32 staged rows (``gemm_smem``), K11's shared-memory layout
(``stage_smem``), the attention's work items (``att_groups``,
``stage_att_groups``) and the row maps of the phases (``window_rows``,
``merge_rows``). Each mirrors one C function named in its docstring; change
them together. ``launches_ms`` times a call's launches in launch order (a
phase a launch) on the card.
"""

import json
import os
import re
import tempfile
from typing import Callable, Dict, List, Sequence, Tuple

import numpy as np

from .swin_bwd_plan import token_window, window_token  # noqa: F401  (the window partition's maps)

BM, BK = 128, 64          # rows of an output tile; k-block of the ring (one 128-byte row)
A_BYTES = BM * BK * 2     # one A box of a stage
SMEM_LIMIT = 232448       # bytes of shared memory a block can have
RING_BUDGET = 230400      # what a ring and its staged rows may take (FW_RING_BUDGET)
BNS = (64, 128, 192)      # the GEMMs' tile widths
WIN_N, HD = 64, 24        # tokens a window, head dim
ATT_END = 2 * WIN_N * 128 + 32 * 128  # AttFwdSmem::END: Q, K and V^T tiles
ATT_SMEM = ATT_END + 1024
ATT_SLOTS = 3             # K11's attention items in flight a block (one a warpgroup)
LN_GROUPS = 6             # MAX_LN_GROUPS: LN rows of at most 8 x 32 x 6 values
MAX_C = 768
MAX_DEPTH = 31
TILE_KEYS = ("qkv", "proj", "fc1", "fc2", "merge", "stages")
# K4's tile choices (swin_block_adapt.cu::AdaptTiles): its bf16 GEMMs' widths
# and the ring depth; its float32 forms (sa2, fc2 + ma2) run at F32_BN only
ADAPT_TILE_KEYS = ("qkv", "proj", "sa1", "fc1", "ma1", "stages")
F32_BN = 64               # FW_BN_F32
ADAPT_PAD = 32            # the padded adapter width is a multiple of this
# bytes of a staged value by epilogue (fwd_elem): bf16, float32 for K4's forms
EPI_ELEM = {"out": 2, "res": 2, "branch": 4, "adapt_out": 4}


def check_block(H: int, W: int, C: int, nh: int, window: int, hidden: int,
                merge: bool = False, masks: bool = False) -> None:
    """Raise unless K2 takes the block (swin_fwd_sm90.cuh::bad_block and
    swin_block_forward's checks): 8x8 windows, head dim 24, C % 32 == 0, C
    <= 768, hidden % 8 == 0, whole windows; the merge on an even map with
    4C <= 1536, never with drop-path masks."""
    if masks and merge:
        raise ValueError("drop-path masks do not combine with the merge fold "
                         "(training calls the block without merge_params)")
    if (window * window != WIN_N or nh < 1 or C % nh or C // nh != HD or C % 32 or C > MAX_C
            or hidden < 8 or hidden % 8 or H % window or W % window):
        raise NotImplementedError(
            f"the Swin block kernels take 8x8 windows, head dim 24, C % 32 == 0, C <= "
            f"{MAX_C}, hidden % 8 == 0 and whole windows (got window={window}, nh={nh}, "
            f"C={C}, hidden={hidden}, {H}x{W})")
    if merge and (H % 2 or W % 2):
        raise ValueError(f"PatchMerging needs an even map, got {H}x{W}")
    if merge and 4 * C > 8 * 32 * LN_GROUPS:
        raise NotImplementedError(f"the merge's LayerNorm rows take 4C <= "
                                  f"{8 * 32 * LN_GROUPS}, got C={C}")


def check_stage(H: int, W: int, C: int, nh: int, window: int, hidden: int,
                shifts: Sequence[int]) -> None:
    """Raise unless K11 takes the stage (swin_stage_forward's checks): K2's
    shapes, 1..31 blocks, shifts 0 or one positive base shift."""
    check_block(H, W, C, nh, window, hidden)
    if not 1 <= len(shifts) <= MAX_DEPTH:
        raise NotImplementedError(f"the Swin stage kernel takes 1..{MAX_DEPTH} blocks, "
                                  f"got {len(shifts)}")
    if set(shifts) - {0, max(shifts)}:
        raise ValueError(f"shifts must be 0 or one base shift, got {tuple(shifts)}")


STAGE_BNS = (64, 128)      # K11's tile widths (swin_stage.cu::gemm_phase)


def check_stage_tiles(tiles: Dict[str, int]) -> None:
    """Raise unless K11 takes K2's tile widths at the stage's width
    (swin_stage_forward): 64 or 128 for qkv, proj, fc1 and fc2."""
    check_tiles(tiles)
    for k in ("qkv", "proj", "fc1", "fc2"):
        if tiles[k] not in STAGE_BNS:
            raise NotImplementedError(f"tile width {k}={tiles[k]}: the Swin stage kernel "
                                      f"takes {STAGE_BNS}")


def check_adapt_block(H: int, W: int, C: int, nh: int, window: int, hidden: int,
                      ch: int) -> None:
    """Raise unless K4 takes the block (swin_block_adapt.cu::bad_adapt):
    K2's shapes without the merge, and a padded adapter width ch, a
    positive multiple of 32."""
    check_block(H, W, C, nh, window, hidden)
    if ch < ADAPT_PAD or ch % ADAPT_PAD:
        raise NotImplementedError(f"the adapter block kernel takes a padded adapter width "
                                  f"% {ADAPT_PAD} == 0, got {ch}")


def check_adapt_tiles(tiles: Dict[str, int]) -> None:
    """Raise unless every K4 tile width is one the kernel has (bad_adapt)
    and the ring depth is 0 or >= 2."""
    for k in ADAPT_TILE_KEYS[:-1]:
        if tiles[k] not in BNS:
            raise ValueError(f"tile width {k}={tiles[k]}: the adapter block kernel takes {BNS}")
    if tiles["stages"] < 0 or tiles["stages"] == 1:
        raise ValueError(f"ring depth {tiles['stages']}: 0 (as deep as fits) or >= 2")


def check_tiles(tiles: Dict[str, int]) -> None:
    """Raise unless every tile width is one the kernels have (bad_tiles) and
    the ring depth is 0 (as deep as fits) or at least 2."""
    for k in TILE_KEYS[:-1]:
        if tiles[k] not in BNS:
            raise ValueError(f"tile width {k}={tiles[k]}: the kernels take {BNS}")
    if tiles["stages"] < 0 or tiles["stages"] == 1:
        raise ValueError(f"ring depth {tiles['stages']}: 0 (as deep as fits) or >= 2")


def staged_bytes(bn: int, elem: int = 2) -> int:
    """FwdStage<BN, ELEM>::BYTES: the 2 x 64 rows' offsets of a tile and the
    one before (2048 bytes), then 64 rows of bn values of ``elem`` bytes
    (bf16, or float32 for K4's forms) + 16 bytes for each consumer
    warpgroup."""
    return 2048 + 2 * 64 * (elem * bn + 16)


def gemm_smem(bn: int, stages: int = 0, elem: int = 2) -> Tuple[int, int]:
    """(stages used, dynamic shared-memory bytes) of a forward GEMM launch
    at tile width bn (FwdTile<BN, ELEM>, fwd_gemm_launch): the ring as deep
    as fits in RING_BUDGET with the staged rows of ``elem``-byte values (at
    most 6; ``stages`` caps it), the mbarriers, 1024 bytes of alignment."""
    stage = A_BYTES + bn * BK * 2
    fit = min(6, (RING_BUDGET - staged_bytes(bn, elem)) // stage)
    used = min(stages, fit) if stages > 0 else fit
    return used, fit * stage + staged_bytes(bn, elem) + 16 * fit + 1024


def stage_smem(tiles: Dict[str, int]) -> Dict[str, int]:
    """K11's shared-memory layout (swin_stage_forward): a ring sized for the
    widest of the stage's four GEMM tiles, at least deep enough to hold the
    two consumer warpgroups' attention tiles, its staged rows, the
    mbarriers."""
    bn = max(tiles[k] for k in ("qkv", "proj", "fc1", "fc2"))
    stage = A_BYTES + bn * BK * 2
    stg = staged_bytes(bn)
    S = min(6, (RING_BUDGET - stg) // stage)
    if tiles["stages"] > 0:
        S = min(S, tiles["stages"])
    if S * stage < ATT_SLOTS * ATT_END:
        S = -(-ATT_SLOTS * ATT_END // stage)
    return {"S": S, "stage_bytes": stage, "stg_bytes": stg,
            "smem": S * stage + stg + 16 * S + 1024}


def att_groups(n_windows: int, nh: int) -> int:
    """K2's window groups a head (swin_bwd_sm90.cuh::att_groups): every
    window once, about 512 (window group, head) items in all."""
    return min(n_windows, max(1, 512 // nh))


def stage_att_groups(n_windows: int, nh: int, grid: int) -> int:
    """K11's window groups a head (swin_stage_forward): about one (window
    group, head) item per consumer warpgroup of the grid."""
    return max(1, min(n_windows, -(-ATT_SLOTS * grid // nh)))


def window_rows(B: int, H: int, W: int, window: int, shift: int) -> np.ndarray:
    """The token each window-order row reads (LN1 rows) and the token each
    proj output row goes to: window_token over the B H W rows."""
    return window_token(np.arange(B * H * W), H * W, H, W, window, shift)


def merge_token(r: np.ndarray, L: int, W: int, piece: int) -> np.ndarray:
    """Token of piece p (0 (h0,w0), 1 (h1,w0), 2 (h0,w1), 3 (h1,w1)) of
    merged row r (swin_fwd_sm90.cuh::merge_token)."""
    l4, w2 = L // 4, W // 2
    b, rr = r // l4, r % l4
    i, j = rr // w2, rr % w2
    return b * L + (2 * i + (piece & 1)) * W + 2 * j + (piece >> 1)


def merge_rows(B: int, H: int, W: int) -> np.ndarray:
    """(B H W / 4, 4): the tokens of each merged row's 4C gather, in order."""
    r = np.arange(B * H * W // 4)
    return np.stack([merge_token(r, H * W, W, p) for p in range(4)], axis=1)


def ln_rows_per_warp(K: int, mode: str) -> int:
    """Rows a warp of the LN row pass takes at a time over rows of K values
    (swin_fwd_sm90.cuh::ln_rows_per_warp): two rows of 16 lanes each when K
    <= 128, else one of 32 lanes; for token rows ("tokens", no row map to
    work out before the loads), four, two or one such sets in flight at
    once as K grows ("windows" and "merge" rows one set)."""
    rpw = 2 if K <= 128 else 1
    if mode != "tokens":
        return rpw
    return rpw * (4 if K <= 256 else 2 if K <= 768 else 1)


def ln_lanes_per_row(K: int) -> int:
    """Lanes that share a row of the LN row pass (ln_rows_any's SEG)."""
    return 16 if K <= 128 else 32


def _gemm(name: str, M: int, N: int, K: int, bn: int, epi: str, sms: int,
          K1: int = 0) -> Dict:
    """A GEMM launch; K1 > 0: F_ADAPT_OUT's second chain (M, K1) . (K1, N)
    through the same ring after the first's k-blocks."""
    tiles = -(-M // BM) * -(-N // bn)
    elem = EPI_ELEM[epi]
    maps = [(M, K, BM, 64), (K, N, 64, 64)]
    if K1:
        maps += [(M, K1, BM, 64), (K1, N, 64, 64)]
    return {"name": name, "kind": "gemm", "M": M, "N": N, "K": K, "K1": K1, "bn": bn,
            "epi": epi, "elem": elem, "kblocks": -(-K // BK) + -(-K1 // BK), "tiles": tiles,
            "grid": min(tiles, sms), "staged": staged_bytes(bn, elem),
            "smem": gemm_smem(bn, elem=elem)[1],
            # the TMA boxes (tmap): A (M, K) in 128 x 64, W (K, N) in 64 x 64
            "maps": maps}


def _ln(name: str, rows: int, K: int, mode: str, in_bytes: int = 2) -> Dict:
    """An LN rows launch (ln_rows_launch: 8 warps a block) over rows of K
    values of ``in_bytes`` (bf16, or K4's float32 y)."""
    rpw, lanes = ln_rows_per_warp(K, mode), ln_lanes_per_row(K)
    return {"name": name, "kind": "ln", "rows": rows, "K": K, "rows_per_warp": rpw,
            "lanes": lanes, "groups": -(-K // (8 * lanes)), "blocks": -(-rows // (8 * rpw)),
            "in_bytes": in_bytes}


def _attention(n_windows: int, nh: int) -> Dict:
    groups = att_groups(n_windows, nh)
    return {"name": "attention", "kind": "attention", "items": groups * nh, "groups": groups,
            "smem": ATT_SMEM}


def block_launches(B: int, H: int, W: int, C: int, nh: int, hidden: int, merge: bool,
                   tiles: Dict[str, int], sms: int = 132) -> List[Dict]:
    """The launches of one K2 call (swin_block_forward), in order: LN rows
    (rows, K, rows a warp, column groups a lane, blocks of 8 warps), the GEMMs (output,
    depth, tile width, epilogue, k-blocks, tiles, persistent grid, shared
    memory, TMA boxes) and the attention ((window group, head) items)."""
    M = B * H * W
    n_windows = B * (H // 8) * (W // 8)
    out = [_ln("ln1", M, C, "windows"), _gemm("qkv", M, 3 * C, C, tiles["qkv"], "out", sms),
           _attention(n_windows, nh),
           _gemm("proj", M, C, C, tiles["proj"], "res", sms), _ln("ln2", M, C, "tokens"),
           _gemm("fc1", M, hidden, C, tiles["fc1"], "out", sms),
           _gemm("fc2", M, C, hidden, tiles["fc2"], "res", sms)]
    if merge:
        out += [_ln("merge_ln", M // 4, 4 * C, "merge"),
                _gemm("merge", M // 4, 2 * C, 4 * C, tiles["merge"], "out", sms)]
    return out


ADAPT_PHASES = ("ln1", "qkv", "attention", "proj", "sa1", "sa2", "ln2", "fc1", "ma1", "fc2")


def adapt_launches(B: int, H: int, W: int, C: int, nh: int, hidden: int, ch: int,
                   tiles: Dict[str, int], sms: int = 132) -> List[Dict]:
    """The launches of one K4 call (swin_block_adapt_forward), in order
    (``ADAPT_PHASES``): K2's LN1, qkv and attention; proj (F_OUT through the
    window -> token map); sa1 with GELU; sa2 (F_BRANCH, float32 y); LN2 over
    the float32 rows; fc1 and ma1 with GELU; fc2 and ma2 on one tile
    (F_ADAPT_OUT: the second chain over the adapter's ch); the float32
    forms at width F32_BN."""
    M = B * H * W
    n_windows = B * (H // 8) * (W // 8)
    return [_ln("ln1", M, C, "windows"), _gemm("qkv", M, 3 * C, C, tiles["qkv"], "out", sms),
            _attention(n_windows, nh),
            dict(_gemm("proj", M, C, C, tiles["proj"], "out", sms), map="win_to_tok"),
            _gemm("sa1", M, ch, C, tiles["sa1"], "out", sms),
            _gemm("sa2", M, C, ch, F32_BN, "branch", sms),
            _ln("ln2", M, C, "tokens", in_bytes=4),
            _gemm("fc1", M, hidden, C, tiles["fc1"], "out", sms),
            _gemm("ma1", M, ch, C, tiles["ma1"], "out", sms),
            _gemm("fc2", M, C, hidden, F32_BN, "adapt_out", sms, K1=ch)]


def adapt_phase_flops(M: int, C: int, hidden: int, ch: int) -> Dict[str, int]:
    """bf16 FLOPs of K4's GEMM and attention phases on M rows (adapter
    width ch as the kernel runs it, padded)."""
    return {"qkv": 6 * M * C * C, "attention": 4 * M * 64 * C, "proj": 2 * M * C * C,
            "sa1": 2 * M * C * ch, "sa2": 2 * M * ch * C, "fc1": 2 * M * C * hidden,
            "ma1": 2 * M * C * ch, "fc2": 2 * M * hidden * C + 2 * M * ch * C}


def launches_ms(fn: Callable[[], object], n: int, reps: int = 3) -> Tuple[List[float], List[str]]:
    """Device ms of each of the ``n`` launches of one call of ``fn``, in
    launch order, and their kernels' names: torch.profiler over ``reps``
    calls (after one), the trace's kernel events in time order, PyTorch's
    own (``at::`` kernels: a fill of default masks) left out. Raises unless
    the calls show ``n`` launches each, in the same order; a trace that
    does not (the profiler recorded nothing, or dropped kernel events) is
    taken again, up to three times in all."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    marker = torch.zeros(1, device="cuda")
    for attempt in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            marker.add_(1)  # the profiler may miss the first kernel of its window
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            prof.export_chrome_trace(path)
            with open(path) as f:
                ev = [e for e in json.load(f)["traceEvents"]
                      if e.get("cat") == "kernel" and not re.search(r"\bat::", e["name"])]
        finally:
            os.unlink(path)
        ev.sort(key=lambda e: e["ts"])
        ev = ev[-n * reps:]
        if len(ev) == n * reps and all(e["name"] == ev[i % n]["name"] for i, e in enumerate(ev)):
            break
        if attempt == 2:
            raise RuntimeError(f"expected {reps} calls of {n} launches in order, got "
                               + ", ".join(e["name"][:40] for e in ev[:2 * n]))
    ms = [0.0] * n
    for i, e in enumerate(ev):
        ms[i % n] += e["dur"] / 1e3 / reps
    return ms, [e["name"] for e in ev[:n]]
