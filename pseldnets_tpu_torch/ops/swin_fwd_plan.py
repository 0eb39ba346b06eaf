"""What kernels K2 and K11 (``csrc/swin_block.cu``, ``csrc/swin_stage.cu`` on
the Hopper forward layer ``csrc/swin_fwd_sm90.cuh``) decide on the host and
in their index arithmetic, in Python, so the CPU tests can hold it to its
rules: the shapes they take (``check_block``, ``check_stage``), the tile
choices they take (``check_tiles``), the launches of one K2 call with their
GEMMs' TMA boxes (``block_launches``), the GEMM ring that fits shared memory
(``gemm_smem``), K11's shared-memory layout (``stage_smem``), the attention's
work items (``att_groups``, ``stage_att_groups``) and the row maps of the
phases (``window_rows``, ``merge_rows``). Each mirrors one C function named
in its docstring; change them together.
"""

from typing import Dict, List, Sequence, Tuple

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


def check_tiles(tiles: Dict[str, int]) -> None:
    """Raise unless every tile width is one the kernels have (bad_tiles) and
    the ring depth is 0 (as deep as fits) or at least 2."""
    for k in TILE_KEYS[:-1]:
        if tiles[k] not in BNS:
            raise ValueError(f"tile width {k}={tiles[k]}: the kernels take {BNS}")
    if tiles["stages"] < 0 or tiles["stages"] == 1:
        raise ValueError(f"ring depth {tiles['stages']}: 0 (as deep as fits) or >= 2")


def staged_bytes(bn: int) -> int:
    """FwdStage<BN>::BYTES: the 2 x 64 rows' offsets of a tile and the one
    before (2048 bytes), then 64 rows of bn bf16 + 16 bytes for each
    consumer warpgroup."""
    return 2048 + 2 * 64 * (2 * bn + 16)


def gemm_smem(bn: int, stages: int = 0) -> Tuple[int, int]:
    """(stages used, dynamic shared-memory bytes) of K2's GEMM launch at
    tile width bn (FwdTile, fwd_gemm_launch): the ring as deep as fits in
    RING_BUDGET with the staged rows (at most 6; ``stages`` caps it), the
    mbarriers, 1024 bytes of alignment."""
    stage = A_BYTES + bn * BK * 2
    fit = min(6, (RING_BUDGET - staged_bytes(bn)) // stage)
    used = min(stages, fit) if stages > 0 else fit
    return used, fit * stage + staged_bytes(bn) + 16 * fit + 1024


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


def _gemm(name: str, M: int, N: int, K: int, bn: int, epi: str, sms: int) -> Dict:
    tiles = -(-M // BM) * -(-N // bn)
    return {"name": name, "kind": "gemm", "M": M, "N": N, "K": K, "bn": bn, "epi": epi,
            "kblocks": -(-K // BK), "tiles": tiles, "grid": min(tiles, sms),
            "smem": gemm_smem(bn)[1],
            # the TMA boxes (tmap): A (M, K) in 128 x 64, W (K, N) in 64 x 64
            "maps": [(M, K, BM, 64), (K, N, 64, 64)]}


def block_launches(B: int, H: int, W: int, C: int, nh: int, hidden: int, merge: bool,
                   tiles: Dict[str, int], sms: int = 132) -> List[Dict]:
    """The launches of one K2 call (swin_block_forward), in order: LN rows
    (rows, K, rows a warp, column groups a lane, blocks of 8 warps), the GEMMs (output,
    depth, tile width, epilogue, k-blocks, tiles, persistent grid, shared
    memory, TMA boxes) and the attention ((window group, head) items)."""
    M = B * H * W
    n_windows = B * (H // 8) * (W // 8)

    def ln(name, rows, K, mode):  # ln_rows_launch: 8 warps a block
        rpw, lanes = ln_rows_per_warp(K, mode), ln_lanes_per_row(K)
        return {"name": name, "kind": "ln", "rows": rows, "K": K, "rows_per_warp": rpw,
                "lanes": lanes, "groups": -(-K // (8 * lanes)), "blocks": -(-rows // (8 * rpw))}

    groups = att_groups(n_windows, nh)
    out = [ln("ln1", M, C, "windows"), _gemm("qkv", M, 3 * C, C, tiles["qkv"], "out", sms),
           {"name": "attention", "kind": "attention", "items": groups * nh, "groups": groups,
            "smem": ATT_SMEM},
           _gemm("proj", M, C, C, tiles["proj"], "res", sms), ln("ln2", M, C, "tokens"),
           _gemm("fc1", M, hidden, C, tiles["fc1"], "out", sms),
           _gemm("fc2", M, C, hidden, tiles["fc2"], "res", sms)]
    if merge:
        out += [ln("merge_ln", M // 4, 4 * C, "merge"),
                _gemm("merge", M // 4, 2 * C, 4 * C, tiles["merge"], "out", sms)]
    return out
