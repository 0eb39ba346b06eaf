"""What kernels K3 and K5 decide on the host and in their index arithmetic
(csrc/swin_bwd_sm90.cuh cannot be compiled here), through its Python mirror
``ops/swin_bwd_plan.py``: the weight grads' row split, the fixed order of
the final reduction, the window-order <-> token-order row maps of the
shifted window partition (against the plain version's window_partition and
roll), and the GEMM launches' TMA boxes and rings against the rules the
wrappers enforce. Change the mirror with the kernels."""

import itertools

import numpy as np
import pytest
import torch

from pseldnets_tpu_torch.models.htsat import window_partition, window_reverse
from pseldnets_tpu_torch.ops import swin_block_vjp, swin_bwd_plan as plan
import torch_threads  # noqa: F401  (each xdist worker's share of the cores)

# HTSAT's stages: (H = W, C, nh); hidden 4 C, the adapter width C / 2 padded to 32
STAGES = ((64, 96, 4), (32, 192, 8), (16, 384, 16), (8, 768, 32))


def _ch(C):
    return -(-(C // 2) // 32) * 32


@pytest.mark.parametrize("bn,items", [(128, 264), (64, 264), (128, 132), (128, 528)])
@pytest.mark.parametrize("B", [32, 1, 2, 3])
def test_weight_grad_split_covers_every_row_once(B, bn, items):
    """At every stage and each weight grad of K3 and K5 (fc1, fc2, proj,
    qkv, the adapters'), the splits cover rows 0..M-1 exactly once in equal
    multiples of 64 (the last one short, none empty), at least 8 k-blocks a
    split when there are several, and the plan is a pure function of the
    shape: the same from a second call."""
    for H, C, _ in STAGES:
        M, hid, ch = B * H * H, 4 * C, _ch(C)
        for Ka, N in ((hid, C), (C, hid), (C, C), (C, 3 * C), (ch, C), (C, ch)):
            rps, splits = plan.tt_split(M, Ka, N, bn, items)
            assert (rps, splits) == plan.tt_split(M, Ka, N, bn, items)
            assert rps % plan.BK == 0 and splits >= 1
            hits = np.zeros(M, np.int64)
            for s in range(splits):
                lo, hi = s * rps, min(M, (s + 1) * rps)
                assert hi > lo
                hits[lo:hi] += 1
            assert (hits == 1).all()
            assert splits == 1 or rps >= 8 * plan.BK


@pytest.mark.parametrize("S", [1, 2, 7, 63, 64, 65, 86, 256, 1024, 1025])
def test_reduction_order_is_fixed(S):
    """The final reduction sums every partial once, in consecutive ranges
    taken in order: the order depends on S alone."""
    ranges = plan.reduce_order(S)
    assert ranges == plan.reduce_order(S)
    assert [s for lo, hi in ranges for s in range(lo, hi)] == list(range(S))
    assert len(ranges) == (1 if S < 64 else 8)


@pytest.mark.parametrize("B,stage,shift", [(32, i, s) for i in range(4) for s in (0, 4)] + [
    (b, i, s) for b, i, s in itertools.product((1, 2, 3), range(4), (0, 4))])
def test_row_maps_cover_every_token_once(B, stage, shift):
    """window_token is a permutation of the B H W tokens equal to the plain
    version's window_partition of the map rolled by -shift; token_window is
    its inverse, equal to window_reverse then the roll back."""
    H, C, _ = STAGES[stage]
    L, win = H * H, 8
    tok = torch.arange(B * L).reshape(B, H, H, 1)
    rolled = torch.roll(tok, shifts=(-shift, -shift), dims=(1, 2)) if shift else tok
    want = window_partition(rolled, win).reshape(-1).numpy()
    r = np.arange(B * L)
    wt = plan.window_token(r, L, H, H, win, shift)
    assert (wt == want).all()
    assert np.array_equal(np.sort(wt), r)
    tw = plan.token_window(r, L, H, H, win, shift)
    assert (tw[wt] == r).all() and (wt[tw] == r).all()
    back = window_reverse(torch.from_numpy(r).reshape(-1, win * win, 1), win, H, H)
    if shift:
        back = torch.roll(back, shifts=(shift, shift), dims=(1, 2))
    assert (back.reshape(-1).numpy() == tw).all()


@pytest.mark.parametrize("kernel", ["K3", "K5"])
@pytest.mark.parametrize("tiles", [{}, {"bn_nn": 64, "bn_nt": 64, "bn_dual": 64, "bn_tt": 64}])
@pytest.mark.parametrize("B,stage", [(32, i) for i in range(4)] + [(1, 3), (3, 0)])
def test_gemm_plans_keep_the_tma_and_ring_rules(kernel, tiles, B, stage):
    """Every GEMM a K3 or K5 call launches, at each stage and tile width:
    each TMA box reads a bf16 matrix whose row stride is a multiple of 16
    bytes, 64 columns (one 128-byte swizzle row) by at most 256 rows, the
    matrix under 2^31 elements a dimension; N, K and the output's row stride
    are multiples of 8 (16-byte stores and bulk copies); the ring of the
    form and tile, with its staged output rows, fits in a block's shared
    memory with at least 2 stages."""
    t = dict(swin_block_vjp.TILES, **tiles)
    H, C, _ = STAGES[stage]
    launches = plan.block_gemms(kernel, B, H, H, C, 4 * C, _ch(C) if kernel == "K5" else 0, t)
    assert len(launches) == (10 if kernel == "K3" else 19)
    for g in launches:
        assert g["N"] % 8 == 0 and g["K"] % 8 == 0 and g["bn"] in (64, 128), g["name"]
        for rows, cols, box_rows, box_cols in g["maps"]:
            assert (cols * 2) % 16 == 0 and box_cols * 2 == 128, g["name"]
            assert 1 <= box_rows <= 256 and 0 < rows < 2 ** 31 and cols < 2 ** 31, g["name"]
        stages, smem = plan.ring_stages(g["bn"], g["form"], g["out"])
        assert 2 <= stages <= 6 and smem <= plan.SMEM_LIMIT, g["name"]
        if t["stages"]:
            assert t["stages"] >= 2
