"""What kernels K2 and K11 decide on the host and in their index arithmetic
(csrc/swin_fwd_sm90.cuh cannot be compiled here), through its Python mirror
``ops/swin_fwd_plan.py`` and the plain versions of K2's phases in
``ops/swin_block.py``: the shapes the kernels take and refuse (before any
launch), the launches of a K2 call with their GEMMs' TMA boxes and rings
and K11's shared-memory layout at every served and trained shape, the row
maps of the phases against the plain path's window partition, roll and
PatchMerging gather, and the phases chained as the C entry chains them
against ``swin_block_plain``'s bits. Change the mirror with the kernels."""

import numpy as np
import pytest
import torch

from pseldnets_tpu_torch.models.factory import init_weights
from pseldnets_tpu_torch.models.htsat import (PatchMerging, SwinTransformerBlock,
                                              window_partition, window_reverse)
from pseldnets_tpu_torch.ops import swin_block, swin_stage
from pseldnets_tpu_torch.ops import swin_fwd_plan as plan
import torch_threads  # noqa: F401  (each xdist worker's share of the cores)

# HTSAT's stages: (H = W, C, nh, depth); hidden 4 C
STAGES = ((64, 96, 4, 2), (32, 192, 8, 2), (16, 384, 16, 6), (8, 768, 32, 2))


def _served_and_trained():
    """Every (stage, shift, merge, masks) block form HTSAT serves or trains."""
    forms = []
    for i in range(4):
        shifts = (0, 4) if i < 3 else (0,)
        for s in shifts:
            forms.append((i, s, False, False))
            forms.append((i, s, False, True))
        if i < 3:
            forms.append((i, 4, True, False))
    return forms


@pytest.mark.parametrize("B", [32, 1, 2, 3, 128])
@pytest.mark.parametrize("stage,shift,merge,masks", _served_and_trained())
def test_plan_covers_every_served_and_trained_block(B, stage, shift, merge, masks):
    """At every block form HTSAT serves (merge fold in the last block of
    stages 0-2) or trains (drop-path masks): the shape is taken; the call
    launches LN1, qkv, attention, proj, LN2, fc1, fc2 (+ the merge's LN rows
    and GEMM) in that order; every GEMM's TMA boxes read a bf16 matrix whose
    row stride is a multiple of 16 bytes, 64 columns (one 128-byte swizzle
    row) by at most 256 rows, under 2^31 elements a dimension; N and K are
    multiples of 8 (16-byte stores); its ring of at least 2 stages, with the
    staged rows, fits a block's shared memory; the LN rows fit a lane's
    column groups; the attention items cover every (window, head)."""
    H, C, nh, _ = STAGES[stage]
    hidden = 4 * C
    plan.check_block(H, H, C, nh, 8, hidden, merge, masks)
    tiles = swin_block.tiles_for(C)
    plan.check_tiles(tiles)
    launches = plan.block_launches(B, H, H, C, nh, hidden, merge, tiles)
    names = ["ln1", "qkv", "attention", "proj", "ln2", "fc1", "fc2"]
    assert [g["name"] for g in launches] == names + (["merge_ln", "merge"] if merge else [])
    M, n_windows = B * H * H, B * (H // 8) ** 2
    for g in launches:
        if g["kind"] == "gemm":
            assert g["N"] % 8 == 0 and g["K"] % 8 == 0 and g["bn"] in plan.BNS, g["name"]
            for rows, cols, box_rows, box_cols in g["maps"]:
                assert (cols * 2) % 16 == 0 and box_cols * 2 == 128, g["name"]
                assert 1 <= box_rows <= 256 and 0 < rows < 2 ** 31 and cols < 2 ** 31, g["name"]
            stages, smem = plan.gemm_smem(g["bn"], tiles["stages"])
            assert 2 <= stages <= 6 and smem <= plan.SMEM_LIMIT, g["name"]
            assert 1 <= g["grid"] <= 132 and g["tiles"] >= g["grid"]
            assert g["kblocks"] * plan.BK >= g["K"] > (g["kblocks"] - 1) * plan.BK
        elif g["kind"] == "ln":
            assert g["groups"] <= plan.LN_GROUPS and g["K"] % 8 == 0
            assert g["rows"] == (M // 4 if g["name"] == "merge_ln" else M)
            assert g["blocks"] * 8 * g["rows_per_warp"] >= g["rows"]
            assert g["K"] <= 8 * g["lanes"] * g["groups"] and g["lanes"] in (16, 32)
            # registers: a lane holds its row sets' values in flight, at most 48
            rows_at_once = g["rows_per_warp"] * g["lanes"] // 32
            assert rows_at_once * g["groups"] * 8 <= 48
        else:
            groups = g["groups"]
            assert g["items"] == groups * nh and 1 <= groups <= n_windows
            covered = {(grp + k * groups) for grp in range(groups)
                       for k in range(-(-n_windows // groups)) if grp + k * groups < n_windows}
            assert covered == set(range(n_windows))
            assert g["smem"] <= plan.SMEM_LIMIT


@pytest.mark.parametrize("stage", range(4))
@pytest.mark.parametrize("stages", [0, 2, 3])
def test_stage_layout_fits_the_card(stage, stages):
    """K11 at each stage shape and depth, with K2's tile widths: the stage
    is taken; one block's shared memory (a ring for the widest tile, deep
    enough for the two consumer warpgroups' attention tiles, the staged
    rows, the mbarriers) fits the card, so one block a SM can run; about one
    attention item a consumer warpgroup of a 132-SM grid covers every
    window."""
    H, C, nh, depth = STAGES[stage]
    shifts = tuple((0, 4)[d % 2] if stage < 3 else 0 for d in range(depth))
    plan.check_stage(H, H, C, nh, 8, 4 * C, shifts)
    tiles = dict(swin_block.tiles_for(C), stages=stages)
    lay = plan.stage_smem(tiles)
    assert lay["smem"] <= plan.SMEM_LIMIT
    assert lay["S"] >= 2 and lay["S"] * lay["stage_bytes"] >= plan.ATT_SLOTS * plan.ATT_END
    bn = max(tiles[k] for k in ("qkv", "proj", "fc1", "fc2"))
    assert lay["stage_bytes"] == plan.A_BYTES + bn * 128 and lay["stage_bytes"] % 1024 == 0
    for B in (32, 1, 2):
        n_windows = B * (H // 8) ** 2
        groups = plan.stage_att_groups(n_windows, nh, 132)
        assert 1 <= groups <= n_windows
        assert groups * nh >= min(n_windows * nh, plan.ATT_SLOTS * 132)


@pytest.mark.parametrize("C,nh,window,hidden,H,merge,masks,exc", [
    (128, 4, 8, 512, 16, False, False, NotImplementedError),  # head dim 32
    (96, 4, 7, 384, 14, False, False, NotImplementedError),  # 7x7 windows
    (72, 3, 8, 288, 16, False, False, NotImplementedError),  # C % 32
    (96, 4, 8, 384, 12, False, False, NotImplementedError),  # a part window
    (1536, 64, 8, 6144, 8, False, False, NotImplementedError),  # C > 768
    (96, 4, 8, 100, 16, False, False, NotImplementedError),  # hidden % 8
    (96, 4, 8, 384, 16, True, True, ValueError),  # masks with the merge
    (768, 32, 8, 3072, 16, True, False, NotImplementedError),  # 4C > 1536
])
def test_plan_refuses_what_the_kernels_do_not_take(C, nh, window, hidden, H, merge, masks,
                                                    exc):
    with pytest.raises(exc):
        plan.check_block(H, H, C, nh, window, hidden, merge, masks)


@pytest.mark.parametrize("shifts,exc", [((), NotImplementedError), ((0,) * 32, NotImplementedError),
                                        ((0, 4, 2), ValueError)])
def test_plan_refuses_stages_the_kernel_does_not_take(shifts, exc):
    with pytest.raises(exc):
        plan.check_stage(16, 16, 96, 4, 8, 384, shifts)


@pytest.mark.parametrize("tiles", [{"qkv": 96}, {"fc2": 256}, {"stages": 1}, {"stages": -1}])
def test_plan_refuses_tiles_the_kernels_lack(tiles):
    with pytest.raises(ValueError):
        plan.check_tiles(dict(swin_block.DEFAULT_TILES, **tiles))


@pytest.mark.parametrize("key", ["qkv", "proj", "fc1", "fc2"])
def test_stage_plan_refuses_the_widest_tile(key):
    """K11 takes widths 64 and 128 (K2 also 192, which TILES leaves to the
    single-GEMM tests); the merge's width is K2's alone."""
    with pytest.raises(NotImplementedError):
        plan.check_stage_tiles(dict(swin_block.DEFAULT_TILES, **{key: 192}))
    plan.check_stage_tiles(dict(swin_block.DEFAULT_TILES, merge=192))


def test_tile_table_is_taken_at_every_stage():
    """Every entry of TILES is a form K2 and K11 both have (K11 runs K2's
    widths, so its stages give K2's bits); an unlisted width takes the
    defaults."""
    plan.check_stage_tiles(swin_block.DEFAULT_TILES)
    for C, t in swin_block.TILES.items():
        plan.check_tiles(t)
        plan.check_stage_tiles(t)
        assert swin_block.tile_args(C) == tuple(t[k] for k in plan.TILE_KEYS)
    assert swin_block.tiles_for(32) == swin_block.DEFAULT_TILES


@pytest.mark.parametrize("C,nh,window,H,merge", [(64, 2, 8, 16, False), (96, 4, 7, 14, False),
                                                 (768, 32, 8, 16, True)])
def test_wrappers_refuse_before_any_launch(monkeypatch, C, nh, window, H, merge):
    """A shape the kernels do not take raises in the wrappers before
    anything is built or launched. The tensors lie on the meta device
    (neither a CPU tensor, which takes the plain version, nor a card), with
    the wrappers' device check taken out so that the shape check is
    reached."""
    for mod in (swin_block, swin_stage):
        monkeypatch.setattr(mod, "check_cuda_tensor", lambda *a, **k: None)
    gen = torch.Generator().manual_seed(C)
    blk = SwinTransformerBlock(C, (H, H), nh, window, shift_size=0)
    mrg = PatchMerging((H, H), C) if merge else None
    for m in (blk, mrg):
        if m is not None:
            init_weights(m, gen)
    p = swin_block.prepare_block(blk.eval(), torch.bfloat16, mrg)
    x = torch.empty(2, H * H, C, device="meta", dtype=torch.bfloat16)
    before = (swin_block.KERNEL.launches, swin_stage.KERNEL.launches)
    libs = (swin_block.KERNEL._lib, swin_stage.KERNEL._lib)
    with pytest.raises(NotImplementedError):
        swin_block.swin_block_fused(x, p)
    if not merge:  # a stage has no merge: the last case's stage shape is taken
        layer = torch.nn.Module()
        layer.blocks = torch.nn.ModuleList([blk])
        with pytest.raises(NotImplementedError):
            swin_stage.swin_stage_fused(x, swin_stage.prepare_stage(layer, torch.bfloat16))
    assert (swin_block.KERNEL.launches, swin_stage.KERNEL.launches) == before
    assert (swin_block.KERNEL._lib, swin_stage.KERNEL._lib) == libs


@pytest.mark.parametrize("B,stage,shift", [(b, i, s) for b in (1, 2, 3) for i in range(4)
                                           for s in ((0, 4) if i < 3 else (0,))])
def test_row_maps_reproduce_the_plain_permutations(B, stage, shift):
    """The token each window-order row reads (LN1 rows) is the plain path's
    window partition of the map rolled by -shift; the token each proj row
    goes to is its window reverse rolled back by +shift (the same map
    read as a scatter); token_window inverts it; the merge's 4C gather is
    PatchMerging's (h0,w0) (h1,w0) (h0,w1) (h1,w1) concat."""
    H, C, _, _ = STAGES[stage]
    L = H * H
    tok = torch.arange(B * L).reshape(B, H, H, 1)
    rolled = torch.roll(tok, shifts=(-shift, -shift), dims=(1, 2)) if shift else tok
    want = window_partition(rolled, 8).reshape(-1).numpy()
    rows = plan.window_rows(B, H, H, 8, shift)
    assert (rows == want).all()
    r = np.arange(B * L)
    assert (plan.token_window(rows, L, H, H, 8, shift) == r).all()
    vals = torch.from_numpy(r).reshape(-1, 64, 1)  # row r's value, in window order
    back = window_reverse(vals, 8, H, H)
    if shift:
        back = torch.roll(back, shifts=(shift, shift), dims=(1, 2))
    scattered = np.empty(B * L, np.int64)
    scattered[rows] = r
    assert (back.reshape(-1).numpy() == scattered).all()
    v = tok.reshape(B, H, H, 1)
    cat = torch.cat([v[:, 0::2, 0::2], v[:, 1::2, 0::2], v[:, 0::2, 1::2], v[:, 1::2, 1::2]],
                    dim=-1).reshape(-1, 4).numpy()
    assert (plan.merge_rows(B, H, H) == cat).all()


def _small_block(gen, shift, merge):
    H, C, nh = 16, 48, 2  # head dim 24, 8x8 windows: the kernel's shapes, small
    blk = SwinTransformerBlock(C, (H, H), nh, 8, shift_size=shift)
    mrg = PatchMerging((H, H), C) if merge else None
    for m in (blk, mrg):
        if m is not None:
            init_weights(m, gen)
    with torch.no_grad():  # non-trivial norms and biases
        for name, t in blk.named_parameters():
            if "norm" in name or name.endswith("bias"):
                t.add_(0.3 * torch.randn(t.shape, generator=gen))
    return H, C, blk.eval(), (mrg.eval() if mrg is not None else None)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shift,merge,masks", [
    (0, False, None), (4, False, None), (0, True, None), (4, True, None),
    (4, False, "keep"), (0, False, "dropped"), (4, False, "zeros")])
def test_chained_phases_give_the_plain_bits(dtype, shift, merge, masks):
    """K2's phases in plain PyTorch (LN rows through the window map, the
    GEMM forms with their bias, GELU and residual epilogues, the residual
    scattered through the window -> token map, the merge's LN rows over
    its 4C gather), chained as swin_block_forward chains its launches, give
    swin_block_plain's bits: masks that keep, drop one branch, or are zero
    for every image, shifted and unshifted, with and without the merge."""
    gen = torch.Generator().manual_seed(shift + 2 * merge + 7)
    H, C, blk, mrg = _small_block(gen, shift, merge)
    p = swin_block.prepare_block(blk, dtype, mrg)
    B = 3
    x = torch.randn(B, H * H, C, generator=gen).to(dtype)
    m = None
    if masks is not None:
        m = {"keep": torch.full((B, 2), 1 / 0.9),
             "dropped": torch.tensor([[1 / 0.9, 0.0], [0.0, 1 / 0.9], [1 / 0.9, 1 / 0.9]]),
             "zeros": torch.zeros(B, 2)}[masks]
    got = swin_block.swin_block_phases_plain(x, p, m)
    want = swin_block.swin_block_plain(x, p, m)
    assert got.dtype == want.dtype and got.shape == want.shape
    assert torch.equal(got, want)
    if masks == "zeros":  # both branches dropped: the block is the identity
        assert torch.equal(got, x)


@pytest.mark.parametrize("shift", [0, 4])
@pytest.mark.parametrize("with_scale", [False, True])
def test_residual_gemm_form_scatters_through_the_map(shift, with_scale):
    """fwd_gemm_plain's residual form, row by row: out[token of row r] =
    bf16(x[token] + bf16(bf16(m[image]) bf16(a[r] w + b)))."""
    gen = torch.Generator().manual_seed(40 + shift + with_scale)
    B, H, C, N = 2, 16, 32, 24
    M, L = B * H * H, H * H
    a = torch.randn(M, C, generator=gen).bfloat16()
    w = (torch.randn(C, N, generator=gen) / C ** 0.5).bfloat16()
    bias = torch.randn(N, generator=gen)
    x = torch.randn(M, N, generator=gen).bfloat16()
    scale = torch.tensor([1 / 0.9, 0.0]) if with_scale else None
    rows = plan.window_rows(B, H, H, 8, shift)
    got = swin_block.fwd_gemm_plain(a, w, bias, resid=x, scale=scale, L=L, rows_out=rows)
    for r in (0, 5, L - 1, L, M - 1):
        v = ((a[r].float() @ w.float()) + bias).bfloat16()
        if scale is not None:
            v = scale[r // L].bfloat16() * v
        assert torch.equal(got[rows[r]], x[rows[r]] + v)
