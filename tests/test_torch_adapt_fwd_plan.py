"""What kernel K4 (the Swin block with AdapterBit adapters, forward,
csrc/swin_block_adapt.cu on the Hopper forward layer csrc/swin_fwd_sm90.cuh)
decides on the host and computes in each phase, on the CPU (the kernel
cannot be compiled here): the plain versions of its phases chained as its C
entry chains its launches against ``swin_block_adapt_plain``'s bits, the
plain version of each of its GEMM forms and of its float32 LN rows row by
row, and the Python mirror in ``ops/swin_fwd_plan.py`` of its launches, TMA
boxes, float32 staged rows and the shapes and tiles it refuses. Change the
mirror with the kernel."""

import numpy as np
import pytest
import torch

from pseldnets_tpu_torch.models.adapters import AdaptConfig
from pseldnets_tpu_torch.models.factory import init_weights
from pseldnets_tpu_torch.models.htsat import SwinTransformerBlock
from pseldnets_tpu_torch.ops import swin_block, swin_block_adapt as sa
from pseldnets_tpu_torch.ops import swin_fwd_plan as plan
import torch_threads  # noqa: F401  (each xdist worker's share of the cores)

# HTSAT's stages: (H = W, C, nh); hidden 4 C, the adapter C / 2 padded to 32
STAGES = ((64, 96, 4), (32, 192, 8), (16, 384, 16), (8, 768, 32))
BOTH = ("MlpAdapter", "SpatialAdapter")
MASKS = {"keep": lambda B: torch.full((B, 2), 1 / 0.9),
         "dropped": lambda B: torch.tensor([[1 / 0.9, 0.0], [0.0, 1 / 0.9], [1 / 0.9, 1 / 0.9]]),
         "zeros": lambda B: torch.zeros(B, 2)}


def _adapt_block(gen, C, nh, shift, positions=BOTH, H=16):
    adapt = AdaptConfig({"method": "adapter", "adapt_kwargs": {
        "position": list(positions), "type": "adapter", "mlp_ratio": 0.5,
        "adapter_scalar": 0.1, "act_layer": "gelu"}})
    blk = SwinTransformerBlock(C, (H, H), nh, 8, shift_size=shift, adapt=adapt)
    init_weights(blk, gen)
    with torch.no_grad():  # non-trivial norms, biases and adapters (fc2 starts at zero)
        for name, t in blk.named_parameters():
            if "norm" in name or name.endswith("bias") or "adapter" in name:
                t.add_(0.3 * torch.randn(t.shape, generator=gen))
    return blk.eval()


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("C,nh,shift,positions,masks", [
    (48, 2, 0, BOTH, None), (48, 2, 4, BOTH, "keep"), (48, 2, 4, BOTH, "dropped"),
    (48, 2, 0, BOTH, "zeros"), (48, 2, 4, ("MlpAdapter",), "dropped"),
    (48, 2, 0, ("SpatialAdapter",), None),
    (96, 4, 4, BOTH, "dropped"), (96, 4, 0, BOTH, None)])  # C 96: stage 0's 48 -> 64
def test_chained_phases_give_the_plain_bits(dtype, C, nh, shift, positions, masks):
    """K4's phases in plain PyTorch (LN1 rows through the window map, qkv,
    the attention, proj stored through the window -> token map, sa1 +
    GELU, sa2's float32 branch, LN2 over the float32 rows, fc1 and ma1 +
    GELU, fc2 and ma2 into the output), chained as swin_block_adapt_forward
    chains its launches, give swin_block_adapt_plain's bits: shifted and
    unshifted, masks that keep, drop one branch or are zero for every image
    (then the block is the identity), both adapters or one, and the padded
    adapter width."""
    gen = torch.Generator().manual_seed(C + shift + len(positions) + 3 * (masks is None))
    blk = _adapt_block(gen, C, nh, shift, positions)
    p = sa.prepare_adapt_block(blk, dtype)
    assert p.ch == C // 2 and p.ch_pad == -(-C // 2 // 32) * 32
    B = 3
    x = torch.randn(B, 16 * 16, C, generator=gen).to(dtype)
    m = MASKS[masks](B) if masks is not None else None
    got = sa.swin_block_adapt_phases_plain(x, p, m)
    want = sa.swin_block_adapt_plain(x, p, m)
    assert got.dtype == want.dtype == dtype and got.shape == want.shape
    assert torch.equal(got, want)
    if masks == "zeros":
        assert torch.equal(got, x)


def _rand(gen, *shape, scale=1.0):
    return torch.randn(*shape, generator=gen) * scale


@pytest.mark.parametrize("shift", [0, 4])
def test_out_form_through_the_map_scatters_rows(shift):
    """fwd_gemm_plain's F_OUT through the window -> token map (K4's proj):
    out[token of row r] = bf16(a[r] w + b), every token written once."""
    gen = torch.Generator().manual_seed(60 + shift)
    B, H, C = 2, 16, 48
    M = B * H * H
    a, w = _rand(gen, M, C).bfloat16(), _rand(gen, C, C, scale=C ** -0.5).bfloat16()
    bias = _rand(gen, C)
    rows = plan.window_rows(B, H, H, 8, shift)
    assert sorted(rows) == list(range(M))
    got = swin_block.fwd_gemm_plain(a, w, bias, rows_out=rows)
    v = (a.float() @ w.float() + bias).bfloat16()  # the products as one GEMM computes them
    for r in (0, 7, 63, 64, H * H - 1, H * H, M - 1):
        assert torch.equal(got[rows[r]], v[r])


@pytest.mark.parametrize("N,K", [(48, 32), (96, 64), (192, 96)])
def test_branch_form_row_by_row(N, K):
    """branch_gemm_plain (K4's sa2, F_BRANCH), row by row: float32 y[r] =
    x[r] + m0[r // L] (a[r] + s (gs[r] w + b)), the mask unrounded (1/0.9
    is not a bf16 value), a zero mask giving x exactly."""
    gen = torch.Generator().manual_seed(N + K)
    L, s = 64, 0.1
    M = 3 * L
    gs, w = _rand(gen, M, K).bfloat16(), _rand(gen, K, N, scale=K ** -0.5).bfloat16()
    bias = _rand(gen, N)
    x, add = _rand(gen, M, N).bfloat16(), _rand(gen, M, N).bfloat16()
    m0 = torch.tensor([1 / 0.9, 0.0, 1.0])
    y = sa.branch_gemm_plain(gs, w, bias, x, add, m0, s, L)
    assert y.dtype == torch.float32
    acc = gs.float() @ w.float()  # the products as one GEMM computes them
    for r in (0, L - 1, L, 2 * L + 5, M - 1):
        t = acc[r] + bias
        assert torch.equal(y[r], x[r].float() + m0[r // L] * (add[r].float() + s * t))
    assert torch.equal(y[L:2 * L], x[L:2 * L].float())


@pytest.mark.parametrize("N,K,K1", [(48, 192, 32), (96, 384, 64), (192, 768, 96)])
def test_adapt_out_form_row_by_row(N, K, K1):
    """adapt_out_gemm_plain (K4's fc2 and ma2 on one tile, F_ADAPT_OUT),
    row by row: out[r] = bf16(y[r] + m1[r // L] ((fg[r] fc2 + b2) + s
    (gm[r] Wma2 + bma2))), y float32, the mask unrounded."""
    gen = torch.Generator().manual_seed(N + K + K1)
    L, s = 64, 0.1
    M = 3 * L
    fg, w = _rand(gen, M, K).bfloat16(), _rand(gen, K, N, scale=K ** -0.5).bfloat16()
    gm, w1 = _rand(gen, M, K1).bfloat16(), _rand(gen, K1, N, scale=K1 ** -0.5).bfloat16()
    b, b1, y = _rand(gen, N), _rand(gen, N), _rand(gen, M, N)
    m1 = torch.tensor([0.0, 1 / 0.9, 1.0])
    out = sa.adapt_out_gemm_plain(fg, w, b, gm, w1, b1, y, m1, s, L)
    assert out.dtype == torch.bfloat16
    acc, acc1 = fg.float() @ w.float(), gm.float() @ w1.float()
    for r in (0, L - 1, L, 2 * L + 5, M - 1):
        mo = (acc[r] + b) + s * (acc1[r] + b1)
        assert torch.equal(out[r], (y[r] + m1[r // L] * mo).bfloat16())
    assert torch.equal(out[:L], y[:L].bfloat16())


@pytest.mark.parametrize("C", [48, 96, 768])
def test_float32_ln_rows_row_by_row(C):
    """K4's LN2 rows over the float32 y: h[r] = bf16((y[r] - mean) rstd w +
    b), two-pass float32 moments; y is not rounded to bf16 first."""
    gen = torch.Generator().manual_seed(C)
    y = _rand(gen, 40, C) * 3.0 + 1.0
    w, b = _rand(gen, C) + 1.0, _rand(gen, C)
    h = swin_block.ln_rows_plain(y, w, b, dtype=torch.bfloat16)
    assert h.dtype == torch.bfloat16
    for r in (0, 17, 39):
        v = y[r]
        mu = v.mean()
        rs = torch.rsqrt(((v - mu) ** 2).mean() + 1e-5)
        assert torch.equal(h[r], ((v - mu) * rs * w + b).bfloat16())
    assert not torch.equal(h, swin_block.ln_rows_plain(y.bfloat16(), w, b))


# every (stage, shift) of an AdapterBit block, served or trained
ADAPT_FORMS = [(i, s) for i in range(4) for s in ((0, 4) if i < 3 else (0,))]


@pytest.mark.parametrize("B", [32, 1, 2, 3, 128])
@pytest.mark.parametrize("stage,shift", ADAPT_FORMS)
def test_plan_covers_every_adapter_block(B, stage, shift):
    """At every AdapterBit block form: the shape is taken; the call launches
    plan.ADAPT_PHASES in order, ten launches; proj stores through the window
    -> token map; every GEMM's TMA boxes read a bf16 matrix with a 16-byte
    row stride, 64 columns by at most 256 rows; fc2's second chain reads the
    adapter's (M, ch) and (ch, N); N and K are multiples of 8; the float32
    forms stage 4-byte rows at width 64, and each ring of at least 2 stages
    fits beside its staged rows; the LN2 rows read float32; the attention
    items cover every (window, head)."""
    H, C, nh = STAGES[stage]
    hidden, ch = 4 * C, -(-C // 2 // 32) * 32
    plan.check_adapt_block(H, H, C, nh, 8, hidden, ch)
    tiles = sa.TILES[C]
    plan.check_adapt_tiles(tiles)
    launches = plan.adapt_launches(B, H, H, C, nh, hidden, ch, tiles)
    assert tuple(g["name"] for g in launches) == plan.ADAPT_PHASES and len(launches) == 10
    M = B * H * H
    by = {g["name"]: g for g in launches}
    assert by["proj"].get("map") == "win_to_tok" and by["proj"]["epi"] == "out"
    assert (by["sa2"]["epi"], by["fc2"]["epi"]) == ("branch", "adapt_out")
    assert by["fc2"]["maps"][2:] == [(M, ch, plan.BM, 64), (ch, C, 64, 64)]
    assert by["fc2"]["kblocks"] == -(-hidden // 64) + -(-ch // 64)
    assert by["sa2"]["bn"] == by["fc2"]["bn"] == plan.F32_BN
    assert by["ln2"]["in_bytes"] == 4 and by["ln1"]["in_bytes"] == 2
    for g in launches:
        if g["kind"] == "gemm":
            assert g["N"] % 8 == 0 and g["K"] % 8 == 0, g["name"]
            for rows, cols, box_rows, box_cols in g["maps"]:
                assert (cols * 2) % 16 == 0 and box_cols * 2 == 128, g["name"]
                assert 1 <= box_rows <= 256 and 0 < rows < 2 ** 31, g["name"]
            elem = 4 if g["epi"] in ("branch", "adapt_out") else 2
            assert g["elem"] == elem and g["staged"] == plan.staged_bytes(g["bn"], elem)
            stages, smem = plan.gemm_smem(g["bn"], tiles["stages"], elem)
            assert 2 <= stages <= 6 and smem <= plan.SMEM_LIMIT, g["name"]
            assert smem == g["smem"] and stages * (plan.A_BYTES + g["bn"] * 128) \
                + g["staged"] <= plan.RING_BUDGET
            assert 1 <= g["grid"] <= 132 and g["tiles"] >= g["grid"]
        elif g["kind"] == "ln":
            assert g["rows"] == M and g["K"] == C and g["groups"] <= plan.LN_GROUPS
            assert g["blocks"] * 8 * g["rows_per_warp"] >= M
        else:
            n_windows = B * (H // 8) ** 2
            assert g["items"] == g["groups"] * nh and 1 <= g["groups"] <= n_windows


@pytest.mark.parametrize("stages,used", [(0, 6), (2, 2), (3, 3), (9, 6)])
def test_float32_staging_fits_beside_the_ring(stages, used):
    """FwdStage<64, 4>: 64 float32 rows of 64 + 16 bytes a consumer
    warpgroup (twice the bf16 rows' bytes, less 16 a row) beside a ring
    that still holds its 6 stages (24 KB each) and their mbarriers in the
    budget; a ring depth asked for is capped there."""
    bn = plan.F32_BN
    assert plan.staged_bytes(bn, 4) == 2048 + 128 * (4 * bn + 16) == 36864
    assert plan.staged_bytes(bn, 4) > plan.staged_bytes(bn)
    got, smem = plan.gemm_smem(bn, stages, elem=4)
    assert got == used and smem == 6 * 24576 + 36864 + 16 * 6 + 1024 <= plan.SMEM_LIMIT


@pytest.mark.parametrize("C,nh,window,hidden,H,ch,exc", [
    (128, 4, 8, 512, 16, 64, NotImplementedError),   # head dim 32
    (96, 4, 7, 384, 14, 64, NotImplementedError),    # 7x7 windows
    (96, 4, 8, 384, 12, 64, NotImplementedError),    # a part window
    (96, 4, 8, 384, 16, 48, NotImplementedError),    # the adapter width unpadded
    (96, 4, 8, 384, 16, 0, NotImplementedError),     # no adapter
    (1536, 64, 8, 6144, 8, 768, NotImplementedError),  # C > 768
])
def test_plan_refuses_adapter_blocks_the_kernel_does_not_take(C, nh, window, hidden, H, ch,
                                                              exc):
    with pytest.raises(exc):
        plan.check_adapt_block(H, H, C, nh, window, hidden, ch)


@pytest.mark.parametrize("tiles", [{"qkv": 32}, {"sa1": 96}, {"ma1": 256}, {"stages": 1},
                                   {"stages": -1}])
def test_plan_refuses_adapter_tiles_the_kernel_lacks(tiles):
    with pytest.raises(ValueError):
        plan.check_adapt_tiles(dict(sa.DEFAULT_TILES, **tiles))


def test_adapter_tile_table_is_taken_at_every_stage():
    """Every entry of K4's TILES is a form K4 has, with every key its C
    entry takes; an unlisted width takes the defaults."""
    plan.check_adapt_tiles(sa.DEFAULT_TILES)
    for C, t in sa.TILES.items():
        assert set(t) == set(plan.ADAPT_TILE_KEYS)
        plan.check_adapt_tiles(t)
        assert sa.fwd_tile_args(C) == tuple(t[k] for k in plan.ADAPT_TILE_KEYS)
    assert sa.fwd_tile_args(32) == tuple(sa.DEFAULT_TILES[k] for k in plan.ADAPT_TILE_KEYS)


@pytest.mark.parametrize("C,nh,window,H", [(64, 2, 8, 16), (96, 4, 7, 14)])
def test_wrapper_refuses_before_any_launch(monkeypatch, C, nh, window, H):
    """A shape K4 does not take raises in the wrapper before anything is
    built or launched (the tensors on the meta device, the device check
    taken out so that the shape check is reached)."""
    monkeypatch.setattr(sa, "check_cuda_tensor", lambda *a, **k: None)
    gen = torch.Generator().manual_seed(C)
    blk = _adapt_block(gen, C, nh, 0, H=H) if window == 8 else None
    if blk is None:
        adapt = AdaptConfig({"method": "adapter", "adapt_kwargs": {
            "position": list(BOTH), "type": "adapter", "mlp_ratio": 0.5,
            "adapter_scalar": 0.1, "act_layer": "gelu"}})
        blk = SwinTransformerBlock(C, (H, H), nh, window, shift_size=0, adapt=adapt)
        init_weights(blk, gen)
    p = sa.prepare_adapt_block(blk.eval(), torch.bfloat16)
    x = torch.empty(2, H * H, C, device="meta", dtype=torch.bfloat16)
    m = torch.ones(2, 2, device="meta")
    before, lib = sa.FWD_KERNEL.launches, sa.FWD_KERNEL._lib
    with pytest.raises(NotImplementedError):
        sa.swin_block_adapt_fused(x, p, m)
    assert (sa.FWD_KERNEL.launches, sa.FWD_KERNEL._lib) == (before, lib)


def test_row_images_follow_the_rows():
    """_image_rows: row r takes its image's mask (r // L), as the kernel's
    epilogues read masks[2 (r / L) + column]."""
    m = torch.tensor([[1.0, 2.0], [3.0, 4.0], [5.0, 6.0]])
    got = sa._image_rows(m[:, 1], 12, 4)
    assert got.shape == (12, 1)
    assert torch.equal(got[:, 0], torch.from_numpy(np.repeat([2.0, 4.0, 6.0], 4)).float())
