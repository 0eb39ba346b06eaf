"""Kernels K1-K11 on the card against their plain versions, and the EINV2
serving path against its plain path (marked
``cuda``: skipped without a CUDA card and nvcc). Imports nothing of JAX, so on
a machine without JAX it runs with

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q
"""

import sys
from pathlib import Path

import pytest
import torch

from pseldnets_tpu_torch.models.adapters import AdaptConfig
from pseldnets_tpu_torch.models.factory import init_weights
from pseldnets_tpu_torch.models.htsat import BasicLayer, PatchMerging, SwinTransformerBlock
from pseldnets_tpu_torch.models.passt import Block
from pseldnets_tpu_torch.ops import (conv_block, frontend, frontend_forms, patch_embed,
                                     swin_block, swin_block_adapt, swin_block_vjp, swin_fwd_plan,
                                     swin_stage, vit_block)
from pseldnets_tpu_torch.ops.features import logmel_iv_filterbank, logmel_iv_from_spectrum

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("form", ["served", "passt", "train"])
@pytest.mark.parametrize("B,N", [(1, 48000), (3, 48000 + 117), (32, 240000)])
def test_frontend_kernel_matches_plain(card, form, B, N):
    """K1 in the three forms the paths use: served HTSAT (affine, bf16,
    t_out past n_frames: the zero tail), PaSST (affine, bf16, n_frames) and
    training (float32, no folds); B = 1, 3 and 32 clips, an N that leaves a
    partial last block, a silent stretch. float32 within the 8e-4 dB / 7e-5
    IV feature budget, bf16 within one bf16 ulp (2^-7 of max(|x|, 1)),
    exact zeros from n_frames on, finite everywhere, and a second launch
    with equal bits."""
    g = torch.Generator(device=card).manual_seed(B)
    x = torch.randn(B, 4, N, device=card, generator=g) * 0.1
    x[-1, :, N // 3:N // 2] = 0.0  # silence: IV must stay finite
    n_frames = 1 + N // 240
    aff = (torch.rand(7, 64, device=card, generator=g) + 0.5,
           torch.randn(7, 64, device=card, generator=g))
    kw = {"served": dict(post_affine=aff, out_dtype=torch.bfloat16,
                         t_out=max(1024, n_frames + 23) if N == 240000 else n_frames + 23),
          "passt": dict(post_affine=aff, out_dtype=torch.bfloat16),
          "train": {}}[form]
    before = frontend.KERNEL.launches
    got = frontend.fused_logmel_iv(x, **kw)
    again = frontend.fused_logmel_iv(x, **kw)
    assert frontend.KERNEL.launches == before + 2
    assert torch.equal(got, again)
    ref = frontend.fused_logmel_iv_plain(x, **kw)
    assert got.shape == ref.shape and got.dtype == ref.dtype
    assert got.shape[2] == kw.get("t_out", n_frames)
    got, ref = got.float(), ref.float()
    assert torch.isfinite(got).all()
    assert not got[:, :, n_frames:].any()
    if form == "train":
        assert (got[:, :4] - ref[:, :4]).abs().max() <= 8e-4
        assert (got[:, 4:] - ref[:, 4:]).abs().max() <= 7e-5
    else:
        assert ((got - ref).abs() / ref.abs().clamp(min=1.0)).max() <= 2.0 ** -7


def test_frontend_kernel_at_32khz(card):
    """The l3das22 configs' STFT (32 kHz, hop 320, 64 mels) on K1, B=3 four
    seconds, served form and float32: the same bounds as at 24 kHz."""
    g = torch.Generator(device=card).manual_seed(320)
    x = torch.randn(3, 4, 128000, device=card, generator=g) * 0.1
    kw = dict(hop=320, sample_rate=32000)
    aff = (torch.rand(7, 64, device=card, generator=g) + 0.5,
           torch.randn(7, 64, device=card, generator=g))
    got, ref = frontend.fused_logmel_iv(x, **kw), frontend.fused_logmel_iv_plain(x, **kw)
    assert got.shape == ref.shape == (3, 7, 401, 64)
    assert (got[:, :4] - ref[:, :4]).abs().max() <= 8e-4
    assert (got[:, 4:] - ref[:, 4:]).abs().max() <= 7e-5
    kw.update(post_affine=aff, out_dtype=torch.bfloat16, t_out=416)
    got = frontend.fused_logmel_iv(x, **kw).float()
    ref = frontend.fused_logmel_iv_plain(x, **kw).float()
    assert not got[:, :, 401:].any()
    assert ((got - ref).abs() / ref.abs().clamp(min=1.0)).max() <= 2.0 ** -7


@pytest.mark.parametrize("bad,exc", [
    (dict(N=512), ValueError),                      # reflect pad needs N > n_fft / 2
    (dict(out_dtype=torch.float16), ValueError),
    (dict(t_out=10), ValueError),                   # t_out < n_frames
    (dict(hop=1024), NotImplementedError),          # hop >= n_fft
    (dict(dtype=torch.float64), ValueError),
    (dict(channels=3), ValueError),
    (dict(strided=True), ValueError)])
def test_frontend_kernel_raises(card, bad, exc):
    """What K1 does not take raises before any launch: no fallback."""
    N = bad.get("N", 4800)
    x = torch.randn(2, bad.get("channels", 4), 2 * N if bad.get("strided") else N,
                    device=card, dtype=bad.get("dtype", torch.float32))
    if bad.get("strided"):
        x = x[..., ::2]
    kw = {k: v for k, v in bad.items() if k in ("out_dtype", "t_out", "hop")}
    before = frontend.KERNEL.launches
    with pytest.raises(exc):
        frontend.fused_logmel_iv(x, **kw)
    assert frontend.KERNEL.launches == before


@pytest.mark.parametrize("stage,shift,merge", [(2, 4, True), (3, 0, False), (0, 4, False)])
def test_swin_block_kernel_matches_plain(card, stage, shift, merge):
    """Full-width stage shapes, B=2: within two bf16 ulps of the plain bf16
    version at the output's largest magnitude."""
    gen = torch.Generator().manual_seed(stage)
    H, C, nh = 64 >> stage, 96 << stage, 4 << stage
    blk = SwinTransformerBlock(C, (H, H), nh, 8, shift_size=shift)
    mrg = PatchMerging((H, H), C) if merge else None
    for m in (blk, mrg):
        if m is not None:
            init_weights(m, gen)
            m.to(card).eval()
    p = swin_block.prepare_block(blk, torch.bfloat16, mrg)
    x = torch.randn(2, H * H, C, generator=gen).to(card).bfloat16()
    before = swin_block.KERNEL.launches
    got = swin_block.swin_block_fused(x, p).float()
    assert swin_block.KERNEL.launches == before + 1
    ref = swin_block.swin_block_plain(x, p).float()
    assert got.shape == ref.shape
    assert (got - ref).abs().max() <= 2.0 ** -6 * ref.abs().max()


# K2's GEMM forms at the block's shapes, B=2 images of each stage (and a
# ragged row count): (form, stage, M or None for B H W, N, K)
_FWD_GEMMS = [(f, i) for i in range(4) for f in ("qkv", "proj", "fc1", "fc2")] + [
    ("merge", i) for i in range(3)] + [("ragged", 0)]


@pytest.mark.parametrize("bn", [64, 128, 192])
@pytest.mark.parametrize("form,stage", _FWD_GEMMS)
def test_fwd_gemm_forms_match_plain(card, form, stage, bn):
    """Each GEMM form of K2/K11's Hopper layer alone (TMA boxes, the tile
    width, the bias, GELU and residual epilogues, the drop-path scale with
    a zero, the residual stored through the shifted window -> token map)
    against its plain version: within 2^-7 of the output's largest
    magnitude (float32 sums in another order, then one bf16 rounding);
    two launches give equal bits. A wrong TMA descriptor gives wrong
    numbers, not a crash."""
    H, C = 64 >> stage, 96 << stage
    M, L = 2 * H * H, H * H
    K, N = {"qkv": (C, 3 * C), "proj": (C, C), "fc1": (C, 4 * C), "fc2": (4 * C, C),
            "merge": (4 * C, 2 * C), "ragged": (C, 3 * C)}[form]
    if form == "merge":
        M //= 4
    if form == "ragged":
        M = 333
    gen = torch.Generator().manual_seed(M + K + N + bn)
    a = torch.randn(M, K, generator=gen).to(card).bfloat16()
    w = (torch.randn(K, N, generator=gen) / K ** 0.5).to(card).bfloat16()
    bias = None if form == "merge" else (torch.randn(N, generator=gen) * 0.3).to(card)
    kw = {"gelu": form == "fc1"}
    plain_kw = dict(kw)
    if form in ("proj", "fc2"):
        resid = torch.randn(M, N, generator=gen).to(card).bfloat16()
        scale = torch.tensor([1 / 0.9, 0.0], device=card)  # image 1's branch dropped
        # the kernel reads column 0 of (images, 2) drop-path masks
        kw.update(resid=resid, scale=torch.stack([scale, scale], 1), L=L)
        plain_kw.update(resid=resid, scale=scale, L=L)
        if form == "proj":  # the window -> token map, shifted where the stage has shifts
            shift = 4 if stage < 3 else 0
            kw["geometry"] = (H, H, 8, shift)
            plain_kw["rows_out"] = swin_fwd_plan.window_rows(2, H, H, 8, shift)
    got = swin_block.fwd_gemm(a, w, bias, bn=bn, **kw)
    again = swin_block.fwd_gemm(a, w, bias, bn=bn, **kw)
    ref = swin_block.fwd_gemm_plain(a, w, bias, **plain_kw)
    assert torch.equal(got, again)
    assert got.shape == ref.shape
    g, r = got.float(), ref.float()
    assert torch.isfinite(g).all()
    assert (g - r).abs().max() <= 2.0 ** -7 * r.abs().max()


@pytest.mark.parametrize("stage,shift,masks", [(0, 4, "zeros"), (1, 0, "mixed"), (2, 4, "mixed"),
                                               (3, 0, "zeros"), (1, 4, None)])
def test_swin_block_kernel_masks_and_repeat(card, stage, shift, masks):
    """K2 with drop-path masks, every image's zero (both branches dropped:
    the block is the identity, exactly) or one branch dropped per image,
    and without masks, B=3: within 2^-6 of the output's largest magnitude
    of the plain bf16 version; a second launch gives the same bits."""
    gen = torch.Generator().manual_seed(50 + stage)
    H, C, nh = 64 >> stage, 96 << stage, 4 << stage
    blk = SwinTransformerBlock(C, (H, H), nh, 8, shift_size=shift)
    init_weights(blk, gen)
    p = swin_block.prepare_block(blk.to(card).eval(), torch.bfloat16)
    x = torch.randn(3, H * H, C, generator=gen).to(card).bfloat16()
    m = {"zeros": torch.zeros(3, 2),
         "mixed": torch.tensor([[1 / 0.9, 0.0], [0.0, 1 / 0.9], [1 / 0.9, 1 / 0.9]]),
         None: None}[masks]
    m = m.to(card) if m is not None else None
    before = swin_block.KERNEL.launches
    got = swin_block.swin_block_fused(x, p, m)
    again = swin_block.swin_block_fused(x, p, m)
    assert swin_block.KERNEL.launches == before + 2
    assert torch.equal(got, again)
    ref = swin_block.swin_block_plain(x, p, m).float()
    assert (got.float() - ref).abs().max() <= 2.0 ** -6 * ref.abs().max()
    if masks == "zeros":
        assert torch.equal(got, x)


@pytest.mark.parametrize("stage,shift", [(0, 4), (1, 0), (2, 4), (3, 0)])
def test_training_block_kernels_match_plain(card, stage, shift):
    """K2 with drop-path masks (zeros included) and K3 at one full-width
    shape per stage, B=2: every output within 2^-6 of its largest magnitude
    of the plain bf16 version (phase_swin_block_train's bound)."""
    gen = torch.Generator().manual_seed(10 + stage)
    H, C, nh = 64 >> stage, 96 << stage, 4 << stage
    blk = SwinTransformerBlock(C, (H, H), nh, 8, shift_size=shift)
    init_weights(blk, gen)
    blk.to(card)
    p = swin_block.prepare_block(blk, torch.bfloat16)
    x = torch.randn(2, H * H, C, generator=gen).to(card).bfloat16()
    dout = torch.randn(2, H * H, C, generator=gen).to(card).bfloat16()
    m = torch.tensor([[1 / 0.9, 0.0], [0.0, 1 / 0.9]], device=card)
    before = (swin_block.KERNEL.launches, swin_block_vjp.KERNEL.launches)
    got = swin_block.swin_block_fused(x, p, m).float()
    dx, g = swin_block_vjp.swin_block_backward(x, p, m, dout)
    assert (swin_block.KERNEL.launches, swin_block_vjp.KERNEL.launches) == \
        (before[0] + 1, before[1] + 1)
    ref = swin_block.swin_block_plain(x, p, m).float()
    assert (got - ref).abs().max() <= 2.0 ** -6 * ref.abs().max()
    dx0, g0 = swin_block_vjp.swin_block_backward_plain(x, p, m, dout)
    for name, a, b in [("dx", dx, dx0)] + [(k, g[k], g0[k]) for k in swin_block_vjp.GRAD_KEYS]:
        a, b = a.float(), b.float()
        assert a.shape == b.shape, name
        assert (a - b).abs().max() <= 2.0 ** -6 * b.abs().max(), name


@pytest.mark.parametrize("stage,shift,positions", [
    (0, 4, ("MlpAdapter", "SpatialAdapter")), (1, 0, ("MlpAdapter",)),
    (2, 4, ("MlpAdapter", "SpatialAdapter")), (3, 0, ("SpatialAdapter",))])
def test_adapter_block_kernels_match_plain(card, stage, shift, positions):
    """K4 with drop-path masks and K5 at one full-width shape per stage
    (stage 0: the 48-wide adapter padded to 64), random adapter weights,
    B=2: every output within 2^-6 of its largest magnitude of the plain
    bf16 version; no grads for an adapter the block lacks."""
    gen = torch.Generator().manual_seed(20 + stage)
    H, C, nh = 64 >> stage, 96 << stage, 4 << stage
    adapt = AdaptConfig({"method": "adapter", "adapt_kwargs": {
        "position": list(positions), "type": "adapter", "mlp_ratio": 0.5,
        "adapter_scalar": 0.1, "act_layer": "gelu"}})
    blk = SwinTransformerBlock(C, (H, H), nh, 8, shift_size=shift, adapt=adapt)
    init_weights(blk, gen)
    with torch.no_grad():
        for ad in swin_block_adapt.block_adapters(blk).values():
            ad.fc2.weight.copy_(torch.randn(ad.fc2.weight.shape, generator=gen) * 0.3)
    blk.to(card)
    p = swin_block_adapt.prepare_adapt_block(blk, torch.bfloat16)
    x = torch.randn(2, H * H, C, generator=gen).to(card).bfloat16()
    dout = torch.randn(2, H * H, C, generator=gen).to(card).bfloat16()
    m = torch.tensor([[1 / 0.9, 0.0], [0.0, 1 / 0.9]], device=card)
    fwd, bwd = swin_block_adapt.FWD_KERNEL, swin_block_adapt.BWD_KERNEL
    before = (fwd.launches, bwd.launches)
    got = swin_block_adapt.swin_block_adapt_fused(x, p, m).float()
    dx, g = swin_block_adapt.swin_block_adapt_backward(x, p, m, dout)
    assert (fwd.launches, bwd.launches) == (before[0] + 1, before[1] + 1)
    ref = swin_block_adapt.swin_block_adapt_plain(x, p, m).float()
    assert (got - ref).abs().max() <= 2.0 ** -6 * ref.abs().max()
    dx0, g0 = swin_block_adapt.swin_block_adapt_backward_plain(x, p, m, dout)
    assert set(g) == set(g0) and ("sa1_w" in g) == ("SpatialAdapter" in positions)
    for name, a, b in [("dx", dx, dx0)] + [(k, g[k], g0[k]) for k in g0]:
        a, b = a.float(), b.float()
        assert a.shape == b.shape, name
        assert (a - b).abs().max() <= 2.0 ** -6 * b.abs().max(), name


# K4's GEMM forms at the adapter block's shapes, B=2 images of each stage:
# proj through the window -> token map, the adapters' narrow GEMMs (N = ch,
# or K = ch), sa2's float32 branch, fc2 and ma2 on one tile
# (the float32 forms, sa2 and fc2 + ma2, run at width swin_fwd_plan.F32_BN)
_ADAPT_GEMMS = [(f, i, bn) for i in range(4) for f in ("proj", "sa1", "sa2", "ma1", "fc2")
                for bn in ((swin_fwd_plan.F32_BN,) if f in ("sa2", "fc2")
                           else swin_fwd_plan.BNS)]


@pytest.mark.parametrize("form,stage,bn", _ADAPT_GEMMS)
def test_adapt_gemm_forms_match_plain(card, form, stage, bn):
    """Each GEMM form K4 adds to the Hopper forward layer alone, at every
    stage width and tile width it takes (the float32 forms: 64): F_OUT
    through the shifted window -> token
    map, F_OUT + GELU at N = ch (stage 0: the 48-wide adapter padded to
    64), F_BRANCH (float32 y from x, a and an unrounded mask with a zero,
    K = ch: one k-block at stage 0), F_ADAPT_OUT (two chains through one
    ring). Within 2^-7 of the output's largest magnitude of its plain
    version (float32 outputs too); two launches give equal bits."""
    H, C = 64 >> stage, 96 << stage
    ch = -(-C // 2 // 32) * 32
    M, L = 2 * H * H, H * H
    K, N = {"proj": (C, C), "sa1": (C, ch), "sa2": (ch, C), "ma1": (C, ch),
            "fc2": (4 * C, C)}[form]
    gen = torch.Generator().manual_seed(M + K + N + bn)
    rnd = lambda *shape: torch.randn(*shape, generator=gen).to(card)  # noqa: E731
    a, w = rnd(M, K).bfloat16(), (rnd(K, N) / K ** 0.5).bfloat16()
    bias = rnd(N) * 0.3
    masks = torch.tensor([[1 / 0.9, 0.0], [0.0, 1 / 0.9]], device=card)
    run = lambda **kw: swin_block_adapt.adapt_gemm(form_of, a, w, bias, bn=bn, **kw)  # noqa: E731
    if form in ("proj", "sa1", "ma1"):
        form_of = "out"
        kw = {"gelu": form != "proj"}
        plain_kw = dict(kw)
        if form == "proj":
            shift = 4 if stage < 3 else 0
            kw["geometry"] = (H, H, 8, shift)
            plain_kw["rows_out"] = swin_fwd_plan.window_rows(2, H, H, 8, shift)
        ref = swin_block.fwd_gemm_plain(a, w, bias, **plain_kw)
    elif form == "sa2":
        form_of = "branch"
        x, add = rnd(M, N).bfloat16(), rnd(M, N).bfloat16()
        kw = dict(x=x, add=add, masks=masks, col=0, s=0.1, L=L)
        ref = swin_block_adapt.branch_gemm_plain(a, w, bias, x, add, masks[:, 0], 0.1, L)
    else:
        form_of = "adapt_out"
        a1, w1 = rnd(M, ch).bfloat16(), (rnd(ch, N) / ch ** 0.5).bfloat16()
        bias1, y = rnd(N) * 0.3, rnd(M, N)
        kw = dict(a1=a1, w1=w1, bias1=bias1, y=y, masks=masks, col=1, s=0.1, L=L)
        ref = swin_block_adapt.adapt_out_gemm_plain(a, w, bias, a1, w1, bias1, y, masks[:, 1],
                                                    0.1, L)
    got, again = run(**kw), run(**kw)
    assert torch.equal(got, again)
    assert got.shape == ref.shape and got.dtype == ref.dtype
    g, r = got.float(), ref.float()
    assert torch.isfinite(g).all()
    assert (g - r).abs().max() <= 2.0 ** -7 * r.abs().max()
    if form == "sa2":  # image 1's mask is 0: y is x there, exactly
        assert torch.equal(got[L:], x[L:].float())


@pytest.mark.parametrize("C", [96, 192, 384, 768])
def test_adapt_ln_rows_match_plain(card, C):
    """K4's LN2 row pass over float32 rows alone, at each stage width: within
    one bf16 ulp (2^-7 of max(|h|, 1)) of ln_rows_plain on the unrounded y;
    a second launch gives equal bits."""
    gen = torch.Generator().manual_seed(C)
    y = (torch.randn(1000, C, generator=gen) * 3.0 + 1.0).to(card)
    w, b = (torch.rand(C, generator=gen) + 0.5).to(card), torch.randn(C, generator=gen).to(card)
    got, again = swin_block_adapt.adapt_ln_rows(y, w, b), swin_block_adapt.adapt_ln_rows(y, w, b)
    assert torch.equal(got, again)
    ref = swin_block.ln_rows_plain(y, w, b, dtype=torch.bfloat16).float()
    assert ((got.float() - ref).abs() / ref.abs().clamp(min=1.0)).max() <= 2.0 ** -7


@pytest.mark.parametrize("stage,shift", [(0, 0), (0, 4), (1, 0), (1, 4), (2, 0), (2, 4), (3, 0)])
@pytest.mark.parametrize("masks", [None, "mixed", "zeros"])
def test_adapter_block_forward_every_stage_and_repeat(card, stage, shift, masks):
    """K4 at every stage shape and shift, served (masks None) and with
    drop-path masks (one branch dropped per image, or every mask zero: the
    block is the identity, exactly), B=3, random adapters (stage 0: 48 ->
    64): within 2^-6 of the output's largest magnitude of its plain bf16
    version; a second launch gives the same bits."""
    blk = _train_block(card, stage, shift, 70 + stage, _ADAPT)[0]
    p = swin_block_adapt.prepare_adapt_block(blk, torch.bfloat16)
    H, C = 64 >> stage, 96 << stage
    gen = torch.Generator().manual_seed(80 + stage + shift)
    x = torch.randn(3, H * H, C, generator=gen).to(card).bfloat16()
    m = {"zeros": torch.zeros(3, 2),
         "mixed": torch.tensor([[1 / 0.9, 0.0], [0.0, 1 / 0.9], [1 / 0.9, 1 / 0.9]]),
         None: None}[masks]
    m = m.to(card) if m is not None else None
    before = swin_block_adapt.FWD_KERNEL.launches
    got = swin_block_adapt.swin_block_adapt_fused(x, p, m)
    again = swin_block_adapt.swin_block_adapt_fused(x, p, m)
    assert swin_block_adapt.FWD_KERNEL.launches == before + 2
    assert torch.equal(got, again)
    ref = swin_block_adapt.swin_block_adapt_plain(x, p, m).float()
    assert (got.float() - ref).abs().max() <= 2.0 ** -6 * ref.abs().max()
    if masks == "zeros":
        assert torch.equal(got, x)


def test_layer_norm_with_frozen_scale_trains_its_shift(card):
    """On the card, a LayerNorm whose scale is frozen still gives its shift
    a gradient (the AdapterBit freeze), equal to nn.LayerNorm's."""
    from pseldnets_tpu_torch.models.common import LayerNorm

    g = torch.Generator(device=card).manual_seed(3)
    x = torch.randn(64, 96, device=card, generator=g)
    dy = torch.randn(64, 96, device=card, generator=g)
    ref, ln = torch.nn.LayerNorm(96).to(card), LayerNorm(96).to(card)
    ln.weight.requires_grad_(False)
    (gb_ref,) = torch.autograd.grad((ref(x) * dy).sum(), [ref.bias])
    (gb,) = torch.autograd.grad((ln(x) * dy).sum(), [ln.bias])
    assert gb.shape == (96,) and torch.allclose(gb, gb_ref, atol=1e-5)


@pytest.mark.parametrize("B,N", [(2, 602), (3, 130), (1, 1800), (1, 3500), (5, 77)])
def test_vit_block_kernel_matches_plain(card, B, N):
    """K6 at PaSST's full width (C 768, 12 heads of 64, MLP 3072): the served
    token count, a tail whose N and B*N are not multiples of 64, a long
    sequence, one past the earlier design's 3392-token limit, and a B*N
    (385) that is not a multiple of the 128-row tiles: within 2^-6 of the
    plain bf16 output's largest magnitude, and a second launch bitwise
    equal."""
    gen = torch.Generator().manual_seed(30 + N)
    blk = Block(768, 12)
    init_weights(blk, gen)
    blk.to(card).eval()
    p = vit_block.prepare_vit_block(blk, torch.bfloat16)
    x = torch.randn(B, N, 768, generator=gen).to(card).bfloat16()
    before = vit_block.KERNEL.launches
    got = vit_block.vit_block_fused(x, p)
    assert vit_block.KERNEL.launches == before + 1
    assert torch.equal(vit_block.vit_block_fused(x, p), got)
    got = got.float()
    ref = vit_block.vit_block_plain(x, p).float()
    assert got.shape == ref.shape == (B, N, 768)
    assert (got - ref).abs().max() <= 2.0 ** -6 * ref.abs().max()


@pytest.mark.parametrize("M,N,K,epilogue,bn", [
    (19264, 2304, 768, "bias", 192), (19264, 768, 768, "resid", 192),
    (19264, 3072, 768, "gelu", 128), (19264, 768, 3072, "resid", 192),
    (1000, 768, 768, "bias", 256), (130, 3072, 768, "gelu", 256),
    (77, 2304, 3072, "resid", 128), (200, 768, 3072, "resid", 256),
    (19264, 3072, 768, "gelu", -128), (1000, 768, 3072, "resid", -128),
    (333, 2304, 768, "bias", -128)])
def test_vit_gemm_core_matches_plain(card, M, N, K, epilogue, bn):
    """K6's Hopper GEMM core alone (TMA, mbarrier ring, wgmma, TMA-stored
    epilogue) at the four GEMM shapes of a served PaSST batch (B=32 x 602
    tokens) with their tiles and at ragged M, each tile width and the
    ping-pong schedule (bn -128): within 2^-7 of
    the plain version's largest magnitude (float32 sums in another order,
    then one or two bf16 roundings)."""
    gen = torch.Generator().manual_seed(M + N + K)
    a = (torch.randn(M, K, generator=gen) * 0.5).to(card).bfloat16()
    w = (torch.randn(N, K, generator=gen) / K ** 0.5).to(card).bfloat16()
    bias = (torch.randn(N, generator=gen) * 0.1).to(card)
    resid = torch.randn(M, N, generator=gen).to(card).bfloat16() if epilogue == "resid" else None
    got = vit_block.gemm(a, w, bias, resid, epilogue, bn).float()
    ref = vit_block.gemm_plain(a, w, bias, resid, epilogue).float()
    assert got.shape == (M, N)
    assert (got - ref).abs().max() <= 2.0 ** -7 * ref.abs().max()


def _conv_operands(card, gen, B, T, F, cin, cmid, cout, relu_conv=False):
    """bf16 NHWC input, HWIO weights N(0, 1/fan_in) with folded-BN-like
    scales, float32 biases large enough that a wrong edge halo shows."""
    x = torch.randn(B, T, F, cin, generator=gen)
    w1 = torch.randn(3, 3, cin, cmid, generator=gen) / (9 * cin) ** 0.5
    b1 = torch.randn(cin if relu_conv else cmid, generator=gen) * 0.5 + 0.5
    w2 = torch.randn(3, 3, cmid, cout, generator=gen) / (9 * cmid) ** 0.5
    b2 = torch.randn(cout, generator=gen) * 0.5
    bf = lambda t: t.to(card).bfloat16().contiguous()  # noqa: E731
    return bf(x), bf(w1), b1.to(card), bf(w2), b2.to(card)


def _conv_args(mode, x, w1, b1, w2, b2):
    if mode == "relu_conv":
        return (x, None, b1, w2, b2)
    if mode == "single":
        return (x, w1, b1, None, None)
    return (x, w1, b1, w2, b2)


def _check_conv_block(card, mode, shape, seed):
    B, T, F, cin, cmid, cout = shape
    gen = torch.Generator().manual_seed(seed)
    args = _conv_args(mode, *_conv_operands(
        card, gen, B, T, F, cin, cmid if mode != "relu_conv" else cin, cout or cmid,
        relu_conv=mode == "relu_conv"))
    before = conv_block.KERNEL.launches
    got = conv_block.conv3x3_bias_relu(*args)
    again = conv_block.conv3x3_bias_relu(*args)
    assert conv_block.KERNEL.launches == before + 2
    ref = conv_block.conv3x3_bias_relu_plain(*args)
    assert got.shape == ref.shape and got.dtype == torch.bfloat16
    assert torch.equal(got, again)
    got, ref = got.float(), ref.float()
    assert (got - ref).abs().max() <= 2.0 ** -6 * ref.abs().max()


@pytest.mark.parametrize("mode,shape", [
    ("pair", (2, 37, 16, 16, 64, 64)), ("pair", (2, 9, 4, 512, 1024, 1024)),
    ("single", (2, 21, 8, 64, 128, 0)), ("single", (1, 5, 2, 1024, 2048, 0)),
    ("relu_conv", (2, 19, 8, 64, 64, 128)), ("pair", (1, 11, 8, 32, 48, 40)),
    ("pair", (3, 7, 48, 16, 64, 64)), ("single", (3, 33, 5, 32, 128, 0)),
    ("pair", (2, 3, 200, 64, 48, 40)), ("relu_conv", (3, 13, 200, 64, 64, 128)),
    ("relu_conv", (3, 9, 5, 24, 24, 40)), ("pair", (3, 101, 64, 8, 64, 64))])
def test_conv_block_kernel_matches_plain(card, mode, shape):
    """K7 in each mode at small shapes: tiles of whole frequency rows (F 16,
    8, 4, 2), F not dividing 128 (48; 5: 25 time rows of 5 bins), F over 128
    (200: two 100-bin chunks), odd T with B >= 3 (each image's last tile
    clipped), Cin 8, 16, 24 and 32 (zero-filled channels of the K step, the
    16-channel K step at Cin <= 16), Cout 40 and the mid 48 (clipped output
    tiles), relu_conv with its halo and its channels past Cin kept zero:
    within two bf16 ulps (2^-6) of the plain bf16 version at the output's
    largest magnitude, and a second launch gives the same bits."""
    _check_conv_block(card, mode, shape, 40 + shape[1])


@pytest.mark.parametrize("bn,bk,stages", [
    (64, 64, 0), (-64, 64, 0), (64, 16, 0), (-64, 16, 2), (128, 64, 0), (-128, 64, 0),
    (192, 64, 0), (256, 64, 0), (256, 64, 2)])
@pytest.mark.parametrize("resident", [True, False])
@pytest.mark.parametrize("mode,shape", [("pair", (3, 13, 48, 16, 64, 136)),
                                        ("relu_conv", (2, 5, 200, 72, 72, 200))])
def test_conv_block_kernel_tiles_match_plain(card, monkeypatch, bn, bk, stages, resident, mode,
                                             shape):
    """Every tile form of K7 (64 to 256 output channels, cooperative or
    ping-pong, K steps of 16 or 64 channels, the shallowest ring, conv1 of
    the pair with its weights resident or in the ring) on both convs, at
    ragged shapes: as test_conv_block_kernel_matches_plain."""
    for key in ("bn_cout64", "bn_cout128", "bn_wider"):
        monkeypatch.setitem(conv_block.TILES, key, bn)
    monkeypatch.setitem(conv_block.TILES, "bk_cin16", bk)
    monkeypatch.setitem(conv_block.TILES, "stages", stages)
    monkeypatch.setitem(conv_block.TILES, "resident", resident)
    _check_conv_block(card, mode, shape, 60 + abs(bn) + bk + stages)


def test_conv_block_kernel_raises_on_what_it_does_not_take(card):
    gen = torch.Generator().manual_seed(50)
    x, w1, b1, w2, b2 = _conv_operands(card, gen, 1, 4, 4, 16, 32, 32)
    with pytest.raises(ValueError, match="expected torch.bfloat16"):
        conv_block.conv3x3_bias_relu(x.float(), w1, b1)
    with pytest.raises(ValueError, match="contiguous"):
        conv_block.conv3x3_bias_relu(x.transpose(1, 2), w1, b1)
    with pytest.raises(ValueError, match="expected torch.float32"):
        conv_block.conv3x3_bias_relu(x, w1, b1.bfloat16())
    with pytest.raises(NotImplementedError, match="Cin % 8"):
        conv_block.conv3x3_bias_relu(x[..., :7].contiguous(), w1[:, :, :7].contiguous(), b1)
    with pytest.raises(NotImplementedError, match="Cout % 8"):
        conv_block.conv3x3_bias_relu(x, w1[..., :12].contiguous(), b1[:12].contiguous())
    with pytest.raises(NotImplementedError, match="computes in bf16"):
        conv_block.conv3x3_bias_relu(x, w1, b1, compute_dtype=torch.float32)
    shifted = torch.empty(x.numel() + 4, device=card, dtype=torch.bfloat16)[4:].view(x.shape)
    shifted.copy_(x)
    with pytest.raises(ValueError, match="16-byte aligned"):
        conv_block.conv3x3_bias_relu(shifted, w1, b1)
    big = torch.zeros(1, 1024, 1024, 8, device=card, dtype=torch.bfloat16)
    wide = torch.zeros(3, 3, 8, 2048, device=card, dtype=torch.bfloat16)
    with pytest.raises(NotImplementedError, match="< 2\\^31"):
        conv_block.conv3x3_bias_relu(big, wide, torch.zeros(2048, device=card))


@pytest.mark.parametrize("dtype,F,fr,T,B", [
    (torch.bfloat16, 64, 4, 1024, 2), (torch.bfloat16, 64, 4, 1000, 2),
    (torch.bfloat16, 64, 4, 1000, 3), (torch.float32, 64, 4, 1024, 2),
    (torch.float32, 64, 4, 1000, 3), (torch.bfloat16, 128, 2, 512, 3),
    (torch.bfloat16, 128, 2, 501, 3), (torch.bfloat16, 256, 1, 251, 3),
    (torch.float32, 128, 2, 512, 3), (torch.float32, 128, 2, 501, 3),
    (torch.float32, 256, 1, 251, 3)])
def test_patch_embed_kernel_matches_plain(card, dtype, F, fr, T, B):
    """K8 at HTSAT's serving shapes (7 x 1024 x 64, 7 x 512 x 128 and 7 x
    256 x 256 -> 4096 x 96: 64, 128 and 256 mel bins at freq_ratio 4, 2
    and 1; T short of the image zero-padded in the kernel; B=3 a grid of 96
    blocks): bf16 within one bf16 ulp (2^-7 of max(|x|, 1)), float32 within
    1e-5 of the plain version; a second launch gives the same bits."""
    gen = torch.Generator().manual_seed(60)
    vec = lambda s, o: (torch.randn(96, generator=gen) * s + o).to(card)  # noqa: E731
    p = patch_embed.PatchEmbedParams(
        w=(torch.randn(112, 96, generator=gen) * 0.1).to(card, dtype), bias=vec(0.1, 0.0),
        ln_w=vec(0.1, 1.0), ln_b=vec(0.1, 0.0), freq_ratio=fr, t_img=256 * fr)
    x = torch.randn(B, 7, T, F, generator=gen).to(card, dtype)
    before = patch_embed.KERNEL.launches
    got = patch_embed.patch_embed_tokens(x, p)
    assert patch_embed.KERNEL.launches == before + 1
    assert torch.equal(patch_embed.patch_embed_tokens(x, p), got)
    ref = patch_embed.patch_embed_tokens_plain(x, p)
    assert got.shape == ref.shape == (B, 4096, 96) and got.dtype == dtype
    got, ref = got.float(), ref.float()
    if dtype == torch.bfloat16:
        assert ((got - ref).abs() / ref.abs().clamp(min=1.0)).max() <= 2.0 ** -7
    else:
        assert (got - ref).abs().max() <= 1e-5


def test_patch_embed_kernel_refuses_other_shapes(card):
    """A shape K8 does not take (bf16 with 4 channels, an embed width of 64,
    a served model of embed width 16 on its default embed) raises before
    any launch, naming the einsum embed; nothing falls back."""
    from pseldnets_tpu_torch.models import heads
    from pseldnets_tpu_torch.serving import htsat_fused_forward

    def params(K, E):
        return patch_embed.PatchEmbedParams(
            w=torch.zeros(K, E, device=card, dtype=torch.bfloat16),
            bias=torch.zeros(E, device=card), ln_w=torch.ones(E, device=card),
            ln_b=torch.zeros(E, device=card), freq_ratio=4, t_img=1024)

    before = patch_embed.KERNEL.launches
    x4 = torch.zeros(1, 4, 1024, 64, device=card, dtype=torch.bfloat16)
    with pytest.raises(NotImplementedError, match='C=4.*patch_embed="einsum"'):
        patch_embed.patch_embed_tokens(x4, params(64, 96))
    x7 = torch.zeros(1, 7, 1024, 64, device=card, dtype=torch.bfloat16)
    with pytest.raises(NotImplementedError, match='E=64.*patch_embed="einsum"'):
        patch_embed.patch_embed_tokens(x7, params(112, 64))
    tm = heads.HTSAT(num_classes=5, in_channels=7, mel_bins=16, num_tracks=3,
                     tgt_output_frames=24, encoder_kwargs=dict(
                         spec_size=64, patch_size=4, patch_stride=(4, 4), embed_dim=16,
                         depths=(2, 2), num_heads=(2, 4), window_size=4, mlp_ratio=2.0))
    with pytest.raises(NotImplementedError, match='patch_embed="einsum"'):
        htsat_fused_forward(tm.to(card).eval(), torch.zeros(2, 7, 241, 16, device=card))
    assert patch_embed.KERNEL.launches == before


@pytest.mark.parametrize("n_mels", [64, 96, 128, 256])
@pytest.mark.parametrize("kw,kernel", [
    (dict(n_fft=1024, hop=240, radix2=False), "flat"),
    (dict(n_fft=1024, hop=240, variant="dif"), "dif"),
    (dict(n_fft=1024, hop=240, variant="dif", window="hamming"), "dif"),
    (dict(n_fft=512, hop=100, radix2=False), "flat"),
    (dict(n_fft=512, hop=100, variant="dif"), "dif"),
    (dict(n_fft=1024, hop=241), "flat"), (dict(n_fft=1023, hop=241, window="hamming"), "flat"),
    (dict(n_fft=2048, hop=240), "flat")])
def test_frontend_form_kernels_match_plain(card, kw, kernel, n_mels):
    """K9 and K10 through fused_logmel_iv's routing at every shape of
    chip_smoke.py's FORM_CASES, at 64 mels and at 96, 128 and 256 (the wide
    form: a tile's mel groups, the sums in a scratch of the block's own), 2
    s clips: at 64 mels within the 8e-4 dB / 7e-5 IV budget of the form's
    plain version and of the float32 eager extractor; wider, the second
    clip silent for its first half second as in chip_smoke.py's check data,
    against the plain version and the float64 DFT under chip_smoke.py's
    rule for those widths (``wide_check``: 8e-4 dB within 50 dB of the
    frame's loudest; in a deeper band, twice what one float32 DFT's
    rounding can move it by, ``wide_bound``); one launch of the form's kernel, K1 not launched; a second
    launch gives the same bits. (At 64 mels the clips stay whole: K10's
    narrow form keeps the JAX kernel's 3-tap window, which a silent
    stretch's edge can put past 8e-4 dB from float64: ROADMAP.md, the
    measured deviations.)"""
    g = torch.Generator(device=card).manual_seed(61)
    x = torch.randn(2, 4, 48000, device=card, generator=g) * 0.1
    if n_mels > 64:
        x[-1, :, :12000] = 0.0
    k = frontend_forms.FLAT_KERNEL if kernel == "flat" else frontend_forms.DIF_KERNEL
    before = (k.launches, frontend.KERNEL.launches)
    got = frontend.fused_logmel_iv(x, n_mels=n_mels, **kw)
    assert (k.launches, frontend.KERNEL.launches) == (before[0] + 1, before[1])
    assert torch.equal(got, frontend.fused_logmel_iv(x, n_mels=n_mels, **kw))
    shape = {n: v for n, v in kw.items() if n in ("n_fft", "hop", "window")}
    plain = (frontend_forms.logmel_iv_flat_plain if kernel == "flat"
             else frontend_forms.logmel_iv_dif_plain)
    ref = plain(x, n_mels=n_mels, **shape)
    eager = frontend.fused_logmel_iv_plain(x, n_mels=n_mels, **shape)
    assert got.shape == ref.shape == eager.shape == (2, 7, 1 + 48000 // kw["hop"], n_mels)
    if n_mels <= 64:
        for r in (ref, eager):
            assert (got[:, :4] - r[:, :4]).abs().max() <= 8e-4
            assert (got[:, 4:] - r[:, 4:]).abs().max() <= 7e-5
        return
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import chip_smoke  # noqa: E402  (the repo's root: the rule chip_smoke.py holds these to)

    fb64 = torch.as_tensor(logmel_iv_filterbank(24000, kw["n_fft"], n_mels), device=card)
    spec64 = frontend_forms.flat_spectrum(x.double(), kw["n_fft"], kw["hop"],
                                          kw.get("window", "hann"))
    f64 = logmel_iv_from_spectrum(*spec64, fb64.double())
    bound = chip_smoke.wide_bound(x, kw["n_fft"], kw["hop"], kw.get("window", "hann"), n_mels,
                                  spec64)
    ok, info = chip_smoke.wide_check(got, ref, f64, bound)
    assert ok, info


def test_flat_kernel_folded_form_matches_plain(card):
    """K9 standing in for the DIT kernel at n_fft 2048 with K1's folds
    (affine, bf16, zero tail to 208 frames): one bf16 ulp; a second launch
    gives the same bits."""
    g = torch.Generator(device=card).manual_seed(62)
    x = torch.randn(2, 4, 48000, device=card, generator=g) * 0.1
    aff = (torch.rand(7, 64, device=card, generator=g) + 0.5,
           torch.randn(7, 64, device=card, generator=g))
    kw = dict(n_fft=2048, hop=240, post_affine=aff, out_dtype=torch.bfloat16, t_out=208)
    got = frontend.fused_logmel_iv(x, **kw)
    assert torch.equal(got, frontend.fused_logmel_iv(x, **kw))
    got = got.float()
    ref = frontend_forms.logmel_iv_flat_plain(x, **kw).float()
    assert got.shape == (2, 7, 208, 64) and not got[:, :, 201:].any()
    assert ((got - ref).abs() / ref.abs().clamp(min=1.0)).max() <= 2.0 ** -7


def _check_stage(got, x, sp):
    """K11's output against its plain version block by block (chip_smoke.py's
    check_stage): bitwise K2 run block after block, each of those blocks
    within K2's 2^-6 of its plain version's scale on its own input, the
    stage within depth x 2^-6 of the plain stage's scale."""
    xs = x
    for d in range(sp.depth):
        p = sp.block(d)
        y = swin_block.swin_block_fused(xs, p).float()
        ref = swin_block.swin_block_plain(xs, p).float()
        assert (y - ref).abs().max() <= 2.0 ** -6 * ref.abs().max()
        xs = swin_block.swin_block_fused(xs, p)
    assert torch.equal(got, xs)
    ref = swin_stage.swin_stage_plain(x, sp).float()
    assert (got.float() - ref).abs().max() <= sp.depth * 2.0 ** -6 * ref.abs().max()


@pytest.mark.parametrize("stage", [0, 1, 2, 3])
def test_swin_stage_kernel_matches_plain(card, stage):
    """K11 at each served stage shape, full width and depth (2, 2, 6, 2),
    B=2: one launch, held against its plain version block by block
    (_check_stage), a second launch bitwise equal (a missing grid barrier
    shows as a difference), v1 and v2 alike."""
    gen = torch.Generator().manual_seed(20 + stage)
    H, C, nh, depth = 64 >> stage, 96 << stage, 4 << stage, (2, 2, 6, 2)[stage]
    layer = BasicLayer(C, (H, H), depth, nh, 8)
    init_weights(layer, gen)
    sp = swin_stage.prepare_stage(layer.to(card).eval(), torch.bfloat16)
    assert sp.shifts == (((0, 4) * 3)[:depth] if stage < 3 else (0, 0))
    x = torch.randn(2, H * H, C, generator=gen).to(card).bfloat16()
    before = swin_stage.KERNEL.launches
    got = swin_stage.swin_stage_fused(x, sp)
    again = swin_stage.swin_stage_fused_v2(x, sp)
    assert swin_stage.KERNEL.launches == before + 2
    assert torch.equal(got, again)
    _check_stage(got, x, sp)


def test_swin_stage_kernel_takes_any_zero_base_pattern(card):
    """v1's pattern (0, 4, 4, 0, 0, 4) at stage 2's shape, B=2, against the
    plain version (_check_stage); v2 refuses it before launching."""
    gen = torch.Generator().manual_seed(30)
    shifts = (0, 4, 4, 0, 0, 4)
    blocks = [SwinTransformerBlock(384, (16, 16), 16, 8, shift_size=s) for s in shifts]
    layer = torch.nn.Module()
    layer.blocks = torch.nn.ModuleList(blocks)
    init_weights(layer, gen)
    sp = swin_stage.prepare_stage(layer.to(card).eval(), torch.bfloat16)
    x = torch.randn(2, 256, 384, generator=gen).to(card).bfloat16()
    before = swin_stage.KERNEL.launches
    got = swin_stage.swin_stage_fused(x, sp)
    with pytest.raises(ValueError):
        swin_stage.swin_stage_fused_v2(x, sp)
    assert swin_stage.KERNEL.launches == before + 1
    _check_stage(got, x, sp)


# the backward layer's GEMM forms at the shapes K3 and K5 give them (B=2 rows
# of each stage; ragged rows), each tile width: (form, M, K, N, K1)
_BWD_GEMMS = [
    ("nn", 8192, 96, 288, 0), ("nn", 2048, 192, 576, 0), ("nn", 333, 384, 1152, 0),
    ("nn", 128, 768, 384, 0), ("nn_f32", 8192, 64, 96, 0), ("nt", 8192, 288, 96, 0),
    ("nt", 512, 1152, 384, 0), ("nt_f32", 8192, 384, 96, 0), ("nt_f32", 200, 3072, 768, 0),
    ("cat", 8192, 384, 96, 64), ("cat", 333, 1536, 384, 192), ("dual", 8192, 96, 384, 0),
    ("dual", 512, 384, 1536, 0), ("dual", 8192, 96, 64, 0), ("dual", 333, 192, 96, 0),
    ("tt", 8192, 96, 288, 0), ("tt", 8192, 384, 96, 0), ("tt", 8192, 64, 96, 0),
    ("tt", 2048, 768, 3072, 0), ("tt", 333, 192, 576, 0), ("tt", 131072, 96, 96, 0)]


@pytest.mark.parametrize("bn", [64, 128])
@pytest.mark.parametrize("form,M,K,N,K1", _BWD_GEMMS)
def test_bwd_gemm_forms_match_plain(card, form, M, K, N, K1, bn):
    """Each GEMM form of K3/K5's Hopper layer alone (TMA boxes, the
    transposed operands, the epilogues, the row split of the weight grads
    and its ordered reduction) against its plain version: bf16 outputs
    within 2^-7, float32 within 2^-12 of the largest magnitude (float32 sums
    in another order); two launches give equal bits. A wrong TMA descriptor
    gives wrong numbers, not a crash."""
    gen = torch.Generator().manual_seed(M + K + N + bn)
    bf = lambda *s: (torch.randn(*s, generator=gen) / max(s[-1], 1) ** 0.25).to(card).bfloat16()  # noqa: E731
    a1 = b1 = None
    if form == "tt":
        a0, b0 = bf(M, K), bf(M, N)
    elif form.startswith("nn"):
        a0, b0 = bf(M, K), bf(K, N)
    else:
        a0, b0 = bf(M, K), bf(N, K)
    if form == "dual":
        a0, b0, a1, b1 = bf(M, K), bf(K, N), bf(M, K), bf(N, K)
    if form == "cat":
        a1, b1 = bf(M, K1), bf(N, K1)
    bias = (torch.randn(N, generator=gen) * 0.3).to(card) if form in ("nn", "dual") else None
    gelu = form == "nn" and N % 3 == 0
    kw = dict(a1=a1, b1=b1, bias=bias, gelu=gelu)
    got = swin_block_vjp.bwd_gemm(form, a0, b0, bn=bn, **kw)
    again = swin_block_vjp.bwd_gemm(form, a0, b0, bn=bn, **kw)
    ref = swin_block_vjp.bwd_gemm_plain(form, a0, b0, **kw)
    assert set(got) == set(ref)
    for k, r in ref.items():
        assert torch.equal(got[k], again[k]), k
        g, r = got[k].float(), r.float()
        assert g.shape == r.shape, k
        tol = 2.0 ** -12 if k == "out_f32" else 2.0 ** -7
        assert (g - r).abs().max() <= tol * r.abs().max(), k


def _train_block(card, stage, shift, seed, adapt=None):
    gen = torch.Generator().manual_seed(seed)
    H, C, nh = 64 >> stage, 96 << stage, 4 << stage
    blk = SwinTransformerBlock(C, (H, H), nh, 8, shift_size=shift, **(
        {"adapt": adapt} if adapt is not None else {}))
    init_weights(blk, gen)
    if adapt is not None:
        with torch.no_grad():
            for ad in swin_block_adapt.block_adapters(blk).values():
                ad.fc2.weight.copy_(torch.randn(ad.fc2.weight.shape, generator=gen) * 0.3)
    blk.to(card)
    x = torch.randn(2, H * H, C, generator=gen).to(card).bfloat16()
    dout = torch.randn(2, H * H, C, generator=gen).to(card).bfloat16()
    m = torch.tensor([[1 / 0.9, 0.0], [0.0, 1 / 0.9]], device=card)
    return blk, x, dout, m


_ADAPT = AdaptConfig({"method": "adapter", "adapt_kwargs": {
    "position": ["MlpAdapter", "SpatialAdapter"], "type": "adapter", "mlp_ratio": 0.5,
    "adapter_scalar": 0.1, "act_layer": "gelu"}})
# AdapterBit's trained grads of a block (train/optim.py::trainable_mask)
_ADAPT_TRAINED = ("ln1_b", "qkv_b", "proj_b", "ln2_b", "fc1_b", "fc2_b") + tuple(
    k for keys in swin_block_adapt.ADAPTER_KEYS.values() for k in keys)


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("stage,shift", [(0, 0), (0, 4), (1, 0), (1, 4), (2, 0), (2, 4), (3, 0)])
@pytest.mark.parametrize("kernel", ["K3", "K5"])
def test_block_backward_kernels_full_and_masked(card, kernel, stage, shift, masked):
    """K3 and K5 at every stage shape, shifted and unshifted, B=2, in the
    full form (every grad, the Pallas kernel's set) and the masked form
    (AdapterBit's trained grads only): each output within 2^-6 of its
    largest magnitude of the plain bf16 version, the masked form returning
    exactly the wanted keys, and two launches giving equal bits."""
    want = _ADAPT_TRAINED if masked else None
    if kernel == "K3":
        blk, x, dout, m = _train_block(card, stage, shift, 40 + stage)
        p = swin_block.prepare_block(blk, torch.bfloat16)
        run = lambda: swin_block_vjp.swin_block_backward(x, p, m, dout, want)  # noqa: E731
        dx0, g0 = swin_block_vjp.swin_block_backward_plain(x, p, m, dout, want)
    else:
        blk, x, dout, m = _train_block(card, stage, shift, 50 + stage, _ADAPT)
        p = swin_block_adapt.prepare_adapt_block(blk, torch.bfloat16)
        run = lambda: swin_block_adapt.swin_block_adapt_backward(x, p, m, dout, want)  # noqa: E731
        dx0, g0 = swin_block_adapt.swin_block_adapt_backward_plain(x, p, m, dout, want)
    (dx, g), (dx2, g2) = run(), run()
    assert set(g) == set(g0) == set(g2)
    if masked:
        keys = swin_block_vjp.GRAD_KEYS if kernel == "K3" else swin_block_adapt.ALL_KEYS
        assert set(g) == set(want) & set(keys)
    assert torch.equal(dx, dx2) and all(torch.equal(g[k], g2[k]) for k in g)
    for name, a, b in [("dx", dx, dx0)] + [(k, g[k], g0[k]) for k in g0]:
        a, b = a.float(), b.float()
        assert a.shape == b.shape, name
        assert (a - b).abs().max() <= 2.0 ** -6 * b.abs().max(), name


def test_block_backward_kernels_raise_on_what_they_do_not_take(card, monkeypatch):
    """No fallback: a window other than 8x8, a misaligned tensor and tiles
    the C entry refuses raise; nothing launches the plain version."""
    blk, x, dout, m = _train_block(card, 3, 0, 60)
    p = swin_block.prepare_block(blk, torch.bfloat16)
    with pytest.raises(ValueError):  # misaligned: 2 bytes past an aligned base
        xm = torch.empty(x.numel() + 8, device=card, dtype=torch.bfloat16)[1:1 + x.numel()]
        swin_block_vjp.swin_block_backward(xm.view_as(x), p, m, dout)
    blk7 = SwinTransformerBlock(768, (7, 7), 32, 7).to(card)
    p7 = swin_block.prepare_block(blk7, torch.bfloat16)
    x7 = torch.randn(2, 49, 768, device=card).bfloat16()
    with pytest.raises(NotImplementedError):
        swin_block_vjp.swin_block_backward(x7, p7, m, x7)
    monkeypatch.setitem(swin_block_vjp.TILES, "bn_nt", 96)
    with pytest.raises(ValueError):  # the size query refuses the tile
        swin_block_vjp.swin_block_backward(x, p, m, dout)
    ablk, ax, adout, am = _train_block(card, 3, 0, 61, _ADAPT)
    ap = swin_block_adapt.prepare_adapt_block(ablk, torch.bfloat16)
    with pytest.raises(ValueError):
        swin_block_adapt.swin_block_adapt_backward(ax, ap, am, adout)
    with pytest.raises(NotImplementedError):
        swin_block_vjp.bwd_gemm("nn", x[0], p.qkv_w, bn=96)


def test_einv2_served_on_kernels_matches_plain(card):
    """EINV2 (the dual HTSAT of configs/loss/einv2_pit_agg.yaml, full width,
    seeded weights) served from 10 s waveforms at B=3: K1 x1, K8 x1 (the DOA
    branch) and K2 x24 a call, two calls with equal bits, finite outputs
    within 5e-2 of the plain path; K8 refuses the SED branch's four
    channels before any launch (that branch takes the einsum embed)."""
    from pathlib import Path

    from pseldnets_tpu_torch.config import compose
    from pseldnets_tpu_torch.models import build_model
    from pseldnets_tpu_torch.serving import (einv2_htsat_fused_forward_from_wav,
                                             folded_wav_features, prepare_einv2)

    cfg = compose(str(Path(__file__).resolve().parents[1] / "configs"), "train",
                  ["loss=einv2_pit_agg", "model.kwargs.pretrained_path=null"])
    model, _ = build_model(cfg, 13, device=card, seed=2)
    params = prepare_einv2(model, torch.bfloat16)
    g = torch.Generator(device=card).manual_seed(11)
    wav = torch.randn(3, 4, 240000, device=card, generator=g) * 0.1
    kernels = (frontend.KERNEL, patch_embed.KERNEL, swin_block.KERNEL)
    before = [k.launches for k in kernels]
    got = einv2_htsat_fused_forward_from_wav(model, wav, params=params)
    again = einv2_htsat_fused_forward_from_wav(model, wav, params=params)
    assert [k.launches - b for k, b in zip(kernels, before)] == [2, 2, 48]
    plain = einv2_htsat_fused_forward_from_wav(model, wav, params=params, use_kernels=False)
    for key, shape in (("sed", (3, 100, 3, 13)), ("doa", (3, 100, 3, 3))):
        assert got[key].shape == shape and torch.isfinite(got[key]).all()
        assert torch.equal(got[key], again[key])
        assert (got[key] - plain[key]).abs().max().item() < 5e-2
    feats = folded_wav_features(model, wav, t_out=1024)
    sed = patch_embed.prepare_patch_embed(model.sed_encoder, torch.bfloat16)
    n = patch_embed.KERNEL.launches
    with pytest.raises(NotImplementedError, match="einsum"):
        patch_embed.patch_embed_tokens(feats[:, :4].contiguous(), sed)
    assert patch_embed.KERNEL.launches == n


@pytest.mark.parametrize("batch", [32, 128])
def test_acs_folded_batch_on_kernels_matches_plain(card, batch):
    """The eval step's ACS (HTSAT mACCDOA at full width, bf16, seeded
    weights) at B=32, eight rotations folded into each forward (256 clips a
    launch, two chunks: K1 x2, K8 x2, K2 x24), and at the infer CLI's B=128,
    four rotations a forward (512 clips a launch, four chunks: K1 x4, K8 x4,
    K2 x48); the averaged outputs within 5e-2 of the plain path's; on the
    first chunk's folded batch, K1 within 2^-7 of max(|x|, 1) of its plain
    version, K8 and each K2 block within 2^-6 of the plain output's scale on
    the same inputs."""
    from pathlib import Path

    from pseldnets_tpu_torch.config import compose
    from pseldnets_tpu_torch.serving import folded_wav_features
    from pseldnets_tpu_torch.train.module import DatasetSpec, SELDTask

    cfg = compose(str(Path(__file__).resolve().parents[1] / "configs"), "train",
                  ["loss=multi_accdoa", "model.kwargs.pretrained_path=null",
                   "trainer.precision=bf16-mixed"])
    task = SELDTask(cfg, DatasetSpec(num_classes=13), device=card)
    task.init_state(0)
    model = task.model
    gen = torch.Generator().manual_seed(5)
    with torch.no_grad():
        model.scalar.running_mean.copy_(torch.randn(7, 64, generator=gen) * 5.0 - 20.0)
        model.scalar.running_var.copy_(torch.rand(7, 64, generator=gen) * 50.0 + 10.0)
    g = torch.Generator(device=card).manual_seed(12)
    wav = torch.randn(batch, 4, 240000, device=card, generator=g) * 0.1
    chunk = task.acs_chunk(batch)
    assert chunk == {32: 8, 128: 4}[batch]
    kernels = (frontend.KERNEL, patch_embed.KERNEL, swin_block.KERNEL)
    before = [k.launches for k in kernels]
    got = task.eval_step({"data": wav}, post_processing="ACS")["multi_accdoa"]
    n = 16 // chunk
    assert [k.launches - b for k, b in zip(kernels, before)] == [n, n, 12 * n]
    task.set_use_kernels(False)
    plain = task.eval_step({"data": wav}, post_processing="ACS")["multi_accdoa"]
    task.set_use_kernels(True)
    assert got.shape == (batch, 100, 117) and torch.isfinite(got).all()
    assert (got - plain).abs().max().item() < 5e-2
    del plain

    perm, sign, _ = (torch.as_tensor(t, device=card) for t in task.acs_tables())
    folded = task.acs_fold(wav, perm[:chunk], sign[:chunk])
    assert folded.shape == (chunk * batch, 4, 240000)
    blocks, embed = (task._eval_params("htsat")[k] for k in ("blocks", "embed"))
    with torch.no_grad():
        feats = folded_wav_features(model, folded, t_out=1024)
        ref = folded_wav_features(model, folded, t_out=1024, use_kernels=False).float()
        assert ((feats.float() - ref).abs() / ref.abs().clamp(min=1.0)).max().item() <= 2 ** -7
        x = patch_embed.patch_embed_tokens(feats, embed)
        ref = patch_embed.patch_embed_tokens_plain(feats, embed).float()
        assert (x.float() - ref).abs().max().item() <= 2 ** -6 * ref.abs().max().item()
        for p in blocks:
            y = swin_block.swin_block_fused(x, p)
            ref = swin_block.swin_block_plain(x, p).float()
            assert (y.float() - ref).abs().max().item() <= 2 ** -6 * ref.abs().max().item()
            x = y


class _CardData:
    """What ``fit`` reads of a datamodule, seeded: 2 train batches of 2
    ten-second clips at 24 kHz (host numpy arrays, as ``collate`` yields
    them; multi-ACCDOA ADPIT labels, one source a frame on track A), the
    same each epoch, and two 20 s validation files in four 10 s chunks
    with DCASE ground truth."""

    def __init__(self, seed):
        import numpy as np
        from collections import OrderedDict

        rng = np.random.default_rng(seed)

        def labels(n):
            lab = np.zeros((n, 100, 6, 4, 13), np.float32)
            cls = rng.integers(0, 13, (n, 100))
            doa = rng.standard_normal((n, 100, 3)).astype(np.float32)
            doa /= np.linalg.norm(doa, axis=-1, keepdims=True)
            b, t = np.meshgrid(np.arange(n), np.arange(100), indexing="ij")
            lab[b, t, 0, 0, cls] = 1.0
            for ax in range(3):
                lab[b, t, 0, 1 + ax, cls] = doa[..., ax]
            return lab

        def wavs(n):
            return (rng.standard_normal((n, 4, 240000)) * 0.1).astype(np.float32)

        self.train = [{"data": wavs(2), "adpit_label": labels(2), "ov": ["1", "1"]}
                      for _ in range(2)]
        self.paths_dict = OrderedDict((f"fold1_room1_mix{i:03d}.wav", 200) for i in range(2))
        self.valid_gt_dcaseformat = OrderedDict(
            (p, {fr: [[int(rng.integers(0, 13)), int(rng.integers(-180, 180)),
                       int(rng.integers(-60, 60))]] for fr in range(0, 200, 2)})
            for p in self.paths_dict)
        w, lab = wavs(4), labels(4)
        self.val = [{"data": w[i:i + 2], "adpit_label": lab[i:i + 2]} for i in (0, 2)]

    def steps_per_epoch(self):
        return len(self.train)

    def train_dataloader(self, num_batches=None):
        n = len(self.train) if num_batches is None else num_batches
        return iter([self.train[i % len(self.train)] for i in range(n)])

    def val_dataloader(self):
        return iter(self.val)


def test_fit_on_kernels_matches_plain_and_resumes(card, tmp_path):
    """Two epochs of ``fit`` (2 steps of 2 ten-second clips, a validation
    of 4 clips after each) of the HTSAT mACCDOA at the kernels' widths
    (HTSAT's published widths, depths cut to (2, 2, 2, 2); bf16-mixed, fused
    forward, drop-path 0.1 from fit's seeded generator), on K1/K2/K3 (the
    validations on K1/K8/K2), against the same fit on the plain versions:
    each epoch's train and validation losses within 2^-6 of scale, the rate
    equal, every parameter within 2.01 lr a step; then ``init_state`` from
    the kernel run's first-epoch ``last.ckpt`` restores parameters,
    statistics, optimizer state, step, epoch and best score bit for bit."""
    import json
    from pathlib import Path

    from pseldnets_tpu_torch.config import compose
    from pseldnets_tpu_torch.train import loop
    from pseldnets_tpu_torch.train.module import DatasetSpec, SELDTask

    cfg = compose(str(Path(__file__).resolve().parents[1] / "configs"), "train",
                  ["loss=multi_accdoa", "model.kwargs.pretrained_path=null",
                   "trainer.precision=bf16-mixed", "trainer.fused_forward=true",
                   "model.kwargs.depths=[2,2,2,2]", "trainer.max_epochs=2", "logger=csv",
                   f"paths.log_dir={tmp_path}/logs", "seed=8"])
    dm = _CardData(21)
    kernels = (frontend.KERNEL, patch_embed.KERNEL, swin_block.KERNEL, swin_block_vjp.KERNEL)
    lines, finals = {}, {}
    for use_kernels in (True, False):
        task = SELDTask(cfg, DatasetSpec(num_classes=13), steps_per_epoch=2, device=card,
                        use_kernels=use_kernels)
        task.init_state(3)
        before = [k.launches for k in kernels]
        out = tmp_path / f"kernels_{use_kernels}"
        loop.fit(task, dm, cfg, out)
        launched = [k.launches - b for k, b in zip(kernels, before)]
        # train: K1 x1, K2 x8, K3 x8 a step; validation: K1 x1, K8 x1, K2 x8 a batch
        assert launched == ([8, 4, 64, 32] if use_kernels else [0, 0, 0, 0]), launched
        lines[use_kernels] = [json.loads(s)
                              for s in (out / "metrics.jsonl").read_text().splitlines()]
        finals[use_kernels] = {k: v.float() for k, v in task.model.state_dict().items()}
    for got, want in zip(lines[True], lines[False]):
        assert got["epoch"] == want["epoch"] and got["lr"] == want["lr"]
        for part in (got["train"], got["val"]["losses"]):
            ref = want["train"] if part is got["train"] else want["val"]["losses"]
            for k, v in ref.items():
                assert abs(part[k] - v) <= 2 ** -6 * max(abs(v), 1e-3), k
    lr = float(cfg["model"]["optimizer"]["kwargs"]["lr"])
    for k, v in finals[False].items():
        assert (finals[True][k] - v).abs().max().item() <= 2.01 * lr * 4, k

    task = SELDTask(cfg, DatasetSpec(num_classes=13), steps_per_epoch=2, device=card)
    task.init_state(3)
    loop.fit(task, dm, dict(cfg, trainer=dict(cfg["trainer"], max_epochs=1)), tmp_path / "one")
    saved = ({k: v.clone() for k, v in task.model.state_dict().items()},
             task.state.optimizer.state_dict(), task.state.step, task.state.epoch,
             task.state.best_score)
    saved_opt = {i: {k: v.clone() if torch.is_tensor(v) else v for k, v in st.items()}
                 for i, st in saved[1]["state"].items()}
    task.init_state(3, ckpt_path=str(tmp_path / "one" / "checkpoints" / "last.ckpt"))
    for k, v in task.model.state_dict().items():
        assert torch.equal(v, saved[0][k]), k
    for i, st in task.state.optimizer.state_dict()["state"].items():
        for k, v in st.items():
            assert torch.equal(v.cpu(), saved_opt[i][k].cpu()) if torch.is_tensor(v) \
                else v == saved_opt[i][k], (i, k)
    assert (task.state.step, task.state.epoch, task.state.best_score) == saved[2:]


def test_augmix_step_at_b96_on_kernels_matches_plain(card):
    """One ``experiment=synth_maccdoa`` step (AugMix: 32 loader clips become
    96, the host's rotate and wavmix, the device TF chains on each copy) of
    the HTSAT mACCDOA at its published widths, depths cut to (2, 2, 2, 2),
    bf16-mixed, fused forward: the augmentation run twice from the same
    generator and RandomState states gives bit-identical features (K1 x1 a
    run); the step's forward and backward on the kernels (K2 x8, K3 x8 at
    B=96) against the plain step on those features, with one drop-path
    generator seed: the loss within 2^-6 and every grad within 2^-4 of
    scale, each no further from float32 than the plain bf16 step
    (chip_smoke.py's phase_train rule)."""
    from pathlib import Path

    import numpy as np

    from pseldnets_tpu_torch.config import compose
    from pseldnets_tpu_torch.train.module import DatasetSpec, SELDTask

    cfg = compose(str(Path(__file__).resolve().parents[1] / "configs"), "train",
                  ["experiment=synth_maccdoa", "model.kwargs.pretrained_path=null",
                   "trainer.precision=bf16-mixed", "trainer.fused_forward=true",
                   "model.kwargs.depths=[2,2,2,2]"])
    task = SELDTask(cfg, DatasetSpec(num_classes=13), steps_per_epoch=2, device=card)
    assert task.augmix and task.fused_forward
    task.init_state(3)
    dm = _CardData(5)
    rng = np.random.default_rng(6)
    batch = {"data": (rng.standard_normal((32, 4, 240000)) * 0.1).astype(np.float32),
             "adpit_label": np.concatenate([dm.train[0]["adpit_label"]] * 16),
             "ov": ["1"] * 32}
    gen, np_state = task.aug_generator.get_state(), task._np_rng.get_state()
    before = frontend.KERNEL.launches
    feats, tgt = task.step_inputs(task.prepare_batch(batch))
    task.aug_generator.set_state(gen)
    task._np_rng.set_state(np_state)
    feats2, tgt2 = task.step_inputs(task.prepare_batch(batch))
    assert frontend.KERNEL.launches == before + 2
    assert feats.shape == (96, 7, 1001, 64) and torch.equal(feats, feats2)
    assert all(torch.equal(tgt[k], tgt2[k]) for k in tgt)

    def grads(use_kernels, dtype):
        task.set_use_kernels(use_kernels)
        task.compute_dtype = dtype
        counts = [k.launches for k in (swin_block.KERNEL, swin_block_vjp.KERNEL)]
        losses, g, _ = task.grads_on(feats, tgt, torch.Generator(device=card).manual_seed(9))
        done = [k.launches - c for k, c in zip((swin_block.KERNEL, swin_block_vjp.KERNEL), counts)]
        assert done == ([8, 8] if use_kernels else [0, 0]), done
        return [losses["loss_all"].float().reshape(1)] + [x.float() for x in g]

    k16, p16, p32 = grads(True, torch.bfloat16), grads(False, torch.bfloat16), grads(
        False, torch.float32)
    for i, (a, b, c) in enumerate(zip(k16, p16, p32)):
        scale = c.abs().max().item()
        tol = 2.0 ** -6 if i == 0 else 2.0 ** -4
        assert torch.isfinite(a).all()
        assert (a - b).abs().max().item() <= tol * scale, i
        assert (a - c).abs().max().item() <= 1.25 * (b - c).abs().max().item() + 2 ** -7 * scale, i
