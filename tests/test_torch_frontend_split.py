"""The split-TF32 arithmetic of kernels K9 and K10 on the CPU: the operand
split (``tf32_split`` on the device's side, ``tf32_split_np`` for the host's
tables), the split tables against the float64 ones they come from, the plain
versions' accuracy against the float64 DFT beside the former two-level
float32 order, and the launch plan's refusals (ops/frontend_forms.py)."""

import numpy as np
import pytest
import torch

from pseldnets_tpu_torch.ops import frontend_forms as ff
from pseldnets_tpu_torch.ops.features import logmel_iv_filterbank, logmel_iv_from_spectrum
import torch_threads  # noqa: F401  (each xdist worker's share of the cores)

SR = 24000


def _rna_reference(x: np.ndarray) -> np.ndarray:
    """float32 x rounded to tf32 in float64 arithmetic: to a multiple of the
    ulp of 11 significant bits (2^-136 in the subnormal range, where the
    kept field is the same 10 bits), to nearest, ties away from zero."""
    x = x.astype(np.float64)
    _, e = np.frexp(x)
    ulp = np.maximum(np.ldexp(1.0, e - 11), 2.0 ** -136)
    return np.sign(x) * np.floor(np.abs(x) / ulp + 0.5) * ulp


def _floats(kind: str) -> np.ndarray:
    rng = np.random.default_rng(15)
    if kind == "normal":
        x = rng.standard_normal(20000) * np.exp(rng.uniform(-20, 20, 20000))
    elif kind == "ties":  # exactly half an ulp of tf32 above a tf32 value
        bits = (rng.integers(0x3000_0000, 0x4800_0000, 4000) & ~0x1FFF) | 0x1000
        x = bits.astype(np.uint32).view(np.float32)
    elif kind == "negative":
        x = -np.abs(rng.standard_normal(4000))
    elif kind == "zeros":
        x = np.array([0.0, -0.0, 1e-45, -1e-45])
    else:  # subnormal float32
        x = rng.integers(1, 1 << 23, 4000).astype(np.uint32).view(np.float32) * rng.choice([-1, 1], 4000)
    return np.asarray(x, np.float32)


@pytest.mark.parametrize("kind", ["normal", "ties", "negative", "zeros", "subnormal"])
def test_tf32_split_rounds_to_nearest_ties_away(kind):
    """``tf32_split``: hi is x rounded to 10 explicit mantissa bits, to
    nearest with ties away from zero (cvt.rna.tf32.f32), lo the same of x -
    hi; both keep their low 13 bits zero; hi + lo is x within 2^-22 of |x|
    (2^-137 in the subnormal range, whose tf32 grid is 2^-136)."""
    x = _floats(kind)
    hi, lo = ff.tf32_split(torch.from_numpy(x))
    hi, lo = hi.numpy(), lo.numpy()
    for part in (hi, lo):
        assert not (part.view(np.uint32) & 0x1FFF).any()
    np.testing.assert_array_equal(hi.astype(np.float64), _rna_reference(x))
    np.testing.assert_array_equal(lo.astype(np.float64),
                                  _rna_reference((x.astype(np.float64) - hi).astype(np.float32)))
    err = np.abs(hi.astype(np.float64) + lo - x)
    assert (err <= np.maximum(2.0 ** -22 * np.abs(x.astype(np.float64)), 2.0 ** -137)).all()
    if kind == "ties":  # rounded away from zero: the magnitude went up
        assert (np.abs(hi) > np.abs(x)).all()


def test_host_split_rebuilds_its_operand():
    """``tf32_split_np`` of float64 values: two tf32 parts (low 13 bits
    zero, hi the larger) whose sum is the value rounded to 22 significant
    bits, within 2^-22 of it."""
    x = np.random.default_rng(16).standard_normal(20000) * np.exp(
        np.random.default_rng(17).uniform(-10, 10, 20000))
    hi, lo = ff.tf32_split_np(x)
    for part in (hi, lo):
        assert part.dtype == np.float32 and not (part.view(np.uint32) & 0x1FFF).any()
    assert (np.abs(lo) <= np.abs(hi) * 2.0 ** -10).all()
    assert (np.abs(hi.astype(np.float64) + lo - x) <= 2.0 ** -22 * np.abs(x)).all()


@pytest.mark.parametrize("form,n_fft", [("flat", 1024), ("flat", 1023), ("dif", 1024),
                                        ("dif", 512)])
def test_split_tables_rebuild_the_float64_tables(form, n_fft):
    """The kernels' tables, hi + lo, against the float64 tables they are
    split from (within 2^-22 of each entry): each column of tile t is the
    windowed (cos, -sin) of its bin over the samples in the kernels' k order,
    zero past n_fft (DIF: n_fft/2) and for bins out of range; the mel tables are the filterbank's
    rows of each local bin in the mel GEMM's k order."""
    fbank = logmel_iv_filterbank(SR, n_fft, 64).astype(np.float64)
    if form == "flat":
        tab, fb = ff.flat_tables(n_fft, "hann", 64, SR)
        k_lo = ff.weighted_bins(SR, n_fft, 64)[0]
        full = ff._dft_table(n_fft, "hann")  # (n_fft, cos | -sin)
        n_freqs = n_fft // 2 + 1
        local, part = ff.tile_columns()
        K = n_fft
    else:
        tab, fb, s0 = ff.dif_tables(n_fft, 64, SR)
        idx, part = (np.tile(a, 2) for a in ff.tile_columns(64))
        K = n_fft // 2
    n_tiles, _, cols, Kp = tab.shape
    assert Kp % ff.BK == 0 and Kp >= K and cols == 128
    got = tab[:, 0].astype(np.float64) + tab[:, 1]
    for t in range(n_tiles):
        if form == "flat":
            bins = k_lo + ff.TILE_BINS * t + local
            ok = bins < n_freqs
            want = np.zeros((cols, K))
            want[ok] = full[:, np.where(part[ok] == 0, bins[ok], n_freqs + bins[ok])].T
            local_bins = k_lo + ff.TILE_BINS * t + np.arange(64)
        else:
            s = s0 + ff.DIF_STEP * t
            half = np.arange(cols) // 64
            bins = np.where(half == 0, 2 * s + 2 * idx, 2 * s - 1 + 2 * idx)
            ang = 2 * np.pi * (np.outer(bins, np.arange(K)) % n_fft) / n_fft
            want = np.where(part[:, None] == 0, np.cos(ang), -np.sin(ang))
            want *= ((bins >= 0) & (bins <= K))[:, None]
            local_bins = 2 * s - 1 + np.arange(64)
            local_bins[[0, 63]] = -1
        order = ff.k_order(Kp)  # the sample at each k position
        assert np.abs(got[t][:, order < K] - want[:, order[order < K]]).max() <= 2.0 ** -22
        assert not got[t][:, order >= K].any()
        rows = np.zeros((64, 64))
        ok = (local_bins >= 0) & (local_bins < fbank.shape[0])
        rows[ok] = fbank[local_bins[ok]]
        mel = fb[t, 0].astype(np.float64) + fb[t, 1]  # (mels, k)
        np.testing.assert_allclose(mel, rows.T[:, ff.local_order()], rtol=2.0 ** -22, atol=0)


def _two_level_f32(x, n_fft, hop, form):
    """The former kernels' arithmetic: float32 tables, partial sums of 16
    products added in order (the yardstick for the split order's rms)."""
    fb = torch.as_tensor(logmel_iv_filterbank(SR, n_fft, 64))
    n_frames = 1 + x.shape[-1] // hop
    xp = ff.padded_signal(x, n_fft, hop)

    def gemm(a, b):
        b = torch.from_numpy(b.astype(np.float32))
        out = None
        for k0 in range(0, a.shape[-1], 16):
            part = a[..., k0:k0 + 16] @ b[k0:k0 + 16]
            out = part if out is None else out + part
        return out

    if form == "flat":
        spec = gemm(xp.unfold(-1, n_fft, hop)[..., :n_frames, :], ff._dft_table(n_fft, "hann"))
        n_freqs = n_fft // 2 + 1
        return logmel_iv_from_spectrum(spec[..., :n_freqs], spec[..., n_freqs:], fb)
    hf = n_fft // 2
    lo = xp.unfold(-1, hf, hop)[..., :n_frames, :]
    hi = xp[..., hf:].unfold(-1, hf, hop)[..., :n_frames, :]
    tabs = ff._dif_tables(n_fft)
    even, odd = gemm(lo + hi, tabs[0]), gemm(lo - hi, tabs[1])
    n_even, n_odd = tabs[0].shape[1] // 2, tabs[1].shape[1] // 2
    re = even.new_empty(even.shape[:-1] + (hf + 1,))
    im = torch.empty_like(re)
    re[..., 0::2], im[..., 0::2] = even[..., :n_even], even[..., n_even:]
    re[..., 1::2], im[..., 1::2] = odd[..., :n_odd], odd[..., n_odd:]
    re_l = torch.cat([re[..., 1:2], re[..., :-1]], -1)
    im_l = torch.cat([-im[..., 1:2], im[..., :-1]], -1)
    re_r = torch.cat([re[..., 1:], re[..., -2:-1]], -1)
    im_r = torch.cat([im[..., 1:], -im[..., -2:-1]], -1)
    return logmel_iv_from_spectrum(0.5 * re - 0.25 * (re_l + re_r),
                                   0.5 * im - 0.25 * (im_l + im_r), fb)


@pytest.mark.parametrize("form", ["flat", "dif"])
@pytest.mark.parametrize("n_fft,hop", [(512, 100), (1024, 240)])
def test_split_plain_within_budget_of_float64(form, n_fft, hop):
    """The plain versions in the kernels' split-TF32 arithmetic against the
    float64 DFT, 2 s of noise at std 0.1: within the 8e-4 dB / 7e-5 IV
    budget, and an rms dB error no worse than 1.5x the former two-level
    float32 order's on the same input."""
    x = torch.from_numpy((np.random.default_rng(18).standard_normal((1, 4, 48000)) * 0.1)
                         .astype(np.float32))
    fb64 = torch.as_tensor(logmel_iv_filterbank(SR, n_fft, 64)).double()
    ref = logmel_iv_from_spectrum(*ff.flat_spectrum(x.double(), n_fft, hop), fb64)
    plain = ff.logmel_iv_flat_plain if form == "flat" else ff.logmel_iv_dif_plain
    d = (plain(x, n_fft=n_fft, hop=hop).double() - ref).abs()
    old = (_two_level_f32(x, n_fft, hop, form).double() - ref).abs()
    assert d[:, :4].max() <= 8e-4 and d[:, 4:].max() <= 7e-5, (d[:, :4].max(), d[:, 4:].max())
    rms, rms_old = (float(e[:, :4].pow(2).mean().sqrt()) for e in (d, old))
    assert rms <= 1.5 * rms_old, (rms, rms_old)


def test_launch_plan_mirrors_the_kernels():
    """``launch_plan``: the cell's launch (B=32, 10 s, n_fft 1024, hop 240)
    in both forms and at wider mels, the tables it implies, and the shapes
    the C entries refuse (no mels, too many clips, t_out short of the
    frames), refused before any launch."""
    flat = ff.launch_plan("flat", 32, 240000, 1024, 240, 64, SR, 1001)
    dif = ff.launch_plan("dif", 32, 240000, 1024, 240, 64, SR, 1001)
    assert (flat["Kp"], flat["n_tiles"], dif["Kp"], dif["n_tiles"]) == (1024, 8, 512, 9)
    assert flat["grid"] == dif["grid"] == (32, 32) and flat["threads"] == 384
    assert flat["smem"] <= ff.SMEM_LIMIT and flat["tab_box"] == (32, 256)
    assert flat["stages_a_tile"] == 33 and dif["stages_a_tile"] == 17
    tab, fb = ff.flat_tables(1024, "hann", 64, SR)
    assert tab.shape == (8, 2, 128, 1024) and fb.shape == (8, 2, 64, 64)
    # K9 with K1's folds: zero frames to t_out, in whole blocks of 32
    assert ff.launch_plan("flat", 2, 48000, 2048, 240, 64, SR, 208)["grid"] == (7, 2)
    # wider mels: the same launch, the sums in a scratch of the blocks' own
    # and no shared-memory accumulator; the widest tile's mel groups
    for n_mels, groups in ((96, 1), (128, 1), (256, 2)):
        wide = ff.launch_plan("flat", 32, 240000, 1024, 240, n_mels, SR, 1001)
        assert wide["wide"] and wide["grid"] == (32, 32) and wide["smem"] < flat["smem"]
        assert wide["scratch"] == (32, 32, 32, 7, n_mels) and max(wide["mel_groups"]) == groups
        assert wide["fb_box"] == (32, 128) and wide["stages_a_tile"] == 32 + groups
    for kw in (dict(n_mels=0), dict(B=70000), dict(t_out=100)):
        args = dict(form="flat", B=2, N=48000, n_fft=1024, hop=240, n_mels=64,
                    sample_rate=SR, t_out=201)
        args.update(kw)
        with pytest.raises(NotImplementedError, match="do not take"):
            ff.launch_plan(**args)
    with pytest.raises(ValueError, match="form"):
        ff.launch_plan("dit", 2, 48000, 1024, 240, 64, SR, 201)
