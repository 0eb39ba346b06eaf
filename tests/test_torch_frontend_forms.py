"""The frontend's flat and DIF forms (kernels K9 and K10) on the CPU: their
plain versions against the Pallas fused_logmel_iv in interpret mode
(radix2=False and variant="dif") and the XLA extractor, numpy replays of the
kernels' tables, tiles and per-bin band scatter, the routing against the
JAX package's selection, and the callers that route (fused_logmel_iv,
LogmelIVExtractor)."""

import jax
import jax.experimental.pallas
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pseldnets_tpu.ops.features import LogmelIVExtractor as JaxExtractor
from pseldnets_tpu.ops.pallas import frontend as jax_frontend
from pseldnets_tpu_torch.ops import frontend, frontend_forms
from pseldnets_tpu_torch.ops.features import LogmelIVExtractor, logmel_iv
import torch_threads  # noqa: F401  (each xdist worker's share of the cores)

SR = 24000


@pytest.fixture
def rng():
    """A fresh generator for each test (in place of the session one): each
    test's data is fixed, whatever ran before it on the same worker."""
    return np.random.default_rng(6)


def _cfg(n_fft, hop, window, n_mels=64):
    return {"data": {"nfft": n_fft, "hoplen": hop, "window": window, "sample_rate": SR,
                     "n_mels": n_mels, "frontend_dft": "f32"}}


def _wav(rng, N=24000):
    return (rng.standard_normal((1, 4, N)) * 0.2).astype(np.float32)


def _errs(a, b):
    """(max |dB| over the 4 log-mel channels, max |diff| over the 3 IV ones)."""
    d = np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64))
    return d[:, :4].max(), d[:, 4:].max()


def _within_budget(got, xla, n_fft):
    """The feature budget against the float32 XLA extractor: 8e-4 dB
    log-mel, 7e-5 IV. At n_fft 512 (64 mels, bands of one bin) the deepest
    spectral valleys put any float32 DFT's dB error there at the mercy of
    the draw: the Pallas flat kernel itself lies 2.5e-3 dB from the XLA
    extractor on this file's draw; the dB channels take the JAX package's
    own allowance for that shape, rtol 2e-5 of the value
    (tests/test_pallas_frontend.py:104-106)."""
    rtol = 2e-5 if n_fft == 512 else 0.0
    got, xla = np.asarray(got, np.float64), np.asarray(xla, np.float64)
    db = np.abs(got[:, :4] - xla[:, :4]) - rtol * np.abs(xla[:, :4])
    return db.max() <= 8e-4 and np.abs(got[:, 4:] - xla[:, 4:]).max() <= 7e-5


FLAT_CASES = [(1024, 240, "hann"), (1024, 240, "hamming"), (512, 100, "hann"),
              (1024, 241, "hann")]
DIF_CASES = [(1024, 240, "hann"), (1024, 240, "hamming"), (512, 100, "hann")]


@pytest.mark.parametrize("n_fft,hop,window", FLAT_CASES)
def test_flat_plain_matches_pallas_and_xla(rng, n_fft, hop, window):
    """K9's plain version against the Pallas flat kernel (radix2=False, f32,
    interpret; tests/test_pallas_frontend.py's 5e-3 dB / 1e-4 IV) and the
    XLA extractor (the 8e-4 dB / 7e-5 IV budget, ``_within_budget``)."""
    x = _wav(rng)
    got = frontend_forms.logmel_iv_flat_plain(torch.from_numpy(x), n_fft=n_fft, hop=hop,
                                              window=window).numpy()
    ref = np.asarray(jax_frontend.fused_logmel_iv(jnp.asarray(x), n_fft=n_fft, hop=hop,
                                                  window=window, radix2=False, t_blk=32,
                                                  interpret=True))
    xla = np.asarray(JaxExtractor(_cfg(n_fft, hop, window), backend="xla")(jnp.asarray(x)))
    assert got.shape == ref.shape == (1, 7, 1 + 24000 // hop, 64)
    db, iv = _errs(got, ref)
    assert db < 5e-3 and iv < 1e-4, (db, iv)
    assert _within_budget(got, xla, n_fft), _errs(got, xla)


@pytest.mark.parametrize("n_fft,hop,window", DIF_CASES)
def test_dif_plain_matches_pallas_and_xla(rng, n_fft, hop, window):
    """K10's plain version against the Pallas DIF kernel (variant="dif", f32,
    interpret) and the XLA extractor, with the same bounds; (512, 100):
    n_fft/2 is not a multiple of hop/2."""
    x = _wav(rng)
    got = frontend_forms.logmel_iv_dif_plain(torch.from_numpy(x), n_fft=n_fft, hop=hop,
                                             window=window).numpy()
    ref = np.asarray(jax_frontend.fused_logmel_iv(jnp.asarray(x), n_fft=n_fft, hop=hop,
                                                  window=window, variant="dif", t_blk=32,
                                                  interpret=True))
    xla = np.asarray(JaxExtractor(_cfg(n_fft, hop, window), backend="xla")(jnp.asarray(x)))
    assert got.shape == ref.shape
    db, iv = _errs(got, ref)
    assert db < 5e-3 and iv < 1e-4, (db, iv)
    assert _within_budget(got, xla, n_fft), _errs(got, xla)


def test_flat_folds_match_the_jax_dit_kernel(rng):
    """n_fft 2048: the JAX package runs its DIT kernel, the port K9 with K1's
    folds (affine, zero tail, bf16): the float32 folded form against the
    Pallas DIT kernel (f32, interpret) within the feature budget scaled by
    |inv| <= 1.5, and the bf16 form the cast of the float32 one."""
    x = _wav(rng)
    inv = (rng.random((7, 64)) + 0.5).astype(np.float32)
    shift = rng.standard_normal((7, 64)).astype(np.float32)
    kw = dict(n_fft=2048, hop=240, window="hann")
    ref = np.asarray(jax_frontend.fused_logmel_iv(
        jnp.asarray(x), t_blk=32, interpret=True, post_affine=(inv, shift), full_frames=True,
        **kw))
    aff = (torch.from_numpy(inv), torch.from_numpy(shift))
    assert frontend.frontend_route(2048, 240, folds=True) == "flat"
    got = frontend.fused_logmel_iv(torch.from_numpy(x), post_affine=aff, t_out=ref.shape[2],
                                   **kw).numpy()
    assert got.shape == ref.shape == (1, 7, 128, 64)
    assert not got[:, :, 101:].any()
    db, iv = _errs(got, ref)
    assert db < 1.2e-3 and iv < 1.05e-4, (db, iv)
    bf = frontend.fused_logmel_iv(torch.from_numpy(x), post_affine=aff, t_out=128,
                                  out_dtype=torch.bfloat16, **kw)
    assert bf.dtype == torch.bfloat16 and torch.equal(bf, torch.from_numpy(got).bfloat16())


def _padded_sample(x, pad, i):
    """csrc/frontend_common.cuh padded_sample over an index array (numpy):
    a reflect pad of ``pad`` on both sides, zeros beyond it."""
    N = x.shape[-1]
    j = i - pad
    j = np.where(j < 0, -j, np.where(j >= N, 2 * (N - 1) - j, j))
    return np.where((i >= 0) & (i < N + 2 * pad), x[..., np.clip(j, 0, N - 1)], 0.0)


def _bin_values(re, im):
    """(..., 4, bins) -> (..., 7, bins): frontend_common.cuh bin_values."""
    power = re * re + im * im
    iv = re[..., 1:4, :] * re[..., :1, :] + im[..., 1:4, :] * im[..., :1, :]
    nrm = np.sqrt((iv * iv).sum(-2, keepdims=True)) + np.finfo(np.float32).eps
    return np.concatenate([power, iv / nrm], axis=-2)


def _finish(acc):
    out = acc.copy()
    out[:, :4] = 10.0 * np.log10(np.maximum(out[:, :4], 1e-10))
    return out


def _columns(width):
    """Column 8 j + 2 u + part of a wgmma accumulator ``width`` wide holds
    complex index (width // 8) u + j (thread u of a lane quad owns
    consecutive indices): (index, part) per column."""
    col = np.arange(width)
    return width // 8 * ((col % 8) // 2) + col // 8, col % 2


def _mel_replay(vals, fb, plan, t, n_mels):
    """The mel GEMMs of tile t: values (..., 7, 64 locals), position 8 kk +
    c of its k holding local 16 (c % 4) + 2 kk + c // 4, against each of
    the tile's groups' hi + lo mel tables (rows the group's mels: plan[t, 0]
    + 64 j + r), scattered to the mels < n_mels: (..., 7, n_mels). The
    tile's first mel is a multiple of 8, so that the thread owning a mel's
    sum (column 8 i + 2 u + e: lane u = mel // 2 % 4) is the same in every
    tile."""
    kk, c = np.divmod(np.arange(64), 8)
    order = 16 * (c % 4) + 2 * kk + c // 4
    assert plan[t, 0] % 8 == 0
    out = np.zeros(vals.shape[:-1] + (n_mels,))
    for j, g in enumerate(range(plan[t, 1], plan[t + 1, 1])):
        m0 = plan[t, 0] + 64 * j
        table = fb[g, 0].astype(np.float64) + fb[g, 1]
        sums = vals[..., order] @ table.T
        n = min(64, n_mels - m0)
        out[..., m0:m0 + n] += sums[..., :n]
    return out


def _replay_flat(x, n_fft, hop, window, n_mels=64):
    """numpy replay of csrc/frontend_flat.cu in float64: rows (frame,
    channel) read from the padded signal at stride hop (zero past n_fft),
    each tile's hi + lo table (rows its columns),
    bins as (re, im) column pairs in the quad layout, the seven values per
    local bin and the tile's mel GEMMs (one a group of 64 mels)."""
    tab, fb = frontend_forms.flat_tables(n_fft, window, n_mels, SR)
    plan = frontend_forms.mel_plan("flat", n_fft, n_mels, SR)
    n_tiles, _, cols, Kp = tab.shape
    n_frames = 1 + x.shape[-1] // hop
    pos = frontend_forms.k_order(Kp)  # the sample at each k position
    idx = np.arange(n_frames)[:, None] * hop + pos[None]
    a = np.where(pos < n_fft, _padded_sample(x, n_fft // 2, idx), 0.0)  # (B, 4, T, Kp)
    local, part = _columns(cols)
    acc = np.zeros((x.shape[0], n_frames, 7, n_mels))
    for t in range(n_tiles):
        spec = a @ (tab[t, 0].astype(np.float64) + tab[t, 1]).T  # (B, 4, T, 128)
        re, im = np.zeros(spec.shape[:-1] + (64,)), np.zeros(spec.shape[:-1] + (64,))
        re[..., local[part == 0]] = spec[..., part == 0]
        im[..., local[part == 1]] = spec[..., part == 1]
        vals = _bin_values(re.transpose(0, 2, 1, 3), im.transpose(0, 2, 1, 3))  # (B, T, 7, 64)
        acc += _mel_replay(vals, fb, plan, t, n_mels)
    return _finish(acc.transpose(0, 2, 1, 3))


def _replay_dif(x, n_fft, hop, window, n_mels=64):
    """numpy replay of csrc/frontend_dif.cu in float64: the sum and
    difference streams from the padded signal (over 64 mels each frame's
    halves first times the window table's two rows), each
    tile's two table halves (hi + lo), the local spectrum (local
    2i + 1: sum-stream index i, local 2i: difference-stream index i, each
    half in the quad layout), at 64 mels and fewer the 3-tap with the
    conjugate fix-ups at bins 0 and n_fft/2 on local bins 1 .. 62, the
    values and the mel GEMM."""
    tab, fb, s0 = frontend_forms.dif_tables(n_fft, n_mels, SR)
    plan = frontend_forms.mel_plan("dif", n_fft, n_mels, SR)
    n_tiles, _, cols, Kp = tab.shape
    hf = n_fft // 2
    a0, a1 = frontend_forms.WIN_3TAP[window]
    in_time = n_mels > 64
    n_frames = 1 + x.shape[-1] // hop
    pos = frontend_forms.k_order(Kp)
    idx = np.arange(n_frames)[:, None] * hop + pos[None]
    keep = pos < hf
    lo = np.where(keep, _padded_sample(x, hf, idx), 0.0)
    hi = np.where(keep, _padded_sample(x, hf, idx + hf), 0.0)
    if in_time:
        win = frontend_forms.dif_window(n_fft, window).astype(np.float64)
        lo, hi = lo * win[0, pos], hi * win[1, pos]
    index, part = _columns(cols // 2)
    acc = np.zeros((x.shape[0], n_frames, 7, n_mels))
    for t in range(n_tiles):
        base = 2 * (s0 + frontend_forms.DIF_STEP * t) - 1
        table = (tab[t, 0].astype(np.float64) + tab[t, 1]).T  # (Kp, 128)
        X = np.zeros(lo.shape[:-1] + (64,), complex)
        for stream, half, offset in ((lo + hi, table[:, :64], 1), (lo - hi, table[:, 64:], 0)):
            s = stream @ half  # (B, 4, T, 64)
            X[..., 2 * index[part == 0] + offset] += s[..., part == 0]
            X[..., 2 * index[part == 1] + offset] += 1j * s[..., part == 1]
        xw = X if in_time else np.zeros_like(X)
        for l in range(1, 63) if not in_time else ():
            left, right = X[..., l - 1], X[..., l + 1]
            if base + l == 0:
                left = np.conj(X[..., l + 1])
            if base + l == hf:
                right = np.conj(X[..., l - 1])
            xw[..., l] = a0 * X[..., l] + a1 * (left + right)
        vals = _bin_values(xw.real.transpose(0, 2, 1, 3), xw.imag.transpose(0, 2, 1, 3))
        acc += _mel_replay(vals, fb, plan, t, n_mels)
    return _finish(acc.transpose(0, 2, 1, 3))


@pytest.mark.parametrize("form,n_fft,hop,window", [
    ("flat", 1024, 240, "hann"), ("flat", 1023, 241, "hamming"), ("flat", 2048, 240, "hann"),
    ("dif", 1024, 240, "hann"), ("dif", 512, 100, "hamming"), ("dif", 2048, 240, "hann")])
def test_kernel_replays_match_plain(rng, form, n_fft, hop, window):
    """The kernels' index logic (reflect pad and zero tail, the k order
    inside each k step, the K-major hi/lo table tiles and their quad column layout, the
    DIF local layout and window edges, each tile's mel tables over its local
    bins) replayed in numpy equals the form's plain version: within float32
    rounding of the plain side (1e-3 dB, 1e-5 IV)."""
    x = _wav(rng, N=12000)
    replay, plain = ((_replay_flat, frontend_forms.logmel_iv_flat_plain) if form == "flat"
                     else (_replay_dif, frontend_forms.logmel_iv_dif_plain))
    got = replay(x.astype(np.float64), n_fft, hop, window)
    ref = plain(torch.from_numpy(x), n_fft=n_fft, hop=hop, window=window).numpy()
    assert got.shape == ref.shape
    db, iv = _errs(got, ref)
    assert db < 1e-3 and iv < 1e-5, (db, iv)


@pytest.mark.parametrize("n_fft,hop,window,in_time", [
    pytest.param(1024, 240, "hann", False, id="1024-240-hann"),
    pytest.param(512, 100, "hamming", False, id="512-100-hamming"),
    pytest.param(1024, 240, "hann", True, id="in_time-1024-240-hann"),
    pytest.param(512, 100, "hamming", True, id="in_time-512-100-hamming")])
def test_dif_spectrum_matches_the_direct_dft(rng, n_fft, hop, window, in_time):
    """The DIF spectrum (two half-size DFTs, 3-tap window with the conjugate
    fix-ups; or, K10's wide form, each frame's halves times their halves of
    the window first) equals the direct windowed DFT at every bin, 0 and
    n_fft/2 included, within float32 rounding of the spectrum's scale; the
    wide form's window table holds the window's two halves in sample order,
    zero to Kp; and K10's tile 0 starts one bin below bin 0 (a zero column:
    bin -1 does not exist), its first difference-stream bin being bin 1."""
    x = torch.from_numpy(_wav(rng, N=6000))
    got = frontend_forms.dif_spectrum(x, n_fft, hop, window, in_time=in_time)
    win = frontend_forms.dif_window(n_fft, window)
    assert win.shape == (2, -(-n_fft // 64) * 32) and not win[:, n_fft // 2:].any()
    assert np.array_equal(win[:, :n_fft // 2].reshape(-1),
                          frontend_forms.get_window(window, n_fft).astype(np.float32))
    ref = frontend_forms.flat_spectrum(x.double(), n_fft, hop, window)
    scale = max(float(r.abs().max()) for r in ref)
    for g, r in zip(got, ref):
        assert float((g.double() - r).abs().max()) < 1e-5 * scale
    tab, fb, s0 = frontend_forms.dif_tables(1024, 64, SR)
    # bin 512 keeps a weight at float64 rounding of 0: its fix-up runs
    assert s0 == 0 and frontend_forms.weighted_bins(SR, 1024, 64) == (1, 512)
    # the difference stream's index 0 (bin -1) sits in columns 64, 65
    edges = np.isin(frontend_forms.local_order(), [0, 63])
    assert not tab[0, :, 64:66].any() and not fb[..., edges].any()
    # index 1 (bin 1): column 64 + 8, its cos over the samples in k order
    n = frontend_forms.k_order(512)
    np.testing.assert_allclose(tab[0, 0, 72].astype(np.float64) + tab[0, 1, 72],
                               np.cos(2 * np.pi * n / 1024), atol=1e-7)


class _Route(Exception):
    pass


def _jax_route(monkeypatch, n_fft, hop, window, radix2, variant, folds):
    """The JAX fused_logmel_iv's choice, traced without jit: "dif", "dit",
    "flat", or the NotImplementedError it raises."""
    def stop(tag):
        def call(*args, **kwargs):
            raise _Route(tag)
        return call

    monkeypatch.setattr(jax_frontend, "_call_dif", stop("dif"))
    monkeypatch.setattr(jax_frontend, "_call_radix2", stop("dit"))
    monkeypatch.setattr(jax.experimental.pallas, "pallas_call", stop("flat"))
    x = jnp.zeros((1, 4, 4 * n_fft))
    kw = dict(post_affine=(np.ones((7, 64), np.float32), np.zeros((7, 64), np.float32)),
              full_frames=True) if folds else {}
    try:
        jax_frontend.fused_logmel_iv.__wrapped__(x, n_fft=n_fft, hop=hop, window=window,
                                                 radix2=radix2, variant=variant, **kw)
    except _Route as r:
        return str(r)
    except NotImplementedError:
        return "raises"
    raise AssertionError("no route")


@pytest.mark.parametrize("n_fft", [1024, 2048, 512, 1023])
@pytest.mark.parametrize("hop", [240, 241, 100, 1024])
def test_route_matches_the_jax_selection(monkeypatch, n_fft, hop):
    """frontend_route against the JAX function's own choice over radix2,
    variant, window and folds: its DIT kernel is K1 at n_fft 1024 and K9
    elsewhere; what raises there raises here."""
    for radix2 in (None, True, False):
        for variant in ("dit", "dif"):
            for window in ("hann", "hamming", "blackman"):
                for folds in (False, True):
                    ref = _jax_route(monkeypatch, n_fft, hop, window, radix2, variant, folds)
                    try:
                        got = frontend.frontend_route(n_fft, hop, window, radix2, variant, folds)
                    except NotImplementedError:
                        got = "raises"
                    want = {"dit": "k1" if n_fft == 1024 else "flat"}.get(ref, ref)
                    assert got == want, (n_fft, hop, radix2, variant, window, folds, ref)


def test_fused_logmel_iv_routes_on_the_cpu(rng):
    """The port's fused_logmel_iv takes the routed form's plain version on a
    CPU tensor and counts no launch; a tensor on another device reaches the
    routed kernel's wrapper (and is refused there)."""
    x = torch.from_numpy(_wav(rng, N=4800))
    counts = (frontend.KERNEL, frontend_forms.FLAT_KERNEL, frontend_forms.DIF_KERNEL)
    for k in counts:
        k.launches = 0
    kw = dict(n_fft=1024, hop=240)
    assert torch.equal(frontend.fused_logmel_iv(x, radix2=False, **kw),
                       frontend_forms.logmel_iv_flat_plain(x, **kw))
    assert torch.equal(frontend.fused_logmel_iv(x, variant="dif", **kw),
                       frontend_forms.logmel_iv_dif_plain(x, **kw))
    assert torch.equal(frontend.fused_logmel_iv(x, hop=241, n_fft=1024),
                       frontend_forms.logmel_iv_flat_plain(x, n_fft=1024, hop=241))
    with pytest.raises(NotImplementedError, match="DIT"):
        frontend.fused_logmel_iv(x, variant="dif", out_dtype=torch.bfloat16, **kw)
    with pytest.raises(NotImplementedError, match="hop < n_fft"):
        frontend.fused_logmel_iv(x, n_fft=256, hop=320)
    for extra in ({"radix2": False}, {"variant": "dif"}, {"n_fft": 2048}):
        with pytest.raises(ValueError, match="expected a CUDA tensor"):
            frontend.fused_logmel_iv(x.to("meta"), **{**kw, **extra})
    assert all(k.launches == 0 and k._lib is None for k in counts)


@pytest.mark.parametrize("n_fft,hop", [(2048, 240), (1024, 241), (512, 100)])
def test_extractor_routes_every_n_fft(rng, n_fft, hop):
    """LogmelIVExtractor no longer raises for n_fft != 1024: on the CPU it
    runs the eager extractor, and a tensor off the CPU goes to
    fused_logmel_iv's K9."""
    ext = LogmelIVExtractor(_cfg(n_fft, hop, "hann"))
    x = torch.from_numpy(_wav(rng, N=9600))
    assert torch.equal(ext(x), logmel_iv(x, n_fft=n_fft, hop=hop, window="hann",
                                         mel_fb=ext.mel_fb))
    frontend_forms.FLAT_KERNEL.launches = 0
    with pytest.raises(ValueError, match="expected a CUDA tensor"):
        ext(x.to("meta"))
    assert frontend_forms.FLAT_KERNEL.launches == 0
