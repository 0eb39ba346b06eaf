"""The frontend's kernels at mel widths over 64 on the CPU: the flat and DIF
forms (K9, K10) at 96, 128 and 256 mels, their plain versions against the
Pallas fused_logmel_iv in interpret mode and the XLA extractor, the kernels'
wide layout (each column tile's mels in groups of 64 from its first one, the
sums in a scratch of the block's own) replayed in numpy, the launches they
take at every width; and K1's plain version at 128 mels against the JAX DIT
kernel."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pseldnets_tpu.ops.features import LogmelIVExtractor as JaxExtractor
from pseldnets_tpu.ops.pallas import frontend as jax_frontend
from pseldnets_tpu_torch.ops import frontend, frontend_forms
from pseldnets_tpu_torch.ops.features import logmel_iv_filterbank, logmel_iv_from_spectrum
import torch_threads  # noqa: F401  (each xdist worker's share of the cores)
from test_torch_frontend_forms import SR, _cfg, _errs, _replay_dif, _replay_flat, _wav

WIDE = (96, 128, 256)
# the kernels' shapes in chip_smoke.py's FORM_CASES: (form, n_fft, hop, window)
SHAPES = (("flat", 1024, 240, "hann"), ("dif", 1024, 240, "hann"), ("dif", 1024, 240, "hamming"),
          ("flat", 512, 100, "hann"), ("dif", 512, 100, "hann"), ("flat", 1024, 241, "hann"),
          ("flat", 1023, 241, "hamming"), ("flat", 2048, 240, "hann"))


@pytest.fixture
def rng():
    """A fresh generator for each test: each test's data is fixed, whatever
    ran before it on the same worker."""
    return np.random.default_rng(25)


def _budget_errs(got, xla, n_fft):
    """(dB, IV) distance from the float32 XLA extractor under the feature
    budget's rule (test_torch_frontend_forms.py ``_within_budget``): at n_fft
    512 the dB channels take the JAX package's rtol 2e-5 of the value."""
    rtol = 2e-5 if n_fft == 512 else 0.0
    got, xla = np.asarray(got, np.float64), np.asarray(xla, np.float64)
    db = np.abs(got[:, :4] - xla[:, :4]) - rtol * np.abs(xla[:, :4])
    return db.max(), np.abs(got[:, 4:] - xla[:, 4:]).max()


def _float64(x, n_fft, hop, window, n_mels):
    """The features from the float64 DFT and filterbank."""
    fb64 = torch.as_tensor(logmel_iv_filterbank(SR, n_fft, n_mels)).double()
    spec = frontend_forms.flat_spectrum(torch.from_numpy(x).double(), n_fft, hop, window)
    return logmel_iv_from_spectrum(*spec, fb64).numpy()


@pytest.mark.parametrize("form,n_fft,hop,window,n_mels", [
    s + (128,) for s in SHAPES if s[1] in (512, 1024) and s[2] != 241 and s[3] == "hann"]
    + [("flat", 1024, 240, "hann", 96), ("dif", 1024, 240, "hann", 96),
       ("flat", 512, 100, "hann", 256), ("dif", 512, 100, "hann", 256)])
def test_wide_plain_matches_pallas_and_xla(rng, form, n_fft, hop, window, n_mels):
    """K9's and K10's plain versions at 128 mels (and 96 at n_fft 1024, 256
    at n_fft 512, its narrowest bands) against the
    Pallas kernel of the same form (radix2=False / variant="dif", f32,
    interpret): 5e-3 dB / 1e-4 IV, the bound the 64-mel forms are held to
    (tests/test_pallas_frontend.py's); within the 8e-4 dB / 7e-5 IV budget
    of the float64 DFT; and against the float32 XLA extractor within that
    budget or the Pallas kernel's own distance from it, the larger. At n_fft
    512 the narrow low bands (one bin or none at 256 mels: -100 dB on every
    side) put the XLA extractor itself 2.2e-3 dB from float64 and the Pallas
    kernel 1.3e-3 dB (with the rtol) from it on this draw."""
    x = _wav(rng, N=12000)
    plain = (frontend_forms.logmel_iv_flat_plain if form == "flat"
             else frontend_forms.logmel_iv_dif_plain)
    got = plain(torch.from_numpy(x), n_fft=n_fft, hop=hop, window=window, n_mels=n_mels).numpy()
    kw = {"radix2": False} if form == "flat" else {"variant": "dif"}
    ref = np.asarray(jax_frontend.fused_logmel_iv(jnp.asarray(x), n_fft=n_fft, hop=hop,
                                                  window=window, n_mels=n_mels, t_blk=32,
                                                  interpret=True, **kw))
    xla = np.asarray(JaxExtractor(_cfg(n_fft, hop, window, n_mels), backend="xla")(
        jnp.asarray(x)))
    assert got.shape == ref.shape == xla.shape == (1, 7, 1 + 12000 // hop, n_mels)
    db, iv = _errs(got, ref)
    assert db < 5e-3 and iv < 1e-4, (db, iv)
    db, iv = _errs(got, _float64(x, n_fft, hop, window, n_mels))
    assert db <= 8e-4 and iv <= 7e-5, (db, iv)
    db, iv = _budget_errs(got, xla, n_fft)
    db_ref, iv_ref = _budget_errs(ref, xla, n_fft)
    assert db <= max(8e-4, db_ref) and iv <= max(7e-5, iv_ref), (db, iv, db_ref, iv_ref)


@pytest.mark.parametrize("n_mels", WIDE)
@pytest.mark.parametrize("form,n_fft,hop,window", [("flat", 1024, 240, "hann"),
                                                   ("flat", 1023, 241, "hamming"),
                                                   ("dif", 512, 100, "hann"),
                                                   ("dif", 2048, 240, "hamming")])
def test_wide_kernel_replays_match_float64(rng, form, n_fft, hop, window, n_mels):
    """The kernels' wide layout replayed in numpy (test_torch_frontend_forms
    ``_replay_flat``/``_replay_dif``: each tile's groups of 64 mels from its
    first mel, a multiple of 8, the tables of each group, the sums over the
    tiles in order; K10's window on the samples), in float64, gives the
    float64 DFT's features within the tables' split rounding (8e-4 dB, 7e-5
    IV): the layout computes the function. (Against the float32 plain
    version the distance is that version's own rounding, up to 2.0e-3 dB at
    a band 72 dB under its frame's loudest at n_fft 2048 and 256 mels; the
    plain versions are held to float64 and to the Pallas kernels above.)"""
    x = _wav(rng, N=4800)
    replay = _replay_flat if form == "flat" else _replay_dif
    got = replay(x.astype(np.float64), n_fft, hop, window, n_mels)
    ref = _float64(x, n_fft, hop, window, n_mels)
    assert got.shape == ref.shape == (1, 7, 1 + 4800 // hop, n_mels)
    db, iv = _errs(got, ref)
    assert db <= 8e-4 and iv <= 7e-5, (db, iv)


def test_dif_window_in_time_at_a_silent_edge(rng):
    """Why K10's wide form windows the samples: on 2 s clips silent for
    their first half second (n_fft 1024, hop 240, hann), frames that end in
    the onset put the 3-tap in frequency (the narrow form at 64 mels, and
    the same spectrum through the wide mel sums at 96) past 8e-4 dB from
    the float64 DFT, while the window on the samples (the wide form at 96)
    stays within it."""
    x = _wav(rng, N=48000)
    x[..., :12000] = 0.0
    xt = torch.from_numpy(x)
    kw = dict(n_fft=1024, hop=240, window="hann")
    narrow = frontend_forms.logmel_iv_dif_plain(xt, n_mels=64, **kw).numpy()
    wide = frontend_forms.logmel_iv_dif_plain(xt, n_mels=96, **kw).numpy()
    tap = frontend_forms.tile_mel_features(
        "dif", *frontend_forms.dif_spectrum(xt, **kw), 1024, 96, SR).numpy()
    assert _errs(narrow, _float64(x, 1024, 240, "hann", 64))[0] > 8e-4
    f64 = _float64(x, 1024, 240, "hann", 96)
    assert _errs(tap, f64)[0] > 8e-4
    db, iv = _errs(wide, f64)
    assert db <= 8e-4 and iv <= 7e-5, (db, iv)


def test_wide_tables_cover_every_weight():
    """At each wide width and shape the groups of a tile hold every non-zero
    mel weight of its bins once (the tables' hi + lo, summed over the
    groups, give the filterbank back within the split's 2^-22), and a tile's
    first mel is a multiple of 8."""
    for form, n_fft, _, window in SHAPES[:5]:
        for n_mels in WIDE:
            fb = frontend_forms.logmel_iv_filterbank(SR, n_fft, n_mels).astype(np.float64)
            bins = frontend_forms.tile_bins(form, n_fft, n_mels, SR)
            plan = frontend_forms.mel_plan(form, n_fft, n_mels, SR)
            tables = (frontend_forms.flat_tables(n_fft, window, n_mels, SR)[1] if form == "flat"
                      else frontend_forms.dif_tables(n_fft, n_mels, SR)[1])
            assert tables.shape == (plan[-1, 1], 2, 64, 64) and not (plan[:-1, 0] % 8).any()
            back = np.zeros_like(fb)
            inverse = np.argsort(frontend_forms.local_order())
            for t, tile in enumerate(bins):
                for j, g in enumerate(range(plan[t, 1], plan[t + 1, 1])):
                    m0 = plan[t, 0] + 64 * j
                    w = (tables[g, 0].astype(np.float64) + tables[g, 1])[:, inverse]  # (mel, local)
                    n = min(64, n_mels - m0)
                    ok = tile >= 0
                    np.add.at(back, (tile[ok][:, None], np.arange(m0, m0 + n)[None]),
                              w[:n, ok].T)
            assert np.abs(back - fb).max() <= 2.0 ** -21 * np.abs(fb).max(), (form, n_fft, n_mels)


def test_launch_plan_takes_every_width():
    """``launch_plan`` (the C entries' mirror) takes every n_mels from 1 to
    256 at every FORM_CASES shape, B=32 ten-second clips (K9's folded form
    at 1024 frames), within the block's shared memory and TMA's box limits:
    the narrow form up to 64 mels, the wide one (no shared accumulator, a
    scratch of the blocks' own) above."""
    for form, n_fft, hop, _ in SHAPES:
        n_frames = 1 + 240000 // hop
        t_out = 1024 if (form, n_fft) == ("flat", 2048) else n_frames
        for n_mels in range(1, 257):
            plan = frontend_forms.launch_plan(form, 32, 240000, n_fft, hop, n_mels, SR, t_out)
            assert plan["smem"] <= frontend_forms.SMEM_LIMIT
            assert max(plan["tab_box"] + plan["fb_box"]) <= 256
            assert plan["wide"] == (n_mels > 64)
            assert plan["n_groups"] == sum(plan["mel_groups"]) >= plan["n_tiles"]
            if plan["wide"]:
                assert plan["scratch"] == (32, plan["grid"][0], 32, 7, n_mels)
            else:
                assert plan["mel_groups"] == (1,) * plan["n_tiles"]


def test_wide_widths_route_to_the_forms_on_the_cpu(rng):
    """fused_logmel_iv at 128 mels takes the routed form's plain version on
    a CPU tensor, counts no launch, and hands a tensor off the CPU to the
    kernel's wrapper (which refuses a meta tensor there, not the width)."""
    x = torch.from_numpy(_wav(rng, N=4800))
    kernels = (frontend.KERNEL, frontend_forms.FLAT_KERNEL, frontend_forms.DIF_KERNEL)
    for k in kernels:
        k.launches = 0
    for kw, plain in (({"radix2": False}, frontend_forms.logmel_iv_flat_plain),
                      ({"variant": "dif"}, frontend_forms.logmel_iv_dif_plain)):
        got = frontend.fused_logmel_iv(x, n_mels=128, **kw)
        assert got.shape == (1, 7, 21, 128)
        assert torch.equal(got, plain(x, n_fft=1024, hop=240, n_mels=128))
        with pytest.raises(ValueError, match="expected a CUDA tensor"):
            frontend.fused_logmel_iv(x.to("meta"), n_mels=256, **kw)
    assert all(k.launches == 0 for k in kernels)


@pytest.mark.parametrize("hop,folds", [(240, False), (480, True)])
def test_k1_plain_at_128_mels_matches_the_dit_kernel(rng, hop, folds):
    """K1's plain version at 128 mels against the JAX DIT kernel (f32,
    interpret), plain and with the serving folds (the ScalarBN affine, the
    zero tail to 512 frames: HTSAT at 128 mels and hop 480): 5e-3 dB / 1e-4
    IV as the 64-mel K1 (tests/test_torch_frontend.py), scaled by |inv| <=
    1.5 where folded."""
    x = _wav(rng, N=12000)
    n_frames = 1 + 12000 // hop
    kw = dict(n_fft=1024, hop=hop, n_mels=128)
    jkw, tkw = {}, {}
    if folds:
        inv = (rng.random((7, 128)) + 0.5).astype(np.float32)
        shift = rng.standard_normal((7, 128)).astype(np.float32)
        jkw = dict(post_affine=(inv, shift), full_frames=True)
        tkw = dict(post_affine=(torch.from_numpy(inv), torch.from_numpy(shift)))
    ref = np.asarray(jax_frontend.fused_logmel_iv(jnp.asarray(x), t_blk=32, interpret=True,
                                                  **kw, **jkw))
    t_out = ref.shape[2] if folds else None
    got = frontend.fused_logmel_iv(torch.from_numpy(x), t_out=t_out, **kw, **tkw).numpy()
    assert got.shape == ref.shape and got.shape[-1] == 128
    assert not got[:, :, n_frames:].any()
    db, iv = _errs(got, ref)
    scale = 1.5 if folds else 1.0
    assert db < 5e-3 * scale and iv < 1e-4 * scale, (db, iv)
