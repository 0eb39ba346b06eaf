"""The logmel, GCC-PHAT and SALSA-lite features (ops/features.py), the FFT
STFT (ops/stft.py), the offline mic preprocessing
(preproc/preprocess.py ``extract_mic_features``) and FreqShift's pad modes
(augment/tf_device.py) against the JAX package's on the CPU.

Bounds (float32): log-mel and log-power dB within 1e-4 dB (the DFT's sums
in another order; a few ulps of values up to ~100 dB); GCC-PHAT lags and
SALSA-lite's normalized phase within 1e-5; SALSA-lite from the two
packages' own FFTs, whose rounding moves a small bin's log power and phase
as far as the bin is small, in the power domain and weighted by the bins'
magnitude (``_hold_salsa``); FreqShift bit for bit in the index modes and
within 1e-6 in the arithmetic ones (``mean``, ``linear_ramp``,
``median``)."""

from pathlib import Path

import h5py
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pseldnets_tpu.augment import tf_device as jaug
from pseldnets_tpu.config import compose as jax_compose
from pseldnets_tpu.data.datasets import get_dataset as jax_get_dataset
from pseldnets_tpu.ops import features as jfeat
from pseldnets_tpu.ops.stft import stft as jax_stft
from pseldnets_tpu.preproc import Preprocess as JaxPreprocess
from pseldnets_tpu_torch.augment import tf_device as taug
from pseldnets_tpu_torch.config import compose
from pseldnets_tpu_torch.data.datasets import get_dataset
from pseldnets_tpu_torch.ops import features as tfeat
from pseldnets_tpu_torch.ops import stft as tstft
from pseldnets_tpu_torch.preproc import Preprocess
from pseldnets_tpu_torch.utils.audio_io import write_wav
import torch_threads  # noqa: F401  (each xdist worker's share of the cores)
from test_torch_augment import FEAT_SHAPE, jax_draws

ROOT = Path(__file__).resolve().parents[1]
FS, NFFT, HOP, MELS = 16000, 512, 160, 32
# the SALSA-lite limits (no shipped config has a data.salsalite entry): the
# SALSA-lite paper's 50 Hz, 2 kHz and 9 kHz, the last cut to 8 kHz at 16 kHz
SALSALITE = {"fmin_doa": 50.0, "fmax_doa": 2000.0, "fmax_spectra": 8000.0}
DB_TOL, TOL = 1e-4, 1e-5


def _cfg(feature="logmel", n_mels=MELS):
    return compose(str(ROOT / "configs"), "train", [
        f"data.sample_rate={FS}", f"data.nfft={NFFT}", f"data.hoplen={HOP}",
        f"data.n_mels={n_mels}", f"data.audio_feature={feature}"])


def _wav(rng, B, C, n=FS):
    """Noise with a sine under it, one clip silent in its second half (the
    digital-silence bins of GCC-PHAT)."""
    t = np.arange(n) / FS
    x = 0.1 * rng.standard_normal((B, C, n)) + 0.3 * np.sin(2 * np.pi * 440.0 * t)
    x[0, :, n // 2:] = 0.0
    return x.astype(np.float32)


def _err(a, b):
    return float(np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64)).max())


@pytest.mark.parametrize("channels", [1, 4])
def test_logmel_extractor_matches_jax(channels):
    """make_extractor takes audio_feature=logmel to LogmelExtractor, (B, C,
    T, n_mels) at any channel count, within 1e-4 dB of the JAX one."""
    x = _wav(np.random.default_rng(channels), 2, channels)
    ex = tfeat.make_extractor(_cfg())
    assert isinstance(ex, tfeat.LogmelExtractor)
    got = ex(torch.from_numpy(x)).numpy()
    want = np.asarray(jfeat.LogmelExtractor(_cfg())(jnp.asarray(x)))
    assert got.shape == want.shape == (2, channels, 1 + FS // HOP, MELS)
    assert _err(got, want) <= DB_TOL, _err(got, want)


@pytest.fixture(scope="module")
def spectra():
    """The FFT STFT of a 4-channel batch in both packages."""
    x = _wav(np.random.default_rng(7), 2, 4)
    got = tstft.stft(torch.from_numpy(x), NFFT, HOP, "hann")
    want = jax_stft(jnp.asarray(x), NFFT, HOP, "hann")
    return [t.numpy() for t in got], [np.asarray(t) for t in want]


def test_fft_stft_matches_jax(spectra):
    """ops/stft.py ``stft`` (frames through rfft) against the JAX ``stft``:
    within 1e-5 of the spectrum's largest magnitude."""
    got, want = spectra
    for a, b in zip(got, want):
        assert a.shape == b.shape == (2, 4, 1 + FS // HOP, NFFT // 2 + 1)
        assert _err(a, b) <= TOL * np.abs(b).max()


def test_gcc_phat_matches_jax(spectra):
    """gcc_phat on the JAX spectra: the 6 pairs in (m, n) order, the centre
    lags, a silent bin's phase 1 (not 0/0), within 1e-5 of JAX's."""
    _, (re, im) = spectra
    got = tfeat.gcc_phat(torch.from_numpy(re), torch.from_numpy(im), MELS).numpy()
    want = np.asarray(jfeat.gcc_phat(jnp.asarray(re), jnp.asarray(im), MELS))
    assert got.shape == want.shape == (2, 6, re.shape[2], MELS)
    assert np.isfinite(got).all()
    assert (re[0, :, -1] == 0).all()  # the silent half: every bin of a frame is 0
    assert _err(got, want) <= TOL, _err(got, want)


def test_salsa_lite_matches_jax(spectra):
    """salsa_lite (the bins above the DOA limit zeroed from the sliced
    range's index upper_bin on, as the reference) within 1e-4 dB (log
    power) and 1e-5 (phase) of JAX's."""
    _, (re, im) = spectra
    args = (FS, NFFT, SALSALITE["fmin_doa"], SALSALITE["fmax_doa"], SALSALITE["fmax_spectra"])
    assert tfeat.salsa_lite_bins(*args[:2], *args[2:]) == jfeat.salsa_lite_bins(*args)
    lo, up, cut = tfeat.salsa_lite_bins(*args)
    got = tfeat.salsa_lite(torch.from_numpy(re), torch.from_numpy(im), *args).numpy()
    want = np.asarray(jfeat.salsa_lite(jnp.asarray(re), jnp.asarray(im), *args))
    assert got.shape == want.shape == (2, 7, re.shape[2], cut - lo)
    assert _err(got[:, :4], want[:, :4]) <= DB_TOL
    assert _err(got[:, 4:], want[:, 4:]) <= TOL
    assert (got[:, 4:, :, up:] == 0).all() and up < cut - lo


def _hold_salsa(got, want):
    """SALSA-lite from two FFTs' spectra: their float32 rounding moves a
    raw bin's log power and phase by as much as the bin is small, so both
    are held where the bins carry power: the power within 1e-5 of the
    largest, and each channel's phase as the wrapped angle difference
    times its cross-spectrum magnitude (sqrt of the two channels' powers)
    within 1e-5 of the largest magnitude."""
    lo, _, cut = tfeat.salsa_lite_bins(FS, NFFT, *SALSALITE.values())
    power = [10.0 ** (np.asarray(v[:4], np.float64) / 10.0) for v in (got, want)]
    assert _err(*power) <= TOL * power[1].max()
    f = np.arange(NFFT // 2 + 1, dtype=np.float64)[lo:cut]
    delta = 2.0 * np.pi * FS / (NFFT * 343.0)
    turn = (got[4:].astype(np.float64) - want[4:]) * delta * f
    turn = np.abs((turn + np.pi) % (2 * np.pi) - np.pi)
    mag = np.sqrt(power[1][1:] * power[1][:1])
    assert float((turn * mag).max()) <= TOL * mag.max()


def _mic_corpus(root, rng, n_clips=2):
    """4-channel mic WAVs (2 s and 2.5 s at 16 kHz) and frame-wise metadata."""
    mic, meta = root / "train2_ov1" / "mic", root / "train2_ov1" / "metadata"
    mic.mkdir(parents=True)
    meta.mkdir(parents=True)
    for i in range(n_clips):
        x = _wav(rng, 1, 4, FS * 2 + 8000 * i)[0]
        write_wav(mic / f"fold1_room1_mix{i:03d}.wav", x, FS)
        (meta / f"fold1_room1_mix{i:03d}.csv").write_text("0,0,0,10,5\n")
    (root / "cls_indices_train.tsv").write_text("".join(f"x\ty\tclass_{i}\n" for i in range(4)))


def _mic_overrides(root, hdf5, feature):
    return [f"data.sample_rate={FS}", f"data.nfft={NFFT}", f"data.n_mels={MELS}",
            f"data.hoplen={HOP}", f"data.audio_feature={feature}", "dataset=train2_ov1",
            "wav_format=.wav", f"paths.dataset_dir={root}", f"paths.hdf5_dir={hdf5}",
            "num_workers=0"]


@pytest.mark.parametrize("feature", ["logmelgcc", "salsalite"])
def test_mic_features_match_jax_preprocess(tmp_path, feature):
    """Preprocess.extract_mic_features (on the CPU) against the JAX
    Preprocess on the same 4-channel WAVs, file by file: one ``feature``
    dataset each, float32, the shape of the JAX one, log-mel / log power
    within 1e-4 dB (logmelgcc: the per-channel 80 dB floor too), GCC-PHAT
    lags and phase within 1e-5."""
    root = tmp_path / "datasets"
    _mic_corpus(root, np.random.default_rng(11))
    out = {}
    for side in ("jax", "port"):
        over = _mic_overrides(root, tmp_path / f"hdf5_{side}", feature)
        cfg = (jax_compose if side == "jax" else compose)(str(ROOT / "configs"), "preproc", over)
        cfg["data"]["salsalite"] = dict(SALSALITE)
        if side == "jax":
            JaxPreprocess(cfg, jax_get_dataset("train2_ov1", cfg)).extract_mic_features()
        else:
            Preprocess(cfg, get_dataset("train2_ov1", cfg)).extract_mic_features("cpu")
        out[side] = sorted((tmp_path / f"hdf5_{side}").rglob("*.h5"))
    assert [p.name for p in out["port"]] == [p.name for p in out["jax"]] == [
        "fold1_room1_mix000.h5", "fold1_room1_mix001.h5"]
    split = 4
    for pj, pt in zip(out["jax"], out["port"]):
        with h5py.File(pj, "r") as hj, h5py.File(pt, "r") as ht:
            assert list(ht) == list(hj) == ["feature"]
            want, got = hj["feature"][()], ht["feature"][()]
        assert got.dtype == want.dtype == np.float32 and got.shape == want.shape
        assert got.shape[0] == (10 if feature == "logmelgcc" else 7)
        assert got.shape[1] == (FS * 2 + 8000 * int(pt.stem[-1])) // HOP
        if feature == "logmelgcc":
            assert _err(got[:split], want[:split]) <= DB_TOL, pt.name
            assert _err(got[split:], want[split:]) <= TOL, pt.name
        else:
            _hold_salsa(got, want)


@pytest.mark.parametrize("mode", taug.PAD_MODES)
def test_freqshift_every_pad_mode_matches_jax(mode):
    """FreqShift with each ``jnp.pad`` mode: the port's ``apply`` on the
    JAX draws against the JAX aug on its key (p 0.9, both directions, a
    shift range of 5), bit for bit in the index modes, within 1e-6 in the
    arithmetic ones; ``empty`` pads zeros, as ``jnp.pad`` does on the
    CPU."""
    rng = np.random.default_rng(len(mode))
    x = rng.standard_normal(FEAT_SHAPE).astype(np.float32)
    kw = {"p": 0.9, "shift_range": 5, "mode": mode}
    ja, ta = jaug.FreqShift(**kw), taug.FreqShift(**kw)
    tol = 1e-6 if mode in ("mean", "linear_ramp", "median") else 0.0
    for seed in (3, 4):
        key = jax.random.PRNGKey(seed)
        xj, _ = ja(key, jnp.asarray(x), {})
        xt, _ = ta.apply(torch.from_numpy(x), {}, jax_draws("freqshift", ja, key, x.shape))
        assert _err(xt.numpy(), xj) <= tol, (mode, seed)
    if mode == "empty":
        np.testing.assert_array_equal(np.asarray(jnp.pad(x[..., :2], ((0, 0),) * 3 + ((1, 1),),
                                                         mode="empty"))[..., 0], 0.0)
    with pytest.raises(ValueError, match="jnp.pad takes"):
        taug.FreqShift(mode="nearest")
