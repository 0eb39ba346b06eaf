"""The audio feature extractors in PyTorch, the counterpart of the JAX
package's ops/features.py.

Behavioral parity targets (reference src/utils/feature.py):
* ``LogmelIVExtractor``: STFT -> power-mel (HTK scale, slaney norm, fmin=20,
  fmax=fs/2) -> 10*log10 dB (amin=1e-10) concatenated with the
  L2-normalized FOA intensity vector projected onto the mel basis; output
  (B, 4+3, T, n_mels) (feature.py:20-56,93-117);
* ``LogmelExtractor``: the same log-mel without the IV, any channel count
  (feature.py:59-91);
* ``gcc_phat``: the PHAT-weighted cross-correlation of every channel pair,
  its centre lags (feature.py:164-175);
* ``salsa_lite``: the per-channel log power spectra and the normalized
  inter-channel phase within [lower_bin, cutoff_bin) (feature.py:177-192).

The last three run eagerly on any device (the JAX package has no Pallas
kernel for them); the offline mic preprocessing (preproc/preprocess.py)
takes the two pair features.

This is the plain version of the fused frontend kernel K1 (ops/frontend.py),
its epilogue (``logmel_iv_from_spectrum``) that of the flat and DIF forms
(ops/frontend_forms.py), and the only path when hop >= n_fft.
``LogmelIVExtractor`` sends a CUDA tensor to the kernels (in their unfolded
float32 form, as the JAX extractor calls its Pallas kernel,
features.py:105-115).
"""

import numpy as np
import torch

from .mel import mel_filterbank
from .stft import stft_dft

EPS_F32 = float(np.finfo(np.float32).eps)
AMIN_DB = 1e-10


def power_to_db(power: torch.Tensor) -> torch.Tensor:
    """10*log10(max(x, 1e-10)) (top_db=None, as the reference uses it)."""
    return 10.0 * torch.log10(torch.clamp(power, min=AMIN_DB))


def logmel_iv_filterbank(sample_rate: int, n_fft: int, n_mels: int) -> np.ndarray:
    """(n_freqs, n_mels) float32 filterbank the logmel-IV frontend projects onto."""
    return mel_filterbank(sample_rate, n_fft, n_mels, fmin=20.0,
                          fmax=sample_rate / 2.0, scale="htk",
                          norm="slaney").astype(np.float32)


def _mel_project(x: torch.Tensor, mel_fb: torch.Tensor) -> torch.Tensor:
    """(..., F) @ (F, M) mel projection in float32."""
    return torch.matmul(x, mel_fb)


def intensity_vector(real: torch.Tensor, imag: torch.Tensor,
                     mel_fb: torch.Tensor) -> torch.Tensor:
    """FOA intensity vector, mel-projected.

    real/imag: (B, 4, T, F) with channel order (W, X, Y, Z); mel_fb: (F, n_mels).
    Returns (B, 3, T, n_mels): IV_d = Re(conj(W)*P_d), L2-normalized across
    (x, y, z) per TF bin with +eps, then projected through the mel filterbank.
    """
    w_re, w_im = real[:, 0], imag[:, 0]
    iv = real[:, 1:4] * w_re[:, None] + imag[:, 1:4] * w_im[:, None]
    normal = torch.sqrt(torch.sum(iv * iv, dim=1, keepdim=True)) + EPS_F32
    return _mel_project(iv / normal, mel_fb).to(real.dtype)


class LogmelIVExtractor:
    """logmel(4ch) + intensity-vector(3ch) frontend for FOA input.

    A CUDA tensor goes to ``fused_logmel_iv`` (no affine, float32, no zero
    tail), which routes it as the JAX package's does (ops/frontend.py
    ``frontend_route``): kernel K1 at n_fft 1024 with an even hop, K9 (the
    flat form) at every other shape; unless ``use_kernels`` is False. A CPU
    tensor, and the shapes the JAX package itself keeps off its kernels
    (hop >= n_fft, frontend.py:478), take the eager form.
    """

    in_channels = 7

    def __init__(self, cfg, use_kernels: bool = True):
        self.use_kernels = use_kernels
        data = cfg["data"]
        self.n_fft = int(data["nfft"])
        self.hop = int(data["hoplen"])
        self.window = str(data["window"])
        self.sr = int(data["sample_rate"])
        self.n_mels = int(data["n_mels"])
        self.mel_fb = torch.as_tensor(
            logmel_iv_filterbank(self.sr, self.n_fft, self.n_mels))

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        """(B, 4, samples) -> (B, 7, n_frames, n_mels) float32."""
        if x.device.type != "cpu" and self.use_kernels and self.hop < self.n_fft:
            from .frontend import fused_logmel_iv

            return fused_logmel_iv(x, n_fft=self.n_fft, hop=self.hop, window=self.window,
                                   n_mels=self.n_mels, sample_rate=self.sr)
        return logmel_iv(x, n_fft=self.n_fft, hop=self.hop, window=self.window,
                         mel_fb=self.mel_fb.to(x.device))


class LogmelExtractor:
    """logmel frontend for any channel count (mono or mic; the JAX
    package's features.py:123-146): the windowed-DFT STFT, power -> mel
    (HTK scale, slaney norm, fmin 20, fmax fs / 2) -> 10 log10 dB, eagerly
    on the input's device."""

    def __init__(self, cfg):
        data = cfg["data"]
        self.n_fft = int(data["nfft"])
        self.hop = int(data["hoplen"])
        self.window = str(data["window"])
        self.sr = int(data["sample_rate"])
        self.n_mels = int(data["n_mels"])
        self.mel_fb = torch.as_tensor(logmel_iv_filterbank(self.sr, self.n_fft, self.n_mels))

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        """(B, C, samples) -> (B, C, n_frames, n_mels) float32."""
        if x.ndim != 3:
            raise ValueError(f"expected (batch, channels, samples), got {tuple(x.shape)}")
        real, imag = stft_dft(x, self.n_fft, self.hop, self.window)
        return power_to_db(_mel_project(real * real + imag * imag, self.mel_fb.to(x.device)))


def gcc_phat(real: torch.Tensor, imag: torch.Tensor, n_lags: int) -> torch.Tensor:
    """GCC-PHAT of every channel pair (m, n), m < n, in that order, of
    onesided spectra (B, C, T, F): -> (B, C (C - 1) / 2, T, n_lags), the
    centre lags as [last n_lags / 2 | first n_lags / 2] (the JAX package's
    features.py:149-169). The phase is exp(i angle(R)), as the reference's
    (feature.py:171): a zero cross-spectrum bin maps to 1, not to 0 / 0."""
    C = real.shape[1]
    spec = torch.complex(real.float(), imag.float())
    outs = []
    for m in range(C):
        for n in range(m + 1, C):
            angle = torch.angle(torch.conj(spec[:, m]) * spec[:, n])
            cc = torch.fft.irfft(torch.polar(torch.ones_like(angle), angle), dim=-1)
            outs.append(torch.cat([cc[..., -n_lags // 2:], cc[..., :n_lags // 2]], dim=-1))
    return torch.stack(outs, dim=1).to(real.dtype)


def salsa_lite_bins(sr: int, n_fft: int, fmin_doa: float, fmax_doa: float,
                    fmax_spectra: float):
    """(lower_bin, upper_bin, cutoff_bin) of SALSA-lite (features.py:172-177)."""
    lower_bin = max(int(np.floor(fmin_doa * n_fft / float(sr))), 1)
    upper_bin = int(np.floor(min(fmax_doa, sr // 2) * n_fft / float(sr)))
    cutoff_bin = int(np.floor(fmax_spectra * n_fft / float(sr)))
    if upper_bin > cutoff_bin:
        raise ValueError(f"fmax_doa's bin {upper_bin} is above fmax_spectra's {cutoff_bin}")
    return lower_bin, upper_bin, cutoff_bin


def salsa_lite(real: torch.Tensor, imag: torch.Tensor, sr: int, n_fft: int,
               fmin_doa: float, fmax_doa: float, fmax_spectra: float) -> torch.Tensor:
    """SALSA-lite of spectra (B, C, T, F): -> (B, 2C - 1, T, cutoff - lower),
    the per-channel log power spectra (floored at ``AMIN_DB``), then the
    phase of each channel against the first, divided by its bin's
    2 pi f / c (features.py:172-207). As in the reference (feature.py:
    182-183), the phase is zeroed from index ``upper_bin`` of the SLICED
    range on, i.e. from absolute bin lower_bin + upper_bin."""
    lower_bin, upper_bin, cutoff_bin = salsa_lite_bins(sr, n_fft, fmin_doa, fmax_doa,
                                                       fmax_spectra)
    delta = 2.0 * np.pi * sr / (n_fft * 343.0)
    freq_idx = np.arange(n_fft // 2 + 1, dtype=np.float32)
    freq_idx[0] = 1.0
    spec = torch.complex(real.float(), imag.float())
    phase = torch.angle(spec[:, 1:] * torch.conj(spec[:, :1]))
    phase = phase / (delta * torch.as_tensor(freq_idx, device=real.device))
    keep = (np.arange(cutoff_bin - lower_bin) < upper_bin).astype(np.float32)
    phase = phase[..., lower_bin:cutoff_bin] * torch.as_tensor(keep, device=real.device)
    logspec = 10.0 * torch.log10(torch.clamp(real * real + imag * imag, min=AMIN_DB))
    return torch.cat([logspec[..., lower_bin:cutoff_bin], phase.to(real.dtype)], dim=1)


def make_extractor(cfg, use_kernels: bool = True):
    """The on-device frontend for ``cfg.data.audio_feature`` (the JAX
    package's make_extractor, features.py:210-220): logmelIV ->
    LogmelIVExtractor, logmel -> LogmelExtractor; the other features
    (salsalite, logmelgcc) are read pre-extracted from the offline
    preprocessing (None)."""
    feat = cfg["data"]["audio_feature"]
    if feat == "logmelIV":
        return LogmelIVExtractor(cfg, use_kernels=use_kernels)
    if feat == "logmel":
        return LogmelExtractor(cfg)
    return None


def logmel_iv(x: torch.Tensor, *, n_fft: int, hop: int, window: str,
              mel_fb: torch.Tensor) -> torch.Tensor:
    """(B, 4, samples) float32 -> (B, 7, n_frames, n_mels) float32."""
    if x.ndim != 3 or x.shape[1] != 4:
        raise ValueError(f"expected (batch, 4, samples), got {tuple(x.shape)}")
    real, imag = stft_dft(x, n_fft, hop, window)  # (B, 4, T, F)
    return logmel_iv_from_spectrum(real, imag, mel_fb)


def logmel_iv_from_spectrum(real: torch.Tensor, imag: torch.Tensor,
                            mel_fb: torch.Tensor) -> torch.Tensor:
    """The windowed spectrum (B, 4, T, F) as (real, imag) -> (B, 7, T,
    n_mels): power -> mel -> dB, and the normalized intensity vector -> mel.
    The epilogue every plain frontend form shares."""
    power = real * real + imag * imag
    logmel = power_to_db(_mel_project(power, mel_fb))
    iv = intensity_vector(real, imag, mel_fb)
    return torch.cat([logmel, iv], dim=1)
