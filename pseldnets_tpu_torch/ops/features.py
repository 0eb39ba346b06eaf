"""logmel + FOA intensity-vector frontend in PyTorch, the counterpart of the
JAX package's ops/features.py (LogmelIVExtractor path and make_extractor).

Behavioral parity target (reference src/utils/feature.py:20-56,93-117): STFT ->
power-mel (HTK scale, slaney norm, fmin=20, fmax=fs/2) -> 10*log10 dB
(amin=1e-10) concatenated with the L2-normalized FOA intensity vector
projected onto the mel basis; output (B, 4+3, T, n_mels).

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


def make_extractor(cfg, use_kernels: bool = True):
    """The on-device frontend for ``cfg.data.audio_feature`` (the JAX
    package's make_extractor, features.py:210-220): logmelIV ->
    LogmelIVExtractor; features other than logmel are read pre-extracted
    (None); the mono/mic logmel extractor is not ported yet (ROADMAP queue
    A, step 1)."""
    feat = cfg["data"]["audio_feature"]
    if feat == "logmelIV":
        return LogmelIVExtractor(cfg, use_kernels=use_kernels)
    if feat == "logmel":
        raise NotImplementedError("LogmelExtractor is not ported yet (ROADMAP queue A, step 1)")
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
