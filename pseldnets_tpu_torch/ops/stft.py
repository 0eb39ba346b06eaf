"""STFT in PyTorch, the counterpart of the JAX package's ops/stft.py.

Semantics match torchaudio.transforms.Spectrogram(power=None) as used by the
reference extractors (src/utils/feature.py:28-31): center=True, reflect padding,
onesided, no normalization, win_length = n_fft.

``stft_dft`` computes the windowed DFT as one strided convolution, so the
(..., n_frames, n_fft) frame tensor is never materialized; ``stft`` frames
the signal and takes ``torch.fft.rfft`` (the JAX package's FFT ``stft``,
stft.py:77, which its offline mic features use). Both return (real, imag)
with layout (..., n_frames, n_freqs): time-major.
"""

import numpy as np
import torch
import torch.nn.functional as F

from .windows import get_window


def _reflect_pad_last(x: torch.Tensor, pad: int) -> torch.Tensor:
    lead = x.shape[:-1]
    return F.pad(x.reshape(-1, 1, x.shape[-1]), (pad, pad),
                 mode="reflect").reshape(lead + (-1,))


def frame_signal(x: torch.Tensor, n_fft: int, hop: int,
                 center: bool = True) -> torch.Tensor:
    """(..., samples) -> (..., n_frames, n_fft) with torch-style centering
    (a strided view of the padded signal)."""
    if center:
        x = _reflect_pad_last(x, n_fft // 2)
    return x.unfold(-1, n_fft, hop)


def dft_matrices(n_fft: int, window: np.ndarray):
    """Real/imag DFT basis pre-multiplied by the analysis window.

    Returns (wcos, wsin) of shape (n_fft, n_freqs) such that for a frame f:
    real = f @ wcos, imag = f @ wsin (matching numpy's rfft sign convention).
    """
    n_freqs = n_fft // 2 + 1
    n = np.arange(n_fft)[:, None]
    k = np.arange(n_freqs)[None, :]
    ang = 2.0 * np.pi * n * k / n_fft
    wcos = (np.cos(ang) * window[:, None]).astype(np.float32)
    wsin = (-np.sin(ang) * window[:, None]).astype(np.float32)
    return wcos, wsin


def stft_dft(x: torch.Tensor, n_fft: int, hop: int, window: str = "hann",
             center: bool = True):
    """Windowed-DFT STFT as one strided float32 convolution.

    On a GPU, cuDNN runs float32 convolutions in TF32 unless
    ``torch.backends.cudnn.allow_tf32`` is False; a reference run sets it.
    """
    win = get_window(window, n_fft)
    wcos, wsin = dft_matrices(n_fft, win)  # (n_fft, n_freqs)
    n_freqs = n_fft // 2 + 1
    kernel = np.concatenate([wcos, wsin], axis=1).T[:, None, :]  # OIW
    kernel = torch.as_tensor(np.ascontiguousarray(kernel), device=x.device)

    lead = x.shape[:-1]
    if center:
        x = _reflect_pad_last(x, n_fft // 2)
    sig = x.reshape(-1, 1, x.shape[-1]).to(torch.float32)
    out = F.conv1d(sig, kernel, stride=hop)  # (N, 2*n_freqs, n_frames)
    out = out.transpose(1, 2).reshape(lead + (out.shape[2], 2 * n_freqs))
    return out[..., :n_freqs].to(x.dtype), out[..., n_freqs:].to(x.dtype)


def stft(x: torch.Tensor, n_fft: int, hop: int, window: str = "hann", center: bool = True):
    """FFT STFT: the windowed frames through ``torch.fft.rfft``, in x's
    dtype (the JAX package's ``stft``, stft.py:77-83)."""
    win = torch.as_tensor(get_window(window, n_fft), dtype=x.dtype, device=x.device)
    spec = torch.fft.rfft(frame_signal(x, n_fft, hop, center) * win, dim=-1)
    return spec.real.to(x.dtype), spec.imag.to(x.dtype)
