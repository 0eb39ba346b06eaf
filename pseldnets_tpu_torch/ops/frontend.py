"""Fused logmel + FOA intensity-vector frontend: kernel K1, its plain
version, and the routing among the frontend's forms. The counterpart of the
JAX package's ``ops/pallas/frontend.py::fused_logmel_iv``: K1 is its radix-2
DIT path; the flat and DIF forms (kernels K9 and K10) are in
ops/frontend_forms.py, and ``frontend_route`` chooses among the three as the
JAX function chooses among its kernels (frontend.py:467-504).

On a CUDA tensor the hand-written kernel of the route runs (K1:
``csrc/frontend.cu``); on a CPU tensor its plain PyTorch version (K1's:
ops/features.py plus the folds below). Folds, as in the Pallas kernel:
``post_affine=(inv, shift)`` (the eval ScalarBN per (channel, mel)),
``out_dtype`` and ``t_out`` - the output holds ``t_out`` frames and frames
from ``n_frames = 1 + N // hop`` on are 0 AFTER the affine (the JAX kernel's
``full_frames``, which pads to the HTSAT reshape_wav2img frame count).
"""

from functools import lru_cache
from typing import Optional, Tuple

import numpy as np
import torch

from ._cuda import CudaKernel, check_cuda_tensor, i32, ptr
from .features import logmel_iv, logmel_iv_filterbank
from .frontend_forms import (WIN_3TAP, affine_table, apply_folds, check_launch, logmel_iv_dif,
                             logmel_iv_flat)
from .windows import get_window

KERNEL = CudaKernel("frontend.cu", {
    "logmel_iv_frontend": [ptr] * 8 + [i32] * 10 + [ptr],
})

# the kernel's FFT length: 32 x 32, four-step (csrc/frontend.cu)
FFT_SIDE = 32


def frontend_route(n_fft: int, hop: int, window: str = "hann", radix2=None,
                   variant: str = "dit", folds: bool = False) -> str:
    """Which form computes the features: "k1", "flat" or "dif", or raise.

    The JAX package's selection (frontend.py:467-504): hop >= n_fft raises;
    with ``radix2`` not False and an even n_fft and hop, ``variant="dif"``
    with a hann or hamming window takes the DIF form and any other setting
    the radix-2 DIT form, which here is K1 at n_fft 1024 and the flat form
    (K9) at every other n_fft; the rest (radix2=False, an odd n_fft or hop)
    takes the flat form. ``folds`` (an affine, a non-float32 output or
    ``t_out``) raise off the DIT form, as there: K9 carries them only where
    it stands in for it."""
    if hop >= n_fft:
        raise NotImplementedError(
            f"fused_logmel_iv requires hop < n_fft (got hop={hop}, n_fft={n_fft}): "
            "use ops.features.logmel_iv")
    if (radix2 is None or radix2) and n_fft % 2 == 0 and hop % 2 == 0:
        if variant == "dif" and window in WIN_3TAP:
            if folds:
                raise NotImplementedError("post_affine/out_dtype/t_out: radix-2 DIT forms only")
            return "dif"
        return "k1" if n_fft == FFT_SIDE ** 2 else "flat"
    if folds:
        raise NotImplementedError("post_affine/out_dtype/t_out: radix-2 DIT forms only")
    return "flat"


def fused_logmel_iv(x: torch.Tensor, *, n_fft: int = 1024, hop: int = 240,
                    window: str = "hann", n_mels: int = 64,
                    sample_rate: int = 24000,
                    post_affine: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                    out_dtype: torch.dtype = torch.float32,
                    t_out: Optional[int] = None, radix2=None,
                    variant: str = "dit") -> torch.Tensor:
    """(B, 4, N) float32 -> (B, 7, t_out or n_frames, n_mels) of ``out_dtype``.

    ``radix2`` and ``variant`` choose the form as in the JAX package
    (``frontend_route``). A CPU tensor takes the form's plain version; a
    CUDA tensor launches its kernel (K1, K9 or K10) or raises."""
    folds = post_affine is not None or out_dtype != torch.float32 or t_out is not None
    route = frontend_route(n_fft, hop, window, radix2, variant, folds)
    kw = dict(n_fft=n_fft, hop=hop, window=window, n_mels=n_mels, sample_rate=sample_rate)
    if route == "dif":
        return logmel_iv_dif(x, **kw)
    if route == "flat":
        return logmel_iv_flat(x, post_affine=post_affine, out_dtype=out_dtype, t_out=t_out,
                              **kw)
    n_frames = 1 + x.shape[-1] // hop
    t_out = n_frames if t_out is None else int(t_out)
    if t_out < n_frames:
        raise ValueError(f"t_out={t_out} < n_frames={n_frames}")
    if x.device.type == "cpu":
        return fused_logmel_iv_plain(x, post_affine=post_affine, out_dtype=out_dtype,
                                     t_out=t_out, **kw)
    B, C, N = x.shape
    check_cuda_tensor("x", x, torch.float32, (B, 4, N))
    check_launch(N, n_fft, hop, out_dtype)
    win, tw, wts, bands, sched = _kernel_tables(n_fft, window, n_mels, sample_rate, x.device)
    aff = affine_table(post_affine, n_mels, x.device)
    out = torch.empty((B, 7, t_out, n_mels), device=x.device, dtype=out_dtype)
    KERNEL.launches += 1
    KERNEL.call("logmel_iv_frontend", x.data_ptr(), win.data_ptr(),
                tw.data_ptr(), wts.data_ptr(), bands.data_ptr(), sched.data_ptr(),
                aff.data_ptr() if aff is not None else None, out.data_ptr(),
                B, N, n_fft, hop, n_mels, n_frames, t_out,
                int(out_dtype == torch.bfloat16), wts.numel(), sched.shape[0])
    return out


def fused_logmel_iv_plain(x: torch.Tensor, *, n_fft: int = 1024, hop: int = 240,
                          window: str = "hann", n_mels: int = 64,
                          sample_rate: int = 24000, post_affine=None,
                          out_dtype: torch.dtype = torch.float32,
                          t_out: Optional[int] = None) -> torch.Tensor:
    """Plain PyTorch version of kernel K1, on any device: features -> affine
    -> zero frames up to ``t_out`` -> cast."""
    mel_fb = torch.as_tensor(logmel_iv_filterbank(sample_rate, n_fft, n_mels),
                             device=x.device)
    feats = logmel_iv(x.float(), n_fft=n_fft, hop=hop, window=window, mel_fb=mel_fb)
    return apply_folds(feats, post_affine, out_dtype, t_out)


def fft_tables(n_fft: int, window: str):
    """The analysis window (n_fft,) and the four-step twiddles (n_fft, 2)
    float32 (re, im) of W_{n_fft}^(k1 n2) at row 32 k1 + n2, k1, n2 < 32: the
    factor between the kernel's two 32-point FFTs."""
    if n_fft != FFT_SIDE ** 2:
        raise ValueError(f"the four-step FFT takes n_fft={FFT_SIDE ** 2}, got {n_fft}")
    k1, n2 = np.meshgrid(np.arange(FFT_SIDE), np.arange(FFT_SIDE), indexing="ij")
    w = np.exp(-2j * np.pi * (k1 * n2).reshape(-1) / n_fft)
    tw = np.stack([w.real, w.imag], axis=1).astype(np.float32)
    return np.asarray(get_window(window, n_fft), np.float32), tw


def mel_bands(fb: np.ndarray) -> np.ndarray:
    """(n_mels, 3) int32: first and last bin with a non-zero weight in each
    mel band (an empty band gets (1, 0)) and the offset of its first weight in
    ``packed_mel_weights``."""
    bands = np.zeros((fb.shape[1], 3), np.int32)
    off = 0
    for mi in range(fb.shape[1]):
        nz = np.nonzero(fb[:, mi])[0]
        lo, hi = (nz[0], nz[-1]) if nz.size else (1, 0)
        bands[mi] = (lo, hi, off)
        off += hi - lo + 1
    return bands


def packed_mel_weights(fb: np.ndarray, bands: np.ndarray) -> np.ndarray:
    """Each band's weights over its bin range, bands one after the other."""
    parts = [fb[lo:hi + 1, mi] for mi, (lo, hi, _) in enumerate(bands)]
    return np.concatenate(parts).astype(np.float32)


def mel_schedule(bands: np.ndarray, lanes: int = 32) -> np.ndarray:
    """(n_slots, lanes) int32 order of the 7 * n_mels mel outputs of a frame,
    widest band first, -1 past the end: the lanes of one slot sum bands of
    about the same width, so few of them idle."""
    width = np.tile(bands[:, 1] - bands[:, 0] + 1, 7)
    order = np.argsort(-width, kind="stable").astype(np.int32)
    slots = -(-order.size // lanes)
    return np.concatenate([order, np.full(slots * lanes - order.size, -1, np.int32)]
                          ).reshape(slots, lanes)


@lru_cache(maxsize=8)
def _kernel_tables(n_fft: int, window: str, n_mels: int, sample_rate: int,
                   device: torch.device):
    fb = logmel_iv_filterbank(sample_rate, n_fft, n_mels)
    bands = mel_bands(fb)
    return tuple(torch.as_tensor(a, device=device) for a in (
        *fft_tables(n_fft, window), packed_mel_weights(fb, bands), bands,
        mel_schedule(bands)))
