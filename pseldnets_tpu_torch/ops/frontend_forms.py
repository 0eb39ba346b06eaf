"""The fused frontend's flat and DIF forms: kernels K9 and K10 and their
plain versions. The counterparts of the JAX package's
``ops/pallas/frontend.py::fused_logmel_iv`` flat path (``_kernel``) and its
radix-2 DIF variant (``_call_dif`` -> ``_kernel_dif``); ``fused_logmel_iv``
in ops/frontend.py routes to them (``frontend_route``).

Both compute the (B, 7, n_frames, n_mels) float32 features of
ops/features.py from a (B, 4, N) waveform: center=True reflect pad of
n_fft // 2 (zeros beyond it), n_frames = 1 + N // hop, periodic window,
power -> mel -> dB and the normalized FOA intensity vector -> mel.

- flat (K9, ``csrc/frontend_flat.cu``): the DFT as a GEMM of the frames,
  read from the waveform at stride hop, and the windowed (cos, -sin) table;
  any n_fft, any hop < n_fft. Where it stands in for the JAX package's DIT
  kernel it carries K1's folds (``post_affine``, ``out_dtype``, ``t_out``).
- DIF (K10, ``csrc/frontend_dif.cu``): the sum and difference streams
  y+-[n] = p[n] +- p[n + n_fft/2] of each frame through two half-size DFTs
  (even and odd bins), then the window as the exact 3-tap in frequency;
  even n_fft and hop, hann or hamming, no folds.

On a CUDA tensor the wrapper launches its kernel; on a CPU tensor it runs
the plain version, which follows the form's own arithmetic in float32 (the
DFT sums in the kernels' two levels, ``two_level_matmul``) and shares the
plain epilogue (``features.logmel_iv_from_spectrum``). The
kernels compute only the bins from the first to the last one with a
non-zero mel weight: the others add nothing to any output.
"""

from functools import lru_cache
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ._cuda import CudaKernel, check_cuda_tensor, f32, i32, ptr
from .features import logmel_iv_filterbank, logmel_iv_from_spectrum
from .windows import get_window

FLAT_KERNEL = CudaKernel("frontend_flat.cu", {
    "logmel_iv_flat": [ptr] * 6 + [i32] * 10 + [ptr],
})
DIF_KERNEL = CudaKernel("frontend_dif.cu", {
    "logmel_iv_dif": [ptr] * 5 + [i32] * 9 + [f32] * 2 + [ptr],
})

# window -> exact 3-tap frequency response of the periodic cosine window
# w[n] = a0 + 2 a1 cos(2 pi n / N): X_w[k] = a0 X[k] + a1 (X[k-1] + X[k+1])
WIN_3TAP = {"hann": (0.5, -0.25), "hamming": (0.54, -0.23)}

BK = 16          # the kernels' k step: tables pad n to a multiple of it
TILE_BINS = 64   # K9: bins per column tile
DIF_STEP = 31    # K10: sub-bins between column tiles (62 windowed bins)


def padded_signal(x: torch.Tensor, n_fft: int, hop: int) -> torch.Tensor:
    """(..., N) -> the center=True padded signal: a reflect pad of n_fft // 2
    on both sides, then zeros, to the length n_frames = 1 + N // hop frames
    of n_fft read (the JAX kernels' row slab; torch's own framing gives one
    frame fewer for an odd n_fft when hop divides N)."""
    pad = n_fft // 2
    N = x.shape[-1]
    if N <= pad:
        raise ValueError(f"reflect padding needs more than n_fft/2 samples, got {N}")
    lead = x.shape[:-1]
    xp = F.pad(x.reshape(-1, 1, N), (pad, pad), mode="reflect").reshape(lead + (-1,))
    need = (N // hop) * hop + n_fft
    return F.pad(xp, (0, max(0, need - xp.shape[-1])))


def apply_folds(feats: torch.Tensor, post_affine, out_dtype, t_out) -> torch.Tensor:
    """K1's epilogue folds on plain features (the plain versions of K1 and
    K9): affine, zero frames up to ``t_out``, cast."""
    if post_affine is not None:
        inv, shift = (torch.as_tensor(a, dtype=torch.float32, device=feats.device)
                      for a in post_affine)
        feats = feats * inv[None, :, None, :] + shift[None, :, None, :]
    if t_out is not None:
        feats = F.pad(feats, (0, 0, 0, t_out - feats.shape[2]))
    return feats.to(out_dtype)


def _mel_fb(sample_rate, n_fft, n_mels, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(logmel_iv_filterbank(sample_rate, n_fft, n_mels),
                           device=like.device).to(like.dtype)


def two_level_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b summed as the kernels sum: a partial product over each k step of
    BK, the partials added in order (csrc/frontend_common.cuh,
    "Accumulation"). Works in the operands' dtype."""
    out = None
    for k0 in range(0, a.shape[-1], BK):
        part = torch.matmul(a[..., k0:k0 + BK], b[k0:k0 + BK])
        out = part if out is None else out + part
    return out


def flat_spectrum(x: torch.Tensor, n_fft: int, hop: int, window: str = "hann"):
    """The windowed spectrum (B, 4, n_frames, n_fft // 2 + 1) as (re, im),
    in x's float dtype (float32 for a waveform of another): the framed
    signal @ the windowed (cos, -sin) DFT table."""
    dt = x.dtype if x.dtype == torch.float64 else torch.float32
    n_frames = 1 + x.shape[-1] // hop
    frames = padded_signal(x.to(dt), n_fft, hop).unfold(-1, n_fft, hop)[..., :n_frames, :]
    n_freqs = n_fft // 2 + 1
    tab = torch.as_tensor(_dft_table(n_fft, window), device=x.device).to(dt)
    spec = two_level_matmul(frames, tab)
    return spec[..., :n_freqs], spec[..., n_freqs:]


def dif_spectrum(x: torch.Tensor, n_fft: int, hop: int, window: str = "hann"):
    """The windowed spectrum (B, 4, n_frames, n_fft // 2 + 1) as (re, im),
    in x's float dtype as ``flat_spectrum``, the DIF way: the sum and difference streams of each frame -> an
    n_fft/2-point DFT of each (even bins, and the pre-twiddled odd bins) ->
    the unwindowed spectrum with X[-1] = conj(X[1]) and X[n_fft/2 + 1] =
    conj(X[n_fft/2 - 1]) -> the 3-tap window."""
    check_dif(n_fft, hop, window)
    hf = n_fft // 2
    dt = x.dtype if x.dtype == torch.float64 else torch.float32
    n_frames = 1 + x.shape[-1] // hop
    xp = padded_signal(x.to(dt), n_fft, hop)
    lo = xp.unfold(-1, hf, hop)[..., :n_frames, :]
    hi = xp[..., hf:].unfold(-1, hf, hop)[..., :n_frames, :]
    tabs = [torch.as_tensor(t, device=x.device).to(dt) for t in _dif_tables(n_fft)]
    even = two_level_matmul(lo + hi, tabs[0])  # (B, 4, T, 2 n_even): bins 0, 2, ..
    odd = two_level_matmul(lo - hi, tabs[1])   # bins 1, 3, ..
    n_even, n_odd = tabs[0].shape[1] // 2, tabs[1].shape[1] // 2
    shape = even.shape[:-1] + (hf + 1,)
    re, im = even.new_empty(shape), even.new_empty(shape)
    re[..., 0::2], im[..., 0::2] = even[..., :n_even], even[..., n_even:]
    re[..., 1::2], im[..., 1::2] = odd[..., :n_odd], odd[..., n_odd:]
    # neighbours k - 1 and k + 1 with the conjugate fix-ups at both ends
    re_l = torch.cat([re[..., 1:2], re[..., :-1]], -1)
    im_l = torch.cat([-im[..., 1:2], im[..., :-1]], -1)
    re_r = torch.cat([re[..., 1:], re[..., -2:-1]], -1)
    im_r = torch.cat([im[..., 1:], -im[..., -2:-1]], -1)
    a0, a1 = WIN_3TAP[window]
    return a0 * re + a1 * (re_l + re_r), a0 * im + a1 * (im_l + im_r)


def logmel_iv_flat_plain(x: torch.Tensor, *, n_fft: int, hop: int, window: str = "hann",
                         n_mels: int = 64, sample_rate: int = 24000, post_affine=None,
                         out_dtype: torch.dtype = torch.float32,
                         t_out: Optional[int] = None) -> torch.Tensor:
    """Plain version of K9 on any device: ``flat_spectrum``, the shared
    epilogue and K1's folds."""
    re, im = flat_spectrum(x, n_fft, hop, window)
    feats = logmel_iv_from_spectrum(re, im, _mel_fb(sample_rate, n_fft, n_mels, re))
    return apply_folds(feats, post_affine, out_dtype, t_out)


def logmel_iv_dif_plain(x: torch.Tensor, *, n_fft: int, hop: int, window: str = "hann",
                        n_mels: int = 64, sample_rate: int = 24000) -> torch.Tensor:
    """Plain version of K10 on any device: ``dif_spectrum`` and the shared
    epilogue."""
    re, im = dif_spectrum(x, n_fft, hop, window)
    return logmel_iv_from_spectrum(re, im, _mel_fb(sample_rate, n_fft, n_mels, re))


def logmel_iv_flat(x: torch.Tensor, *, n_fft: int, hop: int, window: str = "hann",
                   n_mels: int = 64, sample_rate: int = 24000, post_affine=None,
                   out_dtype: torch.dtype = torch.float32,
                   t_out: Optional[int] = None) -> torch.Tensor:
    """(B, 4, N) float32 -> (B, 7, t_out or n_frames, n_mels): kernel K9 on
    a CUDA tensor, the plain version on a CPU tensor."""
    n_frames = 1 + x.shape[-1] // hop
    t_out = n_frames if t_out is None else int(t_out)
    if t_out < n_frames:
        raise ValueError(f"t_out={t_out} < n_frames={n_frames}")
    if x.device.type == "cpu":
        return logmel_iv_flat_plain(x, n_fft=n_fft, hop=hop, window=window, n_mels=n_mels,
                                    sample_rate=sample_rate, post_affine=post_affine,
                                    out_dtype=out_dtype, t_out=t_out)
    B, _, N = x.shape
    check_cuda_tensor("x", x, torch.float32, (B, 4, N))
    check_launch(N, n_fft, hop, out_dtype)
    tab, band_m, band_w = _flat_kernel_tables(n_fft, window, n_mels, sample_rate, x.device)
    aff = affine_table(post_affine, n_mels, x.device)
    out = torch.empty((B, 7, t_out, n_mels), device=x.device, dtype=out_dtype)
    FLAT_KERNEL.launches += 1
    FLAT_KERNEL.call("logmel_iv_flat", x.data_ptr(), tab.data_ptr(), band_m.data_ptr(),
                     band_w.data_ptr(), aff.data_ptr() if aff is not None else None,
                     out.data_ptr(), B, N, n_fft, hop, tab.shape[1], tab.shape[0], n_mels,
                     n_frames, t_out, int(out_dtype == torch.bfloat16))
    return out


def logmel_iv_dif(x: torch.Tensor, *, n_fft: int, hop: int, window: str = "hann",
                  n_mels: int = 64, sample_rate: int = 24000) -> torch.Tensor:
    """(B, 4, N) float32 -> (B, 7, n_frames, n_mels) float32: kernel K10 on
    a CUDA tensor, the plain version on a CPU tensor."""
    if x.device.type == "cpu":
        return logmel_iv_dif_plain(x, n_fft=n_fft, hop=hop, window=window, n_mels=n_mels,
                                   sample_rate=sample_rate)
    B, _, N = x.shape
    check_cuda_tensor("x", x, torch.float32, (B, 4, N))
    check_dif(n_fft, hop, window)
    check_launch(N, n_fft, hop, torch.float32)
    tab, band_m, band_w, s0 = _dif_kernel_tables(n_fft, n_mels, sample_rate, x.device)
    n_frames = 1 + N // hop
    out = torch.empty((B, 7, n_frames, n_mels), device=x.device, dtype=torch.float32)
    a0, a1 = WIN_3TAP[window]
    DIF_KERNEL.launches += 1
    DIF_KERNEL.call("logmel_iv_dif", x.data_ptr(), tab.data_ptr(), band_m.data_ptr(),
                    band_w.data_ptr(), out.data_ptr(), B, N, n_fft, hop, tab.shape[1],
                    tab.shape[0], s0, n_mels, n_frames, a0, a1)
    return out


def check_dif(n_fft: int, hop: int, window: str) -> None:
    if n_fft % 2 or hop % 2 or window not in WIN_3TAP:
        raise ValueError(f"the DIF form takes an even n_fft and hop and a window in "
                         f"{sorted(WIN_3TAP)}, got ({n_fft}, {hop}, {window!r})")


def check_launch(N: int, n_fft: int, hop: int, out_dtype: torch.dtype) -> None:
    """Raise on what the frontend kernels (K1, K9, K10) do not take."""
    if not 0 < hop < n_fft:
        raise NotImplementedError(f"the frontend kernels need 0 < hop < n_fft (got hop={hop}, "
                                  f"n_fft={n_fft}): use ops.features.logmel_iv")
    if N <= n_fft // 2:
        raise ValueError(f"reflect padding needs more than n_fft/2 samples, got {N}")
    if out_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"out_dtype must be float32 or bfloat16, got {out_dtype}")


def affine_table(post_affine, n_mels: int, device) -> Optional[torch.Tensor]:
    """``post_affine`` as the kernels read it: (2, 7, n_mels) float32 on the
    card, or None."""
    if post_affine is None:
        return None
    aff = torch.stack([torch.as_tensor(a) for a in post_affine]).to(
        device=device, dtype=torch.float32).contiguous()
    check_cuda_tensor("post_affine", aff, torch.float32, (2, 7, n_mels))
    return aff


@lru_cache(maxsize=8)
def _dft_table(n_fft: int, window: str) -> np.ndarray:
    """(n_fft, 2 n_freqs) float32: the windowed cos | -sin over all bins."""
    k = np.arange(n_fft // 2 + 1)
    c, s = _trig(n_fft, np.arange(n_fft), k)
    win = get_window(window, n_fft)[:, None]
    return np.concatenate([win * c, -win * s], axis=1).astype(np.float32)


@lru_cache(maxsize=8)
def _dif_tables(n_fft: int) -> Tuple[np.ndarray, np.ndarray]:
    """The n_fft/2-point DFT tables (n_fft/2, 2 n) float32 as cos | -sin:
    of the sum stream for the even bins 0, 2, .. <= n_fft/2 and of the
    difference stream, pre-twiddled, for the odd bins 1, 3, .. <= n_fft/2."""
    hf = n_fft // 2
    n = np.arange(hf)
    out = []
    for bins in (np.arange(0, hf + 1, 2), np.arange(1, hf + 1, 2)):
        c, s = _trig(n_fft, n, bins)
        out.append(np.concatenate([c, -s], axis=1).astype(np.float32))
    return tuple(out)


def _trig(n_fft: int, n: np.ndarray, k: np.ndarray):
    """cos and sin of 2 pi n k / n_fft, (len(n), len(k)) float64, the angle
    reduced exactly (n k mod n_fft) before the float64 product."""
    ang = 2.0 * np.pi * (np.outer(n, k) % n_fft) / n_fft
    return np.cos(ang), np.sin(ang)


def weighted_bins(sample_rate: int, n_fft: int, n_mels: int) -> Tuple[int, int]:
    """The first and last bin with a non-zero mel weight."""
    nz = np.nonzero(logmel_iv_filterbank(sample_rate, n_fft, n_mels).any(axis=1))[0]
    return int(nz[0]), int(nz[-1])


def band_tables(fb: np.ndarray, bins: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """For each bin (-1 or past the last: none) the two bands it feeds and
    their weights, (len, 2) int32 and float32; a bin feeds at most two
    adjacent mel triangles, and a weight is 0 where it feeds fewer."""
    m = np.zeros((len(bins), 2), np.int32)
    w = np.zeros((len(bins), 2), np.float32)
    for i, k in enumerate(bins):
        if 0 <= k < fb.shape[0]:
            nz = np.nonzero(fb[k])[0]
            if nz.size > 2:
                raise ValueError(f"bin {k} feeds {nz.size} mel bands: the kernels take two")
            m[i, :nz.size] = nz
            w[i, :nz.size] = fb[k, nz]
    return m, w


def flat_tables(n_fft: int, window: str, n_mels: int, sample_rate: int):
    """K9's tables: (n_tiles, Kp, 128) float32, per tile of 64 bins from the
    first weighted one the windowed cos (even columns) and -sin (odd) over
    n < n_fft, zeros to Kp (n_fft rounded up to the k step); and the bands
    and weights of each tile's bins, (n_tiles, 64, 2) each."""
    fb = logmel_iv_filterbank(sample_rate, n_fft, n_mels)
    k_lo, k_hi = weighted_bins(sample_rate, n_fft, n_mels)
    n_tiles = -(-(k_hi - k_lo + 1) // TILE_BINS)
    Kp = -(-n_fft // BK) * BK
    bins = k_lo + np.arange(n_tiles * TILE_BINS)
    c, s = _trig(n_fft, np.arange(n_fft), bins)
    keep = bins <= n_fft // 2
    win = get_window(window, n_fft)[:, None]
    tab = np.zeros((Kp, n_tiles * TILE_BINS, 2))
    tab[:n_fft, :, 0] = win * c * keep
    tab[:n_fft, :, 1] = -win * s * keep
    tab = tab.reshape(Kp, n_tiles, 2 * TILE_BINS).transpose(1, 0, 2)
    m, w = band_tables(fb, bins)
    return (np.ascontiguousarray(tab, np.float32), m.reshape(n_tiles, TILE_BINS, 2),
            w.reshape(n_tiles, TILE_BINS, 2))


def dif_tables(n_fft: int, n_mels: int, sample_rate: int):
    """K10's tables and s0: tile t (s = s0 + 31 t) holds in columns 2i,
    2i + 1 the (cos, -sin) of bin 2s + 2i over the n_fft/2 samples of the
    sum stream, and in columns 64 + 2i, 65 + 2i those of bin 2s - 1 + 2i for
    the difference stream, zero for a bin outside 0 .. n_fft/2; (n_tiles,
    Kp, 128) float32; with the bands and weights of windowed local bin l
    (bin 2s - 1 + l, l = 1 .. 62; 0 and 63 feed none), (n_tiles, 64, 2)."""
    fb = logmel_iv_filterbank(sample_rate, n_fft, n_mels)
    hf = n_fft // 2
    k_lo, k_hi = weighted_bins(sample_rate, n_fft, n_mels)
    s0 = k_lo // 2
    n_tiles = -(-(k_hi - 2 * s0 + 1) // (2 * DIF_STEP))
    Kp = -(-hf // BK) * BK
    n = np.arange(hf)
    tab = np.zeros((n_tiles, Kp, 2 * TILE_BINS))
    m = np.zeros((n_tiles, TILE_BINS, 2), np.int32)
    w = np.zeros((n_tiles, TILE_BINS, 2), np.float32)
    i = np.arange(TILE_BINS // 2)
    for t in range(n_tiles):
        s = s0 + DIF_STEP * t
        for off, bins in ((0, 2 * s + 2 * i), (TILE_BINS, 2 * s - 1 + 2 * i)):
            c, sn = _trig(n_fft, n, bins)
            keep = (bins >= 0) & (bins <= hf)
            tab[t, :hf, off:off + TILE_BINS:2] = c * keep
            tab[t, :hf, off + 1:off + TILE_BINS:2] = -sn * keep
        local = 2 * s - 1 + np.arange(TILE_BINS)
        local[[0, -1]] = -1
        m[t], w[t] = band_tables(fb, local)
    return np.ascontiguousarray(tab, np.float32), m, w, s0


@lru_cache(maxsize=8)
def _flat_kernel_tables(n_fft: int, window: str, n_mels: int, sample_rate: int,
                        device: torch.device):
    return tuple(torch.as_tensor(a, device=device)
                 for a in flat_tables(n_fft, window, n_mels, sample_rate))


@lru_cache(maxsize=8)
def _dif_kernel_tables(n_fft: int, n_mels: int, sample_rate: int, device: torch.device):
    tab, m, w, s0 = dif_tables(n_fft, n_mels, sample_rate)
    return (*(torch.as_tensor(a, device=device) for a in (tab, m, w)), s0)
