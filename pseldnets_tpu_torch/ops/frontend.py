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
    "logmel_iv_frontend": [ptr] * 8 + [i32] * 11 + [ptr],
})

# the kernel's FFT length: 32 x 32, four-step (csrc/frontend.cu)
FFT_SIDE = 32
GROUP = 4  # mel bands per gather group: 7 value rows x 4 bands = 28 lanes
# frames (one warp each) per block and the gathers' bank-aligned windows, chosen
# by scripts/torch_k1_tiles.py
TILES = {"warps": 4, "aligned_windows": True}


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
    win, tw, gwts, gstart, ginfo = _kernel_tables(n_fft, window, n_mels, sample_rate, x.device,
                                                  TILES["aligned_windows"])
    aff = affine_table(post_affine, n_mels, x.device)
    out = torch.empty((B, 7, t_out, n_mels), device=x.device, dtype=out_dtype)
    KERNEL.launches += 1
    KERNEL.call("logmel_iv_frontend", x.data_ptr(), win.data_ptr(),
                tw.data_ptr(), gwts.data_ptr(), gstart.data_ptr(), ginfo.data_ptr(),
                aff.data_ptr() if aff is not None else None, out.data_ptr(),
                B, N, n_fft, hop, n_mels, n_frames, t_out,
                int(out_dtype == torch.bfloat16), gwts.numel(), ginfo.shape[0], TILES["warps"])
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
    """(n_mels, 2) int32: first and last bin with a non-zero weight in each
    mel band (an empty band gets (1, 0))."""
    bands = np.zeros((fb.shape[1], 2), np.int32)
    for mi in range(fb.shape[1]):
        nz = np.nonzero(fb[:, mi])[0]
        bands[mi] = (nz[0], nz[-1]) if nz.size else (1, 0)
    return bands


def mel_groups(fb: np.ndarray, group: int = GROUP, align: bool = True):
    """K1's mel gather tables: bands in groups of ``group`` (lanes (m', q)
    of a warp sum band group * g + m' of value row q). Each group has one
    even width W; each band a window of W bins from ``start`` over which the
    kernel sums the filterbank's own column, zeros outside the band
    included. A window starts at a bin = m' mod 4 where one fits (value rows
    are 4 banks apart, so the group's 28 lanes read 28 banks), W covers the
    group's widest window and is no multiple of 32 (the weight rows' banks),
    and a window that would pass bin n_fft / 2 is moved down. Returns gstart
    (n_groups * group,) int32, ginfo (n_groups, 2) int32 (offset of the
    group's weights, W) and gwts float32, group after group, each (group, W)
    row-major; bands past n_mels have zero weights. ``align=False``: every
    window from its band's first bin (TILES["aligned_windows"])."""
    n_bins, n_mels = fb.shape
    bands = mel_bands(fb)
    n_groups = -(-n_mels // group)
    gstart = np.zeros(n_groups * group, np.int32)
    ginfo = np.zeros((n_groups, 2), np.int32)
    parts, off = [], 0
    for g in range(n_groups):
        ms = [m for m in range(g * group, (g + 1) * group)
              if m < n_mels and bands[m, 1] >= bands[m, 0]]
        start = {m: int(bands[m, 0]) - (int(bands[m, 0]) - m % group) % 4 * align for m in ms}
        start = {m: st if st >= 0 else int(bands[m, 0]) for m, st in start.items()}
        width = max([int(bands[m, 1]) - start[m] + 1 for m in ms] + [2])
        width += width % 2
        width += 2 if width % 32 == 0 and align else 0
        width = min(width, n_bins - n_bins % 2)
        w = np.zeros((group, width), np.float32)
        for m in ms:
            st = min(start[m], n_bins - width)
            gstart[m] = st
            w[m - g * group] = fb[st:st + width, m]
        ginfo[g] = (off, width)
        parts.append(w.reshape(-1))
        off += group * width
    return gstart, ginfo, np.concatenate(parts)


def launch_plan(B: int, N: int, hop: int, t_out: int, n_mels: int = 64,
                warps: Optional[int] = None, n_w: int = 0) -> dict:
    """K1's launch as csrc/frontend.cu makes it: one warp per frame,
    ``warps`` frames per block (TILES), blocks (ceil(t_out / warps), B);
    warp w of block (bx, b) takes frame bx * warps + w of clip b (none past
    t_out; the zero tail from n_frames on). The block stages its real
    frames' span of the padded signal, ``span`` samples a channel from
    ``first`` (frame f0's first sample), signal 0's two channels over its
    warps' A regions and signal 1's over their B regions. Shared memory in
    bytes: the block's mel tables (``n_w`` weights of ``mel_groups``, 4
    starts and an (offset, width) pair per group), then the A regions (a
    transpose; then the W/X stash, value rows 4-6 and the staged outputs)
    and the B regions (a transpose; then value rows 0-3)."""
    warps = TILES["warps"] if warps is None else warps
    n_groups = -(-n_mels // GROUP)
    n_frames = 1 + N // hop
    a16 = lambda n: -(-n // 16) * 16  # noqa: E731
    vld = FFT_SIDE ** 2 // 2 + 4
    region = a16(max(FFT_SIDE * (FFT_SIDE + 1) * 8, (16 + 3 * vld + 7 * n_mels) * 4))
    tables = a16(4 * n_w) + a16(4 * (GROUP + 2) * n_groups)
    blocks = []
    for bx in range(-(-t_out // warps)):
        f0 = bx * warps
        nf = max(0, min(warps, n_frames - f0))
        blocks.append({"frames": [f for f in range(f0, f0 + warps) if f < t_out],
                       "first": f0 * hop, "span": (nf - 1) * hop + FFT_SIDE ** 2 if nf else 0})
    return {"grid": (len(blocks), B), "threads": 32 * warps, "n_frames": n_frames,
            "blocks": blocks, "region": region, "tables": tables,
            "stash": (FFT_SIDE // 2 * FFT_SIDE + 1) * 16, "value_rows": 4 * vld * 4,
            "outputs": (16 + 3 * vld + 7 * n_mels) * 4,
            "smem": tables + 2 * warps * region}


def span_samples(first: int, count: int, N: int, n_fft: int = FFT_SIDE ** 2) -> np.ndarray:
    """The waveform index of padded-signal samples first .. first + count
    as K1 stages them (``padded_sample``): a reflect pad of n_fft / 2 by
    index arithmetic, -1 (a zero) past N + n_fft."""
    i = first + np.arange(count)
    j = np.abs(i - n_fft // 2)
    j = np.where(j >= N, 2 * (N - 1) - j, j)
    return np.where(i >= N + n_fft, -1, j)


def store_columns(n_mels: int, lanes: int = 32):
    """The columns of a staged output row each lane copies out in K1: a pair
    (2 l + 64 t, + 1) where n_mels is even, one (l + 32 t) where odd."""
    if n_mels % 2 == 0:
        return [[m + e for m in range(2 * lane, n_mels, 2 * lanes) for e in (0, 1)]
                for lane in range(lanes)]
    return [list(range(lane, n_mels, lanes)) for lane in range(lanes)]


@lru_cache(maxsize=8)
def _kernel_tables(n_fft: int, window: str, n_mels: int, sample_rate: int,
                   device: torch.device, aligned: bool = True):
    fb = logmel_iv_filterbank(sample_rate, n_fft, n_mels)
    gstart, ginfo, gwts = mel_groups(fb, align=aligned)
    return tuple(torch.as_tensor(a, device=device) for a in (
        *fft_tables(n_fft, window), gwts, gstart, ginfo))
