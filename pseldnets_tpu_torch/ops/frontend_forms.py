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
  (even and odd bins), then the window as the exact 3-tap in frequency, as
  the JAX kernel does; even n_fft and hop, hann or hamming, no folds. Over
  64 mels each frame's two halves are multiplied by their halves of the
  window before the streams instead (``dif_spectrum(in_time=True)``): in
  float32 the 3-tap cancels the unwindowed leakage of a frame that ends in
  a sharp onset and leaves a one-bin band (there are many over 64 mels) up
  to 2e-3 dB from the float64 DFT, where the windowed samples leave the
  flat form's error.

On a CUDA tensor the wrapper launches its kernel; on a CPU tensor it runs
the plain version, which follows the kernels' arithmetic in float32: the DFT
in split TF32 (``tf32_split`` of the frames or streams and of the float64
tables, three products a k step of 8 in the kernels' k order, summed from
zero over each k-block of 32 and then into a running sum, ``split3_matmul``)
and the shared plain epilogue (``features.logmel_iv_from_spectrum``). The
kernels compute only the bins from the first to the last one with a
non-zero mel weight (the others add nothing to any output) and take the mel
sums on the tensor cores too (``flat_tables``, ``dif_tables``), a column
tile's mels in groups of 64 from its first touched one (``mel_plan``; one
group a tile, mels from 0, at n_mels <= 64); ``launch_plan`` mirrors what
they take and refuse. Over 64 mels the plain versions take the mel sums as
the kernels do (``tile_mel_features``: each tile's seven values a local bin
through a split-TF32 product with each of its groups' tables, the tiles'
sums added in tile order); at 64 mels and fewer their mel projection is
one float32 product over all bins.
"""

from functools import lru_cache
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ._cuda import CudaKernel, check_cuda_tensor, f32, i32, ptr
from .features import (EPS_F32, logmel_iv_filterbank, logmel_iv_from_spectrum,
                       power_to_db)
from .windows import get_window

FLAT_KERNEL = CudaKernel("frontend_flat.cu", {
    "logmel_iv_flat": [ptr] * 7 + [i32] * 11 + [ptr],
})
DIF_KERNEL = CudaKernel("frontend_dif.cu", {
    "logmel_iv_dif": [ptr] * 7 + [i32] * 10 + [f32] * 2 + [ptr],
})

# window -> exact 3-tap frequency response of the periodic cosine window
# w[n] = a0 + 2 a1 cos(2 pi n / N): X_w[k] = a0 X[k] + a1 (X[k-1] + X[k+1])
WIN_3TAP = {"hann": (0.5, -0.25), "hamming": (0.54, -0.23)}

# the kernels' geometry (csrc/frontend_common.cuh)
BK = 32          # k-block: tables pad k to a multiple of it
KSTEP = 8        # wgmma's k step: the plain versions sum a step at a time
CHUNK = 32       # k summed in the tensor cores' accumulator (a k-block) before the running sum
TILE_BINS = 64   # local bins per column tile (128 columns)
COLS = 2 * TILE_BINS
MELS = 64        # the mel GEMM's columns: a group of mels (one a tile at n_mels <= 64)
MEL_ALIGN = 8    # a wide tile's first mel, rounded down: each mel keeps its owner thread
DIF_STEP = 31    # K10: sub-bins between column tiles (62 windowed bins)
FR = 32          # frames per block (two consumer warpgroups of 16)
THREADS = 384    # two consumer warpgroups and the producer's
STAGES = 3       # ring depth
CLUSTER = 1      # CTAs sharing each table tile by TMA multicast
STAGE_BYTES = 2 * COLS * BK * 4     # a k-block's hi and lo tiles, or a tile's mel tables
ACC_BYTES = FR * 8 * MELS * 4       # the block's mel sums (n_mels <= 64; wider: device memory)
A_SLOTS = {"flat": 4, "dif": 8}     # 16-byte waveform slots a consumer thread and k-block
SMEM_LIMIT = 232448                 # 227 KB a block


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


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """float32 x rounded to tf32 (10 explicit mantissa bits), to nearest with
    ties away from zero: what ``cvt.rna.tf32.f32`` gives, as float32."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def tf32_split(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The split-TF32 operand of float32 x: hi = tf32(x), lo = tf32(x - hi),
    as the kernels split the waveform rows on the device."""
    hi = tf32_round(x)
    return hi, tf32_round(x - hi)


def tf32_split_np(x: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """The split of float64 (or float32) x on the host, as float32 arrays:
    x rounded once to the 22 significant bits a split pair holds (to
    nearest, ties away), then cut exactly into hi (its first 11 bits, a
    tf32) and lo (the other 11): hi + lo is that rounding, within 2^-22 of
    |x|."""
    m, e = np.frexp(np.asarray(x, np.float64))
    q = np.sign(m) * np.floor(np.abs(m) * 2.0 ** 22 + 0.5)  # 22-bit integer significand
    hi_q = np.sign(q) * np.floor(np.abs(q) / 2.0 ** 11 + 0.5) * 2.0 ** 11
    return (np.ldexp(hi_q / 2.0 ** 22, e).astype(np.float32),
            np.ldexp((q - hi_q) / 2.0 ** 22, e).astype(np.float32))


def k_order(Kp: int) -> np.ndarray:
    """The kernels' k order: inside each k-block of 32, position 8 kk + c of
    k step kk holds sample 16 (kk // 2) + 4 (c % 4) + 2 (kk % 2) + c // 4, so
    that the thread holding A columns c and c + 4 of steps 2 j and 2 j + 1
    loads them as one 16-byte vector of four adjacent samples."""
    kk, c = np.divmod(np.arange(Kp), KSTEP)
    return BK * (kk // 4) + 16 * (kk % 4 // 2) + 4 * (c % 4) + 2 * (kk % 2) + c // 4


def local_order() -> np.ndarray:
    """The mel GEMM's k order: position 8 kk + c holds local bin 16 (c % 4)
    + 2 kk + c // 4 of the tile (thread c % 4 holds locals 16 (c % 4) ..
    + 15)."""
    kk, c = np.divmod(np.arange(TILE_BINS), KSTEP)
    return 16 * (c % 4) + 2 * kk + c // 4


def split3_matmul(a: torch.Tensor, b_hi: torch.Tensor, b_lo: torch.Tensor,
                  chunk: int = CHUNK) -> torch.Tensor:
    """a @ (b_hi + b_lo) as the kernels compute it: a split with
    ``tf32_split``; in each chunk of ``chunk`` k from zero (the DFT's CHUNK,
    the mel GEMM's 64 locals), for each k step of 8
    in order a_lo b_hi, a_hi b_lo and a_hi b_hi added to the chunk's sum (the
    small products first); the chunks' sums added in order (two levels, as
    the former float32 kernels summed). a (..., K) float32 with K a multiple
    of 8, b_hi and b_lo (K, cols) float32."""
    a_hi, a_lo = tf32_split(a)
    out = None
    for c0 in range(0, a.shape[-1], chunk):
        part = None
        for k0 in range(c0, min(c0 + chunk, a.shape[-1]), KSTEP):
            k = slice(k0, k0 + KSTEP)
            step = torch.matmul(a_lo[..., k], b_hi[k])
            part = step if part is None else part + step
            part = part + torch.matmul(a_hi[..., k], b_lo[k])
            part = part + torch.matmul(a_hi[..., k], b_hi[k])
        out = part if out is None else out + part
    return out


def _pad_k(a: torch.Tensor, K: int) -> torch.Tensor:
    """The last axis zero-padded to the kernels' Kp and put in their k order."""
    Kp = -(-K // BK) * BK
    return F.pad(a, (0, Kp - K))[..., torch.as_tensor(k_order(Kp), device=a.device)]


def flat_spectrum(x: torch.Tensor, n_fft: int, hop: int, window: str = "hann"):
    """The windowed spectrum (B, 4, n_frames, n_fft // 2 + 1) as (re, im):
    the framed signal @ the windowed (cos, -sin) DFT table. For a float64
    waveform in float64; otherwise in float32 as the kernels compute it
    (``split3_matmul`` on the frames and the table's float64 split)."""
    n_frames = 1 + x.shape[-1] // hop
    n_freqs = n_fft // 2 + 1
    if x.dtype == torch.float64:
        frames = padded_signal(x, n_fft, hop).unfold(-1, n_fft, hop)[..., :n_frames, :]
        spec = frames @ torch.as_tensor(_dft_table(n_fft, window), device=x.device)
    else:
        frames = padded_signal(x.float(), n_fft, hop).unfold(-1, n_fft, hop)[..., :n_frames, :]
        hi, lo = (torch.as_tensor(t, device=x.device) for t in _split_table(n_fft, window))
        spec = split3_matmul(_pad_k(frames, n_fft), hi, lo)
    return spec[..., :n_freqs], spec[..., n_freqs:]


def dif_spectrum(x: torch.Tensor, n_fft: int, hop: int, window: str = "hann",
                 in_time: bool = False):
    """The windowed spectrum (B, 4, n_frames, n_fft // 2 + 1) as (re, im),
    in float64 or float32 as ``flat_spectrum``, the DIF way: the sum and
    difference streams of each frame (formed in the working dtype) -> an
    n_fft/2-point DFT of each (even bins, and the pre-twiddled odd bins) ->
    the unwindowed spectrum with X[-1] = conj(X[1]) and X[n_fft/2 + 1] =
    conj(X[n_fft/2 - 1]) -> the 3-tap window. ``in_time``: each frame's two
    halves times their halves of the window (``dif_window``, rounded before
    the sum and difference) and no 3-tap, K10's form over 64 mels."""
    check_dif(n_fft, hop, window)
    hf = n_fft // 2
    dt = x.dtype if x.dtype == torch.float64 else torch.float32
    n_frames = 1 + x.shape[-1] // hop
    xp = padded_signal(x.to(dt), n_fft, hop)
    lo = xp.unfold(-1, hf, hop)[..., :n_frames, :]
    hi = xp[..., hf:].unfold(-1, hf, hop)[..., :n_frames, :]
    if in_time:
        win = get_window(window, n_fft)
        win = torch.as_tensor(win if dt == torch.float64 else win.astype(np.float32),
                              device=x.device)
        lo, hi = lo * win[:hf], hi * win[hf:]
    tabs = _dif_tables(n_fft)
    if dt == torch.float64:
        even, odd = ((lo + hi) @ torch.as_tensor(tabs[0], device=x.device),
                     (lo - hi) @ torch.as_tensor(tabs[1], device=x.device))
    else:
        # bins 0, 2, .. from the sum stream; 1, 3, .. from the difference
        even, odd = (split3_matmul(_pad_k(a, hf), *(torch.as_tensor(t, device=x.device)
                                                    for t in _split_dif_table(n_fft, i)))
                     for i, a in enumerate((lo + hi, lo - hi)))
    n_even, n_odd = tabs[0].shape[1] // 2, tabs[1].shape[1] // 2
    shape = even.shape[:-1] + (hf + 1,)
    re, im = even.new_empty(shape), even.new_empty(shape)
    re[..., 0::2], im[..., 0::2] = even[..., :n_even], even[..., n_even:]
    re[..., 1::2], im[..., 1::2] = odd[..., :n_odd], odd[..., n_odd:]
    if in_time:
        return re, im
    # neighbours k - 1 and k + 1 with the conjugate fix-ups at both ends
    re_l = torch.cat([re[..., 1:2], re[..., :-1]], -1)
    im_l = torch.cat([-im[..., 1:2], im[..., :-1]], -1)
    re_r = torch.cat([re[..., 1:], re[..., -2:-1]], -1)
    im_r = torch.cat([im[..., 1:], -im[..., -2:-1]], -1)
    a0, a1 = WIN_3TAP[window]
    return a0 * re + a1 * (re_l + re_r), a0 * im + a1 * (im_l + im_r)


def bin_values(re: torch.Tensor, im: torch.Tensor) -> torch.Tensor:
    """(B, 4, T, F) spectrum -> (B, 7, T, F) float32: the four channels'
    powers and the normalized intensity vector of each bin, the values the
    kernels project onto the mels (as ``features.logmel_iv_from_spectrum``
    computes them before its projection)."""
    iv = re[:, 1:4] * re[:, :1] + im[:, 1:4] * im[:, :1]
    iv = iv / (torch.sqrt(torch.sum(iv * iv, dim=1, keepdim=True)) + EPS_F32)
    return torch.cat([re * re + im * im, iv], dim=1)


def tile_mel_features(form: str, re: torch.Tensor, im: torch.Tensor, n_fft: int, n_mels: int,
                      sample_rate: int) -> torch.Tensor:
    """(B, 4, T, n_fft // 2 + 1) float32 spectrum -> (B, 7, T, n_mels): the
    mel sums as the kernels take them over 64 mels: for each column tile in
    order, its 64 local bins' values (``bin_values``, zero where a local
    feeds no band) in the mel GEMM's k order, through one split-TF32
    product a k step with each of the tile's groups of 64 mels
    (``mel_tiles``; the 64 locals summed in one chunk), added to the mels'
    running sums; then dB on the powers."""
    vals = bin_values(re, im)
    bins = tile_bins(form, n_fft, n_mels, sample_rate)
    plan = mel_plan(form, n_fft, n_mels, sample_rate)
    fb = _mel_tiles(form, n_fft, n_mels, sample_rate)
    vals = F.pad(vals, (0, 1))  # index -1: a zero value for the locals that feed none
    order = torch.as_tensor(local_order(), device=re.device)
    out = vals.new_zeros(vals.shape[:-1] + (n_mels,))
    for t in range(bins.shape[0]):
        local = vals[..., torch.as_tensor(bins[t], device=re.device)][..., order]
        for j, g in enumerate(range(plan[t, 1], plan[t + 1, 1])):
            m0 = int(plan[t, 0]) + MELS * j
            n = min(MELS, n_mels - m0)
            hi, lo = (torch.as_tensor(fb[g, i].T, device=re.device) for i in (0, 1))
            out[..., m0:m0 + n] += split3_matmul(local, hi, lo, chunk=TILE_BINS)[..., :n]
    return torch.cat([power_to_db(out[:, :4]), out[:, 4:]], dim=1)


def _features(form: str, re, im, n_fft: int, n_mels: int, sample_rate: int) -> torch.Tensor:
    """The plain epilogue of a form: the kernels' per-tile mel sums over 64
    mels, the shared epilogue otherwise."""
    if n_mels > MELS and re.dtype == torch.float32:
        return tile_mel_features(form, re, im, n_fft, n_mels, sample_rate)
    return logmel_iv_from_spectrum(re, im, _mel_fb(sample_rate, n_fft, n_mels, re))


def logmel_iv_flat_plain(x: torch.Tensor, *, n_fft: int, hop: int, window: str = "hann",
                         n_mels: int = 64, sample_rate: int = 24000, post_affine=None,
                         out_dtype: torch.dtype = torch.float32,
                         t_out: Optional[int] = None) -> torch.Tensor:
    """Plain version of K9 on any device: ``flat_spectrum``, the mel sums
    (``_features``) and K1's folds."""
    re, im = flat_spectrum(x, n_fft, hop, window)
    feats = _features("flat", re, im, n_fft, n_mels, sample_rate)
    return apply_folds(feats, post_affine, out_dtype, t_out)


def logmel_iv_dif_plain(x: torch.Tensor, *, n_fft: int, hop: int, window: str = "hann",
                        n_mels: int = 64, sample_rate: int = 24000) -> torch.Tensor:
    """Plain version of K10 on any device: ``dif_spectrum`` (the window in
    time over 64 mels) and the mel sums (``_features``)."""
    re, im = dif_spectrum(x, n_fft, hop, window, in_time=n_mels > MELS)
    return _features("dif", re, im, n_fft, n_mels, sample_rate)


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
    plan = launch_plan("flat", B, N, n_fft, hop, n_mels, sample_rate, t_out)
    tab, fb, tiles = _flat_kernel_tables(n_fft, window, n_mels, sample_rate, x.device)
    aff = affine_table(post_affine, n_mels, x.device)
    acc = _scratch(plan, x.device)
    out = torch.empty((B, 7, t_out, n_mels), device=x.device, dtype=out_dtype)
    FLAT_KERNEL.launches += 1
    FLAT_KERNEL.call("logmel_iv_flat", x.data_ptr(), tab.data_ptr(), fb.data_ptr(),
                     tiles.data_ptr(), aff.data_ptr() if aff is not None else None,
                     acc.data_ptr() if acc is not None else None, out.data_ptr(), B, N, n_fft,
                     hop, plan["Kp"], plan["n_tiles"], plan["n_groups"], n_mels, n_frames, t_out,
                     int(out_dtype == torch.bfloat16))
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
    n_frames = 1 + N // hop
    plan = launch_plan("dif", B, N, n_fft, hop, n_mels, sample_rate, n_frames)
    tab, fb, tiles, s0 = _dif_kernel_tables(n_fft, n_mels, sample_rate, x.device)
    win = _dif_kernel_window(n_fft, window, x.device) if plan["wide"] else None
    acc = _scratch(plan, x.device)
    out = torch.empty((B, 7, n_frames, n_mels), device=x.device, dtype=torch.float32)
    a0, a1 = WIN_3TAP[window]
    DIF_KERNEL.launches += 1
    DIF_KERNEL.call("logmel_iv_dif", x.data_ptr(), tab.data_ptr(), fb.data_ptr(),
                    tiles.data_ptr(), win.data_ptr() if win is not None else None,
                    acc.data_ptr() if acc is not None else None, out.data_ptr(), B, N, n_fft,
                    hop, plan["Kp"], plan["n_tiles"], plan["n_groups"], s0, n_mels, n_frames,
                    a0, a1)
    return out


def _scratch(plan: dict, device) -> Optional[torch.Tensor]:
    """The wide form's mel sums, (B, blocks, FR, 7, n_mels) float32 (the
    kernel zeroes its own), or None at n_mels <= 64."""
    return (torch.empty(plan["scratch"], device=device, dtype=torch.float32)
            if plan["wide"] else None)


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


def launch_plan(form: str, B: int, N: int, n_fft: int, hop: int, n_mels: int,
                sample_rate: int, t_out: int) -> dict:
    """What the C entries of K9 (``form="flat"``) and K10 (``"dif"``) launch
    (csrc/frontend_common.cuh ``launch_forms``): the tables' k padding and
    column tiles, the grid, the ring, shared memory and the TMA boxes;
    raises ``NotImplementedError`` on what they refuse, before any launch."""
    if form not in ("flat", "dif"):
        raise ValueError(f"form must be 'flat' or 'dif', got {form!r}")
    if n_mels < 1:
        raise NotImplementedError(f"the frontend form kernels do not take n_mels={n_mels}")
    tiles = mel_plan(form, n_fft, n_mels, sample_rate)
    n_tiles = tiles.shape[0] - 1
    groups = np.diff(tiles[:, 1])
    wide = n_mels > MELS
    K = n_fft if form == "flat" else n_fft // 2
    n_frames = 1 + N // hop
    blocks = -(-t_out // FR)
    grid = (-(-blocks // CLUSTER) * CLUSTER, B)
    plan = {"Kp": -(-K // BK) * BK, "n_tiles": n_tiles, "n_frames": n_frames,
            "grid": grid, "cluster": CLUSTER, "threads": THREADS, "stages": STAGES,
            "smem": (STAGES * STAGE_BYTES + (0 if wide else ACC_BYTES)
                     + 2 * A_SLOTS[form] * (THREADS - 128) * 16 + 16 * STAGES + 1024),
            # (k, rows) of each TMA box: the tables' hi and lo tiles (split
            # over the pair), the mel tables' two k-halves
            "tab_box": (BK, 2 * COLS // CLUSTER), "fb_box": (BK, 2 * MELS),
            # mel groups: each tile's, all, and the wide form's scratch
            "mel_groups": tuple(int(g) for g in groups), "n_groups": int(tiles[-1, 1]),
            "wide": wide, "scratch": (B, grid[0], FR, 7, n_mels) if wide else None,
            # ring stages a column tile takes: its k-blocks and its mel
            # tables (the widest tile's)
            "stages_a_tile": -(-K // BK) + int(groups.max())}
    why = []
    if not 1 <= B <= 65535:
        why.append(f"B={B} outside the grid's 1..65535")
    if plan["smem"] > SMEM_LIMIT:
        why.append(f"{plan['smem']} bytes of shared memory > {SMEM_LIMIT}")
    if (max(n_tiles * 2 * COLS, plan["n_groups"] * 2 * MELS) >= 2 ** 31
            or max(plan["tab_box"] + plan["fb_box"]) > 256):
        why.append("a TMA dimension or box out of range")
    if t_out < n_frames:
        why.append(f"t_out={t_out} < n_frames={n_frames}")
    if why:
        raise NotImplementedError("the frontend form kernels do not take this: " + "; ".join(why))
    return plan


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
    """(n_fft, 2 n_freqs) float64: the windowed cos | -sin over all bins."""
    k = np.arange(n_fft // 2 + 1)
    c, s = _trig(n_fft, np.arange(n_fft), k)
    win = get_window(window, n_fft)[:, None]
    return np.concatenate([win * c, -win * s], axis=1)


@lru_cache(maxsize=8)
def _split_table(n_fft: int, window: str) -> Tuple[np.ndarray, np.ndarray]:
    """``_dft_table`` split (hi, lo), rows padded to Kp in the kernels' k
    order: the plain flat form's B operand."""
    Kp = -(-n_fft // BK) * BK
    return tf32_split_np(np.pad(_dft_table(n_fft, window), ((0, Kp - n_fft), (0, 0)))[k_order(Kp)])


@lru_cache(maxsize=8)
def _dif_tables(n_fft: int) -> Tuple[np.ndarray, np.ndarray]:
    """The n_fft/2-point DFT tables (n_fft/2, 2 n) float64 as cos | -sin:
    of the sum stream for the even bins 0, 2, .. <= n_fft/2 and of the
    difference stream, pre-twiddled, for the odd bins 1, 3, .. <= n_fft/2."""
    hf = n_fft // 2
    n = np.arange(hf)
    out = []
    for bins in (np.arange(0, hf + 1, 2), np.arange(1, hf + 1, 2)):
        c, s = _trig(n_fft, n, bins)
        out.append(np.concatenate([c, -s], axis=1))
    return tuple(out)


@lru_cache(maxsize=8)
def _split_dif_table(n_fft: int, which: int) -> Tuple[np.ndarray, np.ndarray]:
    """``_dif_tables(n_fft)[which]`` split (hi, lo), rows padded to Kp in the
    kernels' k order."""
    hf = n_fft // 2
    Kp = -(-hf // BK) * BK
    return tf32_split_np(np.pad(_dif_tables(n_fft)[which], ((0, Kp - hf), (0, 0)))[k_order(Kp)])


def _trig(n_fft: int, n: np.ndarray, k: np.ndarray):
    """cos and sin of 2 pi n k / n_fft, (len(n), len(k)) float64, the angle
    reduced exactly (n k mod n_fft) before the float64 product."""
    ang = 2.0 * np.pi * (np.outer(n, k) % n_fft) / n_fft
    return np.cos(ang), np.sin(ang)


@lru_cache(maxsize=8)
def weighted_bins(sample_rate: int, n_fft: int, n_mels: int) -> Tuple[int, int]:
    """The first and last bin with a non-zero mel weight."""
    nz = np.nonzero(logmel_iv_filterbank(sample_rate, n_fft, n_mels).any(axis=1))[0]
    return int(nz[0]), int(nz[-1])


def tile_columns(width: int = COLS) -> Tuple[np.ndarray, np.ndarray]:
    """For each column of a wgmma accumulator ``width`` wide its complex
    index and part (0 re / cos, 1 im / -sin): column 8 j + 2 u + part is
    index (width // 8) u + j, so that thread u of each lane quad holds
    indices (width // 8) u .. + width // 8 - 1. K9's 128 columns are local
    bins 16 u + j; each of K10's two 64-column halves is bins 2s + 2i (sum
    stream) or 2s - 1 + 2i (difference stream), i = 8 u + j."""
    j, r = np.divmod(np.arange(width), 8)
    u, part = np.divmod(r, 2)
    return width // 8 * u + j, part


@lru_cache(maxsize=16)
def tile_bins(form: str, n_fft: int, n_mels: int, sample_rate: int) -> np.ndarray:
    """(n_tiles, 64) int: the bin each column tile's local bin feeds, -1 for
    one that feeds no band. K9: bins k_lo + 64 t + l from the first weighted
    bin k_lo; K10 (s = s0 + 31 t, s0 = k_lo // 2): windowed local l = 1 ..
    62 is bin 2s - 1 + l, locals 0 and 63 feed none. Bins past n_fft / 2
    (K9's last tile) feed none either (their weights are absent)."""
    k_lo, k_hi = weighted_bins(sample_rate, n_fft, n_mels)
    local = np.arange(TILE_BINS)
    if form == "flat":
        n_tiles = -(-(k_hi - k_lo + 1) // TILE_BINS)
        bins = k_lo + TILE_BINS * np.arange(n_tiles)[:, None] + local[None]
    else:
        s0 = k_lo // 2
        n_tiles = -(-(k_hi - 2 * s0 + 1) // (2 * DIF_STEP))
        bins = 2 * (s0 + DIF_STEP * np.arange(n_tiles))[:, None] - 1 + local[None]
        bins[:, [0, TILE_BINS - 1]] = -1
    bins[bins > n_fft // 2] = -1
    return bins


@lru_cache(maxsize=16)
def mel_plan(form: str, n_fft: int, n_mels: int, sample_rate: int) -> np.ndarray:
    """(n_tiles + 1, 2) int32: per column tile its first mel and its first
    mel group, the last row (0, the number of groups). At n_mels <= 64 tile
    t takes group t, mels 0 .. 63 (the narrow form). Wider, a tile's mels
    run from the first one its bins feed, rounded down to a multiple of
    MEL_ALIGN (so that a mel's sum keeps its owner thread in the kernel), to
    the last one, in groups of 64 (at least one)."""
    bins = tile_bins(form, n_fft, n_mels, sample_rate)
    n_tiles = bins.shape[0]
    first, groups = np.zeros(n_tiles, np.int64), np.ones(n_tiles, np.int64)
    if n_mels > MELS:
        fb = logmel_iv_filterbank(sample_rate, n_fft, n_mels)
        for t in range(n_tiles):
            fed = np.nonzero(fb[bins[t][bins[t] >= 0]].any(axis=0))[0]
            lo, hi = (fed[0], fed[-1]) if fed.size else (0, 0)
            first[t] = lo // MEL_ALIGN * MEL_ALIGN
            groups[t] = -(-(hi - first[t] + 1) // MELS)
    plan = np.zeros((n_tiles + 1, 2), np.int32)
    plan[:-1, 0] = first
    plan[1:, 1] = np.cumsum(groups)
    return plan


def mel_tiles(fb: np.ndarray, local_bins: np.ndarray, plan: np.ndarray) -> np.ndarray:
    """(n_groups, 2, 64, 64) float32: per mel group the hi and lo mel
    tables, rows the group's mels (tile t's group j: mels plan[t, 0] + 64 j
    + r, zero from n_mels on), k the tile's local bins in the mel GEMM's
    order (``local_order``); ``local_bins`` (n_tiles, 64) gives each local's
    bin, -1 for one that feeds no band."""
    n_mels = fb.shape[1]
    rows = np.zeros((int(plan[-1, 1]), TILE_BINS, MELS))
    for t, bins in enumerate(local_bins):
        ok = bins >= 0
        for g in range(plan[t, 1], plan[t + 1, 1]):
            m0 = plan[t, 0] + MELS * (g - plan[t, 1])
            cols = fb[bins[ok], m0:m0 + MELS]
            rows[g, np.nonzero(ok)[0], :cols.shape[1]] = cols
    hi, lo = tf32_split_np(rows.transpose(0, 2, 1)[..., local_order()])
    return np.ascontiguousarray(np.stack([hi, lo], axis=1))


def flat_tables(n_fft: int, window: str, n_mels: int, sample_rate: int):
    """K9's tables: (n_tiles, 2, 128, Kp) float32, per tile of 64 bins from
    the first weighted one the hi and lo parts of the windowed cos and -sin
    (split from float64), rows the tile's columns (local bin 16 u + j at
    columns 8 j + 2 u + {0: cos, 1: -sin}), k the samples in the kernels'
    order (``k_order``), zero from n_fft to Kp (n_fft rounded up to the
    k-block); and ``mel_tiles`` of each tile's 64 bins (groups as
    ``mel_plan``)."""
    plan = launch_plan("flat", 1, n_fft, n_fft, 1, n_mels, sample_rate, 1 + n_fft)
    n_tiles, Kp = plan["n_tiles"], plan["Kp"]
    k_lo = weighted_bins(sample_rate, n_fft, n_mels)[0]
    local, part = tile_columns()
    win = get_window(window, n_fft)[:, None]
    tab = np.zeros((n_tiles, COLS, Kp))
    for t in range(n_tiles):
        bins = k_lo + TILE_BINS * t + local
        c, s = _trig(n_fft, np.arange(n_fft), bins)
        tab[t, :, :n_fft] = (np.where(part == 0, win * c, -win * s) * (bins <= n_fft // 2)).T
    hi, lo = tf32_split_np(tab[..., k_order(Kp)])
    return (np.ascontiguousarray(np.stack([hi, lo], axis=1)),
            _mel_tiles("flat", n_fft, n_mels, sample_rate))


def dif_tables(n_fft: int, n_mels: int, sample_rate: int):
    """K10's tables and s0: tile t (s = s0 + 31 t) holds in its first 64
    columns the (cos, -sin) of bin 2s + 2i over the n_fft/2 samples of the
    sum stream and in its last 64 those of bin 2s - 1 + 2i for the
    difference stream (i = 8 u + j at columns 8 j + 2 u + part of each
    half), zero for a bin outside 0 .. n_fft/2; split hi/lo as K9's,
    (n_tiles, 2, 128, Kp) float32; with ``mel_tiles`` of local bin l (bin
    2s - 1 + l, l = 1 .. 62; locals 0 and 63, which the next and the last
    tile hold, feed none)."""
    hf = n_fft // 2
    plan = launch_plan("dif", 1, n_fft, n_fft, 2, n_mels, sample_rate, 1 + n_fft // 2)
    n_tiles, Kp = plan["n_tiles"], plan["Kp"]
    s0 = weighted_bins(sample_rate, n_fft, n_mels)[0] // 2
    idx, part = (np.tile(a, 2) for a in tile_columns(COLS // 2))
    half = np.arange(COLS) // (COLS // 2)
    n = np.arange(hf)
    tab = np.zeros((n_tiles, COLS, Kp))
    for t in range(n_tiles):
        s = s0 + DIF_STEP * t
        bins = np.where(half == 0, 2 * s + 2 * idx, 2 * s - 1 + 2 * idx)
        c, sn = _trig(n_fft, n, bins)
        keep = (bins >= 0) & (bins <= hf)
        tab[t, :, :hf] = (np.where(part == 0, c, -sn) * keep).T
    hi, lo = tf32_split_np(tab[..., k_order(Kp)])
    return (np.ascontiguousarray(np.stack([hi, lo], axis=1)),
            _mel_tiles("dif", n_fft, n_mels, sample_rate), s0)


@lru_cache(maxsize=8)
def _flat_kernel_tables(n_fft: int, window: str, n_mels: int, sample_rate: int,
                        device: torch.device):
    return tuple(torch.as_tensor(a, device=device)
                 for a in (*flat_tables(n_fft, window, n_mels, sample_rate),
                           mel_plan("flat", n_fft, n_mels, sample_rate)))


def dif_window(n_fft: int, window: str) -> np.ndarray:
    """(2, Kp) float32: the window K10's wide form multiplies each frame's
    halves by, w[n] and w[n + n_fft/2] for n < n_fft/2 in sample order (a thread
    reads four adjacent samples' values as one vector), zero to Kp."""
    hf = n_fft // 2
    Kp = -(-hf // BK) * BK
    w = np.zeros((2, Kp), np.float32)
    win = get_window(window, n_fft).astype(np.float32)
    w[0, :hf], w[1, :hf] = win[:hf], win[hf:]
    return w


@lru_cache(maxsize=8)
def _dif_kernel_window(n_fft: int, window: str, device: torch.device) -> torch.Tensor:
    return torch.as_tensor(dif_window(n_fft, window), device=device)


@lru_cache(maxsize=16)
def _mel_tiles(form: str, n_fft: int, n_mels: int, sample_rate: int) -> np.ndarray:
    """The form's ``mel_tiles`` (the mel tables are the same whatever the
    window)."""
    return mel_tiles(logmel_iv_filterbank(sample_rate, n_fft, n_mels),
                     tile_bins(form, n_fft, n_mels, sample_rate),
                     mel_plan(form, n_fft, n_mels, sample_rate))


@lru_cache(maxsize=8)
def _dif_kernel_tables(n_fft: int, n_mels: int, sample_rate: int, device: torch.device):
    tab, fb, s0 = dif_tables(n_fft, n_mels, sample_rate)
    return (torch.as_tensor(tab, device=device), torch.as_tensor(fb, device=device),
            torch.as_tensor(mel_plan("dif", n_fft, n_mels, sample_rate), device=device), s0)
