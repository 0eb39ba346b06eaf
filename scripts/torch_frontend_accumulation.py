#!/usr/bin/env python3
"""How the float32 summation order of the DFT-as-GEMM frontend forms (kernels
K9 and K10, pseldnets_tpu_torch/csrc/frontend_{flat,dif}.cu) moves their
log-mel error, emulated in numpy on the CPU.

Each (frame, channel, column) sum runs over k in float32 with fused
multiply-adds (each product exact, one rounding per add): "sequential" adds
every product to the running sum; "two-level" (the kernels' order) sums each
k step of 16 products into a partial and adds the partial to the running
sum. The features of both are compared with the float64 flat DFT of the
same waveform; the script prints, over the four log-mel channels, the
largest |dB| error (set by the deepest spectral valleys, so it varies with
the seed), its 99.9th percentile and its root mean square, and the largest
|IV| error over the three intensity-vector channels.

    python3 scripts/torch_frontend_accumulation.py [--n-fft 512 --hop 100 --clips 2]

Noise waveforms (std 0.1, 4 channels, 10 s at 24 kHz) from --seed. A few
minutes on one CPU core per form at the defaults.
"""

import argparse
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from pseldnets_tpu_torch.ops import frontend_forms as ff  # noqa: E402
from pseldnets_tpu_torch.ops.features import (logmel_iv_filterbank,  # noqa: E402
                                              logmel_iv_from_spectrum)


def emulate(a, t, order):
    """a (M, K) @ t (K, C), float32 FMA sums in ``order``, returned float64."""
    f32 = lambda v: v.astype(np.float32).astype(np.float64)  # noqa: E731
    acc = np.zeros((a.shape[0], t.shape[1]))
    part = np.zeros_like(acc)
    for k in range(a.shape[1]):
        prod = np.outer(a[:, k], t[k])
        if order == "sequential":
            acc = f32(acc + prod)
            continue
        part = f32(part + prod)
        if (k + 1) % ff.BK == 0 or k == a.shape[1] - 1:
            acc = f32(acc + part)
            part[:] = 0.0
    return acc


def report(form, order, got, ref):
    d = np.abs(got - ref)
    db = d[:, :4].ravel()
    print(f"{form:4s} {order:10s}: |dB| max {db.max():.3g}, p99.9 "
          f"{np.quantile(db, 0.999):.3g}, rms {np.sqrt((db ** 2).mean()):.3g}; "
          f"max |IV| {d[:, 4:].max():.3g}")


def features(re, im, n_fft, n_mels):
    fb = torch.as_tensor(logmel_iv_filterbank(24000, n_fft, n_mels)).double()
    return logmel_iv_from_spectrum(torch.as_tensor(re), torch.as_tensor(im), fb).numpy()


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n-fft", type=int, default=512)
    ap.add_argument("--hop", type=int, default=100)
    ap.add_argument("--clips", type=int, default=2)
    ap.add_argument("--n-mels", type=int, default=64)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    n_fft, hop = args.n_fft, args.hop
    x = torch.from_numpy(np.random.default_rng(args.seed).standard_normal(
        (args.clips, 4, 240000)).astype(np.float32) * 0.1)
    n_frames = 1 + x.shape[-1] // hop
    lead = (args.clips, 4, n_frames)

    re, im = ff.flat_spectrum(x.double(), n_fft, hop, "hann")
    ref = features(re.numpy(), im.numpy(), n_fft, args.n_mels)

    xp = ff.padded_signal(x.double(), n_fft, hop)
    frames = xp.unfold(-1, n_fft, hop)[..., :n_frames, :].reshape(-1, n_fft).numpy()
    tab = ff._dft_table(n_fft, "hann").astype(np.float64)
    hf = n_fft // 2
    lo = xp.unfold(-1, hf, hop)[..., :n_frames, :].float().double()
    hi = xp[..., hf:].unfold(-1, hf, hop)[..., :n_frames, :].float().double()
    u = (lo + hi).float().double().reshape(-1, hf).numpy()
    v = (lo - hi).float().double().reshape(-1, hf).numpy()
    t_even, t_odd = (t.astype(np.float64) for t in ff._dif_tables(n_fft))
    a0, a1 = ff.WIN_3TAP["hann"]
    n_freqs = n_fft // 2 + 1
    for order in ("sequential", "two-level"):
        spec = emulate(frames, tab, order).reshape(lead + (-1,))
        report("flat", order, features(spec[..., :n_freqs], spec[..., n_freqs:], n_fft,
                                       args.n_mels), ref)
        even = emulate(u, t_even, order).reshape(lead + (-1,))
        odd = emulate(v, t_odd, order).reshape(lead + (-1,))
        X = np.zeros(lead + (n_freqs,), complex)
        ne, no = t_even.shape[1] // 2, t_odd.shape[1] // 2
        X[..., 0::2] = even[..., :ne] + 1j * even[..., ne:]
        X[..., 1::2] = odd[..., :no] + 1j * odd[..., no:]
        left = np.concatenate([np.conj(X[..., 1:2]), X[..., :-1]], -1)
        right = np.concatenate([X[..., 1:], np.conj(X[..., -2:-1])], -1)
        xw = (a0 * X + a1 * (left + right)).astype(np.complex64).astype(complex)
        report("dif", order, features(xw.real, xw.imag, n_fft, args.n_mels), ref)


if __name__ == "__main__":
    main()
