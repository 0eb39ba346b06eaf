"""The port's frontend (plain version of kernel K1) against the JAX package:
the XLA LogmelIVExtractor and the Pallas fused_logmel_iv in interpret mode,
on the same seeded numpy waveform."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from pseldnets_tpu.ops.features import LogmelIVExtractor as JaxExtractor
from pseldnets_tpu.ops.pallas.frontend import fused_logmel_iv as jax_fused
from pseldnets_tpu_torch.ops import frontend
from pseldnets_tpu_torch.ops.features import LogmelIVExtractor
import torch_threads  # noqa: F401  (each xdist worker's share of the cores)

FE = dict(n_fft=1024, hop=240, window="hann", n_mels=16, sample_rate=24000)


def _cfg(n_mels=16):
    return {"data": {"nfft": 1024, "hoplen": 240, "window": "hann",
                     "sample_rate": 24000, "n_mels": n_mels,
                     "frontend_dft": "f32"}}


def _wav(rng, B=2, N=57600):
    return (rng.standard_normal((B, 4, N)) * 0.1).astype(np.float32)


def _split_err(a, b):
    """(max |dB| over the 4 log-mel channels, max |diff| over the 3 IV channels)."""
    d = np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64))
    return d[:, :4].max(), d[:, 4:].max()


def test_plain_frontend_matches_jax_xla_extractor(rng):
    # f32 DFTs on both sides, summed in different orders: the repo's
    # feature budget (8e-4 dB log-mel, 7e-5 IV) bounds the gap
    wav = _wav(rng)
    ref = np.asarray(JaxExtractor(_cfg(), backend="xla")(jnp.asarray(wav)))
    got = LogmelIVExtractor(_cfg())(torch.from_numpy(wav)).numpy()
    assert got.shape == ref.shape == (2, 7, 241, 16)
    db, iv = _split_err(got, ref)
    assert db < 8e-4 and iv < 7e-5, (db, iv)


def test_plain_frontend_matches_pallas_interpret_with_folds(rng):
    """post_affine (eval ScalarBN), full-frame zero tail after the affine,
    f32 output: the serving form of the kernel, radix-2 f32 path."""
    wav = _wav(rng)
    inv = (rng.random((7, 16)) + 0.5).astype(np.float32)
    shift = rng.standard_normal((7, 16)).astype(np.float32)
    ref = np.asarray(jax_fused(jnp.asarray(wav), interpret=True, split3=False,
                               t_blk=32, post_affine=(inv, shift),
                               full_frames=True, **FE))
    got = frontend.fused_logmel_iv(torch.from_numpy(wav), t_out=ref.shape[2],
                                   post_affine=(torch.from_numpy(inv),
                                                torch.from_numpy(shift)),
                                   **FE).numpy()
    assert got.shape == ref.shape == (2, 7, 256, 16)
    assert not got[:, :, 241:].any() and not ref[:, :, 241:].any()
    # errors scale with |inv| <= 1.5: budget 1e-3 dB log-mel, 1e-4 IV
    db, iv = _split_err(got, ref)
    assert db < 1e-3 and iv < 1e-4, (db, iv)


def test_plain_frontend_bf16_output_and_silence(rng):
    """bf16 cast rides the output; digital silence gives finite features
    (IV = 0, not NaN: the +eps in the normalization)."""
    wav = _wav(rng)
    wav[1] = 0.0
    f32 = frontend.fused_logmel_iv(torch.from_numpy(wav), **FE)
    bf = frontend.fused_logmel_iv(torch.from_numpy(wav), out_dtype=torch.bfloat16, **FE)
    assert bf.dtype == torch.bfloat16
    assert torch.isfinite(f32).all()
    assert (f32[1, 4:] == 0).all() and (f32[1, :4] == -100.0).all()
    # bf16 keeps 8 significant bits: relative rounding <= 2^-8
    rel = ((bf.float() - f32).abs() / f32.abs().clamp(min=1e-30)).max()
    assert rel <= 2.0 ** -8, rel


def _rev5(r):
    return int(f"{r:05b}"[::-1], 2)


def _fft32_dif(a, w32):
    """The kernel's 32-point radix-2 DIF FFT over the last axis: natural order
    in, bin rev5(r) at position r out."""
    a = a.copy()
    for s in range(5):
        half = 16 >> s
        for g in range(0, 32, 2 * half):
            for p in range(half):
                u, v = a[..., g + p].copy(), a[..., g + p + half].copy()
                a[..., g + p] = u + v
                a[..., g + p + half] = (u - v) * w32[p << s]
    return a


def _replay_k1_frame(x, frame, hop, win, tw, gstart, ginfo, gwts, n_mels):
    """numpy replay of csrc/frontend.cu on one frame (float64): the sample
    map (reflect pad by index), the four-step 32 x 32 FFT of the two packed
    channel pairs with its twiddle table and transpose, the unpacking of bin
    lane + 32 j against the partner lane's bin (the shuffle rule; the
    twiddle of row k1 = 8 h + l the product of table rows l and 8 h), power and
    normalized IV, and the mel gathers over the group tables in the
    kernel's order (two interleaved sums, then added)."""
    R, n_fft = 32, 1024
    idx = frontend.span_samples(frame * hop, n_fft, x.shape[-1])
    seg = np.where(idx >= 0, x[:, np.maximum(idx, 0)], 0.0)
    w32 = np.exp(-2j * np.pi * np.arange(16) / 32)
    twc = tw[:, 0].astype(np.float64) + 1j * tw[:, 1]
    rev = [_rev5(r) for r in range(R)]
    lanes = np.arange(R)
    chans = []
    for st in range(2):
        z = win * (seg[2 * st] + 1j * seg[2 * st + 1])
        a = _fft32_dif(z.reshape(R, R).T, w32)  # a[lane, r] = Y[k1 = rev5(r)] of column lane
        T = np.zeros((R, R), complex)
        for r in range(R):
            k1 = rev[r]
            lo, hi = twc[(k1 & 7) * R:((k1 & 7) + 1) * R], twc[(k1 & 24) * R:((k1 & 24) + 1) * R]
            T[k1] = a[:, r] * (lo if k1 < 8 else hi if k1 % 8 == 0 else lo * hi)
        a = _fft32_dif(T, w32)  # a[lane, r] = Z[lane + 32 rev5(r)]
        partner = (R - lanes) % R
        c = np.zeros((2, 513), complex)
        for j in range(17):
            for lane in lanes:
                k = lane + R * j
                if k > n_fft // 2:
                    continue
                A = a[lane, rev[j]]
                if j < 16:
                    p = partner[lane]
                    B = a[p, rev[(R - j) % R] if p == 0 else rev[R - 1 - j]]
                else:
                    B = A
                c[0, k] = complex(0.5 * (A.real + B.real), 0.5 * (A.imag - B.imag))
                c[1, k] = complex(0.5 * (A.imag + B.imag), 0.5 * (B.real - A.real))
        chans += [c[0], c[1]]
    X = np.stack(chans)  # W, X, Y, Z at bins 0 .. n_fft / 2
    vals = np.zeros((7, 513))
    vals[:4] = np.abs(X) ** 2
    iv = (np.conj(X[0]) * X[1:]).real
    vals[4:] = iv / (np.sqrt((iv ** 2).sum(0)) + np.finfo(np.float32).eps)
    mel = np.zeros((7, n_mels))
    for g, (off, width) in enumerate(ginfo):
        for mp in range(frontend.GROUP):
            m = g * frontend.GROUP + mp
            if m >= n_mels:
                continue
            w = gwts[off + mp * width:off + (mp + 1) * width].astype(np.float64)
            v = vals[:, gstart[m]:gstart[m] + width]
            mel[:, m] = (v[:, 0::2] * w[0::2]).sum(1) + (v[:, 1::2] * w[1::2]).sum(1)
    mel[:4] = 10 * np.log10(np.maximum(mel[:4], 1e-10))
    return mel


def test_fft_kernel_replay_matches_plain_frontend(rng):
    """The FFT kernel's index logic, replayed in numpy with its own tables,
    gives the plain version's features on the first, a middle and the last
    frame (which carry the reflect pad): the feature budget."""
    from pseldnets_tpu_torch.ops.features import logmel_iv_filterbank

    x = _wav(rng, B=1, N=24000)
    ref = frontend.fused_logmel_iv(torch.from_numpy(x), **FE).numpy()[0]
    win, tw = frontend.fft_tables(1024, "hann")
    assert win.shape == (1024,) and tw.shape == (1024, 2)
    gstart, ginfo, gwts = frontend.mel_groups(logmel_iv_filterbank(24000, 1024, 16))
    assert ginfo.shape == (4, 2) and gstart.shape == (16,)  # 16 bands in groups of 4
    for frame in (0, 1, 50, ref.shape[1] - 1):
        got = _replay_k1_frame(x[0].astype(np.float64), frame, 240, win.astype(np.float64),
                               tw, gstart, ginfo, gwts, 16)
        db, iv = _split_err(got[None], ref[None, :, frame])
        assert db < 8e-4 and iv < 7e-5, (frame, db, iv)


@pytest.mark.parametrize("align", [True, False])
@pytest.mark.parametrize("n_mels,sample_rate", [(64, 24000), (16, 24000), (64, 32000),
                                                (30, 24000)])
def test_mel_group_tables_reproduce_the_filterbank(n_mels, sample_rate, align):
    """The gather tables, scattered back into a dense (bins, n_mels)
    matrix, give the filterbank exactly; every window lies within bins
    0 .. n_fft / 2 and covers its band's non-zero weights; widths are even,
    so the kernel's two interleaved sums take whole pairs; aligned, the
    windows of a group start on distinct bins mod 4 (28 lanes, 28 banks)
    and no width is a multiple of 32."""
    from pseldnets_tpu_torch.ops.features import logmel_iv_filterbank

    fb = logmel_iv_filterbank(sample_rate, 1024, n_mels)
    bands = frontend.mel_bands(fb)
    for m, (lo, hi) in enumerate(bands):
        nz = np.nonzero(fb[:, m])[0]
        assert lo == nz[0] and hi == nz[-1]
    gstart, ginfo, gwts = frontend.mel_groups(fb, align=align)
    n_groups = -(-n_mels // frontend.GROUP)
    assert ginfo.shape == (n_groups, 2) and gstart.shape == (n_groups * frontend.GROUP,)
    dense = np.zeros((fb.shape[0], n_groups * frontend.GROUP), np.float32)
    for g, (off, width) in enumerate(ginfo):
        assert width % 2 == 0 and width >= 2
        assert off == 0 if g == 0 else off == ginfo[g - 1, 0] + frontend.GROUP * ginfo[g - 1, 1]
        for mp in range(frontend.GROUP):
            m = g * frontend.GROUP + mp
            s = gstart[m]
            assert 0 <= s and s + width <= fb.shape[0]
            if m < n_mels:
                assert s <= bands[m, 0] and bands[m, 1] < s + width
            dense[s:s + width, m] += gwts[off + mp * width:off + (mp + 1) * width]
    assert gwts.size == ginfo[-1, 0] + frontend.GROUP * ginfo[-1, 1]
    if align and (n_mels, sample_rate) == (64, 24000):
        g4 = gstart.reshape(-1, frontend.GROUP) % 4
        assert (g4 == np.arange(4)).mean() > 0.95 and (ginfo[:, 1] % 32).all()
    np.testing.assert_array_equal(dense[:, :n_mels], fb)
    assert not dense[:, n_mels:].any()


@pytest.mark.parametrize("N", [24000, 240000, 240000 + 117])
@pytest.mark.parametrize("B", [1, 2, 3, 32])
@pytest.mark.parametrize("warps", [1, 2, 4])
def test_launch_plan_covers_every_frame_once(N, B, warps):
    """One warp per (clip, frame): the grid covers each frame of t_out once
    per clip (the served HTSAT form's 1024, the PaSST and training forms'
    n_frames), the real frames below n_frames and the zero tail above; each
    block's staged span holds every padded sample its real frames read and
    fits its warps' regions two channels at a time; the regions hold the
    stash, the value rows and the staged outputs; and the shipped block of 4
    warps fits three times on an SM (228 KB, 1 KB reserved a block), as the
    kernel's register cap does."""
    from pseldnets_tpu_torch.ops.features import logmel_iv_filterbank

    hop = 240
    n_frames = 1 + N // hop
    n_w = frontend.mel_groups(logmel_iv_filterbank(24000, 1024, 64))[2].size
    for t_out in sorted({n_frames, max(n_frames, 1024)}):
        plan = frontend.launch_plan(B, N, hop, t_out, 64, warps, n_w)
        assert plan["n_frames"] == n_frames and plan["threads"] == 32 * warps
        gx, gy = plan["grid"]
        assert gy == B and gx == len(plan["blocks"])
        seen = np.zeros((B, t_out), np.int64)
        for b in range(B):
            for bx, blk in enumerate(plan["blocks"]):
                f = np.array(blk["frames"], np.int64)
                assert (f == bx * warps + np.arange(f.size)).all()
                np.add.at(seen[b], f, 1)
        assert (seen == 1).all()
        for blk in plan["blocks"]:
            real = [f for f in blk["frames"] if f < n_frames]
            if not real:
                assert blk["span"] == 0
                continue
            lo, hi = blk["first"], blk["first"] + blk["span"]
            assert lo == real[0] * hop and hi == real[-1] * hop + 1024  # every sample read
            assert 2 * blk["span"] * 4 <= warps * plan["region"]
        assert plan["value_rows"] <= plan["region"] and plan["stash"] <= plan["region"]
        assert plan["outputs"] <= plan["region"]
        assert plan["tables"] >= 4 * n_w + 4 * 6 * 16
        blocks = 228 * 1024 // (plan["smem"] + 1024)  # resident blocks by shared memory
        assert warps * blocks >= 10 and (warps != 4 or blocks == 3)


@pytest.mark.parametrize("N", [24000, 24000 + 7, 600])
def test_frame_sample_map_reads_the_padded_signal(rng, N):
    """The kernel's sample index of each frame (reflect pad of n_fft / 2 by
    index arithmetic, zeros past N + n_fft) reads exactly the center=True
    padded signal, at the first frames, the interior and the last frames;
    so does each block's staged span, at every frame's offset in it."""
    from pseldnets_tpu_torch.ops.frontend_forms import padded_signal

    hop = 240
    x = rng.standard_normal(N)
    xp = padded_signal(torch.from_numpy(x)[None], 1024, hop)[0].numpy()
    n_frames = 1 + N // hop
    for blk in frontend.launch_plan(1, N, hop, n_frames + 30, 64, 4)["blocks"]:
        idx = frontend.span_samples(blk["first"], blk["span"], N)
        span = np.where(idx >= 0, x[np.maximum(idx, 0)], 0.0)
        for f in blk["frames"]:
            if f < n_frames:
                o = f * hop - blk["first"]
                np.testing.assert_array_equal(span[o:o + 1024], xp[f * hop:f * hop + 1024])
    for f in sorted({0, 1, 2, n_frames // 2, n_frames - 3, n_frames - 2, n_frames - 1} - {-1}):
        if f < 0:
            continue
        idx = frontend.span_samples(f * hop, 1024, N)
        assert idx.shape == (1024,) and idx.max() < N
        got = np.where(idx >= 0, x[np.maximum(idx, 0)], 0.0)
        np.testing.assert_array_equal(got, xp[f * hop:f * hop + 1024])


@pytest.mark.parametrize("n_mels", [64, 16, 15])
def test_store_plan_writes_each_output_once(n_mels):
    """The staged outputs' copy: each warp writes the 7 rows of n_mels of its
    frame, a pair per lane where n_mels is even (one per lane where odd):
    every (clip, channel, frame, mel) of the output once, rows contiguous."""
    B, t_out = 2, 9
    count = np.zeros((B, 7, t_out, n_mels), np.int64)
    for b in range(B):
        for frame in range(t_out):
            for q in range(7):
                for m0 in frontend.store_columns(n_mels):
                    for m in m0:
                        count[b, q, frame, m] += 1
    assert (count == 1).all()
    cols = frontend.store_columns(n_mels)
    busy = min(32, n_mels // 2 if n_mels % 2 == 0 else n_mels)
    assert len(cols) == 32 and all(cols[:busy]) and not any(cols[busy:])


def test_mel_bands_cover_every_nonzero_weight():
    """mel_bands gives each band's first and last non-zero bin (the gather
    windows start from them); at 64 mels of a 1024-point FFT no bin feeds
    more than two bands, so a window of the widest band in a group of four
    covers each group's bands."""
    from pseldnets_tpu_torch.ops.features import logmel_iv_filterbank

    fb = logmel_iv_filterbank(24000, 1024, 64)
    bands = frontend.mel_bands(fb)
    assert bands.shape == (64, 2)
    for m, (lo, hi) in enumerate(bands):
        nz = np.nonzero(fb[:, m])[0]
        assert lo == nz[0] and hi == nz[-1]
        assert (fb[lo:hi + 1, m] > 0).all()  # a triangle: no zero inside
    assert ((fb != 0).sum(1) <= 2).all()
    gstart, ginfo, _ = frontend.mel_groups(fb)
    widths = bands[:, 1] - bands[:, 0] + 1
    assert (ginfo[:, 1] >= widths.reshape(16, 4).max(1)).all()
    assert (ginfo[:, 1] <= widths.reshape(16, 4).max(1) + 6).all()  # alignment and pairs
    _, plain, _ = frontend.mel_groups(fb, align=False)
    assert (plain[:, 1] <= widths.reshape(16, 4).max(1) + 1).all()


def test_frame_signal_and_stft_match_jax(rng):
    """center=True reflect-padded frames (the first and last frames carry the
    reflection) and the windowed-DFT STFT against the JAX package's."""
    from pseldnets_tpu.ops.stft import frame_signal as jax_frames
    from pseldnets_tpu.ops.stft import stft_dft as jax_stft
    from pseldnets_tpu_torch.ops.stft import frame_signal, stft_dft

    x = rng.standard_normal((2, 4, 5000)).astype(np.float32)
    ref = np.asarray(jax_frames(jnp.asarray(x), 1024, 240))
    got = frame_signal(torch.from_numpy(x), 1024, 240).numpy()
    assert got.shape == ref.shape == (2, 4, 21, 1024)
    np.testing.assert_array_equal(got, ref)  # pure data movement: exact
    re_ref, im_ref = (np.asarray(a) for a in jax_stft(jnp.asarray(x), 1024, 240))
    re, im = (a.numpy() for a in stft_dft(torch.from_numpy(x), 1024, 240))
    # f32 sums of 1024 products in different orders: ~1e-6 of the largest bin
    scale = np.abs(re_ref).max()
    assert np.abs(re - re_ref).max() < 1e-5 * scale and np.abs(im - im_ref).max() < 1e-5 * scale
