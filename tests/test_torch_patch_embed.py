"""Kernel K8 (the HTSAT patch embed) on the CPU: its plain version against
the Pallas ``patch_embed_tokens`` in interpret mode, a numpy replay of the
kernel's persistent tile schedule, fragment loads, weight layout and token
order, and the HTSAT serving paths with ``patch_embed="kernel"`` (the
default: plain, 5 s trick, AdapterBit, from the waveform) against the JAX
ones on the tiny model of tests/test_serving_fused.py."""

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pseldnets_tpu.ops.pallas.patch_embed import patch_embed_tokens as jax_patch_embed
from pseldnets_tpu.serving import htsat_fused_forward as jax_fused_forward
from pseldnets_tpu.serving import htsat_fused_forward_from_wav as jax_from_wav
from pseldnets_tpu_torch.ops import patch_embed
from pseldnets_tpu_torch.serving import (htsat_fused_forward, htsat_fused_forward_from_wav,
                                         prepare_patch_embed)
import torch_threads  # noqa: F401  (each xdist worker's share of the cores)
from test_torch_adapter import _serving_models
from test_torch_htsat import FE, _models

T_IMG = 256  # spec_size 64 x freq_ratio 4 (mel bins 16)


@pytest.fixture
def rng():
    """A fresh generator for each test (in place of the session one): each
    test's data is fixed, whatever ran before it on the same worker."""
    return np.random.default_rng(8)


def _jax_tokens(variables, x, dtype):
    pe = variables["params"]["encoder"]["patch_embed"]
    proj = pe["proj"].get("base", pe["proj"])  # the JAX package's _dense_p
    out = jax_patch_embed(jnp.asarray(x).astype(dtype),
                          jnp.asarray(proj["kernel"], jnp.float32), proj["bias"],
                          pe["norm"]["scale"], pe["norm"]["bias"], spec_size=64, freq_ratio=4,
                          compute_dtype=dtype, interpret=True)
    return np.asarray(out.astype(jnp.float32))


def _bf16_ulps(got, ref):
    """Largest error as a share of max(|ref|, 1) per element: one bf16 ulp
    is 2^-7 of that (the rule chip_smoke.py holds the folded K1 to)."""
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return float((np.abs(got - ref) / np.maximum(np.abs(ref), 1.0)).max())


@pytest.mark.parametrize("T", [T_IMG, 241])
def test_plain_matches_pallas_interpret(rng, T):
    """float32 < 1e-5 (summation order only); bf16 within one bf16 ulp (the
    same bf16 operands, float32 sums, LayerNorm in float32, one rounding).
    T=241: the reshape_wav2img zero pad."""
    _, variables, tm = _models(rng)
    x = (rng.standard_normal((2, 7, T, 16)) * 0.5).astype(np.float32)
    xp = np.pad(x, ((0, 0), (0, 0), (0, T_IMG - T), (0, 0)))
    for dtype, jdtype in ((torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)):
        p = prepare_patch_embed(tm.encoder, dtype)
        got = patch_embed.patch_embed_tokens_plain(torch.from_numpy(x).to(dtype), p)
        assert got.shape == (2, 4 * 4 * 16, 16) and got.dtype == dtype
        ref = _jax_tokens(variables, xp, jdtype)
        if dtype == torch.float32:
            assert np.abs(got.numpy() - ref).max() < 1e-5, np.abs(got.numpy() - ref).max()
        else:
            assert _bf16_ulps(got.float().numpy(), ref) <= 2.0 ** -7


def _row_token(m, H=1):
    """csrc/patch_embed.cu's GEMM row m of a tile -> (fp, tp) for H 64-bin
    halves (F = 64 H): bits m0 tp0, m1 fp0, m2 fp2, m3 fp1, m4 fp3, then m5,
    m6 tp1, tp2 (H 1), fp4, tp1 (H 2) or fp4, fp5 (H 4)."""
    bit = lambda i: (m >> i) & 1  # noqa: E731
    fp = bit(1) | bit(3) << 1 | bit(2) << 2 | bit(4) << 3
    tp = bit(0)
    if H == 1:
        tp = tp | bit(5) << 1 | bit(6) << 2
    elif H == 2:
        fp, tp = fp | bit(5) << 4, tp | bit(6) << 1
    else:
        fp = fp | bit(5) << 4 | bit(6) << 5
    return fp, tp


def _col_channel(n):
    """The kernel's GEMM column n -> embedding channel e."""
    return 24 * (n // 2 % 4) + 2 * (n // 8) + n % 2


def _gemm_col(e):
    """csrc/patch_embed.cu::gemm_col: channel e -> GEMM column."""
    return 8 * (e % 24 // 2) + 2 * (e // 24) + e % 2


def _swizzle128(c, t, f, H=1):
    """Byte offset of bf16 x[c, t, f] in a stage: the box of half f // 64
    (7 channels of 32 / H frames of 64 bins), TMA's 128-byte swizzle over
    its 128-byte frame rows c (32 / H) + t (16-byte chunk ^= row % 8)."""
    frames = 32 // H
    r = c * frames + t
    fl = f % 64
    return (f // 64) * 7 * frames * 128 + r * 128 + ((fl // 8) ^ (r % 8)) * 16 + fl % 8 * 2


def _kernel_const(name):
    """A ``constexpr int`` of csrc/patch_embed.cu, read from its source."""
    m = re.search(rf"constexpr int {name} = (\d+);", patch_embed.KERNEL.source.read_text())
    return int(m.group(1))


def _schedule(tiles, sms):
    """Replay of the bf16 kernel's persistent loop on ``sms`` SMs: the grid
    min(tiles, CTAS_PER_SM x sms) that launch_wgmma sets; block b's first
    STAGES loads (tiles b, b + grid, ...), its walk t = b, b + grid, ...
    waiting on stage it % STAGES for that stage's (it / STAGES)-th load,
    and the refill of tile t + STAGES grid into the stage just read.
    Asserts that each wait finds the tile it computes, with that load the
    only one in flight on its stage, and that no load is left unread.
    Returns (grid, the tiles each block took)."""
    stages, grid = _kernel_const("STAGES"), min(tiles, _kernel_const("CTAS_PER_SM") * sms)
    taken = []
    for cta in range(grid):
        loads = [[cta + s * grid] if cta + s * grid < tiles else [] for s in range(stages)]
        mine = []
        for it, t in enumerate(range(cta, tiles, grid)):
            s = it % stages
            assert len(loads[s]) == it // stages + 1 and loads[s][-1] == t
            if t + stages * grid < tiles:
                loads[s].append(t + stages * grid)
            mine.append(t)
        assert sum(map(len, loads)) == len(mine)
        taken.append(mine)
    return grid, taken


def _banks_distinct(byte_addrs, width=4):
    """Each access's ``width`` bytes land on banks no other access of the
    same instruction (or 16-byte quarter-warp phase) touches."""
    banks = [(a // 4 + i) % 32 for a in byte_addrs for i in range(width // 4)]
    return len(set(banks)) == len(banks)


def _replay(x, p, sms=132):
    """numpy replay of csrc/patch_embed.cu's bf16 map in float64 at F = 64
    H mel bins: the persistent schedule (``_schedule``); per tile the H 4-D
    TMA boxes x[b, :, t0:t0 + 32 / H, 64 h:64 h + 64] with zeros past T_in,
    laid out with the 128-byte swizzle; per thread the A fragments' 4-byte
    loads from it (rows r, r + 8; k pairs 2 (l % 4), + 8 in the (kw, kh)
    order, one channel a k16 step), the weights B[n, k] = w[k, e(n)] of the
    permuted columns; per accumulator register its (row, column); the
    epilogue's bias and LayerNorm over each row's 96 channels, 24 a lane;
    the 16-byte staging stores at token fp TPB + tp (TPB = 8 / H); the TMA
    store at (g 16 H + fp) tp_n + tp0 + tp. Also asserts that every
    fragment load and every staging store is free of bank conflicts.
    Returns the tokens."""
    B, C, T_in, Fq = x.shape
    H = Fq // 64
    FP, TPB, frames = 16 * H, 8 // H, 32 // H
    fr, t_img = p.freq_ratio, p.t_img
    tg = t_img // fr
    tp_n = tg // 4
    tblk = tp_n // TPB
    w = p.w.double().numpy()
    bias, ln_w, ln_b = (v.double().numpy() for v in (p.bias, p.ln_w, p.ln_b))
    E = w.shape[1]
    B_mat = w[:, [_col_channel(n) for n in range(E)]].T  # (N, K)
    assert [_gemm_col(_col_channel(n)) for n in range(E)] == list(range(E))
    _, taken = _schedule(B * fr * tblk, sms)
    out = np.full((B, fr * FP * tp_n, E), np.nan)
    lane = np.arange(32)
    q = lane % 4
    cc, tt, ff = np.meshgrid(np.arange(C), np.arange(frames), np.arange(Fq), indexing="ij")
    for cta_tiles in taken:
        for t in cta_tiles:
            b, rest = divmod(t, fr * tblk)
            g, tb = divmod(rest, tblk)
            tp0 = tb * TPB
            at = g * tg + 4 * tp0 + tt
            stage = np.full(C * 32 * 64, np.nan)  # bf16 elements by byte offset / 2
            vals = np.where(at < T_in, x[b, cc, np.minimum(at, T_in - 1), ff], 0.0)
            stage[_swizzle128(cc, tt, ff, H) // 2] = vals
            A = np.full((128, C * 16), np.nan)
            for wg in range(2):
                for warp in range(4):
                    for j in range(4):
                        m = 64 * wg + 16 * warp + lane // 4 + 8 * (j % 2)
                        fp, tp = _row_token(m, H)
                        tr = 4 * tp + q // 2 + 2 * (j // 2)
                        f = 4 * fp + 2 * (q % 2)
                        fl = f % 64  # the kernel's offset: half, frame row, swizzled chunk
                        off = (f // 64 * C * frames * 128 + tr * 128
                               + ((fl // 8) ^ (tr % 8)) * 16 + fl % 8 * 2)
                        assert (off == _swizzle128(0, tr, f, H)).all()
                        for c in range(C):
                            addr = c * frames * 128 + off
                            assert _banks_distinct(addr)
                            k = 16 * c + 2 * q + 8 * (j // 2)
                            A[m, k] = stage[addr // 2]
                            A[m, k + 1] = stage[addr // 2 + 1]
            assert not np.isnan(A).any()
            acc = A @ B_mat.T  # (128 rows, 96 GEMM columns)
            staging = np.full((128, E), np.nan)
            for wg in range(2):
                for warp in range(4):
                    for h in range(2):
                        m = 64 * wg + 16 * warp + lane // 4 + 8 * h
                        # registers 4 j + 2 h + i: column 8 j + 2 q + i,
                        # channel 24 q + 2 j + i
                        ii = np.array([4 * (c // 2) + 2 * h + c % 2 for c in range(24)])
                        cols = 8 * (ii[None] // 4) + 2 * q[:, None] + ii[None] % 2
                        ch = 24 * q[:, None] + np.arange(24)[None]
                        assert (np.vectorize(_col_channel)(cols) == ch).all()
                        v = acc[m[:, None], cols] + bias[ch]
                        mean = v.reshape(8, 4, 24).sum((1, 2)).repeat(4)[:, None] / E
                        var = ((v - mean) ** 2).reshape(8, 4, 24).sum((1, 2)).repeat(4)[:, None]
                        y = (v - mean) / np.sqrt(var / E + 1e-5) * ln_w[ch] + ln_b[ch]
                        fp, tp = _row_token(m, H)
                        tok = fp * TPB + tp
                        for k in range(3):
                            dst = tok * 192 + 48 * q + 16 * k
                            for quarter in range(4):
                                assert _banks_distinct(dst[8 * quarter:8 * quarter + 8], 16)
                        staging[tok[:, None], ch] = y
            assert not np.isnan(staging).any()
            fpi, tpi = np.divmod(np.arange(128), TPB)
            out[b, (g * FP + fpi) * tp_n + tp0 + tpi] = staging
    return out


@pytest.mark.parametrize("T", [1024, 1000])
def test_kernel_replay_matches_plain(rng, T):
    """The kernel's shapes (E 96, F 64, spec_size 256 x fr 4 as served; T
    1000 the 5 s trick's concat, zero-padded by TMA): the replay of its
    tiles, fragments, permuted weight columns, row order and token order
    equals the plain version in float32, conflict-free."""
    E, C = 96, 7
    w = torch.from_numpy(rng.standard_normal((C * 16, E)).astype(np.float32) * 0.1)
    vec = lambda s, o: torch.from_numpy(  # noqa: E731
        (rng.standard_normal(E) * s + o).astype(np.float32))
    p = patch_embed.PatchEmbedParams(w=w, bias=vec(0.1, 0.0), ln_w=vec(0.1, 1.0),
                                     ln_b=vec(0.1, 0.0), freq_ratio=4, t_img=1024)
    x = rng.standard_normal((1, C, T, 64)).astype(np.float32)
    got = _replay(x.astype(np.float64), p)
    ref = patch_embed.patch_embed_tokens_plain(torch.from_numpy(x), p).numpy()
    assert got.shape == ref.shape == (1, 4096, E)
    assert np.abs(got - ref).max() < 1e-4, np.abs(got - ref).max()


@pytest.mark.parametrize("B", [1, 3, 32])
def test_tile_schedule_covers_each_tile_once(B):
    """The kernel's persistent blocks at 132 SMs (two an SM) take every
    tile of B clips (32 a clip at T_img 1024) exactly once, each from the
    ring stage its load went to; at B=32 the last round is partial."""
    tiles = 32 * B
    grid, taken = _schedule(tiles, 132)
    assert grid == min(tiles, 2 * 132)
    assert sorted(t for mine in taken for t in mine) == list(range(tiles))
    assert {len(mine) for mine in taken} == ({4, 3} if B == 32 else {1})


def test_prepared_weights_take_the_kernel_k_order(rng):
    """prepare_patch_embed lays the conv kernel (E, C, kh, kw) out as w[(c 4
    + kw) 4 + kh, e], so a k pair (2i, 2i + 1) is two adjacent mel bins of
    one frame."""
    _, _, tm = _models(rng)
    p = prepare_patch_embed(tm.encoder, torch.float32)
    kern = tm.encoder.patch_embed.proj.weight.detach()
    c, kw, kh = 3, 2, 1
    assert torch.equal(p.w[(c * 4 + kw) * 4 + kh], kern[:, c, kh, kw])


def test_cpu_call_takes_the_plain_version(rng):
    _, _, tm = _models(rng)
    p = prepare_patch_embed(tm.encoder, torch.float32)
    x = torch.from_numpy(rng.standard_normal((1, 7, T_IMG, 16)).astype(np.float32))
    patch_embed.KERNEL.launches = 0
    got = patch_embed.patch_embed_tokens(x, p)
    assert torch.equal(got, patch_embed.patch_embed_tokens_plain(x, p))
    assert patch_embed.KERNEL.launches == 0 and patch_embed.KERNEL._lib is None
    with pytest.raises(ValueError, match="expected a CUDA tensor"):
        patch_embed.patch_embed_tokens(x.to("meta"), p)
    with pytest.raises(ValueError, match="frames"):
        patch_embed.patch_embed_tokens(torch.zeros(1, 7, T_IMG + 4, 16), p)
    assert patch_embed.KERNEL.launches == 0


@pytest.mark.parametrize("num_tracks,T,B", [(3, 241, 2), (1, 121, 4)])
def test_fused_forward_kernel_embed_matches_jax(rng, num_tracks, T, B):
    """htsat_fused_forward(patch_embed="kernel") against the JAX one with its
    Pallas embed in interpret mode, float32, 10 s and the 5 s concat trick
    (the embed pads T after the concat): < 5e-5; the einsum embed agrees."""
    jm, variables, tm = _models(rng, num_tracks=num_tracks, T=T)
    x = (rng.standard_normal((B, 7, T, 16)) * 0.5).astype(np.float32)
    key = tm.output_key
    ref = np.asarray(jax_fused_forward(jm, variables, jnp.asarray(x), compute_dtype=jnp.float32,
                                       interpret=True, patch_embed="kernel")[key])
    got = htsat_fused_forward(tm, torch.from_numpy(x), compute_dtype=torch.float32,
                              patch_embed="kernel")[key].numpy()
    assert got.shape == ref.shape == (B, 24 * T // 241, 15 * num_tracks)
    assert np.abs(got - ref).max() < 5e-5, np.abs(got - ref).max()
    ein = htsat_fused_forward(tm, torch.from_numpy(x), compute_dtype=torch.float32,
                              patch_embed="einsum")[key]
    assert np.abs(ein.numpy() - got).max() < 5e-5


def test_adapter_fused_forward_kernel_embed_matches_jax(rng):
    """The AdapterBit model (random adapters, K4's plain version, unfolded
    merges) with the kernel embed against the JAX adapter path with its
    Pallas embed: float32 < 5e-5."""
    jm, variables, tm = _serving_models(rng)
    x = (rng.standard_normal((2, 7, 241, 16)) * 0.5).astype(np.float32)
    ref = np.asarray(jax_fused_forward(jm, variables, jnp.asarray(x), compute_dtype=jnp.float32,
                                       interpret=True, patch_embed="kernel")["multi_accdoa"])
    got = htsat_fused_forward(tm, torch.from_numpy(x), compute_dtype=torch.float32,
                              patch_embed="kernel")["multi_accdoa"].numpy()
    assert np.abs(got - ref).max() < 5e-5, np.abs(got - ref).max()


def test_default_embed_is_the_kernel(rng):
    """The served calls' default embed is K8: on the CPU its plain version,
    bit for bit the same as patch_embed="kernel", from features and from
    the waveform, float32 and bf16."""
    _, _, tm = _models(rng)
    x = torch.from_numpy((rng.standard_normal((2, 7, 241, 16)) * 0.5).astype(np.float32))
    wav = (rng.standard_normal((2, 4, 57600)) * 0.1).astype(np.float32)
    for dtype in (torch.float32, torch.bfloat16):
        dflt = htsat_fused_forward(tm, x, compute_dtype=dtype)["multi_accdoa"]
        kern = htsat_fused_forward(tm, x, compute_dtype=dtype,
                                   patch_embed="kernel")["multi_accdoa"]
        assert torch.equal(dflt, kern)
        dflt = htsat_fused_forward_from_wav(tm, wav, compute_dtype=dtype, device="cpu",
                                            n_mels=16)["multi_accdoa"]
        kern = htsat_fused_forward_from_wav(tm, wav, compute_dtype=dtype, device="cpu",
                                            n_mels=16, patch_embed="kernel")["multi_accdoa"]
        assert torch.equal(dflt, kern)


@pytest.mark.parametrize("embed", ["einsum", "kernel"])
def test_from_wav_matches_jax_from_wav(rng, embed):
    """Serving from the waveform with each embed, float32, plain versions on
    the CPU, against the JAX from-wav path with the same embed (interpret
    mode, split3=False): < 5e-5; bf16 within the serving band 5e-2."""
    jm, variables, tm = _models(rng)
    wav = (rng.standard_normal((2, 4, 57600)) * 0.1).astype(np.float32)
    got = htsat_fused_forward_from_wav(tm, wav, compute_dtype=torch.float32, device="cpu",
                                       n_mels=16, patch_embed=embed)["multi_accdoa"].numpy()
    ref = np.asarray(jax_from_wav(jm, variables, jnp.asarray(wav), compute_dtype=jnp.float32,
                                  interpret=True, split3=False, patch_embed=embed,
                                  **FE)["multi_accdoa"])
    assert got.shape == ref.shape == (2, 24, 45)
    assert np.abs(got - ref).max() < 5e-5, np.abs(got - ref).max()
    bf = htsat_fused_forward_from_wav(tm, wav, device="cpu", n_mels=16,
                                      patch_embed=embed)["multi_accdoa"].numpy()
    assert np.abs(bf - got).max() < 5e-2


def test_other_embeds_raise(rng):
    _, _, tm = _models(rng)
    x = torch.zeros(2, 7, 241, 16)
    with pytest.raises(NotImplementedError, match="patch_embed='conv'"):
        htsat_fused_forward(tm, x, compute_dtype=torch.float32, patch_embed="conv")
    tm.encoder.patch_stride = (2, 2)
    with pytest.raises(NotImplementedError, match="4x4/4"):
        htsat_fused_forward(tm, x, compute_dtype=torch.float32, patch_embed="kernel")
