"""Kernel K8 (the HTSAT patch embed) on the CPU: its plain version against
the Pallas ``patch_embed_tokens`` in interpret mode, a numpy replay of the
kernel's block and token index map, and the HTSAT serving paths with
``patch_embed="kernel"`` (plain, 5 s trick, AdapterBit, from the waveform)
against the JAX ones on the tiny model of tests/test_serving_fused.py."""

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
        p = prepare_patch_embed(tm, dtype)
        got = patch_embed.patch_embed_tokens_plain(torch.from_numpy(x).to(dtype), p)
        assert got.shape == (2, 4 * 4 * 16, 16) and got.dtype == dtype
        ref = _jax_tokens(variables, xp, jdtype)
        if dtype == torch.float32:
            assert np.abs(got.numpy() - ref).max() < 1e-5, np.abs(got.numpy() - ref).max()
        else:
            assert _bf16_ulps(got.float().numpy(), ref) <= 2.0 ** -7


def _replay(x, p):
    """numpy replay of csrc/patch_embed.cu's index logic in float64: per
    block (b, g, 8 time patches) the gather into the (k, token) patch tile,
    the tile's tokens times the (k, E) weights, bias and LayerNorm, and the
    store at token (g 16 + fp) tp_n + tp0 + q."""
    B, C, T_in, Fq = x.shape
    fr, t_img = p.freq_ratio, p.t_img
    tg = t_img // fr
    tp_n = tg // 4
    w = p.w.double().numpy()
    out = np.zeros((B, fr * 16 * tp_n, w.shape[1]))
    c, r, f = np.meshgrid(np.arange(C), np.arange(32), np.arange(Fq), indexing="ij")
    k_idx = (c * 4 + f % 4) * 4 + r % 4
    t_idx = (f // 4) * 8 + r // 4
    for blk in range(B * fr * (tp_n // 8)):
        b, rest = divmod(blk, fr * (tp_n // 8))
        g, tb = divmod(rest, tp_n // 8)
        tp0 = tb * 8
        t = g * tg + tp0 * 4 + r
        vals = np.where(t < T_in, x[b, c, np.minimum(t, T_in - 1), f], 0.0)
        ps = np.zeros((C * 16, 128))
        ps[k_idx, t_idx] = vals
        acc = ps.T @ w + p.bias.double().numpy()
        m = acc.mean(-1, keepdims=True)
        y = (acc - m) / np.sqrt(((acc - m) ** 2).mean(-1, keepdims=True) + 1e-5)
        y = y * p.ln_w.double().numpy() + p.ln_b.double().numpy()
        tl = np.arange(128)
        out[b, (g * 16 + tl // 8) * tp_n + tp0 + tl % 8] = y
    return out


@pytest.mark.parametrize("T", [1024, 1000])
def test_kernel_replay_matches_plain(rng, T):
    """The kernel's shapes (E 96, F 64, spec_size 256 x fr 4 as served; T
    1000 the 5 s trick's concat, zero-padded in the kernel): the replay of
    its tiles and token order equals the plain version in float32."""
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


def test_cpu_call_takes_the_plain_version(rng):
    _, _, tm = _models(rng)
    p = prepare_patch_embed(tm, torch.float32)
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
    ein = htsat_fused_forward(tm, torch.from_numpy(x), compute_dtype=torch.float32)[key]
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
