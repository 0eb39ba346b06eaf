"""The served paths at mel widths over 64 on the CPU: kernel K8 (the HTSAT
patch embed) at 128 and 256 mel bins, its plain version against the Pallas
``patch_embed_tokens`` in interpret mode and a numpy replay of the kernel's
halves, tiles, fragment loads and token order; PaSST served from the
waveform at 128 mels, and HTSAT (freq_ratio 2) and PaSST at twice their tiny
mel widths through ``SELDTask``'s eval step (from the waveform, the eval
ScalarBN folded into the frontend), against the JAX package on the same
weights."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pseldnets_tpu.models import heads as jax_heads
from pseldnets_tpu.ops.pallas.patch_embed import patch_embed_tokens as jax_patch_embed
from pseldnets_tpu.serving import passt_fused_forward_from_wav as jax_passt_from_wav
from pseldnets_tpu_torch.models import heads
from pseldnets_tpu_torch.ops import patch_embed
from pseldnets_tpu_torch.serving import passt_fused_forward_from_wav
from pseldnets_tpu_torch.train.checkpoint import load_jax_variables
import torch_threads  # noqa: F401  (each xdist worker's share of the cores)
from test_torch_eval import HTSAT, PASST, _max_diff, _pair, _wav
from test_torch_passt import WAV_ENC
from test_torch_patch_embed import _replay
from test_torch_swin_block import randomize

E, C = 96, 7
# F -> freq_ratio at HTSAT's spec_size 256
RATIO = {64: 4, 128: 2, 256: 1}


@pytest.fixture
def rng():
    """A fresh generator for each test: each test's data is fixed, whatever
    ran before it on the same worker."""
    return np.random.default_rng(125)


def _params(rng, F, dtype):
    """Random conv (HWIO: kh along frequency, kw along time), bias and
    LayerNorm of E channels, as the JAX kernel takes them and as
    ``PatchEmbedParams`` (w[(c 4 + kw) 4 + kh, e], ops/patch_embed.py)."""
    kern = (rng.standard_normal((4, 4, C, E)) * 0.1).astype(np.float32)
    bias, ln_w, ln_b = ((rng.standard_normal(E) * 0.1 + o).astype(np.float32) for o in (0, 1, 0))
    w = torch.from_numpy(np.ascontiguousarray(kern.transpose(2, 1, 0, 3).reshape(C * 16, E)))
    fr = RATIO[F]
    p = patch_embed.PatchEmbedParams(w=w.to(dtype), bias=torch.from_numpy(bias),
                                     ln_w=torch.from_numpy(ln_w), ln_b=torch.from_numpy(ln_b),
                                     freq_ratio=fr, t_img=256 * fr)
    return (kern, bias, ln_w, ln_b), p


@pytest.mark.parametrize("F", [128, 256])
def test_k8_plain_matches_pallas_at_wide_mels(rng, F):
    """K8's plain version at 128 and 256 mel bins (HTSAT spec_size 256 at
    freq_ratio 2 and 1, 4096 tokens) against the Pallas kernel in interpret
    mode: float32 < 1e-5 (summation order only), bf16 within one bf16 ulp
    (2^-7 of max(|x|, 1): the same bf16 operands, float32 sums, one
    rounding), as at 64 bins (test_torch_patch_embed.py)."""
    fr = RATIO[F]
    x = (rng.standard_normal((1, C, 256 * fr, F)) * 0.5).astype(np.float32)
    for dtype, jdtype in ((torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)):
        jp, p = _params(np.random.default_rng(F), F, dtype)
        got = patch_embed.patch_embed_tokens_plain(torch.from_numpy(x).to(dtype), p)
        ref = np.asarray(jax_patch_embed(jnp.asarray(x).astype(jdtype), *map(jnp.asarray, jp),
                                         spec_size=256, freq_ratio=fr, compute_dtype=jdtype,
                                         interpret=True).astype(jnp.float32))
        assert got.shape == ref.shape == (1, 4096, E) and got.dtype == dtype
        got = got.float().numpy()
        if dtype == torch.float32:
            assert np.abs(got - ref).max() < 1e-5, np.abs(got - ref).max()
        else:
            assert (np.abs(got - ref) / np.maximum(np.abs(ref), 1.0)).max() <= 2.0 ** -7


@pytest.mark.parametrize("F,T", [(128, 512), (128, 501), (256, 256), (256, 251)])
def test_k8_replay_matches_plain_at_wide_mels(rng, F, T):
    """The kernel's map at 128 and 256 bins (HTSAT spec_size 256 at
    freq_ratio 2 and 1; T short of the image: TMA's zero pad) replayed in
    numpy (test_torch_patch_embed.py ``_replay``: the H boxes of 64 bins a
    tile, the token map per H, every load and staging store free of bank
    conflicts) equals the plain version in float32."""
    _, p = _params(rng, F, torch.float32)
    x = rng.standard_normal((1, C, T, F)).astype(np.float32)
    got = _replay(x.astype(np.float64), p)
    ref = patch_embed.patch_embed_tokens_plain(torch.from_numpy(x), p).numpy()
    assert got.shape == ref.shape == (1, 4096, E)
    assert np.abs(got - ref).max() < 1e-4, np.abs(got - ref).max()


def test_k8_takes_the_wide_widths_and_refuses_the_rest(rng):
    """The kernel's shape check (run on the card before any launch) takes
    128 and 256 bins at HTSAT's geometry, bf16 and float32, and refuses 32
    bins, another embed width and bf16 with 4 channels; a CPU tensor never
    reaches it (the plain version runs) and a meta one is refused as not on
    the card."""
    for F in (128, 256):
        for dtype in (torch.bfloat16, torch.float32):
            _, p = _params(rng, F, dtype)
            patch_embed.check_kernel_shape(C, F, p)
            x = torch.zeros(1, C, p.t_img, F, dtype=dtype)
            assert patch_embed.patch_embed_tokens(x, p).shape == (1, 4096, E)
            with pytest.raises(ValueError, match="expected a CUDA tensor"):
                patch_embed.patch_embed_tokens(x.to("meta"), p)
    _, p = _params(rng, 128, torch.bfloat16)
    for C_, F, change in ((C, 32, {}), (C, 128, dict(w=p.w[:, :64])), (4, 128, dict(w=p.w[:64]))):
        q = patch_embed.PatchEmbedParams(**{**p.__dict__, **change})
        with pytest.raises(NotImplementedError, match="patch-embed kernel takes"):
            patch_embed.check_kernel_shape(C_, F, q)


def _passt_models(rng, enc):
    """tests/test_torch_passt.py's tiny PaSST pair at encoder ``enc`` (its
    img_size giving the mel bins), the JAX init jitted: seeded random
    weights and eval ScalarBN statistics, the port's through the bridge."""
    mel, T = enc["img_size"]
    kw = dict(num_classes=5, in_channels=7, mel_bins=mel, num_tracks=3)
    jm = jax_heads.PASST(encoder_kwargs=tuple(enc.items()), **kw)
    v = jax.jit(lambda r, x: jm.init({"params": r}, x, train=False))(
        jax.random.PRNGKey(0), jnp.zeros((2, 7, T, mel)))
    variables = {"params": randomize(v["params"], rng),
                 "batch_stats": {"scalar": {"bn": {
                     "running_mean": (rng.standard_normal((7, mel)) * 0.5).astype(np.float32),
                     "running_var": (rng.random((7, mel)) + 0.5).astype(np.float32)}}}}
    tm = heads.PASST(encoder_kwargs=enc, **kw)
    load_jax_variables(tm, variables)
    return jm, variables, tm.eval()


def test_passt_served_at_128_mels_matches_jax(rng):
    """A tiny PaSST at 128 mels (img_size (128, 101): 12 x 10 patches + 2
    tokens) served from the waveform, float32, plain versions on the CPU,
    against the JAX from-wav path in interpret mode: < 5e-5, the 64-mel
    from-wav bound (test_torch_passt.py)."""
    jm, variables, tm = _passt_models(rng, dict(WAV_ENC, img_size=(128, 101)))
    wav = (rng.standard_normal((2, 4, 24000)) * 0.1).astype(np.float32)
    got = passt_fused_forward_from_wav(tm, wav, compute_dtype=torch.float32, device="cpu",
                                       n_mels=128)["multi_accdoa"].numpy()
    ref = np.asarray(jax_passt_from_wav(jm, variables, jnp.asarray(wav),
                                        compute_dtype=jnp.float32, interpret=True, split3=False,
                                        n_mels=128)["multi_accdoa"])
    assert got.shape == ref.shape == (2, 10, 45)
    assert np.abs(got - ref).max() < 5e-5, np.abs(got - ref).max()


def _widen(over, **values):
    """``over`` with each ``data.<key>=`` entry set to ``values[key]``."""
    out = [o for o in over if not any(o.startswith(f"data.{k}=") for k in values)]
    return out + [f"data.{k}={v}" for k, v in values.items()]


# twice the tiny mel widths of tests/test_torch_eval.py: HTSAT at freq_ratio
# 2 (hop 800: 81 frames of the 128-frame image, 40 label frames), from the
# waveform through K1 (n_fft 1024) and K9 with its folds (n_fft 2048);
# PaSST at 32 mels (img_size (32, 201))
WIDE_ROUTES = {
    "htsat": (_widen(HTSAT, n_mels=32, hoplen=800), "htsat"),
    "htsat_nfft2048": (_widen(HTSAT, n_mels=32, hoplen=800, nfft=2048), "htsat"),
    "passt": ([o for o in _widen(PASST, n_mels=32) if "img_size" not in o]
              + ["model.kwargs.img_size=[32,201]"], "passt"),
}


@pytest.mark.parametrize("name", list(WIDE_ROUTES))
def test_eval_step_at_twice_the_mel_width_matches_jax(name):
    """``SELDTask.eval_step`` at twice the tiny mel width: an odd batch of 3
    4 s clips from the waveform (the eval ScalarBN folded into the
    frontend: K1's, or K9's at n_fft 2048, plain version; then K8's or K6's
    plain version) against the JAX eval step on the same weights and
    statistics: < 5e-5 in float32, the 64-mel eval bound
    (test_torch_eval.py)."""
    over, route = WIDE_ROUTES[name]
    task_j, state, task, _ = _pair(over)
    assert task.eval_route() == route and task.extractor.n_mels == 32
    x = _wav(3, 64000)
    assert task._folds_from_wav(torch.from_numpy(x))
    got = task.eval_step({"data": x})
    want = task_j.eval_step(state, {"data": x})
    err = _max_diff(got, want)
    assert err < 5e-5, (name, err)

