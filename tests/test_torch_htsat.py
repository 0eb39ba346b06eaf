"""The port's HTSAT mACCDOA/ACCDOA model and serving path against the JAX
package, tiny configuration (tests/test_serving_fused.py:13), f32, weights
moved across by the bridge."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pseldnets_tpu.models import heads as jax_heads
from pseldnets_tpu.ops.pallas.frontend import fused_logmel_iv as jax_fused
from pseldnets_tpu.serving import htsat_fused_forward as jax_fused_forward
from pseldnets_tpu.serving import htsat_fused_forward_from_wav as jax_from_wav
from pseldnets_tpu_torch.models import heads
from pseldnets_tpu_torch.models.adapters import AdaptConfig
from pseldnets_tpu_torch.ops import frontend, swin_block, swin_stage
from pseldnets_tpu_torch.serving import (htsat_fused_forward,
                                         htsat_fused_forward_from_wav, prepare_stages)
from pseldnets_tpu_torch.train.checkpoint import load_jax_variables
import torch_threads  # noqa: F401  (each xdist worker's share of the cores)
from test_torch_swin_block import randomize

ENC = dict(spec_size=64, patch_size=4, patch_stride=(4, 4), embed_dim=16,
           depths=(2, 2), num_heads=(2, 4), window_size=4, mlp_ratio=2.0)
FE = dict(n_mels=16, t_blk=32)


def _models(rng, num_tracks=3, T=241):
    jm = jax_heads.HTSAT(num_classes=5, in_channels=7, mel_bins=16,
                         num_tracks=num_tracks, tgt_output_frames=24,
                         encoder_kwargs=tuple(ENC.items()) + (("drop_path_rate", 0.0),))
    x = jnp.zeros((2, 7, T, 16), jnp.float32)
    v = jm.init({"params": jax.random.PRNGKey(0)}, x, train=False)
    variables = {"params": randomize(v["params"], rng),
                 "batch_stats": {"scalar": {"bn": {
                     "running_mean": (rng.standard_normal((7, 16)) * 0.5).astype(np.float32),
                     "running_var": (rng.random((7, 16)) + 0.5).astype(np.float32)}}}}
    tm = heads.HTSAT(num_classes=5, in_channels=7, mel_bins=16, num_tracks=num_tracks,
                     tgt_output_frames=24, encoder_kwargs=ENC)
    load_jax_variables(tm, variables)
    return jm, variables, tm.eval()


def test_htsat_forward_matches_flax_10s(rng):
    jm, variables, tm = _models(rng)
    x = (rng.standard_normal((2, 7, 241, 16)) * 0.5).astype(np.float32)
    ref = np.asarray(jm.apply(variables, jnp.asarray(x), train=False)["multi_accdoa"])
    with torch.no_grad():
        got = tm(torch.from_numpy(x))["multi_accdoa"].numpy()
    assert got.shape == ref.shape == (2, 24, 45)
    # f32 through 4 blocks, 2 merges, conv head: summation order only
    assert np.abs(got - ref).max() < 5e-5, np.abs(got - ref).max()
    fused = htsat_fused_forward(tm, torch.from_numpy(x), compute_dtype=torch.float32,
                                patch_embed="einsum")
    assert np.abs(fused["multi_accdoa"].numpy() - ref).max() < 5e-5


def test_htsat_forward_matches_flax_5s_trick(rng):
    """5 s clips: batch halves concatenated in time for the encoder and split
    back (accdoa.py:211-240), ACCDOA head."""
    jm, variables, tm = _models(rng, num_tracks=1, T=121)
    x = (rng.standard_normal((4, 7, 121, 16)) * 0.5).astype(np.float32)
    ref = np.asarray(jm.apply(variables, jnp.asarray(x), train=False)["accdoa"])
    with torch.no_grad():
        got = tm(torch.from_numpy(x))["accdoa"].numpy()
    assert got.shape == ref.shape == (4, 12, 15)
    assert np.abs(got - ref).max() < 5e-5, np.abs(got - ref).max()
    fused = htsat_fused_forward(tm, torch.from_numpy(x), compute_dtype=torch.float32,
                                patch_embed="einsum")
    ref_fused = np.asarray(jax_fused_forward(jm, variables, jnp.asarray(x),
                                             compute_dtype=jnp.float32, interpret=True,
                                             patch_embed="einsum")["accdoa"])
    assert np.abs(fused["accdoa"].numpy() - ref_fused).max() < 5e-5


def test_from_wav_matches_jax_from_wav(rng):
    """The whole serving path from the waveform, f32, plain branches on the
    CPU, against the JAX one in interpret mode: frontend (split3=False),
    folded ScalarBN, frame pad, fused blocks with merge folds, head - bound
    5e-5 (test_serving_fused.py:412). The JAX default split3=True (bf16x3
    DFT emulation, 8e-4 dB feature budget) stays within 5e-3."""
    jm, variables, tm = _models(rng)
    wav = (rng.standard_normal((2, 4, 57600)) * 0.1).astype(np.float32)
    frontend.KERNEL.launches = swin_block.KERNEL.launches = 0
    got = htsat_fused_forward_from_wav(tm, wav, compute_dtype=torch.float32, device="cpu",
                                       n_mels=16, patch_embed="einsum")["multi_accdoa"].numpy()
    # CPU tensors take the plain versions: no kernel launch is counted
    assert frontend.KERNEL.launches == swin_block.KERNEL.launches == 0
    ref = np.asarray(jax_from_wav(jm, variables, jnp.asarray(wav),
                                  compute_dtype=jnp.float32, interpret=True,
                                  split3=False, patch_embed="einsum", **FE)["multi_accdoa"])
    assert got.shape == ref.shape == (2, 24, 45)
    assert np.abs(got - ref).max() < 5e-5, np.abs(got - ref).max()
    ref3 = np.asarray(jax_from_wav(jm, variables, jnp.asarray(wav),
                                   compute_dtype=jnp.float32, interpret=True,
                                   split3=True, patch_embed="einsum", **FE)["multi_accdoa"])
    assert np.abs(got - ref3).max() < 5e-3, np.abs(got - ref3).max()
    # and the eager model on the plain features agrees with the fused path
    feats = jax_fused(jnp.asarray(wav), split3=False, interpret=True, **FE)
    with torch.no_grad():
        eager = tm(torch.from_numpy(np.array(feats)))["multi_accdoa"].numpy()
    assert np.abs(got - eager).max() < 5e-5


def test_from_wav_bf16_within_band(rng):
    """bf16 compute on the plain branches against f32: the serving band the
    JAX package holds its bf16 paths to (5e-2)."""
    _, _, tm = _models(rng)
    wav = (rng.standard_normal((2, 4, 57600)) * 0.1).astype(np.float32)
    f32 = htsat_fused_forward_from_wav(tm, wav, compute_dtype=torch.float32,
                                       device="cpu", n_mels=16)["multi_accdoa"]
    bf = htsat_fused_forward_from_wav(tm, wav, device="cpu", n_mels=16)["multi_accdoa"]
    assert bf.dtype == torch.float32 and torch.isfinite(bf).all()
    assert (bf - f32).abs().max() < 5e-2, (bf - f32).abs().max()


def test_from_wav_stage_path_matches_jax_from_wav():
    """swin="stage": each stage in one call of K11's plain version, the
    merges unfolded, f32 on the CPU, against the JAX from-wav path
    (interpret, split3=False, per-block kernels with merge folds) and the
    port's swin="block" path - summation order only, bound 5e-5."""
    rng = np.random.default_rng(70)
    jm, variables, tm = _models(rng)
    wav = (rng.standard_normal((2, 4, 57600)) * 0.1).astype(np.float32)
    stages = prepare_stages(tm.encoder, torch.float32)
    assert [sp.shifts for sp in stages] == [(0, 2), (0, 2)]
    frontend.KERNEL.launches = swin_block.KERNEL.launches = swin_stage.KERNEL.launches = 0
    got = htsat_fused_forward_from_wav(tm, wav, compute_dtype=torch.float32, device="cpu",
                                       n_mels=16, swin="stage", stages=stages,
                                       patch_embed="einsum")["multi_accdoa"].numpy()
    assert frontend.KERNEL.launches == swin_block.KERNEL.launches == 0
    assert swin_stage.KERNEL.launches == 0
    ref = np.asarray(jax_from_wav(jm, variables, jnp.asarray(wav),
                                  compute_dtype=jnp.float32, interpret=True,
                                  split3=False, patch_embed="einsum", **FE)["multi_accdoa"])
    assert got.shape == ref.shape == (2, 24, 45)
    assert np.abs(got - ref).max() < 5e-5, np.abs(got - ref).max()
    block = htsat_fused_forward_from_wav(tm, wav, compute_dtype=torch.float32, device="cpu",
                                         n_mels=16, patch_embed="einsum")["multi_accdoa"].numpy()
    assert np.abs(got - block).max() < 5e-5, np.abs(got - block).max()


def test_stage_path_5s_trick():
    """5 s clips through htsat_fused_forward(..., swin="stage"): the batch
    halves concatenated in time before the embed, against the JAX fused
    forward (interpret) and the port's block path, f32, 5e-5."""
    rng = np.random.default_rng(71)
    jm, variables, tm = _models(rng, num_tracks=1, T=121)
    x = (rng.standard_normal((4, 7, 121, 16)) * 0.5).astype(np.float32)
    got = htsat_fused_forward(tm, torch.from_numpy(x), compute_dtype=torch.float32,
                              swin="stage", patch_embed="einsum")["accdoa"].numpy()
    ref = np.asarray(jax_fused_forward(jm, variables, jnp.asarray(x), compute_dtype=jnp.float32,
                                       interpret=True, patch_embed="einsum")["accdoa"])
    assert got.shape == ref.shape == (4, 12, 15)
    assert np.abs(got - ref).max() < 5e-5, np.abs(got - ref).max()
    block = htsat_fused_forward(tm, torch.from_numpy(x), compute_dtype=torch.float32,
                                patch_embed="einsum")
    assert np.abs(got - block["accdoa"].numpy()).max() < 5e-5


def test_stage_path_raises_on_adapters_and_unknown_values():
    """The stage kernels have no adapters: an AdapterBit model with
    swin="stage" raises, as does prepare_stages on it; an unknown swin value
    raises as an unknown patch_embed does."""
    adapt = AdaptConfig({"method": "adapter",
                         "adapt_kwargs": {"position": ["MlpAdapter", "SpatialAdapter"],
                                          "type": "adapter", "mlp_ratio": 0.5,
                                          "adapter_scalar": 0.1, "act_layer": "gelu"}})
    am = heads.HTSAT(num_classes=5, in_channels=7, mel_bins=16, num_tracks=3,
                     tgt_output_frames=24, encoder_kwargs=ENC, adapt=adapt).eval()
    x = torch.zeros(2, 7, 241, 16)
    with pytest.raises(NotImplementedError, match="adapters"):
        htsat_fused_forward(am, x, compute_dtype=torch.float32, swin="stage")
    with pytest.raises(NotImplementedError, match="adapters"):
        prepare_stages(am.encoder, torch.float32)
    _, _, tm = _models(np.random.default_rng(72))
    with pytest.raises(NotImplementedError, match="swin="):
        htsat_fused_forward(tm, x, compute_dtype=torch.float32, swin="window")
    with pytest.raises(NotImplementedError, match="swin="):
        htsat_fused_forward_from_wav(tm, np.zeros((2, 4, 57600), np.float32), device="cpu",
                                     n_mels=16, swin="stages")
