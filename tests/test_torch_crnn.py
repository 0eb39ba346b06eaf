"""The port's CRNN (CNN8/CNN12 trunk + GRU/conformer/transformer/no decoder)
ACCDOA/mACCDOA model, the plain version of its ConvBlock kernel K7 and its
serving path against the JAX package at tiny sizes (tests/test_conv_block.py,
tests/test_serving_fused.py:342-480), weights moved across by the bridge; the
JAX Pallas kernels run in interpret mode."""

from pathlib import Path

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from pseldnets_tpu.models import heads as jax_heads
from pseldnets_tpu.ops.pallas.conv_block import conv3x3_bias_relu as jax_conv_block
from pseldnets_tpu.serving import crnn_fused_forward as jax_fused_forward
from pseldnets_tpu.serving import crnn_fused_forward_from_wav as jax_from_wav
from pseldnets_tpu.train.checkpoint import flax_to_torch_key as jax_key
from pseldnets_tpu_torch.config import compose
from pseldnets_tpu_torch.models import build_model, heads
from pseldnets_tpu_torch.models.common import DropoutDraws
from pseldnets_tpu_torch.ops import conv_block, frontend
from pseldnets_tpu_torch.serving import (crnn_fused_forward, crnn_fused_forward_from_wav,
                                         prepare_crnn)
from pseldnets_tpu_torch.train.checkpoint import (_flatten, flax_to_torch_key,
                                                  jax_to_torch_state_dict, load_jax_variables)
import torch_threads  # noqa: F401  (each xdist worker's share of the cores)
from test_torch_passt import recorded_jax_draws
from test_torch_swin_block import randomize

CONFIGS = str(Path(__file__).resolve().parents[1] / "configs")
FEATS = (8, 16, 16, 24)  # CNN8
CRNN_OVERRIDES = ["model=crnn", "loss=accdoa", "model.kwargs.pretrained_path=null",
                  "model.kwargs.audioset_pretrain=false"]


def _layers(decoder):
    return 2 if decoder in ("gru", "transformer") else 1


def _random_stats(tree, rng):
    """Non-trivial eval BatchNorm statistics for every BN of a flax tree."""
    out = {}
    for k, v in tree.items():
        if hasattr(v, "items"):
            out[k] = _random_stats(v, rng)
        elif k == "running_mean":
            out[k] = (0.3 * rng.standard_normal(np.shape(v))).astype(np.float32)
        else:
            out[k] = (rng.random(np.shape(v)) + 0.5).astype(np.float32)
    return out


def _models(rng, decoder="conformer", num_tracks=1, mel=16, T=80, dtype=jnp.float32):
    """A tiny JAX heads.CRNN (CNN8 (8, 16, 16, 24)) with seeded random
    weights and BN statistics, and the port's model with the same weights
    through the bridge."""
    kw = dict(num_classes=4, in_channels=7, encoder="CNN8", num_features=FEATS,
              decoder=decoder, num_decoder_layers=_layers(decoder), mel_bins=mel, pred_res=10,
              num_tracks=num_tracks)
    jm = jax_heads.CRNN(dtype=dtype, **kw)
    v = jm.init({"params": jax.random.PRNGKey(0)}, jnp.zeros((1, 7, T, mel)), train=False)
    variables = {"params": randomize(flax.core.unfreeze(v["params"]), rng),
                 "batch_stats": _random_stats(flax.core.unfreeze(v["batch_stats"]), rng)}
    tm = heads.CRNN(**kw)
    load_jax_variables(tm, variables)
    return jm, variables, tm.eval()


def _feats(rng, B=2, T=80, mel=16):
    return (rng.standard_normal((B, 7, T, mel)) * 0.5).astype(np.float32)


# --- K7's plain version against the Pallas kernel ----------------------------

def _conv_inputs(rng, Ci, Cm=16, Co=24):
    B, T, F = 2, 12, 8
    x = rng.standard_normal((B, T, F, Ci)).astype(np.float32)
    w1 = rng.normal(0, 0.2, (3, 3, Ci, Cm)).astype(np.float32)
    b1 = rng.normal(0, 0.5, (Cm,)).astype(np.float32)  # large: a wrong edge halo shows
    w2 = rng.normal(0, 0.2, (3, 3, Cm, Co)).astype(np.float32)
    b2 = rng.normal(0, 0.2, (Co,)).astype(np.float32)
    return x, w1, b1, w2, b2


def _conv_args(mode, x, w1, b1, w2, b2):
    if mode == "single":
        return x, w1, b1, None, None
    if mode == "pair":
        return x, w1, b1, w2, b2
    raw = jax.lax.conv_general_dilated(
        jnp.asarray(x), jnp.asarray(w1), window_strides=(1, 1), padding=((1, 1), (1, 1)),
        dimension_numbers=("NHWC", "HWIO", "NHWC"), preferred_element_type=jnp.float32)
    return np.asarray(raw), None, b1, w2, b2


@pytest.mark.parametrize("t_blk", [4, 12])
@pytest.mark.parametrize("mode,Ci", [("single", 5), ("pair", 5), ("relu_conv", 7)])
def test_conv_block_plain_matches_pallas_f32(rng, mode, Ci, t_blk):
    """conv3x3_bias_relu_plain against the Pallas conv3x3_bias_relu
    (interpret mode) in float32, in each mode, at test_conv_block.py's
    shapes, both t_blk chunkings: < 5e-5 (summation order only)."""
    args = _conv_args(mode, *_conv_inputs(rng, Ci))
    ref = np.asarray(jax_conv_block(*(None if a is None else jnp.asarray(a) for a in args),
                                    t_blk=t_blk, compute_dtype=jnp.float32, interpret=True))
    got = conv_block.conv3x3_bias_relu_plain(
        *(None if a is None else torch.from_numpy(np.array(a)) for a in args),
        compute_dtype=torch.float32).numpy()
    assert got.shape == ref.shape
    assert np.abs(got - ref).max() < 5e-5, np.abs(got - ref).max()


def test_conv_block_stem_forms_agree_in_float32(rng):
    """The served stem (the pair on Cin = 7, zero-padded to 8) equals the
    JAX "pallas" stem split (raw conv1, then relu_conv) in float32: < 5e-5.
    In bf16 they differ where the split rounds the raw conv1 output."""
    x, w1, b1, w2, b2 = _conv_inputs(rng, 7)
    t = lambda a: torch.from_numpy(np.array(a))  # noqa: E731
    assert conv_block.padded_channels(7) == 8 and conv_block.padded_channels(64) == 64
    xp, w1p = F.pad(t(x), (0, 1)), F.pad(t(w1), (0, 0, 0, 1))
    pair = conv_block.conv3x3_bias_relu_plain(xp, w1p, t(b1), t(w2), t(b2),
                                              compute_dtype=torch.float32)
    split = conv_block.conv3x3_bias_relu_plain(*(None if a is None else t(a) for a in
                                                 _conv_args("relu_conv", x, w1, b1, w2, b2)),
                                               compute_dtype=torch.float32)
    assert (pair - split).abs().max().item() < 5e-5
    # bf16: the mid rounded once, the output in bf16
    got = conv_block.conv3x3_bias_relu_plain(xp, w1p, t(b1), t(w2), t(b2))
    assert got.dtype == torch.bfloat16
    assert (got.float() - pair).abs().max().item() < 2.0 ** -6 * pair.abs().max().item()


def test_conv_block_wrapper_routes_and_raises(rng):
    """On a CPU tensor the wrapper takes the plain version and launches
    nothing; a tensor that is neither on the CPU nor on the card is refused,
    as are unsupported dtypes, before anything is built."""
    x, w1, b1, w2, b2 = (torch.from_numpy(a) for a in _conv_inputs(rng, 16))
    conv_block.KERNEL.launches = 0
    got = conv_block.conv3x3_bias_relu(x, w1, b1, w2, b2, compute_dtype=torch.float32)
    ref = conv_block.conv3x3_bias_relu_plain(x, w1, b1, w2, b2, compute_dtype=torch.float32)
    assert torch.equal(got, ref)
    meta = lambda t: t.to("meta")  # noqa: E731
    with pytest.raises(ValueError, match="expected a CUDA tensor"):
        conv_block.conv3x3_bias_relu(meta(x).bfloat16(), meta(w1).bfloat16(), meta(b1),
                                     meta(w2).bfloat16(), meta(b2))
    with pytest.raises(NotImplementedError, match="computes in bf16"):
        conv_block.conv3x3_bias_relu(meta(x), meta(w1), meta(b1), compute_dtype=torch.float32)
    with pytest.raises(ValueError, match="needs w2"):
        conv_block.conv3x3_bias_relu(x, None, b1)
    assert conv_block.KERNEL.launches == 0 and conv_block.KERNEL._lib is None


# --- the eager model and the bridge ------------------------------------------

@pytest.mark.parametrize("num_tracks", [1, 3])
@pytest.mark.parametrize("decoder", ["conformer", "gru", None, "transformer"])
def test_eager_crnn_matches_flax(rng, decoder, num_tracks):
    """The eager CRNN (CNN8, mel 16, T = 80) against flax model.apply
    (train=False) in float32 with each decoder: < 5e-5."""
    jm, variables, tm = _models(rng, decoder, num_tracks)
    x = _feats(rng)
    ref = np.asarray(jm.apply(variables, jnp.asarray(x), train=False)[tm.output_key])
    with torch.no_grad():
        got = tm(torch.from_numpy(x))[tm.output_key].numpy()
    assert got.shape == ref.shape == (2, 8, 12 * num_tracks)
    assert np.abs(got - ref).max() < 5e-5, np.abs(got - ref).max()


@pytest.mark.parametrize("decoder", ["conformer", "gru", "transformer"])
def test_bridge_maps_crnn_trees_both_ways(rng, decoder):
    """Every leaf of the CRNN trees maps with the JAX package's key map onto
    the reference's torch keys and layouts; the bridge is strict both ways
    and raises on an unmapped leaf."""
    _, variables, tm = _models(rng, decoder)
    sd = jax_to_torch_state_dict(variables, tm)
    assert set(sd) == set(tm.state_dict())
    for coll in ("params", "batch_stats"):
        for path in _flatten(variables[coll]):
            if "self_attn" not in path:  # packed by the bridge, not by key
                assert flax_to_torch_key(path) == jax_key(path), path
    assert sd["convs.conv_block1.conv1.weight"].shape == (8, 7, 3, 3)
    assert sd["convs.conv_block4.bn2.running_var"].shape == (24,)
    assert sd["scalar.running_mean"].shape == (7, 16) and sd["fc.weight"].shape == (12, 24)
    if decoder == "conformer":
        pre = "decoder.layers.0.sequential."
        assert sd[pre + "2.module.sequential.4.conv.weight"].shape == (24, 1, 31)
        assert sd[pre + "2.module.sequential.2.conv.weight"].shape == (48, 24, 1)
        assert sd[pre + "2.module.sequential.7.conv.weight"].shape == (24, 24, 1)
        assert sd[pre + "2.module.sequential.5.running_mean"].shape == (24,)
        assert sd[pre + "1.module.attention.u_bias"].shape == (8, 3)
        assert sd[pre + "1.module.attention.pos_proj.weight"].shape == (24, 24)
        assert sd[pre + "0.module.sequential.1.weight"].shape == (96, 24)
        assert sd[pre + "4.weight"].shape == (24,)
    elif decoder == "gru":
        assert sd["decoder.decoder.weight_ih_l0"].shape == (36, 24)
        assert sd["decoder.decoder.weight_hh_l1_reverse"].shape == (36, 12)
    else:
        pre = "decoder.decoder.layers.1."
        assert sd[pre + "self_attn.in_proj_weight"].shape == (72, 24)
        assert sd[pre + "self_attn.in_proj_bias"].shape == (72,)
        assert sd[pre + "self_attn.out_proj.weight"].shape == (24, 24)
        assert sd[pre + "linear1.weight"].shape == (2048, 24)
    params = variables["params"]
    extra = dict(variables, params=dict(params, stray={"kernel": np.zeros((2, 2))}))
    with pytest.raises(KeyError, match="stray"):
        jax_to_torch_state_dict(extra, tm)
    short = dict(variables, params={k: v for k, v in params.items() if k != "fc"})
    with pytest.raises(KeyError, match="fc"):
        jax_to_torch_state_dict(short, tm)


def test_full_size_parameter_count_matches_flax():
    """configs/model/crnn.yaml (CNN12 64..2048, one conformer layer at 2048):
    the port's parameter count, on the meta device, equals flax's from
    jax.eval_shape; nothing of the ~176 M parameters is allocated."""
    cfg = compose(CONFIGS, "train", CRNN_OVERRIDES)
    kw = dict(num_classes=13, in_channels=7, encoder="CNN12",
              num_features=tuple(cfg["model"]["kwargs"]["num_features"]),
              decoder=cfg["model"]["decoder"],
              num_decoder_layers=cfg["model"]["num_decoder_layers"], mel_bins=64, pred_res=10)
    with torch.device("meta"):
        tm = heads.CRNN(**kw)
    n_port = sum(p.numel() for p in tm.parameters())
    n_buf = sum(b.numel() for b in tm.buffers())
    jm = jax_heads.CRNN(**kw)
    shapes = jax.eval_shape(lambda: jm.init({"params": jax.random.PRNGKey(0)},
                                            jnp.zeros((1, 7, 1001, 64)), train=False))
    count = lambda t: sum(int(np.prod(x.shape)) for x in jax.tree_util.tree_leaves(t))  # noqa: E731
    assert n_port == count(shapes["params"]) and n_buf == count(shapes["batch_stats"])
    assert 170e6 < n_port < 180e6
    assert tm.convs.conv_block6.conv2.weight.shape == (2048, 2048, 3, 3)


def test_crnn_from_configs_builds_and_is_seeded():
    """The factory's CRNN branch: configs/model/default.yaml (CNN8 + GRU)
    builds on the CPU with seeded weights (the same seed gives the same
    weights; the conformer's u/v biases are drawn too), and the encoder /
    num_features mismatch raises ValueError."""
    cfg = compose(CONFIGS, "train", ["model=default", "loss=accdoa"])
    m1, meta = build_model(cfg, 13, device="cpu", seed=3)
    m2, _ = build_model(cfg, 13, device="cpu", seed=3)
    assert meta["backbone"] == "CRNN" and m1.decoder_kind == "gru" and not m1.training
    for (k, a), b in zip(m1.state_dict().items(), m2.state_dict().values()):
        assert torch.equal(a, b), k
    assert m1.decoder.decoder.weight_ih_l0.std().item() > 0.05
    cc = heads.ConvConformer(num_classes=3, num_features=FEATS, mel_bins=16,
                             num_decoder_layers=1)
    from pseldnets_tpu_torch.models.factory import init_weights

    init_weights(cc, torch.Generator().manual_seed(0))
    att = cc.decoder.layers[0].sequential[1].module.attention
    assert att.u_bias.abs().max().item() > 0 and not torch.equal(att.u_bias, att.v_bias)
    with pytest.raises(ValueError, match="CNN12 expects 6"):
        heads.CRNN(num_classes=3, encoder="CNN12", num_features=FEATS)


def _bernoulli_masks(rec):
    """The dropout draws a JAX forward recorded (``recorded_jax_draws``), in
    call order, as the port's injected keep-masks."""
    return [torch.from_numpy(np.array(v)) for name, v in rec if name == "bernoulli"]


def _check_train_forward(rng, decoder, n_masks):
    """The CRNN with ``decoder`` at its dropout 0.1 in train mode (the
    trunk's and the conformer's BatchNorms on batch statistics) against
    flax model.apply(train=True) with the JAX draws recorded and injected,
    float32: outputs < 5e-5, the new batch statistics within 1e-6; without
    draws or a generator the forward raises ValueError."""
    jm, variables, tm = _models(rng, decoder)
    x = _feats(rng)
    with recorded_jax_draws() as rec:
        ref, upd = jm.apply(variables, jnp.asarray(x), train=True, mutable=["batch_stats"],
                            rngs={"dropout": jax.random.PRNGKey(3)})
    masks = _bernoulli_masks(rec)
    assert len(masks) == n_masks and not all(bool(m.all()) for m in masks)
    tm.train()
    with torch.no_grad():
        got = tm(torch.from_numpy(x), dropout_draws=masks)["accdoa"].numpy()
    ref = np.asarray(ref["accdoa"])
    assert got.shape == ref.shape == (2, 8, 12)
    assert np.abs(got - ref).max() < 5e-5, np.abs(got - ref).max()
    sd = jax_to_torch_state_dict(dict(variables, batch_stats=upd["batch_stats"]), tm)
    for k, v in tm.state_dict().items():
        if k.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(v.numpy(), sd[k].numpy(), rtol=1e-6, atol=1e-6)
    with pytest.raises(ValueError, match="dropout draws or a generator"):
        tm(torch.from_numpy(x))
    return tm, x


def test_conformer_train_mode_with_dropout_raises(rng):
    """(Its name kept from when training with dropout raised.) The shipped
    conformer decoder's seven dropout sites a block (ff1 x2, attention
    weights, attention output, conv output, ff2 x2) in train mode against
    flax, as ``_check_train_forward`` states; from a generator two forwards
    on the same seed agree and another seed differs."""
    tm, x = _check_train_forward(rng, "conformer", 7)
    with torch.no_grad():
        a, b, c = (tm(torch.from_numpy(x), generator=torch.Generator().manual_seed(s))["accdoa"]
                   for s in (5, 5, 6))
    assert torch.equal(a, b) and not torch.equal(a, c)


def test_transformer_train_mode_matches_flax(rng):
    """The transformer decoder (two layers) in train mode against flax, as
    ``_check_train_forward`` states: four draws a layer, the attention
    weights' (1, 1, T, T) mask broadcast over batch and heads (flax's
    multiply form) first."""
    _check_train_forward(rng, "transformer", 8)


@pytest.mark.parametrize("decoder", ["conformer", "transformer"])
def test_einv2_track_decoders_match_jax_decoder(rng, decoder):
    """The EINV2 CRNN's six track decoders, module by module, in train mode
    against the JAX ``Decoder`` applied with deterministic=False on the same
    (bridged) weights and the JAX draws injected, float32: < 5e-5. The JAX
    EINV2 CRNN itself calls them in eval form while training (its
    einv2_heads.py:72-73); the port trains them, a deviation ROADMAP.md
    records. The whole head then trains from a generator, deterministic in
    its seed."""
    from pseldnets_tpu.models import einv2_heads as jax_einv2
    from pseldnets_tpu.models.common import Decoder as JaxDecoder
    from pseldnets_tpu_torch.models import einv2_heads

    kw = dict(num_classes=4, in_channels=7, encoder="CNN8", num_features=FEATS,
              decoder=decoder, num_decoder_layers=_layers(decoder), mel_bins=16, pred_res=10)
    v = jax_einv2.CRNN(**kw).init({"params": jax.random.PRNGKey(0)}, jnp.zeros((1, 7, 80, 16)))
    variables = {"params": randomize(flax.core.unfreeze(v["params"]), rng),
                 "batch_stats": _random_stats(flax.core.unfreeze(v["batch_stats"]), rng)}
    tm = einv2_heads.CRNN(**kw)
    load_jax_variables(tm, variables)
    tm.train()
    jd = JaxDecoder(decoder, FEATS[-1], num_layers=_layers(decoder))
    x = (rng.standard_normal((2, 10, FEATS[-1])) * 0.5).astype(np.float32)
    for i, name in enumerate(f"{b}_track{t}" for b in ("sed", "doa") for t in (1, 2, 3)):
        sub = {c: variables[c][name] for c in variables if name in variables[c]}
        with recorded_jax_draws() as rec:
            ref = jd.apply(sub, jnp.asarray(x), deterministic=False, mutable=["batch_stats"],
                           rngs={"dropout": jax.random.PRNGKey(i)})[0]
        with torch.no_grad():
            got = getattr(tm, name)(torch.from_numpy(x), DropoutDraws(masks=_bernoulli_masks(rec)))
        assert np.abs(got.numpy() - np.asarray(ref)).max() < 5e-5, name
    wav_x = torch.from_numpy(_feats(rng, T=80))
    with torch.no_grad():
        a, b = (tm(wav_x, generator=torch.Generator().manual_seed(1)) for _ in range(2))
    assert all(torch.isfinite(a[k]).all() and torch.equal(a[k], b[k]) for k in a)


# --- the fused forward and serving from the waveform -------------------------

@pytest.mark.parametrize("conv_impl,num_tracks", [("xla", 1), ("pallas", 3)])
def test_fused_forward_matches_jax_f32(rng, conv_impl, num_tracks):
    """The port's crnn_fused_forward on the plain versions in float32
    against the JAX crnn_fused_forward (conv_impl "xla", or "pallas" in
    interpret mode: the stem split, relu_conv and the double kernel): < 5e-5;
    the eager model agrees."""
    jm, variables, tm = _models(rng, num_tracks=num_tracks)
    x = _feats(rng)
    ref = np.asarray(jax_fused_forward(jm, variables, jnp.asarray(x), compute_dtype=jnp.float32,
                                       conv_impl=conv_impl, interpret=True)[tm.output_key])
    got = crnn_fused_forward(tm, torch.from_numpy(x), compute_dtype=torch.float32,
                             use_kernels=False)[tm.output_key].numpy()
    assert got.shape == ref.shape == (2, 8, 12 * num_tracks)
    assert np.abs(got - ref).max() < 5e-5, np.abs(got - ref).max()
    with torch.no_grad():
        eager = tm(torch.from_numpy(x))[tm.output_key].numpy()
    assert np.abs(got - eager).max() < 5e-5


def test_fused_forward_without_decoder_matches_jax(rng):
    """decoder None: the trunk, the frequency mean, the interp-mean matrix
    and fc alone, float32: < 5e-5."""
    jm, variables, tm = _models(rng, decoder=None)
    x = _feats(rng)
    ref = np.asarray(jax_fused_forward(jm, variables, jnp.asarray(x),
                                       compute_dtype=jnp.float32)["accdoa"])
    got = crnn_fused_forward(tm, torch.from_numpy(x), compute_dtype=torch.float32)["accdoa"]
    assert np.abs(got.numpy() - ref).max() < 5e-5


def test_fused_forward_bf16_within_band(rng):
    """bf16: the port against the JAX bf16 fused forward, and against the
    port's float32 path: within 5e-2, the band the JAX package holds its
    bf16 paths to (tanh outputs)."""
    jm, variables, tm = _models(rng, num_tracks=3)
    x = _feats(rng)
    ref = np.asarray(jax_fused_forward(jm, variables, jnp.asarray(x),
                                       compute_dtype=jnp.bfloat16)["multi_accdoa"])
    params = prepare_crnn(tm, torch.bfloat16)
    assert params.blocks[0].w1.shape == (3, 3, 8, 8) and params.num_heads == 8
    got = crnn_fused_forward(tm, torch.from_numpy(x), params=params)["multi_accdoa"]
    assert got.dtype == torch.float32 and torch.isfinite(got).all()
    assert np.abs(got.numpy() - ref.astype(np.float32)).max() < 5e-2
    f32 = crnn_fused_forward(tm, torch.from_numpy(x), compute_dtype=torch.float32)
    assert (got - f32["multi_accdoa"]).abs().max() < 5e-2


@pytest.mark.parametrize("decoder", ["gru", "transformer"])
def test_unsupported_decoders_raise(rng, decoder):
    _, _, tm = _models(rng, decoder)
    with pytest.raises(NotImplementedError, match=f"not '{decoder}'"):
        crnn_fused_forward(tm, torch.from_numpy(_feats(rng)), use_kernels=False)
    with pytest.raises(NotImplementedError, match=f"not '{decoder}'"):
        crnn_fused_forward_from_wav(tm, np.zeros((1, 4, 18960), np.float32), device="cpu")


def test_from_wav_matches_jax_from_wav(rng):
    """From the waveform, float32, plain branches on the CPU: 18960 samples
    (80 frames at hop 240), non-trivial ScalarBN statistics, against the JAX
    crnn_fused_forward_from_wav in interpret mode (frontend split3=False):
    < 5e-5; the default use_kernels=True on CPU tensors launches nothing."""
    jm, variables, tm = _models(rng)
    wav = (rng.standard_normal((2, 4, 18960)) * 0.1).astype(np.float32)
    frontend.KERNEL.launches = conv_block.KERNEL.launches = 0
    got = crnn_fused_forward_from_wav(tm, wav, compute_dtype=torch.float32, device="cpu",
                                      use_kernels=False, n_mels=16)["accdoa"].numpy()
    dflt = crnn_fused_forward_from_wav(tm, wav, compute_dtype=torch.float32, device="cpu",
                                       n_mels=16)["accdoa"].numpy()
    assert frontend.KERNEL.launches == conv_block.KERNEL.launches == 0
    assert np.array_equal(got, dflt)
    ref = np.asarray(jax_from_wav(jm, variables, jnp.asarray(wav), compute_dtype=jnp.float32,
                                  interpret=True, split3=False, n_mels=16)["accdoa"])
    assert got.shape == ref.shape == (2, 8, 12)
    assert np.abs(got - ref).max() < 5e-5, np.abs(got - ref).max()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            crnn_fused_forward_from_wav(tm, wav, n_mels=16)
