"""The port's PaSST ACCDOA/mACCDOA model, its ViT block (plain version of
kernel K6) and its serving path against the JAX package, tiny configurations
(tests/test_serving_fused.py:173-226), weights moved across by the bridge;
the JAX Pallas kernels run in interpret mode. The train-mode forward
against model.apply(train=True) with the JAX draws recorded and injected
(the EINV2 dual PaSST and the SELDTask steps: test_torch_passt_train.py)."""

import contextlib
import dataclasses
import zlib
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pseldnets_tpu.models import einv2_heads as jax_einv2
from pseldnets_tpu.models import heads as jax_heads
from pseldnets_tpu.models.passt import Block as JaxBlock
from pseldnets_tpu.ops.pallas.vit_block import vit_block_fused as jax_vit_block
from pseldnets_tpu.serving import passt_fused_forward as jax_fused_forward
from pseldnets_tpu.serving import passt_fused_forward_from_wav as jax_from_wav
from pseldnets_tpu.train.checkpoint import flax_to_torch_key as jax_key
from pseldnets_tpu_torch.config import compose
from pseldnets_tpu_torch.models import build_model, einv2_heads, heads
from pseldnets_tpu_torch.models.passt import Block, PatchoutDraws
from pseldnets_tpu_torch.ops import frontend, vit_block
from pseldnets_tpu_torch.serving import (passt_fused_forward, passt_fused_forward_from_wav,
                                         prepare_vit_blocks)
from pseldnets_tpu_torch.train.checkpoint import (_flatten, flax_to_torch_key,
                                                  jax_to_torch_state_dict, load_jax_variables)
import torch_threads  # noqa: F401  (each xdist worker's share of the cores)
from test_torch_swin_block import abstract_init, randomize

ROOT = Path(__file__).resolve().parents[1]
ENC = dict(u_patchout=0, s_patchout_t=0, s_patchout_f=0, img_size=(16, 101), patch_size=16,
           stride=10, embed_dim=32, depth=2, num_heads=2, mlp_ratio=4.0, qkv_bias=True,
           distilled=True, drop_rate=0.0, drop_path_rate=0.0)
# from the waveform: 64 mels and 1 s at 24 kHz fill img_size with 101 frames
WAV_ENC = dict(ENC, img_size=(64, 101))
PASST_OVERRIDES = ["model=passt", "loss=multi_accdoa", "model.kwargs.pretrained_path=null",
                   "model.kwargs.audioset_pretrain=false"]


def _models(rng, num_tracks=3, enc=ENC, dtype=jnp.float32):
    """A tiny JAX heads.PASST with seeded random weights (every leaf: tokens,
    position embeddings, norms, biases) and eval ScalarBN statistics, and the
    port's model with the same weights through the bridge."""
    mel = enc["img_size"][0]
    jm = jax_heads.PASST(num_classes=5, in_channels=7, mel_bins=mel, num_tracks=num_tracks,
                         encoder_kwargs=tuple(enc.items()), dtype=dtype)
    x = jnp.zeros((1, 7, enc["img_size"][1], mel), jnp.float32)
    v = jm.init({"params": jax.random.PRNGKey(0)}, x, train=False)
    variables = {"params": randomize(v["params"], rng),
                 "batch_stats": {"scalar": {"bn": {
                     "running_mean": (rng.standard_normal((7, mel)) * 0.5).astype(np.float32),
                     "running_var": (rng.random((7, mel)) + 0.5).astype(np.float32)}}}}
    tm = heads.PASST(num_classes=5, in_channels=7, mel_bins=mel, num_tracks=num_tracks,
                     encoder_kwargs=enc)
    load_jax_variables(tm, variables)
    return jm, variables, tm.eval()


@pytest.mark.parametrize("num_tracks,key", [(1, "accdoa"), (3, "multi_accdoa")])
def test_bridge_and_eager_forward_match_flax(rng, num_tracks, key):
    """Every key maps both ways with the JAX package's key map and the
    reference layouts; the eager model equals model.apply(train=False) in
    float32 (summation order only)."""
    jm, variables, tm = _models(rng, num_tracks)
    sd = jax_to_torch_state_dict(variables, tm)
    assert set(sd) == set(tm.state_dict())
    for coll in ("params", "batch_stats"):
        for path in _flatten(variables[coll]):
            assert flax_to_torch_key(path) == jax_key(path), path
    assert sd["encoder.blocks.1.attn.qkv.weight"].shape == (96, 32)
    assert sd["encoder.head.0.weight"].shape == (32,)
    assert sd["encoder.cls_token"].shape == sd["encoder.dist_token"].shape == (1, 1, 32)
    assert sd["encoder.new_pos_embed"].shape == (1, 2, 32)
    assert sd["encoder.freq_new_pos_embed"].shape == (1, 32, 1, 1)
    assert sd["encoder.time_new_pos_embed"].shape == (1, 32, 1, 10)
    assert sd["encoder.patch_embed.proj.weight"].shape == (32, 7, 16, 16)
    x = (rng.standard_normal((2, 7, 101, 16)) * 0.5).astype(np.float32)
    ref = np.asarray(jm.apply(variables, jnp.asarray(x), train=False)[key])
    with torch.no_grad():
        got = tm(torch.from_numpy(x))[key].numpy()
    assert got.shape == ref.shape == (2, 10, 15 * num_tracks)
    assert np.abs(got - ref).max() < 2e-5, np.abs(got - ref).max()


def _block_pair(rng, N, C, nh):
    blk = JaxBlock(dim=C, num_heads=nh)
    x = rng.standard_normal((3, N, C)).astype(np.float32)
    params = randomize(blk.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"], rng)
    tblk = Block(C, nh)
    load_jax_variables(tblk, {"params": params})
    return blk, params, tblk.eval(), x


@pytest.mark.parametrize("N,C,nh", [(26, 32, 4), (17, 48, 3)])
def test_vit_block_plain_matches_pallas_f32(rng, N, C, nh):
    """vit_block_plain against the Pallas kernel (exact softmax, interpret
    mode) and the flax block in float32, N not a multiple of 16."""
    blk, params, tblk, x = _block_pair(rng, N, C, nh)
    ref = np.asarray(jax_vit_block(jnp.asarray(x), params, nh=nh, compute_dtype=jnp.float32,
                                   interpret=True))
    p = vit_block.prepare_vit_block(tblk, torch.float32)
    assert p.eps == 1e-6
    got = vit_block.vit_block_plain(torch.from_numpy(x), p).numpy()
    assert np.abs(got - ref).max() < 5e-5, np.abs(got - ref).max()
    flax_ref = np.asarray(blk.apply({"params": params}, jnp.asarray(x)))
    with torch.no_grad():
        eager = tblk(torch.from_numpy(x)).numpy()
    assert np.abs(eager - flax_ref).max() < 5e-5, np.abs(eager - flax_ref).max()
    assert np.abs(got - eager).max() < 5e-5, np.abs(got - eager).max()


def test_vit_block_plain_matches_pallas_bf16(rng):
    """bf16: the same rounding points as the Pallas bf16 kernel; they differ
    by exact GELU against _gelu_poly and one-ulp flips that propagate, within
    3e-2 of the output's largest magnitude (K2's bound)."""
    _, params, tblk, x = _block_pair(rng, 26, 32, 4)
    ref = np.asarray(jax_vit_block(jnp.asarray(x), params, nh=4, compute_dtype=jnp.bfloat16,
                                   interpret=True)).astype(np.float32)
    got = vit_block.vit_block_plain(torch.from_numpy(x),
                                    vit_block.prepare_vit_block(tblk, torch.bfloat16))
    assert got.dtype == torch.bfloat16
    err = np.abs(got.float().numpy() - ref).max()
    assert err < 3e-2 * np.abs(ref).max(), (err, np.abs(ref).max())


def _two_pass_attention(q, k, v, tile=64):
    """Kernel K6's attention order in plain torch, per (image, head): pass 1
    over key tiles of ``tile`` keeps a running float32 row max m and sum l
    of exp(s / 8 - m), rescaled as m grows; pass 2 recomputes each tile's
    scores, rounds p = exp(s / 8 - m) / l to bf16 (normalized, then rounded,
    as the Pallas exact path) and sums P V in float32. q, k, v (B, nh, N, 64)
    bf16 -> O (B, nh, N, 64) bf16."""
    qf, kf, vf = q.float(), k.float(), v.float()
    scale = q.shape[-1] ** -0.5
    N = q.shape[2]
    m = torch.full(q.shape[:3] + (1,), -float("inf"))
    l = torch.zeros(q.shape[:3] + (1,))
    for j0 in range(0, N, tile):
        s = torch.matmul(qf, kf[:, :, j0:j0 + tile].transpose(-1, -2)) * scale
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        l = l * torch.exp(m - m_new) + torch.exp(s - m_new).sum(-1, keepdim=True)
        m = m_new
    o = torch.zeros(qf.shape)
    for j0 in range(0, N, tile):
        s = torch.matmul(qf, kf[:, :, j0:j0 + tile].transpose(-1, -2)) * scale
        p = (torch.exp(s - m) / l).to(torch.bfloat16)
        o += torch.matmul(p.float(), vf[:, :, j0:j0 + tile])
    return o.to(torch.bfloat16)


@pytest.mark.parametrize("tile", [64, 128])
def test_two_pass_attention_order_matches_pallas(rng, tile):
    """The kernel's two-pass attention (key tiles of 64, as shipped, and of
    128, its other form; N = 150 leaves a partial last tile) inside the
    plain bf16 block, against the Pallas exact path in interpret mode:
    within 3e-2 of the output's largest magnitude, the bound of the bf16
    test above; and its heads within two bf16 ulps of the one-pass softmax
    of vit_block_plain."""
    _, params, tblk, x = _block_pair(rng, 150, 128, 2)  # head dim 64, as the kernel
    p = vit_block.prepare_vit_block(tblk, torch.bfloat16)
    x0 = torch.from_numpy(x).bfloat16()
    B, N, C = x0.shape
    h = vit_block._ln(x0, p.ln1_w, p.ln1_b, p.eps).to(torch.bfloat16)
    qkv = (vit_block._mm(h, p.qkv_w.t()) + p.qkv_b).to(torch.bfloat16)
    q, k, v = (qkv[..., i * C:(i + 1) * C].reshape(B, N, p.nh, 64).transpose(1, 2)
               for i in range(3))
    o = _two_pass_attention(q, k, v, tile)
    one_pass = torch.matmul(torch.softmax(torch.matmul((q * 0.125).float(), k.float().transpose(
        -1, -2)), dim=-1).to(torch.bfloat16).float(), v.float()).to(torch.bfloat16)
    assert (o.float() - one_pass.float()).abs().max() <= 2.0 ** -7 * one_pass.float().abs().max()
    o = o.transpose(1, 2).reshape(B, N, C)
    y = x0 + (vit_block._mm(o, p.proj_w.t()) + p.proj_b).to(torch.bfloat16)
    h = vit_block._ln(y, p.ln2_w, p.ln2_b, p.eps).to(torch.bfloat16)
    h = torch.nn.functional.gelu(vit_block._mm(h, p.fc1_w.t()) + p.fc1_b,
                                 approximate="none").to(torch.bfloat16)
    got = (y + (vit_block._mm(h, p.fc2_w.t()) + p.fc2_b).to(torch.bfloat16)).float().numpy()
    ref = np.asarray(jax_vit_block(jnp.asarray(x), params, nh=2, compute_dtype=jnp.bfloat16,
                                   interpret=True)).astype(np.float32)
    err = np.abs(got - ref).max()
    assert err < 3e-2 * np.abs(ref).max(), (err, np.abs(ref).max())


def test_fused_forward_matches_jax(rng):
    """The port's fused forward on the plain block (CPU) against the JAX
    passt_fused_forward (Pallas interpret): 5e-5 in float32; and the eager
    model agrees with it."""
    jm, variables, tm = _models(rng, num_tracks=1)
    x = (rng.standard_normal((2, 7, 101, 16)) * 0.5).astype(np.float32)
    ref = np.asarray(jax_fused_forward(jm, variables, jnp.asarray(x), compute_dtype=jnp.float32,
                                       interpret=True)["accdoa"])
    got = passt_fused_forward(tm, torch.from_numpy(x), compute_dtype=torch.float32,
                              use_kernels=False)["accdoa"].numpy()
    assert got.shape == ref.shape == (2, 10, 15)
    assert np.abs(got - ref).max() < 5e-5, np.abs(got - ref).max()
    with torch.no_grad():
        eager = tm(torch.from_numpy(x))["accdoa"].numpy()
    assert np.abs(got - eager).max() < 5e-5


def test_fused_forward_bf16_within_band(rng):
    """bf16: the port against the JAX fused forward of a bf16 model (the
    flax submodules at bf16, the Pallas block in bf16), and against the
    float32 path: both within 5e-2, the band the JAX package holds its bf16
    paths to (the outputs are tanh values)."""
    jm, variables, tm = _models(rng, dtype=jnp.bfloat16)
    x = (rng.standard_normal((2, 7, 101, 16)) * 0.5).astype(np.float32)
    ref = np.asarray(jax_fused_forward(jm, variables, jnp.asarray(x), compute_dtype=jnp.bfloat16,
                                       interpret=True)["multi_accdoa"]).astype(np.float32)
    blocks = prepare_vit_blocks(tm, torch.bfloat16)
    got = passt_fused_forward(tm, torch.from_numpy(x), blocks=blocks)["multi_accdoa"]
    assert got.dtype == torch.float32 and torch.isfinite(got).all()
    assert np.abs(got.numpy() - ref).max() < 5e-2, np.abs(got.numpy() - ref).max()
    f32 = passt_fused_forward(tm, torch.from_numpy(x), compute_dtype=torch.float32)
    assert (got - f32["multi_accdoa"]).abs().max() < 5e-2


def test_from_wav_matches_jax_from_wav(rng):
    """The serving path from the waveform, float32, plain branches on the
    CPU, against the JAX one in interpret mode (frontend split3=False, eval
    ScalarBN folded): 5e-5, test_torch_htsat.py's from-wav bound; 101
    frames fill img_size (64, 101), 62 tokens."""
    jm, variables, tm = _models(rng, enc=WAV_ENC)
    wav = (rng.standard_normal((2, 4, 24000)) * 0.1).astype(np.float32)
    frontend.KERNEL.launches = vit_block.KERNEL.launches = 0
    got = passt_fused_forward_from_wav(tm, wav, compute_dtype=torch.float32, device="cpu",
                                       use_kernels=False)["multi_accdoa"].numpy()
    # the default use_kernels=True on CPU tensors takes the plain versions
    dflt = passt_fused_forward_from_wav(tm, wav, compute_dtype=torch.float32,
                                        device="cpu")["multi_accdoa"].numpy()
    assert frontend.KERNEL.launches == vit_block.KERNEL.launches == 0
    assert np.array_equal(got, dflt)
    ref = np.asarray(jax_from_wav(jm, variables, jnp.asarray(wav), compute_dtype=jnp.float32,
                                  interpret=True, split3=False)["multi_accdoa"])
    assert got.shape == ref.shape == (2, 10, 45)
    assert np.abs(got - ref).max() < 5e-5, np.abs(got - ref).max()


def test_from_wav_needs_the_card_and_a_full_clip(rng):
    _, _, tm = _models(rng, enc=WAV_ENC)
    wav = np.zeros((1, 4, 24000), np.float32)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            passt_fused_forward_from_wav(tm, wav)
    with pytest.raises(ValueError, match="needs 101 frames"):
        passt_fused_forward_from_wav(tm, wav[..., :12000], device="cpu")


# a geometry whose crop has room: patch 16, stride 9 (an odd patch - stride)
# on 99 frames gives 10 time patches against the time pos-embed's 11
# columns, so the JAX crop offset is 0 or 1; 64 mels give 7 frequency rows.
# At the shipped patch 16, stride 10 the conv's grid always equals the
# pos-embed's, and the offset is always 0.
CROP_ENC = dict(ENC, img_size=(64, 99), stride=9)
TRAIN_SETTINGS = [{}, {"u_patchout": 10}, {"s_patchout_t": 2}, {"s_patchout_f": 1},
                  {"drop_rate": 0.1}, {"drop_path_rate": 0.5}, {"u_patchout": 7},
                  {"s_patchout_f": 1, "u_patchout": 6, "drop_rate": 0.1,
                   "drop_path_rate": 0.5}]


@contextlib.contextmanager
def recorded_jax_draws():
    """Every value jax.random.randint / permutation / bernoulli / uniform
    returns while the context is open, as (name, array) in call order: the
    JAX PaSST's crop, patchout and position-dropout draws
    (models/passt.py:142-188) and its DropPath masks' uniforms
    (models/common.py:111-118). Traced calls (flax checks an existing
    parameter's shape against its initializer's) are left out."""
    rec = []
    saved = {n: getattr(jax.random, n) for n in ("randint", "permutation", "bernoulli",
                                                 "uniform")}

    def wrap(name, fn):
        def call(*a, **k):
            out = fn(*a, **k)
            if not isinstance(out, jax.core.Tracer):
                rec.append((name, np.asarray(out)))
            return out
        return call

    for n, fn in saved.items():
        setattr(jax.random, n, wrap(n, fn))
    try:
        yield rec
    finally:
        for n, fn in saved.items():
            setattr(jax.random, n, fn)


def _next(it, name):
    got, value = next(it)
    assert got == name, (got, name)
    return value


def take_patchout_draws(it, enc) -> PatchoutDraws:
    """One JAX encoder's forward_before draws as the port's PatchoutDraws:
    the crop's offset, the sorted keep-sets, the position-dropout mask."""
    d = PatchoutDraws(offset=torch.tensor(int(_next(it, "randint"))))
    for name, key in (("keep_t", "s_patchout_t"), ("keep_f", "s_patchout_f"),
                      ("keep_u", "u_patchout")):
        if enc.get(key):
            perm = _next(it, "permutation")
            setattr(d, name, torch.from_numpy(np.sort(perm[:len(perm) - enc[key]])).long())
    if enc.get("drop_rate", 0) > 0:
        d.pos_keep = torch.from_numpy(np.array(_next(it, "bernoulli")))
    return d


def take_block_mask(it, rate, B):
    """One JAX block's two DropPath draws (attention branch, then MLP
    branch) as the port's (B, 2) mask in ``drop_path_masks``'s format,
    floor(keep + u) / keep; ones where the block's rate is 0 (it draws
    nothing)."""
    if not rate:
        return torch.ones(B, 2)
    keep = 1.0 - rate
    m = np.stack([np.floor(keep + _next(it, "uniform").reshape(-1)) for _ in range(2)], 1)
    return torch.from_numpy((m / keep).astype(np.float32))


def port_draws(rec, enc, B, n_encoders):
    """A JAX PaSST apply's recorded draws -> the port's: one PatchoutDraws
    and one list of (B, 2) block masks an encoder. The JAX EINV2 PaSST
    draws both encoders' forward_before first (SED's, then DOA's), then
    runs the blocks interleaved (SED block i, DOA block i)."""
    it = iter(rec)
    draws = [take_patchout_draws(it, enc) for _ in range(n_encoders)]
    masks = [[] for _ in range(n_encoders)]
    for rate in _rates(enc):
        for m in masks:
            m.append(take_block_mask(it, rate, B))
    assert next(it, None) is None
    return draws, masks


def _rates(enc):
    depth = enc["depth"]
    return [enc.get("drop_path_rate", 0.0) * i / max(depth - 1, 1) for i in range(depth)]


def _train_pair(rng, setting, einv2, decoder=None):
    """(JAX model, variables, port model in train mode, input) on CROP_ENC
    with ``setting``: the single mACCDOA head or the EINV2 dual PaSST (its
    track decoders ``decoder``)."""
    enc = dict(CROP_ENC, **setting)
    x = (rng.standard_normal((3, 7, 99, 64)) * 0.5).astype(np.float32)
    if einv2:
        kw = dict(num_classes=5, in_channels=7, mel_bins=64, ps_gap=1, decoder=decoder,
                  num_decoder_layers=1)
        jm = jax_einv2.PASST(encoder_kwargs=tuple(enc.items()), **kw)
        tm = einv2_heads.PASST(encoder_kwargs=enc, **kw)
    else:
        kw = dict(num_classes=5, in_channels=7, mel_bins=64, num_tracks=3)
        jm = jax_heads.PASST(encoder_kwargs=tuple(enc.items()), **kw)
        tm = heads.PASST(encoder_kwargs=enc, **kw)
    v = abstract_init(jm, jnp.asarray(x), train=False)
    variables = {"params": randomize(v["params"], rng),
                 "batch_stats": {"scalar": {"bn": {"running_mean": np.zeros((7, 64), np.float32),
                                                   "running_var": np.ones((7, 64), np.float32)}}}}
    load_jax_variables(tm, variables)
    return jm, variables, tm.train(), x, enc


@pytest.mark.parametrize("setting", TRAIN_SETTINGS)
def test_train_mode_raises(setting):
    """A PaSST built with the train-only ``setting`` in eval mode against
    the JAX model.apply(train=False), float32, within 5e-5 and with the full
    grid's frames (eval ignores patchout, dropout and drop-path). Then the
    single mACCDOA head's train-mode forward (batch-statistics
    ScalarBN, the time-pos-embed crop, patchout, position dropout,
    drop-path) against the JAX model.apply(train=True), float32, the JAX
    draws injected: within 5e-5, the batch statistics within 1e-6. Time
    patchout gives JAX's shorter output; a token patchout that leaves a
    count not divisible by the frequency rows raises in both packages (JAX
    in its reshape, the port a ValueError). (The name is kept from when
    PaSST training was not ported and this test held that it raised.)"""
    check_train_forward(setting, einv2=False)


def check_train_forward(setting, einv2):
    rng = np.random.default_rng(zlib.crc32(repr((setting, einv2)).encode()))
    jm, variables, tm, x, enc = _train_pair(rng, setting, einv2)
    ref = jm.apply(variables, jnp.asarray(x), train=False)
    with torch.no_grad():
        got = tm.eval()(torch.from_numpy(x))
    for k, r in ref.items():
        r = np.asarray(r)
        assert got[k].shape == r.shape and r.shape[1] == 10, (k, r.shape)
        err = np.abs(got[k].numpy() - r).max()
        assert err < 5e-5, (k, err)
    tm.train()
    rngs = {"dropout": jax.random.PRNGKey(5), "patchout": jax.random.PRNGKey(6)}
    apply = lambda: jm.apply(variables, jnp.asarray(x), train=True,  # noqa: E731
                             mutable=["batch_stats"], rngs=rngs)
    divides = (7 - enc.get("s_patchout_f", 0)) * 10
    if (divides - enc.get("u_patchout", 0)) % (7 - enc.get("s_patchout_f", 0)):
        with pytest.raises(TypeError, match="reshape"):
            apply()
        with pytest.raises(ValueError, match="token map"), torch.no_grad():
            tm(torch.from_numpy(x), generator=torch.Generator().manual_seed(0))
        return
    with recorded_jax_draws() as rec:
        ref, new_vars = apply()
    draws, masks = port_draws(rec, enc, x.shape[0], 2 if einv2 else 1)
    if not setting:  # the crop moved: offset 1 of {0, 1}
        assert all(int(d.offset) == 1 for d in draws)
    if enc.get("drop_path_rate"):
        assert any((m == 0).any() for ms in masks for m in ms)
    if einv2:
        got = tm(torch.from_numpy(x), dp_masks=tuple(masks), patchout_draws=tuple(draws))
    else:
        got = tm(torch.from_numpy(x), dp_masks=masks[0], patchout_draws=draws[0])
    frames = 10 - enc.get("s_patchout_t", 0) - enc.get("u_patchout", 0) // (
        7 - enc.get("s_patchout_f", 0))
    for k, r in ref.items():
        r = np.asarray(r)
        assert got[k].shape == r.shape and r.shape[1] == frames, (k, r.shape)
        err = np.abs(got[k].detach().numpy() - r).max()
        assert err < 5e-5, (k, err)
    bn = new_vars["batch_stats"]["scalar"]["bn"]
    for k in ("running_mean", "running_var"):
        np.testing.assert_allclose(getattr(tm.scalar, k).numpy(), np.asarray(bn[k]),
                                   rtol=1e-6, atol=1e-6)


def test_train_draws_are_checked():
    """A train-mode encoder refuses to run without its draws, and draws
    that lack one its settings take (the crop's offset where the crop has
    room, a keep-set, the position-dropout mask); ``draw`` gives them all."""
    enc = heads.PASST(num_classes=5, in_channels=7, mel_bins=64, num_tracks=3,
                      encoder_kwargs=dict(CROP_ENC, s_patchout_f=1, drop_rate=0.1)).encoder
    assert enc.crop_room == 2 and heads.PASST(
        num_classes=5, encoder_kwargs=WAV_ENC).encoder.crop_room == 1
    x = torch.zeros(2, 7, 99, 64)
    enc.train()
    with pytest.raises(ValueError, match="needs its patchout draws"):
        enc.forward_before(x)
    full = enc.draw(torch.Generator().manual_seed(0), 2)
    for name in ("offset", "keep_f", "pos_keep"):
        with pytest.raises(ValueError, match=f"lack {name}"):
            enc.forward_before(x, dataclasses.replace(full, **{name: None}))
    with torch.no_grad():
        assert enc.forward_before(x, full).shape == (2, 2 + 6 * 10, 32)
        assert enc.eval().forward_before(x).shape == (2, 2 + 7 * 10, 32)


def test_vit_block_wrapper_routes_and_raises(rng):
    """A CPU tensor takes the plain version and builds or launches nothing;
    any other device must be CUDA, and the kernel's shape limits raise."""
    _, _, tblk, x = _block_pair(rng, 26, 128, 2)  # head dim 64
    p = vit_block.prepare_vit_block(tblk, torch.bfloat16)
    xt = torch.from_numpy(x).bfloat16()
    vit_block.KERNEL.launches = 0
    assert torch.equal(vit_block.vit_block_fused(xt, p), vit_block.vit_block_plain(xt, p))
    assert vit_block.KERNEL.launches == 0 and vit_block.KERNEL._lib is None
    with pytest.raises(ValueError, match="expected a CUDA tensor"):
        vit_block.vit_block_fused(xt.to("meta"), p)
    with pytest.raises(NotImplementedError, match="head dim 64"):
        vit_block.vit_block_fused(torch.zeros(vit_block.MAX_IMAGES + 1, 26, 128,
                                              dtype=torch.bfloat16, device="meta"), p)
    # TMA reads rows of 16 bytes: hidden must be a multiple of 8
    odd = vit_block.prepare_vit_block(Block(128, 2, mlp_ratio=131 / 128).eval(), torch.bfloat16)
    assert odd.hidden == 131 and odd.fc1_w.shape == (131, 128)
    with pytest.raises(NotImplementedError, match="hidden % 8 == 0"):
        vit_block.vit_block_fused(torch.zeros(1, 26, 128, dtype=torch.bfloat16, device="meta"),
                                  odd)
    _, _, tblk32, _ = _block_pair(rng, 26, 64, 2)  # head dim 32
    with pytest.raises(NotImplementedError, match="head dim 64"):
        vit_block.vit_block_fused(torch.zeros(1, 26, 64, dtype=torch.bfloat16, device="meta"),
                                  vit_block.prepare_vit_block(tblk32, torch.bfloat16))
    assert vit_block.KERNEL.launches == 0


def test_gemm_core_wrapper_routes_and_raises(rng):
    """K6's GEMM core alone: a CPU tensor takes the plain version (float32
    sums of the rounded operands, the epilogue's roundings) and builds or
    launches nothing; the tile, the epilogue and the 16-byte row limits
    raise before any launch."""
    a = torch.from_numpy(rng.standard_normal((37, 64)).astype(np.float32)).bfloat16()
    w = torch.from_numpy(rng.standard_normal((48, 64)).astype(np.float32)).bfloat16()
    bias = torch.from_numpy(rng.standard_normal(48).astype(np.float32))
    resid = torch.from_numpy(rng.standard_normal((37, 48)).astype(np.float32)).bfloat16()
    vit_block.KERNEL.launches = 0
    f = torch.matmul(a.float(), w.float().t()) + bias
    assert torch.equal(vit_block.gemm(a, w, bias), f.bfloat16())
    assert torch.equal(vit_block.gemm(a, w, bias, resid, "resid"), resid + f.bfloat16())
    assert torch.equal(vit_block.gemm(a, w, bias, epilogue="gelu"),
                       torch.nn.functional.gelu(f).bfloat16())
    assert vit_block.KERNEL.launches == 0 and vit_block.KERNEL._lib is None
    meta = lambda *shape: torch.zeros(*shape, dtype=torch.bfloat16, device="meta")  # noqa: E731
    for kw in ({"bn": 64}, {"epilogue": "relu"}):
        with pytest.raises(NotImplementedError, match="the GEMM core takes"):
            vit_block.gemm(meta(37, 64), meta(48, 64), bias.to("meta"), **kw)
    with pytest.raises(NotImplementedError, match="K % 8 == 0"):
        vit_block.gemm(meta(37, 60), meta(48, 60), bias.to("meta"))
    with pytest.raises(ValueError, match="expected a CUDA tensor"):
        vit_block.gemm(meta(37, 64), meta(48, 64), bias.to("meta"))
    assert vit_block.KERNEL.launches == 0


def test_full_size_passt_from_configs():
    """configs/model/passt.yaml with bench_all.py's overrides builds the
    published width: (6, 100) patch grid + cls + dist = 602 tokens, 7 blocks
    of 768 wide, 12 heads of 64, MLP 3072, eps 1e-6, 13 x 3 x 3 outputs; the
    seeded init fills the tokens and position embeddings."""
    cfg = compose(str(Path(__file__).resolve().parents[1] / "configs"), "train", PASST_OVERRIDES)
    model, meta = build_model(cfg, 13, device="cpu")
    enc = model.encoder
    assert meta["backbone"] == "PASST" and not model.training
    assert enc.grid_size == (6, 100) and enc.num_tokens == 2 and enc.img_size == (64, 1001)
    assert model.output_key == "multi_accdoa" and model.fc.out_features == 117
    blocks = prepare_vit_blocks(model, torch.bfloat16)
    assert [(p.C, p.nh, p.hidden, p.eps) for p in blocks] == [(768, 12, 3072, 1e-6)] * 7
    assert blocks[0].qkv_w.shape == (2304, 768) and blocks[0].qkv_w.dtype == torch.bfloat16
    for t in (enc.cls_token, enc.dist_token, enc.new_pos_embed, enc.freq_new_pos_embed,
              enc.time_new_pos_embed):
        assert 0.01 < t.std().item() < 0.03 and t.abs().max().item() <= 0.04
    assert enc.time_new_pos_embed.shape == (1, 768, 1, 100)
