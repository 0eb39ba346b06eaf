"""The port's EINV2 slice against the JAX package on the CPU, tiny
configurations (tests/test_serving_fused.py:228-258), weights moved across by
the bridge, the JAX Pallas kernels in interpret mode: CrossStitch, the four
EINV2 heads, the tPIT and AGG losses, the fused dual-HTSAT forward (plain
versions of K8 and K2) from features and from the waveform (plain K1),
the refusals, the eager SELDTask step, drop-path, the freeze and multi_opt
groupings and the factory."""

import zlib

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pseldnets_tpu.losses import build_loss as jax_build_loss
from pseldnets_tpu.models import einv2_heads as jax_einv2
from pseldnets_tpu.models.adapters import AdaptConfig as JaxAdaptConfig
from pseldnets_tpu.models.common import CrossStitch as JaxCrossStitch
from pseldnets_tpu.models.factory import build_model as jax_build_model
from pseldnets_tpu.ops.pallas.frontend import fused_logmel_iv as jax_fused
from pseldnets_tpu.serving import einv2_htsat_fused_forward as jax_fused_forward
from pseldnets_tpu.train.checkpoint import flax_to_torch_key as jax_key
from pseldnets_tpu.train.module import SELDTask as JaxTask
from pseldnets_tpu.train.optim import build_optimizer as jax_build_optimizer
from pseldnets_tpu.train.optim import trainable_mask as jax_trainable_mask
from pseldnets_tpu_torch.config import compose
from pseldnets_tpu_torch.losses import build_loss
from pseldnets_tpu_torch.models import build_model, einv2_heads
from pseldnets_tpu_torch.models.adapters import AdaptConfig
from pseldnets_tpu_torch.models.common import CrossStitch
from pseldnets_tpu_torch.models.heads import tscam_head
from pseldnets_tpu_torch.models.common import drop_path_masks
from pseldnets_tpu_torch.ops import frontend, patch_embed, swin_block
from pseldnets_tpu_torch.serving import (einv2_htsat_fused_forward,
                                         einv2_htsat_fused_forward_from_wav, prepare_einv2)
from pseldnets_tpu_torch.serving import einv2 as serving_einv2
from pseldnets_tpu_torch.train.checkpoint import (_flatten, flax_to_torch_key,
                                                  jax_to_torch_state_dict, load_jax_variables)
from pseldnets_tpu_torch.train.module import DatasetSpec, SELDTask
from pseldnets_tpu_torch.train.optim import build_optimizer, trainable_mask
import torch_threads  # noqa: F401  (each xdist worker's share of the cores)
from test_torch_crnn import _random_stats
from test_torch_passt import recorded_jax_draws, take_block_mask
from test_torch_swin_block import abstract_init, randomize
from test_torch_train import ROOT, TINY_TASK, _JaxSpec, einv2_labels

ENC = dict(spec_size=64, patch_size=4, patch_stride=(4, 4), embed_dim=16,
           depths=(2, 2), num_heads=(2, 4), window_size=4, mlp_ratio=2.0)
PASST_ENC = dict(u_patchout=0, s_patchout_t=0, s_patchout_f=0, img_size=(16, 101),
                 patch_size=16, stride=10, embed_dim=32, depth=3, num_heads=2, mlp_ratio=4.0,
                 qkv_bias=True, distilled=True, drop_rate=0.0, drop_path_rate=0.0)
CRNN_FEATS = (8, 16, 16, 24)
FE = dict(n_mels=16, t_blk=32)
ADAPTER = {"method": "adapter",
           "adapt_kwargs": {"position": ["MlpAdapter", "SpatialAdapter"], "type": "adapter",
                            "mlp_ratio": 0.5, "adapter_scalar": 0.1, "act_layer": "gelu"}}


@pytest.fixture
def rng(request):
    """A generator of each test's own, seeded from its name: the session's
    shared one would shift the inputs of the files that run after this one
    on the same worker."""
    return np.random.default_rng(zlib.crc32(request.node.name.encode()))


def _pair(rng, kind, T=241, drop_path=0.0, decoder=None, adapt=None, **enc_kw):
    """(JAX model, variables, port model in eval mode, input shape) with
    seeded random weights (every leaf, the stitches included) and BN
    statistics, carried across by the bridge; ``enc_kw`` adds to an HTSAT's
    encoder arguments."""
    if kind in ("HTSAT", "HTSAT_SEDDOA"):
        kw = dict(num_classes=5, in_channels=7, mel_bins=16, tgt_output_frames=24)
        enc = dict(ENC, drop_path_rate=drop_path, **enc_kw)
        jm = getattr(jax_einv2, kind)(encoder_kwargs=tuple(enc.items()),
                                      adapt=JaxAdaptConfig(adapt), **kw)
        tm = getattr(einv2_heads, kind)(encoder_kwargs=enc, adapt=AdaptConfig(adapt), **kw)
        shape = (2 if T > 200 else 4, 7, T, 16)
    elif kind == "CRNN":
        kw = dict(num_classes=4, in_channels=7, num_features=CRNN_FEATS, decoder=decoder,
                  num_decoder_layers=2 if decoder in ("gru", "transformer") else 1,
                  mel_bins=16, pred_res=10)
        jm, tm, shape = jax_einv2.CRNN(**kw), einv2_heads.CRNN(**kw), (2, 7, 80, 16)
    else:
        kw = dict(num_classes=5, in_channels=7, mel_bins=16, ps_gap=2, decoder=decoder,
                  num_decoder_layers=1)
        jm = jax_einv2.PASST(encoder_kwargs=tuple(PASST_ENC.items()), **kw)
        tm = einv2_heads.PASST(encoder_kwargs=PASST_ENC, **kw)
        shape = (2, 7, 101, 16)
    v = abstract_init(jm, jnp.zeros(shape), train=False)  # every leaf is replaced
    variables = {"params": randomize(v["params"], rng),
                 "batch_stats": _random_stats(v["batch_stats"], rng)}
    load_jax_variables(tm, variables)
    return jm, variables, tm.eval(), shape


def _x(rng, shape):
    return (rng.standard_normal(shape) * 0.5).astype(np.float32)


def _max_diff(got, ref):
    return max(float(np.abs(np.asarray(got[k]) - np.asarray(ref[k])).max())
               for k in ("sed", "doa"))


# --- CrossStitch and the bridge -------------------------------------------

@pytest.mark.parametrize("shape", [(3, 5, 6, 2), (3, 7, 5)])
def test_cross_stitch_matches_flax(rng, shape):
    """4-D NCHW (channels on axis 1) and 3-D tokens (channels last), the
    sequential update, against flax: < 1e-6; a 2-D input raises."""
    C = shape[1] if len(shape) == 4 else shape[-1]
    x, y = rng.standard_normal(shape).astype(np.float32), rng.standard_normal(shape).astype(
        np.float32)
    js = JaxCrossStitch(feat_dim=C)
    params = {"weight": rng.uniform(0.1, 0.9, (C, 2, 2)).astype(np.float32)}
    rx, ry = js.apply({"params": params}, jnp.asarray(x), jnp.asarray(y))
    ts = CrossStitch(C)
    load_jax_variables(ts, {"params": params})
    gx, gy = ts(torch.from_numpy(x), torch.from_numpy(y))
    assert np.abs(gx.detach().numpy() - np.asarray(rx)).max() < 1e-6
    assert np.abs(gy.detach().numpy() - np.asarray(ry)).max() < 1e-6
    # y mixes with the already mixed x
    w = params["weight"]
    axis = (1, -1, 1, 1) if len(shape) == 4 else (1, 1, -1)
    want_y = w[:, 1, 0].reshape(axis) * gx.detach().numpy() + w[:, 1, 1].reshape(axis) * y
    assert np.abs(gy.detach().numpy() - want_y).max() < 1e-6
    with pytest.raises(ValueError, match="3D or 4D"):
        ts(torch.zeros(2, C), torch.zeros(2, C))


@pytest.mark.parametrize("kind,decoder", [("HTSAT", None), ("HTSAT_SEDDOA", None),
                                          ("CRNN", "conformer"), ("CRNN", "gru"),
                                          ("PASST", "transformer")])
def test_bridge_maps_every_einv2_key_both_ways(rng, kind, decoder):
    """Every leaf of the four EINV2 trees has a port key (the JAX package's
    key map), the load is strict both ways, and the (C, 2, 2) stitch weights
    arrive untransposed."""
    jm, variables, tm, _ = _pair(rng, kind, decoder=decoder)
    sd = jax_to_torch_state_dict(variables, tm)
    assert set(sd) == set(tm.state_dict())
    for coll in ("params", "batch_stats"):
        for path in _flatten(variables[coll]):
            assert flax_to_torch_key(path) == jax_key(path), path
    stitches = {k: v for k, v in _flatten(variables["params"]).items() if "stitch" in k[0]}
    assert bool(stitches) == (kind != "HTSAT_SEDDOA")  # one encoder: nothing to stitch
    for path, w in stitches.items():
        assert w.shape[1:] == (2, 2)
        assert np.array_equal(sd[flax_to_torch_key(path)].numpy(), w), path
    first = next(iter(variables["params"]))
    short = dict(variables, params={k: v for k, v in variables["params"].items() if k != first})
    with pytest.raises(KeyError, match="not filled"):
        jax_to_torch_state_dict(short, tm)
    extra = dict(variables, params=dict(variables["params"], stray={"kernel": np.zeros((2, 2))}))
    with pytest.raises(KeyError, match="stray"):
        jax_to_torch_state_dict(extra, tm)


# --- the eager heads ------------------------------------------------------

@pytest.mark.parametrize("kind,T,decoder", [
    ("HTSAT", 241, None), ("HTSAT", 121, None), ("HTSAT_SEDDOA", 241, None),
    ("HTSAT_SEDDOA", 121, None), ("CRNN", None, "gru"), ("CRNN", None, "conformer"),
    ("CRNN", None, None), ("PASST", None, None), ("PASST", None, "transformer")])
def test_eager_head_matches_flax(rng, kind, T, decoder):
    """Each EINV2 head in eval against model.apply(train=False), float32
    (summation order only): < 5e-5; the HTSAT heads at 10 s and, through
    the 5 s trick, 5 s."""
    jm, variables, tm, shape = _pair(rng, kind, T=T or 241, decoder=decoder)
    x = _x(rng, shape)
    ref = jm.apply(variables, jnp.asarray(x), train=False)
    with torch.no_grad():
        got = tm(torch.from_numpy(x))
    for k in ("sed", "doa"):
        assert got[k].shape == ref[k].shape and got[k].dtype == torch.float32, k
    assert got["sed"].shape[2] == got["doa"].shape[2] == 3 and got["doa"].shape[3] == 3
    assert _max_diff({k: v.numpy() for k, v in got.items()}, ref) < 5e-5


# --- the losses -----------------------------------------------------------

def _loss_inputs(rng, B=3, T=10, K=4, tied=False):
    pred = {"sed": rng.standard_normal((B, T, 3, K)).astype(np.float32),
            "doa": np.tanh(rng.standard_normal((B, T, 3, 3))).astype(np.float32)}
    lab = einv2_labels(rng, B, T, K)
    if tied:  # three identical tracks: all six orders tie, the first wins
        pred = {k: np.repeat(v[:, :, :1], 3, axis=2) for k, v in pred.items()}
        lab = {k: np.repeat(v[:, :, :1], 3, axis=2) for k, v in lab.items()}
    return pred, lab


def _both_losses(cfg, pred, lab):
    ref = jax_build_loss(cfg)({k: jnp.asarray(v) for k, v in pred.items()},
                              {k: jnp.asarray(v) for k, v in lab.items()})
    got = build_loss(cfg)({k: torch.from_numpy(v) for k, v in pred.items()},
                          {k: torch.from_numpy(v) for k, v in lab.items()})
    assert set(got) == set(ref)
    for k in got:
        assert abs(float(got[k]) - float(ref[k])) < 1e-6, (k, float(got[k]), float(ref[k]))
    return got


@pytest.mark.parametrize("tied", [False, True])
@pytest.mark.parametrize("method", ["tPIT", "none"])
@pytest.mark.parametrize("fns", [("bce", "mse"), ("mse", "l1")])
def test_einv2_pit_loss_matches_jax(rng, method, fns, tied):
    cfg = {"_target_": "loss.einv2.Losses_pit", "loss_fn": {"sed": fns[0], "doa": fns[1]},
           "loss_type": "loss_all", "method": method, "loss_beta": 0.3}
    got = _both_losses(cfg, *_loss_inputs(rng, tied=tied))
    assert float(got["loss_all"]) > 0


@pytest.mark.parametrize("tied", [False, True])
@pytest.mark.parametrize("method", ["mACCDOA_pit", "ACCDOA", "mixed"])
def test_agg_pit_loss_matches_jax(rng, method, tied):
    pred, lab = _loss_inputs(rng, tied=tied)
    pred["doa"][0, 0, 0] = 0.0  # a zero DOA: F.normalize's eps
    cfg = {"_target_": "loss.einv2.Losses_agg_pit", "loss_fn": "mse", "loss_type": "loss_all",
           "loss_alpha": 0.4, "method": method}
    _both_losses(cfg, pred, lab)


# --- the fused forward ----------------------------------------------------

@pytest.mark.parametrize("T", [241, 121])
def test_fused_forward_matches_jax_f32(rng, T):
    """einv2_htsat_fused_forward on the plain versions (SED einsum embed,
    DOA K8, K2 with merge folds) against the JAX fused forward in interpret
    mode, float32: < 5e-5 at 10 s and (5 s trick) 5 s; no launch counted
    on CPU tensors."""
    jm, variables, tm, shape = _pair(rng, "HTSAT", T=T)
    x = _x(rng, shape)
    ref = jax_fused_forward(jm, variables, jnp.asarray(x), compute_dtype=jnp.float32,
                            interpret=True)
    patch_embed.KERNEL.launches = swin_block.KERNEL.launches = 0
    got = einv2_htsat_fused_forward(tm, torch.from_numpy(x), compute_dtype=torch.float32)
    assert patch_embed.KERNEL.launches == swin_block.KERNEL.launches == 0
    assert got["sed"].shape == ref["sed"].shape == (shape[0], T // 10, 3, 5)
    assert got["doa"].shape == ref["doa"].shape == (shape[0], T // 10, 3, 3)
    assert _max_diff({k: v.numpy() for k, v in got.items()}, ref) < 5e-5
    with torch.no_grad():
        eager = tm(torch.from_numpy(x))
    assert _max_diff({k: v.numpy() for k, v in got.items()}, eager) < 5e-5


def test_fused_forward_bf16_within_band(rng):
    """bf16 on the plain versions against the JAX fused forward in bf16
    (interpret) and against float32: the serving band, 5e-2."""
    jm, variables, tm, shape = _pair(rng, "HTSAT")
    x = _x(rng, shape)
    ref = jax_fused_forward(jm, variables, jnp.asarray(x), compute_dtype=jnp.bfloat16,
                            interpret=True)
    got = einv2_htsat_fused_forward(tm, torch.from_numpy(x))
    f32 = einv2_htsat_fused_forward(tm, torch.from_numpy(x), compute_dtype=torch.float32)
    assert all(torch.isfinite(v).all() and v.dtype == torch.float32 for v in got.values())
    ref32 = {k: np.asarray(v, np.float32) for k, v in ref.items()}
    assert _max_diff({k: v.numpy() for k, v in got.items()}, ref32) < 5e-2
    assert _max_diff({k: v.numpy() for k, v in got.items()}, f32) < 5e-2


def test_from_wav_matches_jax(rng):
    """The whole served path from the waveform on the CPU (plain K1 with
    the ScalarBN and frame pad folded, plain K8 and K2) against the JAX
    frontend (split3=False, interpret) followed by the JAX fused forward,
    float32: < 5e-5; no launch counted."""
    jm, variables, tm, _ = _pair(rng, "HTSAT")
    wav = (rng.standard_normal((2, 4, 57600)) * 0.1).astype(np.float32)
    frontend.KERNEL.launches = patch_embed.KERNEL.launches = swin_block.KERNEL.launches = 0
    got = einv2_htsat_fused_forward_from_wav(tm, wav, compute_dtype=torch.float32,
                                             device="cpu", n_mels=16)
    assert frontend.KERNEL.launches == patch_embed.KERNEL.launches == 0
    assert swin_block.KERNEL.launches == 0
    feats = jax_fused(jnp.asarray(wav), split3=False, interpret=True, **FE)
    ref = jax_fused_forward(jm, variables, feats, compute_dtype=jnp.float32, interpret=True)
    assert got["sed"].shape == ref["sed"].shape == (2, 24, 3, 5)
    assert _max_diff({k: v.numpy() for k, v in got.items()}, ref) < 5e-5
    with pytest.raises(ValueError, match="10-second"):
        einv2_htsat_fused_forward_from_wav(tm, wav[:, :, :28800], device="cpu", n_mels=16)


def test_embed_routes_and_refusals(rng, monkeypatch):
    """prepare_einv2 sends the SED branch (4 channels) to the einsum embed
    and the DOA branch to K8, and the forward takes those routes;
    swin="stage" and adapters raise."""
    _, _, tm, shape = _pair(rng, "HTSAT")
    p = prepare_einv2(tm, torch.float32)
    assert p.sed.embed is None and p.doa.embed is not None
    assert p.doa.embed.w.shape == (7 * 16, 16)
    assert len(p.sed.blocks) == len(p.doa.blocks) == 4
    assert [b.merge for b in p.sed.blocks] == [False, True, False, False]
    calls = []
    for name in ("embed_tokens", "patch_embed_tokens"):
        fn = getattr(serving_einv2, name)
        monkeypatch.setattr(serving_einv2, name,
                            lambda x, *a, _n=name, _f=fn: calls.append(_n) or _f(x, *a))
    x = torch.from_numpy(_x(rng, shape))
    einv2_htsat_fused_forward(tm, x, compute_dtype=torch.float32, params=p)
    assert calls == ["embed_tokens", "patch_embed_tokens"]
    with pytest.raises(NotImplementedError, match="no stage form"):
        einv2_htsat_fused_forward(tm, x, compute_dtype=torch.float32, swin="stage")
    with pytest.raises(NotImplementedError, match="no stage form"):
        einv2_htsat_fused_forward_from_wav(tm, np.zeros((2, 4, 57600), np.float32),
                                           device="cpu", n_mels=16, swin="stage")
    am = einv2_heads.HTSAT(num_classes=5, mel_bins=16, tgt_output_frames=24,
                           encoder_kwargs=ENC, adapt=AdaptConfig(ADAPTER)).eval()
    with pytest.raises(NotImplementedError, match="adapters"):
        prepare_einv2(am, torch.float32)
    with pytest.raises(NotImplementedError, match="adapters"):
        einv2_htsat_fused_forward(am, x, compute_dtype=torch.float32)


# --- training -------------------------------------------------------------

@pytest.mark.parametrize("kind", ["HTSAT", "HTSAT_SEDDOA"])
def test_drop_rates_train_forward_matches_jax(rng, kind):
    """The EINV2 HTSATs with drop_rate = attn_drop_rate = 0.1 and drop-path
    0.2 in train mode against the JAX model.apply(train=True), the JAX draws
    recorded and injected: the dropout masks in the JAX call order (for the
    dual encoder: SED's embed, DOA's, then stage by stage SED's blocks and
    DOA's, four masks a block), the DropPath uniforms of each stage split
    into each encoder's block masks. float32: within 5e-5."""
    jm, variables, tm, shape = _pair(rng, kind, drop_path=0.2, drop_rate=0.1,
                                     attn_drop_rate=0.1)
    x = _x(rng, shape)
    with recorded_jax_draws() as rec:
        ref, _ = jm.apply(variables, jnp.asarray(x), train=True, mutable=["batch_stats"],
                          rngs={"dropout": jax.random.PRNGKey(5)})
    drops = [torch.from_numpy(np.array(v)) for name, v in rec if name == "bernoulli"]
    uniforms = iter([r for r in rec if r[0] == "uniform"])
    encs = (tm.sed_encoder, tm.doa_encoder) if kind == "HTSAT" else (tm.encoder,)
    rates, masks, start = encs[0].block_rates(), tuple([] for _ in encs), 0
    for depth in ENC["depths"]:
        for m in masks:  # a stage's blocks, SED's then DOA's
            m.extend(take_block_mask(uniforms, r, shape[0]) for r in rates[start:start + depth])
        start += depth
    assert next(uniforms, None) is None
    assert len(drops) == len(encs) * (1 + 4 * sum(ENC["depths"]))
    assert not all(bool(m.all()) for m in drops) and not all(bool(m.all()) for m in masks[-1])
    with torch.no_grad():
        got = tm.train()(torch.from_numpy(x), dp_masks=masks if kind == "HTSAT" else masks[0],
                         dropout_draws=drops)
    assert _max_diff(got, ref) < 5e-5, _max_diff(got, ref)


def test_train_forward_with_masks_equals_stages_by_hand(rng):
    """Drop-path 0.2: the train-mode forward with injected (SED, DOA) masks
    equals the two encoders' embed / stitch / run_stage / finalize and the
    tscam heads applied by hand with the same masks; masks drawn from a
    generator are the SED encoder's then the DOA encoder's, and a dropped
    branch changes the output."""
    _, _, tm, shape = _pair(rng, "HTSAT", drop_path=0.2)
    tm.train()
    x = torch.from_numpy(_x(rng, shape))
    sed_enc, doa_enc = tm.sed_encoder, tm.doa_encoder
    gen = lambda: torch.Generator().manual_seed(5)  # noqa: E731
    g = gen()
    masks = [drop_path_masks(g, 2, enc.block_rates()) for enc in (sed_enc, doa_enc)]
    masks[0][3][0, 0] = masks[1][2][1, 1] = 0.0
    with torch.no_grad():
        got = tm(x, dp_masks=tuple(masks))
        h = tm.scalar(x)
        xs, xd = sed_enc.embed(h[:, :4]), doa_enc.embed(h)
        for i, st in enumerate(tm.stitch1):
            xs, xd = st(xs, xd)
            xs = sed_enc.run_stage(i, xs, sed_enc.stage_masks(masks[0])[i])
            xd = doa_enc.run_stage(i, xd, doa_enc.stage_masks(masks[1])[i])
        frames = (2, 24, False, 24, 10)
        sed = tscam_head(sed_enc.finalize(xs), tm.sed_tscam_conv, sed_enc.time_res, *frames)
        doa = tscam_head(doa_enc.finalize(xd), tm.doa_tscam_conv, doa_enc.time_res, *frames)
        assert torch.equal(got["sed"], sed.reshape(2, 24, 3, 5))
        assert torch.equal(got["doa"], torch.tanh(doa).reshape(2, 24, 3, 3))
        ones = tm(x, dp_masks=tuple([torch.ones(2, 2)] * 4 for _ in range(2)))
        assert not torch.equal(ones["sed"], got["sed"])
        g = gen()
        drawn = [drop_path_masks(g, 2, enc.block_rates()) for enc in (sed_enc, doa_enc)]
        assert torch.equal(tm(x, generator=gen())["doa"], tm(x, dp_masks=tuple(drawn))["doa"])
    with pytest.raises(ValueError, match="generator"):
        tm(x)


def _jax_task_step(over, rng):
    cfg_j = jax_compose_configs(over)
    task_j = JaxTask(cfg_j, _JaxSpec(), steps_per_epoch=2, num_devices=1)
    state = task_j.init_state(jax.random.PRNGKey(0))
    variables = jax.tree_util.tree_map(np.asarray, {"params": state.params,
                                                    "batch_stats": state.batch_stats})
    wav = (rng.standard_normal((2, 4, 64000)) * 0.1).astype(np.float32)
    lab = einv2_labels(rng, 2, 40, 3)
    new_state, losses_j, _ = task_j.train_step(state, {"data": wav, **lab},
                                               jax.random.PRNGKey(1))
    return variables, wav, lab, new_state, losses_j


def jax_compose_configs(over):
    from pseldnets_tpu.config import compose as jax_compose

    return jax_compose(str(ROOT / "configs"), "train", over)


@pytest.mark.parametrize("extra", [["loss=einv2_pit_agg"], ["loss=einv2_pit"],
                                   ["loss=einv2_pit", "+model.optimizer.multi_opt=true",
                                    "+model.optimizer.kwargs1.lr=0.001"]])
def test_seld_task_einv2_step_matches_jax(extra):
    """One eager EINV2 HTSAT SELDTask.train_step (tiny, B=2, drop-path 0,
    float32: frontend, train-mode ScalarBN, both encoders with the stitches,
    loss, clip, AdamW, batch statistics) against the JAX SELDTask's step from
    the same weights and batch, with the AGG and the tPIT losses and with
    multi_opt (the SED encoder at its own rate). The bounds of
    test_seld_task_crnn_step_matches_jax: loss < 1e-5, every parameter
    within 2.01 lr, all but 0.5% of the elements within 1e-6."""
    rng = np.random.default_rng(21)
    over = TINY_TASK + extra
    variables, wav, lab, new_state, losses_j = _jax_task_step(
        over + ["trainer.fused_forward=false"], rng)
    cfg = compose(str(ROOT / "configs"), "train", over)
    task = SELDTask(cfg, DatasetSpec(num_classes=3), steps_per_epoch=2, device="cpu")
    assert not task.fused_forward and isinstance(task.model, einv2_heads.HTSAT)
    task.init_state(0)
    load_jax_variables(task.model, variables)
    losses = task.train_step(wav, lab)
    for k in ("loss_all",) + tuple(k for k in losses if k != "loss_all"):
        assert abs(float(losses[k]) - float(losses_j[k])) < 1e-5, k
    ref = jax_to_torch_state_dict(jax.tree_util.tree_map(
        np.asarray, {"params": new_state.params, "batch_stats": new_state.batch_stats}))
    got = task.model.state_dict()
    assert set(ref) == set(got)
    opt = cfg["model"]["optimizer"]
    lr = max(float(opt["kwargs"]["lr"]), float((opt.get("kwargs1") or {}).get("lr", 0)))
    n_far = n_all = 0
    for name, r in ref.items():
        d = (got[name] - r).abs()
        assert float(d.max()) <= 2.01 * lr, name
        n_far += int((d > 1e-6).sum())
        n_all += d.numel()
    assert n_far <= 0.005 * n_all, (n_far, n_all)


@pytest.mark.parametrize("method", ["adapter", "mono_adapter", "none"])
def test_freeze_and_multi_opt_groups_match_jax(method):
    """On the EINV2 HTSAT's parameter names (AdapterBit adapters in both
    encoders): the port's trainable_mask and its multi_opt grouping (SED
    encoder against the rest) against the JAX package's optim.py, read off
    one SGD update of unit grads with rate 1 for the rest and 2 for the SED
    encoder (frozen leaves move 0)."""
    rng = np.random.default_rng(22)
    adapt = dict(ADAPTER, method=method)
    jm, variables, tm, _ = _pair(rng, "HTSAT", adapt=adapt)
    params = jax.tree_util.tree_map(jnp.asarray, variables["params"])
    cfg = {"model": {"optimizer": {"method": "SGD", "kwargs": {"lr": 1.0},
                                   "kwargs1": {"lr": 2.0}, "multi_opt": True}},
           "adapt": {"method": method}}
    tx, _ = jax_build_optimizer(cfg, params, 1)
    upd, _ = tx.update(jax.tree_util.tree_map(jnp.ones_like, params), tx.init(params), params)
    jax_lr = {flax_to_torch_key(p): -float(np.asarray(u).flat[0])
              for p, u in _flatten(jax.tree_util.tree_map(np.asarray, upd)).items()}
    jax_mask = {flax_to_torch_key(p): bool(m) for p, m in
                _flatten(jax.tree_util.tree_map(np.asarray,
                                                jax_trainable_mask(params, method))).items()}
    names = [n for n, _ in tm.named_parameters()]
    assert set(names) == set(jax_lr) == set(jax_mask)
    mask = dict(zip(names, trainable_mask(names, method)))
    assert mask == jax_mask
    if method == "adapter":
        assert not mask["stitch1.0.weight"] and mask["doa_tscam_conv.weight"]
        assert mask["sed_encoder.layers.0.blocks.0.mlp.adapter.fc1.weight"]
    opt, _ = build_optimizer(cfg, tm.named_parameters(), 1)
    by_id = {id(p): g["lr"] for g in opt.param_groups for p in g["params"]}
    port_lr = {n: by_id.get(id(p), 0.0) for n, p in tm.named_parameters()}
    assert port_lr == jax_lr
    assert {v for v in port_lr.values()} >= {1.0, 2.0}


# --- the factory ----------------------------------------------------------

TINY_HTSAT = ["model.kwargs.spec_size=64", "model.kwargs.embed_dim=8", "model.kwargs.depths=[1,1]",
              "model.kwargs.num_heads=[2,4]", "model.kwargs.window_size=4",
              "model.kwargs.tgt_output_frames=24", "data.n_mels=16"]
BACKBONES = {
    "CRNN": ["model=crnn", "model.kwargs.num_features=[8,8,8,8,8,8]"],
    "ConvConformer": ["model=crnn", "model.backbone=ConvConformer",
                      "model.kwargs.num_features=[8,8,8,8]"],
    "HTSAT": TINY_HTSAT,
    "HTSAT_SEDDOA": TINY_HTSAT + ["model.backbone=HTSAT_SEDDOA"],
    "PASST": ["model=passt", "model.kwargs.depth=3", "model.kwargs.embed_dim=24",
              "model.kwargs.num_heads=2", "model.decoder=transformer"],
}


@pytest.mark.parametrize("loss", ["einv2_pit", "einv2_pit_agg"])
@pytest.mark.parametrize("backbone", list(BACKBONES))
def test_factory_builds_every_einv2_backbone(loss, backbone):
    """build_model on compose(...) with each EINV2 loss builds the class the
    JAX factory builds from the same config, and the bridge fills it
    strictly, keys and shapes, from that model's tree (zeros of
    jax.eval_shape's shapes); seeded stitches in U(0.1, 0.9)."""
    over = [f"loss={loss}", "model.kwargs.pretrained_path=null",
            "model.kwargs.audioset_pretrain=false"] + BACKBONES[backbone]
    cfg = compose(str(ROOT / "configs"), "train", over)
    model, meta = build_model(cfg, 13, device="cpu", seed=1)
    cls = "CRNN" if backbone == "ConvConformer" else backbone
    assert type(model) is getattr(einv2_heads, cls) and meta["method"] == "einv2"
    jm, _ = jax_build_model(jax_compose_configs(over), 13)
    assert type(jm).__name__ == cls
    T = {"PASST": 1001}.get(backbone, 241 if "HTSAT" in backbone else 80)
    F = 16 if "HTSAT" in backbone else 64
    shapes = jax.eval_shape(lambda: jm.init({"params": jax.random.PRNGKey(0)},
                                            jnp.zeros((2, 7, T, F)), train=False))
    zeros = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32),
                                   flax.core.unfreeze(shapes))
    jax_to_torch_state_dict(zeros, model)  # raises on a key or shape that differs
    ws = [m.weight.detach().flatten() for m in model.modules() if isinstance(m, CrossStitch)]
    assert bool(ws) == (backbone != "HTSAT_SEDDOA")
    if ws:
        w = torch.cat(ws)
        assert 0.1 <= float(w.min()) and float(w.max()) <= 0.9 and float(w.std()) > 0.1
    if backbone == "ConvConformer":
        assert model.sed_track1.kind == "conformer"


def test_seddoa_experiment_builds():
    """configs/experiment/synth_seddoa_agg.yaml with its shipped
    augmentation: the task builds the full-width HTSAT_SEDDOA with the AGG
    loss and the experiment's augmentation (augmix.yaml, as the JAX
    package composes it); synth_einv2_agg builds the dual-encoder HTSAT."""
    for exp, cls in (("synth_seddoa_agg", einv2_heads.HTSAT_SEDDOA),
                     ("synth_einv2_agg", einv2_heads.HTSAT)):
        over = [f"experiment={exp}", "model.kwargs.pretrained_path=null"]
        cfg = compose(str(ROOT / "configs"), "train", over)
        task = SELDTask(cfg, DatasetSpec(num_classes=13), device="cpu")
        assert type(task.model) is cls and not task.fused_forward
        assert type(task.loss).__name__ == "AggPitLoss"
        aug = jax_compose_configs(over)["augment"]
        assert task.aug_type == list(aug["type"]) and task.augmix is bool(aug["AugMix"]) is True
        assert "trackmix" in task.aug_type and "wavmix" in task.aug_type and task.aug_tf_comb
