"""The port's training slice against the JAX package on the CPU: the ACCDOA
and ADPIT losses, the optimizers against optax, train-mode ScalarBN against
flax, the fused training forward (plain versions of K2/K3) against the JAX
one in interpret mode, and one SELDTask step against the JAX SELDTask (the
CRNN's with its decoder dropout, the JAX draws injected); plus the settings
that do not train, which raise."""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pseldnets_tpu.config import compose as jax_compose
from pseldnets_tpu.data.datasets import BaseDatasetSpec
from pseldnets_tpu.losses import build_loss as jax_build_loss
from pseldnets_tpu.models import heads as jax_heads
from pseldnets_tpu.models.common import ScalarBN as JaxScalarBN
from pseldnets_tpu.train.fused_forward import htsat_fused_train_forward as jax_fused_train
from pseldnets_tpu.train.module import SELDTask as JaxTask
from pseldnets_tpu.train.optim import build_optimizer as jax_build_optimizer
from pseldnets_tpu_torch.config import compose
from pseldnets_tpu_torch.losses import build_loss
from pseldnets_tpu_torch.models import heads
from pseldnets_tpu_torch.models.common import ScalarBN
from pseldnets_tpu_torch.models.common import drop_path_masks
from pseldnets_tpu_torch.train.checkpoint import jax_to_torch_state_dict, load_jax_variables
from pseldnets_tpu_torch.train.fused_forward import htsat_fused_train_forward
from pseldnets_tpu_torch.train.module import DatasetSpec, SELDTask
from pseldnets_tpu_torch.train.optim import build_optimizer, optimizer_step
import torch_threads  # noqa: F401  (each xdist worker's share of the cores)
from test_torch_swin_block import randomize

ROOT = Path(__file__).resolve().parents[1]
TINY_ENC = dict(spec_size=64, patch_size=4, patch_stride=(4, 4), embed_dim=16,
                depths=(2, 2), num_heads=(2, 4), window_size=4, mlp_ratio=2.0)
# tests/test_fused_train.py:212-220, drop-path 0
TINY_TASK = ["loss=multi_accdoa", "data.sample_rate=16000", "data.nfft=256", "data.n_mels=16",
             "data.hoplen=320", "data.train_chunklen_sec=4", "model.kwargs.spec_size=64",
             "model.kwargs.embed_dim=8", "model.kwargs.depths=[1,1]",
             "model.kwargs.num_heads=[2,4]", "model.kwargs.window_size=4",
             "model.kwargs.drop_path_rate=0.0", "model.kwargs.tgt_output_frames=40",
             "model.kwargs.pretrained_path=null"]


def _adpit_labels(rng, B, T, K):
    """ADPIT labels (B, T, 6, 4, K) with every overlap group in use: track A
    alone, B0/B1 (two sources of one class) and C0/C1/C2 (three)."""
    lab = np.zeros((B, T, 6, 4, K), np.float32)
    act = rng.random((B, T, 6, K)) < 0.4
    doa = rng.standard_normal((B, T, 6, 3, K)).astype(np.float32)
    doa /= np.linalg.norm(doa, axis=3, keepdims=True)
    lab[:, :, :, 0] = act
    lab[:, :, :, 1:] = doa * act[:, :, :, None]
    return lab


def test_adpit_loss_matches_jax(rng):
    """Random overlaps (B and C groups), then exact ties: silent labels and
    a zero output make all 13 permutations equal, and the first one wins."""
    B, T, K = 3, 20, 5
    lab = _adpit_labels(rng, B, T, K)
    out = np.tanh(rng.standard_normal((B, T, 9 * K))).astype(np.float32)
    cfg = {"_target_": "loss.multi_accdoa.Losses", "loss_fn": "mse", "loss_type": "loss_all"}
    ref = jax_build_loss(cfg)({"multi_accdoa": jnp.asarray(out)}, {"adpit_label": jnp.asarray(lab)})
    got = build_loss(cfg)({"multi_accdoa": torch.from_numpy(out)},
                          {"adpit_label": torch.from_numpy(lab)})
    assert abs(float(got["loss_all"]) - float(ref["loss_all"])) < 1e-6
    zero = np.zeros_like(lab)
    zero[:, :, 0, 0] = 1.0  # active, DOA 0: every permutation gives the same loss
    t0 = build_loss(cfg)({"multi_accdoa": torch.zeros(B, T, 9 * K)},
                         {"adpit_label": torch.from_numpy(zero)})
    r0 = jax_build_loss(cfg)({"multi_accdoa": jnp.zeros((B, T, 9 * K))},
                             {"adpit_label": jnp.asarray(zero)})
    assert float(t0["loss_all"]) == float(r0["loss_all"]) == 0.0


@pytest.mark.parametrize("loss_fn", ["mse", "l1"])
def test_accdoa_loss_matches_jax(rng, loss_fn):
    pred = rng.standard_normal((2, 10, 39)).astype(np.float32)
    lab = rng.standard_normal((2, 10, 39)).astype(np.float32)
    cfg = {"_target_": "loss.accdoa.Losses", "loss_fn": loss_fn}
    ref = jax_build_loss(cfg)({"accdoa": jnp.asarray(pred)}, {"accdoa_label": jnp.asarray(lab)})
    got = build_loss(cfg)({"accdoa": torch.from_numpy(pred)},
                          {"accdoa_label": torch.from_numpy(lab)})
    assert abs(float(got["loss_all"]) - float(ref["loss_all"])) < 1e-6


@pytest.mark.parametrize("method,kwargs", [
    ("AdamW", {"lr": 1e-3, "weight_decay": 0.01}),
    ("Adam", {"lr": 1e-3}),
    ("SGD", {"lr": 1e-2, "momentum": 0.9, "nesterov": True}),
    ("RMSprop", {"lr": 1e-3, "alpha": 0.9, "momentum": 0.5}),
])
def test_optimizer_steps_match_optax(rng, method, kwargs):
    """Three steps on the same grads with StepLR (the rate halves after two
    epochs of one step) and clipping at global norm 1.0 (steps 1 and 3 clip,
    step 2 does not): parameters within float32 rounding of optax."""
    cfg = {"model": {"optimizer": {"method": method, "kwargs": kwargs},
                     "lr_scheduler": {"method": "StepLR", "kwargs": {"step_size": 2, "gamma": 0.5}}},
           "trainer": {"gradient_clip_val": 1.0}}
    shapes = {"a": (7, 5), "b": (5,), "c": (3, 4, 2)}
    p0 = {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
    grads = [{k: (rng.standard_normal(s) * sc).astype(np.float32) for k, s in shapes.items()}
             for sc in (3.0, 0.05, 1.0)]
    tx, _ = jax_build_optimizer(cfg, {k: jnp.asarray(v) for k, v in p0.items()}, 1)
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    st = tx.init(jp)
    names = list(shapes)
    tp = [torch.from_numpy(p0[k].copy()) for k in names]
    opt, lr_fn = build_optimizer(cfg, zip(names, tp), 1)
    assert [lr_fn(s) for s in range(4)] == [kwargs["lr"]] * 2 + [kwargs["lr"] * 0.5] * 2
    for step, g in enumerate(grads):
        upd, st = tx.update({k: jnp.asarray(v) for k, v in g.items()}, st, jp)
        jp = jax.tree_util.tree_map(lambda p, u: p + u, jp, upd)
        optimizer_step(opt, tp, [torch.from_numpy(g[k].copy()) for k in names], step,
                       cfg["trainer"]["gradient_clip_val"])
        for k, t in zip(names, tp):
            np.testing.assert_allclose(t.numpy(), np.asarray(jp[k]), rtol=2e-6, atol=2e-7,
                                       err_msg=f"{method} {k}")


def test_train_mode_scalar_bn_matches_flax(rng):
    """Train-mode ScalarBN: biased batch variance for the output, running
    mean and unbiased running variance moved by momentum 0.1."""
    x = (rng.standard_normal((4, 7, 50, 16)) * 3 + 1).astype(np.float32)
    jm = JaxScalarBN(num_channels=7, mel_bins=16)
    v = jm.init(jax.random.PRNGKey(0), jnp.asarray(x))
    params = {"bn": {"weight": (1 + 0.1 * rng.standard_normal((7, 16))).astype(np.float32),
                     "bias": (0.1 * rng.standard_normal((7, 16))).astype(np.float32)}}
    stats = {"bn": {"running_mean": rng.standard_normal((7, 16)).astype(np.float32),
                    "running_var": (rng.random((7, 16)) + 0.5).astype(np.float32)}}
    ref, new = jm.apply({"params": params, "batch_stats": stats}, jnp.asarray(x),
                        use_running_average=False, mutable=["batch_stats"])
    bn = ScalarBN(7, 16)
    with torch.no_grad():
        for name, val in [*params["bn"].items(), *stats["bn"].items()]:
            getattr(bn, name).copy_(torch.from_numpy(val))
    bn.train()
    got = bn(torch.from_numpy(x))
    assert np.abs(got.detach().numpy() - np.asarray(ref)).max() < 1e-5
    for k in ("running_mean", "running_var"):
        np.testing.assert_allclose(getattr(bn, k).numpy(),
                                   np.asarray(new["batch_stats"]["bn"][k]), rtol=1e-6, atol=1e-6)


def _tiny_models(rng, drop_path):
    jm = jax_heads.HTSAT(num_classes=3, in_channels=7, mel_bins=16, num_tracks=1,
                         tgt_output_frames=24,
                         encoder_kwargs=tuple(TINY_ENC.items()) + (("drop_path_rate", drop_path),))
    x = rng.standard_normal((2, 7, 241, 16)).astype(np.float32)
    v = jm.init(jax.random.PRNGKey(0), jnp.asarray(x), train=False)
    variables = {"params": randomize(v["params"], rng),
                 "batch_stats": jax.tree_util.tree_map(np.asarray, v["batch_stats"])}
    tm = heads.HTSAT(num_classes=3, in_channels=7, mel_bins=16, num_tracks=1,
                     tgt_output_frames=24, encoder_kwargs=dict(TINY_ENC, drop_path_rate=drop_path))
    load_jax_variables(tm, variables)
    return jm, variables, tm.train(), x


def _jax_masks(key, B, drop_path, n_blocks):
    """The JAX fused forward's masks: fold_in(dropout_rng, bi) after bi += 1
    (train/fused_forward.py:119-128)."""
    out = []
    for bi, rate in enumerate(np.linspace(0, drop_path, n_blocks), start=1):
        if rate > 0.0:
            keep = 1.0 - float(rate)
            m = jax.random.bernoulli(jax.random.fold_in(key, bi), keep, (B, 2))
            out.append(np.asarray(m.astype(jnp.float32) / keep))
        else:
            out.append(np.ones((B, 2), np.float32))
    return out


@pytest.mark.parametrize("drop_path", [0.0, 0.1])
def test_fused_train_forward_matches_jax(rng, drop_path):
    """The fused training forward on the plain versions of K2/K3 (CPU, f32)
    against the JAX fused forward with its Pallas kernels in interpret mode
    (tests/test_fused_train.py::_tiny): loss within 2e-6, the ScalarBN
    update within 1e-6, every parameter grad within 5e-4 of max(1, |grad|),
    the JAX test's band. At drop-path 0.1 the JAX masks are recomputed and
    injected."""
    jm, variables, tm, x = _tiny_models(rng, drop_path)
    y = rng.standard_normal((2, 24, 9)).astype(np.float32)
    key = jax.random.PRNGKey(3)

    def loss_jax(params):
        preds, new_bs = jax_fused_train(jm, {"params": params, "batch_stats": variables["batch_stats"]},
                                        jnp.asarray(x), dropout_rng=key,
                                        compute_dtype=jnp.float32, interpret=True)
        return jnp.mean((preds["accdoa"] - y) ** 2), new_bs

    (l_ref, bs_ref), g_ref = jax.value_and_grad(loss_jax, has_aux=True)(
        jax.tree_util.tree_map(jnp.asarray, variables["params"]))
    masks = [torch.from_numpy(np.array(m)) for m in _jax_masks(key, 2, drop_path, 4)]
    if drop_path:
        assert any((m == 0).any() for m in masks)
    preds, bs = htsat_fused_train_forward(tm, torch.from_numpy(x), dp_masks=masks,
                                          compute_dtype=torch.float32)
    loss = ((preds["accdoa"] - torch.from_numpy(y)) ** 2).mean()
    names, params = zip(*tm.named_parameters())
    grads = torch.autograd.grad(loss, params)
    assert abs(loss.item() - float(l_ref)) < 2e-6, (loss.item(), float(l_ref))
    for k in ("running_mean", "running_var"):
        np.testing.assert_allclose(bs[k].numpy(), np.asarray(bs_ref["scalar"]["bn"][k]),
                                   rtol=1e-6, atol=1e-6)
    ref = jax_to_torch_state_dict({"params": jax.tree_util.tree_map(np.asarray, g_ref)})
    worst = max(float((g - ref[n]).abs().max()) / max(1.0, float(ref[n].abs().max()))
                for n, g in zip(names, grads))
    assert worst < 5e-4, worst


def test_eager_train_model_matches_fused_forward(rng):
    """The eager model in train mode (batch statistics, drop-path through
    per-block masks) is the plain full-model reference of the fused training
    forward: with the same masks, the loss, every parameter grad and the
    ScalarBN update agree in float32 (summation order only: the fused path
    folds the q-scale into the weights and embeds by einsum)."""
    _, _, tm, x = _tiny_models(rng, 0.1)
    masks = drop_path_masks(torch.Generator().manual_seed(1), 2, tm.encoder.block_rates())
    masks[3][0, 0] = 0.0  # one dropped branch at least
    y = torch.from_numpy(rng.standard_normal((2, 24, 9)).astype(np.float32))
    names, params = zip(*tm.named_parameters())
    preds, bs = htsat_fused_train_forward(tm, torch.from_numpy(x), dp_masks=masks,
                                          compute_dtype=torch.float32)
    loss_f = ((preds["accdoa"] - y) ** 2).mean()
    g_f = torch.autograd.grad(loss_f, params)
    loss_e = ((tm(torch.from_numpy(x), dp_masks=masks)["accdoa"] - y) ** 2).mean()
    g_e = torch.autograd.grad(loss_e, params)
    assert abs(loss_f.item() - loss_e.item()) < 1e-6
    for k in ("running_mean", "running_var"):  # the eager BatchNorm wrote its own
        torch.testing.assert_close(getattr(tm.scalar, k), bs[k], rtol=1e-6, atol=1e-6)
    worst = max(float((a - b).abs().max()) / max(1.0, float(a.abs().max()))
                for a, b in zip(g_e, g_f))
    assert worst < 5e-5, worst


class _JaxSpec(BaseDatasetSpec):
    def __init__(self):
        super().__init__()
        self.label_dic = {f"c{i}": i for i in range(3)}
        self.max_ov = 3


@pytest.mark.parametrize("fused", [False, True])
def test_seld_task_step_matches_jax(rng, fused):
    """One SELDTask.train_step from the same weights and batch (tiny
    overrides, B=2, drop-path 0, float32) against the JAX SELDTask's flax
    step (trainer.fused_forward=false): frontend, forward (eager module, or
    the fused forward on the plain kernels), ADPIT loss, grads, clip 1.0,
    AdamW, batch statistics. AdamW's first step moves each parameter by
    about lr * sign(grad), so a grad within rounding of 0 may flip sign:
    every parameter lies within 2.01 lr of the JAX one, and all but 0.5%
    of the elements within 1e-6."""
    cfg_j = jax_compose(str(ROOT / "configs"), "train", TINY_TASK + ["trainer.fused_forward=false"])
    task_j = JaxTask(cfg_j, _JaxSpec(), steps_per_epoch=2, num_devices=1)
    state = task_j.init_state(jax.random.PRNGKey(0))
    variables = jax.tree_util.tree_map(np.asarray, {"params": state.params,
                                                    "batch_stats": state.batch_stats})
    wav = (rng.standard_normal((2, 4, 64000)) * 0.1).astype(np.float32)
    lab = _adpit_labels(rng, 2, 40, 3)
    new_state, losses_j, _ = task_j.train_step(state, {"data": wav, "adpit_label": lab},
                                               jax.random.PRNGKey(1))

    cfg = compose(str(ROOT / "configs"), "train",
                  TINY_TASK + [f"trainer.fused_forward={str(fused).lower()}"])
    task = SELDTask(cfg, DatasetSpec(num_classes=3), steps_per_epoch=2, device="cpu")
    assert task.fused_forward is fused
    task.init_state(0)
    load_jax_variables(task.model, variables)
    losses = task.train_step(wav, {"adpit_label": lab})
    assert abs(float(losses["loss_all"]) - float(losses_j["loss_all"])) < 1e-5
    ref = jax_to_torch_state_dict(jax.tree_util.tree_map(
        np.asarray, {"params": new_state.params, "batch_stats": new_state.batch_stats}))
    got = task.model.state_dict()
    lr = 1e-4
    n_far = n_all = 0
    for name, r in ref.items():
        d = (got[name] - r).abs()
        assert float(d.max()) <= 2.01 * lr, name
        n_far += int((d > 1e-6).sum())
        n_all += d.numel()
    assert n_far <= 0.005 * n_all, (n_far, n_all)
    assert task.state.step == 1


# ROADMAP queue C, C1: the CRNN at 2 s (1 s chunks give 96 frames after the
# three time pools, which the JAX head cannot reshape to 10 x 10 either)
TINY_CRNN = ["model=crnn", "loss=accdoa", "model.kwargs.pretrained_path=null",
             "model.kwargs.audioset_pretrain=false",
             "model.kwargs.num_features=[8,8,8,8,8,8]", "data.train_chunklen_sec=2"]


@pytest.mark.parametrize("decoder", ["null", "conformer", "transformer", "ConvConformer"])
def test_seld_task_crnn_step_matches_jax(decoder):
    """C1: one eager CRNN SELDTask.train_step (CNN12 of width 8, ACCDOA,
    float32, B=2: frontend, ScalarBN and trunk BatchNorms on batch
    statistics, decoder, loss, clip, AdamW) against the JAX SELDTask's step
    from the same weights and batch: with no decoder, with the shipped
    conformer and with the transformer at their dropout 0.1, and the
    ConvConformer backbone; the JAX step's dropout draws recorded from an
    unjitted apply on its key (fold_in(key, 1)) and injected. Bounds of
    test_seld_task_step_matches_jax, at the CRNN config's learning rate."""
    from test_torch_passt import recorded_jax_draws

    rng = np.random.default_rng(11)
    over = TINY_CRNN + (["model.backbone=ConvConformer"] if decoder == "ConvConformer"
                        else [f"model.decoder={decoder}"])
    cfg_j = jax_compose(str(ROOT / "configs"), "train", over)
    task_j = JaxTask(cfg_j, _JaxSpec(), steps_per_epoch=2, num_devices=1)
    state = task_j.init_state(jax.random.PRNGKey(0))
    variables = jax.tree_util.tree_map(np.asarray, {"params": state.params,
                                                    "batch_stats": state.batch_stats})
    wav = (rng.standard_normal((2, 4, 48000)) * 0.1).astype(np.float32)
    lab = rng.uniform(-1, 1, (2, 20, 9)).astype(np.float32)
    key = jax.random.PRNGKey(1)
    new_state, losses_j, _ = task_j.train_step(state, {"data": wav, "accdoa_label": lab}, key)
    with recorded_jax_draws() as rec:
        task_j.model.apply(variables, jnp.zeros((2, 7, 201, 64)), train=True,
                           mutable=["batch_stats"], rngs={"dropout": jax.random.fold_in(key, 1)})
    drops = [torch.from_numpy(np.array(v)) for name, v in rec if name == "bernoulli"]
    assert len(drops) == {"null": 0, "transformer": 4}.get(decoder, 7)  # one layer

    cfg = compose(str(ROOT / "configs"), "train", over)
    task = SELDTask(cfg, DatasetSpec(num_classes=3), steps_per_epoch=2, device="cpu")
    assert not task.fused_forward
    task.init_state(0)
    load_jax_variables(task.model, variables)
    losses = task.train_step(wav, {"accdoa_label": lab}, dropout_draws=drops)
    assert abs(float(losses["loss_all"]) - float(losses_j["loss_all"])) < 1e-5
    ref = jax_to_torch_state_dict(jax.tree_util.tree_map(
        np.asarray, {"params": new_state.params, "batch_stats": new_state.batch_stats}))
    got = task.model.state_dict()
    assert set(ref) <= set(got)
    lr = float(cfg["model"]["optimizer"]["kwargs"]["lr"])
    n_far = n_all = 0
    for name, r in ref.items():
        d = (got[name] - r).abs()
        assert float(d.max()) <= 2.01 * lr, name
        n_far += int((d > 1e-6).sum())
        n_all += d.numel()
    assert n_far <= 0.005 * n_all, (n_far, n_all)


# PaSST with time patchout: 2 s chunks (20 label frames) and s_patchout_t=2,
# which leaves 18 output frames
PASST_TIME_PATCHOUT = ["model=passt", "model.kwargs.pretrained_path=null",
                       "model.kwargs.depth=1", "model.kwargs.embed_dim=24",
                       "model.kwargs.num_heads=2", "model.kwargs.img_size=[64,201]",
                       "model.kwargs.s_patchout_t=2", "data.train_chunklen_sec=2"]


# the ids the cases had when PaSST and CRNN-dropout training were not ported
# and raised
@pytest.mark.parametrize("over,error,match", [
    pytest.param(TINY_CRNN + ["model.decoder=conformer"], ValueError,
                 "dropout draws or a generator", id="over0-step 9"),
    pytest.param(PASST_TIME_PATCHOUT + ["loss=multi_accdoa"], ValueError,
                 r"\[18\] output frames where the labels have \[20\]", id="over1-step 8"),
])
def test_seld_task_unported_training_raises(over, error, match):
    """C1: the conformer at its shipped dropout 0.1 trains from the step's
    generator (a finite loss, the same loss again from a generator of the
    same seed) and raises ValueError without one, not a TypeError. PaSST
    trains, but its time patchout drops output frames: the step raises
    ValueError where the JAX step fails in its loss (the JAX ADPIT loss
    refuses 18 frames against 20 here too)."""
    rng = np.random.default_rng(12)
    task = SELDTask(compose(str(ROOT / "configs"), "train", over),
                    DatasetSpec(num_classes=3), steps_per_epoch=2, device="cpu")
    task.init_state(0)
    wav = (rng.standard_normal((2, 4, 48000)) * 0.1).astype(np.float32)
    labels = ({"adpit_label": _adpit_labels(rng, 2, 20, 3)}
              if task.model.output_key == "multi_accdoa"
              else {"accdoa_label": rng.uniform(-1, 1, (2, 20, 9)).astype(np.float32)})
    generator = torch.Generator().manual_seed(0)
    if "generator" in match:
        losses = [task.compute_grads(wav, labels, torch.Generator().manual_seed(0))[0]["loss_all"]
                  for _ in range(2)]
        assert torch.isfinite(losses[0]) and torch.equal(losses[0], losses[1])
        generator = None
    with pytest.raises(error, match=match):
        task.train_step(wav, labels, generator)
    if generator is not None:  # the JAX loss refuses PaSST's 18 frames too
        with pytest.raises(TypeError):
            jax_build_loss(dict(task.cfg["model"]["loss"]))(
                {"multi_accdoa": jnp.zeros((2, 18, 27))},
                {"adpit_label": jnp.asarray(labels["adpit_label"])})


def einv2_labels(rng, B, T, K):
    """EINV2 targets: ``sed_label`` (B, T, 3, K) one-hot activity of up to
    three tracks, ``doa_label`` (B, T, 3, 3) unit vectors where active."""
    act = (rng.random((B, T, 3, 1)) < 0.6).astype(np.float32)
    sed = np.zeros((B, T, 3, K), np.float32)
    np.put_along_axis(sed, rng.integers(0, K, (B, T, 3, 1)), act, axis=3)
    doa = rng.standard_normal((B, T, 3, 3)).astype(np.float32)
    doa /= np.linalg.norm(doa, axis=-1, keepdims=True)
    return {"sed_label": sed, "doa_label": doa * act}


# EINV2 heads whole override lists: the dual PaSST with time patchout (its
# output frames fall short of the labels', as in the JAX package) and the
# CRNN with the shipped conformer dropout 0.1, which needs the step's
# generator
EINV2_PASST_TRAIN = PASST_TIME_PATCHOUT + ["loss=einv2_pit"]
EINV2_CRNN_TRAIN = TINY_CRNN + ["loss=einv2_pit", "model.decoder=conformer"]


@pytest.mark.parametrize("override,error,match", [
    # tensor parallelism is ported (tests/test_torch_tp.py); in one process
    # tp 2 does not divide the ranks and raises as the JAX task does (the
    # case keeps the id it had while tp > 1 was not ported)
    pytest.param("+trainer.tensor_parallel=2", ValueError, "does not divide the 1 process",
                 id="+trainer.tensor_parallel=2-NotImplementedError-step 11"),
    pytest.param(EINV2_PASST_TRAIN, ValueError, "output frames", id="einv2-passt-train"),
    pytest.param(EINV2_CRNN_TRAIN, ValueError, "dropout draws or a generator",
                 id="einv2-crnn-conformer-train"),
    ("model.kwargs.attn_drop_rate=0.1", ValueError, "fused_forward=true"),
])
def test_unported_training_settings_raise(override, error, match):
    """A setting (one override on the tiny HTSAT task with the fused
    forward) raises as the task is built; an EINV2 head (a whole override
    list) builds and raises at its first step: the CRNN, whose track
    decoders drop out, trains a step from a generator and raises ValueError
    without one; the dual PaSST's time patchout raises because it drops
    output frames (the JAX step fails there too)."""
    if isinstance(override, str):
        cfg = compose(str(ROOT / "configs"), "train",
                      TINY_TASK + ["trainer.fused_forward=true", override])
        with pytest.raises(error, match=match):
            SELDTask(cfg, DatasetSpec(num_classes=3), device="cpu")
        return
    rng = np.random.default_rng(13)
    task = SELDTask(compose(str(ROOT / "configs"), "train", override),
                    DatasetSpec(num_classes=3), steps_per_epoch=2, device="cpu")
    assert not task.fused_forward
    task.init_state(0)
    wav = (rng.standard_normal((2, 4, 48000)) * 0.1).astype(np.float32)
    labels = einv2_labels(rng, 2, 20, 3)
    generator = torch.Generator().manual_seed(0)
    if "generator" in match:
        losses = task.train_step(wav, labels, generator)
        assert all(torch.isfinite(v) for v in losses.values() if torch.is_tensor(v))
        generator = None
    with pytest.raises(error, match=match):
        task.train_step(wav, labels, generator)


def test_task_defaults_to_the_card():
    cfg = compose(str(ROOT / "configs"), "train", TINY_TASK)
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        SELDTask(cfg, DatasetSpec(num_classes=3))


@pytest.mark.parametrize("kind", ["file", "directory"])
def test_init_state_raises_on_an_existing_pretrained_path(tmp_path, kind):
    """Where the JAX init_state loads ``pretrained_path`` (a path that
    exists), the port loads it too (tests/test_torch_pretrained.py); a file
    that is not a checkpoint raises the error the JAX package's load raises
    on it (torch.load's), and so does a directory, instead of training from
    random weights."""
    from pseldnets_tpu.train.checkpoint import load_torch_state_dict as jax_load

    path = tmp_path / "pretrained.ckpt"
    if kind == "file":
        path.write_bytes(b"not a checkpoint")
    else:
        path.mkdir()
    cfg = compose(str(ROOT / "configs"), "train",
                  TINY_TASK + [f"model.kwargs.pretrained_path={path}"])
    task = SELDTask(cfg, DatasetSpec(num_classes=3), steps_per_epoch=2, device="cpu")
    assert task.meta["pretrained_path"] == str(path)
    with pytest.raises(Exception) as jax_err:
        jax_load(str(path))
    with pytest.raises(type(jax_err.value)):
        task.init_state(0)
    assert task.state is None


@pytest.mark.parametrize("name", ["missing.ckpt", ""])
def test_init_state_builds_without_a_pretrained_file(tmp_path, name):
    """C2: a pretrained path that does not exist (or is empty) builds and
    initialises from the seed, as the JAX package trains from random
    weights then; two inits with one seed give equal weights."""
    path = tmp_path / name if name else ""
    cfg = compose(str(ROOT / "configs"), "train",
                  TINY_TASK + [f"model.kwargs.pretrained_path={path}"])
    task = SELDTask(cfg, DatasetSpec(num_classes=3), steps_per_epoch=2, device="cpu")
    state = task.init_state(0)
    assert state.step == 0 and task.state is state
    first = {k: v.clone() for k, v in task.model.state_dict().items()}
    task.init_state(0)
    for k, v in task.model.state_dict().items():
        assert torch.equal(v, first[k]), k
