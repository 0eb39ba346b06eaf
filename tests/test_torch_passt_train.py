"""PaSST training in the port against the JAX package on the CPU, the parts
of tests/test_torch_passt.py's train-mode checks that need more than the
single head: the EINV2 dual PaSST's train-mode forward and one SELDTask
step of each PaSST head against the JAX step, with the JAX draws recorded
(test_torch_passt.recorded_jax_draws) and injected."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pseldnets_tpu.config import compose as jax_compose
from pseldnets_tpu.train.module import SELDTask as JaxTask
from pseldnets_tpu_torch.config import compose
from pseldnets_tpu_torch.train.checkpoint import jax_to_torch_state_dict, load_jax_variables
from pseldnets_tpu_torch.train.module import DatasetSpec, SELDTask
import torch_threads  # noqa: F401  (each xdist worker's share of the cores)
from test_torch_passt import (ROOT, TRAIN_SETTINGS, _train_pair, check_train_forward,
                              port_draws, recorded_jax_draws)
from test_torch_train import _adpit_labels, _JaxSpec, einv2_labels


@pytest.mark.parametrize("setting", [TRAIN_SETTINGS[0], TRAIN_SETTINGS[-1]])
def test_einv2_train_mode_matches_jax(setting):
    """The EINV2 dual PaSST in eval and in train mode against the JAX one,
    as above: each encoder its own draws (SED's forward_before first), the
    blocks' masks interleaved as the JAX blocks run, a stitch before every
    block; the crop alone, then every setting at once."""
    check_train_forward(setting, einv2=True)


def test_einv2_decoders_drop_out_as_jax():
    """The EINV2 dual PaSST with transformer track decoders (one layer, its
    dropout 0.1) in train mode against the JAX model.apply(train=True),
    whose decoders take ``deterministic=not train`` (its
    einv2_heads.py:263-264): the crop's draws and the decoders' dropout
    masks (four a decoder, SED track i then DOA track i) recorded and
    injected, float32: within 5e-5."""
    rng = np.random.default_rng(23)
    jm, variables, tm, x, enc = _train_pair(rng, {}, True, decoder="transformer")
    with recorded_jax_draws() as rec:
        ref, _ = jm.apply(variables, jnp.asarray(x), train=True, mutable=["batch_stats"],
                          rngs={"dropout": jax.random.PRNGKey(5),
                                "patchout": jax.random.PRNGKey(6)})
    drops = [torch.from_numpy(np.array(v)) for name, v in rec if name == "bernoulli"]
    draws, masks = port_draws([r for r in rec if r[0] != "bernoulli"], enc, x.shape[0], 2)
    assert len(drops) == 6 * 4 and not all(bool(m.all()) for m in drops)
    with torch.no_grad():
        got = tm(torch.from_numpy(x), dp_masks=tuple(masks), patchout_draws=tuple(draws),
                 dropout_draws=drops)
    for k in ("sed", "doa"):
        assert np.abs(got[k].numpy() - np.asarray(ref[k])).max() < 5e-5, k


# the step tests' tiny PaSST: 2 s chunks (201 frames, 20 label frames) at
# the shipped patch 16, stride 10, frequency patchout, position dropout and
# drop-path on
STEP_PASST = ["model=passt", "model.kwargs.pretrained_path=null",
              "model.kwargs.audioset_pretrain=false", "model.kwargs.depth=2",
              "model.kwargs.embed_dim=24", "model.kwargs.num_heads=2",
              "model.kwargs.img_size=[64,201]", "data.train_chunklen_sec=2",
              "model.kwargs.s_patchout_f=1", "model.kwargs.drop_rate=0.1",
              "model.kwargs.drop_path_rate=0.5"]


@pytest.mark.parametrize("loss", ["multi_accdoa", "einv2_pit"])
def test_seld_task_passt_step_matches_jax(loss):
    """One eager SELDTask.train_step of the PaSST mACCDOA head and of the
    EINV2 dual PaSST (tiny, B=2, float32: frontend, batch-statistics
    ScalarBN, the structured frequency patchout, position dropout and
    drop-path, loss, clip, AdamW, batch statistics) against the JAX
    SELDTask's step from the same weights and batch, the JAX step's draws
    (its ``patchout`` and ``dropout`` keys, fold_in(key, 2) and (key, 1))
    recorded from an unjitted apply and injected: loss within 1e-5, every
    parameter within 2.01 lr (AdamW's sign-flip band), all but 0.5% of the
    elements within 1e-6."""
    over = STEP_PASST + [f"loss={loss}"]
    rng = np.random.default_rng(31)
    task_j = JaxTask(jax_compose(str(ROOT / "configs"), "train", over), _JaxSpec(),
                     steps_per_epoch=2, num_devices=1)
    state = task_j.init_state(jax.random.PRNGKey(0))
    variables = jax.tree_util.tree_map(np.asarray, {"params": state.params,
                                                    "batch_stats": state.batch_stats})
    wav = (rng.standard_normal((2, 4, 48000)) * 0.1).astype(np.float32)
    lab = (einv2_labels(rng, 2, 20, 3) if loss.startswith("einv2")
           else {"adpit_label": _adpit_labels(rng, 2, 20, 3)})
    key = jax.random.PRNGKey(1)
    new_state, losses_j, _ = task_j.train_step(state, {"data": wav, **lab}, key)
    with recorded_jax_draws() as rec:
        task_j.model.apply(variables, jnp.zeros((2, 7, 201, 64)), train=True,
                           mutable=["batch_stats"],
                           rngs={"dropout": jax.random.fold_in(key, 1),
                                 "patchout": jax.random.fold_in(key, 2)})
    cfg = compose(str(ROOT / "configs"), "train", over)
    task = SELDTask(cfg, DatasetSpec(num_classes=3), steps_per_epoch=2, device="cpu")
    assert not task.fused_forward
    enc = dict(cfg["model"]["kwargs"], depth=2)
    einv2 = loss.startswith("einv2")
    draws, masks = port_draws(rec, enc, 2, 2 if einv2 else 1)
    assert any((m == 0).any() for ms in masks for m in ms)
    task.init_state(0)
    load_jax_variables(task.model, variables)
    losses = task.train_step(wav, lab, dp_masks=tuple(masks) if einv2 else masks[0],
                             patchout_draws=tuple(draws) if einv2 else draws[0])
    for k in losses:
        assert abs(float(losses[k]) - float(losses_j[k])) < 1e-5, k
    ref = jax_to_torch_state_dict(jax.tree_util.tree_map(
        np.asarray, {"params": new_state.params, "batch_stats": new_state.batch_stats}))
    got = task.model.state_dict()
    assert set(ref) == set(got)
    lr = float(cfg["model"]["optimizer"]["kwargs"]["lr"])
    n_far = n_all = 0
    for name, r in ref.items():
        d = (got[name] - r).abs()
        assert float(d.max()) <= 2.01 * lr, name
        n_far += int((d > 1e-6).sum())
        n_all += d.numel()
    assert n_far <= 0.005 * n_all, (n_far, n_all)
