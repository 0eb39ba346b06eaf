"""The port's eval step against the JAX package's on the CPU: SELDTask.eval_step
on every eval route (HTSAT plain and AdapterBit, PaSST, the EINV2 HTSAT, the
CRNN with a conformer and with no decoder, and one eager head) on an odd
batch, against the JAX SELDTask.eval_step (which on the CPU is
``model.apply``) from the same weights; ACS with an EINV2 head raising; and
the reference-checkpoint loader against the JAX
``load_seld_inference_ckpt`` on a checkpoint the test writes.

Bound: < 5e-5 in float32 against the JAX step (the port's parity bound). ACS and the
bf16 band are in test_torch_eval_acs.py."""

import functools
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pseldnets_tpu.config import compose as jax_compose
from pseldnets_tpu.data.datasets import BaseDatasetSpec
from pseldnets_tpu.train.checkpoint import load_seld_inference_ckpt as jax_load_ckpt
from pseldnets_tpu.train.module import SELDTask as JaxTask
from pseldnets_tpu_torch.config import compose
from pseldnets_tpu_torch.ops import frontend
from pseldnets_tpu_torch.train.checkpoint import jax_to_torch_state_dict, load_jax_variables
from pseldnets_tpu_torch.train.module import DatasetSpec, SELDTask
import torch_threads  # noqa: F401  (each xdist worker's share of the cores)
from test_torch_swin_block import randomize

ROOT = Path(__file__).resolve().parents[1]
# a tiny HTSAT whose frontend shape K1 takes with folds (n_fft 1024, an even
# hop below it): 4 s clips of 64000 samples are the full clip, which the
# eval step takes from the waveform (201 frames, 40 label frames); 2 s clips
# take the 5 s trick through the extractor
TINY = ["data.sample_rate=16000", "data.nfft=1024", "data.n_mels=16", "data.hoplen=320",
        "data.train_chunklen_sec=4", "model.kwargs.spec_size=64", "model.kwargs.embed_dim=8",
        "model.kwargs.depths=[1,1]", "model.kwargs.num_heads=[2,4]",
        "model.kwargs.window_size=4", "model.kwargs.drop_path_rate=0.0",
        "model.kwargs.tgt_output_frames=40"]
HTSAT = ["loss=multi_accdoa", "model.kwargs.pretrained_path=null"] + TINY
PASST = ["model=passt", "loss=multi_accdoa", "model.kwargs.pretrained_path=null",
         "model.kwargs.audioset_pretrain=false", "model.kwargs.depth=1",
         "model.kwargs.embed_dim=24", "model.kwargs.num_heads=2",
         "model.kwargs.img_size=[16,201]"] + TINY[:5]
# the CRNN at 2 s and 24 kHz (the JAX head reshapes 2 s, not 1 s, clips)
CRNN = ["model=crnn", "loss=accdoa", "model.kwargs.pretrained_path=null",
        "model.kwargs.audioset_pretrain=false", "model.kwargs.num_features=[8,8,8,8,8,8]",
        "data.train_chunklen_sec=2"]
ROUTES = {
    "htsat": (HTSAT, 64000, "htsat"),
    "htsat_5s": (HTSAT, 32000, "htsat"),
    "adapterbit": (HTSAT + ["adapt=adapter"], 64000, "htsat"),
    "passt": (PASST, 64000, "passt"),
    "einv2": (HTSAT + ["loss=einv2_pit"], 64000, "einv2"),
    "einv2_5s": (HTSAT + ["loss=einv2_pit"], 32000, "einv2"),
    "crnn_conformer": (CRNN + ["model.decoder=conformer"], 48000, "crnn"),
    "crnn_null": (CRNN + ["model.decoder=null"], 48000, "crnn"),
    "eager_gru": (["model=default", "loss=accdoa", "model.kwargs.num_features=[8,8,16,16]",
                   "model.num_decoder_layers=1", "data.train_chunklen_sec=2"], 48000, "eager"),
}


class _JaxSpec(BaseDatasetSpec):
    def __init__(self):
        super().__init__()
        self.label_dic = {f"c{i}": i for i in range(3)}
        self.max_ov = 3


def _random_stats(tree, rng, path=()):
    """Eval statistics away from (0, 1): the ScalarBN's at the scale of dB
    features, every other BatchNorm's near (0, 1)."""
    out = {}
    for k, v in tree.items():
        if hasattr(v, "items"):
            out[k] = _random_stats(v, rng, path + (k,))
            continue
        v = np.asarray(v)
        scalar = "scalar" in path
        if k == "running_mean":
            out[k] = (rng.standard_normal(v.shape) * (5.0 if scalar else 0.1)
                      - (20.0 if scalar else 0.0)).astype(np.float32)
        else:
            out[k] = (rng.random(v.shape) * (50.0 if scalar else 1.0)
                      + (10.0 if scalar else 0.5)).astype(np.float32)
    return out


@functools.lru_cache(maxsize=None)
def _jax_side(over):
    """A JAX SELDTask (one device), its eval state and its variables: seeded
    random weights and eval statistics (no optimizer: the eval step reads
    the parameters and the statistics only)."""
    rng = np.random.default_rng(0)
    task_j = JaxTask(jax_compose(str(ROOT / "configs"), "train", list(over)), _JaxSpec(),
                     steps_per_epoch=2, num_devices=1)
    feats = task_j._forward_features(task_j._dummy_batch())
    init = jax.jit(lambda r, f: task_j.model.init({"params": r, "dropout": r, "patchout": r},
                                                  f, train=False))(jax.random.PRNGKey(0), feats)
    init = jax.tree_util.tree_map(np.asarray, dict(init))
    variables = {"params": randomize(init["params"], rng),
                 "batch_stats": _random_stats(init.get("batch_stats", {}), rng)}
    state = types.SimpleNamespace(**{k: jax.tree_util.tree_map(jnp.asarray, v)
                                     for k, v in variables.items()})
    return task_j, state, variables


def _pair(over):
    """The JAX side of ``over`` and a port SELDTask on the CPU holding the
    same weights and statistics."""
    task_j, state, variables = _jax_side(tuple(over))
    task = SELDTask(compose(str(ROOT / "configs"), "train", over), DatasetSpec(num_classes=3),
                    steps_per_epoch=2, device="cpu")
    task.init_state(0)
    load_jax_variables(task.model, variables)
    return task_j, state, task, variables


def _wav(B, n, seed=1):
    return (np.random.default_rng(seed).standard_normal((B, 4, n)) * 0.1).astype(np.float32)


def _max_diff(got, want):
    assert set(got) == set(want)
    return max(float(np.abs(got[k].numpy() - np.asarray(want[k])).max()) for k in want)


@pytest.mark.parametrize("name", list(ROUTES))
def test_eval_step_matches_jax(name):
    """An odd batch of 3 (the repeat pad to 4, sliced back) through the
    port's route and through the JAX eval step: < 5e-5 in float32."""
    over, n, route = ROUTES[name]
    task_j, state, task, _ = _pair(over)
    assert task.eval_route() == route
    x = _wav(3, n)
    want = task_j.eval_step(state, {"data": x})
    got = task.eval_step({"data": x})
    assert all(v.shape[0] == 3 and v.dtype == torch.float32 for v in got.values())
    err = _max_diff(got, want)
    assert err < 5e-5, (name, err)


def test_eval_step_routes_from_the_waveform(monkeypatch):
    """A full clip at a frontend shape that folds (an even hop below an
    even n_fft) goes in from the waveform, the frontend folding the eval
    ScalarBN; the 5 s clip and a shape that does not fold (hop >= n_fft)
    go through the extractor, with or without the kernels."""
    folded = []
    real = frontend.fused_logmel_iv_plain

    def spy(x, **kw):
        folded.append(kw.get("post_affine") is not None)
        return real(x, **kw)

    monkeypatch.setattr(frontend, "fused_logmel_iv_plain", spy)
    _, _, task, _ = _pair(HTSAT)
    assert task._folds_from_wav(torch.zeros(2, 4, 64000))
    assert not task._folds_from_wav(torch.zeros(2, 4, 32000))
    task.set_use_kernels(False)
    assert task._folds_from_wav(torch.zeros(2, 4, 64000))
    task = SELDTask(compose(str(ROOT / "configs"), "train", HTSAT + ["data.nfft=256"]),
                    DatasetSpec(num_classes=3), device="cpu")
    assert not task._folds_from_wav(torch.zeros(2, 4, 64000))
    _, _, task, _ = _pair(CRNN + ["model.decoder=null"])
    task.eval_step({"data": _wav(2, 48000)})
    assert folded == [True]  # n_fft 1024: K1's plain version with the folds


def test_acs_with_einv2_raises():
    """The JAX ACS step has no EINV2 outputs (a KeyError on "accdoa"); the
    port says so."""
    _, _, task, _ = _pair(HTSAT + ["loss=einv2_pit"])
    with pytest.raises(ValueError, match="ACS"):
        task.eval_step({"data": _wav(2, 64000)}, post_processing="ACS")


def _reference_ckpt(path, variables, model, drop=()):
    """A reference-format checkpoint: the bridge's keys (the reference's torch
    names), the fused ScalarBN split into scalar.{c}.* rows, a Lightning
    ``state_dict`` wrapper with ``net.`` and ``_orig_mod.`` prefixes, an
    ``af_extractor`` entry and a ``num_batches_tracked`` counter."""
    rows = {}
    for k, v in jax_to_torch_state_dict(variables, model).items():
        if k.startswith("scalar."):
            rows.update({f"scalar.{c}.{k[7:]}": v[c].clone() for c in range(v.shape[0])})
        elif k not in drop:
            rows[k] = v
    rows["af_extractor.mel.weight"] = torch.zeros(3)
    rows["scalar.0.num_batches_tracked"] = torch.tensor(5)
    torch.save({"state_dict": {f"net._orig_mod.{k}": v for k, v in rows.items()},
                "epoch": 3}, path)


@pytest.mark.parametrize("over", [HTSAT, CRNN + ["model.decoder=conformer"]],
                         ids=["htsat", "crnn_conformer"])
def test_checkpoint_loads_like_jax(tmp_path, over):
    """One reference-format .ckpt read by the JAX load_seld_inference_ckpt
    and the port's init_state(ckpt_path=...): the port's state is the
    bridge's exactly, and both eval steps agree (< 5e-5). An existing
    pretrained_path does not stop the load (the JAX order: ckpt_path
    first)."""
    task_j, state, task, variables = _pair(over)
    ckpt = tmp_path / "model.ckpt"
    _reference_ckpt(ckpt, variables, task.model)
    loaded, report = jax_load_ckpt(variables, str(ckpt))
    loaded = types.SimpleNamespace(**{k: jax.tree_util.tree_map(jnp.asarray, v)
                                      for k, v in loaded.items()})
    pre = tmp_path / "pretrained.ckpt"
    pre.write_bytes(b"not read")
    port = SELDTask(compose(str(ROOT / "configs"), "train",
                            over + [f"model.kwargs.pretrained_path={pre}"]),
                    DatasetSpec(num_classes=3), steps_per_epoch=2, device="cpu")
    port.init_state(5, ckpt_path=str(ckpt))
    for k, v in task.model.state_dict().items():
        assert torch.equal(port.model.state_dict()[k], v), k
    x = _wav(2, 64000 if over[0] != "model=crnn" else 48000)
    assert _max_diff(port.eval_step({"data": x}), task_j.eval_step(loaded, {"data": x})) < 5e-5


def test_checkpoint_missing_key_and_orbax_directory_raise(tmp_path):
    _, _, task, variables = _pair(HTSAT)
    ckpt = tmp_path / "short.ckpt"
    _reference_ckpt(ckpt, variables, task.model, drop=("tscam_conv.weight",))
    with pytest.raises(KeyError, match="tscam_conv.weight"):
        task.init_state(0, ckpt_path=str(ckpt))
    extra = tmp_path / "extra.ckpt"
    _reference_ckpt(extra, variables, task.model)
    sd = torch.load(extra, weights_only=False)
    sd["state_dict"]["net.head.stray.weight"] = torch.zeros(2)
    torch.save(sd, extra)
    with pytest.raises(KeyError, match="head.stray.weight"):
        task.init_state(0, ckpt_path=str(extra))
    with pytest.raises(NotImplementedError, match="reads only .ckpt files"):
        task.init_state(0, ckpt_path=str(tmp_path))
