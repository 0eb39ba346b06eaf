"""The port's pretrained loading (train/checkpoint.py ``load_pretrained``
and ``SELDTask.init_state``) against the JAX package's load_pretrained on
the CPU. Each case writes a synthetic file with ``torch.save``, shaped as
the reference's released files are (the AudioSet HTSAT's ``sed_model.``
prefixes, a 1-channel patch embed, ``bn0`` over the mels, head and tscam
keys; PaSST's pos-embed grids; PANNs' ``model`` entry with a 1-channel first
conv; a SELD whole model), loads it into a tiny JAX model and into the same
model bridged to the port, and compares the loaded parameters through the
weight bridge (equal, or within 1e-6 for PaSST's resized pos-embed), the
report's key lists, and a float32 forward within 5e-5."""

from pathlib import Path

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pseldnets_tpu.config import compose as jax_compose
from pseldnets_tpu.models.factory import build_model as jax_build_model
from pseldnets_tpu.train.checkpoint import load_pretrained as jax_load_pretrained
from pseldnets_tpu.train.checkpoint import load_torch_state_dict as jax_load_sd
from pseldnets_tpu_torch.config import compose
from pseldnets_tpu_torch.models import build_model
from pseldnets_tpu_torch.train.checkpoint import (jax_to_torch_state_dict, load_jax_variables,
                                                  load_pretrained, save_training_ckpt)
from pseldnets_tpu_torch.train.module import DatasetSpec, SELDTask
import torch_threads  # noqa: F401  (each xdist worker's share of the cores)

ROOT = Path(__file__).resolve().parents[1]
K = 3
TINY_HTSAT = ["model.kwargs.spec_size=64", "model.kwargs.embed_dim=8", "model.kwargs.depths=[1,1]",
              "model.kwargs.num_heads=[2,4]", "model.kwargs.window_size=4",
              "model.kwargs.tgt_output_frames=24", "data.n_mels=16"]
TINY_PASST = ["model=passt", "model.kwargs.depth=1", "model.kwargs.embed_dim=24",
              "model.kwargs.num_heads=2"]
TINY_CRNN = ["model=crnn", "model.kwargs.num_features=[8,8,8,8,8,8]", "model.decoder=null"]
CASES = {
    "htsat": (["loss=multi_accdoa"] + TINY_HTSAT, (2, 7, 241, 16)),
    "htsat_seddoa": (["loss=einv2_pit", "model.backbone=HTSAT_SEDDOA"] + TINY_HTSAT,
                     (2, 7, 241, 16)),
    "einv2_htsat": (["loss=einv2_pit"] + TINY_HTSAT, (2, 7, 241, 16)),
    "passt_crop": (["loss=multi_accdoa"] + TINY_PASST, (2, 7, 1001, 64)),
    "passt_resize": (["loss=multi_accdoa"] + TINY_PASST, (2, 7, 1001, 64)),
    "crnn": (["loss=multi_accdoa"] + TINY_CRNN, (2, 7, 80, 64)),
    "einv2_crnn": (["loss=einv2_pit"] + TINY_CRNN, (2, 7, 80, 64)),
}


def _models(over, shape, seed=0):
    """The JAX model with its init variables (numpy) and the port model
    bridged from them (eval mode, CPU), and the port's meta."""
    cfg_j = jax_compose(str(ROOT / "configs"), "train", over)
    jm, _ = jax_build_model(cfg_j, K)
    v = jm.init({"params": jax.random.PRNGKey(seed)}, jnp.zeros(shape), train=False)
    variables = jax.tree_util.tree_map(np.asarray, flax.core.unfreeze(v))
    model, meta = build_model(compose(str(ROOT / "configs"), "train", over), K, device="cpu")
    load_jax_variables(model, variables)
    return jm, variables, model.eval(), meta


def _rand(rng, shape, scale=0.2):
    return torch.from_numpy((rng.standard_normal(shape) * scale).astype(np.float32))


def _bn0(rng, F):
    return {"bn0.weight": 1 + _rand(rng, (F,), 0.1), "bn0.bias": _rand(rng, (F,), 0.1),
            "bn0.running_mean": _rand(rng, (F,), 3.0) - 20.0,
            "bn0.running_var": torch.from_numpy(rng.uniform(20, 60, F).astype(np.float32)),
            "bn0.num_batches_tracked": torch.tensor(7)}


def audioset_file(case, model, path, rng):
    """A synthetic AudioSet file for ``model``'s encoder: its encoder keys
    (random values) without the prefix, a 1-channel first conv, bn0 and the
    head keys the load skips; written as the released file is."""
    enc = {"htsat": "encoder.", "htsat_seddoa": "encoder.", "einv2_htsat": "doa_encoder.",
           "passt_crop": "encoder.", "passt_resize": "encoder.", "crnn": "convs.",
           "einv2_crnn": "doa_convs."}[case]
    sd = {k[len(enc):]: (torch.from_numpy(rng.uniform(0.5, 1.5, tuple(v.shape)).astype(np.float32))
                         if k.endswith("running_var") else _rand(rng, tuple(v.shape)))
          for k, v in model.state_dict().items() if k.startswith(enc)}
    first = "conv_block1.conv1.weight" if "crnn" in case else "patch_embed.proj.weight"
    w = sd[first]
    sd[first] = _rand(rng, (w.shape[0], 1) + tuple(w.shape[2:]))
    sd.update(_bn0(rng, model.scalar.weight.shape[1]))
    if "htsat" in case:
        sd.update({"head.weight": _rand(rng, (527, 8)), "head.bias": _rand(rng, (527,)),
                   "tscam_conv.weight": _rand(rng, (527, 16, 2, 3)),
                   "tscam_conv.bias": _rand(rng, (527,)),
                   "layers.0.blocks.0.attn.relative_position_index": torch.zeros(16, 16)})
        sd = {f"sed_model.{k}": v for k, v in sd.items()}
        obj = {"state_dict": sd}
    elif "passt" in case:
        E = sd["freq_new_pos_embed"].shape[1]
        grid = (8, 120) if case == "passt_crop" else (4, 60)
        sd["freq_new_pos_embed"] = _rand(rng, (1, E, grid[0], 1))
        sd["time_new_pos_embed"] = _rand(rng, (1, E, 1, grid[1]))
        sd.update({"head.1.weight": _rand(rng, (527, E)), "head.1.bias": _rand(rng, (527,)),
                   "head_dist.weight": _rand(rng, (527, E))})
        obj = {"model": sd}
    else:
        sd.update({"fc1.weight": _rand(rng, (16, 8)), "fc_audioset.weight": _rand(rng, (527, 16))})
        obj = {"model": sd}
    torch.save(obj, str(path))
    return sd


def _compare(jm, variables, model, path, meta, shape, strict, tol=0.0):
    """JAX load_pretrained and the port's on one file: the parameters
    equal (``tol`` for resized pos-embeds), the same report key sets, a
    float32 forward within 5e-5. -> the port's report."""
    jv, jrep = jax_load_pretrained(variables, str(path), meta, strict=strict)
    rep = load_pretrained(model, path, meta, strict=strict)
    for k in ("missing", "skipped", "unused"):
        assert sorted(set(rep[k])) == sorted(set(jrep[k])), (k, rep[k], jrep[k])
        assert len(rep[k]) == len(set(rep[k]))
    ref = jax_to_torch_state_dict(jax.tree_util.tree_map(np.asarray, flax.core.unfreeze(jv)))
    got = model.state_dict()
    assert ref.keys() == got.keys()
    for k in ref:
        d = float((got[k] - ref[k]).abs().max()) if ref[k].numel() else 0.0
        assert d <= (tol if "pos_embed" in k else 0.0), (k, d)
    x = np.random.default_rng(3).standard_normal(shape).astype(np.float32) * 10 - 20
    out_j = jm.apply(jv, jnp.asarray(x), train=False)
    with torch.no_grad():
        out = model(torch.from_numpy(x))
    for k in out_j:
        e = float(np.abs(out[k].numpy() - np.asarray(out_j[k])).max())
        assert e < 5e-5, (k, e)
    return rep


@pytest.mark.parametrize("case", list(CASES))
def test_audioset_load_matches_jax(case, tmp_path):
    """The AudioSet surgery on each backbone: the patch embed (or CNN14's
    first conv) repeated over the input channels and divided by their
    count, bn0 in every ScalarBN row, the skips, PaSST's pos-embeds cropped
    or resized (linear, half-pixel) with head.0 kept; held against JAX. The
    EINV2 heads' reports list the keys the AudioSet file cannot fill (the
    stitches, the SED and DOA tscam convs, which the skips do not name), and
    strict loading raises there as in JAX."""
    over, shape = CASES[case]
    rng = np.random.default_rng(len(case))
    jm, variables, model, meta = _models(over, shape)
    path = tmp_path / "audioset.ckpt"
    sd = audioset_file(case, model, path, rng)
    init = {k: v.clone() for k, v in model.state_dict().items()}
    strict = case not in ("htsat_seddoa", "einv2_htsat")
    rep = _compare(jm, variables, model, path, meta, shape, strict,
                   tol=1e-6 if case == "passt_resize" else 0.0)
    got = model.state_dict()
    first = "conv_block1.conv1.weight" if "crnn" in case else "patch_embed.proj.weight"
    raw = sd.get(first, sd.get(f"sed_model.{first}"))
    for enc in [p for p in ("encoder.", "sed_encoder.", "doa_encoder.", "convs.", "sed_convs.",
                            "doa_convs.") if p + first in got]:
        C = got[enc + first].shape[1]
        assert torch.equal(got[enc + first], raw.repeat(1, C, 1, 1) / C), enc
    bn0 = {k[len("sed_model."):] if k.startswith("sed_model.") else k: v for k, v in sd.items()}
    for leaf in ("weight", "bias", "running_mean", "running_var"):
        assert torch.equal(getattr(model.scalar, leaf), bn0[f"bn0.{leaf}"].expand(C, -1))
    for k in rep["skipped"]:
        assert torch.equal(got[k], init[k]), k
    assert rep["unused"]  # the head keys of the file, bn0 under the prefix
    if not strict:
        assert rep["missing"] and all("stitch" in k or "tscam" in k for k in rep["missing"])
        with pytest.raises(KeyError):
            jax_load_pretrained(variables, str(path), meta, strict=True)
        with pytest.raises(KeyError):
            load_pretrained(model, path, meta, strict=True)
    else:
        assert rep["missing"] == []
    if "passt" in case:
        assert "encoder.head.0.weight" not in rep["skipped"]
        assert torch.equal(got["encoder.head.0.weight"], sd["head.0.weight"])


def test_pos_embed_resize_matches_jax_image_resize():
    """PaSST's growing resize against jax.image.resize(..., "linear") at one
    growing shape per axis (half-pixel centres, edges held): within 1e-6."""
    from pseldnets_tpu_torch.train.checkpoint import _resize_pos_embed

    rng = np.random.default_rng(5)
    for key, axis, shape, tgt in (("time_new_pos_embed", 3, (1, 6, 1, 7), (1, 6, 1, 23)),
                                  ("freq_new_pos_embed", 2, (1, 6, 3, 1), (1, 6, 8, 1))):
        v = rng.standard_normal(shape).astype(np.float32)
        ref = np.asarray(jax.image.resize(jnp.asarray(v), tgt, method="linear"))
        got = _resize_pos_embed(key, axis)({key: torch.from_numpy(v)}, tgt).numpy()
        assert got.shape == ref.shape
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)
        # and a crop takes the centre
        small = _resize_pos_embed(key, axis)({key: torch.from_numpy(v)}, tuple(
            s - 2 if i == axis else s for i, s in enumerate(shape)))
        assert torch.equal(small, torch.from_numpy(v).narrow(axis, 1, shape[axis] - 2))


def _seld_file(path, over, seed):
    """A SELD-pretrained whole model (the port's own best file, the
    reference's Lightning layout: ``net.``, ScalarBN rows) of the 13-class
    model of ``over``, random weights from ``seed``."""
    src, _ = build_model(compose(str(ROOT / "configs"), "train", over), 13, device="cpu",
                         seed=seed)
    with torch.no_grad():
        for t in src.state_dict().values():
            t.add_(0.05 * torch.randn(t.shape, generator=torch.Generator().manual_seed(seed)))
    save_training_ckpt(path, src)
    return src


@pytest.mark.parametrize("case", ["htsat", "einv2_htsat"])
def test_seld_pretrained_load_matches_jax(case, tmp_path):
    """A SELD checkpoint of 13 classes into a 3-class model
    (``audioset_pretrain: false``): the whole model but the head and tscam
    (their shapes differ; the skips keep the init), not strict; held
    against JAX; no backbone key missing."""
    over, shape = CASES[case]
    over = over + ["model.kwargs.audioset_pretrain=false"]
    jm, variables, model, meta = _models(over, shape)
    assert meta["audioset_pretrain"] is False
    path = tmp_path / "seld.ckpt"
    src = _seld_file(path, over, 9)
    init = {k: v.clone() for k, v in model.state_dict().items()}
    rep = _compare(jm, variables, model, path, meta, shape, strict=False)
    assert rep["missing"] == [] and set(rep["unused"]) == set(rep["skipped"])
    got, want = model.state_dict(), src.state_dict()
    for k in got:
        if k in rep["skipped"]:
            assert torch.equal(got[k], init[k]), k
        else:
            assert torch.equal(got[k], want[k]), k
    assert rep["skipped"] and all("tscam" in k or k.startswith(("fc", "head"))
                                  for k in rep["skipped"])


# --- init_state -----------------------------------------------------------

TASK = ["loss=multi_accdoa", "data.sample_rate=16000", "data.nfft=256", "data.hoplen=320",
        "data.train_chunklen_sec=4"] + TINY_HTSAT[:-1] + ["data.n_mels=16",
                                                            "model.kwargs.tgt_output_frames=40"]


def _task(over):
    return SELDTask(compose(str(ROOT / "configs"), "train", TASK + over), DatasetSpec(K),
                    steps_per_epoch=2, device="cpu")


def test_init_state_loads_the_pretrained_path(tmp_path):
    """``init_state`` loads an existing ``pretrained_path`` (the AudioSet
    file) as ``load_pretrained`` does, before the optimizer is built; a
    ``ckpt_path`` wins over it; the weights stay float32."""
    path = tmp_path / "audioset.ckpt"
    probe = _task(["model.kwargs.pretrained_path=null"])
    sd = audioset_file("htsat", probe.model, path, np.random.default_rng(8))
    task = _task([f"model.kwargs.pretrained_path={path}"])
    task.init_state(0)
    ref = _task(["model.kwargs.pretrained_path=null"])
    ref.init_state(0)
    ref_rep = load_pretrained(ref.model, path, ref.meta)
    assert task.pretrained_report == ref_rep and ref_rep["missing"] == []
    for k, v in ref.model.state_dict().items():
        assert torch.equal(task.model.state_dict()[k], v), k
        assert v.dtype == torch.float32 or not v.is_floating_point()
    w = task.model.encoder.patch_embed.proj.weight
    assert torch.equal(w, sd["sed_model.patch_embed.proj.weight"].repeat(1, 7, 1, 1) / 7)
    assert task.state.optimizer.param_groups[0]["params"][0] is task.params[0]

    # ckpt_path wins: the other file's weights, not the pretrained ones
    other = tmp_path / "other.ckpt"
    save_training_ckpt(other, ref.model)
    with torch.no_grad():
        ref.model.encoder.patch_embed.proj.weight.mul_(2.0)
    save_training_ckpt(other, ref.model)
    task.init_state(0, ckpt_path=str(other))
    assert task.pretrained_report is None
    assert torch.equal(task.model.encoder.patch_embed.proj.weight,
                       ref.model.encoder.patch_embed.proj.weight)


def test_finetune_adapterbit_experiment_loads_the_backbone(tmp_path):
    """configs/experiment/l3das22/finetune_maccdoa_ov1_adapterbit.yaml with
    its pretrained_path pointing at a SELD file of the plain model: the
    backbone loads, the adapter keys (not in the file) and the head keep
    the seed's init (the adapters' fc2 zero), as the JAX load does."""
    plain = ["model.kwargs.audioset_pretrain=false"] + TINY_HTSAT
    path = tmp_path / "seld.ckpt"
    src = _seld_file(path, ["loss=multi_accdoa"] + plain, 4)
    exp = ["experiment=l3das22/finetune_maccdoa_ov1_adapterbit"] + TINY_HTSAT
    cfg = compose(str(ROOT / "configs"), "train", exp + [f"model.kwargs.pretrained_path={path}"])
    assert cfg["adapt"]["method"] == "adapter" and cfg["model"]["kwargs"]["audioset_pretrain"] is False
    task = SELDTask(cfg, DatasetSpec(K), device="cpu")
    fresh = SELDTask(cfg, DatasetSpec(K), device="cpu")
    fresh.meta = dict(fresh.meta, pretrained_path=None)
    task.init_state(0)
    fresh.init_state(0)
    rep = task.pretrained_report
    adapters = [k for k in task.model.state_dict() if "adapter" in k]
    assert adapters and set(adapters) <= set(rep["skipped"]) and rep["missing"] == []
    got, want, init = task.model.state_dict(), src.state_dict(), fresh.model.state_dict()
    for k in got:
        assert torch.equal(got[k], init[k] if k in rep["skipped"] else want[k]), k
    assert all(float(got[k].abs().max()) == 0 for k in adapters if ".fc2." in k)

    cfg_j = jax_compose(str(ROOT / "configs"), "train", exp + [f"model.kwargs.pretrained_path={path}"])
    jm, jmeta = jax_build_model(cfg_j, K)
    v = jm.init({"params": jax.random.PRNGKey(0)}, jnp.zeros((2, 7, 241, 16)), train=False)
    _, jrep = jax_load_pretrained(flax.core.unfreeze(v), str(path), jmeta)
    for k in ("missing", "skipped", "unused"):
        assert sorted(set(rep[k])) == sorted(set(jrep[k])), k


def test_load_reads_the_file_as_jax_does(tmp_path):
    """The port reads the state dict as the JAX loader does: the
    ``state_dict``/``model``/raw unwrapping and the prefix strips give the
    same keys and values."""
    rng = np.random.default_rng(2)
    for wrap in ("state_dict", "model", None):
        sd = {"sed_model.a.weight": _rand(rng, (3, 2)), "net._orig_mod.b": _rand(rng, (4,))}
        path = tmp_path / f"{wrap}.ckpt"
        torch.save({wrap: sd} if wrap else sd, str(path))
        from pseldnets_tpu_torch.train.checkpoint import load_torch_state_dict

        got, ref = load_torch_state_dict(path), jax_load_sd(str(path))
        assert got.keys() == ref.keys() == {"a.weight", "b"}
        for k in got:
            np.testing.assert_array_equal(got[k].numpy(), ref[k])


@pytest.mark.parametrize("method", ["accdoa", "multi_accdoa", "einv2"])
def test_spatial_samples_match_jax(method):
    """The mono_adapter spatialisation (data/dataset.py
    ``generate_spatial_samples``) against the JAX package's from the same
    RandomState, bit for bit over three clips in turn (a 4-channel clip, of
    which the first channel is panned, then mono ones): the FOA audio, the
    labels, and the state the draws leave. Two sources in a frame raise
    (the JAX package asserts)."""
    from pseldnets_tpu.data.dataset import generate_spatial_samples as jax_spatial
    from pseldnets_tpu_torch.data.dataset import generate_spatial_samples

    rng = np.random.default_rng(6)
    T, K = 20, 13
    a, b = np.random.RandomState(2024), np.random.RandomState(2024)
    for i in range(3):
        audio = rng.standard_normal((4, 3200) if i == 0 else (3200,)).astype(np.float32)
        cls = rng.integers(0, K, T)
        act = rng.random(T) < 0.6
        if method == "accdoa":
            se = np.zeros((T, K), np.float32)
            se[np.arange(T), cls] = act
            kw = {"accdoa_label": np.concatenate([se, rng.standard_normal((T, 3 * K))],
                                                 1).astype(np.float32)}
        elif method == "multi_accdoa":
            lab = rng.standard_normal((T, 6, 4, K)).astype(np.float32)
            lab[:, :, 0] = 0.0
            lab[np.arange(T), 0, 0, cls] = act
            kw = {"adpit_label": lab}
        else:
            sed = np.zeros((T, 3, K), np.float32)
            sed[np.arange(T), 0, cls] = act
            kw = {"sed_label": sed, "doa_label": rng.standard_normal((T, 3, 3)).astype(np.float32)}
        got = generate_spatial_samples(audio, method, a, **{k: v.copy() for k, v in kw.items()})
        ref = jax_spatial(audio, method, b, **{k: v.copy() for k, v in kw.items()})
        assert len(got) == len(ref)
        for g, r in zip(got, ref):
            assert g.dtype == r.dtype and np.array_equal(g, r)
        assert a.randint(1 << 30) == b.randint(1 << 30)
    two = {k: v.copy() for k, v in kw.items()}
    key = {"accdoa": "accdoa_label", "multi_accdoa": "adpit_label", "einv2": "sed_label"}[method]
    if method == "accdoa":
        two[key][0, :2] = 1.0
    elif method == "multi_accdoa":
        two[key][0, 0, 0, :2] = 1.0
    else:  # two tracks of one class (the JAX check sums over the tracks)
        two[key][0, :2, 0] = 1.0
    with pytest.raises(ValueError, match="single-source"):
        generate_spatial_samples(audio, method, a, **two)
    with pytest.raises(AssertionError):
        jax_spatial(audio, method, b, **two)


FINETUNES = sorted(str(p.relative_to(ROOT / "configs" / "experiment"))[:-5]
                   for p in (ROOT / "configs" / "experiment").glob("*/finetune_*.yaml"))


@pytest.mark.parametrize("exp", ["synth_maccdoa"] + FINETUNES)
def test_shipped_recipes_build_and_load(exp, tmp_path):
    """Every shipped training recipe at tiny widths, its pretrained file
    written here: ``experiment=synth_maccdoa`` (AugMix) from an AudioSet
    HTSAT file (``audioset_pretrain=true``), and each ``finetune_*`` from a
    SELD file of the plain model. The task builds with the experiment's
    augmentation (the JAX task's registry), ``init_state`` loads the file
    with no key missing (AdapterBit: the adapters skipped), and one AugMix
    step of one clip trains where the recipe has augmentation. The mono
    recipes (``adapt=mono_finetune``/``mono_adapter``) take one step on a
    clip their data path (``generate_spatial_samples``) spatialised."""
    over = TINY_HTSAT + ["data.train_chunklen_sec=2.4"]  # 241 frames, 24 label frames
    path = tmp_path / "pretrained.ckpt"
    if exp == "synth_maccdoa":
        probe, _ = build_model(compose(str(ROOT / "configs"), "train", [
            "experiment=synth_maccdoa", "model.kwargs.pretrained_path=null"] + over), 13,
            device="cpu")
        audioset_file("htsat", probe, path, np.random.default_rng(1))
        extra = ["model.kwargs.audioset_pretrain=true"]
    else:
        _seld_file(path, ["loss=multi_accdoa", "model.kwargs.audioset_pretrain=false"] + over, 3)
        extra = []
    full = [f"experiment={exp}", f"model.kwargs.pretrained_path={path}"] + extra + over
    cfg = compose(str(ROOT / "configs"), "train", full)
    cfg_j = jax_compose(str(ROOT / "configs"), "train", full)
    task = SELDTask(cfg, DatasetSpec(13), steps_per_epoch=2, device="cpu")
    aug = cfg_j["augment"]
    assert task.aug_type == list(aug["type"]) and task.augmix == bool(aug["AugMix"])
    task.init_state(0)
    rep = task.pretrained_report
    assert rep is not None and rep["missing"] == [], rep["missing"]
    if "adapterbit" in exp:
        assert any("adapter" in k for k in rep["skipped"])
    if "mono" in exp:  # one step on a clip the mono data path spatialised
        from pseldnets_tpu_torch.data.dataset import generate_spatial_samples

        rng = np.random.default_rng(5)
        n = int(cfg["data"]["train_chunklen_sec"] * cfg["data"]["sample_rate"])
        lab = np.zeros((24, 6, 4, 13), np.float32)
        lab[:12, 0, 0, 2] = 1.0
        mono = (rng.standard_normal((4, n)) * 0.1).astype(np.float32)
        wav, lab = generate_spatial_samples(mono, "multi_accdoa", np.random.RandomState(3),
                                            adpit_label=lab)
        assert wav.shape == (4, n) and np.array_equal(wav[0], mono[0])
        losses = task.train_step(wav[None].astype(np.float32),
                                 {"adpit_label": lab[None], "ov": ["1"]},
                                 torch.Generator().manual_seed(0))
        assert np.isfinite(float(losses["loss_all"])) and task.state.step == 1
    if not task.augmix:
        return
    rng = np.random.default_rng(4)
    n = int(cfg["data"]["train_chunklen_sec"] * cfg["data"]["sample_rate"])
    lab = np.zeros((1, 24, 6, 4, 13), np.float32)
    lab[0, :, 0, 0, 2] = 1.0
    lab[0, :, 0, 1, 2] = 1.0
    losses = task.train_step((rng.standard_normal((1, 4, n)) * 0.1).astype(np.float32),
                             {"adpit_label": lab, "ov": ["1"]}, torch.Generator().manual_seed(0))
    assert np.isfinite(float(losses["loss_all"])) and task.state.step == 1
