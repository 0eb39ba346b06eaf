"""The port's CLI chain on the CPU, the flow of tests/test_e2e.py's
test_train_and_infer_e2e and test_train_resume inside the port: the port's
preproc CLI writes the indexes and labels of a test-written FLAC corpus,
``cli.train --device cpu`` trains tests/test_e2e.py's tiny 16 kHz CRNN (GRU
decoder) with multi-ACCDOA for two epochs from a weights-only ``.ckpt`` of
seeded noise (so that the scores see detections), ``cli.infer`` on its best
checkpoint reproduces the validation scores of that epoch's line, and the
train CLI resumes from ``last.ckpt`` to a third epoch. One epoch each of
``loss=accdoa`` and ``loss=einv2_pit`` runs through the train CLI too. With
the JAX e2e flow's ``augment=augmix`` (tests/test_e2e.py:101) the chain
trains, infers from its best file, and fine-tunes from that file as a
SELD-pretrained ``model.kwargs.pretrained_path`` (``audioset_pretrain:
false``, ``augment=augmix1``). The preproc outputs are held against the JAX
package's in tests/test_torch_preproc.py."""

import json
import shutil
from pathlib import Path

import numpy as np
import pytest
import torch

from pseldnets_tpu_torch.cli import infer as port_infer
from pseldnets_tpu_torch.cli import preproc as port_preproc
from pseldnets_tpu_torch.cli import train as port_train
from pseldnets_tpu_torch.config import compose
from pseldnets_tpu_torch.models import build_model
from pseldnets_tpu_torch.train.checkpoint import (load_torch_state_dict, save_training_ckpt,
                                                  stack_scalar_rows)
from pseldnets_tpu_torch.train.module import SELDTask
import torch_threads  # noqa: F401  (each xdist worker's share of the cores)
from test_torch_infer_cli import CLIP_SEC, FS, K, _make_corpus

ROOT = Path(__file__).resolve().parents[1]


def _overrides(root, work, extra=()):
    """tests/test_e2e.py's tiny CRNN overrides, float32."""
    return ["data.sample_rate=16000", "data.nfft=256", "data.n_mels=16", "data.hoplen=160",
            "data.train_chunklen_sec=4", "data.train_hoplen_sec=4",
            "data.test_chunklen_sec=4", "data.test_hoplen_sec=4",
            "data.train_dataset={train2_ov1: [fold0_room0]}",
            "data.valid_dataset={test2_ov1: [fold1_room1]}",
            "data.test_dataset={test2_ov1: [fold1_room1]}",
            f"paths.dataset_dir={root}", f"paths.hdf5_dir={work}/_hdf5",
            f"paths.log_dir={work}/logs", "model=default", "model.kwargs.num_features=[8,8,16,16]",
            "model.num_decoder_layers=1", "model.batch_size=2", "num_workers=0",
            "trainer.precision=32-true", "logger=csv", "extras.print_config=false"] + list(extra)


@pytest.fixture(scope="module")
def preprocessed(tmp_path_factory):
    rng = np.random.default_rng(7)
    root = tmp_path_factory.mktemp("datasets")
    work = tmp_path_factory.mktemp("work")
    _make_corpus(root, rng, "train2_ov1", "fold0_room0", 3)
    _make_corpus(root, rng, "test2_ov1", "fold1_room1", 2)
    with open(root / "cls_indices_train.tsv", "w") as f:
        for i in range(K):
            f.write(f"x\ty\tclass_{i}\n")
    for ds in ("train2_ov1", "test2_ov1"):
        port_preproc.main(_overrides(root, work, [f"dataset={ds}", "wav_format=.flac"]))
    hdf5 = work / "_hdf5"
    for kind in ("accdoa", "adpit", "track"):
        assert (hdf5 / f"label/{kind}/dev/train2_ov1.h5").exists()
    assert (hdf5 / f"data/{FS}fs/wav/dev/train2_ov1_4sChunklen_4sHoplen_train.csv").exists()
    return root, work


def _noise_ckpt(root, work):
    """A weights-only checkpoint of the multi-ACCDOA CRNN: weights
    N(0, 1/fan_in), norm scales 1 + N(0, 0.1), biases N(0, 0.3), the
    ScalarBN statistics near the log-mel's range."""
    cfg = compose(str(ROOT / "configs"), "train", _overrides(root, work, ["loss=multi_accdoa"]))
    model, _ = build_model(cfg, K, device="cpu")
    g = torch.Generator().manual_seed(5)
    with torch.no_grad():
        for name, t in model.state_dict().items():
            if name.startswith("scalar.running"):
                t.fill_(-20.0 if name.endswith("mean") else 40.0)
            elif "running" in name:
                continue
            elif t.dim() >= 2:
                t.copy_(torch.randn(t.shape, generator=g) / (t[0].numel() ** 0.5))
            elif name.endswith("weight"):
                t.copy_(1.0 + 0.1 * torch.randn(t.shape, generator=g))
            else:
                t.copy_(0.3 * torch.randn(t.shape, generator=g))
    path = work / "start.ckpt"
    save_training_ckpt(path, model)
    return path


def _lines(run):
    return [json.loads(line) for line in (run / "metrics.jsonl").read_text().splitlines()]


def test_train_infer_and_resume_cli(preprocessed):
    root, work = preprocessed
    run = work / "run_maccdoa"
    base = ["loss=multi_accdoa", "seed=3"]
    state = port_train.main(["--device", "cpu", *_overrides(
        root, work, base + ["trainer.max_epochs=2", f"paths.output_dir={run}",
                            f"ckpt_path={_noise_ckpt(root, work)}"])])
    lines = _lines(run)
    assert [line["epoch"] for line in lines] == [1, 2] and state.epoch == 2
    assert any(line["val"]["macro"]["F"] > 0 for line in lines)
    assert all(np.isfinite(line["train"]["loss_all"]) and "val" in line for line in lines)
    steps = state.step // 2  # a step a batch of 2 chunks: DistributedBatchSampler's count
    assert state.step == 2 * steps and steps >= 3
    best_line = min(lines, key=lambda line: line["val"]["macro"]["SELD_scr"])
    ckpts = sorted(p.name for p in (run / "checkpoints").iterdir())
    assert ckpts == [f"epoch_{best_line['epoch']:03d}.ckpt", "last.ckpt"]

    # the infer CLI on the best checkpoint scores as that epoch's validation
    macro = port_infer.main(["--device=cpu", *_overrides(root, work, base + [
        "mode=valid", f"ckpt_path={run}/checkpoints/{ckpts[0]}",
        f"paths.output_dir={work}/infer_best"])])
    for k, v in best_line["val"]["macro"].items():
        assert abs(macro[k] - v) <= 1e-6, (k, macro[k], v)

    # resume from last.ckpt: one more epoch, its line the only one written
    resumed = work / "run_resumed"
    state = port_train.main(["--device", "cpu", *_overrides(root, work, base + [
        "trainer.max_epochs=3", f"ckpt_path={run}/checkpoints/last.ckpt",
        f"paths.output_dir={resumed}"])])
    lines3 = _lines(resumed)
    assert [line["epoch"] for line in lines3] == [3] and state.step == 3 * steps
    assert lines3[0]["lr"] == lines[-1]["lr"] and np.isfinite(lines3[0]["train"]["loss_all"])
    last = torch.load(str(resumed / "checkpoints" / "last.ckpt"), weights_only=False)
    assert (last["epoch"], last["global_step"]) == (3, 3 * steps)
    assert last["best_score"] <= best_line["val"]["macro"]["SELD_scr"]


@pytest.mark.parametrize("loss", ["accdoa", "einv2_pit"])
def test_one_epoch_of_other_heads(preprocessed, loss):
    """One epoch of the ACCDOA and the EINV2 (tPIT) CRNN through the train
    CLI: finite losses, a validation, both checkpoints; the best loads in
    the infer CLI."""
    root, work = preprocessed
    run = work / f"run_{loss}"
    port_train.main(["--device", "cpu", *_overrides(
        root, work, [f"loss={loss}", "seed=4", "trainer.max_epochs=1",
                     f"paths.output_dir={run}"])])
    (line,) = _lines(run)
    assert all(np.isfinite(v) for v in line["train"].values())
    assert np.isfinite(line["val"]["macro"]["SELD_scr"])
    assert sorted(p.name for p in (run / "checkpoints").iterdir()) == ["epoch_001.ckpt",
                                                                       "last.ckpt"]
    macro = port_infer.main(_overrides(root, work, [
        f"loss={loss}", "mode=valid", f"ckpt_path={run}/checkpoints/epoch_001.ckpt",
        f"paths.output_dir={work}/infer_{loss}"]), device="cpu")
    assert abs(macro["SELD_scr"] - line["val"]["macro"]["SELD_scr"]) <= 1e-6


@pytest.mark.parametrize("loss", ["multi_accdoa", "einv2_pit"])
def test_augmix_train_infer_and_finetune_cli(preprocessed, loss):
    """tests/test_e2e.py's flow with ``augment=augmix`` (specaug, crop,
    freqshift, rotate, trackmix, wavmix, AugMix): one epoch through the
    train CLI (finite losses, a validation, both checkpoints), the infer CLI
    on the best file scoring as the epoch's line; then the fine-tune: the
    best file as ``model.kwargs.pretrained_path`` with
    ``audioset_pretrain=false`` and ``augment=augmix1`` loads every key but
    the head's (the task built from those overrides holds the file's
    weights, its head the seed's init), and one epoch of it trains through
    the train CLI."""
    root, work = preprocessed
    run = work / f"run_augmix_{loss}"
    port_train.main(["--device", "cpu", *_overrides(
        root, work, [f"loss={loss}", "augment=augmix", "seed=6", "trainer.max_epochs=1",
                     f"paths.output_dir={run}"])])
    (line,) = _lines(run)
    assert all(np.isfinite(v) for v in line["train"].values())
    assert np.isfinite(line["val"]["macro"]["SELD_scr"])
    best = run / "checkpoints" / "epoch_001.ckpt"
    assert sorted(p.name for p in (run / "checkpoints").iterdir()) == [best.name, "last.ckpt"]
    macro = port_infer.main(_overrides(root, work, [
        f"loss={loss}", "mode=valid", f"ckpt_path={best}",
        f"paths.output_dir={work}/infer_augmix_{loss}"]), device="cpu")
    assert abs(macro["SELD_scr"] - line["val"]["macro"]["SELD_scr"]) <= 1e-6

    tune = [f"loss={loss}", "augment=augmix1", "seed=7", "trainer.max_epochs=1",
            f"model.kwargs.pretrained_path={best}", "model.kwargs.audioset_pretrain=false"]
    task = SELDTask(compose(str(ROOT / "configs"), "train", _overrides(root, work, tune)),
                    type("Spec", (), {"num_classes": K, "max_ov": 3})(), device="cpu")
    task.init_state(7)
    rep = task.pretrained_report
    assert rep["missing"] == [] and rep["skipped"] and set(rep["unused"]) == set(rep["skipped"])
    assert all(k.startswith(("fc.", "fc_sed")) for k in rep["skipped"])
    saved = stack_scalar_rows(load_torch_state_dict(best), task.model)
    for k, v in task.model.state_dict().items():
        if k not in rep["skipped"]:
            assert torch.equal(v, saved[k]), k
    port_train.main(["--device", "cpu", *_overrides(
        root, work, tune + [f"paths.output_dir={work}/run_tune_{loss}"])])
    (tuned,) = _lines(work / f"run_tune_{loss}")
    assert all(np.isfinite(v) for v in tuned["train"].values())
    assert np.isfinite(tuned["val"]["macro"]["SELD_scr"])


# tiny widths on the corpus: PaSST (4 s at hop 160: 401 frames, 40 label
# frames; 16 mels make one frequency row) with position dropout and
# drop-path; the two mono recipes' HTSAT at hop 320 (201 frames)
PASST_CLI = ["model=passt", "loss=multi_accdoa", "model.kwargs.pretrained_path=null",
             "model.kwargs.audioset_pretrain=false", "model.kwargs.depth=2",
             "model.kwargs.embed_dim=24", "model.kwargs.num_heads=2",
             "model.kwargs.img_size=[16,401]", "model.kwargs.drop_rate=0.1",
             "model.kwargs.drop_path_rate=0.1"]
# configs/model/crnn.yaml (CNN12 + one conformer layer, its dropout 0.1)
# narrowed; CNN12's six frequency pools need 64 mels
CRNN_CLI = ["model=crnn", "loss=accdoa", "model.kwargs.num_features=[8,8,8,8,16,16]",
            "data.n_mels=64"]
MONO_CLI = ["model.kwargs.pretrained_path=null", "data.hoplen=320", "model.kwargs.spec_size=64",
            "model.kwargs.embed_dim=8", "model.kwargs.depths=[1,1]",
            "model.kwargs.num_heads=[2,4]", "model.kwargs.window_size=4",
            "model.kwargs.tgt_output_frames=40"]


@pytest.fixture(scope="module")
def mono_corpus(preprocessed):
    """A single-source training set beside the corpus (``train1_ov1``: the
    first two training clips' audio, one event a labelled frame, as the
    mono recipes' spatialisation needs), preprocessed by the port's CLI."""
    root, work = preprocessed
    rng = np.random.default_rng(9)
    foa, meta = root / "train1_ov1" / "foa", root / "train1_ov1" / "metadata"
    foa.mkdir(parents=True)
    meta.mkdir(parents=True)
    for i in range(2):
        stem = f"fold0_room0_mix{i:03d}"
        shutil.copy(root / "train2_ov1" / "foa" / f"{stem}.flac", foa)
        with open(meta / f"{stem}.csv", "w") as f:
            for frame in range(0, CLIP_SEC * 10, 3):
                f.write(f"{frame},{int(rng.integers(0, K))},0,"
                        f"{int(rng.integers(-180, 180))},{int(rng.integers(-60, 60))}\n")
    port_preproc.main(_overrides(root, work, ["dataset=train1_ov1", "wav_format=.flac"]))
    return root, work


@pytest.mark.parametrize("recipe", [
    pytest.param(PASST_CLI, id="passt"),
    pytest.param(CRNN_CLI, id="crnn"),
    pytest.param(["experiment=l3das22/finetune_maccdoa_ov1mono"] + MONO_CLI, id="mono"),
    pytest.param(["experiment=l3das22/finetune_maccdoa_ov1mono_adapterbit"] + MONO_CLI,
                 id="mono_adapterbit")])
def test_passt_and_mono_recipes_train_cli(request, recipe):
    """One epoch of 2 steps through the train CLI on the corpus: PaSST
    (``model=passt``, eager, its draws from fit's generator), the
    CNN14-Conformer (``model=crnn`` narrowed, its conformer's dropout 0.1
    drawn from fit's generator; the shipped ``pretrained_path`` is absent,
    so it starts from the seed's weights) and the two
    L3DAS22 mono recipes, whose training clips the dataset spatialises
    from their first channel (``adapt=mono_finetune``: every parameter
    trains; ``mono_adapter``: the AdapterBit adapters, biases and head).
    Finite losses, a validation, both checkpoints; the mono runs' training
    set is spatialised (a clip's Y, Z, X channels are its W scaled) and
    its validation set is not."""
    from pseldnets_tpu_torch.data import SELDDataModule, get_dataset

    name = recipe[0].split("=")[1].split("/")[-1]
    mono = "mono" in name
    root, work = request.getfixturevalue("mono_corpus" if mono else "preprocessed")
    run = work / f"run_{name}"
    data = [o for o in _overrides(root, work) if not o.startswith("model")]
    if mono:
        data.append("data.train_dataset={train1_ov1: [fold0_room0]}")
    over = recipe[:1] + data + recipe[1:] + [
        "model.batch_size=2", "seed=8", "trainer.max_epochs=1",
        "trainer.limit_train_batches=2", f"paths.output_dir={run}"]
    state = port_train.main(["--device", "cpu", *over])
    (line,) = _lines(run)
    assert state.step == 2
    assert all(np.isfinite(v) for v in line["train"].values())
    assert np.isfinite(line["val"]["macro"]["SELD_scr"])
    assert sorted(p.name for p in (run / "checkpoints").iterdir()) == ["epoch_001.ckpt",
                                                                       "last.ckpt"]
    cfg = compose(str(ROOT / "configs"), "train", over)
    if not mono:
        assert cfg["model"]["backbone"] == {"passt": "PASST", "crnn": "CRNN"}[name]
        assert name != "crnn" or cfg["model"]["decoder"] == "conformer"
        return
    assert cfg["adapt"]["method"] == "mono_adapter"
    dm = SELDDataModule(cfg, get_dataset("train1_ov1", cfg), stage="fit")

    def panned(x):  # channels 1-3 are channel 0 scaled
        gains = x[1:] @ x[0] / (x[0] @ x[0])
        return np.allclose(x[1:], gains[:, None] * x[0], atol=1e-6)

    assert panned(dm.train_set[0]["data"]) and not panned(dm.val_set[0]["data"])
