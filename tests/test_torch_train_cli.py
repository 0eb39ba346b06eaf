"""The port's CLI chain on the CPU, the flow of tests/test_e2e.py's
test_train_and_infer_e2e and test_train_resume inside the port: the port's
preproc CLI writes the indexes and labels of a test-written FLAC corpus,
``cli.train --device cpu`` trains tests/test_e2e.py's tiny 16 kHz CRNN (GRU
decoder) with multi-ACCDOA for two epochs from a weights-only ``.ckpt`` of
seeded noise (so that the scores see detections), ``cli.infer`` on its best
checkpoint reproduces the validation scores of that epoch's line, and the
train CLI resumes from ``last.ckpt`` to a third epoch. One epoch each of
``loss=accdoa`` and ``loss=einv2_pit`` runs through the train CLI too. The
JAX e2e flow's ``augment=augmix`` is left out: augmentation is not ported
(ROADMAP.md queue A step 5). The preproc outputs are held against the JAX
package's in tests/test_torch_preproc.py."""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from pseldnets_tpu_torch.cli import infer as port_infer
from pseldnets_tpu_torch.cli import preproc as port_preproc
from pseldnets_tpu_torch.cli import train as port_train
from pseldnets_tpu_torch.config import compose
from pseldnets_tpu_torch.models import build_model
from pseldnets_tpu_torch.train.checkpoint import save_training_ckpt
from test_torch_infer_cli import FS, K, _make_corpus

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
