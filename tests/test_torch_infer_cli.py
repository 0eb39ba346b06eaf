"""The port's inference and evaluate CLIs, audio decoder and entry point
against the JAX package's on the CPU.

A tiny corpus as tests/test_e2e.py builds it (FLAC clips and DCASE metadata;
the JAX preproc CLI writes the index CSVs and the HDF5 labels, for this
test only), a reference-format checkpoint the test writes from seeded
weights, then src/infer.py and ``python -m pseldnets_tpu_torch.cli.infer``
on the same checkpoint and corpus: ``mode=valid`` with ACS and with
move_avg (macro and micro scores equal to 1e-6), ``mode=test`` (the
submission CSVs equal line for line). The port's decoder gives the JAX
decoder's samples; the port's evaluate CLI the JAX one's scores; entry()
runs on the CPU."""

import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from cli_loader import load_cli
from flac_writer import write_flac
from pseldnets_tpu.config import compose as jax_compose
from pseldnets_tpu.data import get_dataset as jax_get_dataset
from pseldnets_tpu.models import build_model as jax_build_model
from pseldnets_tpu.ops import make_extractor as jax_extractor
from pseldnets_tpu.utils import audio_io as jax_audio
from pseldnets_tpu_torch.cli import evaluate as port_evaluate
from pseldnets_tpu_torch.cli import infer as port_infer
from pseldnets_tpu_torch.models import build_model
from pseldnets_tpu_torch.train.checkpoint import jax_to_torch_state_dict
from pseldnets_tpu_torch.utils import audio_io as port_audio
import torch_threads  # noqa: F401  (each xdist worker's share of the cores)
from test_torch_swin_block import randomize

ROOT = Path(__file__).resolve().parents[1]
FS = 16000
CLIP_SEC = 8
K = 4


def _make_corpus(root, rng, name, room, n_clips):
    """FLAC clips and frame-wise metadata, up to 2 events a frame
    (tests/test_e2e.py::_make_corpus)."""
    foa, meta = root / name / "foa", root / name / "metadata"
    foa.mkdir(parents=True)
    meta.mkdir(parents=True)
    for i in range(n_clips):
        stem = f"{room}_mix{i:03d}"
        sig = (rng.standard_normal((4, FS * CLIP_SEC)) * 3000).astype(np.int16)
        write_flac(foa / f"{stem}.flac", sig, FS, blocksize=4096)
        with open(meta / f"{stem}.csv", "w") as f:
            for frame in range(0, CLIP_SEC * 10, 3):
                for t in range(int(rng.integers(1, 3))):
                    f.write(f"{frame},{int(rng.integers(0, K))},{t},"
                            f"{int(rng.integers(-180, 180))},{int(rng.integers(-60, 60))}\n")


def _overrides(root, work, extra=()):
    """tests/test_e2e.py's tiny 16 kHz CRNN (GRU decoder: the eager route),
    multi-ACCDOA."""
    return ["data.sample_rate=16000", "data.nfft=256", "data.n_mels=16", "data.hoplen=160",
            "data.train_chunklen_sec=4", "data.train_hoplen_sec=4",
            "data.test_chunklen_sec=4", "data.test_hoplen_sec=4",
            "data.train_dataset={train2_ov1: [fold0_room0]}",
            "data.valid_dataset={test2_ov1: [fold1_room1]}",
            "data.test_dataset={test2_ov1: [fold1_room1]}",
            f"paths.dataset_dir={root}", f"paths.hdf5_dir={work}/_hdf5",
            f"paths.log_dir={work}/logs", "model=default", "model.kwargs.num_features=[8,8,16,16]",
            "model.num_decoder_layers=1", "model.batch_size=2", "num_workers=0",
            "loss=multi_accdoa", "seed=3"] + list(extra)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """The corpus, its index CSVs and labels (hop 4 s and 2 s), and a
    reference-format checkpoint of seeded random weights."""
    rng = np.random.default_rng(7)
    root = tmp_path_factory.mktemp("datasets")
    work = tmp_path_factory.mktemp("work")
    _make_corpus(root, rng, "train2_ov1", "fold0_room0", 2)
    _make_corpus(root, rng, "test2_ov1", "fold1_room1", 3)
    with open(root / "cls_indices_train.tsv", "w") as f:
        for i in range(K):
            f.write(f"x\ty\tclass_{i}\n")
    preproc = load_cli("preproc")
    for ds in ("train2_ov1", "test2_ov1"):
        preproc.main(_overrides(root, work, [f"dataset={ds}", "wav_format=.flac"]))
    preproc.main(_overrides(root, work, ["dataset=test2_ov1", "wav_format=.flac",
                                         "data.test_hoplen_sec=2"]))

    cfg = jax_compose(str(ROOT / "configs"), "infer", _overrides(root, work))
    spec = jax_get_dataset("test2_ov1", cfg)
    model, _ = jax_build_model(cfg, spec.num_classes)
    feats = jax_extractor(cfg)(jax.numpy.zeros((1, 4, 4 * FS)))
    v = jax.tree_util.tree_map(np.asarray, dict(model.init(jax.random.PRNGKey(0), feats,
                                                           train=False)))
    stats = {k: {"bn": {"running_mean": np.full(s["bn"]["running_mean"].shape, -20.0, np.float32),
                        "running_var": np.full(s["bn"]["running_var"].shape, 40.0, np.float32)}}
             if k == "scalar" else s for k, s in v["batch_stats"].items()}
    variables = {"params": randomize(v["params"], np.random.default_rng(5)), "batch_stats": stats}
    port_model, _ = build_model(cfg, spec.num_classes, device="cpu")
    rows = {}
    for k, t in jax_to_torch_state_dict(variables, port_model).items():
        if k.startswith("scalar."):
            rows.update({f"scalar.{c}.{k[7:]}": t[c].clone() for c in range(t.shape[0])})
        else:
            rows[k] = t
    ckpt = work / "model.ckpt"
    torch.save({"state_dict": {f"net.{k}": t for k, t in rows.items()}}, ckpt)
    return root, work, ckpt


def _both(root, work, ckpt, extra):
    """The JAX CLI and the port's on the same overrides, each into its own
    output directory."""
    out = {}
    for side in ("jax", "port"):
        over = _overrides(root, work, [f"ckpt_path={ckpt}", f"paths.output_dir={work}/{side}",
                                       *extra])
        if side == "jax":
            out[side] = load_cli("infer").main(over)
        else:
            out[side] = port_infer.main(over, device="cpu")
    return out


@pytest.mark.parametrize("extra", [["post_processing=ACS"],
                                   ["post_processing=move_avg", "data.test_hoplen_sec=2"]],
                         ids=["ACS", "move_avg"])
def test_valid_mode_scores_match_jax(corpus, extra):
    root, work, ckpt = corpus
    out = _both(root, work, ckpt, ["mode=valid"] + extra)
    assert set(out["port"]) == set(out["jax"])
    for k, v in out["jax"].items():
        assert abs(out["port"][k] - v) <= 1e-6, (k, out["port"][k], v)
    res = {side: json.loads((work / side / "results.json").read_text()) for side in out}
    for avg in ("macro", "micro"):
        for k, v in res["jax"][avg].items():
            assert abs(res["port"][avg][k] - v) <= 1e-6, (avg, k)
    for k, v in res["jax"]["losses"].items():
        assert abs(res["port"]["losses"][k] - v) <= 1e-6, k
    assert np.isfinite(out["port"]["SELD_scr"])


def test_test_mode_submissions_match_jax(corpus):
    root, work, ckpt = corpus
    _both(root, work, ckpt, ["mode=test"])
    got = sorted((work / "port" / "submissions").glob("*.csv"))
    want = sorted((work / "jax" / "submissions").glob("*.csv"))
    assert [p.name for p in got] == [p.name for p in want] and len(got) == 3
    for g, w in zip(got, want):
        assert g.read_text().splitlines() == w.read_text().splitlines(), g.name


def test_audio_decoder_matches_jax(corpus, tmp_path):
    """FLAC (whole and ranged) and float32 WAV, and the numpy WAV reader."""
    root, _, _ = corpus
    flac = sorted((root / "test2_ov1" / "foa").glob("*.flac"))[0]
    assert port_audio.audio_info(flac) == jax_audio.audio_info(flac) == (FS * CLIP_SEC, 4, FS)
    for rng_ in ((0, None), (1000, 50000), (FS * CLIP_SEC - 10, FS * CLIP_SEC)):
        np.testing.assert_array_equal(port_audio.load_audio(flac, *rng_),
                                      jax_audio.load_audio(flac, *rng_))
    assert port_audio._get_lib() and port_audio.library_path().parent.name == "_build"
    wav = tmp_path / "x.wav"
    sig = np.random.default_rng(2).standard_normal((4, 3000)).astype(np.float32)
    port_audio.write_wav(wav, sig, FS)
    np.testing.assert_array_equal(port_audio.load_audio(wav), jax_audio.load_audio(wav))
    np.testing.assert_array_equal(port_audio._wav_read_numpy(wav, 10, 2000), sig[:, 10:2000])


def _write_stream(path, stream):
    with open(path, "w") as f:
        for frame, rows in sorted(stream.items()):
            for r in rows:
                f.write(f"{frame},{r[0]},{int(r[1])},{int(r[2])}\n")


@pytest.mark.parametrize("flags", [[], ["--average", "micro"], ["--jackknife"],
                                   ["--consolidate_rooms"]])
def test_evaluate_cli_matches_jax(tmp_path, flags, capsys):
    rng = np.random.default_rng(9)
    gt_dir, pred_dir = tmp_path / "gt", tmp_path / "pred"
    gt_dir.mkdir()
    pred_dir.mkdir()
    for i in range(4):
        stream = {fr: [[int(rng.integers(0, 5)), int(rng.integers(-180, 181)),
                        int(rng.integers(-60, 61))]] for fr in range(0, 120, 2)}
        _write_stream(gt_dir / f"fold1_room{i % 2}_mix{i:03d}.csv", stream)
        _write_stream(pred_dir / f"fold1_room{i % 2}_mix{i:03d}.csv",
                      {fr: [[r[0], r[1] + int(rng.integers(-30, 30)), r[2]] for r in rows]
                       for fr, rows in stream.items() if rng.random() < 0.9})
    argv = ["--gt_csv_dir", str(gt_dir), "--pred_csv_dir", str(pred_dir),
            "--nb_classes", "5"] + flags
    got = port_evaluate.main(argv)
    printed = capsys.readouterr().out
    want = load_cli("evaluate").main(argv)
    assert capsys.readouterr().out == printed and printed
    if "--consolidate_rooms" not in flags:
        assert repr(got[:5]) == repr(want[:5])
        np.testing.assert_array_equal(np.asarray(got[5]), np.asarray(want[5]))


def test_entry_runs_on_the_cpu():
    from pseldnets_tpu_torch.entry import entry

    fn, (model, batch) = entry(device="cpu")  # production shapes, plain versions
    assert batch.shape == (2, 4, 240000) and model.encoder.embed_dim == 96
    assert model.tscam_conv.out_channels == 117
    out = fn(model, batch)
    assert out["multi_accdoa"].shape == (2, 100, 117)
    assert bool(torch.isfinite(out["multi_accdoa"]).all())


def test_cli_runs_as_a_module(tmp_path):
    """``python -m pseldnets_tpu_torch.cli.infer --device cpu`` imports,
    composes its config and stops at the missing corpus."""
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    over = [f"paths.dataset_dir={tmp_path}", f"paths.hdf5_dir={tmp_path}",
            f"paths.output_dir={tmp_path}/out", "model.kwargs.pretrained_path=null"]
    r = subprocess.run([sys.executable, "-m", "pseldnets_tpu_torch.cli.infer", "--device",
                        "cpu"] + over, cwd=tmp_path, env=env, capture_output=True, text=True,
                       timeout=120)
    assert r.returncode != 0 and "FileNotFoundError" in r.stderr, r.stderr[-2000:]
    assert "cls_indices_train.tsv" in r.stderr
    assert port_infer.split_device(["a=1", "--device=cpu", "b=2"], "cuda") == \
        (["a=1", "b=2"], "cpu")
