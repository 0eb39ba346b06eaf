"""The port's preprocessing (pseldnets_tpu_torch/preproc, cli/preproc.py)
against the JAX package's on the CPU, on corpora the test writes: a FOA dev
corpus (FLAC, up to 2 events a frame; tests/test_e2e.py's), STARSS23 eval
(no metadata: indexes only) and L3DAS22 (WAV, start/end/XYZ label CSVs
converted to frame-wise metadata first). Each CLI writes into its own
``paths.hdf5_dir``: the index CSVs are byte-equal, every HDF5 label dataset
(accdoa, track, adpit) equal in name, dtype and values, and the L3DAS22
frame-wise CSVs byte-equal. Offline mic features raise."""

import csv
from pathlib import Path

import h5py
import numpy as np
import pytest

from cli_loader import load_cli
from flac_writer import write_flac
from pseldnets_tpu_torch.cli import preproc as port_preproc
from pseldnets_tpu_torch.config import compose
from pseldnets_tpu_torch.data.datasets import get_dataset
from pseldnets_tpu_torch.preproc import Preprocess
from pseldnets_tpu_torch.utils.audio_io import write_wav
import torch_threads  # noqa: F401  (each xdist worker's share of the cores)

ROOT = Path(__file__).resolve().parents[1]
FS = 16000
K = 4


def _foa_corpus(root, rng, name, room, n_clips, sec=6):
    """FLAC clips and frame-wise metadata, up to 2 events a frame."""
    foa, meta = root / name / "foa", root / name / "metadata"
    foa.mkdir(parents=True)
    meta.mkdir(parents=True)
    for i in range(n_clips):
        stem = f"{room}_mix{i:03d}"
        sig = (rng.standard_normal((4, FS * sec + 1000 * i)) * 3000).astype(np.int16)
        write_flac(foa / f"{stem}.flac", sig, FS, blocksize=4096)
        with open(meta / f"{stem}.csv", "w") as f:
            for frame in range(0, sec * 10, 3):
                for t in range(int(rng.integers(1, 3))):
                    f.write(f"{frame},{int(rng.integers(0, K))},{t},"
                            f"{int(rng.integers(-180, 180))},{int(rng.integers(-60, 60))}\n")
    with open(root / "cls_indices_train.tsv", "w") as f:
        for i in range(K):
            f.write(f"x\ty\tclass_{i}\n")


def _overrides(root, hdf5, extra=()):
    return ["data.sample_rate=16000", "data.nfft=256", "data.n_mels=16", "data.hoplen=160",
            "data.train_chunklen_sec=4", "data.train_hoplen_sec=2",
            "data.test_chunklen_sec=4", "data.test_hoplen_sec=2",
            f"paths.dataset_dir={root}", f"paths.hdf5_dir={hdf5}", "num_workers=0"] + list(extra)


def _run_both(root, tmp, extra):
    """The JAX preproc CLI and the port's on the same corpus, each into
    its own hdf5 directory. -> (jax dir, port dir)."""
    out = {}
    for side in ("jax", "port"):
        out[side] = tmp / f"hdf5_{side}"
        over = _overrides(root, out[side], extra)
        (load_cli("preproc").main if side == "jax" else port_preproc.main)(over)
    return out["jax"], out["port"]


def _files(d):
    return sorted(p.relative_to(d) for p in d.rglob("*") if p.is_file())


def _h5_items(path):
    items = {}
    with h5py.File(path, "r") as hf:
        hf.visititems(lambda name, obj: items.__setitem__(name, (obj.dtype, obj[()]))
                      if isinstance(obj, h5py.Dataset) else None)
    return items


def _assert_same_outputs(jax_dir, port_dir, n_h5):
    files = _files(jax_dir)
    assert files == _files(port_dir)
    assert sum(p.suffix == ".h5" for p in files) == n_h5
    assert any(p.suffix == ".csv" for p in files)
    for rel in files:
        if rel.suffix == ".csv":
            assert (port_dir / rel).read_bytes() == (jax_dir / rel).read_bytes(), rel
            continue
        want, got = _h5_items(jax_dir / rel), _h5_items(port_dir / rel)
        assert sorted(got) == sorted(want) and want, rel
        for name, (dtype, value) in want.items():
            assert got[name][0] == dtype, (rel, name)
            np.testing.assert_array_equal(got[name][1], value, err_msg=f"{rel} {name}")


def test_foa_dev_corpus_matches_jax(tmp_path):
    rng = np.random.default_rng(31)
    root = tmp_path / "datasets"
    _foa_corpus(root, rng, "train2_ov1", "fold0_room0", 3)
    jax_dir, port_dir = _run_both(root, tmp_path, ["dataset=train2_ov1", "wav_format=.flac"])
    _assert_same_outputs(jax_dir, port_dir, n_h5=3)
    index = port_dir / "data/16000fs/wav/dev/train2_ov1_4sChunklen_2sHoplen_train.csv"
    assert len(index.read_text().splitlines()) >= 6


def test_starss23_eval_writes_indexes_only(tmp_path):
    rng = np.random.default_rng(32)
    foa = tmp_path / "datasets" / "STARSS23" / "foa_eval"
    foa.mkdir(parents=True)
    for i in range(2):
        sig = (rng.standard_normal((4, FS * 5 + 700 * i)) * 3000).astype(np.int16)
        write_flac(foa / f"mix{i:03d}.flac", sig, FS, blocksize=4096)
    jax_dir, port_dir = _run_both(tmp_path / "datasets", tmp_path,
                                  ["dataset=STARSS23", "dataset_type=eval", "wav_format=.flac"])
    _assert_same_outputs(jax_dir, port_dir, n_h5=0)
    assert not (port_dir / "label").exists()
    assert len(_files(port_dir)) == 2


def _l3das22_corpus(root, rng):
    """Two WAV clips (A and B microphones; B is left out of the index) and
    a start/end/class/XYZ label CSV for each, events overlapping."""
    base = root / "L3DAS22"
    data, labels = base / "data_train", base / "labels_train"
    data.mkdir(parents=True)
    labels.mkdir()
    classes = ["Knock", "Printer", "Laughter", "Telephone"]
    for i in range(2):
        for mic in ("A", "B"):
            write_wav(data / f"split{i}_ov2_{i}_{mic}.wav",
                      rng.standard_normal((4, FS * 3)).astype(np.float32) * 0.1, FS)
        with open(labels / f"label_split{i}_ov2_{i}.csv", "w", newline="") as f:
            w = csv.writer(f)
            w.writerow(["File", "Start", "End", "Class", "X", "Y", "Z"])
            for _ in range(5):
                start = float(rng.uniform(0, 28))
                w.writerow([f"split{i}", f"{start:.4f}", f"{start + rng.uniform(0.3, 4):.4f}",
                            classes[int(rng.integers(0, 4))],
                            *(f"{v:.3f}" for v in rng.uniform(-2, 2, 3))])
    return base / "metadata_train"


def test_l3das22_matches_jax(tmp_path):
    """Both CLIs convert the labels into the corpus' own metadata directory
    (each run replaces it): the JAX run's CSVs are read before the port's
    run and compared byte for byte, then the indexes and HDF5 labels."""
    rng = np.random.default_rng(33)
    root = tmp_path / "datasets"
    meta = _l3das22_corpus(root, rng)
    extra = ["dataset=L3DAS22", "wav_format=.wav"]
    load_cli("preproc").main(_overrides(root, tmp_path / "hdf5_jax", extra))
    want = {p.name: p.read_bytes() for p in sorted(meta.glob("*.csv"))}
    port_preproc.main(_overrides(root, tmp_path / "hdf5_port", extra))
    got = {p.name: p.read_bytes() for p in sorted(meta.glob("*.csv"))}
    assert sorted(got) == ["split0_ov2_0_A.csv", "split1_ov2_1_A.csv"]
    assert got == want and all(got.values())
    _assert_same_outputs(tmp_path / "hdf5_jax", tmp_path / "hdf5_port", n_h5=3)
    index = (tmp_path / "hdf5_port").rglob("L3DAS22_*_train.csv")
    assert "_B.wav" not in next(index).read_text()


@pytest.mark.parametrize("feature", ["salsalite", "logmelgcc"])
def test_offline_mic_features_raise(tmp_path, feature):
    """A feature other than logmelIV/logmel raises naming its ROADMAP.md
    steps, through the class and through the CLI, before anything is
    written."""
    rng = np.random.default_rng(34)
    root = tmp_path / "datasets"
    _foa_corpus(root, rng, "train2_ov1", "fold0_room0", 1, sec=2)
    over = _overrides(root, tmp_path / "hdf5", ["dataset=train2_ov1",
                                                f"data.audio_feature={feature}"])
    cfg = compose(str(ROOT / "configs"), "preproc", over)
    with pytest.raises(NotImplementedError, match="steps 1/10"):
        Preprocess(cfg, get_dataset("train2_ov1", cfg)).extract_mic_features()
    with pytest.raises(NotImplementedError, match="steps 1/10"):
        port_preproc.main(over)
    assert not (tmp_path / "hdf5").exists()
