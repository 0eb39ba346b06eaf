"""Offline preprocessing: segment indexes and label files.

Parity targets (reference src/preproc/preprocess.py):
* extract_index            — segment CSVs `path,begin,end,pad_before,pad_after`
  in samples (wav mode) / frames (feature mode); train uses the half-chunk
  keep-or-pad rule, test always pads the tail            (:464-522)
* extract_accdoa_label     — HDF5 fn/accdoa/{se,azi,ele} per 100 ms frame (:176-212)
* extract_track_label      — frame x track x class one-hot SED + per-track xyz,
  first-free-track assignment; 6 tracks for STARSS23      (:80-133)
* extract_adpit_label      — 6-dummy-track a0/b0b1/c0c1c2 slot labels (:346-461)
* extract_l3das22_label    — start/end/XYZ csv -> DCASE framewise metadata (:566-611)
* extract_mic_features     — offline logmel+GCC-PHAT or SALSA-lite per-clip HDF5
  (:525-563), computed on a torch device (the card by default)

A copy of the JAX package's preproc/preprocess.py (:1-326), on the port's
metrics/dcase.py, utils/audio_io.py and ops/. ``h5py`` is imported where a
label or feature file is written or read, so the module imports without
it; the card's machine has none, so the files are written on a host that
has it.
"""

import shutil
from functools import partial
from pathlib import Path

import numpy as np

from ..metrics.dcase import load_output_format_file, segment_index
from ..utils.audio_io import audio_info, load_audio


def _pmap(fn, items, num_workers: int, processes: bool = False):
    """Ordered parallel map honoring the cfg ``num_workers`` knob (the
    reference fans preproc out via hydra's joblib launcher, n_jobs=20 —
    configs/preproc.yaml:6-14). Threads for GIL-releasing work (the native
    audio decoder); processes for the pure-Python label
    parsers. Results come back in input order so HDF5 writes (main thread
    only) stay byte-identical to the serial run."""
    items = list(items)
    if num_workers <= 1 or len(items) <= 1:
        return [fn(it) for it in items]
    from concurrent.futures import ProcessPoolExecutor, ThreadPoolExecutor

    n = min(num_workers, len(items))
    if processes:
        # spawn, not fork: this process is multithreaded by the time preproc
        # runs (torch's import starts worker threads), and forking a
        # multithreaded process can deadlock the children (CPython emits
        # DeprecationWarning/RuntimeWarning for exactly this)
        import multiprocessing

        ctx = multiprocessing.get_context("spawn")
        with ProcessPoolExecutor(max_workers=n, mp_context=ctx) as ex:
            return list(ex.map(fn, items))
    with ThreadPoolExecutor(max_workers=n) as ex:
        return list(ex.map(fn, items))


# --- per-file label arrays (top-level so ProcessPoolExecutor can pickle) ---

def _accdoa_arrays(meta_file: Path, K: int):
    meta = load_output_format_file(meta_file)
    num_frames = max(meta.keys()) + 1
    se = np.zeros((num_frames, K), bool)
    azi = np.zeros((num_frames, K), np.int16)
    ele = np.zeros((num_frames, K), np.int8)
    for frame, events in meta.items():
        for ev in events:
            se[frame, ev[0]] = 1
            azi[frame, ev[0]] = ev[1]
            ele[frame, ev[0]] = ev[2]
    return meta_file.stem, se, azi, ele


def _track_arrays(meta_file: Path, K: int, max_polyphony: int):
    rows = []
    with open(meta_file) as f:
        for line in f:
            if line.strip():
                rows.append([float(v) for v in line.strip().split(",")])
    num_frames = int(rows[-1][0]) + 1
    sed = np.zeros((num_frames, max_polyphony, K), bool)
    doa = np.zeros((num_frames, max_polyphony, 3), np.float32)
    occupied = np.zeros((num_frames, max_polyphony), bool)
    for row in rows:
        frame, cls = int(row[0]), int(row[1])
        azi, ele = row[3], row[4]
        free = np.where(~occupied[frame])[0]
        if len(free) == 0:
            continue
        trk = free[0]
        a, e = azi * np.pi / 180, ele * np.pi / 180
        sed[frame, trk, cls] = 1
        doa[frame, trk] = (np.cos(e) * np.cos(a), np.cos(e) * np.sin(a),
                           np.sin(e))
        occupied[frame, trk] = True
    return meta_file.stem, sed, doa


def _adpit_arrays(meta_file: Path, K: int):
    meta = load_output_format_file(meta_file)
    num_frames = max(meta.keys()) + 1
    se = np.zeros((num_frames, 6, K), bool)
    azi = np.zeros((num_frames, 6, K), np.int16)
    ele = np.zeros((num_frames, 6, K), np.int8)
    for frame, events in meta.items():
        events = sorted(events, key=lambda x: x[0])
        group = []
        for i, ev in enumerate(events):
            group.append(ev)
            if i != len(events) - 1 and ev[0] == events[i + 1][0]:
                continue
            # slots: a0 for 1 src, b0/b1 for 2, c0/c1/c2 for >= 3
            slots = {1: [0], 2: [1, 2], 3: [3, 4, 5]}[min(len(group), 3)]
            for slot, g in zip(slots, group):
                se[frame, slot, g[0]] = 1
                azi[frame, slot, g[0]] = g[1]
                ele[frame, slot, g[0]] = g[2]
            group = []
    return meta_file.stem, se, azi, ele


class Preprocess:
    def __init__(self, cfg, dataset):
        self.cfg = cfg
        self.dataset = dataset
        data = cfg["data"]
        self.fs = int(data["sample_rate"])
        self.hoplen = int(data["hoplen"])
        self.nfft = int(data["nfft"])
        self.n_mels = int(data["n_mels"])
        self.audio_feature = data["audio_feature"]
        self.label_res = dataset.label_resolution
        self.num_classes = dataset.num_classes
        self.wav_format = cfg.get("wav_format", ".flac")

        self.train_chunklen_sec = data["train_chunklen_sec"]
        self.train_hoplen_sec = data["train_hoplen_sec"]
        self.test_chunklen_sec = data["test_chunklen_sec"]
        self.test_hoplen_sec = data["test_hoplen_sec"]

        hdf5_dir = Path(cfg["paths"]["hdf5_dir"])
        dataset_type = cfg.get("dataset_type", "dev")
        self.dataset_type = dataset_type
        self.data_dir = {"foa": dataset.dataset_dir[dataset_type]["foa"],
                         "mic": dataset.dataset_dir[dataset_type]["mic"]}
        data_dir = hdf5_dir / f"data/{self.fs}fs"

        label_dir = hdf5_dir / "label"
        self.meta_dir = dataset.dataset_dir[dataset_type]["meta"]
        name = cfg.get("dataset", "synth")
        self.meta_track_path = label_dir / f"track/{dataset_type}/{name}.h5"
        self.meta_accdoa_path = label_dir / f"accdoa/{dataset_type}/{name}.h5"
        self.meta_adpit_path = label_dir / f"adpit/{dataset_type}/{name}.h5"
        self.feature_h5_dir = data_dir / f"feature/{dataset_type}/{self.audio_feature}/{name}"

        self.num_workers = int(cfg.get("num_workers", 8) or 1)
        self.data_type = "wav" if self.audio_feature in ("logmelIV", "logmel") else "feature"
        self.indexes_path_list = [
            data_dir / self.data_type / "{}/{}_{}sChunklen_{}sHoplen_train.csv".format(
                dataset_type, name, self.train_chunklen_sec, self.train_hoplen_sec),
            data_dir / self.data_type / "{}/{}_{}sChunklen_{}sHoplen_test.csv".format(
                dataset_type, name, self.test_chunklen_sec, self.test_hoplen_sec),
        ]

    # ------------------------------------------------------------------ index
    def extract_index(self):
        specs = [(self.train_chunklen_sec, self.train_hoplen_sec, False),
                 (self.test_chunklen_sec, self.test_hoplen_sec, True)]
        for (chunk_sec, hop_sec, pad_last), path in zip(specs, self.indexes_path_list):
            path.parent.mkdir(parents=True, exist_ok=True)
            with open(path, "w") as f:
                if self.data_type == "wav":
                    chunklen = int(chunk_sec * self.fs)
                    hoplen = int(hop_sec * self.fs)
                    files = sorted(self.data_dir["foa"].glob("*" + self.wav_format))
                    if self.cfg.get("dataset") == "L3DAS22":
                        files = [p for p in files if "_B.wav" not in str(p)]
                    # header probes release the GIL in the native decoder
                    lengths = _pmap(lambda p: audio_info(p)[0], files,
                                    self.num_workers)
                    for p, n in zip(files, lengths):
                        idx, pad = segment_index(n, chunklen, hoplen, pad_last)
                        for (b, e), (pb, pa) in zip(idx, pad):
                            f.write(f"{p},{b},{e},{pb},{pa}\n")
                else:
                    import h5py

                    fpp = int(self.label_res / (self.hoplen / self.fs))
                    chunklen = int(chunk_sec / self.label_res * fpp)
                    hoplen = int(hop_sec / self.label_res * fpp)
                    for p in sorted(self.feature_h5_dir.glob("*.h5")):
                        with h5py.File(p, "r") as hf:
                            n = hf["feature"].shape[1]
                        rel = p.relative_to(p.parent.parent)
                        idx, pad = segment_index(n, chunklen, hoplen, pad_last)
                        for (b, e), (pb, pa) in zip(idx, pad):
                            f.write(f"{rel},{b},{e},{pb},{pa}\n")

    # ----------------------------------------------------------------- labels
    def _meta_files(self):
        return [p for p in sorted(self.meta_dir.glob("*.csv"))
                if not p.name.startswith(".")]

    def extract_accdoa_label(self):
        import h5py

        K = self.num_classes
        self.meta_accdoa_path.parent.mkdir(parents=True, exist_ok=True)
        if self.meta_accdoa_path.is_file():
            self.meta_accdoa_path.unlink()
        with h5py.File(self.meta_accdoa_path, "w") as hf:
            for fn, se, azi, ele in _pmap(partial(_accdoa_arrays, K=K),
                                          self._meta_files(),
                                          self.num_workers, processes=True):
                hf.create_dataset(f"{fn}/accdoa/se", data=se, dtype=bool)
                hf.create_dataset(f"{fn}/accdoa/azi", data=azi, dtype=np.int16)
                hf.create_dataset(f"{fn}/accdoa/ele", data=ele, dtype=np.int8)

    def extract_track_label(self):
        import h5py

        max_polyphony = 6 if self.cfg.get("dataset") == "STARSS23" else 3
        K = self.num_classes
        self.meta_track_path.parent.mkdir(parents=True, exist_ok=True)
        if self.meta_track_path.is_file():
            self.meta_track_path.unlink()
        with h5py.File(self.meta_track_path, "w") as hf:
            for fn, sed, doa in _pmap(
                    partial(_track_arrays, K=K, max_polyphony=max_polyphony),
                    self._meta_files(), self.num_workers, processes=True):
                hf.create_dataset(f"{fn}/sed_label", data=sed, dtype=bool)
                hf.create_dataset(f"{fn}/doa_label", data=doa, dtype=np.float32)

    def extract_adpit_label(self):
        import h5py

        K = self.num_classes
        self.meta_adpit_path.parent.mkdir(parents=True, exist_ok=True)
        if self.meta_adpit_path.is_file():
            self.meta_adpit_path.unlink()
        with h5py.File(self.meta_adpit_path, "w") as hf:
            for fn, se, azi, ele in _pmap(partial(_adpit_arrays, K=K),
                                          self._meta_files(),
                                          self.num_workers, processes=True):
                hf.create_dataset(f"{fn}/adpit/se", data=se, dtype=bool)
                hf.create_dataset(f"{fn}/adpit/azi", data=azi, dtype=np.int16)
                hf.create_dataset(f"{fn}/adpit/ele", data=ele, dtype=np.int8)

    # -------------------------------------------------------------- l3das22
    def extract_l3das22_label(self):
        num_frames = int(self.dataset.clip_length / self.label_res)
        label_dir = self.dataset.dataset_dir[self.dataset_type]["label"]
        if self.meta_dir.is_dir():
            shutil.rmtree(self.meta_dir)
        self.meta_dir.mkdir(parents=True)
        import csv

        for path in sorted(label_dir.glob("*.csv")):
            frame_label = {i: [] for i in range(num_frames)}
            with open(path) as f:
                reader = csv.DictReader(f)
                for idz, row in enumerate(reader):
                    start = int(round(float(row["Start"]) / self.label_res))
                    end = int(round(float(row["End"]) / self.label_res))
                    cls = self.dataset.label_dic[row["Class"]]
                    x, y, z = float(row["X"]), float(row["Y"]), float(row["Z"])
                    azi = int(np.arctan2(y, x) * 180 / np.pi)
                    ele = int(np.arctan2(z, np.sqrt(x * x + y * y)) * 180 / np.pi)
                    for fr in range(start, end):
                        if fr < num_frames:
                            frame_label[fr].append([cls, idz, azi, ele])
            fn = path.stem.replace("label_split", "split")
            with open(self.meta_dir / (fn + "_A.csv"), "w") as f:
                for fr in range(num_frames):
                    for ev in frame_label[fr]:
                        f.write(f"{fr},{ev[0]},{ev[1]},{ev[2]},{ev[3]}\n")

    # ------------------------------------------------------------ mic features
    def mic_features(self, wav: np.ndarray, device="cuda") -> np.ndarray:
        """One mic recording (C, N) -> its feature (C', T, F) float32, T =
        N // hoplen frames of the FFT STFT, computed on ``device``: for
        ``logmelgcc`` the log-mel of each channel on the librosa (slaney)
        filterbank, floored 80 dB below the channel's peak (librosa's
        top_db), then the GCC-PHAT of each pair at n_mels lags; for
        ``salsalite`` SALSA-lite with ``data.salsalite``'s limits (the JAX
        package's preprocess.py:290-326)."""
        import torch

        from ..ops._cuda import resolve_device
        from ..ops.features import gcc_phat, salsa_lite
        from ..ops.mel import mel_filterbank
        from ..ops.stft import stft

        dev = resolve_device(device)
        nb_frames = wav.shape[1] // self.hoplen
        x = torch.as_tensor(np.asarray(wav, np.float32), device=dev)[None]
        re, im = (t[:, :, :nb_frames] for t in stft(x, self.nfft, self.hoplen, "hann"))
        if self.audio_feature == "logmelgcc":
            fb = torch.as_tensor(mel_filterbank(self.fs, self.nfft, self.n_mels, scale="slaney",
                                                norm="slaney").astype(np.float32), device=dev)
            logmel = 10.0 * torch.log10(torch.clamp((re * re + im * im) @ fb, min=1e-10))[0]
            peak = logmel.amax(dim=(1, 2), keepdim=True)
            logmel = torch.maximum(logmel, peak - 80.0)
            feature = torch.cat([logmel, gcc_phat(re, im, self.n_mels)[0]], dim=0)
        elif self.audio_feature == "salsalite":
            sl = self.cfg["data"]["salsalite"]
            feature = salsa_lite(re, im, self.fs, self.nfft, sl["fmin_doa"], sl["fmax_doa"],
                                 sl["fmax_spectra"])[0]
        else:
            raise NotImplementedError(self.audio_feature)
        return feature.float().cpu().numpy()

    def extract_mic_features(self, device="cuda"):
        """Offline mic features (``mic_features``, on ``device``) of every
        recording of the mic directory, one ``feature`` dataset per file in
        ``<feature_h5_dir>/<stem>.h5`` (the directory made anew)."""
        import h5py

        from ..ops._cuda import resolve_device

        device = resolve_device(device)  # no card: raise before anything is written
        if self.feature_h5_dir.is_dir():
            shutil.rmtree(self.feature_h5_dir)
        self.feature_h5_dir.mkdir(parents=True)
        for file in sorted(self.data_dir["mic"].glob("*" + self.wav_format)):
            feature = self.mic_features(load_audio(file), device)
            with h5py.File(self.feature_h5_dir / (file.stem + ".h5"), "w") as hf:
                hf.create_dataset("feature", data=feature)
