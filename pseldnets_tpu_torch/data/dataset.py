"""Runtime segment datasets.

Parity: reference src/data/components/data.py:12-110 (index-CSV resolution,
room filtering, paths_dict / GT metadata assembly, .wav->.flac rename) and
src/data/data.py:62-253 (per-method __getitem__: ranged audio read + pad,
HDF5 label slice, on-the-fly polar->cartesian, mono spatialization for the
mono_adapter path, ov statistics).

No torch: items are plain numpy dicts; batching/prefetch in datamodule.py.
A copy of the JAX package's data/dataset.py, but ``h5py`` is imported in
the readers (the package imports without it), and the mono_adapter
spatialisation's bare asserts raise ValueError.
"""

from collections import OrderedDict
from pathlib import Path
from typing import Dict

import numpy as np

from ..metrics.dcase import load_output_format_file
from ..utils.audio_io import load_audio

WAV_FORMAT_DATASETS = ["official", "STARSS23", "DCASE2021", "L3DAS22", "synth"]


def generate_spatial_samples(audio, method, rng=None, **kwargs):
    """Mono -> synthetic-FOA panning for the mono_adapter path (the JAX
    package's data/dataset.py:25-68; reference src/data/data.py:17-59):
    one direction drawn from ``rng`` (azimuth in [-180, 180), elevation in
    [-90, 90) degrees, in that order), the first channel panned to W, Y, Z,
    X, and the labels' single source moved to it. Single-source targets
    only: more than one active source in a frame raises."""
    rng = rng or np.random
    if audio.ndim == 2:
        audio = audio[0]
    azi = rng.randint(-180, 180)
    ele = rng.randint(-90, 90)
    x = np.cos(np.deg2rad(azi)) * np.cos(np.deg2rad(ele))
    y = np.sin(np.deg2rad(azi)) * np.cos(np.deg2rad(ele))
    z = np.sin(np.deg2rad(ele))
    w = audio
    audio = np.stack((w, y * audio, z * audio, x * audio), axis=0)

    if method == "einv2":
        sed_label, doa_label = kwargs["sed_label"], kwargs["doa_label"]
        _single_source(sed_label.sum(axis=-2))
        doa_label = np.zeros_like(doa_label)
        act = sed_label.sum(axis=(-1, -2))
        doa_label[..., 0, 0] = act * x
        doa_label[..., 0, 1] = act * y
        doa_label[..., 0, 2] = act * z
        return audio, sed_label, doa_label
    if method == "accdoa":
        accdoa_label = kwargs["accdoa_label"]
        K = accdoa_label.shape[-1] // 4
        se = accdoa_label[:, :K]
        _single_source(se.sum(axis=-1))
        out = np.zeros_like(accdoa_label)
        out[..., K:2 * K] = x * se
        out[..., 2 * K:3 * K] = y * se
        out[..., 3 * K:] = z * se
        return audio, out
    if method == "multi_accdoa":
        adpit_label = kwargs["adpit_label"]
        se = adpit_label[:, :, 0, :]
        _single_source(se.sum(axis=(-1, -2)))
        out = np.zeros_like(adpit_label)
        out[:, :, 0, :] = se
        out[:, :, 1, :] = x * se
        out[:, :, 2, :] = y * se
        out[:, :, 3, :] = z * se
        return audio, out
    raise ValueError(method)


def _single_source(active) -> None:
    """The JAX package's assert: at most one active source a frame."""
    if active.max() > 1:
        raise ValueError("the mono_adapter spatialisation takes single-source labels; a "
                         f"frame has {active.max()} active sources")


class BaseSegmentDataset:
    def __init__(self, cfg, dataset, dataset_name, rooms, dataset_type="train"):
        self.cfg = cfg
        self.dataset_type = dataset_type
        self.label_res = dataset.label_resolution
        self.max_ov = dataset.max_ov
        self.num_classes = dataset.num_classes
        self.sample_rate = cfg["data"]["sample_rate"]
        self.audio_feature = cfg["data"]["audio_feature"]
        self.chunklen_sec = {"train": cfg["data"]["train_chunklen_sec"],
                             "valid": cfg["data"]["test_chunklen_sec"],
                             "test": cfg["data"]["test_chunklen_sec"]}
        self.mono_adapter = (dataset_type == "train"
                             and cfg.get("adapt", {}).get("method") == "mono_adapter")
        self._rng = np.random.RandomState(cfg.get("seed", 2024))

        hdf5_dir = Path(cfg["paths"]["hdf5_dir"])
        rooms = list(rooms)
        dataset_stage = "eval" if rooms == ["mix"] or rooms == ["split5"] else "dev"
        if self.audio_feature in ("logmelIV", "logmel"):
            main_data_dir = hdf5_dir / f"data/{self.sample_rate}fs/wav"
            self.points_per_predictions = self.sample_rate * self.label_res
        else:
            main_data_dir = hdf5_dir / f"data/{self.sample_rate}fs/feature"
            self.data_dir = main_data_dir / dataset_stage / self.audio_feature
            self.points_per_predictions = int(
                self.label_res / (cfg["data"]["hoplen"] / self.sample_rate))

        label_dir = hdf5_dir / "label"
        self.track_label_dir = label_dir / f"track/{dataset_stage}"
        self.accdoa_label_dir = label_dir / f"accdoa/{dataset_stage}"
        self.adpit_label_dir = label_dir / f"adpit/{dataset_stage}"

        if not (rooms == ["mix"] or rooms == ["split5"]):
            rooms = [room + "_" for room in rooms]
        rooms.sort()
        chunk = self.chunklen_sec["train" if dataset_type == "train" else "test"]
        hop = (cfg["data"]["train_hoplen_sec"] if dataset_type == "train"
               else cfg["data"]["test_hoplen_sec"])
        suffix = "train" if dataset_type == "train" else "test"
        indexes_path = main_data_dir / dataset_stage / \
            f"{dataset_name}_{chunk}sChunklen_{hop}sHoplen_{suffix}.csv"
        segments = []
        with open(indexes_path) as f:
            for line in f:
                if not line.strip():
                    continue
                parts = line.strip().split(",")
                segments.append([parts[0], int(parts[1]), int(parts[2]),
                                 int(parts[3]), int(parts[4])])
        self.segments_list = [s for s in segments for room in rooms if room in s[0]]
        if dataset_name not in WAV_FORMAT_DATASETS:
            for s in self.segments_list:
                s[0] = s[0].replace(".wav", ".flac")

        if dataset_type in ("valid", "test"):
            self.paths_dict = OrderedDict()
            for s in self.segments_list:
                self.paths_dict[s[0]] = int(np.ceil(s[2] / self.points_per_predictions))
        if dataset_type == "valid":
            self.valid_gt_dcaseformat = OrderedDict()
            for s in self.segments_list:
                if s[0] in self.valid_gt_dcaseformat:
                    continue
                metafile = s[0].replace("foa", "metadata").replace(".flac", ".csv")
                if dataset_name in WAV_FORMAT_DATASETS:
                    metafile = metafile.replace(".wav", ".csv")
                if dataset_name == "L3DAS22":
                    metafile = metafile.replace("/data_", "/metadata_")
                self.valid_gt_dcaseformat[s[0]] = load_output_format_file(metafile)

    def __len__(self):
        return len(self.segments_list)

    def _load_segment(self, idx):
        path, b, e, pb, pa = self.segments_list[idx]
        if self.audio_feature in ("logmelIV", "logmel"):
            x = load_audio(path, b, e)
            x = np.pad(x, ((0, 0), (pb, pa)))
            dataset = path.split("/")[-3]
        else:
            import h5py

            with h5py.File(self.data_dir / path, "r") as hf:
                x = hf["feature"][:, b:e]
            x = np.pad(x, ((0, 0), (pb, pa), (0, 0)))
            dataset = path.split("/")[-2]
        return path, x.astype(np.float32), b, e, dataset

    def _label_slice(self, b, e):
        lb = int(b / self.points_per_predictions)
        le = int(e / self.points_per_predictions)
        return lb, le

    def _label_pad(self, arr, target_frames, extra_shape):
        pad = target_frames - arr.shape[0]
        if pad > 0:
            arr = np.concatenate(
                [arr, np.zeros((pad,) + extra_shape, arr.dtype)], axis=0)
        return arr

    @property
    def _target_label_frames(self):
        return int(self.chunklen_sec[self.dataset_type] / self.label_res)


class DatasetACCDOA(BaseSegmentDataset):
    def __getitem__(self, idx):
        path, x, b, e, dataset = self._load_segment(idx)
        fn = Path(path).stem
        if self.dataset_type == "test":
            return {"filename": path, "data": x}
        lb, le = self._label_slice(b, e)
        import h5py

        with h5py.File(self.accdoa_label_dir / f"{dataset}.h5", "r") as hf:
            se = hf[f"{fn}/accdoa/se"][lb:le].astype(np.float32)
            azi = np.deg2rad(hf[f"{fn}/accdoa/azi"][lb:le].astype(np.float32))
            ele = np.deg2rad(hf[f"{fn}/accdoa/ele"][lb:le].astype(np.float32))
        lx = np.cos(azi) * np.cos(ele) * se
        ly = np.sin(azi) * np.cos(ele) * se
        lz = np.sin(ele) * se
        label = np.concatenate([se, lx, ly, lz], axis=1).astype(np.float32)
        label = self._label_pad(label, self._target_label_frames,
                                (4 * self.num_classes,))
        if self.mono_adapter:
            x, label = generate_spatial_samples(x, "accdoa", rng=self._rng,
                                                accdoa_label=label)
        ov = str(max(int(label[:, : self.num_classes].sum(axis=1).max()), 1))
        return {"filename": path, "data": x,
                "accdoa_label": label[:, self.num_classes:], "ov": ov}


class DatasetEINV2(BaseSegmentDataset):
    def __getitem__(self, idx):
        path, x, b, e, dataset = self._load_segment(idx)
        fn = Path(path).stem
        if self.dataset_type == "test":
            return {"filename": path, "data": x}
        lb, le = self._label_slice(b, e)
        import h5py

        with h5py.File(self.track_label_dir / f"{dataset}.h5", "r") as hf:
            sed = hf[f"{fn}/sed_label"][lb:le, : self.max_ov].astype(np.float32)
            doa = hf[f"{fn}/doa_label"][lb:le, : self.max_ov].astype(np.float32)
        T = self._target_label_frames
        sed = self._label_pad(sed, T, (self.max_ov, self.num_classes))
        doa = self._label_pad(doa, T, (self.max_ov, 3))
        if self.mono_adapter:
            x, sed, doa = generate_spatial_samples(x, "einv2", rng=self._rng,
                                                   sed_label=sed, doa_label=doa)
        ov = str(max(int(sed.sum(axis=(1, 2)).max()), 1))
        return {"filename": path, "data": x, "sed_label": sed.astype(np.float32),
                "doa_label": doa.astype(np.float32), "ov": ov}


class DatasetMultiACCDOA(BaseSegmentDataset):
    def __getitem__(self, idx):
        path, x, b, e, dataset = self._load_segment(idx)
        fn = Path(path).stem
        if "test" in self.dataset_type:
            return {"filename": path, "data": x}
        lb, le = self._label_slice(b, e)
        import h5py

        with h5py.File(self.adpit_label_dir / f"{dataset}.h5", "r") as hf:
            se = hf[f"{fn}/adpit/se"][lb:le].astype(np.float32)
            azi = np.deg2rad(hf[f"{fn}/adpit/azi"][lb:le].astype(np.float32))
            ele = np.deg2rad(hf[f"{fn}/adpit/ele"][lb:le].astype(np.float32))
        lx = np.cos(azi) * np.cos(ele) * se
        ly = np.sin(azi) * np.cos(ele) * se
        lz = np.sin(ele) * se
        label = np.stack([se, lx, ly, lz], axis=2).astype(np.float32)
        label = self._label_pad(label, self._target_label_frames,
                                (6, 4, self.num_classes))
        if self.mono_adapter:
            x, label = generate_spatial_samples(x, "multi_accdoa", rng=self._rng,
                                                adpit_label=label)
        ov = str(max(int(label[:, :, 0, :].sum(axis=(1, 2)).max()), 1))
        return {"filename": path, "data": x, "adpit_label": label, "ov": ov}


USER_DATASETS = {
    "accdoa": DatasetACCDOA,
    "einv2": DatasetEINV2,
    "multi_accdoa": DatasetMultiACCDOA,
}
