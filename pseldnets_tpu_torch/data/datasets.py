"""Corpus descriptors: class maps, max overlap, directory layouts.

Parity: reference src/utils/datasets.py:3-179 and the factory in
src/utils/config.py:5-21 (unknown names resolve to the synthetic corpus;
synth class maps are read from cls_indices_train.tsv). A copy of the JAX
package's data/datasets.py.
"""

from pathlib import Path

STARSS23_LABELS = {
    "Female speech, woman speaking": 0, "Male speech, man speaking": 1,
    "Clapping": 2, "Telephone": 3, "Laughter": 4, "Domestic sounds": 5,
    "Walk, footsteps": 6, "Door, open or close": 7, "Music": 8,
    "Musical instrument": 9, "Water tap, faucet": 10, "Bell": 11, "Knock": 12,
}


class BaseDatasetSpec:
    def __init__(self):
        self.label_resolution = 0.1
        self.label_dic = {}
        self.max_ov = None
        self.root_dir = None
        self.dataset_dir = {
            "dev": {"foa": None, "mic": None, "meta": None},
            "eval": {"foa": None, "mic": None, "meta": None},
        }

    @property
    def num_classes(self):
        return len(self.label_dic)


class Synthesis(BaseDatasetSpec):
    """DataSynthSELD synthetic corpus; 170-class map from cls_indices_train.tsv
    next to the per-split dirs (reference datasets.py:27-72)."""

    def __init__(self, root_dir, cfg):
        super().__init__()
        dataset = cfg.get("dataset") or list(cfg["data"]["train_dataset"].keys())[0]
        self.max_ov = 3
        self.root_dir = Path(root_dir) / str(dataset)
        if dataset != "official":
            tsv = self.root_dir.parent / "cls_indices_train.tsv"
            with open(tsv) as f:
                for idx, line in enumerate(f):
                    parts = line.strip().split("\t")
                    self.label_dic[parts[2]] = idx
        else:
            self.label_dic = dict(STARSS23_LABELS)
        for stage in ("dev", "eval"):
            self.dataset_dir[stage] = {
                "foa": self.root_dir / "foa",
                "mic": self.root_dir / "mic",
                "meta": self.root_dir / "metadata",
            }


class DCASE2021TASK3(BaseDatasetSpec):
    def __init__(self, root_dir, cfg):
        super().__init__()
        self.label_dic = {
            "alarm": 0, "crying baby": 1, "crash": 2, "barking dog": 3,
            "female scream": 4, "female speech": 5, "footsteps": 6,
            "knocking on door": 7, "male scream": 8, "male speech": 9,
            "ringing phone": 10, "piano": 11,
        }
        self.max_ov = 3
        self.root_dir = Path(root_dir) / "DCASE2021"
        self.dataset_dir["dev"] = {"foa": self.root_dir / "foa_dev",
                                   "mic": self.root_dir / "mic_dev",
                                   "meta": self.root_dir / "metadata_dev"}
        self.dataset_dir["eval"] = {"foa": self.root_dir / "foa_eval",
                                    "mic": self.root_dir / "mic_eval",
                                    "meta": self.root_dir / "metadata_eval"}


class STARSS23(BaseDatasetSpec):
    def __init__(self, root_dir, cfg):
        super().__init__()
        self.label_dic = dict(STARSS23_LABELS)
        self.max_ov = 3
        self.root_dir = Path(root_dir) / "STARSS23"
        self.dataset_dir["dev"] = {"foa": self.root_dir / "foa_dev",
                                   "mic": self.root_dir / "mic_dev",
                                   "meta": self.root_dir / "metadata_dev"}
        self.dataset_dir["eval"] = {"foa": self.root_dir / "foa_eval",
                                    "mic": self.root_dir / "mic_eval",
                                    "meta": None}


class L3DAS22(BaseDatasetSpec):
    def __init__(self, root_dir, cfg):
        super().__init__()
        self.root_dir = Path(root_dir) / "L3DAS22"
        self.clip_length = 30
        self.dataset_dir = {
            "dev": {"foa": self.root_dir / "data_train", "mic": None,
                    "label": self.root_dir / "labels_train",
                    "meta": self.root_dir / "metadata_train"},
            "eval": {"foa": self.root_dir / "data_test", "mic": None,
                     "label": self.root_dir / "labels_test",
                     "meta": self.root_dir / "metadata_test"},
        }
        self.label_dic = {
            "Chink_and_clink": 0, "Computer_keyboard": 1,
            "Cupboard_open_or_close": 2, "Drawer_open_or_close": 3,
            "Female_speech_and_woman_speaking": 4, "Finger_snapping": 5,
            "Keys_jangling": 6, "Knock": 7, "Laughter": 8,
            "Male_speech_and_man_speaking": 9, "Printer": 10, "Scissors": 11,
            "Telephone": 12, "Writing": 13,
        }
        self.max_ov = 3


dataset_dict = {
    "STARSS23": STARSS23,
    "synth": Synthesis,
    "DCASE2021": DCASE2021TASK3,
    "L3DAS22": L3DAS22,
}


def get_dataset(dataset_name, cfg):
    root_dir = cfg["paths"]["dataset_dir"]
    if "Recording" in dataset_name:
        dataset_name = "recording"
    elif dataset_name not in dataset_dict:
        dataset_name = "synth"
    return dataset_dict[dataset_name](root_dir, cfg)
