"""Preprocessing CLI, the counterpart of the JAX package's src/preproc.py
(reference src/preproc.py): per-dataset segment indexes and the ACCDOA,
track and ADPIT label HDF5s, the L3DAS22 label conversion first for that
corpus; STARSS23 eval (no metadata) gets its indexes only. It composes
``configs/preproc.yaml`` with the port's config/compose.py::

    python -m pseldnets_tpu_torch.cli.preproc dataset=STARSS23 wav_format=.wav

It runs on the host only (numpy, the audio decoder, ``h5py`` for the label
files). A feature other than logmelIV/logmel (offline mic features) raises:
they are not ported (ROADMAP.md queue A steps 1/10).
"""

import sys
from typing import List, Optional

from .infer import REPO


def main(argv: Optional[List[str]] = None):
    from ..config import compose
    from ..data.datasets import get_dataset
    from ..preproc import Preprocess

    cfg = compose(str(REPO / "configs"), "preproc", list(sys.argv[1:] if argv is None else argv))
    dataset = get_dataset(cfg.get("dataset", "synth"), cfg)
    preproc = Preprocess(cfg, dataset)
    if cfg.get("dataset") == "L3DAS22":
        preproc.extract_l3das22_label()
    if cfg["data"]["audio_feature"] not in ("logmelIV", "logmel"):
        preproc.extract_mic_features()
    preproc.extract_index()
    if not (cfg.get("dataset") == "STARSS23" and cfg.get("dataset_type") == "eval"):
        preproc.extract_accdoa_label()
        preproc.extract_track_label()
        preproc.extract_adpit_label()


if __name__ == "__main__":
    main()
