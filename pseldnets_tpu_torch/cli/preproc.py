"""Preprocessing CLI, the counterpart of the JAX package's src/preproc.py
(reference src/preproc.py): per-dataset segment indexes and the ACCDOA,
track and ADPIT label HDF5s, the L3DAS22 label conversion first for that
corpus; STARSS23 eval (no metadata) gets its indexes only. It composes
``configs/preproc.yaml`` with the port's config/compose.py::

    python -m pseldnets_tpu_torch.cli.preproc dataset=STARSS23 wav_format=.wav

It runs on the host (numpy, the audio decoder, ``h5py`` for the label and
feature files), apart from the offline mic features that a feature other
than logmelIV/logmel asks for (``logmelgcc``, ``salsalite``:
``Preprocess.extract_mic_features``), whose STFT, log-mel, GCC-PHAT and
SALSA-lite run on the card, or with ``--device cpu`` on the CPU; without a
card and without ``--device cpu`` that step raises::

    python -m pseldnets_tpu_torch.cli.preproc --device cpu data=mic_salsalite dataset=...
"""

import sys
from typing import List, Optional

from .infer import REPO, split_device


def main(argv: Optional[List[str]] = None, device: str = "cuda"):
    """Preprocess as the config says; ``--device`` (or ``device``) is where
    the offline mic features are computed."""
    from ..config import compose
    from ..data.datasets import get_dataset
    from ..preproc import Preprocess

    argv, device = split_device(list(sys.argv[1:] if argv is None else argv), device)
    cfg = compose(str(REPO / "configs"), "preproc", argv)
    dataset = get_dataset(cfg.get("dataset", "synth"), cfg)
    preproc = Preprocess(cfg, dataset)
    if cfg.get("dataset") == "L3DAS22":
        preproc.extract_l3das22_label()
    if cfg["data"]["audio_feature"] not in ("logmelIV", "logmel"):
        preproc.extract_mic_features(device)
    preproc.extract_index()
    if not (cfg.get("dataset") == "STARSS23" and cfg.get("dataset_type") == "eval"):
        preproc.extract_accdoa_label()
        preproc.extract_track_label()
        preproc.extract_adpit_label()


if __name__ == "__main__":
    main()
