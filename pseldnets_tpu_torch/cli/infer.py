"""Inference CLI, the counterpart of the JAX package's src/infer.py
(reference src/infer.py): ``mode=valid`` scores against the ground truth and
writes ``results.json``; ``mode=test`` writes DCASE submission CSVs to
``<output_dir>/submissions``. It composes ``configs/infer.yaml`` with the
port's config/compose.py and takes the same Hydra-style overrides
(``post_processing=ACS|move_avg``, ``ckpt_path=<reference .ckpt>``, ...)::

    python -m pseldnets_tpu_torch.cli.infer mode=valid ckpt_path=model.ckpt
    python -m pseldnets_tpu_torch.cli.infer --device cpu mode=test ...

It runs on the card unless ``--device cpu`` (or ``main(device="cpu")``)
asks for the CPU, where the kernels' plain versions run. The dataset
readers need ``h5py`` for the labels (data/dataset.py).
"""

import json
import logging
import sys
from pathlib import Path
from typing import List, Optional, Tuple

REPO = Path(__file__).resolve().parents[2]


def split_device(argv: List[str], device: str) -> Tuple[List[str], str]:
    """``--device X`` or ``--device=X`` taken out of ``argv``."""
    rest, i = [], 0
    while i < len(argv):
        a = argv[i]
        if a == "--device" and i + 1 < len(argv):
            device, i = argv[i + 1], i + 2
            continue
        if a.startswith("--device="):
            device = a.split("=", 1)[1]
        else:
            rest.append(a)
        i += 1
    return rest, device


def main(argv: Optional[List[str]] = None, device: str = "cuda"):
    from ..config import compose
    from ..data import SELDDataModule, get_dataset
    from ..metrics import SELDMetrics
    from ..train.loop import run_test, run_validation
    from ..train.module import SELDTask

    argv, device = split_device(list(sys.argv[1:] if argv is None else argv), device)
    cfg = compose(str(REPO / "configs"), "infer", argv)
    logging.basicConfig(level=logging.INFO,
                        format="[%(asctime)s][%(name)s] %(message)s")
    log = logging.getLogger("pseldnets")

    mode = cfg.get("mode", "valid")
    name_key = "valid_dataset" if mode == "valid" else "test_dataset"
    dataset = get_dataset(list(cfg["data"][name_key].keys())[0], cfg)
    datamodule = SELDDataModule(cfg, dataset, stage="fit" if mode == "valid" else "test")

    task = SELDTask(cfg, dataset, device=device)
    task.init_state(int(cfg.get("seed", 42)), ckpt_path=cfg.get("ckpt_path"))

    output_dir = Path(cfg["paths"]["output_dir"])
    output_dir.mkdir(parents=True, exist_ok=True)
    if mode == "valid":
        metrics = SELDMetrics(nb_classes=task.num_classes, doa_threshold=20)
        macro, micro, losses = run_validation(task, datamodule, metrics)
        log.info("val/macro: %s", macro)
        log.info("val/micro: %s", micro)
        with open(output_dir / "results.json", "w") as f:
            json.dump({"macro": macro, "micro": micro, "losses": losses}, f, indent=2)
        return macro
    run_test(task, datamodule, output_dir / "submissions")


if __name__ == "__main__":
    main()
