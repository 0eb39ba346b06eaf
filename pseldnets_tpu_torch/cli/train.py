"""Training CLI, the counterpart of the JAX package's src/train.py (reference
src/train.py): it composes ``configs/train.yaml`` with the port's
config/compose.py, builds the datamodule and the SELD task, and runs
train/loop.py's ``fit`` into ``paths.output_dir`` (``metrics.jsonl``,
``checkpoints/epoch_{epoch:03d}.ckpt`` and ``checkpoints/last.ckpt``)::

    python -m pseldnets_tpu_torch.cli.train experiment=... k=v ...
    python -m pseldnets_tpu_torch.cli.train --device cpu ckpt_path=.../last.ckpt ...

The shipped recipes run as they are composed: ``experiment=synth_maccdoa``
(AugMix: configs/augment/augmix.yaml) from the AudioSet file that
``model.kwargs.pretrained_path`` names, and the ``experiment=<dataset>/
finetune_*`` recipes from a SELD checkpoint there (``audioset_pretrain:
false``); the two ``l3das22/finetune_maccdoa_ov1mono*`` recipes
(``adapt=mono_finetune``/``mono_adapter``) train on clips the dataset
spatialises from their first channel (data/dataset.py
``generate_spatial_samples``). ``model=passt`` trains PaSST eagerly with
``loss=multi_accdoa``, ``accdoa`` or ``einv2_pit(_agg)`` (the EINV2 dual
PaSST); ``model.kwargs.img_size`` must be (n_mels, the chunk's frames
1 + samples / hop), and ``model.kwargs.{s_patchout_f,u_patchout,
drop_rate,drop_path_rate}`` turn on the structured frequency and the
token patchout, position dropout and drop-path (``s_patchout_t`` drops
output frames, so a SELD step with it raises, as in the JAX package).
``model=crnn`` (CNN14-Conformer) trains with its conformer's dropout 0.1
(and ``model.decoder=transformer`` with the transformer's), ``adapt=lora``
and the eager-only adapter settings (``adapt.adapt_kwargs.adapter_scalar=
learnable_scalar``, ``act_layer``, ``new_adapter``) train HTSAT on the
eager modules, and so do ``model.kwargs.drop_rate`` /
``model.kwargs.attn_drop_rate``; the masks come from the step's
generator.
``ckpt_path`` naming the port's ``last.ckpt`` resumes training
exactly; any other ``.ckpt`` (the port's best, the reference's) starts
from its weights, and wins over ``pretrained_path``. ``trainer.detect_anomaly`` turns on
``torch.autograd.set_detect_anomaly``. It runs on the card unless
``--device cpu`` (or ``main(device="cpu")``) asks for the CPU, where the
kernels' plain versions run. The dataset readers need ``h5py`` for the
labels (data/dataset.py).
"""

import logging
import sys
from pathlib import Path
from typing import List, Optional

from .infer import REPO, split_device


def main(argv: Optional[List[str]] = None, device: str = "cuda"):
    import torch

    from ..config import compose
    from ..data import SELDDataModule, get_dataset
    from ..ops._cuda import resolve_device
    from ..train.loop import effective_steps_per_epoch, fit
    from ..train.module import SELDTask
    from ..utils.utilities import count_params, print_config_tree

    argv, device = split_device(list(sys.argv[1:] if argv is None else argv), device)
    device = resolve_device(device)  # no card: raise before any work, never run on the CPU
    cfg = compose(str(REPO / "configs"), "train", argv)
    logging.basicConfig(level=logging.INFO,
                        format="[%(asctime)s][%(name)s] %(message)s")
    log = logging.getLogger("pseldnets")

    if (cfg.get("extras") or {}).get("print_config", False):
        print_config_tree(cfg)
    # trainer.detect_anomaly (reference configs/debug/default.yaml:15)
    if (cfg.get("trainer") or {}).get("detect_anomaly"):
        torch.autograd.set_detect_anomaly(True)
        log.info("trainer.detect_anomaly: torch.autograd anomaly detection on")

    dataset = get_dataset(list(cfg["data"]["train_dataset"].keys())[0], cfg)
    datamodule = SELDDataModule(cfg, dataset, stage="fit")
    log.info("train clips: %d, val clips: %d", len(datamodule.train_set), len(datamodule.val_set))

    task = SELDTask(cfg, dataset, steps_per_epoch=effective_steps_per_epoch(datamodule, cfg),
                    device=device)
    task.init_state(int(cfg.get("seed", 2024)), ckpt_path=cfg.get("ckpt_path"))
    log.info("model parameters: %s (method=%s backbone=%s)",
             f"{count_params(task.model.parameters()):,}", task.method, task.meta["backbone"])

    output_dir = Path(cfg["paths"]["output_dir"])
    output_dir.mkdir(parents=True, exist_ok=True)
    return fit(task, datamodule, cfg, output_dir)


if __name__ == "__main__":
    main()
