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

Data parallelism (``trainer=gpu``, the reference's DDP recipe: ``devices:
2``): ``trainer.devices`` N > 1 (-1 or ``auto``: every visible card) spawns
N worker processes, one card each (rank r on ``cuda:r``), in an NCCL group;
with ``--device cpu``, N processes on the CPU in a gloo group (what the
tests run). Under ``torchrun`` (``WORLD_SIZE``, ``RANK`` and
``LOCAL_RANK`` set) the CLI joins that launcher's group instead (rank r on
``cuda:LOCAL_RANK``). N beyond the visible cards raises before any work;
nothing falls back to fewer processes or to gloo on the card. Each rank
sets its group up before it builds the datamodule, whose sampler and step
count read the world size. ``model.batch_size`` is each rank's batch, as
in the reference's Lightning DDP and the JAX package's multi-process runs:
a step trains on N times as many clips. Like the JAX package, the CLI
reads ``devices``, not ``strategy``, and the BatchNorm statistics are
global under N > 1 whatever ``sync_batchnorm`` says (train/module.py).
"""

import logging
import os
import sys
from pathlib import Path
from typing import Callable, List, Optional, Tuple

from .infer import REPO, split_device

LAUNCHER_ENV = ("WORLD_SIZE", "RANK", "LOCAL_RANK")


def requested_world(cfg, device) -> int:
    """The processes ``trainer.devices`` asks for on ``device``'s type: its
    count, or with -1 / ``auto`` every visible card (one process on the
    CPU). Raises beyond the visible cards, or below 1."""
    import torch

    devices = (cfg.get("trainer") or {}).get("devices", 1)
    cards = torch.cuda.device_count() if device.type == "cuda" else None
    if str(devices).lower() in ("-1", "auto"):
        n = cards if cards is not None else 1
    else:
        n = int(devices)
    if n < 1:
        raise ValueError(f"trainer.devices={devices!r}: at least one process")
    if cards is not None and n > cards:
        raise ValueError(f"trainer.devices={devices!r} asks for {n} cards; {cards} visible")
    return n


def _logging(rank: int = 0, world: int = 1) -> None:
    tag = f"[rank {rank}/{world}]" if world > 1 else ""
    logging.basicConfig(level=logging.INFO,
                        format=f"[%(asctime)s]{tag}[%(name)s] %(message)s")


def main(argv: Optional[List[str]] = None, device: str = "cuda"):
    """Train as the config says; one process returns ``fit``'s state, a
    spawned data-parallel run None (its ranks write the run's files)."""
    from ..config import compose
    from ..ops._cuda import resolve_device
    from ..parallel import init_data_parallel, local_rank, rank_device, shutdown

    argv, device = split_device(list(sys.argv[1:] if argv is None else argv), device)
    device = resolve_device(device)  # no card: raise before any work, never run on the CPU
    cfg = compose(str(REPO / "configs"), "train", argv)
    if all(k in os.environ for k in LAUNCHER_ENV):  # torchrun's group
        import torch.distributed as dist

        world, rank = int(os.environ["WORLD_SIZE"]), int(os.environ["RANK"])
        _logging(rank, world)
        dev = rank_device(device.type, local_rank())
        init_data_parallel(rank, world, _backend(dev), "env://", dev)
        try:
            got = [cfg]  # rank 0's: its run directory's time stamp for every rank
            dist.broadcast_object_list(got, src=0)
            return train(got[0], dev)
        finally:
            shutdown()
    world = requested_world(cfg, device)
    if world > 1:
        return spawn(world, train, (cfg,), device.type)
    _logging()
    return train(cfg, device)


def _backend(device) -> str:
    return "nccl" if device.type == "cuda" else "gloo"


def spawn(world: int, target: Callable, args: Tuple, device_type: str,
          timeout: Optional[float] = None) -> None:
    """``world`` worker processes (the ``spawn`` start method), each calling
    ``target(*args, device)`` on its device, rank r on ``rank_device(
    device_type, r)``, in one group over a file store in a fresh temporary
    directory. The CLI's target is ``train`` on the composed config (one
    run directory for every rank). Returns when every rank has ended, and
    raises (ending the others, which would wait in their next collective)
    when one fails or, where ``timeout`` seconds are given, when the ranks
    outlast them. On the CPU each rank takes its share of this process's
    threads."""
    import multiprocessing as mp
    import shutil
    import tempfile
    import time
    from multiprocessing.connection import wait

    import torch

    store = tempfile.mkdtemp(prefix="pseldnets_ddp_")
    threads = max(1, torch.get_num_threads() // world) if device_type == "cpu" else None
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_worker, name=f"rank{r}",
                         args=(r, world, target, args, device_type, f"file://{store}/store",
                               threads))
             for r in range(world)]
    try:
        for p in procs:
            p.start()
        pending = {p.sentinel: p for p in procs}
        end = None if timeout is None else time.monotonic() + timeout
        while pending:
            left = None if end is None else end - time.monotonic()
            ready = wait(list(pending), timeout=left)
            if not ready and end is not None and time.monotonic() >= end:
                raise TimeoutError(f"data-parallel ranks still running after {timeout} s")
            for s in ready:
                p = pending.pop(s)
                p.join()
                if p.exitcode != 0:
                    raise RuntimeError(f"data-parallel {p.name} of {world} exited with code "
                                       f"{p.exitcode}")
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
            p.join(timeout=30)
        shutil.rmtree(store, ignore_errors=True)


def _worker(rank: int, world: int, target: Callable, args: Tuple, device_type: str,
            init_method: str, threads: Optional[int]) -> None:
    """One spawned rank: join the group, run ``target``, leave."""
    import torch

    from ..parallel import init_data_parallel, rank_device, shutdown

    if threads is not None:
        torch.set_num_threads(threads)
    _logging(rank, world)
    dev = rank_device(device_type, rank)
    init_data_parallel(rank, world, _backend(dev), init_method, dev)
    try:
        target(*args, dev)
    finally:
        shutdown()


def train(cfg, device):
    """Build the datamodule and the task, start or resume the state, and
    ``fit`` into ``paths.output_dir``: this process's part of a run (all
    of it without a group)."""
    import torch

    from ..data import SELDDataModule, get_dataset
    from ..train.loop import effective_steps_per_epoch, fit
    from ..train.module import SELDTask
    from ..utils.utilities import count_params, print_config_tree

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
