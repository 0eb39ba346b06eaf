"""The ranks of tests/test_torch_ddp.py: functions that the train CLI's
launcher (``pseldnets_tpu_torch.cli.train.spawn``) runs in each of its gloo
processes on the CPU, as ``fn(*args, device)``. Each writes what it
computed to ``<out>/rank{r}.pt`` for the test to hold against one process
on the global batch. This module imports neither JAX nor the JAX package
(the spawned processes import it by name); the test file, which does, is
never imported by a rank.

A rank takes rows ``rank::world`` of each global array, the rows that the
sampler gives it (data/sampler.py)."""

import copy
from collections import OrderedDict
from pathlib import Path

import torch

from pseldnets_tpu_torch.augment import (Crop, FreqShift, RotationDevice, SpecAugment,
                                         TrackMixDevice)
from pseldnets_tpu_torch.models.common import (BatchNorm2d, DropoutDraws, ScalarBN,
                                               TorchBatchNorm, drop_path_masks)
from pseldnets_tpu_torch.parallel import all_reduce_mean_, rank, world

DRAW_SEED = 11


def rows(a):
    """This rank's rows of a global array or tensor."""
    return a[rank()::world()]


def _save(out, payload):
    torch.save(payload, str(Path(out) / f"rank{rank()}.pt"))


def bn_module(kind, state):
    """A training BatchNorm of ``kind`` ("scalar" (C=3, F=5), "2d" (4
    channels) or "conformer" (6 features over (B, T))) holding ``state``."""
    m = {"scalar": lambda: ScalarBN(3, 5), "2d": lambda: BatchNorm2d(4),
         "conformer": lambda: TorchBatchNorm((6,), reduce_axes=(0, 1))}[kind]()
    m.load_state_dict(state)
    return m.train()


def bn_step(kind, state, x, g):
    """Forward of ``x`` in train mode, then the grads of sum(y * g): ->
    (y, running mean, running var, dx, dweight, dbias)."""
    m = bn_module(kind, state)
    x = x.clone().requires_grad_(True)
    y = m(x)
    dx, dw, db = torch.autograd.grad((y * g).sum(), (x, m.weight, m.bias))
    return y.detach(), m.running_mean.clone(), m.running_var.clone(), dx, dw, db


def draws_of(N, device="cpu"):
    """Every per-clip device draw of a batch of N clips, in one order from
    one generator: a windowed dropout site (N * 3 rows), flax's
    attention-weights mask (no batch axis), drop-path masks, and the draws
    of SpecAugment, Crop, FreqShift, TrackMixDevice and RotationDevice."""
    g = torch.Generator(device=device).manual_seed(DRAW_SEED)
    d = DropoutDraws(g, batch=N)
    out = {"windows": d.keep((3 * N, 2, 4), 0.3, device),
           "weights": d.keep((1, 1, 4, 4), 0.3, device, batched=False)}
    for i, m in enumerate(drop_path_masks(g, N, [0.0, 0.2, 0.4], device)):
        out[f"dp{i}"] = m
    shape = (N, 7, 50, 16)
    for name, aug in (("spec", SpecAugment(xy_ratio=5)), ("crop", Crop()),
                      ("shift", FreqShift()), ("mix", TrackMixDevice()),
                      ("rot", RotationDevice(p=0.5))):
        for k, v in aug.draw(g, shape).items():
            out[f"{name}.{k}"] = v
    return out


def bn_and_draws_rank(cases, out, device):
    """Each BatchNorm case (kind, state, global x, global upstream g) on
    this rank's rows, and ``draws_of`` its clips."""
    res = {k: bn_step(kind, state, rows(x), rows(g)) for k, (kind, state, x, g) in cases.items()}
    n_local = next(iter(cases.values()))[2].shape[0] // world()
    _save(out, {"bn": res, "draws": draws_of(n_local, device)})


def seld_steps_rank(cfg, num_classes, batches, seeds, variables, dp_masks, out, device):
    """A SELDTask from ``cfg`` (``variables``, JAX weights, loaded after
    ``init_state`` where not None): first ``compute_grads`` on the first global
    batch with a generator of ``seeds[0]``, its grads averaged over the
    ranks (the reduction a step makes); then one ``train_step`` a global
    batch, the generator of the next seed, or ``dp_masks`` (one list of
    global (W * B, 2) masks a step, where not None) injected as this
    rank's rows."""
    from pseldnets_tpu_torch.train.checkpoint import load_jax_variables
    from pseldnets_tpu_torch.train.module import DatasetSpec, SELDTask

    task = SELDTask(cfg, DatasetSpec(num_classes=num_classes), steps_per_epoch=2, device=device)
    task.init_state(0)
    if variables is not None:
        load_jax_variables(task.model, variables)
    first = {k: rows(v) for k, v in batches[0].items()}
    labels = {k: v for k, v in first.items() if k != "data"}
    losses, grads, _ = task.compute_grads(first["data"], labels,
                                          torch.Generator(device=device).manual_seed(seeds[0]))
    all_reduce_mean_(grads)
    res = {"grad_loss": float(losses["loss_all"].detach()), "grads": [g.clone() for g in grads],
           "losses": []}
    for i, (batch, seed) in enumerate(zip(batches, seeds[1:])):
        mine = {k: rows(v) for k, v in batch.items()}
        kw = {}
        if dp_masks is not None:
            kw["dp_masks"] = [torch.as_tensor(rows(m)) for m in dp_masks[i]]
        else:
            kw["generator"] = torch.Generator(device=device).manual_seed(seed)
        losses = task.train_step(mine.pop("data"), mine, **kw)
        res["losses"].append(float(losses["loss_all"]))
    res["state"] = {k: v.clone() for k, v in task.model.state_dict().items()}
    res["step"] = task.state.step
    _save(out, res)


class RankMemoryData:
    """What ``fit`` reads of a datamodule: this rank's rows of the global
    train batches (the same batches every epoch) and the whole validation
    set (every rank validates all of it)."""

    def __init__(self, train, val, paths_dict, gt):
        self.train = [{k: rows(v) for k, v in b.items()} for b in train]
        self.val = val
        self.paths_dict = OrderedDict(paths_dict)
        self.valid_gt_dcaseformat = OrderedDict(gt)

    def steps_per_epoch(self):
        return len(self.train)

    def train_dataloader(self, num_batches=None):
        n = len(self.train) if num_batches is None else num_batches
        return iter([self.train[i % len(self.train)] for i in range(n)])

    def val_dataloader(self):
        return iter(self.val)


def fit_rank(cfg, data, out, device):
    """``fit`` on this rank, each run in ``<out>/<run>/rank{r}``: two epochs
    straight; one epoch, then a resume from rank 0's ``last.ckpt`` to the
    second; and three epochs with early stopping armed on rank 0 alone (a
    rank that stopped alone would leave the other waiting). A rank other
    than 0 also tries to write a checkpoint, which must raise."""
    from pseldnets_tpu_torch.train import loop
    from pseldnets_tpu_torch.train.checkpoint import save_training_ckpt
    from pseldnets_tpu_torch.train.module import DatasetSpec, SELDTask

    dm = RankMemoryData(**data)
    r = rank()
    task = SELDTask(cfg, DatasetSpec(num_classes=3), steps_per_epoch=dm.steps_per_epoch(),
                    device=device)

    def run(name, max_epochs, base=cfg):
        c = copy.deepcopy(base)
        c["trainer"]["max_epochs"] = max_epochs
        state = loop.fit(task, dm, c, Path(out) / name / f"rank{r}")
        return {"epoch": state.epoch, "step": state.step,
                "state": {k: v.clone() for k, v in task.model.state_dict().items()}}

    res = {}
    task.init_state(0)
    res["straight"] = run("straight", 2)
    task.init_state(0)
    res["one"] = run("one", 1)
    task.init_state(0, ckpt_path=str(Path(out) / "one" / "rank0" / "checkpoints" / "last.ckpt"))
    res["resumed"] = run("resumed", 2)
    stop = copy.deepcopy(cfg)
    if r == 0:  # SELD_scr (min) at or below 10 stops at the first validation
        stop["callbacks"]["early_stopping"] = {
            "_target_": "lightning.pytorch.callbacks.EarlyStopping",
            "monitor": "val/macro/SELD_scr", "mode": "min", "patience": 100,
            "stopping_threshold": 10.0}
    else:
        stop["callbacks"].pop("early_stopping", None)
    task.init_state(0)
    res["early"] = {"epoch": run("early", 3, stop)["epoch"]}
    if r != 0:
        try:
            save_training_ckpt(Path(out) / "refused.ckpt", task.model)
        except RuntimeError as e:
            res["refused"] = str(e)
    _save(out, res)
