"""The ranks of tests/test_torch_tp.py: functions that the train CLI's
launcher (``pseldnets_tpu_torch.cli.train.spawn``) runs in each of its gloo
processes on the CPU, as ``fn(*args, device)``, with
``trainer.tensor_parallel`` set in their configs. Each writes what it
computed to ``<out>/rank{r}.pt`` for the test to hold against one process
on the global batch. This module imports neither JAX nor the JAX package
(the spawned processes import it by name).

A rank takes rows ``data_rank::data_world`` of each global array: the rows
that the sampler gives its data row (every model rank of a row the same)."""

import copy
from pathlib import Path

import torch

from pseldnets_tpu_torch.parallel import (all_reduce_mean_, barrier, data_rank, data_world,
                                          model_rank, model_world, rank, world)
from pseldnets_tpu_torch.parallel import tp as tensor_parallel

import torch_ddp_workers


def rows(a):
    """This rank's data rows of a global array or tensor."""
    return a[data_rank()::data_world()]


def _save(out, payload):
    torch.save(payload, str(Path(out) / f"rank{rank()}.pt"))


def _task(cfg, num_classes, device, steps_per_epoch=2):
    from pseldnets_tpu_torch.train.module import DatasetSpec, SELDTask

    return SELDTask(cfg, DatasetSpec(num_classes=num_classes), steps_per_epoch=steps_per_epoch,
                    device=device)


def _full_grads(task, grads):
    """The trained parameters' grads at full width: the split ones gathered
    over the model row."""
    split = [(n, g) for n, g in zip(task.trained_names, grads) if n in task.tp_plan]
    full = dict(zip([n for n, _ in split], tensor_parallel.gather_tensors(
        [g for _, g in split], [task.tp_plan[n] for n, _ in split])))
    return [full.get(n, g).clone() for n, g in zip(task.trained_names, grads)]


def _full_state(task):
    return {k: v.detach().clone() for k, v in task.full_model().state_dict().items()}


def steps(cfg, num_classes, batches, seeds, state_dict=None, dp_masks=None,
          keep_stats=False, device="cpu"):
    """A SELDTask from ``cfg`` (``state_dict``, full-width weights, loaded
    after ``init_state`` where not None): first ``compute_grads`` on the
    first global batch with a generator of ``seeds[0]``, its grads averaged
    over the data column and gathered to full width (``keep_stats``: the
    statistics the eager BatchNorms wrote in that pass put back, so the
    steps start from the loaded ones); then one ``train_step`` a global
    batch, a generator of the next seed, or ``dp_masks`` (one list of
    global (N, 2) masks a step) injected as this rank's data rows. -> the
    record: the losses, the grads, the gathered state after the steps, the
    split plan's names, the frozen parameters' initial values."""
    task = _task(cfg, num_classes, device)
    task.init_state(0)
    if state_dict is not None:
        task.load_full_state(state_dict)
    frozen = {n: p.detach().clone() for n, p in task.full_model().named_parameters()
              if n not in task.trained_names}
    first = {k: rows(v) for k, v in batches[0].items()}
    labels = {k: v for k, v in first.items() if k != "data"}
    stats = {k: v.clone() for k, v in task.model.named_buffers()}
    losses, grads, _ = task.compute_grads(first["data"], labels,
                                          torch.Generator(device=device).manual_seed(seeds[0]))
    if keep_stats:
        with torch.no_grad():
            for k, v in task.model.named_buffers():
                v.copy_(stats[k])
    all_reduce_mean_(grads)
    res = {"grad_loss": float(losses["loss_all"].detach()), "grads": _full_grads(task, grads),
           "losses": [], "plan": list(task.tp_plan), "frozen": frozen,
           "layout": (world(), data_world(), model_world(), data_rank(), model_rank()),
           "fused": task.fused_forward, "local_shapes": {n: tuple(p.shape) for n, p in
                                                         task.model.named_parameters()}}
    for i, (batch, seed) in enumerate(zip(batches, seeds[1:])):
        mine = {k: rows(v) for k, v in batch.items()}
        kw = {}
        if dp_masks is not None:
            kw["dp_masks"] = [torch.as_tensor(rows(m)) for m in dp_masks[i]]
        else:
            kw["generator"] = torch.Generator(device=device).manual_seed(seed)
        res["losses"].append(float(task.train_step(mine.pop("data"), mine, **kw)["loss_all"]))
    res["state"] = _full_state(task)
    res["step"] = task.state.step
    return res


def steps_rank(cases, out, device):
    """``steps`` of each case {name: (cfg, num_classes, batches, seeds,
    state_dict, dp_masks[, keep_stats])} in turn, one record a case."""
    _save(out, {name: steps(*args, device=device) for name, args in cases.items()})


def _refusal(fn):
    try:
        fn()
    except ValueError as e:
        return str(e)
    return None


def checkpoints_rank(cfg, data, out, device):
    """Checkpoints under tensor parallelism, each run in
    ``<out>/<run>/rank{r}``: ``fit`` two epochs straight; one epoch, then a
    resume from rank 0's ``last.ckpt`` to the second; a split task loading
    the one-process files ``<out>/one.ckpt`` (weights) and
    ``<out>/one_last.ckpt`` (a training state), its gathered state and
    optimizer state recorded; and the refusal of ``fused_forward=true``."""
    from pseldnets_tpu_torch.train import loop

    task = _task(cfg, 3, device, len(data["train"]))  # the layout first: rows read it
    dm = torch_ddp_workers.RankMemoryData(**data)
    dm.train = [{k: rows(v) for k, v in b.items()} for b in data["train"]]
    r = rank()

    def run(name, max_epochs):
        c = copy.deepcopy(cfg)
        c["trainer"]["max_epochs"] = max_epochs
        state = loop.fit(task, dm, c, Path(out) / name / f"rank{r}")
        return {"epoch": state.epoch, "step": state.step, "state": _full_state(task)}

    res = {}
    task.init_state(0)
    res["straight"] = run("straight", 2)
    task.init_state(0)
    res["one"] = run("one", 1)
    task.init_state(0, ckpt_path=str(Path(out) / "one" / "rank0" / "checkpoints" / "last.ckpt"))
    res["resumed_at"] = {"epoch": task.state.epoch, "step": task.state.step}
    res["resumed"] = run("resumed", 2)
    barrier()
    task.init_state(0, ckpt_path=str(Path(out) / "one.ckpt"))
    res["loaded"] = _full_state(task)
    task.init_state(0, ckpt_path=str(Path(out) / "one_last.ckpt"))
    res["loaded_last"] = {"state": _full_state(task), "opt": task.checkpoint_optimizer(),
                          "step": task.state.step}
    fused = copy.deepcopy(cfg)
    fused["trainer"]["fused_forward"] = True
    res["fused_refused"] = _refusal(lambda: _task(fused, 3, device))
    _save(out, res)

