"""Training, validation and test loops: the counterpart of the JAX
package's train/loop.py (the Lightning-Trainer role).

Parity targets: reference src/models/model_module.py (validation epoch end
:111-146, test epoch end :165-180) and components/model_module.py
(pred_aggregation :177-222, dcase conversion :224-240, move_avg :304-330).

Host syncs: ``run_validation`` queues each batch's loss on the device
before ``Aggregator.append`` fetches the batch's outputs (one blocking fetch
a batch), and ``MeanMeter`` keeps the losses on the device until
``compute`` at the end of the epoch. Decoding, ``move_avg`` and the SELD
metrics are numpy on the host, as in the JAX package.

``fit`` (:356-514) runs epochs of ``SELDTask.train_step_prepared`` with a
validation every ``check_val_every_n_epoch``, early stopping, loggers, the
per-epoch ``metrics.jsonl`` line and the port's checkpoints
(train/checkpoint.py, the reference's Lightning layout: the best epoch's
``checkpoints/epoch_{epoch:03d}.ckpt``, only the best kept, and
``checkpoints/last.ckpt`` every epoch, written by rank zero). A step reads
nothing from the device: ``_PreparedBatchPipeline`` prepares the next batch
(its copy to the device) on a thread while the step runs, and the losses
stay on the device until the epoch end.

In a process group (data parallelism, parallel/mesh.py) every rank runs
``fit`` on its own batches: the steps average their grads over the ranks;
at an epoch's end one all-reduce averages its train losses and sums its ov
counts over the ranks, so the line is the global batches' as one
process's would be; rank 0 alone writes checkpoints, ``metrics.jsonl`` and
the loggers, and a barrier follows its writes; rank 0's early-stopping
decision is broadcast, so every rank leaves the loop at the same epoch.
Validation runs the whole set on every rank without a collective, as in
the JAX package (``make_local_mesh``, docs/PARITY.md deviation #3). Every
collective is issued from the loop's thread; the prefetch thread issues
none.
"""

import json
import logging
import time
from collections import OrderedDict
from pathlib import Path
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..metrics import (SELDMetrics, accdoa_label_to_dcase_format,
                       convert_output_format_cartesian_to_polar,
                       get_accdoa_labels, get_multi_accdoa_labels,
                       multi_accdoa_to_dcase_format, to_metrics_format,
                       track_to_dcase_format, write_output_format_file)
from ..parallel import all_reduce_mean_, barrier, broadcast_flag, is_up, rank, world
from .checkpoint import save_training_ckpt

log = logging.getLogger("pseldnets")


def _sigmoid(x):
    return 1.0 / (1.0 + np.exp(-x))


class Aggregator:
    """Decode accumulated step outputs into frame streams (pred_aggregation)."""

    def __init__(self, cfg, method, num_classes, label_res=0.1):
        self.cfg = cfg
        self.method = method
        self.num_classes = num_classes
        self.label_res = label_res
        self.outputs = []
        self.num_preds_per_chunk = int(cfg["data"]["test_chunklen_sec"] / label_res)

    def append(self, preds: Dict):
        """Fetch one batch's outputs (device tensors or arrays) to the host."""
        self.outputs.append({k: v.detach().float().cpu().numpy() if isinstance(v, torch.Tensor)
                             else np.asarray(v, np.float32) for k, v in preds.items()})

    def get_num_frames(self, x):
        return int(np.ceil(x / self.num_preds_per_chunk) * self.num_preds_per_chunk)

    def aggregate(self, paths_dict: Optional[OrderedDict] = None):
        thr = self.cfg.get("sed_threshold", 0.5)
        thr = np.asarray(thr, np.float32)
        K = self.num_classes
        if self.method == "accdoa":
            pred = np.concatenate([o["accdoa"] for o in self.outputs], axis=0)
            sed, doa = get_accdoa_labels(pred, K, thr)
            return sed.reshape(-1, K), doa.reshape(-1, 3 * K)
        if self.method == "einv2":
            sed = _sigmoid(np.concatenate([o["sed"] for o in self.outputs], axis=0))
            doa = np.concatenate([o["doa"] for o in self.outputs], axis=0)
            # keep only the top class per track, then threshold
            top = np.argmax(sed, axis=-1)
            mask = np.zeros_like(sed, bool)
            np.put_along_axis(mask, top[..., None], True, axis=-1)
            sed = (sed > thr) & mask
            B, T, tracks = sed.shape[:3]
            return (sed.reshape(B * T, tracks, -1),
                    doa.reshape(B * T, tracks, -1))
        if self.method == "multi_accdoa":
            pred = np.concatenate([o["multi_accdoa"] for o in self.outputs], axis=0)
            if self.cfg.get("post_processing") == "move_avg" and paths_dict:
                pred = self.move_avg(pred, paths_dict)
            sed, doa = get_multi_accdoa_labels(pred, K, thr)
            sed = sed.reshape(3, -1, K).transpose(1, 0, 2)  # (N*T, tracks, K)
            doa = doa.reshape(3, -1, 3 * K).transpose(1, 0, 2)
            return sed, doa
        raise NotImplementedError(self.method)

    def move_avg(self, preds, paths_dict):
        """Overlapped-chunk moving-average stitching (reference
        components/model_module.py:304-330)."""
        test_chunk = self.cfg["data"]["test_chunklen_sec"]
        test_hop = self.cfg["data"]["test_hoplen_sec"]
        assert test_chunk % test_hop == 0
        chunk_len = int(test_hop / self.label_res)
        outputs = []
        batch_ind = 0
        for seg_len in paths_dict.values():
            num_chunks = int(np.ceil((seg_len - test_chunk / self.label_res)
                                     / chunk_len)) + 1
            valid_chunks = int(np.ceil(seg_len / chunk_len))
            tgt_len = self.get_num_frames(seg_len)
            local = preds[batch_ind:batch_ind + num_chunks]
            pieces = []
            for i in range(valid_chunks):
                left = int(max(0, i - test_chunk // test_hop + 1))
                right = int(min(i + 1, num_chunks))
                stack = [local[j, (i - j) * chunk_len:(i - j + 1) * chunk_len]
                         for j in range(left, right)]
                pieces.append(np.mean(np.stack(stack, 0), axis=0))
            res = np.concatenate(pieces, axis=0)
            if res.shape[0] < tgt_len:
                res = np.concatenate(
                    [res, np.zeros((tgt_len - res.shape[0],) + res.shape[1:],
                                   res.dtype)], axis=0)
            else:
                res = res[:tgt_len]
            outputs.append(res)
            batch_ind += num_chunks
        return np.concatenate(outputs)[None]

    def to_dcase_polar(self, pred_sed, pred_doa):
        """(reference convert_to_dcase_format_polar :224-240)."""
        if self.method == "accdoa":
            d = accdoa_label_to_dcase_format(pred_sed, pred_doa, self.num_classes)
            return convert_output_format_cartesian_to_polar(d)
        if self.method == "einv2":
            azi = np.arctan2(pred_doa[..., 1], pred_doa[..., 0])
            ele = np.arctan2(pred_doa[..., 2],
                             np.sqrt(pred_doa[..., 0] ** 2 + pred_doa[..., 1] ** 2))
            return track_to_dcase_format(pred_sed, np.stack((azi, ele), axis=-1))
        if self.method == "multi_accdoa":
            sed = pred_sed.transpose(1, 0, 2)
            doa = pred_doa.transpose(1, 0, 2)
            d = multi_accdoa_to_dcase_format(sed, doa, nb_classes=self.num_classes)
            return convert_output_format_cartesian_to_polar(d)
        raise NotImplementedError(self.method)


class MeanMeter:
    """Deferred mean: the values stay device tensors (no host sync on
    update); ``compute`` fetches them once, at the end of the epoch, and
    averages in float64 as the JAX package's meter does."""

    def __init__(self):
        self.values = []

    def update(self, v):
        self.values.append(v)

    def compute(self):
        if not self.values:
            return 0.0
        dev = next((v.device for v in self.values if isinstance(v, torch.Tensor)), "cpu")
        vals = torch.stack([torch.as_tensor(v, dtype=torch.float32, device=dev).reshape(())
                            for v in self.values]).cpu().numpy()  # the one fetch
        return float(np.mean(vals.astype(np.float64)))


def run_validation(task, datamodule, metrics: SELDMetrics, limit_batches: Optional[int] = None):
    """-> (macro_dict, micro_dict, val_losses). Mirrors validation_step +
    on_validation_epoch_end. The model and its weights are ``task``'s (the
    JAX loop's ``state`` lives in the task here). ``limit_batches``
    truncates the loader (fit's sanity pass and ``limit_val_batches``;
    reference configs/debug/default.yaml:20); only files whose whole padded
    chunk span was read are scored."""
    agg = Aggregator(task.cfg, task.method, task.num_classes, task.label_res)
    val_losses = {k: MeanMeter() for k in task.loss.loss_dict_keys}
    post = task.cfg.get("post_processing")
    loader = datamodule.val_dataloader()
    try:
        for bi, batch in enumerate(loader):
            if limit_batches is not None and bi >= limit_batches:
                break
            preds = task.eval_step(batch, post_processing=post)
            # queued on the device BEFORE agg.append's blocking fetch;
            # MeanMeter defers the scalar fetch to the epoch end
            for k, v in task.validation_losses(preds, batch).items():
                val_losses[k].update(v)
            agg.append(preds)
    finally:
        if hasattr(loader, "close"):
            loader.close()

    pred_sed, pred_doa = agg.aggregate(datamodule.paths_dict)
    metrics.reset()
    frame_ind = 0
    for path, loc_frames in datamodule.paths_dict.items():
        num_frames = agg.get_num_frames(loc_frames)
        if frame_ind + num_frames > len(pred_sed):
            break  # a stream cut by limit_batches: this file's span is not whole
        pred_dcase = agg.to_dcase_polar(pred_sed[frame_ind:frame_ind + loc_frames],
                                        pred_doa[frame_ind:frame_ind + loc_frames])
        gt_dcase = datamodule.valid_gt_dcaseformat[path]
        metrics.update_seld_scores(
            pred=to_metrics_format(pred_dcase, loc_frames),
            gt=to_metrics_format(gt_dcase, loc_frames))
        frame_ind += num_frames
    macro, _ = metrics.compute_seld_scores("macro")
    micro, _ = metrics.compute_seld_scores("micro")
    return macro, micro, {k: m.compute() for k, m in val_losses.items()}


def run_test(task, datamodule, submissions_dir: Path):
    """Mirrors test_step + on_test_epoch_end: write submission CSVs."""
    agg = Aggregator(task.cfg, task.method, task.num_classes, task.label_res)
    post = task.cfg.get("post_processing")
    loader = datamodule.test_dataloader()
    try:
        for batch in loader:
            agg.append(task.eval_step(batch, post_processing=post))
    finally:
        if hasattr(loader, "close"):
            loader.close()
    pred_sed, pred_doa = agg.aggregate(datamodule.paths_dict)
    submissions_dir = Path(submissions_dir)
    submissions_dir.mkdir(parents=True, exist_ok=True)
    frame_ind = 0
    for path, loc_frames in datamodule.paths_dict.items():
        num_frames = agg.get_num_frames(loc_frames)
        pred_dcase = agg.to_dcase_polar(pred_sed[frame_ind:frame_ind + loc_frames],
                                        pred_doa[frame_ind:frame_ind + loc_frames])
        write_output_format_file(submissions_dir / (Path(path).stem + ".csv"),
                                 pred_dcase)
        frame_ind += num_frames
    log.info("Results are saved to %s", submissions_dir)


class EarlyStopping:
    """Lightning-semantics EarlyStopping (reference
    configs/callbacks/early_stopping.yaml): active only when the composed
    callbacks.early_stopping block carries a ``_target_`` (i.e. the user
    added early_stopping.yaml to the callbacks defaults, as in the
    reference); the inert monitor/patience block in callbacks/default.yaml
    does not arm it."""

    def __init__(self, monitor, mode="min", patience=3, min_delta=0.0,
                 check_finite=True, stopping_threshold=None,
                 divergence_threshold=None, verbose=False, **_):
        self.monitor = monitor
        self.sign = -1.0 if mode == "min" else 1.0
        self.patience = int(patience)
        self.min_delta = abs(float(min_delta))
        self.check_finite = check_finite
        self.stopping_threshold = stopping_threshold
        self.divergence_threshold = divergence_threshold
        self.best = -float("inf")
        self.wait_count = 0

    def should_stop(self, metrics: Dict) -> Optional[str]:
        """-> stop reason, or None to continue. Call once per validation."""
        if self.monitor not in metrics:
            return None
        v = float(metrics[self.monitor])
        if self.check_finite and not np.isfinite(v):
            return f"{self.monitor} is not finite ({v})"
        if self.stopping_threshold is not None and \
                self.sign * v >= self.sign * float(self.stopping_threshold):
            return f"{self.monitor} reached stopping_threshold"
        if self.divergence_threshold is not None and \
                self.sign * v <= self.sign * float(self.divergence_threshold):
            return f"{self.monitor} crossed divergence_threshold"
        if self.sign * v > self.best + self.min_delta:
            self.best = self.sign * v
            self.wait_count = 0
            return None
        self.wait_count += 1
        if self.wait_count >= self.patience:
            return (f"{self.monitor} did not improve by {self.min_delta} "
                    f"over {self.patience} validations")
        return None


def make_early_stopping(cfg) -> Optional[EarlyStopping]:
    es_cfg = (cfg.get("callbacks") or {}).get("early_stopping") or {}
    if "_target_" not in es_cfg or not es_cfg.get("monitor"):
        return None
    return EarlyStopping(**{k: v for k, v in es_cfg.items() if k != "_target_"})


class _PreparedBatchPipeline:
    """Double buffer between the host and the device in the train loop: ONE
    background thread runs ``task.prepare_batch`` (the copy to the device)
    for batch N+1 while batch N's step runs. One thread keeps the loader's
    order; the depth-2 queue bounds the batches alive. A worker's exception
    is raised in the consumer; ``close()`` never blocks on the worker."""

    def __init__(self, task, loader, depth: int = 2):
        import queue
        import threading

        self.loader = loader
        self.q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self.thread = threading.Thread(target=self._worker, args=(task,), daemon=True)
        self.thread.start()

    def _worker(self, task):
        try:
            for batch in self.loader:
                if self._stop.is_set():
                    return
                if not self._put(("ok", task.prepare_batch(batch))):
                    return
        except BaseException as e:  # surfaced to the consumer
            self._put(("err", e))
            return
        finally:
            self._put((None, None))

    def _put(self, item) -> bool:
        import queue

        while not self._stop.is_set():
            try:
                self.q.put(item, timeout=0.2)
                return True
            except queue.Full:
                continue
        return False

    def __iter__(self):
        return self

    def __next__(self):
        kind, item = self.q.get()
        if kind == "err":
            raise item
        if kind is None:
            raise StopIteration
        return item

    def close(self):
        import queue

        self._stop.set()
        try:
            self.q.get_nowait()
        except queue.Empty:
            pass
        if hasattr(self.loader, "close"):
            self.loader.close()

    def __del__(self):
        self.close()


def epoch_over_ranks(means: Dict[str, float], counts: Dict[str, int], device
                     ) -> Tuple[Dict[str, float], Dict[str, int]]:
    """An epoch's train-loss ``means`` averaged and its ov ``counts`` summed
    over the ranks of the process group, in one float64 all-reduce on
    ``device`` (every rank ran as many steps on as many clips); both as
    they are without a group."""
    if not is_up():
        return means, counts
    t = torch.tensor(list(means.values()) + list(counts.values()), dtype=torch.float64,
                     device=device)
    all_reduce_mean_([t])
    vals = t.tolist()
    n = len(means)
    return (dict(zip(means, vals[:n])),
            {k: int(round(v * world())) for k, v in zip(counts, vals[n:])})


def effective_steps_per_epoch(datamodule, cfg) -> int:
    """Steps actually run per epoch, honoring trainer.limit_train_batches.
    The OPTIMIZER must be built with this same number — the per-epoch LR
    schedulers (StepLR etc.) map step -> epoch via steps_per_epoch, and the
    reference steps its scheduler once per real epoch regardless of the
    limit (Lightning semantics)."""
    steps = datamodule.steps_per_epoch()
    limit_train = (cfg.get("trainer") or {}).get("limit_train_batches")
    if limit_train:
        steps = max(int(steps * float(limit_train))
                    if limit_train <= 1 else int(limit_train), 1)
    return steps


def fit(task, datamodule, cfg, output_dir, timings: Optional[list] = None):
    """Training loop (the JAX package's fit, loop.py:356-514): epochs of
    train steps from ``task.state`` (``init_state``; an exact resume starts
    at its epoch and best score), a validation every
    ``check_val_every_n_epoch`` epochs monitoring val/macro/SELD_scr (min),
    checkpoints, the ``metrics.jsonl`` line and the loggers each epoch,
    early stopping. -> ``task.state``.

    ``timings``, where given, gets one dict an epoch: ``train_s`` (the
    epoch's steps, from the start of its first step until its losses are
    fetched, which waits for the device), ``val_s`` (0.0 without a
    validation), ``ckpt_s`` and ``ckpt_bytes`` (the checkpoints written)."""
    from ..utils.utilities import flatten_metrics, instantiate_loggers

    output_dir = Path(output_dir)
    state = task.state
    if state is None:
        raise RuntimeError("call task.init_state() first")
    trainer_cfg = cfg.get("trainer") or {}
    max_epochs = int(trainer_cfg.get("max_epochs", 50))
    check_every = int(trainer_cfg.get("check_val_every_n_epoch", 1))
    steps_per_epoch = effective_steps_per_epoch(datamodule, cfg)

    # multi-process: checkpoints and metric files are written by rank zero
    # only (every rank holds the whole state); every rank validates, without
    # a collective
    is_main = rank() == 0
    loggers = instantiate_loggers(cfg.get("logger"), output_dir) if is_main else []
    limit_val = trainer_cfg.get("limit_val_batches")
    if limit_val is not None:
        limit_val = int(limit_val)

    early_stopping = make_early_stopping(cfg)
    ckpt_dir = (output_dir / "checkpoints").resolve()
    ckpt_dir.mkdir(parents=True, exist_ok=True)
    metrics = SELDMetrics(nb_classes=task.num_classes, doa_threshold=20)
    metrics_log = output_dir / "metrics.jsonl"
    generator = torch.Generator(device=task.device).manual_seed(int(cfg.get("seed", 0)))
    stat = {"ov1": 0, "ov2": 0, "ov3": 0}
    epoch = state.epoch
    if epoch:
        log.info("resumed training at epoch %d (step %d, best %s)", epoch, state.step,
                 state.best_score)

    # num_sanity_val_steps (reference configs/debug/default.yaml:16, Lightning
    # semantics): N validation batches (-1 = the whole set) before training,
    # the results discarded: eval-path faults show before the first epoch
    sanity = int(trainer_cfg.get("num_sanity_val_steps", 0) or 0)
    if sanity and epoch < max_epochs:
        log.info("sanity validation pass (%s batches)", "all" if sanity < 0 else sanity)
        run_validation(task, datamodule, metrics, limit_batches=None if sanity < 0 else sanity)

    # profile: N captures the first N train steps (torch.profiler, a Chrome
    # trace under <output_dir>/profile; rank zero's only)
    profile_steps = int(cfg.get("profile", 0) or 0) if is_main else 0
    prof = None
    if profile_steps:
        from torch.profiler import ProfilerActivity, profile

        prof = profile(activities=[ProfilerActivity.CPU] + (
            [ProfilerActivity.CUDA] if task.device.type == "cuda" else []))
        prof.start()

    loader = datamodule.train_dataloader(num_batches=steps_per_epoch * max(max_epochs - epoch, 0))
    pipeline = _PreparedBatchPipeline(task, loader)
    step_in_epoch = 0
    global_step = 0
    train_losses = {k: MeanMeter() for k in task.loss.loss_dict_keys}
    t0 = time.time()
    try:
        for prepared in pipeline:
            if step_in_epoch == 0:
                t_epoch = time.time()
            losses, ov = task.train_step_prepared(prepared, generator)
            global_step += 1
            if prof is not None and global_step == profile_steps:
                if task.device.type == "cuda":
                    torch.cuda.synchronize(task.device)
                prof.stop()
                trace = output_dir / "profile" / "trace.json"
                trace.parent.mkdir(parents=True, exist_ok=True)
                prof.export_chrome_trace(str(trace))
                log.info("profiler trace written to %s", trace)
                prof = None
            for k, v in losses.items():
                train_losses[k].update(v)
            if ov is not None:
                for o in ov:
                    stat[f"ov{o}"] = stat.get(f"ov{o}", 0) + 1
            step_in_epoch += 1
            if step_in_epoch < steps_per_epoch:
                continue

            # ---- epoch end ----
            epoch += 1
            step_in_epoch = 0
            state.epoch = epoch
            lr = float(task.lr_fn(state.step))
            train_means, ov_stat = epoch_over_ranks(
                {k: m.compute() for k, m in train_losses.items()}, dict(stat), task.device)
            log_line = {"epoch": epoch, "lr": lr, "train": train_means,
                        "ov_stat": ov_stat, "wall_s": round(time.time() - t0, 1)}
            t_val = time.time()
            train_s = t_val - t_epoch
            train_losses = {k: MeanMeter() for k in task.loss.loss_dict_keys}
            stat = {"ov1": 0, "ov2": 0, "ov3": 0}

            if epoch % check_every == 0:
                macro, micro, val_losses = run_validation(task, datamodule, metrics,
                                                          limit_batches=limit_val)
                log_line["val"] = {"macro": macro, "micro": micro, "losses": val_losses}
                log.info("epoch %d val/macro: %s", epoch,
                         {k: round(v, 4) for k, v in macro.items()})
            t_ckpt = time.time()
            ckpt_bytes = 0
            if "val" in log_line and log_line["val"]["macro"]["SELD_scr"] < state.best_score:
                state.best_score = log_line["val"]["macro"]["SELD_scr"]
                if is_main:
                    # save_top_k=1 (reference configs/callbacks/default.yaml)
                    best = ckpt_dir / f"epoch_{epoch:03d}.ckpt"
                    ckpt_bytes += save_training_ckpt(best, task.model, global_step=state.step,
                                                     epoch=epoch)
                    for old in ckpt_dir.glob("epoch_*.ckpt"):
                        if old.name != best.name:
                            old.unlink()
            if is_main:
                ckpt_bytes += save_training_ckpt(ckpt_dir / "last.ckpt", task.model,
                                                 state.optimizer, global_step=state.step,
                                                 epoch=epoch, best_score=state.best_score)
            barrier()  # every rank past rank 0's writes
            if timings is not None:
                timings.append({"epoch": epoch, "train_s": train_s, "val_s": t_ckpt - t_val,
                                "ckpt_s": time.time() - t_ckpt, "ckpt_bytes": ckpt_bytes})
            log.info("epoch %d/%d train: %s lr=%.2e", epoch, max_epochs,
                     {k: round(v, 4) for k, v in log_line["train"].items()}, lr)
            if is_main:
                with open(metrics_log, "a") as f:
                    f.write(json.dumps(log_line) + "\n")
            flat = flatten_metrics(log_line)
            for lg in loggers:
                lg.log_metrics(flat, epoch)
            reason = None
            if early_stopping is not None and "val" in log_line:
                reason = early_stopping.should_stop(flat)
            # rank 0 decides for every rank: a rank that left alone would
            # leave the others waiting in their next collective
            if broadcast_flag(bool(reason), task.device):
                log.info("early stopping at epoch %d: %s", epoch,
                         reason or "rank 0 stopped")
                break
            if epoch >= max_epochs:
                break
    finally:
        pipeline.close()
        if prof is not None:
            prof.stop()
        for lg in loggers:
            lg.close()
    return state
