"""Validation and test loops: the eval half of the JAX package's
train/loop.py (:29-219).

Parity targets: reference src/models/model_module.py (validation epoch end
:111-146, test epoch end :165-180) and components/model_module.py
(pred_aggregation :177-222, dcase conversion :224-240, move_avg :304-330).

Host syncs: ``run_validation`` queues each batch's loss on the device
before ``Aggregator.append`` fetches the batch's outputs (one blocking fetch
a batch), and ``MeanMeter`` keeps the losses on the device until
``compute`` at the end of the epoch. Decoding, ``move_avg`` and the SELD
metrics are numpy on the host, as in the JAX package.

The epoch loop ``fit``, ``EarlyStopping`` and the prefetch pipeline
(:221-514) come with ROADMAP.md queue A step 4.
"""

import logging
from collections import OrderedDict
from pathlib import Path
from typing import Dict, Optional

import numpy as np
import torch

from ..metrics import (SELDMetrics, accdoa_label_to_dcase_format,
                       convert_output_format_cartesian_to_polar,
                       get_accdoa_labels, get_multi_accdoa_labels,
                       multi_accdoa_to_dcase_format, to_metrics_format,
                       track_to_dcase_format, write_output_format_file)

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


def run_validation(task, datamodule, metrics: SELDMetrics):
    """-> (macro_dict, micro_dict, val_losses). Mirrors validation_step +
    on_validation_epoch_end. The model and its weights are ``task``'s (the
    JAX loop's ``state`` lives in the task here)."""
    agg = Aggregator(task.cfg, task.method, task.num_classes, task.label_res)
    val_losses = {k: MeanMeter() for k in task.loss.loss_dict_keys}
    post = task.cfg.get("post_processing")
    loader = datamodule.val_dataloader()
    try:
        for batch in loader:
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
