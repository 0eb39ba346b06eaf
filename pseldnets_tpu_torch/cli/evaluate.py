"""Standalone SELD scorer, the counterpart of the JAX package's
src/evaluate.py (reference src/evaluate.py): scores a directory of
prediction CSVs against ground-truth metadata CSVs, macro or micro, with
optional jackknife estimates and confidence intervals and per-room
consolidation. Host numpy and scipy; no device runs it.

Usage: python -m pseldnets_tpu_torch.cli.evaluate --gt_csv_dir GT --pred_csv_dir PRED
       [--nb_classes 13] [--doa_thresh 20] [--jackknife] [--consolidate_rooms]
"""

import argparse
import re
from pathlib import Path

import numpy as np
from scipy import stats

from ..metrics import SELDMetrics, load_output_format_file, to_metrics_format


def jackknife_estimation(global_value, partial_estimates, significance_level=0.05):
    """Bias-corrected jackknife estimate + t-test confidence interval
    (reference src/evaluate.py:11-47)."""
    partial_estimates = np.asarray(partial_estimates, float)
    mean_jack = np.mean(partial_estimates)
    n = len(partial_estimates)
    bias = (n - 1) * (mean_jack - global_value)
    std_err = np.sqrt((n - 1) * np.mean((partial_estimates - mean_jack) ** 2))
    estimate = global_value - bias
    t_value = stats.t.ppf(1 - significance_level / 2, n - 1)
    conf = estimate + t_value * np.array((-std_err, std_err))
    return estimate, bias, std_err, conf


class ComputeSELDResults:
    """(reference src/evaluate.py:50-216)."""

    def __init__(self, ref_files_folder, average="macro", doa_thresh=20,
                 nb_classes=13):
        self._desc_dir = Path(ref_files_folder)
        self._doa_thresh = doa_thresh
        self._nb_classes = nb_classes
        self._average = average
        self._ref_labels = {}
        for file in sorted(self._desc_dir.glob("**/*.csv")):
            gt = load_output_format_file(file)
            nb_frames = max(gt.keys())
            self._ref_labels[file.stem] = [
                to_metrics_format(gt, nb_frames), nb_frames, gt]

    @staticmethod
    def get_nb_files(file_list, tag="all"):
        cnt = {}
        for fn in file_list:
            ind = 0 if tag == "all" else int(re.findall(r"(?<=room)\d+", str(fn))[0])
            cnt.setdefault(ind, []).append(fn)
        return cnt

    def get_SELD_Results(self, pred_files_path, is_jackknife=False):
        pred_files = sorted(Path(pred_files_path).glob("*.csv"))
        ev = SELDMetrics(nb_classes=self._nb_classes, doa_threshold=self._doa_thresh)
        pred_labels_dict = {}
        for pf in pred_files:
            pred = load_output_format_file(pf)
            labels = to_metrics_format(pred, self._ref_labels[pf.stem][1])
            ev.update_seld_scores(labels, self._ref_labels[pf.stem][0])
            if is_jackknife:
                pred_labels_dict[pf.stem] = labels
        metric, classwise = ev.compute_seld_scores(self._average)
        ER, F, LE, LR, seld = metric["ER"], metric["F"], metric["LE"], \
            metric["LR"], metric["SELD_scr"]
        if not is_jackknife:
            return ER, F, LE, LR, seld, classwise

        global_values = [ER, F, LE, LR, seld]
        partials = []
        for leave in pred_files:
            ev = SELDMetrics(nb_classes=self._nb_classes,
                             doa_threshold=self._doa_thresh)
            for pf in pred_files:
                if pf is leave:
                    continue
                ev.update_seld_scores(pred_labels_dict[pf.stem],
                                      self._ref_labels[pf.stem][0])
            m, _ = ev.compute_seld_scores(self._average)
            partials.append([m["ER"], m["F"], m["LE"], m["LR"], m["SELD_scr"]])
        partials = np.asarray(partials)
        conf = []
        for i, g in enumerate(global_values):
            conf.append(jackknife_estimation(g, partials[:, i])[3])
        return ([ER, conf[0]], [F, conf[1]], [LE, conf[2]], [LR, conf[3]],
                [seld, conf[4]], classwise)

    def get_consolidated_SELD_results(self, pred_files_path):
        """Per-room metric breakdown (reference src/evaluate.py:161-216)."""
        pred_files = sorted(Path(pred_files_path).glob("*.csv"))
        rooms = self.get_nb_files(pred_files, tag="room")
        out = {}
        for room, files in sorted(rooms.items()):
            ev = SELDMetrics(nb_classes=self._nb_classes,
                             doa_threshold=self._doa_thresh)
            for pf in files:
                pred = load_output_format_file(pf)
                labels = to_metrics_format(pred, self._ref_labels[pf.stem][1])
                ev.update_seld_scores(labels, self._ref_labels[pf.stem][0])
            metric, _ = ev.compute_seld_scores(self._average)
            out[room] = metric
        return out


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--gt_csv_dir", required=True)
    p.add_argument("--pred_csv_dir", required=True)
    p.add_argument("--nb_classes", type=int, default=13)
    p.add_argument("--doa_thresh", type=float, default=20)
    p.add_argument("--average", default="macro", choices=["macro", "micro"])
    p.add_argument("--jackknife", action="store_true")
    p.add_argument("--consolidate_rooms", action="store_true")
    args = p.parse_args(argv)

    scorer = ComputeSELDResults(args.gt_csv_dir, average=args.average,
                                doa_thresh=args.doa_thresh,
                                nb_classes=args.nb_classes)
    if args.consolidate_rooms:
        for room, m in scorer.get_consolidated_SELD_results(args.pred_csv_dir).items():
            print(f"room{room}: " + ", ".join(f"{k}={v:.4f}" for k, v in m.items()))
        return
    res = scorer.get_SELD_Results(args.pred_csv_dir, is_jackknife=args.jackknife)
    if args.jackknife:
        ER, F, LE, LR, seld, _ = res
        for name, (v, ci) in zip(("ER", "F", "LE", "LR", "SELD_scr"),
                                 (ER, F, LE, LR, seld)):
            print(f"{name}: {v:.4f} [{ci[0]:.4f}, {ci[1]:.4f}]")
    else:
        ER, F, LE, LR, seld, _ = res
        print(f"ER: {ER:.4f}, F: {F:.4f}, LE: {LE:.2f}, LR: {LR:.4f}, "
              f"SELD_scr: {seld:.4f}")
    return res


if __name__ == "__main__":
    main()
