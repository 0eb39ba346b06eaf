"""DCASE SELD metric accumulator.

Behavioral contract (reference src/utils/SELD_metrics.py:20-298, itself the
official DCASE implementation of Mesaros et al. WASPAA 2019 + the multi-track
extension of Politis et al. TASLP 2020):

* update per 1 s segment block with class-wise {frame: [doa, ...]} structures
  (produced by metrics.dcase.to_metrics_format)
* per class: GT/pred DOA sets matched frame-wise by Hungarian assignment on
  great-circle distance; matched GT tracks accumulate an average spatial
  distance → TP if ≤ threshold else spatial FP; count deltas → FP/FN
* ER from segment-level substitutions/deletions/insertions
* macro: per-class F/LE/LR with absent classes (LE==180) dropped; micro: pooled

A copy of the JAX package's metrics/seld.py.
"""

from typing import Dict, Tuple

import numpy as np
from scipy.optimize import linear_sum_assignment

_EPS = np.finfo(np.float32).eps


def early_stopping_metric(er, f, le, lr):
    return np.mean([er, 1.0 - f, le / 180.0, 1.0 - lr], axis=0)


def _angular_distance_deg(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Pairwise great-circle distance in degrees between DOA arrays.
    Rows of `a`/`b` are cartesian (x,y,z) or polar (azi, ele) in radians."""
    if a.shape[-1] == 3:
        na = a / (np.linalg.norm(a, axis=-1, keepdims=True) + 1e-10)
        nb = b / (np.linalg.norm(b, axis=-1, keepdims=True) + 1e-10)
        cos = np.clip(na @ nb.T, -1.0, 1.0)
    else:
        az1, el1 = a[:, 0:1], a[:, 1:2]
        az2, el2 = b[None, :, 0], b[None, :, 1]
        cos = np.clip(np.sin(el1) * np.sin(el2) +
                      np.cos(el1) * np.cos(el2) * np.cos(np.abs(az1 - az2)),
                      -1.0, 1.0)
    return np.arccos(cos) * 180.0 / np.pi


def least_distance_between_gt_pred(gt: np.ndarray, pred: np.ndarray
                                   ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Hungarian matching on the pairwise angular-distance matrix."""
    cost = _angular_distance_deg(np.asarray(gt, float), np.asarray(pred, float)) \
        if len(gt) and len(pred) else np.zeros((len(gt), len(pred)))
    row, col = linear_sum_assignment(cost)
    return cost[row, col], row, col


class SELDMetrics:
    def __init__(self, doa_threshold: float = 20, nb_classes: int = 13):
        self._nb_classes = nb_classes
        self._spatial_T = doa_threshold
        self.reset()

    def reset(self):
        K = self._nb_classes
        self._TP = np.zeros(K)
        self._FP = np.zeros(K)
        self._FP_spatial = np.zeros(K)
        self._FN = np.zeros(K)
        self._Nref = np.zeros(K)
        self._S = 0
        self._D = 0
        self._I = 0
        self._total_DE = np.zeros(K)
        self._DE_TP = np.zeros(K)
        self._DE_FP = np.zeros(K)
        self._DE_FN = np.zeros(K)

    # -- scoring ---------------------------------------------------------
    def compute_seld_scores(self, average: str = "macro"):
        ER = (self._S + self._D + self._I) / (self._Nref.sum() + _EPS)
        classwise = []
        if average == "micro":
            F = self._TP.sum() / (_EPS + self._TP.sum() + self._FP_spatial.sum()
                                  + 0.5 * (self._FP.sum() + self._FN.sum()))
            LE = self._total_DE.sum() / float(self._DE_TP.sum() + _EPS) \
                if self._DE_TP.sum() else 180.0
            LR = self._DE_TP.sum() / (_EPS + self._DE_TP.sum() + self._DE_FN.sum())
            SELD_scr = early_stopping_metric(ER, F, LE, LR)
        elif average == "macro":
            F = self._TP / (_EPS + self._TP + self._FP_spatial
                            + 0.5 * (self._FP + self._FN))
            LE = self._total_DE / (self._DE_TP + _EPS)
            LE[self._DE_TP == 0] = 180.0
            LR = self._DE_TP / (_EPS + self._DE_TP + self._DE_FN)
            SELD_scr = early_stopping_metric(np.repeat(ER, self._nb_classes), F, LE, LR)
            classwise = np.array([np.repeat(ER, self._nb_classes), F, LE, LR,
                                  SELD_scr, np.arange(self._nb_classes)])
            absent = np.where(LE == 180.0)[0]
            F = np.delete(F, absent)
            LE = np.delete(LE, absent)
            LR = np.delete(LR, absent)
            SELD_scr = np.delete(SELD_scr, absent)
            classwise = np.delete(classwise, absent, axis=1)
            F = F.mean() if F.size and not np.isnan(F.mean()) else -1.0
            LE = LE.mean() if LE.size and not np.isnan(LE.mean()) else 180.0
            LR = LR.mean() if LR.size and not np.isnan(LR.mean()) else -1.0
            SELD_scr = SELD_scr.mean() if SELD_scr.size and not np.isnan(SELD_scr.mean()) else 1.0
        else:
            raise ValueError(average)
        return ({"ER": float(ER), "F": float(F), "LE": float(LE),
                 "LR": float(LR), "SELD_scr": float(SELD_scr)}, classwise)

    # -- accumulation ------------------------------------------------------
    def update_seld_scores(self, pred: Dict, gt: Dict):
        """pred/gt: {block: {class: [[frame_list, [[doa,...] per frame]]]}}."""
        for block in range(len(gt.keys())):
            loc_FN, loc_FP = 0, 0
            for cls in range(self._nb_classes):
                gt_here = cls in gt[block]
                pred_here = cls in pred[block]
                nb_gt = max(len(v) for v in gt[block][cls][0][1]) if gt_here else None
                nb_pred = max(len(v) for v in pred[block][cls][0][1]) if pred_here else None
                if nb_gt is not None:
                    self._Nref[cls] += nb_gt
                if gt_here and pred_here:
                    matched_dist: Dict[int, list] = {}
                    matched_cnt: Dict[int, list] = {}
                    gt_frames = gt[block][cls][0][0]
                    pred_frames = pred[block][cls][0][0]
                    for gi, gframe in enumerate(gt_frames):
                        if gframe not in pred_frames:
                            continue
                        gt_doas = np.array(gt[block][cls][0][1][gi], float)
                        pi = pred_frames.index(gframe)
                        pred_doas = np.array(pred[block][cls][0][1][pi], float)
                        if gt_doas.shape[-1] == 2:  # degrees -> radians
                            gt_doas = gt_doas * np.pi / 180.0
                            pred_doas = pred_doas * np.pi / 180.0
                        dists, rows, cols = least_distance_between_gt_pred(gt_doas, pred_doas)
                        for di, dv in enumerate(dists):
                            trk = rows[di]
                            matched_dist.setdefault(trk, []).append(dv)
                            matched_cnt.setdefault(trk, []).append(pi)
                    if not matched_dist:
                        # predictions never aligned frame-wise to GT
                        loc_FN += nb_pred
                        self._FN[cls] += nb_pred
                        self._DE_FN[cls] += nb_pred
                    else:
                        for trk, dlist in matched_dist.items():
                            avg = sum(dlist) / len(matched_cnt[trk])
                            self._total_DE[cls] += avg
                            self._DE_TP[cls] += 1
                            if avg <= self._spatial_T:
                                self._TP[cls] += 1
                            else:
                                loc_FP += 1
                                self._FP_spatial[cls] += 1
                        if nb_pred > nb_gt:
                            loc_FP += nb_pred - nb_gt
                            self._FP[cls] += nb_pred - nb_gt
                            self._DE_FP[cls] += nb_pred - nb_gt
                        elif nb_pred < nb_gt:
                            loc_FN += nb_gt - nb_pred
                            self._FN[cls] += nb_gt - nb_pred
                            self._DE_FN[cls] += nb_gt - nb_pred
                elif gt_here:
                    loc_FN += nb_gt
                    self._FN[cls] += nb_gt
                    self._DE_FN[cls] += nb_gt
                elif pred_here:
                    loc_FP += nb_pred
                    self._FP[cls] += nb_pred
                    self._DE_FP[cls] += nb_pred
            self._S += np.minimum(loc_FP, loc_FN)
            self._D += np.maximum(0, loc_FN - loc_FP)
            self._I += np.maximum(0, loc_FP - loc_FN)
