"""DCASE output-format utilities and head decoders (host-side numpy).

Parity targets: reference src/utils/data_utilities.py —
segment_index (:6-64), csv load/write (:67-104), to_metrics_format (:107-152),
track decode (:154-177), polar/cartesian converts (:180-210), ACCDOA decode
with top-max_ov gating (:234-244), multi-ACCDOA decode with 15° same-class
track unification (:273-398).

A copy of the JAX package's metrics/dcase.py.
"""

from typing import Dict, List, Tuple

import numpy as np


# ---------------------------------------------------------------------------
# segmentation (offline indexer + move_avg chunking share this)
# ---------------------------------------------------------------------------
def segment_index(x_len: int, chunklen: int, hoplen: int,
                  last_frame_always_padding: bool = False
                  ) -> Tuple[List[Tuple[int, int]], List[Tuple[int, int]]]:
    """Slice [0, x_len) into chunklen windows with hoplen stride.
    Returns ([(begin, end)], [(pad_before, pad_after)]).
    Train mode keeps/drops the tail by the half-chunk rule; test mode
    (last_frame_always_padding) always pads the tail."""
    if x_len < chunklen:
        return [(0, x_len)], [(0, chunklen - x_len)]
    n = 1 + (x_len - chunklen) // hoplen
    idx = [(i * hoplen, i * hoplen + chunklen) for i in range(n)]
    pad = [(0, 0)] * n
    if (n - 1) * hoplen + chunklen == x_len:
        return idx, pad
    if last_frame_always_padding:
        idx.append((n * hoplen, x_len))
        pad.append((0, chunklen - (x_len - n * hoplen)))
    elif x_len - n * hoplen >= chunklen // 2:
        idx.append((n * hoplen, x_len))
        pad.append((0, chunklen - (x_len - n * hoplen)))
    else:
        idx.append((x_len - chunklen, x_len))
        pad.append((0, 0))
    return idx, pad


# ---------------------------------------------------------------------------
# DCASE csv format
# ---------------------------------------------------------------------------
def load_output_format_file(path) -> Dict[int, List[List[float]]]:
    """frame -> [[class, azi, ele], ...]; tolerates 4/5/6/7-column variants."""
    out: Dict[int, List[List[float]]] = {}
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            item = line.split(",")
            frame = int(float(item[0]))
            row = out.setdefault(frame, [])
            if len(item) == 4:
                row.append([int(float(item[1])), float(item[2]), float(item[3])])
            else:  # 5/6/7 columns carry a track id at position 2
                row.append([int(float(item[1])), float(item[3]), float(item[4])])
    return out


def write_output_format_file(path, output_dict: Dict[int, List[List[float]]]):
    """[frame, class, azi, ele] with int-rounded angles (reference :91-104)."""
    with open(path, "w") as f:
        for frame in output_dict.keys():
            for v in output_dict[frame]:
                f.write(f"{int(frame)},{int(v[0])},{int(v[1])},{int(v[2])}\n")


def to_metrics_format(label_dict: Dict, num_frames: int,
                      label_resolution: float = 0.1) -> Dict:
    """Regroup frame-wise events into 1 s segments for SELDMetrics
    (reference :107-152). Structure per block/class: [[frames], [doa-lists]]."""
    frames_1s = int(1 / label_resolution)
    num_blocks = int(np.ceil(num_frames / float(frames_1s)))
    out: Dict[int, Dict] = {b: {} for b in range(num_blocks)}
    for start in range(0, num_frames, frames_1s):
        block = start // frames_1s
        loc: Dict[int, Dict[int, list]] = {}
        for frame in range(start, start + frames_1s):
            if frame not in label_dict:
                continue
            for value in label_dict[frame]:
                loc.setdefault(value[0], {}).setdefault(frame - start, []).append(value[1:])
        for cls, frames in loc.items():
            out[block].setdefault(cls, [])
            out[block][cls].append([list(frames.keys()), list(frames.values())])
    return out


# ---------------------------------------------------------------------------
# coordinate converts
# ---------------------------------------------------------------------------
def convert_output_format_polar_to_cartesian(in_dict: Dict) -> Dict:
    out = {}
    for frame, rows in in_dict.items():
        out[frame] = []
        for v in rows:
            azi, ele = v[1] * np.pi / 180.0, v[2] * np.pi / 180.0
            c = np.cos(ele)
            out[frame].append([v[0], np.cos(azi) * c, np.sin(azi) * c, np.sin(ele)])
    return out


def convert_output_format_cartesian_to_polar(in_dict: Dict) -> Dict:
    out = {}
    for frame, rows in in_dict.items():
        out[frame] = []
        for v in rows:
            x, y, z = v[1], v[2], v[3]
            azi = np.arctan2(y, x) * 180.0 / np.pi
            ele = np.arctan2(z, np.sqrt(x * x + y * y)) * 180.0 / np.pi
            out[frame].append([v[0], azi, ele])
    return out


def distance_between_cartesian_coordinates(x1, y1, z1, x2, y2, z2):
    n1 = np.sqrt(x1 * x1 + y1 * y1 + z1 * z1 + 1e-10)
    n2 = np.sqrt(x2 * x2 + y2 * y2 + z2 * z2 + 1e-10)
    dist = np.clip((x1 * x2 + y1 * y2 + z1 * z2) / (n1 * n2), -1.0, 1.0)
    return np.arccos(dist) * 180.0 / np.pi


# ---------------------------------------------------------------------------
# decoders
# ---------------------------------------------------------------------------
def track_to_dcase_format(sed_labels: np.ndarray, doa_labels: np.ndarray) -> Dict:
    """(T, tracks, K) bool/binary SED + (T, tracks, 2) radians -> dcase dict."""
    out: Dict[int, list] = {}
    for frame, track, cls in zip(*np.where(sed_labels)):
        out.setdefault(int(frame), []).append([
            int(cls),
            int(np.around(doa_labels[frame, track, 0] * 180 / np.pi)),
            int(np.around(doa_labels[frame, track, 1] * 180 / np.pi))])
    return out


def get_accdoa_labels(accdoa_in: np.ndarray, nb_classes: int,
                      sed_threshold=0.5, max_ov: int = 3):
    """(..., T, 3K) vectors -> (sed bool mask gated to top-max_ov, doa).
    Per-class threshold supported via a length-K array (reference infer.yaml)."""
    x = accdoa_in[..., :nb_classes]
    y = accdoa_in[..., nb_classes:2 * nb_classes]
    z = accdoa_in[..., 2 * nb_classes:]
    sed = np.sqrt(x * x + y * y + z * z)
    # keep only the top max_ov activations per frame, then threshold
    kth = np.argsort(sed, axis=-1)
    mask = np.zeros_like(sed, bool)
    np.put_along_axis(mask, kth[..., -max_ov:], True, axis=-1)
    thr = np.asarray(sed_threshold)
    return (sed > thr) & mask, accdoa_in


def accdoa_label_to_dcase_format(sed_labels: np.ndarray, doa_labels: np.ndarray,
                                 nb_classes: int = 13) -> Dict:
    out: Dict[int, list] = {}
    for frame, cls in zip(*np.where(sed_labels == 1)):
        out.setdefault(int(frame), []).append([
            int(cls),
            doa_labels[frame, cls],
            doa_labels[frame, cls + nb_classes],
            doa_labels[frame, cls + 2 * nb_classes]])
    return out


def get_multi_accdoa_labels(accdoa_in: np.ndarray, nb_classes: int = 13,
                            sed_threshold=0.5):
    """(B, T, 9K) -> sed (3, B, T, K) bool, doa (3, B, T, 3K)."""
    thr = np.asarray(sed_threshold)
    seds, doas = [], []
    for t in range(3):
        sl = accdoa_in[..., 3 * nb_classes * t: 3 * nb_classes * (t + 1)]
        x, y, z = (sl[..., :nb_classes], sl[..., nb_classes:2 * nb_classes],
                   sl[..., 2 * nb_classes:])
        seds.append(np.sqrt(x * x + y * y + z * z) > thr)
        doas.append(sl)
    return np.stack(seds, axis=0), np.stack(doas, axis=0)


def _similar(a, b, thresh):
    return distance_between_cartesian_coordinates(a[0], a[1], a[2],
                                                  b[0], b[1], b[2]) < thresh


def _avg(events):
    first = events[0]
    return [first[0]] + [sum(e[i] for e in events) / len(events) for i in (1, 2, 3)]


def multi_accdoa_to_dcase_format(sed_pred: np.ndarray, doa_pred: np.ndarray,
                                 threshold_unify: float = 15,
                                 nb_classes: int = 13) -> Dict:
    """Track-wise detections merged when same-class tracks point within
    threshold_unify degrees (reference :302-398)."""
    temp: Dict[int, list] = {}
    for track, frame, cls in zip(*np.where(sed_pred == 1.0)):
        temp.setdefault(int(frame), []).append([
            int(cls),
            doa_pred[track, frame, cls],
            doa_pred[track, frame, cls + nb_classes],
            doa_pred[track, frame, cls + 2 * nb_classes]])

    out: Dict[int, list] = {}
    for frame, events in temp.items():
        events.sort(key=lambda e: e[0])
        out[frame] = []
        group: list = []
        for i, ev in enumerate(events):
            group.append(ev)
            if i != len(events) - 1 and ev[0] == events[i + 1][0]:
                continue
            if len(group) == 1:
                out[frame].append(group[0])
            elif len(group) == 2:
                if _similar(group[0][1:], group[1][1:], threshold_unify):
                    out[frame].append(_avg(group))
                else:
                    out[frame].extend(group)
            else:
                f01 = _similar(group[0][1:], group[1][1:], threshold_unify)
                f12 = _similar(group[1][1:], group[2][1:], threshold_unify)
                f02 = _similar(group[0][1:], group[2][1:], threshold_unify)
                total = f01 + f12 + f02
                if total == 0:
                    out[frame].extend(group)
                elif total == 1:
                    if f01:
                        out[frame].append(_avg(group[:2]))
                        out[frame].append(group[2])
                    elif f12:
                        out[frame].append(group[0])
                        out[frame].append(_avg(group[1:]))
                    else:
                        out[frame].append(group[0])
                        out[frame].append(_avg([group[0], group[2]]))
                else:
                    out[frame].append(_avg(group))
            group = []
    return out
