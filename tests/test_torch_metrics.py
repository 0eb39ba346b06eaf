"""The port's SELD metrics, DCASE format tools and output aggregation against
the JAX package's on the same arrays: SELDMetrics macro and micro, the
DCASE conversions and decoders, Aggregator.aggregate for accdoa, einv2 and
multi_accdoa, move_avg, to_dcase_polar and MeanMeter. Both sides are numpy
on the host, so they agree exactly, or to 1e-12 where a float sum order
differs."""

from collections import OrderedDict

import numpy as np
import pytest
import torch

from pseldnets_tpu import metrics as jm
from pseldnets_tpu.train import loop as jloop
from pseldnets_tpu_torch import metrics as tm
from pseldnets_tpu_torch.train import loop as tloop
import torch_threads  # noqa: F401  (each xdist worker's share of the cores)

K = 5


def _stream(rng, frames=120, K=K, max_ev=3):
    """frame -> [[class, azi, ele], ...] with up to ``max_ev`` events a frame."""
    out = {}
    for fr in range(0, frames, 2):
        out[fr] = [[int(rng.integers(0, K)), int(rng.integers(-180, 181)),
                    int(rng.integers(-60, 61))] for _ in range(int(rng.integers(1, max_ev + 1)))]
    return out


def _cfg(post=None, chunk=4, hop=4, thr=0.5):
    return {"data": {"test_chunklen_sec": chunk, "test_hoplen_sec": hop},
            "sed_threshold": thr, "post_processing": post}


def _seld(mod, pairs, average):
    ev = mod.SELDMetrics(nb_classes=K, doa_threshold=20)
    for pred, gt, n in pairs:
        ev.update_seld_scores(mod.to_metrics_format(pred, n), mod.to_metrics_format(gt, n))
    return ev.compute_seld_scores(average)


@pytest.mark.parametrize("average", ["macro", "micro"])
@pytest.mark.parametrize("cartesian", [False, True])
def test_seld_metrics_match_jax(rng, average, cartesian):
    pairs = []
    for _ in range(3):
        gt = _stream(rng)
        pred = {fr: [[r[0], r[1] + int(rng.integers(-40, 40)), r[2]] for r in rows]
                for fr, rows in gt.items() if rng.random() < 0.8}
        pred.update({fr: [[int(rng.integers(0, K)), 0, 0]] for fr in range(1, 120, 7)})
        if cartesian:
            gt = tm.convert_output_format_polar_to_cartesian(gt)
            pred = tm.convert_output_format_polar_to_cartesian(pred)
        pairs.append((pred, gt, 120))
    got, cw = _seld(tm, pairs, average)
    want, cw_j = _seld(jm, pairs, average)
    assert got == want
    np.testing.assert_array_equal(np.asarray(cw), np.asarray(cw_j))
    assert np.isfinite(got["SELD_scr"])


def test_early_stopping_metric_matches_jax(rng):
    er, f, le, lr = rng.random((4, 6))
    np.testing.assert_array_equal(tm.early_stopping_metric(er, f, le * 180, lr),
                                  jm.early_stopping_metric(er, f, le * 180, lr))


@pytest.mark.parametrize("x_len,chunk,hop,pad_last", [
    (100, 40, 40, False), (100, 40, 20, True), (95, 40, 20, False), (30, 40, 40, True),
    (230, 100, 50, False)])
def test_segment_index_matches_jax(x_len, chunk, hop, pad_last):
    assert tm.segment_index(x_len, chunk, hop, pad_last) == \
        jm.segment_index(x_len, chunk, hop, pad_last)


@pytest.mark.parametrize("cols", [4, 5])
def test_output_format_files_round_trip_like_jax(tmp_path, rng, cols):
    stream = _stream(rng, frames=40)
    path = tmp_path / "s.csv"
    with open(path, "w") as f:
        for fr, rows in stream.items():
            for t, r in enumerate(rows):
                mid = [t] if cols == 5 else []
                f.write(",".join(map(str, [fr, r[0]] + mid + [r[1], r[2]])) + "\n")
    got, want = tm.load_output_format_file(path), jm.load_output_format_file(path)
    assert got == want
    tm.write_output_format_file(tmp_path / "a.csv", got)
    jm.write_output_format_file(tmp_path / "b.csv", want)
    assert (tmp_path / "a.csv").read_text() == (tmp_path / "b.csv").read_text()


def test_conversions_and_decoders_match_jax(rng):
    polar = _stream(rng, frames=30)
    cart = tm.convert_output_format_polar_to_cartesian(polar)
    assert cart == jm.convert_output_format_polar_to_cartesian(polar)
    assert tm.convert_output_format_cartesian_to_polar(cart) == \
        jm.convert_output_format_cartesian_to_polar(cart)
    assert tm.to_metrics_format(polar, 30) == jm.to_metrics_format(polar, 30)
    a, b = rng.standard_normal((2, 3, 7))
    np.testing.assert_array_equal(tm.distance_between_cartesian_coordinates(*a, *b),
                                  jm.distance_between_cartesian_coordinates(*a, *b))

    acc = rng.standard_normal((2, 10, 3 * K)).astype(np.float32) * 0.6
    thr = np.linspace(0.3, 0.7, K).astype(np.float32)  # a per-class threshold
    for t in (0.5, thr):
        for x, y in zip(tm.get_accdoa_labels(acc, K, t), jm.get_accdoa_labels(acc, K, t)):
            np.testing.assert_array_equal(x, y)
    sed, doa = tm.get_accdoa_labels(acc.reshape(-1, 3 * K), K, 0.5)
    assert tm.accdoa_label_to_dcase_format(sed, doa, K) == \
        jm.accdoa_label_to_dcase_format(sed, doa, K)

    macc = rng.standard_normal((2, 10, 9 * K)).astype(np.float32) * 0.6
    got, want = tm.get_multi_accdoa_labels(macc, K, 0.5), jm.get_multi_accdoa_labels(macc, K, 0.5)
    for x, y in zip(got, want):
        np.testing.assert_array_equal(x, y)
    sed, doa = got[0][:, 0], got[1][:, 0]
    assert tm.multi_accdoa_to_dcase_format(sed, doa, nb_classes=K) == \
        jm.multi_accdoa_to_dcase_format(sed, doa, nb_classes=K)

    tsed = rng.random((10, 3, K)) < 0.2
    tdoa = rng.uniform(-3, 3, (10, 3, 2))
    assert tm.track_to_dcase_format(tsed, tdoa) == jm.track_to_dcase_format(tsed, tdoa)


def test_multi_accdoa_unification_matches_jax():
    """Same-class tracks within 15 degrees merge: pairs and triples, with
    one, two or three of the three pairs close."""
    d = np.zeros((3, 4, 3 * K), np.float32)
    sed = np.zeros((3, 4, K), bool)
    dirs = {0: ([1, 0, 0], [0.99, 0.05, 0], [0, 1, 0]), 1: ([1, 0, 0], [0, 1, 0], [0, 0, 1]),
            2: ([1, 0, 0], [0.99, 0.1, 0], [0.98, 0.15, 0]), 3: ([0, 1, 0], [1, 0, 0], [0.99, 0.1, 0])}
    for frame, vecs in dirs.items():
        for track, v in enumerate(vecs):
            sed[track, frame, 2] = True
            d[track, frame, [2, 2 + K, 2 + 2 * K]] = v
    assert tm.multi_accdoa_to_dcase_format(sed, d, nb_classes=K) == \
        jm.multi_accdoa_to_dcase_format(sed, d, nb_classes=K)


def _outputs(rng, method, n_batches=3, B=2, T=40):
    outs = []
    for _ in range(n_batches):
        if method == "accdoa":
            outs.append({"accdoa": rng.uniform(-1, 1, (B, T, 3 * K)).astype(np.float32)})
        elif method == "multi_accdoa":
            outs.append({"multi_accdoa": rng.uniform(-1, 1, (B, T, 9 * K)).astype(np.float32)})
        else:
            outs.append({"sed": rng.standard_normal((B, T, 3, K)).astype(np.float32),
                         "doa": rng.uniform(-1, 1, (B, T, 3, 3)).astype(np.float32)})
    return outs


@pytest.mark.parametrize("method", ["accdoa", "einv2", "multi_accdoa"])
def test_aggregator_matches_jax(rng, method):
    """aggregate then to_dcase_polar over each file's frames; the port's
    append takes device tensors."""
    outs = _outputs(rng, method)
    paths = OrderedDict([("a.wav", 83), ("b.wav", 40), ("c.wav", 1)])
    a_t, a_j = (tloop.Aggregator(_cfg(), method, K), jloop.Aggregator(_cfg(), method, K))
    for o in outs:
        a_t.append({k: torch.from_numpy(v) for k, v in o.items()})
        a_j.append(o)
    got, want = a_t.aggregate(paths), a_j.aggregate(paths)
    for x, y in zip(got, want):
        np.testing.assert_array_equal(x, y)
    fi = 0
    for _, n in paths.items():
        sl = slice(fi, fi + n)
        assert a_t.to_dcase_polar(got[0][sl], got[1][sl]) == \
            a_j.to_dcase_polar(want[0][sl], want[1][sl])
        fi += a_t.get_num_frames(n)
    assert fi == a_j.get_num_frames(83) + 40 + 40


@pytest.mark.parametrize("chunk,hop", [(4, 2), (4, 1), (4, 4)])
def test_move_avg_matches_jax(rng, chunk, hop):
    """Overlapped chunks of three files (lengths in label frames) stitched
    by the moving average; aggregate applies it under post_processing."""
    paths = OrderedDict([("a", 95), ("b", 40), ("c", 61)])
    n_chunks = sum(int(np.ceil((n - chunk * 10) / (hop * 10))) + 1 for n in paths.values())
    preds = rng.uniform(-1, 1, (n_chunks, chunk * 10, 9 * K)).astype(np.float32)
    a_t = tloop.Aggregator(_cfg("move_avg", chunk, hop), "multi_accdoa", K)
    a_j = jloop.Aggregator(_cfg("move_avg", chunk, hop), "multi_accdoa", K)
    got, want = a_t.move_avg(preds, paths), a_j.move_avg(preds, paths)
    np.testing.assert_array_equal(got, want)
    a_t.append({"multi_accdoa": torch.from_numpy(preds)})
    a_j.append({"multi_accdoa": preds})
    for x, y in zip(a_t.aggregate(paths), a_j.aggregate(paths)):
        np.testing.assert_array_equal(x, y)


def test_mean_meter_matches_jax(rng):
    vals = rng.standard_normal(7).astype(np.float32)
    mt, mj = tloop.MeanMeter(), jloop.MeanMeter()
    for v in vals:
        mt.update(torch.tensor(v))
        mj.update(v)
    mt.update(0.25)  # a loss term that is a Python number
    mj.update(0.25)
    assert abs(mt.compute() - mj.compute()) <= 1e-12
    assert tloop.MeanMeter().compute() == jloop.MeanMeter().compute() == 0.0
