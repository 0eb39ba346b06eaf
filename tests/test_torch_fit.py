"""The port's training loop (train/loop.py ``fit``, ``EarlyStopping``, the
prefetch pipeline) and its checkpoints (train/checkpoint.py) against the JAX
package's on the CPU.

Both ``fit``s run the tiny HTSAT of tests/test_torch_train.py (TINY_TASK,
float32, drop-path 0) from the same seeded random weights, bridged with
``jax_to_torch_state_dict``, on one in-memory datamodule (the same numpy
batches every epoch, two steps of B=2; four 4 s validation chunks of two
8 s files): the JAX side with ``fused_forward=false`` (flax), the port's
fused on the plain K1/K2/K3. Each epoch line agrees (train and validation
losses within 1e-5, the rate equal, macro and micro scores within 1e-4,
the ov counts equal), and every parameter lies within 2.01 lr a step taken
of the JAX one (AdamW's sign-flip band, test_torch_train.py). One epoch and
a resume to the second give the JAX resume's second line under the same
bounds, and the port's own straight run's line exactly; ``last.ckpt``
restores parameters, statistics, optimizer state, step, epoch and best score
bit for bit; the best ``.ckpt`` loads through the JAX
``load_seld_inference_ckpt`` and forwards within 5e-5 of the port."""

import copy
import json
import threading
from collections import OrderedDict
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pseldnets_tpu.config import compose as jax_compose
from pseldnets_tpu.parallel.mesh import replicate as jax_replicate
from pseldnets_tpu.train import loop as jax_loop
from pseldnets_tpu.train.checkpoint import load_seld_inference_ckpt as jax_load_ckpt
from pseldnets_tpu.train.module import SELDTask as JaxTask, TrainState as JaxState
from pseldnets_tpu_torch.config import compose
from pseldnets_tpu_torch.train import loop
from pseldnets_tpu_torch.train.checkpoint import (TRAINING_KEYS, jax_to_torch_state_dict,
                                                  load_jax_variables)
from pseldnets_tpu_torch.train.module import DatasetSpec, SELDTask
from test_torch_swin_block import randomize
from test_torch_train import TINY_TASK, _JaxSpec, _adpit_labels

ROOT = Path(__file__).resolve().parents[1]
STEPS, B, LR = 2, 2, 1e-4
TINY_FIT = TINY_TASK + ["data.test_chunklen_sec=4", "data.test_hoplen_sec=4",
                        "model.batch_size=2", "trainer.max_epochs=2", "logger=csv", "seed=5"]


class MemoryData:
    """What ``fit`` reads of a datamodule, from seeded numpy arrays: STEPS
    train batches of B 4 s clips (host arrays, as ``collate`` yields them,
    ADPIT labels and ov), the same batches in the same order every epoch,
    and two 8 s validation files in four 4 s chunks with DCASE ground truth
    of up to two events a frame."""

    def __init__(self, seed=41, n_val_files=2):
        rng = np.random.default_rng(seed)
        self.train = [{"data": (rng.standard_normal((B, 4, 64000)) * 0.1).astype(np.float32),
                       "adpit_label": _adpit_labels(rng, B, 40, 3),
                       "ov": [str(int(o)) for o in rng.integers(1, 4, B)]}
                      for _ in range(STEPS)]
        self.paths_dict = OrderedDict((f"fold1_room1_mix{i:03d}.wav", 80)
                                      for i in range(n_val_files))
        self.valid_gt_dcaseformat = OrderedDict(
            (p, {fr: [[int(rng.integers(0, 3)), int(rng.integers(-180, 180)),
                       int(rng.integers(-60, 60))] for _ in range(int(rng.integers(1, 3)))]
                 for fr in range(0, 80, 2)}) for p in self.paths_dict)
        n = 2 * n_val_files
        wav = (rng.standard_normal((n, 4, 64000)) * 0.1).astype(np.float32)
        lab = _adpit_labels(rng, n, 40, 3)
        self.val = [{"data": wav[i:i + 2], "adpit_label": lab[i:i + 2]} for i in range(0, n, 2)]

    def steps_per_epoch(self):
        return len(self.train)

    def train_dataloader(self, num_batches=None):
        n = len(self.train) if num_batches is None else num_batches
        return iter([self.train[i % len(self.train)] for i in range(n)])

    def val_dataloader(self):
        return iter(self.val)


def _with_epochs(cfg, max_epochs, **top):
    cfg = copy.deepcopy(cfg)
    cfg["trainer"]["max_epochs"] = max_epochs
    cfg.update(top)
    return cfg


def _lines(run_dir):
    return [json.loads(line) for line in (Path(run_dir) / "metrics.jsonl").read_text().splitlines()]


def _port_state(task):
    """Everything a resume must restore, cloned."""
    opt = task.state.optimizer.state_dict()
    return {"model": {k: v.clone() for k, v in task.model.state_dict().items()},
            "opt": {i: {k: v.clone() if torch.is_tensor(v) else v for k, v in st.items()}
                    for i, st in opt["state"].items()},
            "groups": [{k: v for k, v in g.items() if k != "lr_fn"} for g in opt["param_groups"]],
            "step": task.state.step, "epoch": task.state.epoch,
            "best": task.state.best_score}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The JAX and port runs from the same weights and data: straight
    for 2 epochs, 1 epoch, and a resume from that epoch's last checkpoint
    to epoch 2. One JAX task serves every JAX run (one compile)."""
    tmp = tmp_path_factory.mktemp("fit")
    dm = MemoryData()
    cfg_j = jax_compose(str(ROOT / "configs"), "train",
                        TINY_FIT + ["trainer.fused_forward=false", f"paths.log_dir={tmp}/jax"])
    task_j = JaxTask(cfg_j, _JaxSpec(), steps_per_epoch=STEPS, num_devices=1)
    init = task_j.init_state(jax.random.PRNGKey(0))
    params = randomize(jax.tree_util.tree_map(np.asarray, init.params), np.random.default_rng(42))
    stats = jax.tree_util.tree_map(np.asarray, init.batch_stats)

    def jax_state():  # the train step donates its state: a fresh one a run
        p = jax.tree_util.tree_map(jnp.asarray, params)
        return jax_replicate(task_j.mesh, JaxState(
            params=p, batch_stats=jax.tree_util.tree_map(jnp.asarray, stats),
            opt_state=task_j.tx.init(p), step=jnp.zeros((), jnp.int32)))

    out = {"dm": dm, "task_j": task_j, "params": params, "stats": stats, "tmp": tmp,
           "jax_state": jax_state}
    final = jax_loop.fit(task_j, dm, jax_state(), cfg_j, tmp / "jax_straight")
    out["jax_final"] = jax.tree_util.tree_map(np.asarray, {"params": final.params,
                                                           "batch_stats": final.batch_stats})
    jax_loop.fit(task_j, dm, jax_state(), _with_epochs(cfg_j, 1), tmp / "jax_one")
    # the JAX fit resumes only where the checkpoint directory holds an
    # opt_state entry (loop.py:394), which this orbax's single-store layout
    # (ocdbt) never writes: the marker takes the JAX run down its resume path
    last_j = tmp / "jax_one" / "checkpoints" / "last"
    (last_j / "opt_state").mkdir()
    jax_loop.fit(task_j, dm, jax_state(), _with_epochs(cfg_j, 2, ckpt_path=str(last_j)),
                 tmp / "jax_resumed")

    cfg = compose(str(ROOT / "configs"), "train",
                  TINY_FIT + ["trainer.fused_forward=true", f"paths.log_dir={tmp}/port"])
    task = SELDTask(cfg, DatasetSpec(num_classes=3), steps_per_epoch=STEPS, device="cpu")
    assert task.fused_forward

    def port_start(**kw):
        task.init_state(0, **kw)
        if not kw:
            load_jax_variables(task.model, {"params": params, "batch_stats": stats})

    port_start()
    out["timings"] = []
    loop.fit(task, dm, cfg, tmp / "port_straight", timings=out["timings"])
    out["port_final"] = {k: v.clone() for k, v in task.model.state_dict().items()}
    port_start()
    loop.fit(task, dm, _with_epochs(cfg, 1), tmp / "port_one")
    out["saved"] = _port_state(task)
    port_start(ckpt_path=str(tmp / "port_one" / "checkpoints" / "last.ckpt"))
    out["restored"] = _port_state(task)
    loop.fit(task, dm, _with_epochs(cfg, 2), tmp / "port_resumed")
    out["task"], out["cfg"], out["port_start"] = task, cfg, port_start
    return out


def _assert_lines_match(got, want):
    assert got["epoch"] == want["epoch"] and got["lr"] == want["lr"] == LR
    assert got["ov_stat"] == want["ov_stat"]
    assert set(got["train"]) == set(want["train"])
    for k, v in want["train"].items():
        assert abs(got["train"][k] - v) <= 1e-5, (k, got["train"][k], v)
    for avg in ("macro", "micro"):
        assert set(got["val"][avg]) == set(want["val"][avg])
        for k, v in want["val"][avg].items():
            assert abs(got["val"][avg][k] - v) <= 1e-4, (avg, k, got["val"][avg][k], v)
    for k, v in want["val"]["losses"].items():
        assert abs(got["val"]["losses"][k] - v) <= 1e-5, k


def test_fit_lines_and_weights_match_jax(runs):
    tmp = runs["tmp"]
    got, want = _lines(tmp / "port_straight"), _lines(tmp / "jax_straight")
    assert [line["epoch"] for line in got] == [line["epoch"] for line in want] == [1, 2]
    for g, w in zip(got, want):
        _assert_lines_match(g, w)
    # the scores see detections: the weights' outputs cross the threshold
    assert 0.0 < got[-1]["val"]["macro"]["F"] and np.isfinite(got[-1]["val"]["macro"]["SELD_scr"])
    assert sum(got[0]["ov_stat"].values()) == STEPS * B
    ref = jax_to_torch_state_dict(runs["jax_final"])
    bound = 2.01 * LR * 2 * STEPS
    for name, r in ref.items():
        assert float((runs["port_final"][name] - r).abs().max()) <= bound, name
    # the checkpoint layout: the best epoch and last, nothing else
    ckpts = sorted(p.name for p in (tmp / "port_straight" / "checkpoints").iterdir())
    best = min(got, key=lambda line: line["val"]["macro"]["SELD_scr"])["epoch"]
    assert ckpts == [f"epoch_{best:03d}.ckpt", "last.ckpt"]
    assert [t["epoch"] for t in runs["timings"]] == [1, 2]
    assert all(t["ckpt_bytes"] > 0 and t["val_s"] > 0 for t in runs["timings"])


# the trainer's other settings: a sanity pass of one batch, half the train steps
# (one) and one validation batch an epoch (the second file's span cut, so only the
# first is scored), early stopping at the first validation (any SELD score
# <= 10 meets the threshold) of three epochs, a profile of the first step
FIT_OPTIONS = ["trainer.num_sanity_val_steps=1", "trainer.limit_train_batches=0.5",
               "trainer.limit_val_batches=1", "trainer.max_epochs=3",
               "callbacks=early_stopping", "callbacks.early_stopping.monitor=val/macro/SELD_scr",
               "callbacks.early_stopping.stopping_threshold=10"]


def test_fit_options_match_jax(runs):
    tmp, dm = runs["tmp"], runs["dm"]
    over = TINY_FIT + FIT_OPTIONS
    cfg_j = jax_compose(str(ROOT / "configs"), "train", over + [f"paths.log_dir={tmp}/jo"])
    jax_loop.fit(runs["task_j"], dm, runs["jax_state"](), cfg_j, tmp / "jax_options")
    cfg = compose(str(ROOT / "configs"), "train",
                  over + [f"paths.log_dir={tmp}/po", "profile=1"])
    assert loop.make_early_stopping(cfg) is not None
    runs["port_start"]()
    state = loop.fit(runs["task"], dm, cfg, tmp / "port_options")
    got, want = _lines(tmp / "port_options"), _lines(tmp / "jax_options")
    assert [line["epoch"] for line in got] == [line["epoch"] for line in want] == [1]
    assert state.step == 1 and sum(got[0]["ov_stat"].values()) == B
    _assert_lines_match(got[0], want[0])
    assert (tmp / "port_options" / "profile" / "trace.json").stat().st_size > 0


def test_resume_matches_jax_resume(runs):
    tmp = runs["tmp"]
    got, want = _lines(tmp / "port_resumed"), _lines(tmp / "jax_resumed")
    assert [line["epoch"] for line in got] == [line["epoch"] for line in want] == [2]
    _assert_lines_match(got[0], want[0])
    straight = _lines(tmp / "port_straight")[1]
    for key in ("epoch", "lr", "train", "ov_stat", "val"):
        assert got[0][key] == straight[key], key


def test_last_ckpt_restores_the_state_bit_for_bit(runs):
    saved, restored = runs["saved"], runs["restored"]
    assert (restored["step"], restored["epoch"]) == (saved["step"], saved["epoch"]) == (STEPS, 1)
    assert restored["best"] == saved["best"] and np.isfinite(saved["best"])
    assert saved["model"].keys() == restored["model"].keys()
    for k, v in saved["model"].items():
        assert torch.equal(restored["model"][k], v), k
    assert saved["opt"].keys() == restored["opt"].keys() and saved["opt"]
    for i, st in saved["opt"].items():
        for k, v in st.items():
            assert torch.equal(restored["opt"][i][k], v) if torch.is_tensor(v) \
                else restored["opt"][i][k] == v, (i, k)
    assert restored["groups"] == saved["groups"]
    task = runs["task"]
    assert all(callable(g["lr_fn"]) for g in task.state.optimizer.param_groups)
    last = torch.load(str(runs["tmp"] / "port_one" / "checkpoints" / "last.ckpt"),
                      weights_only=False)
    assert set(TRAINING_KEYS) <= set(last)
    assert "net.scalar.0.running_var" in last["state_dict"]
    assert "net.scalar.running_var" not in last["state_dict"]


def test_best_ckpt_loads_in_both_packages(runs):
    """The best file loads as weights (no optimizer state in it) through
    the port's init_state and through the JAX loader; the two forwards of
    the same clips agree within 5e-5."""
    tmp = runs["tmp"]
    best = next((tmp / "port_straight" / "checkpoints").glob("epoch_*.ckpt"))
    ckpt = torch.load(str(best), weights_only=False)
    assert "optimizer_states" not in ckpt and "best_score" not in ckpt
    task = SELDTask(runs["cfg"], DatasetSpec(num_classes=3), device="cpu")
    state = task.init_state(0, ckpt_path=str(best))
    assert (state.step, state.epoch) == (0, 0)
    task_j = runs["task_j"]
    variables, _ = jax_load_ckpt({"params": runs["params"], "batch_stats": runs["stats"]},
                                 str(best))
    wav = runs["dm"].val[0]["data"]
    want = task_j.model.apply(variables, task_j.extractor(jnp.asarray(wav)), train=False)
    got = task.eval_step({"data": wav})
    for k, v in want.items():
        assert float(np.abs(got[k].numpy() - np.asarray(v)).max()) <= 5e-5, k


@pytest.mark.parametrize("case", ["patience", "min_delta", "thresholds", "missing_monitor"])
def test_early_stopping_matches_jax(case):
    """The four cases of tests/test_early_stopping.py through both classes:
    the same decisions and reasons, value by value."""
    scripts = {
        "patience": (dict(monitor="m", mode="min", patience=2), [0.5, 0.4, 0.4, 0.45]),
        "min_delta": (dict(monitor="m", mode="min", patience=2, min_delta=0.1),
                      [1.0, 0.95, 0.5, 0.5, 0.5]),
        "thresholds": (dict(monitor="m", mode="max", patience=5, stopping_threshold=0.9,
                            divergence_threshold=0.1), [0.5, 0.95, 0.05, float("nan")]),
        "missing_monitor": (dict(monitor="m", mode="max", patience=1), [None, 0.3, None, 0.2]),
    }
    kw, values = scripts[case]
    ours, theirs = loop.EarlyStopping(**kw), jax_loop.EarlyStopping(**kw)
    decisions = []
    for v in values:
        metrics = {"other": 1.0} if v is None else {"m": v}
        got, want = ours.should_stop(metrics), theirs.should_stop(metrics)
        assert got == want and ours.wait_count == theirs.wait_count, (case, v)
        decisions.append(got)
    assert any(decisions), case


def test_early_stopping_arming_matches_jax():
    for over in ([], ["callbacks=early_stopping",
                      "callbacks.early_stopping.monitor=val/macro/SELD_scr"]):
        over = over + ["model.kwargs.pretrained_path=null"]
        ours = loop.make_early_stopping(compose(str(ROOT / "configs"), "train", over))
        theirs = jax_loop.make_early_stopping(jax_compose(str(ROOT / "configs"), "train", over))
        assert (ours is None) == (theirs is None)
        if ours is not None:
            assert vars(ours) == vars(theirs)


def _within(seconds, fn):
    """fn() on a thread of its own; fails if it has not returned within
    ``seconds`` (the test's own timeout) and re-raises what it raised."""
    box = {}

    def run():
        try:
            box["out"] = fn()
        except BaseException as e:  # re-raised below
            box["err"] = e

    t = threading.Thread(target=run, daemon=True)
    t.start()
    t.join(seconds)
    assert not t.is_alive(), f"did not return within {seconds} s"
    if "err" in box:
        raise box["err"]
    return box.get("out")


class _Tagger:
    """prepare_batch that tags each batch with its loader index."""

    def prepare_batch(self, batch):
        return batch["i"]


def test_pipeline_keeps_loader_order():
    got = _within(10, lambda: list(loop._PreparedBatchPipeline(
        _Tagger(), iter([{"i": i} for i in range(7)]))))
    assert got == list(range(7))


def test_pipeline_raises_a_worker_exception_in_the_consumer():
    def loader():
        yield {"i": 0}
        yield {"i": 1}
        raise ValueError("loader broke")

    def consume():
        got = []
        with pytest.raises(ValueError, match="loader broke"):
            for item in loop._PreparedBatchPipeline(_Tagger(), loader()):
                got.append(item)
        return got

    assert _within(10, consume) == [0, 1]


def test_pipeline_close_returns_mid_stream():
    """close() after one item of an endless loader returns at once, the
    worker stops (its queue full, it was blocked in put), and the loader is
    closed."""
    class Endless:
        closed = False

        def __iter__(self):
            i = 0
            while True:
                yield {"i": i}
                i += 1

        def close(self):
            Endless.closed = True

    def run():
        p = loop._PreparedBatchPipeline(_Tagger(), Endless())
        assert next(p) == 0
        p.close()
        p.thread.join(5)
        return p.thread.is_alive()

    assert _within(10, run) is False
    assert Endless.closed


def _normalized_files(root):
    """{path under ``root`` with run ids (32 hex digits) and TensorBoard
    event-file suffixes (host, time) masked: the file}."""
    import re

    return {re.sub(r"tfevents\..*", "tfevents.<id>",
                   re.sub(r"[0-9a-f]{32}", "<run>", str(p.relative_to(root)))): p
            for p in root.rglob("*") if p.is_file()}


@pytest.mark.parametrize("logger", ["csv", "tensorboard", "wandb", "mlflow", "neptune", "comet",
                                    "aim", "many_loggers"])
def test_loggers_write_what_the_jax_loggers_write(tmp_path, logger, monkeypatch):
    """Each configs/logger/ backend through both packages'
    instantiate_loggers, the same metrics at two steps: the same files
    (the JSONL fallbacks and streams and the CSV byte for byte, mlflow's
    metric lines but their timestamps)."""
    from pseldnets_tpu.utils import utilities as jax_util
    from pseldnets_tpu_torch.utils import utilities as util

    monkeypatch.chdir(tmp_path)
    flat = [util.flatten_metrics({"epoch": e, "train": {"loss_all": 1.0 / e},
                                  "val": {"macro": {"SELD_scr": 0.5 / e}}}) for e in (1, 2)]
    assert flat == [jax_util.flatten_metrics({"epoch": e, "train": {"loss_all": 1.0 / e},
                                              "val": {"macro": {"SELD_scr": 0.5 / e}}})
                    for e in (1, 2)]
    roots = {}
    for side, mod, comp in (("jax", jax_util, jax_compose), ("port", util, compose)):
        roots[side] = tmp_path / side
        cfg = comp(str(ROOT / "configs"), "train",
                   [f"logger={logger}", f"paths.log_dir={roots[side]}",
                    f"paths.output_dir={roots[side]}/run", "model.kwargs.pretrained_path=null"])
        loggers = mod.instantiate_loggers(cfg["logger"], Path(cfg["paths"]["output_dir"]))
        for step, m in enumerate(flat, start=1):
            for lg in loggers:
                lg.log_metrics(m, step)
        for lg in loggers:
            lg.close()
    got, want = _normalized_files(roots["port"]), _normalized_files(roots["jax"])
    assert sorted(got) == sorted(want) and got
    for name, path in got.items():
        if path.suffix in (".jsonl", ".csv"):
            assert path.read_text() == want[name].read_text(), name
        elif "/metrics/" in name:  # mlflow: "<ms> <value> <step>" lines
            lines = [[line.split()[1:] for line in p.read_text().splitlines()]
                     for p in (path, want[name])]
            assert lines[0] == lines[1] and len(lines[0]) == 2, name


def test_count_params_matches_jax(runs):
    from pseldnets_tpu.utils.utilities import count_params as jax_count
    from pseldnets_tpu_torch.utils.utilities import count_params

    assert count_params(runs["task"].model.parameters()) == jax_count(runs["params"]) > 0
