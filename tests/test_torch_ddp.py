"""Data-parallel training in the port (parallel/mesh.py, the DDP parts of
train/module.py, train/loop.py, cli/train.py and entry.py) on the CPU: two
gloo processes started by the train CLI's launcher (``cli.train.spawn``),
each on its rows (``rank::2``) of one global batch, held against one
process on that global batch, and against the JAX ``SELDTask`` over a
2-device mesh.

Bounds: the BatchNorm outputs, running statistics and grads within 1e-5 of
scale (float32 summation order: the ranks' sums are added by the
all-reduce); every per-clip draw equal to the one-process draw's rows; a
step's float32 loss within 1e-6 relative (1e-5 for a second step, whose
parameters already differ within the sign-flip band), every reduced grad within 1e-5
of its scale, the ranks' parameters and statistics bit-identical and within
AdamW's sign-flip band of the one-process ones (2.01 lr a step,
test_torch_train.py ``test_seld_task_step_matches_jax``; all but 0.5% of
the elements within 1e-6). The ranks run the functions of
tests/torch_ddp_workers.py, which import nothing of JAX."""

import copy
import json
from collections import OrderedDict
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pseldnets_tpu.config import compose as jax_compose
from pseldnets_tpu.train.module import SELDTask as JaxTask
from pseldnets_tpu_torch.cli import train as port_train
from pseldnets_tpu_torch.config import compose
from pseldnets_tpu_torch.entry import dryrun_multichip
from pseldnets_tpu_torch.models.common import DropoutDraws, drop_path_masks
from pseldnets_tpu_torch.parallel import is_up, world
from pseldnets_tpu_torch.train import loop
from pseldnets_tpu_torch.train.checkpoint import jax_to_torch_state_dict
from pseldnets_tpu_torch.train.module import DatasetSpec, SELDTask
import torch_threads  # noqa: F401  (each xdist worker's share of the cores)
import torch_ddp_workers as workers
from test_torch_passt import recorded_jax_draws, take_block_mask
from test_torch_swin_block import randomize
from test_torch_train import TINY_CRNN, TINY_TASK, _JaxSpec, _adpit_labels
from test_torch_train_cli import _lines, _overrides, preprocessed  # noqa: F401  (fixture)

ROOT = Path(__file__).resolve().parents[1]
W, B = 2, 2  # ranks; clips a rank
TIMEOUT = 300  # seconds a spawned run may take


def _spawn(fn, args, out):
    """``fn(*args, out, device)`` on W gloo ranks -> each rank's record."""
    port_train.spawn(W, fn, (*args, str(out)), "cpu", timeout=TIMEOUT)
    return [torch.load(str(Path(out) / f"rank{r}.pt"), weights_only=False) for r in range(W)]


def _close(got, want, tol, what):
    scale = max(float(want.abs().max()), 1e-30)
    err = float((got - want).abs().max())
    assert err <= tol * scale, (what, err, scale)


# ------------------------------------------------------------ BatchNorm

N_BN = 3  # clips a rank in the BatchNorm cases and the draws


def _bn_cases(rng):
    shapes = {"scalar": (W * N_BN, 3, 6, 5), "2d": (W * N_BN, 4, 3, 5),
              "conformer": (W * N_BN, 7, 6)}
    cases = {}
    for kind, shape in shapes.items():
        state = {}
        feat = {"scalar": (3, 5), "2d": (4,), "conformer": (6,)}[kind]
        for k in ("weight", "bias", "running_mean"):
            state[k] = torch.from_numpy(rng.standard_normal(feat).astype(np.float32))
        state["running_var"] = torch.from_numpy(rng.uniform(0.5, 2.0, feat).astype(np.float32))
        x = torch.from_numpy((rng.standard_normal(shape) * 2 + 0.5).astype(np.float32))
        g = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
        cases[kind] = (kind, state, x, g)
    return cases


@pytest.fixture(scope="module")
def bn_and_draws(tmp_path_factory):
    cases = _bn_cases(np.random.default_rng(3))
    return cases, _spawn(workers.bn_and_draws_rank, (cases,), tmp_path_factory.mktemp("bn"))


@pytest.mark.parametrize("kind", ["scalar", "2d", "conformer"])
def test_batchnorm_two_ranks_match_one_process(bn_and_draws, kind):
    """The training BatchNorm (ScalarBN, the CNN's BatchNorm2d, the
    conformer's) on two ranks against one process on the concatenated
    batch: outputs, running statistics and input grads row for row, and the
    weight and bias grads summed over the ranks (the loss is a sum over the
    clips)."""
    cases, got = bn_and_draws
    assert world() == 1
    y, rm, rv, dx, dw, db = workers.bn_step(*cases[kind])
    ranks = [g["bn"][kind] for g in got]
    for r, (ry, rrm, rrv, rdx, _, _) in enumerate(ranks):
        _close(ry, y[r::W], 1e-5, "output")
        _close(rdx, dx[r::W], 1e-5, "input grad")
        _close(rrm, rm, 1e-5, "running mean")
        _close(rrv, rv, 1e-5, "running var")
        assert torch.equal(rrm, ranks[0][1]) and torch.equal(rrv, ranks[0][2])
    _close(sum(r[4] for r in ranks), dw, 1e-5, "weight grad")
    _close(sum(r[5] for r in ranks), db, 1e-5, "bias grad")


def _batch_axis(key):
    return 1 if key.split(".")[0] in ("spec", "crop") else 0


def test_draws_are_the_ranks_rows_of_the_global_draw(bn_and_draws):
    """Every per-clip device draw (a windowed dropout site, drop-path, the
    TF augs', the device rotation's) on a rank equals its rows of one
    process's draw on the global batch from the same generator seed; a
    mask without a batch axis is the one process's on every rank."""
    _, got = bn_and_draws
    full = workers.draws_of(W * N_BN)
    for r, g in enumerate(got):
        d = g["draws"]
        assert d.keys() == full.keys()
        for k, v in full.items():
            if k == "weights":
                want = v
            elif k == "windows":
                want = v.reshape(W * N_BN, 3, *v.shape[1:])[r::W].reshape(-1, *v.shape[1:])
            else:
                idx = (slice(None),) * _batch_axis(k) + (slice(r, None, W),)
                want = v[idx]
            assert torch.equal(d[k], want), (r, k)


# ------------------------------------------------------------ SELDTask steps

def _accdoa_labels(rng, n, T, K):
    return np.tanh(rng.standard_normal((n, T, 3 * K))).astype(np.float32)


STEP_CASES = {
    # the fused HTSAT multi-ACCDOA, drop-path 0.1 from the generator
    "htsat": (TINY_TASK + ["model.kwargs.drop_path_rate=0.1", "trainer.fused_forward=true"],
              64000, lambda rng, n: {"adpit_label": _adpit_labels(rng, n, 40, 3)}),
    # the eager CRNN ACCDOA: BatchNorm2d trunk, conformer (its BatchNorm and
    # dropout 0.1)
    "crnn": (TINY_CRNN + ["model.decoder=conformer"], 48000,
             lambda rng, n: {"accdoa_label": _accdoa_labels(rng, n, 20, 3)}),
}


def _batches(case, seed):
    _, samples, labels = STEP_CASES[case]
    rng = np.random.default_rng(seed)
    return [{"data": (rng.standard_normal((W * B, 4, samples)) * 0.1).astype(np.float32),
             **labels(rng, W * B)} for _ in range(2)]


class _RecordedDraws(DropoutDraws):
    """Dropout draws from a generator, each mask kept with whether it has a
    batch axis, to replay them on a batch in another order."""

    def __init__(self, generator, batch):
        super().__init__(generator, batch=batch)
        self.drawn = []

    def keep(self, shape, rate, device, batched=True):
        m = super().keep(shape, rate, device, batched)
        self.drawn.append((m, batched))
        return m


def _one_process_steps(cfg, batches, seeds):
    """The record ``seld_steps_rank`` writes, from one process on the
    global batches, and ``spread``: how far each of its first grads moves,
    as a share of its scale, when the same process takes the first batch in
    another clip order (the draws following their clips), the float32
    summation-order noise of that grad."""
    task = SELDTask(cfg, DatasetSpec(num_classes=3), steps_per_epoch=2, device="cpu")
    task.init_state(0)

    def grads(batch, **draws):
        b = dict(batch)
        losses, g, _ = task.compute_grads(b.pop("data"), b, **draws)
        return float(losses["loss_all"].detach()), g

    first, perm = batches[0], [3, 2, 1, 0]
    shuffled = {k: v[perm] for k, v in first.items()}
    if task.fused_forward:  # the masks the generator gives the fused forward
        masks = drop_path_masks(torch.Generator().manual_seed(seeds[0]), W * B,
                                task.model.encoder.block_rates())
        loss, g = grads(first, dp_masks=masks)
        again = {"dp_masks": [m[perm] for m in masks]}
    else:
        drawn = _RecordedDraws(torch.Generator().manual_seed(seeds[0]), W * B)
        loss, g = grads(first, dropout_draws=drawn)
        again = {"dropout_draws": [m[perm] if batched else m for m, batched in drawn.drawn]}
    # the eager BatchNorms write their statistics in the forward: the second
    # pass leaves them as the first left them
    stats = {k: v.clone() for k, v in task.model.named_buffers()}
    _, g2 = grads(shuffled, **again)
    with torch.no_grad():
        for k, v in task.model.named_buffers():
            v.copy_(stats[k])
    largest = max(float(x.abs().max()) for x in g)
    scales = [max(float(x.abs().max()), 2.0 ** -14 * largest) for x in g]
    res = {"grad_loss": loss, "grads": g, "losses": [], "names": task.trained_names,
           "scales": scales,
           "spread": [float((a - b).abs().max()) / sc for a, b, sc in zip(g, g2, scales)]}
    for batch, seed in zip(batches, seeds[1:]):
        b = dict(batch)
        res["losses"].append(float(task.train_step(b.pop("data"), b,
                                                   torch.Generator().manual_seed(seed))
                                   ["loss_all"]))
    res["state"] = task.model.state_dict()
    res["lr"] = float(cfg["model"]["optimizer"]["kwargs"]["lr"])
    return res


def _assert_band(got, ref, lr, steps):
    """Every parameter and statistic within steps x 2.01 lr of ``ref`` (AdamW's
    sign-flip band a step), all but 0.5% of the elements within 1e-6."""
    n_far = n_all = 0
    assert got.keys() == ref.keys()
    for name, r in ref.items():
        d = (got[name].float() - r.float()).abs()
        assert float(d.max()) <= steps * 2.01 * lr, (name, float(d.max()))
        n_far += int((d > 1e-6).sum())
        n_all += d.numel()
    assert n_far <= 0.005 * n_all, (n_far, n_all)


def _assert_ranks_identical(got):
    for g in got[1:]:
        for k, v in got[0]["state"].items():
            assert torch.equal(v, g["state"][k]), k


@pytest.mark.parametrize("case", list(STEP_CASES))
def test_two_rank_steps_match_one_process(case, tmp_path):
    """compute_grads and two train_steps on two ranks (B=2 each) against
    one process on the global batches of 4, the same generator seeds: the
    losses (the ranks' mean), the reduced grads, the parameters and
    statistics after the two steps."""
    cfg = compose(str(ROOT / "configs"), "train", STEP_CASES[case][0])
    batches, seeds = _batches(case, 5), [7, 8, 9]
    got = _spawn(workers.seld_steps_rank, (cfg, 3, batches, seeds, None, None), tmp_path)
    ref = _one_process_steps(cfg, batches, seeds)
    grad_loss = np.mean([g["grad_loss"] for g in got])
    assert abs(grad_loss - ref["grad_loss"]) <= 1e-6 * abs(ref["grad_loss"])
    for i, want in enumerate(ref["losses"]):
        # the second step starts from parameters that already differ within
        # the sign-flip band (a grad at float32 noise moves its element by
        # lr either way): 1e-5 there, the JAX comparison's loss bound
        mean = np.mean([g["losses"][i] for g in got])
        assert abs(mean - want) <= (1e-6 if i == 0 else 1e-5) * abs(want), (i, mean, want)
    # each reduced grad within 1e-5 of its scale (floored at 2^-14 of the
    # largest grad: the key projections' bias grads are 0 up to rounding),
    # or within twice the one process's own spread under a clip order
    # change where float32 summation order alone moves it further (the
    # tiny CRNN's: its BatchNorms over a few clips amplify rounding)
    for name, a, b, want, scale, spread in zip(ref["names"], got[0]["grads"], got[1]["grads"],
                                               ref["grads"], ref["scales"], ref["spread"]):
        assert torch.equal(a, b), name
        err = float((a - want).abs().max()) / scale
        assert err <= max(1e-5, 2 * spread), (name, err, spread)
    _assert_ranks_identical(got)
    assert [g["step"] for g in got] == [2, 2]
    _assert_band(got[0]["state"], ref["state"], ref["lr"], 2)


def test_two_rank_step_matches_jax_two_device_step(rng, tmp_path):
    """One train_step on two ranks (fused forward on the plain K2/K3, B=2
    each) against the JAX SELDTask's step over a 2-device CPU mesh on the
    global batch of 4 (flax, GSPMD: global BatchNorm statistics, the
    gradients summed over the devices), from the same random weights,
    drop-path 0.1: the JAX step's DropPath draws recorded from an unjitted
    apply on its keys and injected, each rank its rows. The loss within
    1e-5, every parameter and statistic within 2.01 lr of the JAX one, all
    but 0.5% of the elements within 1e-6."""
    over = TINY_TASK + ["model.kwargs.drop_path_rate=0.1"]
    task_j = JaxTask(jax_compose(str(ROOT / "configs"), "train",
                                 over + ["trainer.fused_forward=false"]),
                     _JaxSpec(), steps_per_epoch=2, num_devices=W)
    assert task_j.mesh.size == W
    state = task_j.init_state(jax.random.PRNGKey(0))
    params = randomize(jax.tree_util.tree_map(np.asarray, state.params), rng)
    state = state.replace(params=jax.tree_util.tree_map(jnp.asarray, params))
    variables = {"params": params,
                 "batch_stats": jax.tree_util.tree_map(np.asarray, state.batch_stats)}
    wav = (rng.standard_normal((W * B, 4, 64000)) * 0.1).astype(np.float32)
    lab = _adpit_labels(rng, W * B, 40, 3)
    key = jax.random.PRNGKey(1)
    new_state, losses_j, _ = task_j.train_step(state, {"data": wav, "adpit_label": lab}, key)
    with recorded_jax_draws() as rec:
        task_j.model.apply(variables, jnp.zeros((W * B, 7, 201, 16)), train=True,
                           mutable=["batch_stats"],
                           rngs={"dropout": jax.random.fold_in(key, 1),
                                 "patchout": jax.random.fold_in(key, 2)})
    cfg = compose(str(ROOT / "configs"), "train", over + ["trainer.fused_forward=true"])
    rates = SELDTask(cfg, DatasetSpec(num_classes=3), device="cpu").model.encoder.block_rates()
    uniforms = iter([(name, v) for name, v in rec if name == "uniform"])
    masks = [take_block_mask(uniforms, r, W * B).numpy() for r in rates]
    assert any((m == 0).any() for m in masks)
    got = _spawn(workers.seld_steps_rank,
                 (cfg, 3, [{"data": wav, "adpit_label": lab}], [0, 0], variables, [masks]),
                 tmp_path)
    loss = np.mean([g["losses"][0] for g in got])
    assert abs(loss - float(losses_j["loss_all"])) < 1e-5, (loss, float(losses_j["loss_all"]))
    _assert_ranks_identical(got)
    ref = jax_to_torch_state_dict(jax.tree_util.tree_map(
        np.asarray, {"params": new_state.params, "batch_stats": new_state.batch_stats}))
    _assert_band(got[0]["state"], ref, float(cfg["model"]["optimizer"]["kwargs"]["lr"]), 1)


# ------------------------------------------------------------ fit

FIT = TINY_TASK + ["data.test_chunklen_sec=4", "data.test_hoplen_sec=4", "model.batch_size=2",
                   "trainer.max_epochs=2", "logger=csv", "seed=5", "trainer.fused_forward=true"]


def _fit_data(seed=41):
    """Two global train batches of W * B 4 s clips (ADPIT labels, ov) and
    two 8 s validation files in four chunks, as test_torch_fit.py's
    MemoryData."""
    rng = np.random.default_rng(seed)
    train = [{"data": (rng.standard_normal((W * B, 4, 64000)) * 0.1).astype(np.float32),
              "adpit_label": _adpit_labels(rng, W * B, 40, 3),
              "ov": [str(int(o)) for o in rng.integers(1, 4, W * B)]} for _ in range(2)]
    paths = OrderedDict((f"fold1_room1_mix{i:03d}.wav", 80) for i in range(2))
    gt = OrderedDict((p, {fr: [[int(rng.integers(0, 3)), int(rng.integers(-180, 180)),
                                int(rng.integers(-60, 60))] for _ in range(int(rng.integers(1, 3)))]
                          for fr in range(0, 80, 2)}) for p in paths)
    wav = (rng.standard_normal((4, 4, 64000)) * 0.1).astype(np.float32)
    lab = _adpit_labels(rng, 4, 40, 3)
    val = [{"data": wav[i:i + 2], "adpit_label": lab[i:i + 2]} for i in (0, 2)]
    return {"train": train, "val": val, "paths_dict": paths, "gt": gt}


@pytest.fixture(scope="module")
def fits(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("ddp_fit")
    cfg = compose(str(ROOT / "configs"), "train", FIT + [f"paths.log_dir={tmp}/logs"])
    data = _fit_data()
    got = _spawn(workers.fit_rank, (cfg, data), tmp)
    task = SELDTask(cfg, DatasetSpec(num_classes=3), steps_per_epoch=2, device="cpu")
    task.init_state(0)
    state = loop.fit(task, workers.RankMemoryData(**data), copy.deepcopy(cfg), tmp / "one_process")
    return tmp, got, state, {k: v.clone() for k, v in task.model.state_dict().items()}


def _jsonl(run_dir):
    path = Path(run_dir) / "metrics.jsonl"
    return [json.loads(line) for line in path.read_text().splitlines()]


def test_fit_writes_on_rank_zero_and_matches_one_process(fits):
    """Two epochs of fit on two ranks: rank 0 alone writes metrics.jsonl and
    the checkpoints (rank 1's write raises), its lines hold the ranks'
    mean train loss within 1e-6 relative of one process's on the global
    batches and validation within test_torch_fit.py's bounds (losses 1e-5,
    scores 1e-4), and the weights lie within the sign-flip band of four
    steps."""
    tmp, got, _, one_state = fits
    r0, r1 = tmp / "straight" / "rank0", tmp / "straight" / "rank1"
    assert not (r1 / "metrics.jsonl").exists() and not list((r1 / "checkpoints").iterdir())
    assert sorted(p.name for p in (r0 / "checkpoints").iterdir())[-1] == "last.ckpt"
    assert "only rank 0 writes" in got[1]["refused"] and "refused" not in got[0]
    lines, want = _jsonl(r0), _jsonl(tmp / "one_process")
    assert [line["epoch"] for line in lines] == [line["epoch"] for line in want] == [1, 2]
    for a, b in zip(lines, want):
        assert a["lr"] == b["lr"] and a["ov_stat"] == b["ov_stat"]
        for k, v in b["train"].items():
            assert abs(a["train"][k] - v) <= 1e-6 * abs(v), k
        for k, v in b["val"]["losses"].items():
            assert abs(a["val"]["losses"][k] - v) <= 1e-5, k
        for avg in ("macro", "micro"):
            for k, v in b["val"][avg].items():
                assert abs(a["val"][avg][k] - v) <= 1e-4, (avg, k)
    assert [g["straight"]["epoch"] for g in got] == [2, 2]
    assert all(g["straight"]["step"] == 4 for g in got)
    for k, v in got[0]["straight"]["state"].items():
        assert torch.equal(v, got[1]["straight"]["state"][k]), k
    _assert_band(got[0]["straight"]["state"], one_state, 1e-4, 4)


def test_fit_resumes_exactly_and_ranks_stop_together(fits):
    """One epoch, then a resume from rank 0's last.ckpt on both ranks to the
    second: its line is the straight run's second line and its weights the
    straight run's, bit for bit, on both ranks. With early stopping armed
    on rank 0 alone (stopping at the first validation), rank 1 stops at the
    same epoch (a rank that went on alone would wait in its next
    collective until the launcher's timeout)."""
    tmp, got, _, _ = fits
    straight = _jsonl(tmp / "straight" / "rank0")[1]
    resumed = _jsonl(tmp / "resumed" / "rank0")
    assert [line["epoch"] for line in resumed] == [2]
    for key in ("epoch", "lr", "train", "ov_stat", "val"):
        assert resumed[0][key] == straight[key], key
    for g in got:
        assert g["resumed"]["step"] == 4 and g["resumed"]["epoch"] == 2
        for k, v in got[0]["straight"]["state"].items():
            assert torch.equal(g["resumed"]["state"][k], v), k
    assert [g["early"]["epoch"] for g in got] == [1, 1]
    assert len(_jsonl(tmp / "early" / "rank0")) == 1


# ------------------------------------------------------------ CLI, dryrun

def test_train_cli_trains_data_parallel_and_resumes(preprocessed):  # noqa: F811
    """``cli.train --device cpu trainer=gpu`` (devices: 2) spawns two gloo
    ranks that train to last.ckpt, each step on 2 x model.batch_size
    chunks, one line an epoch written by rank 0; the CLI resumes from that
    file (both ranks) to a third epoch."""
    root, work = preprocessed
    run = work / "run_ddp"
    base = ["trainer=gpu", "loss=multi_accdoa", "seed=3"]
    got = port_train.main(["--device", "cpu", *_overrides(
        root, work, base + ["trainer.max_epochs=2", f"paths.output_dir={run}"])])
    assert got is None  # the ranks wrote the run
    lines = _lines(run)
    assert [line["epoch"] for line in lines] == [1, 2]
    assert all(np.isfinite(line["train"]["loss_all"]) and "val" in line for line in lines)
    last = torch.load(str(run / "checkpoints" / "last.ckpt"), weights_only=False)
    steps = last["global_step"] // 2
    assert last["epoch"] == 2 and last["global_step"] == 2 * steps and steps >= 1
    # DistributedBatchSampler over 2 replicas of batch 2: 4 chunks a step
    n_chunks = sum(1 for _ in open(next((work / "_hdf5").rglob("train2_ov1_*_train.csv")))) - 1
    assert steps == -(-n_chunks // 4)
    resumed = work / "run_ddp_resumed"
    port_train.main(["--device", "cpu", *_overrides(root, work, base + [
        "trainer.max_epochs=3", f"ckpt_path={run}/checkpoints/last.ckpt",
        f"paths.output_dir={resumed}"])])
    assert [line["epoch"] for line in _lines(resumed)] == [3]
    last3 = torch.load(str(resumed / "checkpoints" / "last.ckpt"), weights_only=False)
    assert (last3["epoch"], last3["global_step"]) == (3, 3 * steps)


def test_devices_beyond_the_visible_cards_raise(monkeypatch, tmp_path):
    """trainer.devices beyond the visible cards raises before any work
    (nothing spawned, no run directory); -1 and auto take every card."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    out = tmp_path / "never"
    with pytest.raises(ValueError, match="2 cards; 1 visible"):
        port_train.main(["trainer=gpu", f"paths.output_dir={out}"])
    assert not out.exists()
    cfg = compose(str(ROOT / "configs"), "train", ["trainer=gpu"])
    for devices, want in ((-1, 1), ("auto", 1), (1, 1)):
        cfg["trainer"]["devices"] = devices
        assert port_train.requested_world(cfg, torch.device("cuda")) == want
    cfg["trainer"]["devices"] = 0
    with pytest.raises(ValueError, match="at least one"):
        port_train.requested_world(cfg, torch.device("cpu"))


def test_train_cli_joins_a_launchers_group(monkeypatch):
    """Under torchrun (WORLD_SIZE, RANK, LOCAL_RANK set) the CLI joins the
    launcher's group through env:// instead of spawning (the launcher's
    world wins over trainer.devices), trains every rank on rank 0's
    composed config, and leaves the group after."""
    import socket

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    for k, v in {"WORLD_SIZE": "1", "RANK": "0", "LOCAL_RANK": "0",
                 "MASTER_ADDR": "localhost", "MASTER_PORT": str(port)}.items():
        monkeypatch.setenv(k, v)
    seen = []
    monkeypatch.setattr(port_train, "train",
                        lambda cfg, device: seen.append((cfg, device, world(), is_up())))
    port_train.main(["--device", "cpu", "trainer=gpu"])
    assert len(seen) == 1 and seen[0][1] == torch.device("cpu")
    assert seen[0][2:] == (1, True) and seen[0][0]["trainer"]["devices"] == 2
    assert not is_up()


def test_dryrun_multichip_two_ranks(capsys):
    dryrun_multichip(2)
    out = capsys.readouterr().out
    assert "dryrun_multichip(2): ok, loss_all=" in out
    loss = float(out.split("loss_all=")[1].split()[0])
    assert np.isfinite(loss)
