"""Tensor parallelism in the port (parallel/tp.py, the (data, model) layout
of parallel/mesh.py, and the tensor-parallel parts of train/module.py,
train/optim.py, train/loop.py and entry.py) on the CPU: gloo processes
started by the train CLI's launcher (``cli.train.spawn``) with
``trainer.tensor_parallel`` set, each data row on its rows of one global
batch, held against one process on that global batch, against the JAX
``tp_shardings`` rules and against the JAX ``SELDTask`` over a 2 x 2 mesh.

Bounds (those of tests/test_torch_ddp.py): a step's float32 loss within
1e-6 relative (1e-5 for a second step, whose parameters already differ
within the sign-flip band); every grad, gathered to full width, within
1e-5 of its scale (floored at 2^-14 of the largest grad); the ranks'
gathered parameters and statistics bit-identical and within AdamW's
sign-flip band of the one-process ones (2.01 lr a step; all but 0.5% of
the elements within 1e-6); checkpoints bit for bit. The ranks run the
functions of tests/torch_tp_workers.py, which import nothing of JAX."""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pseldnets_tpu.config import compose as jax_compose
from pseldnets_tpu.models import build_model as jax_build_model
from pseldnets_tpu.parallel.tp import shard_train_state, tp_spec
from pseldnets_tpu.train.module import SELDTask as JaxTask
from pseldnets_tpu_torch.cli import train as port_train
from pseldnets_tpu_torch.config import compose
from pseldnets_tpu_torch.data.sampler import DistributedBatchSampler
from pseldnets_tpu_torch.entry import dryrun_multichip
from pseldnets_tpu_torch.models import build_model
from pseldnets_tpu_torch.parallel import tp as tensor_parallel
from pseldnets_tpu_torch.train.checkpoint import (flax_to_torch_key, jax_to_torch_state_dict,
                                                  save_training_ckpt)
from pseldnets_tpu_torch.train.module import DatasetSpec, SELDTask
import torch_threads  # noqa: F401  (each xdist worker's share of the cores)
import torch_tp_workers as workers
from test_torch_ddp import (STEP_CASES, _assert_band, _batches, _fit_data, _jsonl,
                            _one_process_steps)
from test_torch_passt import recorded_jax_draws, take_block_mask
from test_torch_passt_train import STEP_PASST
from test_torch_swin_block import randomize
from test_torch_train import TINY_CRNN, TINY_TASK, _JaxSpec, _adpit_labels
from test_torch_infer_cli import K as CLI_CLASSES
from test_torch_train_cli import _lines, _overrides, preprocessed  # noqa: F401  (fixture)

ROOT = Path(__file__).resolve().parents[1]
TIMEOUT = 300  # seconds a spawned run may take
N = 4  # clips of a global batch
SEEDS = [7, 8, 9]
# HTSAT with drop-path and its drop rates, eager (fused_forward auto)
HTSAT_DROP = TINY_TASK + ["model.kwargs.drop_path_rate=0.1", "model.kwargs.drop_rate=0.1",
                          "model.kwargs.attn_drop_rate=0.1"]
CASES = {  # name: (overrides, samples a clip, labels)
    "htsat": (HTSAT_DROP, 64000, STEP_CASES["htsat"][2]),
    "passt": (STEP_PASST + ["loss=accdoa"], 48000,
              lambda rng, n: {"accdoa_label": np.tanh(rng.standard_normal(
                  (n, 20, 9))).astype(np.float32)}),
    "crnn": (STEP_CASES["crnn"][0], STEP_CASES["crnn"][1], STEP_CASES["crnn"][2]),
    "adapter": (TINY_TASK + ["adapt=adapter", "model.kwargs.drop_path_rate=0.1",
                             "trainer.fused_forward=false"], 64000, STEP_CASES["htsat"][2]),
}


def _cfg(overrides, tp=1):
    extra = [f"trainer.tensor_parallel={tp}"] if tp > 1 else []
    return compose(str(ROOT / "configs"), "train", overrides + extra)


def _case_batches(name, seed=5):
    _, samples, labels = CASES[name]
    rng = np.random.default_rng(seed)
    return [{"data": (rng.standard_normal((N, 4, samples)) * 0.1).astype(np.float32),
             **labels(rng, N)} for _ in range(2)]


def _state_dict(name):
    """The case's starting weights: the seeded init, and for AdapterBit the
    adapters' fc2 (zero at init) drawn too, so every adapter leaf trains."""
    task = SELDTask(_cfg(CASES[name][0]), DatasetSpec(num_classes=3), device="cpu")
    task.init_state(0)
    g = torch.Generator().manual_seed(3)
    sd = {k: v.clone() for k, v in task.model.state_dict().items()}
    for k, v in sd.items():
        if "adapter" in k and "fc2" in k:
            sd[k] = 0.1 * torch.randn(v.shape, generator=g)
    return sd


def _spawn(W, fn, args, out):
    port_train.spawn(W, fn, (*args, str(out)), "cpu", timeout=TIMEOUT)
    return [torch.load(str(Path(out) / f"rank{r}.pt"), weights_only=False) for r in range(W)]


# ------------------------------------------------------------ split rules

def _jax_sharded(overrides, tp):
    """The torch keys of the leaves the JAX ``tp_spec`` shards over a model
    axis of ``tp``, by JAX module name, on the config's flax model (shapes
    only: ``jax.eval_shape`` of its init)."""
    cfg = jax_compose(str(ROOT / "configs"), "train", overrides)
    model, _ = jax_build_model(cfg, 3)
    data = cfg["data"]
    if cfg["model"]["backbone"] == "PaSST":
        frames = int(cfg["model"]["kwargs"]["img_size"][1])
    else:
        frames = int(data["train_chunklen_sec"] * data["sample_rate"]) // int(data["hoplen"]) + 1
    feats = jax.ShapeDtypeStruct((2, 7, frames, int(data["n_mels"])), jnp.float32)
    shapes = jax.eval_shape(lambda f: model.init({"params": jax.random.PRNGKey(0),
                                                  "dropout": jax.random.PRNGKey(0),
                                                  "patchout": jax.random.PRNGKey(0)},
                                                 f, train=False), feats)["params"]
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(shapes)[0]:
        names = tuple(getattr(k, "key", str(k)) for k in path)
        if tp_spec(path, leaf, tp) != jax.sharding.PartitionSpec():
            module = next(n for n in reversed(names) if n in tensor_parallel._COL_MODULES
                          + tensor_parallel._ROW_MODULES)
            out[flax_to_torch_key(names)] = module
    return out


# name: (overrides, the split tensors at tp 2 and at tp 4)
SPLIT_MODELS = {
    "htsat": (TINY_TASK, {2: 15, 4: 11}),
    "passt": (STEP_PASST + ["loss=accdoa"], {2: 12, 4: 6}),
    "crnn": (TINY_CRNN + ["model.decoder=conformer"], {2: 6, 4: 6}),
    "adapter": (TINY_TASK + ["adapt=adapter"], {2: 27, 4: 23}),
    "htsat_full": (["loss=multi_accdoa", "model.kwargs.pretrained_path=null"], {2: 87, 4: 87}),
}


@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("name", list(SPLIT_MODELS))
def test_split_rules_cover_the_jax_shardings(name, tp):
    """The parameters the port splits (``tp_plan``) against the leaves the
    JAX ``tp_shardings`` rules shard on the same model: every leaf JAX
    shards under fc1/fc2/reduction is split in the port; every qkv/proj
    leaf is split exactly where its attention's heads divide tp (the port
    splits attention by heads; the tiny HTSAT's 2-head stage and PaSST's 2
    heads stay whole at tp 4), and JAX shards it there too; the port's
    other splits are the bias tables of the split attentions. The count is
    stated, as JAX test_tp.py:98 does."""
    overrides, counts = SPLIT_MODELS[name]
    cfg = _cfg(overrides)
    with torch.device("meta"):
        model, _ = build_model(cfg, 3, device="meta")
    plan = tensor_parallel.tp_plan(model, tp)
    jax_split = _jax_sharded(overrides, tp)
    assert len(plan) == counts[tp], (len(plan), sorted(plan))
    for key, module in jax_split.items():
        if module in ("fc1", "fc2", "reduction"):
            assert key in plan, key
    attentions = [(n, m) for n, m in model.named_modules()
                  if isinstance(getattr(m, "qkv", None), torch.nn.Linear)]
    for n, m in attentions:
        divides = m.num_heads % tp == 0
        for leaf in ("qkv.weight", "qkv.bias", "proj.weight"):
            assert (f"{n}.{leaf}" in plan) == divides, (n, leaf)
            assert not divides or f"{n}.{leaf}" in jax_split, (n, leaf)
    extra = {k for k in plan if k not in jax_split}
    assert all(k.endswith("relative_position_bias_table") for k in extra), extra
    if name.startswith("htsat"):
        assert any(m.num_heads % tp == 0 for _, m in attentions)
        assert any(k.endswith("reduction.weight") for k in plan)


# ------------------------------------------------------------ steps

@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    """Each case's steps on 2 ranks (model 2), and on one process."""
    cases = {name: (_cfg(CASES[name][0], 2), 3, _case_batches(name), SEEDS,
                    _state_dict(name), None) for name in CASES}
    got = _spawn(2, workers.steps_rank, (cases,), tmp_path_factory.mktemp("tp2"))
    ref = {name: _reference(name, c[2], c[4]) for name, c in cases.items()}
    return got, ref


def _reference(name, batches, state_dict=None):
    """One process's steps on the global batches, with the scales its grads
    are held at (floored at 2^-14 of the largest grad), and for the CRNN
    (dropout only, no drop-path) test_torch_ddp.py's ``spread``: how far
    float32 summation order alone moves each grad (its key-projection bias
    grads are 0 up to rounding); the CRNN starts from its seeded init."""
    cfg = _cfg(CASES[name][0])
    if name == "crnn":
        return _one_process_steps(cfg, batches, SEEDS)
    ref = workers.steps(cfg, 3, batches, SEEDS, state_dict)
    largest = max(float(g.abs().max()) for g in ref["grads"])
    ref["scales"] = [max(float(g.abs().max()), 2.0 ** -14 * largest) for g in ref["grads"]]
    ref["spread"] = [0.0] * len(ref["grads"])
    ref["names"] = list(range(len(ref["grads"])))
    return ref


def _hold(got, ref, steps=2):
    """The ranks' records of one case against the one-process record."""
    assert all(not g["fused"] for g in got) and all(g["plan"] for g in got)
    W, n_data = got[0]["layout"][:2]
    grad_loss = np.mean([g["grad_loss"] for g in got])
    assert abs(grad_loss - ref["grad_loss"]) <= 1e-6 * abs(ref["grad_loss"])
    for i, want in enumerate(ref["losses"]):
        mean = np.mean([g["losses"][i] for g in got])
        assert abs(mean - want) <= (1e-6 if i == 0 else 1e-5) * abs(want), (i, mean, want)
    # each grad within 1e-5 of its scale (floored at 2^-14 of the largest
    # grad), or within twice the one process's own spread under a clip
    # order change where float32 summation order alone moves it further
    # (the conformer's key-projection bias grads, 0 up to rounding)
    for name, a, want, scale, spread in zip(ref["names"], got[0]["grads"], ref["grads"],
                                            ref["scales"], ref["spread"]):
        err = float((a - want).abs().max()) / scale
        assert err <= max(1e-5, 2 * spread), (name, err, spread)
    for g in got[1:]:
        for k, v in got[0]["state"].items():
            assert torch.equal(v, g["state"][k]), k
    for g in got:  # the model ranks of a data row hold one set of grads
        for a, b in zip(got[g["layout"][2] * g["layout"][3]]["grads"], g["grads"]):
            assert torch.equal(a, b)
    assert all(g["step"] == steps for g in got)
    _assert_band(got[0]["state"], ref["state"], 1e-4, steps)
    for g in got:  # the frozen parameters (AdapterBit's) as they started
        for k, v in g["frozen"].items():
            assert torch.equal(g["state"][k], v), k
    assert {g["layout"] for g in got} == {
        (W, n_data, W // n_data, d, m) for d in range(n_data) for m in range(W // n_data)}


@pytest.mark.parametrize("name", list(CASES))
def test_two_model_ranks_match_one_process(two_ranks, name):
    """compute_grads and two train_steps on 2 ranks (data 1 x model 2, the
    global batch of 4 on each) against one process: HTSAT with drop-path
    and its drop rates (the attention-dropout masks' heads and the MLP
    dropout's columns from full-width draws), the tiny PaSST (frequency
    patchout, position dropout, drop-path), the CRNN with the conformer
    decoder (its feed-forward modules split, dropout 0.1) and AdapterBit
    HTSAT (adapters split, its frozen parameters bit-identical after the
    steps)."""
    got, ref = two_ranks
    _hold([g[name] for g in got], ref[name])
    assert bool(got[0][name]["frozen"]) == (name == "adapter")


@pytest.fixture(scope="module")
def four_ranks(tmp_path_factory, rng):
    """HTSAT with its drop rates on 4 ranks (data 2 x model 2) and one
    process; and one step against the JAX SELDTask's over a 2 x 2 mesh of 4
    of the 8 CPU devices (tensor_parallel=2, flax, GSPMD), from the same
    random weights, drop-path 0.1, the JAX step's DropPath draws recorded
    from an unjitted apply on its keys and injected, each data row its
    rows."""
    over = TINY_TASK + ["model.kwargs.drop_path_rate=0.1"]
    task_j = JaxTask(jax_compose(str(ROOT / "configs"), "train", over + [
        "trainer.fused_forward=false", "trainer.tensor_parallel=2"]), _JaxSpec(),
        steps_per_epoch=2, num_devices=4)
    assert dict(task_j.mesh.shape) == {"data": 2, "model": 2}
    state = task_j.init_state(jax.random.PRNGKey(0))
    params = randomize(jax.tree_util.tree_map(np.asarray, state.params), rng)
    variables = {"params": params,
                 "batch_stats": jax.tree_util.tree_map(np.asarray, state.batch_stats)}
    state = shard_train_state(state.replace(params=jax.tree_util.tree_map(jnp.asarray, params)),
                              task_j.mesh, task_j.tx)
    wav = (rng.standard_normal((N, 4, 64000)) * 0.1).astype(np.float32)
    lab = _adpit_labels(rng, N, 40, 3)
    key = jax.random.PRNGKey(1)
    new_state, losses_j, _ = task_j.train_step(state, {"data": wav, "adpit_label": lab}, key)
    with recorded_jax_draws() as rec:
        task_j.model.apply(variables, jnp.zeros((N, 7, 201, 16)), train=True,
                           mutable=["batch_stats"],
                           rngs={"dropout": jax.random.fold_in(key, 1),
                                 "patchout": jax.random.fold_in(key, 2)})
    cfg = _cfg(over, 2)
    rates = SELDTask(_cfg(over), DatasetSpec(num_classes=3), device="cpu").model \
        .encoder.block_rates()
    uniforms = iter([(n, v) for n, v in rec if n == "uniform"])
    masks = [take_block_mask(uniforms, r, N).numpy() for r in rates]
    assert any((m == 0).any() for m in masks)
    sd = jax_to_torch_state_dict(variables)
    cases = {"htsat": (_cfg(HTSAT_DROP, 2), 3, _case_batches("htsat"), SEEDS, None, None),
             "jax": (cfg, 3, [{"data": wav, "adpit_label": lab}], [0, 0], sd, [masks], True)}
    got = _spawn(4, workers.steps_rank, (cases,), tmp_path_factory.mktemp("tp4"))
    ref = _reference("htsat", cases["htsat"][2])
    want = jax_to_torch_state_dict(jax.tree_util.tree_map(
        np.asarray, {"params": new_state.params, "batch_stats": new_state.batch_stats}))
    return got, ref, float(losses_j["loss_all"]), want, float(
        cfg["model"]["optimizer"]["kwargs"]["lr"])


def test_four_ranks_data_by_model_match_one_process(four_ranks):
    """compute_grads and two train_steps on 4 ranks (data 2 x model 2: each
    data row on rows d::2 of the global batch of 4, its BatchNorm
    statistics global over the data column, the grads averaged over it,
    the split ones summed over the model row in the clip) against one
    process, HTSAT with drop-path and its drop rates."""
    got, ref, *_ = four_ranks
    _hold([g["htsat"] for g in got], ref)


def test_four_ranks_match_the_jax_tensor_parallel_step(four_ranks):
    """One train_step on 4 ranks (data 2 x model 2, eager, B=2 a data row)
    against the JAX SELDTask's tensor-parallel step on the global batch of
    4: the loss (the data rows' mean) within 1e-5, every parameter and
    statistic within 2.01 lr of the JAX one, all but 0.5% of the elements
    within 1e-6; the ranks' gathered states bit-identical."""
    got, _, loss_j, want, lr = four_ranks
    recs = [g["jax"] for g in got]
    loss = np.mean([r["losses"][0] for r in recs])
    assert abs(loss - loss_j) < 1e-5, (loss, loss_j)
    for r in recs[1:]:
        for k, v in recs[0]["state"].items():
            assert torch.equal(v, r["state"][k]), k
    _assert_band(recs[0]["state"], want, lr, 1)


# ------------------------------------------------------------ checkpoints, fit

# test_torch_ddp.py's FIT on the eager modules; no random draw (a resumed
# fit restarts its generator from the seed, as the JAX fit its key)
FIT_TP = TINY_TASK + ["data.test_chunklen_sec=4", "data.test_hoplen_sec=4",
                      "model.batch_size=2", "trainer.max_epochs=2", "logger=csv", "seed=5"]


@pytest.fixture(scope="module")
def checkpoints(tmp_path_factory):
    """checkpoints_rank on 2 ranks (model 2), after one process wrote a
    weights file and a training state (one step) for the ranks to load;
    then one process loading the ranks' last.ckpt."""
    tmp = tmp_path_factory.mktemp("tp_ckpt")
    cfg1 = _cfg(FIT_TP + [f"paths.log_dir={tmp}/logs"])
    one = SELDTask(cfg1, DatasetSpec(num_classes=3), steps_per_epoch=2, device="cpu")
    one.init_state(3)
    batch = _batches("htsat", 9)[0]
    one.train_step(batch["data"], {"adpit_label": batch["adpit_label"]},
                   torch.Generator().manual_seed(4))
    save_training_ckpt(tmp / "one.ckpt", one.model, global_step=1, epoch=1)
    save_training_ckpt(tmp / "one_last.ckpt", one.model, one.state.optimizer, global_step=1,
                       epoch=1, best_score=7.0)
    cfg = _cfg(FIT_TP + [f"paths.log_dir={tmp}/logs"], 2)
    got = _spawn(2, workers.checkpoints_rank, (cfg, _fit_data()), tmp)
    back = SELDTask(cfg1, DatasetSpec(num_classes=3), steps_per_epoch=2, device="cpu")
    back.init_state(0, ckpt_path=str(tmp / "straight" / "rank0" / "checkpoints" / "last.ckpt"))
    return tmp, got, one, back


def _same_optimizer_state(a, b):
    assert a["param_groups"] == b["param_groups"]
    assert a["state"].keys() == b["state"].keys()
    for i, st in a["state"].items():
        for k, v in st.items():
            w = b["state"][i][k]
            assert torch.equal(v, w) if isinstance(v, torch.Tensor) else v == w, (i, k)


def test_checkpoints_load_bit_for_bit_both_ways(checkpoints):
    """A one-process weights file and training state load into 2 model
    ranks bit for bit (their gathered parameters, statistics and AdamW
    moments are the one process's), and the ranks' last.ckpt (gathered
    parameters and moments, written by rank 0) loads into one process bit
    for bit; fused_forward=true under tensor parallelism raises."""
    from pseldnets_tpu_torch.train.checkpoint import optimizer_state

    tmp, got, one, back = checkpoints
    want = one.model.state_dict()
    for g in got:
        for k, v in want.items():
            assert torch.equal(g["loaded"][k], v), k
            assert torch.equal(g["loaded_last"]["state"][k], v), k
        assert g["loaded_last"]["step"] == 1
        _same_optimizer_state(g["loaded_last"]["opt"], optimizer_state(one.state.optimizer))
        assert "tensor_parallel=1" in g["fused_refused"]
    last = torch.load(str(tmp / "straight" / "rank0" / "checkpoints" / "last.ckpt"),
                      weights_only=False)
    for k, v in got[0]["straight"]["state"].items():
        assert torch.equal(back.model.state_dict()[k], v), k
    _same_optimizer_state(optimizer_state(back.state.optimizer), last["optimizer_states"][0])
    assert back.state.step == 4 and back.state.epoch == 2
    assert not (tmp / "straight" / "rank1" / "checkpoints" / "last.ckpt").exists()


def test_fit_resumes_exactly(checkpoints):
    """fit on 2 model ranks: two epochs straight, and one epoch then a
    resume from rank 0's last.ckpt (the split moments re-split) to the
    second: the resumed run's line is the straight run's second line and
    its gathered weights the straight run's, bit for bit, on both ranks,
    which agree."""
    tmp, got, _, _ = checkpoints
    straight = _jsonl(tmp / "straight" / "rank0")
    resumed = _jsonl(tmp / "resumed" / "rank0")
    assert [line["epoch"] for line in straight] == [1, 2]
    assert [line["epoch"] for line in resumed] == [2]
    for key in ("epoch", "lr", "train", "ov_stat", "val"):
        assert resumed[0][key] == straight[1][key], key
    for g in got:
        assert g["resumed_at"] == {"epoch": 1, "step": 2}
        assert g["resumed"]["step"] == 4 and g["resumed"]["epoch"] == 2
        for k, v in got[0]["straight"]["state"].items():
            assert torch.equal(g["resumed"]["state"][k], v), k
            assert torch.equal(g["straight"]["state"][k], v), k


# ------------------------------------------------------------ CLI, errors, dryrun

def test_train_cli_trains_tensor_parallel(preprocessed):  # noqa: F811
    """``cli.train --device cpu trainer=gpu trainer.tensor_parallel=2``: the
    two spawned gloo ranks are one data row of two model ranks (the layout
    up before the datamodule: the sampler gives both the same 2 chunks a
    step, one process's step count), they train the CRNN (its conformer's
    feed-forward modules split) to a last.ckpt of the full model, which one
    process loads."""
    root, work = preprocessed
    run = work / "run_tp"
    got = port_train.main(["--device", "cpu", *_overrides(root, work, [
        "trainer=gpu", "trainer.tensor_parallel=2", "loss=multi_accdoa", "seed=3",
        "trainer.max_epochs=1", f"paths.output_dir={run}"])])
    assert got is None  # the ranks wrote the run
    lines = _lines(run)
    assert [line["epoch"] for line in lines] == [1] and np.isfinite(lines[0]["train"]["loss_all"])
    n_chunks = sum(1 for _ in open(next((work / "_hdf5").rglob("train2_ov1_*_train.csv"))))
    last = torch.load(str(run / "checkpoints" / "last.ckpt"), weights_only=False)
    # one process's batches of 2: the sampler's count on one replica
    assert last["global_step"] == len(DistributedBatchSampler(n_chunks, 2, rank=0,
                                                              num_replicas=1))
    cfg = compose(str(ROOT / "configs"), "train", _overrides(root, work, ["loss=multi_accdoa"]))
    one = SELDTask(cfg, DatasetSpec(num_classes=CLI_CLASSES), steps_per_epoch=2, device="cpu")
    one.init_state(0, ckpt_path=str(run / "checkpoints" / "last.ckpt"))
    assert one.state.step == last["global_step"] and one.state.epoch == 1



def test_tensor_parallel_that_does_not_divide_the_ranks_raises():
    """tensor_parallel must divide the processes (one here), as the JAX
    task's devices (train/module.py:108-111)."""
    with pytest.raises(ValueError, match="tensor_parallel=2 does not divide the 1 process"):
        SELDTask(_cfg(TINY_TASK, 2), DatasetSpec(num_classes=3), device="cpu")


def test_dryrun_multichip_four_ranks(capsys):
    """dryrun_multichip(4) runs the data-parallel step and then, as the JAX
    dryrun, the tensor-parallel one over (data 2, model 2)."""
    dryrun_multichip(4)
    out = capsys.readouterr().out
    assert "dryrun_multichip(4): ok, loss_all=" in out
    assert "dryrun tp(data=2,model=2): ok, loss_all=" in out
    for line in out.splitlines():
        if "loss_all=" in line:
            assert np.isfinite(float(line.split("loss_all=")[1].split()[0]))
