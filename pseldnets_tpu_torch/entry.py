"""Entry point of the port, the counterpart of the JAX package's
``__graft_entry__.entry``: the flagship model (HTSAT multi-ACCDOA, 13
classes x 3 tracks, configs/model/htsat.yaml at its published width, seeded
random weights) served from raw FOA waveforms at full production shapes.

    fn, args = entry()          # on the card
    out = fn(*args)             # {"multi_accdoa": (2, 100, 117)}

``fn(model, waveforms)`` is ``htsat_fused_forward_from_wav`` (kernels K1,
K8 and K2 x12 on the card; their plain versions on the CPU).

``dryrun_multichip(n)``, the counterpart of the JAX package's
``__graft_entry__.dryrun_multichip``: one data-parallel training step over
n processes on the CPU (gloo), started by the train CLI's launcher, and for
an even n of 4 or more, as the JAX dryrun (:233-246), one tensor-parallel
step over (data = n / 2, model = 2) on the same processes.
"""

import tempfile
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parents[1]

# a tiny HTSAT multi-ACCDOA (two Swin stages of width 8, 4 s clips at 16
# kHz), fused forward with drop-path 0.1, float32
DRYRUN_OVERRIDES = ["loss=multi_accdoa", "model.kwargs.pretrained_path=null",
                    "model.kwargs.audioset_pretrain=false", "data.sample_rate=16000",
                    "data.nfft=256", "data.n_mels=16", "data.hoplen=320",
                    "data.train_chunklen_sec=4", "model.kwargs.spec_size=64",
                    "model.kwargs.embed_dim=8", "model.kwargs.depths=[1,1]",
                    "model.kwargs.num_heads=[2,4]", "model.kwargs.window_size=4",
                    "model.kwargs.drop_path_rate=0.1", "model.kwargs.tgt_output_frames=40",
                    "trainer.fused_forward=true", "seed=3"]
DRYRUN_CLASSES, DRYRUN_B = 4, 2  # classes; clips a rank


def entry(device="cuda"):
    """-> (fn, example_args): ``fn(model, waveforms)`` the served forward,
    ``example_args`` the model on ``device`` and a (2, 4, samples) float32
    batch of zeros there (240000 samples, 10 s at 24 kHz)."""
    from .config import compose
    from .models import build_model
    from .serving import htsat_fused_forward_from_wav, prepare_blocks, prepare_patch_embed

    cfg = compose(str(REPO / "configs"), "train",
                  ["loss=multi_accdoa", "model.kwargs.pretrained_path=null"])
    model, _ = build_model(cfg, 13, device=device, seed=0)
    data = cfg["data"]
    blocks = prepare_blocks(model.encoder, torch.bfloat16)
    embed = prepare_patch_embed(model.encoder, torch.bfloat16)
    frontend = dict(n_fft=int(data["nfft"]), hop=int(data["hoplen"]), window=str(data["window"]),
                    n_mels=int(data["n_mels"]), sample_rate=int(data["sample_rate"]))

    def fn(model, waveforms):
        return htsat_fused_forward_from_wav(model, waveforms, device=device, blocks=blocks,
                                            embed=embed, **frontend)

    n = int(data["train_chunklen_sec"] * data["sample_rate"])
    batch = torch.zeros((2, 4, n), dtype=torch.float32, device=model.scalar.weight.device)
    return fn, (model, batch)


def dryrun_multichip(n: int) -> None:
    """One data-parallel ``SELDTask`` step of a tiny HTSAT multi-ACCDOA
    (``DRYRUN_OVERRIDES``) over ``n`` processes on the CPU in a gloo group,
    started by the train CLI's launcher (cli/train.py ``spawn``), each rank
    on its rows of one seeded global batch of ``n * DRYRUN_B`` clips, the
    drop-path masks from a generator of one seed. Checks that every rank
    ends the step with bit-identical parameters and BatchNorm statistics
    and that the loss is finite, then prints ``dryrun_multichip(n): ok,
    loss_all=<the ranks' mean>``. For an even n of 4 or more, the same
    processes then take one tensor-parallel step (``trainer.
    tensor_parallel=2``, the eager modules: data = n / 2 rows of 2 model
    ranks, each row on its rows of a global batch of n / 2 * DRYRUN_B
    clips), check that every rank's gathered parameters are bit-identical
    and its loss finite, and print ``dryrun tp(data=n/2,model=2): ok,
    loss_all=...``, as the JAX dryrun does."""
    from .cli.train import spawn
    from .config import compose

    cfg = compose(str(REPO / "configs"), "train", DRYRUN_OVERRIDES)
    tp = n >= 4 and n % 2 == 0
    cfg_tp = compose(str(REPO / "configs"), "train", DRYRUN_OVERRIDES + [
        "trainer.fused_forward=auto", "trainer.tensor_parallel=2"]) if tp else None
    with tempfile.TemporaryDirectory(prefix="pseldnets_dryrun_") as out:
        spawn(n, _dryrun_ranks, (cfg, cfg_tp, out), "cpu")
        got = [torch.load(str(Path(out) / f"rank{r}.pt"), weights_only=True) for r in range(n)]
        got_tp = [torch.load(str(Path(out) / "tp" / f"rank{r}.pt"), weights_only=True)
                  for r in range(n)] if tp else None
    loss = _dryrun_check(f"dryrun_multichip({n})", got)
    print(f"dryrun_multichip({n}): ok, loss_all={loss:.6f}", flush=True)
    if tp:
        loss = _dryrun_check(f"dryrun tp(data={n // 2},model=2)", got_tp)
        print(f"dryrun tp(data={n // 2},model=2): ok, loss_all={loss:.6f}", flush=True)


def _dryrun_check(what: str, got) -> float:
    """Every rank's state bit-identical to rank 0's, the ranks' mean loss
    finite: -> that loss."""
    for r in range(1, len(got)):
        for k, v in got[0]["state"].items():
            if not torch.equal(v, got[r]["state"][k]):
                raise AssertionError(f"{what}: rank {r}'s {k} differs from rank 0's after "
                                     "the step")
    loss = float(np.mean([g["loss_all"] for g in got]))
    if not np.isfinite(loss):
        raise AssertionError(f"{what}: loss {loss}")
    return loss


def _dryrun_ranks(cfg, cfg_tp, out: str, device) -> None:
    """One rank of ``dryrun_multichip``: the data-parallel step, then, with
    ``cfg_tp``, the tensor-parallel one (its records under ``out/tp``)."""
    _dryrun_rank(cfg, out, device)
    if cfg_tp is not None:
        (Path(out) / "tp").mkdir(exist_ok=True)
        _dryrun_rank(cfg_tp, str(Path(out) / "tp"), device)


def _dryrun_rank(cfg, out: str, device) -> None:
    """One rank's step on its data rows, then its full-width state and loss
    written to ``out``."""
    from .parallel import data_rank, data_world, rank
    from .train.module import DatasetSpec, SELDTask

    task = SELDTask(cfg, DatasetSpec(num_classes=DRYRUN_CLASSES), steps_per_epoch=10,
                    device=device)
    task.init_state()
    W, r = data_world(), data_rank()
    data = cfg["data"]
    samples = int(data["train_chunklen_sec"] * data["sample_rate"])
    frames = int(data["train_chunklen_sec"] / 0.1)
    rng = np.random.default_rng(0)
    wav = (rng.standard_normal((W * DRYRUN_B, 4, samples)) * 0.1).astype(np.float32)
    act = rng.random((W * DRYRUN_B, frames, 6, 1, DRYRUN_CLASSES)) < 0.3
    doa = rng.standard_normal((W * DRYRUN_B, frames, 6, 3, DRYRUN_CLASSES)).astype(np.float32)
    labels = np.concatenate([act, act * doa], axis=3).astype(np.float32)
    losses = task.train_step(wav[r::W], {"adpit_label": labels[r::W]},
                             torch.Generator(device=device).manual_seed(1))
    state = task.full_model().state_dict()
    torch.save({"state": {k: v.detach().cpu() for k, v in state.items()},
                "loss_all": float(losses["loss_all"])}, str(Path(out) / f"rank{rank()}.pt"))
