#!/usr/bin/env python3
"""Data-parallel training across cards: one rank a card in an NCCL group,
started by the train CLI's launcher (``pseldnets_tpu_torch.cli.train.spawn``,
rank r on cuda:r), the full-width HTSAT step of chip_smoke.py's phase_train
(TRAIN_OVERRIDES: bf16-mixed, fused forward, drop-path 0.1), B clips a
rank, against one process on the global batch.

Each rank takes rows rank::W of one seeded global batch of W * B clips. The
first batch's grads, averaged over the ranks, and its loss (the ranks'
mean) are held against one process's kernel step on the global batch with
the same drop-path masks (chip_smoke.py's train_ddp2 rule: the loss within
2^-6 of its scale, every grad within 2^-4 of its own scale, floored at
2^-14 of the largest); then a warm-up and STEPS timed steps on every rank
(K1 x1, K2 x12, K3 x12 a step on each, counted) and one more under
torch.profiler on rank 0 (its device time by kernel, the collectives'
among them), after which the ranks' parameters and statistics must be
bit-identical. One process then times the same steps at B (a rank's work
alone; one more profiled) and at W * B (the global batch on one card).
Each timing also logs the main thread's CPU time a step (host work
against waiting). It prints the card, every rank's ms a step, the two
one-process times and the clips a second of each, and, as its last line,
them all as one JSON object.

    python3 scripts/torch_ddp_cards.py          # on a host with 4 cards: 4 ranks
    python3 scripts/torch_ddp_cards.py --device cpu --world 4 --tiny --batch 2   # gloo

Needs as many CUDA cards as ranks, and nvcc (``--device cpu``: neither).
"""

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as c  # noqa: E402
from pseldnets_tpu_torch.entry import DRYRUN_OVERRIDES  # noqa: E402

STEPS = 5
CLASSES = 13


def batches(cfg, n, device, count):
    """``count`` global batches of n clips (waveforms from a generator of
    seed 6 on ``device``, the same in every process) and bench_train.py's
    labels."""
    data = cfg["data"]
    samples = int(data["train_chunklen_sec"] * data["sample_rate"])
    g = torch.Generator(device=device).manual_seed(6)
    wavs = [torch.randn(n, 4, samples, device=device, generator=g) * 0.1 for _ in range(count)]
    frames = int(data["train_chunklen_sec"] / 0.1)
    labels = torch.from_numpy(c.make_labels(np.random.default_rng(0), n, frames, CLASSES))
    return wavs, labels.to(device)


def timed_steps(task, wavs, labels, rows):
    """A warm-up step, then one a batch on ``rows`` (drop-path from a
    generator of seed 7): -> (launches counted over the timed steps, ms a
    step on the host clock, synchronized, the step function)."""
    dev = task.device
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    gen = torch.Generator(device=dev).manual_seed(7)
    mine = labels[rows].contiguous()
    step = lambda w: task.train_step(w[rows].contiguous(), {"adpit_label": mine}, gen)  # noqa: E731
    step(wavs[0])
    sync()
    c.zero_counts()
    t0, cpu0 = time.perf_counter(), time.thread_time()
    losses = [step(w)["loss_all"] for w in wavs[1:]]
    sync()
    ms = (time.perf_counter() - t0) * 1e3 / (len(wavs) - 1)
    cpu_ms = (time.thread_time() - cpu0) * 1e3 / (len(wavs) - 1)
    c.log(f"  {ms:.2f} ms a step on the host clock, {cpu_ms:.2f} ms of it the main thread's "
          f"CPU time ({task.device}, B={len(mine)})")
    c.check(all(np.isfinite(float(v)) for v in losses), "a loss is not finite")
    return c.read_counts(), ms, lambda: step(wavs[1])


def rank_run(cfg, B, out, device):
    """One rank: the first batch's reduced grads and loss, the timed steps,
    the ranks' states compared through a broadcast of rank 0's; its record
    to ``out``."""
    from pseldnets_tpu_torch.parallel import all_reduce_mean_, rank, world
    from pseldnets_tpu_torch.train.module import DatasetSpec, SELDTask

    W, r = world(), rank()
    task = SELDTask(cfg, DatasetSpec(num_classes=CLASSES), steps_per_epoch=100, device=device)
    task.init_state(0)
    wavs, labels = batches(cfg, W * B, device, STEPS + 1)
    rows = slice(r, None, W)
    losses, grads, _ = task.compute_grads(wavs[0][rows].contiguous(),
                                          {"adpit_label": labels[rows].contiguous()},
                                          torch.Generator(device=device).manual_seed(8))
    loss = losses["loss_all"].detach().float().reshape(1)
    all_reduce_mean_(grads + [loss])
    launches, ms, step = timed_steps(task, wavs, labels, rows)
    if r == 0 and task.device.type == "cuda":  # where a rank's step goes: one more, profiled
        c.phase_profile("rank 0's step", step, warm=False)
    else:
        step()
    flat = torch.cat([v.float().reshape(-1) for v in task.model.state_dict().values()])
    mine = flat.clone()
    torch.distributed.broadcast(flat, 0)
    same = torch.tensor([float(torch.equal(flat, mine))], device=device)
    torch.distributed.all_reduce(same)
    rec = {"launches": launches, "ms": ms, "identical": bool(same.item() == W),
           "loss": float(loss.item())}
    if r == 0:
        rec["grads"] = [g.cpu() for g in grads]
    torch.save(rec, str(Path(out) / f"rank{r}.pt"))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--world", type=int, default=None, help="ranks (default: every card)")
    ap.add_argument("--batch", type=int, default=c.B_TRAIN, help="clips a rank")
    ap.add_argument("--tiny", action="store_true", help="entry.py's tiny HTSAT (rehearsal)")
    args = ap.parse_args()
    import tempfile

    from pseldnets_tpu_torch.cli.train import spawn
    from pseldnets_tpu_torch.config import compose
    from pseldnets_tpu_torch.ops import _cuda
    from pseldnets_tpu_torch.train.module import DatasetSpec, SELDTask

    cuda = args.device == "cuda"
    if cuda and not torch.cuda.is_available():
        sys.exit("torch_ddp_cards: CUDA is not available")
    W = args.world or (torch.cuda.device_count() if cuda else 2)
    card = (subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True, text=True,
                           check=True).stdout.strip().splitlines() if cuda else ["cpu"])
    c.log(f"cards: {card}; {W} ranks of {args.batch} clips")
    if cuda:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        c.log(f"build: {_cuda.build_all(list(c.kernels().values())):.1f} s")
    cfg = compose(str(ROOT / "configs"), "train",
                  DRYRUN_OVERRIDES + ["trainer.precision=bf16-mixed"] if args.tiny
                  else c.TRAIN_OVERRIDES)
    B = args.batch
    with tempfile.TemporaryDirectory() as out:
        spawn(W, rank_run, (cfg, B, out), args.device, timeout=900)
        recs = [torch.load(str(Path(out) / f"rank{r}.pt"), weights_only=False) for r in range(W)]

    dev = torch.device("cuda", 0) if cuda else torch.device("cpu")
    task = SELDTask(cfg, DatasetSpec(num_classes=CLASSES), steps_per_epoch=100, device=dev)
    task.init_state(0)
    wavs, labels = batches(cfg, W * B, dev, STEPS + 1)
    losses, gf, _ = task.compute_grads(wavs[0], {"adpit_label": labels},
                                       torch.Generator(device=dev).manual_seed(8))
    lf, lk = float(losses["loss_all"].detach()), recs[0]["loss"]
    c.log(f"{W} ranks' step vs one process on the global batch of {W * B}: loss {lk:.6f} "
          f"(one process {lf:.6f})")
    c.check(abs(lk - lf) <= 2.0 ** -6 * abs(lf), "the loss disagrees")
    floor = 2.0 ** -14 * max(g.abs().max().item() for g in gf)
    worst = (0.0, "")
    for name, a, g in zip(task.trained_names, recs[0]["grads"], gf):
        rel = (a.to(dev) - g).abs().max().item() / max(g.abs().max().item(), floor)
        c.check(torch.isfinite(a).all().item() and rel <= 2.0 ** -4,
                f"the {name} grad {rel:.3g} of its scale from the one-process step's")
        worst = max(worst, (rel, name))
    c.log(f"every reduced grad within {worst[0]:.3g} of its scale (<= 2^-4; the worst {worst[1]})")
    want = c.expected(K1=STEPS, K2=12 * STEPS, K3=12 * STEPS) if cuda else c.expected()
    for r, rec in enumerate(recs):
        c.log(f"rank {r}: {rec['ms']:.2f} ms/step, launches {rec['launches']}")
        c.check(rec["launches"] == want, f"rank {r} launch counts")
        c.check(rec["identical"], "the ranks' parameters differ after the steps")
    one = {}
    for n in (B, W * B):
        task.init_state(0)
        _, one[n], step = timed_steps(task, wavs, labels, slice(0, n))
        c.log(f"one process at B={n}: {one[n]:.2f} ms/step, {n * 1e3 / one[n]:.1f} clips/s")
        if n == B and cuda:  # beside rank 0's profiled step
            c.phase_profile(f"one process's step at B={n}", step, warm=False)
    rank_ms = max(rec["ms"] for rec in recs)
    summary = {"card": card, "ranks": W, "clips_a_rank": B, "rank_ms": [r["ms"] for r in recs],
               "clips_s": W * B * 1e3 / rank_ms,
               "one_process_ms": {str(k): v for k, v in one.items()},
               "one_process_clips_s": W * B * 1e3 / one[W * B], "worst_grad_of_scale": worst[0],
               "loss": lk, "one_process_loss": lf}
    c.log(f"{W} ranks: {summary['clips_s']:.1f} clips/s against one process's "
          f"{summary['one_process_clips_s']:.1f} on the same global batch ({card[0]})")
    print(json.dumps(summary))


if __name__ == "__main__":
    main()
