#!/usr/bin/env python3
"""Tensor-parallel training across cards: W ranks in an NCCL group, one a
card (rank r on cuda:r, started by the train CLI's launcher), laid out as
W / tp data rows of tp model ranks (``trainer.tensor_parallel``,
parallel/tp.py), the full-width HTSAT multi-ACCDOA step of chip_smoke.py
(TRAIN_OVERRIDES: bf16-mixed, drop-path 0.1) on the eager modules, against
one card on the same global batch of G clips.

Layouts: tp 2 on 2 cards, tp 4 on 4 cards, and data 2 x model 2 on 4 cards
(each data row on rows d::2 of the global batch). For each, the first
batch's grads (averaged over the data column, the split ones gathered) and
its loss (the data rows' mean) are held against one card's eager step on
the global batch with the same drop-path masks (the loss within 1e-3
relative; the grads by chip_smoke.py's ``hold_bf16_grads``: within 3e-2
of scale, or 4x one card's bf16 step's largest distance from float32);
then a warm-up and STEPS timed steps on every rank (K1 x1 a step, no
other kernel), one more under torch.profiler on rank 0 (its device time
by kernel; the NCCL kernels' share of it is the all-reduces' share), each
rank's peak device memory, and the ranks' gathered parameters
compared bit for bit. One card then times the eager step and the fused
(K2/K3) step on the global batch. It prints the cards, each layout's ms a
step and the one-card times, and, as its last line, them all as one JSON
object.

    python3 scripts/torch_tp_cards.py            # on a host with 4 cards
    python3 scripts/torch_tp_cards.py --device cpu --tiny --batch 4   # gloo rehearsal

Needs 4 CUDA cards (2 for ``--layouts 2x1``) and nvcc (``--device cpu``:
neither).
"""

import argparse
import json
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "scripts"))

import chip_smoke as c  # noqa: E402
from torch_ddp_cards import CLASSES, STEPS, batches, timed_steps  # noqa: E402
from pseldnets_tpu_torch.entry import DRYRUN_OVERRIDES  # noqa: E402

# (ranks, tp): tp 2 on 2 cards, tp 4 on 4, data 2 x model 2 on 4
LAYOUTS = {"2x1": (2, 2), "4x1": (4, 4), "2x2": (4, 2)}


def rank_run(cfg, G, out, device):
    """One rank of a layout: the first batch's reduced, gathered grads and
    loss, the timed steps, rank 0's profiled step, the peak memory, the
    gathered states compared through a broadcast of rank 0's."""
    from pseldnets_tpu_torch.parallel import all_reduce_mean_, data_rank, data_world, rank
    from pseldnets_tpu_torch.parallel import tp as tensor_parallel
    from pseldnets_tpu_torch.train.module import DatasetSpec, SELDTask

    task = SELDTask(cfg, DatasetSpec(num_classes=CLASSES), steps_per_epoch=100, device=device)
    task.init_state(0)
    n_data, r = data_world(), rank()
    wavs, labels = batches(cfg, G, device, STEPS + 1)
    rows = slice(data_rank(), None, n_data)
    losses, grads, _ = task.compute_grads(wavs[0][rows].contiguous(),
                                          {"adpit_label": labels[rows].contiguous()},
                                          torch.Generator(device=device).manual_seed(8))
    loss = losses["loss_all"].detach().float().reshape(1)
    all_reduce_mean_(grads + [loss])
    split = [(n, g) for n, g in zip(task.trained_names, grads) if n in task.tp_plan]
    full = dict(zip([n for n, _ in split], tensor_parallel.gather_tensors(
        [g for _, g in split], [task.tp_plan[n] for n, _ in split])))
    cuda = task.device.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats(task.device)
    launches, ms, step = timed_steps(task, wavs, labels, rows)
    nccl_share = None
    if r == 0 and cuda:
        rows_ = c.phase_profile("rank 0's tensor-parallel step", step, warm=False)
        busy = sum(x[1] for x in rows_)
        if busy:
            nccl_share = sum(x[1] for x in rows_ if "nccl" in x[0].lower()) / busy
    else:
        step()
    state = task.full_model().state_dict()
    flat = torch.cat([v.float().reshape(-1) for v in state.values()])
    mine = flat.clone()
    torch.distributed.broadcast(flat, 0)
    same = torch.tensor([float(torch.equal(flat, mine))], device=task.device)
    torch.distributed.all_reduce(same)
    rec = {"launches": launches, "ms": ms, "identical": bool(same.item() == torch.distributed
                                                             .get_world_size()),
           "loss": float(loss.item()), "nccl_share": nccl_share,
           "peak_gib": torch.cuda.max_memory_allocated(task.device) / 2 ** 30 if cuda else None}
    if r == 0:
        rec["grads"] = [full.get(n, g).cpu() for n, g in zip(task.trained_names, grads)]
    torch.save(rec, str(Path(out) / f"rank{r}.pt"))


def hold(name, rec, names, gf, g32, lf):
    """A layout's first-step loss (within 1e-3 relative) and grads
    (``chip_smoke.hold_bf16_grads``) against one card's."""
    lk = rec["loss"]
    c.log(f"{name}: loss {lk:.6f} (one card {lf:.6f})")
    c.check(abs(lk - lf) <= 1e-3 * abs(lf), f"{name}: the loss disagrees")
    return c.hold_bf16_grads(name, names, rec["grads"], gf, g32)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--batch", type=int, default=c.B_TRAIN, help="clips of the global batch")
    ap.add_argument("--layouts", default=",".join(LAYOUTS), help="of " + ", ".join(LAYOUTS))
    ap.add_argument("--tiny", action="store_true", help="entry.py's tiny HTSAT (rehearsal)")
    args = ap.parse_args()
    import tempfile

    from pseldnets_tpu_torch.cli.train import spawn
    from pseldnets_tpu_torch.config import compose
    from pseldnets_tpu_torch.ops import _cuda
    from pseldnets_tpu_torch.train.module import DatasetSpec, SELDTask

    cuda = args.device == "cuda"
    if cuda and not torch.cuda.is_available():
        sys.exit("torch_tp_cards: CUDA is not available")
    card = (subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True, text=True,
                           check=True).stdout.strip().splitlines() if cuda else ["cpu"])
    c.log(f"cards: {card}; a global batch of {args.batch} clips")
    if cuda:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        c.log(f"build: {_cuda.build_all(list(c.kernels().values())):.1f} s")
    base = (DRYRUN_OVERRIDES + ["trainer.precision=bf16-mixed"] if args.tiny
            else c.TRAIN_OVERRIDES)
    eager = base + ["trainer.fused_forward=false"]
    G = args.batch
    dev = torch.device("cuda", 0) if cuda else torch.device("cpu")
    ref = {}
    for precision in ("bf16-mixed", "32-true"):  # one card's eager step, and its float32 form
        cfg1 = compose(str(ROOT / "configs"), "train", eager + [
            f"trainer.precision={precision}"])
        task = SELDTask(cfg1, DatasetSpec(num_classes=CLASSES), steps_per_epoch=100, device=dev)
        task.init_state(0)
        wavs, labels = batches(cfg1, G, dev, STEPS + 1)
        losses, g, _ = task.compute_grads(wavs[0], {"adpit_label": labels},
                                          torch.Generator(device=dev).manual_seed(8))
        ref[precision] = (float(losses["loss_all"].detach()), [x.detach() for x in g])
        names = task.trained_names
        del task
    (lf, gf), g32 = ref["bf16-mixed"], ref["32-true"][1]
    summary = {"card": card, "global_batch": G, "layouts": {}}
    for name in args.layouts.split(","):
        W, tp = LAYOUTS[name]
        if cuda and torch.cuda.device_count() < W:
            c.log(f"{name}: needs {W} cards, {torch.cuda.device_count()} visible; not measured")
            continue
        cfg = compose(str(ROOT / "configs"), "train", base + [
            "trainer.fused_forward=auto", f"trainer.tensor_parallel={tp}"])
        with tempfile.TemporaryDirectory() as out:
            spawn(W, rank_run, (cfg, G, out), args.device, timeout=900)
            recs = [torch.load(str(Path(out) / f"rank{r}.pt"), weights_only=False)
                    for r in range(W)]
        label = f"{name} (data {W // tp} x model {tp} on {W} cards)"
        worst = hold(label, recs[0], names, gf, g32, lf)
        want = c.expected(K1=STEPS) if cuda else c.expected()
        for r, rec in enumerate(recs):
            c.log(f"{label} rank {r}: {rec['ms']:.2f} ms/step, peak {rec['peak_gib']} GiB, "
                  f"launches {rec['launches']}")
            c.check(rec["launches"] == want, f"{label} rank {r} launch counts")
            c.check(rec["identical"], f"{label}: the ranks' parameters differ after the steps")
        share = recs[0]["nccl_share"]
        c.log(f"{label}: the NCCL kernels {share if share is None else round(100 * share, 1)}% "
              f"of rank 0's device time; {G * 1e3 / max(r['ms'] for r in recs):.1f} clips/s")
        summary["layouts"][name] = {
            "ranks": W, "tp": tp, "rank_ms": [r["ms"] for r in recs],
            "clips_s": G * 1e3 / max(r["ms"] for r in recs), "nccl_share": share,
            "peak_gib": [r["peak_gib"] for r in recs], "worst_grad_of_scale": worst,
            "loss": recs[0]["loss"]}
    one = {}
    for kind, over in (("eager", eager), ("fused", base)):
        cfg = compose(str(ROOT / "configs"), "train", over)
        t = SELDTask(cfg, DatasetSpec(num_classes=CLASSES), steps_per_epoch=100, device=dev)
        t.init_state(0)
        if cuda:
            torch.cuda.reset_peak_memory_stats(dev)
        _, one[kind], _ = timed_steps(t, wavs, labels, slice(None))
        peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30 if cuda else None
        c.log(f"one card, {kind} step at B={G}: {one[kind]:.2f} ms/step, "
              f"{G * 1e3 / one[kind]:.1f} clips/s, peak {peak} GiB")
        summary[f"one_card_{kind}_ms"] = one[kind]
        summary[f"one_card_{kind}_peak_gib"] = peak
        del t
    summary["one_card_loss"] = lf
    print(json.dumps(summary))


if __name__ == "__main__":
    main()
