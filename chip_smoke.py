#!/usr/bin/env python3
"""GPU smoke run of the PyTorch/CUDA port (pseldnets_tpu_torch).

Builds the hand-written CUDA kernels from pseldnets_tpu_torch/csrc, holds each
against its plain PyTorch version on the card, then drives the port's main
paths at full published width (configs/, HTSAT mACCDOA, 13 classes x 3
tracks, seeded random weights, 10 s FOA waveforms): serving through
htsat_fused_forward_from_wav, and training through SELDTask.train_step
(frontend, fused forward with drop-path, ADPIT loss, K3 backward, clip,
AdamW); then the same two with AdapterBit (adapt=adapter: bottleneck
adapters in every block, K4 forward and K5 backward, frozen backbone); then
PaSST mACCDOA serving (configs/model/passt.yaml, 602 tokens of 768, 7 ViT
blocks on K6) through passt_fused_forward_from_wav; then CRNN ACCDOA serving
(configs/model/crnn.yaml: the CNN12 trunk, its six ConvBlocks on K7, and a
conformer at 2048) through crnn_fused_forward_from_wav; then HTSAT serving
again with the einsum patch embed (patch_embed="einsum"; the other served
HTSAT paths take K8, the default); then the frontend's flat and DIF forms
(K9, K10) through fused_logmel_iv (radix2=False, variant="dif"), each
also at 128 mels; then PaSST at its published 128 mel bins and HTSAT at 128
mels (freq_ratio 2, hop 480) served through SELDTask's eval route (K1, K6;
K1, K8 at 128 bins, K2), with the frontend forms and K1 at 96, 128 and 256
mels and K8 at 128 and 256 bins held against their plain versions before;
then HTSAT
serving once more with each Swin stage in one launch (K11, swin="stage",
the merges unfolded); then EINV2 (configs/loss/einv2_pit_agg.yaml: two
HTSAT encoders stitched before every stage) served through
einv2_htsat_fused_forward_from_wav (K1, the DOA branch's K8, K2 on both
branches) and trained eagerly through SELDTask (K1); then PaSST ACCDOA
training (configs/model/passt.yaml at full width, eager under bf16 autocast
as in the JAX package: K1), with the shipped kwargs and with the structured
frequency patchout, drop-path and position dropout, and one validation of
it (K1, K6); then the eval path:
SELDTask.eval_step on an odd batch (K1, K8, K2), ACS with 256 and 512
folded clips a launch, run_validation with move_avg and run_test on an in-memory
datamodule, and one eval step of each other route (K4, K6, K2 x24, K7); then
fit to a checkpoint; then the shipped training recipes: experiment=synth_maccdoa
(AugMix, 96 clips a step on K1, K2, K3) from a synthetic AudioSet HTSAT file
through load_pretrained's surgery, and a SELD fine-tune
(experiment=starss23/finetune_maccdoa_augmix1) from its best file, and the
two L3DAS22 mono recipes (experiment=l3das22/finetune_maccdoa_ov1mono and
its AdapterBit form: K2/K3 and K4/K5) from it on clips the mono_adapter
spatialisation made; then data-parallel training (parallel/mesh.py): the
training steps on one NCCL rank against the same steps without a process
group, and on two gloo ranks sharing the card against one process on the
global batch; then tensor-parallel training (parallel/tp.py,
trainer.tensor_parallel=2: two gloo model ranks sharing the card, the
eager modules split by heads and MLP columns) against one process; then
the mic features (LogmelExtractor on 1 and 4 channels, GCC-PHAT,
SALSA-lite) on the card against the CPU. It checks the outputs, the
kernels' launch counts on each path and the kernel step against the plain
step, and prints the times.

    python3 chip_smoke.py

Needs one CUDA card and nvcc; exits non-zero without them. The last line of
standard output is {"ok": true, "device": {...}}; the line before it lists the
kernels with their launches, errors, times and bounds.
"""

import json
import math
import re
import shutil
import statistics
import subprocess
import sys
import time
import types
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# H100 SXM peaks at the 700 W limit (NVIDIA data sheet, dense)
PEAK_BYTES_S = 3.35e12
PEAK_BF16_FLOP_S = 989e12
PEAK_F32_FLOP_S = 67e12

B_CHECK = 4        # clips per batch in the kernel-vs-plain checks
B_SERVE = 32       # clips per batch on the served path
SERVE_BATCHES = 3  # timed batches on the served path
B_TRAIN = 32       # clips per training step (bench_train.py's B)
TRAIN_STEPS = 5    # timed training steps
N_SAMPLES = 240000  # 10 s at 24 kHz
# bench_train.py:56-58 in bf16, fused forward
TRAIN_OVERRIDES = ["loss=multi_accdoa", "model.kwargs.pretrained_path=null",
                   "model.kwargs.audioset_pretrain=false", "trainer.precision=bf16-mixed",
                   "trainer.fused_forward=true"]
ADAPT = ["adapt=adapter"]  # configs/adapt/adapter.yaml (bench_all.py adapterbit_train)
# configs/model/passt.yaml as bench_all.py:70-80 composes passt_maccdoa
PASST_OVERRIDES = ["model=passt", "loss=multi_accdoa", "model.kwargs.pretrained_path=null",
                   "model.kwargs.audioset_pretrain=false"]
# configs/model/crnn.yaml as bench_all.py:167-191 composes cnn14_accdoa
CRNN_OVERRIDES = ["model=crnn", "loss=accdoa", "model.kwargs.pretrained_path=null",
                  "model.kwargs.audioset_pretrain=false"]
# the CNN12 trunk's ConvBlocks at 10 s: (T, F, Cin, Cout)
CRNN_BLOCKS = ((1001, 64, 7, 64), (500, 32, 64, 128), (250, 16, 128, 256),
               (125, 8, 256, 512), (125, 4, 512, 1024), (125, 2, 1024, 2048))
PATHS = ("serve", "train", "serve_adapter", "train_adapter", "serve_passt", "serve_crnn",
         "serve_patch", "features_flat", "features_dif", "serve_passt128", "serve_htsat128",
         "serve_stage", "serve_einv2",
         "train_einv2", "train_passt", "train_crnn", "train_lora", "eval", "fit", "finetune",
         "train_ddp1", "train_ddp2", "train_tp2", "features_mic")
DEPTHS = (2, 2, 6, 2)  # HTSAT's Swin stages (configs/model/htsat.yaml)


def log(msg):
    print(msg, flush=True)


def check(ok, what):
    if not ok:
        raise AssertionError(what)


def cuda_ms(fn, reps):
    """Mean device time of fn() in ms over ``reps`` calls, after one warm-up."""
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_ms(fn, reps):
    """(device ms, host ms) of fn() a call, means over ``reps`` calls after
    one warm-up, the calls queued behind a kernel that sleeps while the host
    launches them: the device time without the host's cost a call, which
    cuda_ms includes where it is the longer (K8), and that host cost."""
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(100_000_000)  # ~60 ms at the card's clock
    start.record()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    host = (time.perf_counter() - t0) * 1e3 / reps
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps, host


def bound_ms(nbytes, f32_flops=0.0, bf16_flops=0.0):
    """Least time for the work: the larger of bytes over the memory rate and
    the operations over their peak rates; returns (ms, 'bytes'|'operations')."""
    t_bytes = nbytes / PEAK_BYTES_S
    t_ops = f32_flops / PEAK_F32_FLOP_S + bf16_flops / PEAK_BF16_FLOP_S
    return (max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations")


def phase_device():
    import torch

    if not torch.cuda.is_available():
        sys.stderr.write("chip_smoke: CUDA is not available\n")
        sys.exit(1)
    if not (ROOT / "pseldnets_tpu_torch" / "csrc").is_dir() or not (ROOT / "configs").is_dir():
        sys.stderr.write("chip_smoke: run from a checkout of the repository\n")
        sys.exit(1)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    log(f"card: {smi}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda}, "
        f"{torch.cuda.device_count()} device(s)")
    # the plain references: float32 products in full float32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return smi


def kernels():
    from pseldnets_tpu_torch.ops import (conv_block, frontend, frontend_forms, patch_embed,
                                         swin_block, swin_block_adapt, swin_block_vjp,
                                         swin_stage, vit_block)

    return {"K1": frontend.KERNEL, "K2": swin_block.KERNEL, "K3": swin_block_vjp.KERNEL,
            "K4": swin_block_adapt.FWD_KERNEL, "K5": swin_block_adapt.BWD_KERNEL,
            "K6": vit_block.KERNEL, "K7": conv_block.KERNEL, "K8": patch_embed.KERNEL,
            "K9": frontend_forms.FLAT_KERNEL, "K10": frontend_forms.DIF_KERNEL,
            "K11": swin_stage.KERNEL}


def zero_counts():
    for k in kernels().values():
        k.launches = 0


def read_counts():
    return {n: k.launches for n, k in kernels().items()}


def expected(**launches):
    """The launch counts a path should read: the given ones, 0 for every
    other kernel."""
    return {n: launches.get(n, 0) for n in kernels()}


def sass_text(name):
    """Kernel ``name``'s library as ``cuobjdump -sass`` prints it; None
    without cuobjdump."""
    from pseldnets_tpu_torch.ops import _cuda

    tool = shutil.which("cuobjdump") or str(Path(_cuda.nvcc()).parent / "cuobjdump")
    try:
        return subprocess.run([tool, "-sass", str(kernels()[name].library_path())],
                              capture_output=True, text=True, check=True).stdout
    except (OSError, subprocess.CalledProcessError):
        return None


def sass_counts(sass, own=None):
    """HGMMA/UTMALDG/UTMASTG/HMMA/FFMA counts in SASS text, in its functions
    matching ``own`` where given."""
    if own is not None:
        parts = re.split(r"Function : ", sass)[1:]
        sass = "".join(p for p in parts if re.search(own, p.split(None, 1)[0]))
    return {op: len(re.findall(rf"\b{op}\b", sass))
            for op in ("HGMMA", "UTMALDG", "UTMASTG", "HMMA", "FFMA")}


def phase_build():
    from pseldnets_tpu_torch.ops import _cuda

    secs = _cuda.build_all(list(kernels().values()))
    log(f"build: {secs:.1f} s (nvcc, sm_90a, one process per source)")
    for k in kernels().values():
        for line in k.build_log.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {k.source.name}: {line.strip()}")
    # what the Hopper kernels were compiled to: wgmma (HGMMA), TMA loads
    # (UTMALDG) and stores (UTMASTG) in K6's and K7's SASS; in K3's and K5's
    # wgmma and TMA loads (their epilogues store from the registers) and no
    # HMMA (mma.sync, what WMMA compiles to); in K2's and K11's the same,
    # counted in their own kernels (K2's GEMM fwd_gemm and attention, K11's
    # swin_stage_kernel), since their libraries also hold the backward
    # layer's kernels of the header they share; K4's the same as K2's (its
    # GEMMs fwd_gemm and fwd_gemm_two, the attention); K9's and K10's wgmma
    # and TMA loads, and under 512 FFMA in each of their two forms (narrow,
    # and wide: n_mels > 64), counted in each form's kernel (the former
    # float32 DFT loop's unrolled k step alone held 1024; an epilogue takes
    # a few hundred);
    # K8's bf16 kernel (patch_embed_wgmma) wgmma and TMA loads and stores
    for name, need, own in (("K6", ("HGMMA", "UTMALDG", "UTMASTG"), None),
                            ("K7", ("HGMMA", "UTMALDG", "UTMASTG"), None),
                            ("K3", ("HGMMA", "UTMALDG"), None), ("K5", ("HGMMA", "UTMALDG"), None),
                            ("K2", ("HGMMA", "UTMALDG"), r"fwd_gemm|attention_kernel"),
                            ("K4", ("HGMMA", "UTMALDG"), r"fwd_gemm|attention_kernel"),
                            ("K11", ("HGMMA", "UTMALDG"), r"swin_stage_kernel"),
                            ("K9", ("HGMMA", "UTMALDG"), None), ("K10", ("HGMMA", "UTMALDG"), None),
                            ("K8", ("HGMMA", "UTMALDG", "UTMASTG"), r"patch_embed_wgmma")):
        lib = kernels()[name].library_path()
        sass = sass_text(name)
        if sass is None:
            log(f"  {lib.name} SASS: not measured (no cuobjdump)")
            continue
        counts = sass_counts(sass)
        log(f"  {lib.name} SASS: " + ", ".join(f"{op} {n}" for op, n in counts.items()))
        if own is not None:  # the kernel's own functions only
            counts = sass_counts(sass, own)
            log(f"  {lib.name} SASS of its own kernels ({own}): "
                + ", ".join(f"{op} {n}" for op, n in counts.items()))
        check(all(counts[op] for op in need), f"{name}'s SASS lacks wgmma or TMA: {counts}")
        if name in ("K3", "K5", "K2", "K4", "K11"):
            check(counts["HMMA"] == 0, f"{name}'s SASS still has mma.sync (WMMA): {counts}")
        if name in ("K9", "K10"):
            for form, fn in (("narrow", r"logmel_iv_forms_kernelILb[01]ELb0E"),
                             ("wide", r"logmel_iv_forms_kernelILb[01]ELb1E")):
                counts = sass_counts(sass, fn)
                log(f"  {lib.name} SASS of its {form} form: "
                    + ", ".join(f"{op} {n}" for op, n in counts.items()))
                check(all(counts[op] for op in need) and counts["FFMA"] < 512,
                      f"{name}'s {form} form lacks wgmma or TMA or keeps an FFMA DFT loop: "
                      f"{counts}")


def phase_frontend():
    """K1 against its plain version at B_CHECK 10 s clips, in the three forms
    the paths use (training: float32, no folds; served HTSAT: affine, bf16,
    1024 frames; PaSST and CRNN: affine, bf16, 1001 frames), with a silent
    stretch; a second launch of each form gives equal bits."""
    import torch
    from pseldnets_tpu_torch.ops.frontend import fused_logmel_iv, fused_logmel_iv_plain

    g = torch.Generator(device="cuda").manual_seed(1)
    x = torch.randn(B_CHECK, 4, N_SAMPLES, device="cuda", generator=g) * 0.1
    x[-1, :, : N_SAMPLES // 4] = 0.0  # a silent stretch: IV must stay finite
    # float32 output, no folds: the repo's feature budget against float32
    got = fused_logmel_iv(x)
    ref = fused_logmel_iv_plain(x)
    check(got.shape == ref.shape == (B_CHECK, 7, 1001, 64), f"K1 shape {tuple(got.shape)}")
    check(bool(torch.isfinite(got).all()), "K1 output not finite")
    check(torch.equal(got, fused_logmel_iv(x)), "K1 float32: two launches differ")
    db = (got[:, :4] - ref[:, :4]).abs().max().item()
    iv = (got[:, 4:] - ref[:, 4:]).abs().max().item()
    log(f"K1 float32: max |dB| {db:.3g} (<= 8e-4), max |IV| {iv:.3g} (<= 7e-5), "
        f"two launches equal")
    check(db <= 8e-4 and iv <= 7e-5, "K1 float32 outside the feature budget")
    # serving forms: eval ScalarBN affine, bf16, zero tail to 1024 frames
    # (HTSAT) or none (PaSST, CRNN). Both sides round the same float32
    # values to bf16: at most one bf16 ulp apart (2^-7 of the magnitude, or
    # of 1 below 1)
    inv = torch.rand(7, 64, device="cuda", generator=g) + 0.5
    shift = torch.randn(7, 64, device="cuda", generator=g)
    for t_out in (1024, None):
        kw = dict(post_affine=(inv, shift), out_dtype=torch.bfloat16, t_out=t_out)
        got_s = fused_logmel_iv(x, **kw)
        ref_s = fused_logmel_iv_plain(x, **kw)
        frames = t_out or 1001
        check(got_s.shape == (B_CHECK, 7, frames, 64) and got_s.dtype == torch.bfloat16,
              "K1 serving form shape/dtype")
        check(bool((got_s[:, :, 1001:] == 0).all()), "K1 zero tail")
        check(bool(torch.isfinite(got_s.float()).all()), "K1 serving form not finite")
        check(torch.equal(got_s, fused_logmel_iv(x, **kw)), "K1 serving form: launches differ")
        rel = ((got_s.float() - ref_s.float()).abs()
               / ref_s.float().abs().clamp(min=1.0)).max().item()
        log(f"K1 serving form (affine, bf16, {frames} frames): max err {rel:.3g} of "
            f"max(|x|, 1) (<= 2^-7), two launches equal")
        check(rel <= 2.0 ** -7, "K1 serving form disagrees with its plain version")


def rfft_yardstick_ms(x, reps=10):
    """cuFFT's time for the FFT phase alone, as a yardstick beside K1:
    torch.fft.rfft of the windowed 1024-point frames of x (made beforehand,
    not timed); the port never calls it."""
    import torch
    from pseldnets_tpu_torch.ops.frontend_forms import padded_signal
    from pseldnets_tpu_torch.ops.windows import get_window

    win = torch.as_tensor(get_window("hann", 1024), dtype=torch.float32, device=x.device)
    n_frames = 1 + x.shape[-1] // 240
    frames = (padded_signal(x, 1024, 240).unfold(-1, 1024, 240)[..., :n_frames, :]
              * win).contiguous()
    ms = cuda_ms(lambda: torch.fft.rfft(frames), reps=reps)
    del frames
    return ms


def random_block(i, shift, merge, gen):
    """Stage-i full-width block (and PatchMerging) with seeded weights."""
    from pseldnets_tpu_torch.models.factory import init_weights
    from pseldnets_tpu_torch.models.htsat import PatchMerging, SwinTransformerBlock

    H, C, nh = 64 >> i, 96 << i, 4 << i
    blk = SwinTransformerBlock(C, (H, H), nh, 8, shift_size=shift)
    mrg = PatchMerging((H, H), C) if merge else None
    init_weights(blk, gen)
    if mrg is not None:
        init_weights(mrg, gen)
    return blk.cuda().eval(), (mrg.cuda().eval() if mrg is not None else None)


def phase_swin_block():
    """K2 against its plain version (bf16 and float32) at each stage shape,
    shifted and unshifted, with and without the merge fold; a second launch
    bitwise equal to the first."""
    import torch
    from pseldnets_tpu_torch.ops.swin_block import (prepare_block, swin_block_fused,
                                                    swin_block_plain)

    gen = torch.Generator().manual_seed(2)
    for i in range(4):
        shifts = (0, 4) if i < 3 else (0,)  # stage 3: one 8x8 window, no shift
        for shift in shifts:
            for merge in ((False, True) if i < 3 else (False,)):
                blk, mrg = random_block(i, shift, merge, gen)
                H, C = 64 >> i, 96 << i
                x = torch.randn(B_CHECK, H * H, C, generator=gen).cuda().bfloat16()
                p16 = prepare_block(blk, torch.bfloat16, mrg)
                p32 = prepare_block(blk, torch.float32, mrg)
                got = swin_block_fused(x, p16).float()
                again = swin_block_fused(x, p16).float()
                torch.cuda.synchronize()
                check(torch.equal(got, again), f"K2 stage {i}: two launches on one input differ")
                plain16 = swin_block_plain(x, p16).float()
                plain32 = swin_block_plain(x.float(), p32)
                scale = plain32.abs().max().item()
                e16 = (got - plain16).abs().max().item()
                e32 = (got - plain32).abs().max().item()
                p_e32 = (plain16 - plain32).abs().max().item()
                # bf16 vs its plain bf16 version: rounding points agree, one-
                # ulp flips propagate: <= 2 ulps at the largest magnitude.
                # vs float32: no worse than the plain bf16 version plus one ulp
                ok = e16 <= 2.0 ** -6 * scale and e32 <= 1.25 * p_e32 + 2.0 ** -7 * scale
                log(f"K2 stage {i} {H}x{H} C={C} shift={shift} merge={int(merge)}: "
                    f"|k-plain16| {e16:.3g} (<= {2.0 ** -6 * scale:.3g}), "
                    f"|k-plain32| {e32:.3g} (plain16 {p_e32:.3g}), scale {scale:.3g}")
                check(torch.isfinite(got).all().item() and ok,
                      f"K2 disagrees with its plain version at stage {i} shift {shift} "
                      f"merge {merge}")


def compare(name, got, plain16, plain32, rel_tol):
    """A bf16 kernel output against its plain bf16 and float32 versions:
    within rel_tol of the output's largest magnitude of the plain bf16 one,
    and no further from float32 than the plain bf16 version (x1.25 plus one
    bf16 ulp, 2^-7 of the scale). Returns the max abs error vs plain bf16."""
    import torch

    got, plain16, plain32 = got.float(), plain16.float(), plain32.float()
    scale = plain32.abs().max().item()
    e16 = (got - plain16).abs().max().item()
    e32 = (got - plain32).abs().max().item()
    p_e32 = (plain16 - plain32).abs().max().item()
    ok = (torch.isfinite(got).all().item() and e16 <= rel_tol * scale
          and e32 <= 1.25 * p_e32 + 2.0 ** -7 * scale)
    log(f"  {name:8s} |k-plain16| {e16:.3g} (<= {rel_tol * scale:.3g}), |k-plain32| "
        f"{e32:.3g} (plain16 {p_e32:.3g}), scale {scale:.3g}")
    check(ok, f"{name} disagrees with its plain version")
    return e16


def drop_masks(B):
    """(B, 2) drop-path scales with dropped branches: image 0 drops its MLP
    branch, image 1 its attention branch, the rest keep both (keep 0.9)."""
    import torch

    m = torch.full((B, 2), 1 / 0.9)
    m[0, 1] = m[1, 0] = 0.0
    return m.cuda()


def phase_swin_block_train():
    """K2 with drop-path masks and K3 against their plain versions (bf16 and
    float32) at each stage shape, shifted and unshifted; K2 with every mask
    zero gives its input back."""
    import torch
    from pseldnets_tpu_torch.ops.swin_block import (prepare_block, swin_block_fused,
                                                    swin_block_plain)
    from pseldnets_tpu_torch.ops.swin_block_vjp import (GRAD_KEYS, swin_block_backward,
                                                        swin_block_backward_plain)

    gen = torch.Generator().manual_seed(5)
    for i in range(4):
        for shift in ((0, 4) if i < 3 else (0,)):
            blk, _ = random_block(i, shift, False, gen)
            H, C = 64 >> i, 96 << i
            x = torch.randn(B_CHECK, H * H, C, generator=gen).cuda().bfloat16()
            dout = torch.randn(B_CHECK, H * H, C, generator=gen).cuda().bfloat16()
            m = drop_masks(B_CHECK)
            p16 = prepare_block(blk, torch.bfloat16)
            p32 = prepare_block(blk, torch.float32)
            log(f"training block, stage {i} {H}x{H} C={C} shift={shift}, masks with zeros:")
            got = swin_block_fused(x, p16, m)
            torch.cuda.synchronize()
            compare("K2 out", got, swin_block_plain(x, p16, m),
                    swin_block_plain(x.float(), p32, m), 2.0 ** -6)
            # every branch dropped: the block is the identity, exactly
            zero = swin_block_fused(x, p16, torch.zeros_like(m))
            check(torch.equal(zero, x), f"K2 with zero masks at stage {i} is not the identity")
            dx, g = swin_block_backward(x, p16, m, dout)
            torch.cuda.synchronize()
            dx16, g16 = swin_block_backward_plain(x, p16, m, dout)
            dx32, g32 = swin_block_backward_plain(x.float(), p32, m, dout.float())
            # K3 vs its plain bf16 version: rounding points agree, one-ulp
            # flips of bf16 intermediates propagate into the float32 sums
            compare("K3 dx", dx, dx16, dx32, 2.0 ** -6)
            for k in GRAD_KEYS:
                compare(f"K3 {k}", g[k], g16[k], g32[k], 2.0 ** -6)


def k1_work(B, n_fft=1024, hop=240, t_out=1024, out_bytes=2, affine=True, n_mels=64):
    """Bytes and float32 FLOPs of the frontend's function (K1, and K9 and
    K10 at their shapes) on B 10 s clips: per frame and channel the window
    and a real FFT of n_fft (2.5 n log2 n FLOPs), then power, the normalized
    IV and the mel projection on non-zero weights, of the n_frames real
    frames; waveform, filterbank, window and affine read once, the output
    (t_out frames of n_mels, out_bytes each) written once. The function's
    bound, not the algorithm's: a DFT as a GEMM does far more."""
    from pseldnets_tpu_torch.ops.features import logmel_iv_filterbank

    n_frames, n_freqs = 1 + N_SAMPLES // hop, n_fft // 2 + 1
    fb = logmel_iv_filterbank(24000, n_fft, n_mels)
    nnz = int((fb != 0).sum())
    fft = n_fft + 2.5 * n_fft * math.log2(n_fft)
    per_frame = 4 * fft + 4 * n_freqs * 3 + n_freqs * 15 + 7 * nnz * 2
    nbytes = (B * 4 * N_SAMPLES * 4 + B * 7 * t_out * n_mels * out_bytes
              + fb.size * 4 + n_fft * 4 + (2 * 7 * n_mels * 4 if affine else 0))
    return nbytes, B * n_frames * per_frame


def k2_work(B, p):
    """Bytes and bf16 FLOPs of one K2 call on B images."""
    L, C, hidden = p.H * p.W, p.C, p.fc1_w.shape[1]
    M = B * L
    flops = 2 * M * (C * 3 * C + C * C + C * hidden + hidden * C) + 4 * M * 64 * C
    out_bytes = M * C * 2
    w_bytes = sum(t.numel() * t.element_size() for t in
                  (p.qkv_w, p.proj_w, p.fc1_w, p.fc2_w, p.bias, p.qkv_b, p.proj_b,
                   p.fc1_b, p.fc2_b, p.ln1_w, p.ln1_b, p.ln2_w, p.ln2_b))
    if p.mask is not None:
        w_bytes += p.mask.numel() * 4
    if p.merge:
        flops += 2 * (M // 4) * 4 * C * 2 * C
        out_bytes = (M // 4) * 2 * C * 2
        w_bytes += p.merge_w.numel() * 2 + 2 * 4 * C * 4
    return M * C * 2 + out_bytes + w_bytes, flops


def k3_work(B, p, masked=False):
    """Bytes and bf16 FLOPs of one K3 call on B images: the forward the
    backward needs (qkv, proj, fc1: 2M(3C^2 + C^2 + C hid); attention
    4M 64C), the activation grads (2M(hid C + C hid + C^2 + 3C^2)), the
    weight grads (the same) and the attention backward (dV, dP, dq, dk:
    8M 64C); x and dout read, dx written, the bf16 weights and float32
    vectors read, every float32 grad written, once each. ``masked``: the
    training form with frozen weights (AdapterBit's): no weight grads, no
    LayerNorm-scale or bias-table grads written."""
    L, C, hid = p.H * p.W, p.C, p.fc1_w.shape[1]
    M = B * L
    grads = C * 3 * C + C * C + C * hid + hid * C
    flops = 2 * M * (4 * C * C + C * hid) + 2 * 2 * M * grads + 12 * M * 64 * C
    w_bytes = sum(t.numel() * t.element_size() for t in
                  (p.qkv_w, p.proj_w, p.fc1_w, p.fc2_w, p.bias, p.qkv_b, p.proj_b,
                   p.fc1_b, p.fc2_b, p.ln1_w, p.ln1_b, p.ln2_w, p.ln2_b))
    if p.mask is not None:
        w_bytes += p.mask.numel() * 4
    g_bytes = 4 * (grads + 3 * C + C + hid + C + 4 * C + p.bias.numel())
    if masked:
        flops -= 2 * M * grads
        g_bytes -= 4 * (grads + 2 * C + p.bias.numel())
    return 3 * M * C * 2 + B * 2 * 4 + w_bytes + g_bytes, flops


def k35_phase_flops(B, p, ch=0, masked=False):
    """bf16 FLOPs of K3 (ch 0) or K5 (adapter width ch) by phase, as
    scripts/torch_k35_phases.py groups the launches: the recompute GEMMs
    (qkv, proj, the spatial adapter), the dual GEMMs (fc1 with fc2's grad,
    the adapters' two), the activation grads (dh2, the spatial adapter's,
    dattn, dh), the weight grads (none in the masked form, whose frozen
    weights keep only the adapters'), the attention recompute (S, P V) and
    backward (S, dV, dP, dq, dk)."""
    L, C, hid = p.H * p.W, p.C, p.fc1_w.shape[1]
    M = B * L
    wg = 2 * M * (3 * C * C + C * C + 2 * C * hid)
    return {"recompute": 2 * M * (4 * C * C + 2 * C * ch),
            "mlp_dual": 4 * M * C * hid + 8 * M * C * ch,
            "act_grad": 2 * M * (hid * C + 4 * C * C + 2 * ch * C),
            "weight_grad": (0 if masked else wg) + 8 * M * C * ch,
            "attn_fwd": 4 * M * 64 * C, "attn_bwd": 10 * M * 64 * C}


def log_phases(name, recorded, B, flops_of, smi):
    """``name`` by phase over one step's 12 recorded block backwards (each
    launched as the step launched it; torch.profiler): ms x12 and the GEMM
    and attention phases' TFLOP/s. Returns {phase: ms}."""
    from pseldnets_tpu_torch.ops.swin_bwd_plan import phases_ms

    ms, fl = {}, {}
    for fn, args in recorded:
        for k, v in phases_ms(fn, reps=3).items():
            ms[k] = ms.get(k, 0.0) + v
        for k, v in flops_of(args).items():
            fl[k] = fl.get(k, 0) + v
    log(f"{name} by phase x12 at B={B} ({smi}): " + ", ".join(
        f"{k} {v:.3f} ms" + (f" ({fl[k] / v / 1e9:.0f} TFLOP/s)" if fl.get(k) else "")
        for k, v in sorted(ms.items(), key=lambda kv: -kv[1])) + f"; sum {sum(ms.values()):.3f} ms")
    return {k: round(v, 5) for k, v in ms.items()}


def htsat_serving_model():
    """HTSAT mACCDOA at full published width (bench.py's config), seeded
    random weights, non-trivial eval ScalarBN statistics, on the card."""
    import torch
    from pseldnets_tpu_torch.config import compose
    from pseldnets_tpu_torch.models import build_model

    cfg = compose(str(ROOT / "configs"), "train",
                  ["loss=multi_accdoa", "model.kwargs.pretrained_path=null"])
    model, _ = build_model(cfg, 13, device="cuda", seed=0)
    gen = torch.Generator().manual_seed(3)
    with torch.no_grad():  # non-trivial eval ScalarBN statistics
        model.scalar.running_mean.copy_(torch.randn(7, 64, generator=gen) * 5.0 - 20.0)
        model.scalar.running_var.copy_(torch.rand(7, 64, generator=gen) * 50.0 + 10.0)
    return model


def phase_serve(smi):
    import torch
    from pseldnets_tpu_torch.ops import swin_block
    from pseldnets_tpu_torch.ops.patch_embed import patch_embed_tokens
    from pseldnets_tpu_torch.serving import (folded_wav_features, htsat_fused_forward_from_wav,
                                             prepare_blocks, prepare_patch_embed)

    model = htsat_serving_model()
    blocks = prepare_blocks(model.encoder, torch.bfloat16)
    embed = prepare_patch_embed(model.encoder, torch.bfloat16)
    check(len(blocks) == 12 and sum(p.merge for p in blocks) == 3, "block plan")
    g = torch.Generator(device="cuda").manual_seed(4)
    wavs = [torch.randn(B_SERVE, 4, N_SAMPLES, device="cuda", generator=g) * 0.1
            for _ in range(SERVE_BATCHES)]
    serve = lambda w: htsat_fused_forward_from_wav(  # noqa: E731
        model, w, blocks=blocks, embed=embed)
    serve(wavs[0])  # warm-up
    torch.cuda.synchronize()

    # the main path: counts from 0, SERVE_BATCHES batches
    zero_counts()
    t0 = time.perf_counter()
    outs = [serve(w)["multi_accdoa"] for w in wavs]
    torch.cuda.synchronize()
    dt = (time.perf_counter() - t0) / SERVE_BATCHES
    launches = read_counts()
    want = expected(K1=SERVE_BATCHES, K8=SERVE_BATCHES, K2=12 * SERVE_BATCHES)
    log(f"served {SERVE_BATCHES} batches of {B_SERVE} x 10 s clips: launches {launches} "
        f"(expect {want})")
    check(launches == want, "launch counts")
    for o in outs:
        check(o.shape == (B_SERVE, 100, 117) and o.dtype == torch.float32, f"shape {o.shape}")
        check(bool(torch.isfinite(o).all()), "served output not finite")
    log(f"served: {dt * 1e3:.2f} ms/batch, {B_SERVE / dt:.1f} clips/s "
        f"(host clock, synchronized; {smi})")

    # the same path with the plain versions on the card
    plain = htsat_fused_forward_from_wav(model, wavs[0], blocks=blocks,
                                         use_kernels=False)["multi_accdoa"]
    f32 = htsat_fused_forward_from_wav(model, wavs[0], compute_dtype=torch.float32,
                                       use_kernels=False)["multi_accdoa"]
    e_plain = (outs[0] - plain).abs().max().item()
    e_f32 = (outs[0] - f32).abs().max().item()
    p_f32 = (plain - f32).abs().max().item()
    log(f"served vs plain bf16 path: max |d| {e_plain:.3g} (<= 5e-2); vs float32 "
        f"plain path {e_f32:.3g} (plain bf16 {p_f32:.3g}); output std "
        f"{f32.std().item():.3g}")
    check(e_plain <= 5e-2, "served output disagrees with the plain path")
    check(e_f32 <= 1.25 * p_f32 + 1e-2, "served output further from float32 than plain bf16")

    # each kernel against its plain version on the served batch's own inputs,
    # with the tolerances of phase_frontend and phase_swin_block, and timed
    wav = wavs[0]
    feats = folded_wav_features(model, wav, t_out=1024)
    ref = folded_wav_features(model, wav, t_out=1024, use_kernels=False).float()
    k1_err = (feats.float() - ref).abs().max().item()
    k1_rel = k1_err / ref.abs().max().item()
    rel = ((feats.float() - ref).abs() / ref.abs().clamp(min=1.0)).max().item()
    log(f"K1 at B={B_SERVE} (served form): max |d| {k1_err:.3g}, max err {rel:.3g} of "
        f"max(|x|, 1) (<= 2^-7)")
    check(rel <= 2.0 ** -7, f"K1 disagrees with its plain version at B={B_SERVE}")
    k1 = cuda_ms(lambda: folded_wav_features(model, wav, t_out=1024), reps=10)
    k1_plain = cuda_ms(lambda: folded_wav_features(model, wav, t_out=1024,
                                                   use_kernels=False), reps=3)
    with torch.no_grad():
        xs = [patch_embed_tokens(feats, embed)]
        for p in blocks[:-1]:
            xs.append(swin_block.swin_block_fused(xs[-1], p))
    k2_rows, k2_err, k2_rel = [], 0.0, 0.0
    for i, (x, p) in enumerate(zip(xs, blocks)):
        ref = swin_block.swin_block_plain(x, p).float()
        scale = ref.abs().max().item()
        err = (swin_block.swin_block_fused(x, p).float() - ref).abs().max().item()
        check(err <= 2.0 ** -6 * scale,
              f"K2 block {i} disagrees with its plain version at B={B_SERVE}")
        k2_err, k2_rel = max(k2_err, err), max(k2_rel, err / scale)
        t = cuda_ms(lambda: swin_block.swin_block_fused(x, p), reps=5)
        tp = cuda_ms(lambda: swin_block.swin_block_plain(x, p), reps=2)
        nb, fl = k2_work(B_SERVE, p)
        k2_rows.append((t, tp, bound_ms(nb, bf16_flops=fl)[0]))
        log(f"  K2 block {i:2d} {p.H}x{p.W} C={p.C} shift={p.shift} merge={int(p.merge)}: "
            f"|k-plain| {err:.3g} (<= {2.0 ** -6 * scale:.3g}), {t:.3f} ms, "
            f"plain {tp:.3f} ms, bound {k2_rows[-1][2]:.4f} ms")
    nb1, fl1 = k1_work(B_SERVE)
    k1_bound, k1_by = bound_ms(nb1, f32_flops=fl1)
    rfft_ms = rfft_yardstick_ms(wav)
    log(f"K1 at B={B_SERVE}: {k1:.4f} ms, bound {k1_bound:.4f} ms by {k1_by}; cuFFT rfft of "
        f"its {B_SERVE * 4 * 1001} windowed frames alone (yardstick) {rfft_ms:.4f} ms ({smi})")
    b128 = serve_b128("served", serve, model, smi)
    k2_ms = sum(r[0] for r in k2_rows)
    k2_plain = sum(r[1] for r in k2_rows)
    k2_bound = sum(r[2] for r in k2_rows)
    log(f"per batch of {B_SERVE} ({smi}): K1 {k1:.3f} ms (plain {k1_plain:.3f}, bound "
        f"{k1_bound:.3f}), K2 x12 {k2_ms:.3f} ms (plain {k2_plain:.3f}, bound "
        f"{k2_bound:.3f}), rest {dt * 1e3 - k1 - k2_ms:.3f} ms")
    phase_profile("one served batch", lambda: serve(wav))
    return launches, {"K1": (k1_err, k1_rel, k1, k1_plain, k1_bound, k1_by, None, None,
                             {"cufft_rfft_ms": rfft_ms, "served_b128": b128}),
                      "K2": (k2_err, k2_rel, k2_ms, k2_plain, k2_bound, "operations")}


def serve_b128(label, serve, model, smi, B=128, shapes=None):
    """One batch of ``serve`` (a served HTSAT path, waveform -> outputs) at
    bench.py's B=128 (after a warm-up batch), outside the counted paths: the
    batch and K1 alone, ms and clips/s, logged as "<label> at B=128".
    ``shapes``: each output's shape after (B, 100) (mACCDOA's 117 by
    default)."""
    import torch
    from pseldnets_tpu_torch.serving import folded_wav_features

    g = torch.Generator(device="cuda").manual_seed(128)
    wav = torch.randn(B, 4, N_SAMPLES, device="cuda", generator=g) * 0.1
    with torch.no_grad():
        out = serve(wav)
        for key, shape in (shapes or {"multi_accdoa": (117,)}).items():
            check(out[key].shape == (B, 100) + shape and bool(torch.isfinite(out[key]).all()),
                  f"{label} output {key} at B={B}")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        serve(wav)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        k1 = cuda_ms(lambda: folded_wav_features(model, wav, t_out=1024), reps=5)
    nb, fl = k1_work(B)
    bound = bound_ms(nb, f32_flops=fl)[0]
    log(f"{label} at B={B}: {dt * 1e3:.3f} ms/batch, {B / dt:.1f} clips/s (host clock, one "
        f"batch after a warm-up); K1 {k1:.4f} ms (bound {bound:.4f}) ({smi})")
    del wav, out
    return {"batch_ms": dt * 1e3, "clips_per_s": B / dt, "k1_ms": k1, "k1_bound_ms": bound}


def make_labels(rng, B, T_label, K_cls=13):
    """bench_train.py::make_labels: one active source per frame, random
    class and unit DOA, on track A."""
    import numpy as np

    adpit = np.zeros((B, T_label, 6, 4, K_cls), np.float32)
    cls = rng.integers(0, K_cls, (B, T_label))
    doa = rng.standard_normal((B, T_label, 3)).astype(np.float32)
    doa /= np.linalg.norm(doa, axis=-1, keepdims=True)
    bi, ti = np.meshgrid(np.arange(B), np.arange(T_label), indexing="ij")
    adpit[bi, ti, 0, 0, cls] = 1.0
    for ax in range(3):
        adpit[bi, ti, 0, 1 + ax, cls] = doa[..., ax]
    return adpit


def hold_k1_train(task, wav):
    """K1 in its training form (unfolded, float32) on a step's waveforms
    against its plain version, with phase_frontend's feature budget (8e-4
    dB, 7e-5 IV). -> (max |d|, of scale)."""
    import torch
    from pseldnets_tpu_torch.ops.frontend import fused_logmel_iv_plain

    feats = task.extractor(wav)
    ref = fused_logmel_iv_plain(wav)
    B = wav.shape[0]
    check(feats.shape == ref.shape == (B, 7, 1001, 64) and feats.dtype == torch.float32,
          f"K1 training form shape {tuple(feats.shape)}")
    db = (feats[:, :4] - ref[:, :4]).abs().max().item()
    iv = (feats[:, 4:] - ref[:, 4:]).abs().max().item()
    log(f"K1 at B={B} (training form, float32): max |dB| {db:.3g} (<= 8e-4), "
        f"max |IV| {iv:.3g} (<= 7e-5)")
    check(torch.isfinite(feats).all().item() and db <= 8e-4 and iv <= 7e-5,
          f"K1 training form disagrees with its plain version at B={B}")
    return max(db, iv), max(db / ref[:, :4].abs().max().item(),
                            iv / ref[:, 4:].abs().max().item())


def record_block_backwards(task, wav, labels, seed, feats=None):
    """The inputs of every K3 call of one ``task.compute_grads`` on (wav,
    labels), or of one ``task.grads_on`` on given augmented (features,
    labels) ``feats``, drop-path masks drawn from ``seed``: [(x, p,
    masks, dout, want)], the step asking for every grad."""
    import torch
    from pseldnets_tpu_torch.ops import swin_block_vjp

    recorded = []
    orig = swin_block_vjp.swin_block_backward

    def record(x, p, m, dout, want=None):
        recorded.append((x, p, m, dout, want))
        return orig(x, p, m, dout, want)

    swin_block_vjp.swin_block_backward = record
    gen = torch.Generator(device="cuda").manual_seed(seed)
    try:
        if feats is None:
            task.compute_grads(wav, labels, gen)
        else:
            task.grads_on(*feats, gen)
    finally:
        swin_block_vjp.swin_block_backward = orig
    check(len(recorded) == 12, f"recorded {len(recorded)} block backwards")
    check(all(set(r[4]) == set(swin_block_vjp.GRAD_KEYS) for r in recorded),
          "the plain step asks K3 for every grad")
    return recorded


def hold_train_block(x, p, m, dout, j):
    """K2 with masks and K3 on one block's recorded training inputs
    against their plain versions, each within 2^-6 of the plain output's
    scale (phase_swin_block's rule). -> (K2 max |d|, of scale, K3 max |d|,
    worst of scale over dx and the grads)."""
    import torch
    from pseldnets_tpu_torch.ops import swin_block_vjp

    B = x.shape[0]
    y = swin_block_vjp.swin_block_fused(x, p, m).float()
    y0 = swin_block_vjp.swin_block_plain(x, p, m).float()
    e2, s = (y - y0).abs().max().item(), y0.abs().max().item()
    check(torch.isfinite(y).all().item() and e2 <= 2.0 ** -6 * s,
          f"K2 with masks, block {j}, disagrees at B={B}")
    dx, gr = swin_block_vjp.swin_block_backward(x, p, m, dout)
    dx0, g0 = swin_block_vjp.swin_block_backward_plain(x, p, m, dout)
    e3 = worst = 0.0
    for name, a, b in [("dx", dx, dx0)] + [(k, gr[k], g0[k]) for k in gr]:
        e = (a.float() - b.float()).abs().max().item()
        sc = b.float().abs().max().item()
        check(e <= 2.0 ** -6 * sc, f"K3 block {j} {name} disagrees at B={B}")
        e3, worst = max(e3, e), max(worst, e / sc)
    return e2, e2 / s, e3, worst


def phase_train(smi):
    """Full-width B=32 training steps through SELDTask (kernels K1, K2 with
    masks, K3), the kernel step against the plain step, K3 on the step's own
    block inputs, and a profile of one step."""
    import numpy as np
    import torch
    from pseldnets_tpu_torch.config import compose
    from pseldnets_tpu_torch.ops import swin_block_vjp
    from pseldnets_tpu_torch.train.module import DatasetSpec, SELDTask

    cfg = compose(str(ROOT / "configs"), "train", TRAIN_OVERRIDES)
    task = SELDTask(cfg, DatasetSpec(num_classes=13), steps_per_epoch=100, device="cuda")
    check(task.fused_forward and task.compute_dtype == torch.bfloat16, "training configuration")
    task.init_state(0)
    g = torch.Generator(device="cuda").manual_seed(6)
    wavs = [torch.randn(B_TRAIN, 4, N_SAMPLES, device="cuda", generator=g) * 0.1
            for _ in range(TRAIN_STEPS)]
    labels = {"adpit_label": torch.from_numpy(make_labels(np.random.default_rng(0), B_TRAIN,
                                                          100)).cuda()}
    gen = torch.Generator(device="cuda").manual_seed(7)
    step = lambda w: task.train_step(w, labels, gen)  # noqa: E731
    step(wavs[0])  # warm-up
    torch.cuda.synchronize()

    # the main path: counts from 0, TRAIN_STEPS steps
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    t0 = time.perf_counter()
    losses = [step(w)["loss_all"] for w in wavs]
    torch.cuda.synchronize()
    dt = (time.perf_counter() - t0) / TRAIN_STEPS
    launches = read_counts()
    log(f"peak device memory over the steps {torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB")
    want = expected(K1=TRAIN_STEPS, K2=12 * TRAIN_STEPS, K3=12 * TRAIN_STEPS)
    log(f"trained {TRAIN_STEPS} steps of {B_TRAIN} x 10 s clips: launches {launches} "
        f"(expect {want}); losses {[round(float(v), 6) for v in losses]}")
    check(launches == want, "training launch counts")
    check(all(np.isfinite(float(v)) for v in losses), "training loss not finite")
    log(f"training: {dt * 1e3:.2f} ms/step, {B_TRAIN / dt:.1f} clips/s "
        f"(host clock, synchronized; {smi})")

    # one kernel step against one plain step (bf16) and one float32 plain
    # step, from the same parameters, batch and drop-path masks
    def grads_with(use_kernels, dtype):
        task.set_use_kernels(use_kernels)
        task.compute_dtype = dtype
        losses, grads, _ = task.compute_grads(wavs[0], labels,
                                              torch.Generator(device="cuda").manual_seed(8))
        return losses["loss_all"].float().reshape(1), grads

    lk, gk = grads_with(True, torch.bfloat16)
    lp, gp = grads_with(False, torch.bfloat16)
    lf, gf = grads_with(False, torch.float32)
    task.set_use_kernels(True)
    task.compute_dtype = torch.bfloat16
    log(f"kernel step vs plain step: loss {lk.item():.6f} (plain bf16 {lp.item():.6f}, "
        f"float32 {lf.item():.6f})")
    compare("loss", lk, lp, lf, 2.0 ** -6)
    worst = 0.0
    for name, a, b, c in zip(task.trained_names, gk, gp, gf):
        worst = max(worst, compare(name[-36:], a, b, c, 2.0 ** -4)
                    / max(c.abs().max().item(), 1e-30))
    log(f"every parameter grad within {worst:.3g} of its scale of the plain step's")

    # K1 in its training form (unfolded, float32) on the step's own B=32
    # waveforms, with phase_frontend's feature budget, and timed
    wav = wavs[0]
    k1_err, k1_rel = hold_k1_train(task, wav)
    k1_ms = cuda_ms(lambda: task.extractor(wav), reps=10)

    # K3 on the step's own B=32 block inputs, recorded from one step
    recorded = record_block_backwards(task, wavs[1], labels, 9)
    orig = swin_block_vjp.swin_block_backward
    k2_err = k2_rel = k3_err = k3_rel = 0.0
    rows = []
    for j, (x, p, m, dout, _) in enumerate(reversed(recorded)):
        e2, k2_block_rel, e3, worst_rel = hold_train_block(x, p, m, dout, j)
        k2_err, k2_rel = max(k2_err, e2), max(k2_rel, k2_block_rel)
        k3_err, k3_rel = max(k3_err, e3), max(k3_rel, worst_rel)
        t = cuda_ms(lambda: orig(x, p, m, dout), reps=5)
        tp = cuda_ms(lambda: swin_block_vjp.swin_block_backward_plain(x, p, m, dout), reps=1)
        t2 = cuda_ms(lambda: swin_block_vjp.swin_block_fused(x, p, m), reps=5)
        nb, fl = k3_work(B_TRAIN, p)
        rows.append((t, tp, bound_ms(nb, bf16_flops=fl)[0], t2))
        log(f"  K3 block {j:2d} {p.H}x{p.W} C={p.C} shift={p.shift}: worst {worst_rel:.3g} of "
            f"scale, {t:.3f} ms, plain {tp:.3f} ms, bound {rows[-1][2]:.4f} ms; K2 with "
            f"masks {k2_block_rel:.3g} of scale (<= 2^-6), {t2:.3f} ms")
    k3_ms, k3_plain, k3_bound = (sum(r[i] for r in rows) for i in range(3))
    k2_train = sum(r[3] for r in rows)
    log(f"per step of {B_TRAIN} ({smi}): K1 (float32) {k1_ms:.3f} ms, K2 with masks x12 "
        f"{k2_train:.3f} ms, K3 x12 {k3_ms:.3f} ms (plain {k3_plain:.3f}, bound "
        f"{k3_bound:.3f}), rest {dt * 1e3 - k1_ms - k2_train - k3_ms:.3f} ms")
    phases = log_phases("K3", [((lambda r=r: orig(*r)), r) for r in recorded], B_TRAIN,
                        lambda r: k35_phase_flops(B_TRAIN, r[1]), smi)
    phase_profile("one training step", lambda: step(wavs[0]))
    return launches, {"K1": (k1_err, k1_rel), "K2": (k2_err, k2_rel),
                      "K3": (k3_err, k3_rel, k3_ms, k3_plain, k3_bound, "operations", None,
                             None, {"phases_ms_x12": phases})}


def randomize_adapters(model, gen):
    """Seeded random values in every adapter leaf, standing for a tuned
    AdapterBit checkpoint (a zero fc2, the init, would hide wiring faults):
    weights N(0, 1/fan_in) clamped at 2 sigma, biases N(0, 0.02)."""
    import torch
    from pseldnets_tpu_torch.models.adapters import Adapter

    with torch.no_grad():
        for ad in [m for m in model.modules() if isinstance(m, Adapter)]:
            for fc in (ad.fc1, ad.fc2):
                w = torch.randn(fc.weight.shape, generator=gen).clamp_(-2, 2)
                fc.weight.copy_(w / math.sqrt(fc.weight.shape[1]))
                fc.bias.copy_(0.02 * torch.randn(fc.bias.shape, generator=gen))


def adapt_config():
    from pseldnets_tpu_torch.config import compose
    from pseldnets_tpu_torch.models.adapters import AdaptConfig

    return AdaptConfig(compose(str(ROOT / "configs"), "train", ADAPT)["adapt"])


def phase_swin_block_adapt():
    """K4 with drop-path masks and K5 against their plain versions (bf16 and
    float32) at each stage shape, shifted and unshifted, random adapters
    (stage 0: the 48-wide adapter, padded to 64)."""
    import torch
    from pseldnets_tpu_torch.models.factory import init_weights
    from pseldnets_tpu_torch.models.htsat import SwinTransformerBlock
    from pseldnets_tpu_torch.ops import swin_block_adapt as sa

    gen = torch.Generator().manual_seed(11)
    adapt = adapt_config()
    for i in range(4):
        for shift in ((0, 4) if i < 3 else (0,)):
            H, C, nh = 64 >> i, 96 << i, 4 << i
            blk = SwinTransformerBlock(C, (H, H), nh, 8, shift_size=shift, adapt=adapt)
            init_weights(blk, gen)
            randomize_adapters(blk, gen)
            blk.cuda()
            x = torch.randn(B_CHECK, H * H, C, generator=gen).cuda().bfloat16()
            dout = torch.randn(B_CHECK, H * H, C, generator=gen).cuda().bfloat16()
            m = drop_masks(B_CHECK)
            p16 = sa.prepare_adapt_block(blk, torch.bfloat16)
            p32 = sa.prepare_adapt_block(blk, torch.float32)
            log(f"adapter block, stage {i} {H}x{H} C={C} adapter {p16.ch} (padded "
                f"{p16.ch_pad}) shift={shift}, masks with zeros:")
            got = sa.swin_block_adapt_fused(x, p16, m)
            torch.cuda.synchronize()
            compare("K4 out", got, sa.swin_block_adapt_plain(x, p16, m),
                    sa.swin_block_adapt_plain(x.float(), p32, m), 2.0 ** -6)
            dx, g = sa.swin_block_adapt_backward(x, p16, m, dout)
            torch.cuda.synchronize()
            dx16, g16 = sa.swin_block_adapt_backward_plain(x, p16, m, dout)
            dx32, g32 = sa.swin_block_adapt_backward_plain(x.float(), p32, m, dout.float())
            check(set(g) == set(g16) == set(g32) and len(g) == 21, "K5 grad keys")
            compare("K5 dx", dx, dx16, dx32, 2.0 ** -6)
            for k in g16:
                compare(f"K5 {k}", g[k], g16[k], g32[k], 2.0 ** -6)


def k4_work(B, p):
    """Bytes and bf16 FLOPs of one K4 call on B images: K2's (no merge) plus
    the two adapters' four GEMMs (8 M C ch, 4 M C^2 at ch = C/2) and their
    weights, at the true adapter width ch."""
    nbytes, flops = k2_work(B, p.base)
    M, C, ch = B * p.base.H * p.base.W, p.base.C, p.ch
    return nbytes + 2 * (2 * C * ch * 2 + (ch + C) * 4), flops + 8 * M * C * ch


def k5_work(B, p, masked=False):
    """Bytes and bf16 FLOPs of one K5 call on B images: K3's plus the
    adapters' recompute, activation grads and weight grads (3 x 8 M C ch,
    12 M C^2 at ch = C/2), their weights read and float32 grads written.
    ``masked``: AdapterBit's training form, k3_work's masked form plus the
    adapters' work (all of it trains)."""
    nbytes, flops = k3_work(B, p.base, masked)
    M, C, ch = B * p.base.H * p.base.W, p.base.C, p.ch
    return (nbytes + 2 * (2 * C * ch * 2 + (ch + C) * 4) + 2 * (2 * C * ch + ch + C) * 4,
            flops + 24 * M * C * ch)


def adapter_model(seed):
    """The full-width AdapterBit mACCDOA model on the card, seeded, with
    random adapters and non-trivial eval ScalarBN statistics."""
    import torch
    from pseldnets_tpu_torch.config import compose
    from pseldnets_tpu_torch.models import build_model

    cfg = compose(str(ROOT / "configs"), "train",
                  ["loss=multi_accdoa", "model.kwargs.pretrained_path=null"] + ADAPT)
    model, _ = build_model(cfg, 13, device="cuda", seed=0)
    gen = torch.Generator().manual_seed(seed)
    randomize_adapters(model, gen)
    with torch.no_grad():
        model.scalar.running_mean.copy_(torch.randn(7, 64, generator=gen).cuda() * 5.0 - 20.0)
        model.scalar.running_var.copy_(torch.rand(7, 64, generator=gen).cuda() * 50.0 + 10.0)
    return model


def phase_serve_adapter(smi):
    """AdapterBit serving: SERVE_BATCHES batches of B_SERVE 10 s clips through
    htsat_fused_forward_from_wav (K1, K8, then K4 on every block,
    PatchMerging unfolded), the output against the plain path, K4 on the
    batch's own block inputs, one batch at B=128, and a profile."""
    import torch
    from pseldnets_tpu_torch.ops import swin_block_adapt as sa
    from pseldnets_tpu_torch.ops.patch_embed import patch_embed_tokens
    from pseldnets_tpu_torch.serving import (folded_wav_features, htsat_fused_forward_from_wav,
                                             prepare_blocks, prepare_patch_embed)
    from pseldnets_tpu_torch.serving.htsat import patch_merging

    model = adapter_model(12)
    blocks = prepare_blocks(model.encoder, torch.bfloat16)
    embed = prepare_patch_embed(model.encoder, torch.bfloat16)
    check(len(blocks) == 12 and all(isinstance(p, sa.AdaptBlockParams) for p in blocks)
          and blocks[0].ch == 48 and blocks[0].ch_pad == 64, "adapter block plan")
    g = torch.Generator(device="cuda").manual_seed(13)
    wavs = [torch.randn(B_SERVE, 4, N_SAMPLES, device="cuda", generator=g) * 0.1
            for _ in range(SERVE_BATCHES)]
    serve = lambda w: htsat_fused_forward_from_wav(  # noqa: E731
        model, w, blocks=blocks, embed=embed)
    serve(wavs[0])  # warm-up
    torch.cuda.synchronize()

    # the main path: counts from 0, SERVE_BATCHES batches
    zero_counts()
    t0 = time.perf_counter()
    outs = [serve(w)["multi_accdoa"] for w in wavs]
    torch.cuda.synchronize()
    dt = (time.perf_counter() - t0) / SERVE_BATCHES
    launches = read_counts()
    want = expected(K1=SERVE_BATCHES, K8=SERVE_BATCHES, K4=12 * SERVE_BATCHES)
    log(f"AdapterBit: served {SERVE_BATCHES} batches of {B_SERVE} x 10 s clips: launches "
        f"{launches} (expect {want})")
    check(launches == want, "AdapterBit serving launch counts")
    for o in outs:
        check(o.shape == (B_SERVE, 100, 117) and torch.isfinite(o).all().item(),
              f"AdapterBit served output {tuple(o.shape)}")
    log(f"AdapterBit served: {dt * 1e3:.2f} ms/batch, {B_SERVE / dt:.1f} clips/s "
        f"(host clock, synchronized; {smi})")
    plain = htsat_fused_forward_from_wav(model, wavs[0], blocks=blocks,
                                         use_kernels=False)["multi_accdoa"]
    f32 = htsat_fused_forward_from_wav(model, wavs[0], compute_dtype=torch.float32,
                                       use_kernels=False)["multi_accdoa"]
    e_plain = (outs[0] - plain).abs().max().item()
    e_f32 = (outs[0] - f32).abs().max().item()
    p_f32 = (plain - f32).abs().max().item()
    log(f"AdapterBit served vs plain bf16 path: max |d| {e_plain:.3g} (<= 5e-2); vs float32 "
        f"plain path {e_f32:.3g} (plain bf16 {p_f32:.3g}); output std {f32.std().item():.3g}")
    check(e_plain <= 5e-2, "AdapterBit served output disagrees with the plain path")
    check(e_f32 <= 1.25 * p_f32 + 1e-2,
          "AdapterBit served output further from float32 than plain bf16")

    # K4 against its plain version on the batch's own block inputs, timed
    wav = wavs[0]
    feats = folded_wav_features(model, wav, t_out=1024)
    xs, rows, k4_err, k4_rel = [], [], 0.0, 0.0
    with torch.no_grad():
        x = patch_embed_tokens(feats, embed)
        i = 0
        for layer in model.encoder.layers:
            for _ in layer.blocks:
                xs.append(x)
                x = sa.swin_block_adapt_fused(x, blocks[i])
                i += 1
            if layer.downsample is not None:
                x = patch_merging(layer.downsample, x, torch.bfloat16)
    for i, (x, p) in enumerate(zip(xs, blocks)):
        ref = sa.swin_block_adapt_plain(x, p).float()
        scale = ref.abs().max().item()
        err = (sa.swin_block_adapt_fused(x, p).float() - ref).abs().max().item()
        check(err <= 2.0 ** -6 * scale, f"K4 block {i} disagrees with its plain version")
        k4_err, k4_rel = max(k4_err, err), max(k4_rel, err / scale)
        t = cuda_ms(lambda: sa.swin_block_adapt_fused(x, p), reps=5)
        tp = cuda_ms(lambda: sa.swin_block_adapt_plain(x, p), reps=2)
        nb, fl = k4_work(B_SERVE, p)
        rows.append((t, tp, bound_ms(nb, bf16_flops=fl)[0]))
        log(f"  K4 block {i:2d} {p.base.H}x{p.base.W} C={p.base.C} shift={p.base.shift}: "
            f"|k-plain| {err:.3g} (<= {2.0 ** -6 * scale:.3g}), {t:.3f} ms, plain {tp:.3f} ms, "
            f"bound {rows[-1][2]:.4f} ms")
    k4_ms, k4_plain, k4_bound = (sum(r[j] for r in rows) for j in range(3))
    k1 = cuda_ms(lambda: folded_wav_features(model, wav, t_out=1024), reps=10)
    log(f"AdapterBit per batch of {B_SERVE} ({smi}): K1 {k1:.3f} ms, K4 x12 {k4_ms:.3f} ms "
        f"(plain {k4_plain:.3f}, bound {k4_bound:.3f}), rest {dt * 1e3 - k1 - k4_ms:.3f} ms")
    phases = k4_phases(xs, blocks, smi)
    b128 = serve_b128("AdapterBit served", serve, model, smi)
    phase_profile("one AdapterBit served batch", lambda: serve(wav))
    return launches, {"K4": (k4_err, k4_rel, k4_ms, k4_plain, k4_bound, "operations", None,
                             None, {"phases_ms_x12": phases, "served_b128": b128})}


def k4_phases(xs, blocks, smi):
    """K4 by phase over the served batch's twelve blocks (each on its own
    input; torch.profiler, a phase a launch in swin_fwd_plan.ADAPT_PHASES'
    order): ms x12 and the GEMM and attention phases' TFLOP/s (the padded
    adapter width, as the kernel runs it). Returns {phase: ms}."""
    from pseldnets_tpu_torch.ops import swin_block_adapt as sa
    from pseldnets_tpu_torch.ops import swin_fwd_plan as plan

    ms = dict.fromkeys(plan.ADAPT_PHASES, 0.0)
    fl = {}
    for x, p in zip(xs, blocks):
        t, _ = plan.launches_ms(lambda: sa.swin_block_adapt_fused(x, p), len(plan.ADAPT_PHASES))
        for k, v in zip(plan.ADAPT_PHASES, t):
            ms[k] += v
        b = p.base
        for k, v in plan.adapt_phase_flops(x.shape[0] * x.shape[1], b.C, b.fc1_w.shape[1],
                                           p.ch_pad).items():
            fl[k] = fl.get(k, 0) + v
    log(f"K4 by phase x12 at B={B_SERVE} ({smi}): " + ", ".join(
        f"{k} {v:.3f} ms" + (f" ({fl[k] / v / 1e9:.0f} TFLOP/s)" if fl.get(k) else "")
        for k, v in ms.items()) + f"; sum {sum(ms.values()):.3f} ms")
    return {k: round(v, 5) for k, v in ms.items()}


def phase_train_adapter(smi):
    """AdapterBit training (bench_all.py adapterbit_train: bench_train's step
    with adapt=adapter, B=32): TRAIN_STEPS SELDTask steps from the zero
    adapter init (K1, K4 with masks, K5), the frozen backbone bit-identical
    after them, then, with random adapters, one kernel step against one plain
    step, K4 and K5 on the step's own block inputs, and a profile."""
    import numpy as np
    import torch
    from pseldnets_tpu_torch.config import compose
    from pseldnets_tpu_torch.ops import swin_block_adapt as sa
    from pseldnets_tpu_torch.train.module import DatasetSpec, SELDTask

    cfg = compose(str(ROOT / "configs"), "train", TRAIN_OVERRIDES + ADAPT)
    task = SELDTask(cfg, DatasetSpec(num_classes=13), steps_per_epoch=100, device="cuda")
    check(task.fused_forward and task.compute_dtype == torch.bfloat16,
          "AdapterBit training configuration")
    task.init_state(0)
    trained = set(task.trained_names)
    n_train = sum(p.numel() for p in task.trained)
    n_all = sum(p.numel() for p in task.params)
    log(f"AdapterBit: {len(trained)} of {len(task.names)} parameter tensors train "
        f"({n_train} of {n_all} values)")
    before = {n: p.detach().clone() for n, p in task.model.named_parameters()}
    g = torch.Generator(device="cuda").manual_seed(14)
    wavs = [torch.randn(B_TRAIN, 4, N_SAMPLES, device="cuda", generator=g) * 0.1
            for _ in range(TRAIN_STEPS)]
    labels = {"adpit_label": torch.from_numpy(make_labels(np.random.default_rng(1), B_TRAIN,
                                                          100)).cuda()}
    gen = torch.Generator(device="cuda").manual_seed(15)
    step = lambda w: task.train_step(w, labels, gen)  # noqa: E731
    step(wavs[0])  # warm-up
    torch.cuda.synchronize()

    # the main path: counts from 0, TRAIN_STEPS steps
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    t0 = time.perf_counter()
    losses = [step(w)["loss_all"] for w in wavs]
    torch.cuda.synchronize()
    dt = (time.perf_counter() - t0) / TRAIN_STEPS
    launches = read_counts()
    log(f"AdapterBit: peak device memory over the steps "
        f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB")
    want = expected(K1=TRAIN_STEPS, K4=12 * TRAIN_STEPS, K5=12 * TRAIN_STEPS)
    log(f"AdapterBit: trained {TRAIN_STEPS} steps of {B_TRAIN} x 10 s clips: launches "
        f"{launches} (expect {want}); losses {[round(float(v), 6) for v in losses]}")
    check(launches == want, "AdapterBit training launch counts")
    check(all(np.isfinite(float(v)) for v in losses), "AdapterBit training loss not finite")
    log(f"AdapterBit training: {dt * 1e3:.2f} ms/step, {B_TRAIN / dt:.1f} clips/s "
        f"(host clock, synchronized; {smi})")
    after = dict(task.model.named_parameters())
    frozen_same = all(torch.equal(after[n], v) for n, v in before.items() if n not in trained)
    adapters_moved = all(not torch.equal(after[n], before[n]) for n in trained if "adapter" in n)
    log(f"after {TRAIN_STEPS + 1} steps: frozen parameters bit-identical {frozen_same}; "
        f"every adapter parameter moved {adapters_moved}")
    check(frozen_same and adapters_moved, "freeze policy on the card")

    # from here on, random adapters (a zero fc2 would hide wiring faults)
    randomize_adapters(task.model, torch.Generator().manual_seed(16))

    def grads_with(use_kernels, dtype):
        task.set_use_kernels(use_kernels)
        task.compute_dtype = dtype
        losses, grads, _ = task.compute_grads(wavs[0], labels,
                                              torch.Generator(device="cuda").manual_seed(17))
        return losses["loss_all"].float().reshape(1), grads

    lk, gk = grads_with(True, torch.bfloat16)
    lp, gp = grads_with(False, torch.bfloat16)
    lf, gf = grads_with(False, torch.float32)
    task.set_use_kernels(True)
    task.compute_dtype = torch.bfloat16
    log(f"AdapterBit kernel step vs plain step: loss {lk.item():.6f} (plain bf16 "
        f"{lp.item():.6f}, float32 {lf.item():.6f})")
    compare("loss", lk, lp, lf, 2.0 ** -6)
    worst = 0.0
    for name, a, b, c in zip(task.trained_names, gk, gp, gf):
        worst = max(worst, compare(name[-36:], a, b, c, 2.0 ** -4)
                    / max(c.abs().max().item(), 1e-30))
    log(f"every trained parameter grad within {worst:.3g} of its scale of the plain step's")

    # K4 with masks and K5 on the step's own B=32 block inputs, from one step
    recorded = []

    def record(x, p, m, dout, want=None):
        recorded.append((x, p, m, dout, want))
        return orig(x, p, m, dout, want)

    orig = sa.swin_block_adapt_backward
    sa.swin_block_adapt_backward = record
    try:
        task.compute_grads(wavs[1], labels, torch.Generator(device="cuda").manual_seed(18))
    finally:
        sa.swin_block_adapt_backward = orig
    check(len(recorded) == 12, f"recorded {len(recorded)} adapter block backwards")
    trained_keys = {"ln1_b", "qkv_b", "proj_b", "ln2_b", "fc1_b", "fc2_b"} | set(
        k for keys in sa.ADAPTER_KEYS.values() for k in keys)
    check(all(set(r[4]) <= trained_keys and {"qkv_b", "ln1_b"} <= set(r[4]) for r in recorded),
          f"AdapterBit asks K5 for more than its trained grads: {sorted(recorded[0][4])}")
    k4_err = k4_rel = k5_err = k5_rel = 0.0
    rows = []
    for j, (x, p, m, dout, want) in enumerate(reversed(recorded)):
        y = sa.swin_block_adapt_fused(x, p, m).float()
        y0 = sa.swin_block_adapt_plain(x, p, m).float()
        e, s = (y - y0).abs().max().item(), y0.abs().max().item()
        check(torch.isfinite(y).all().item() and e <= 2.0 ** -6 * s,
              f"K4 with masks, block {j}, disagrees at B={B_TRAIN}")
        k4_err, k4_rel = max(k4_err, e), max(k4_rel, e / s)
        k4_block_rel = e / s
        dx, gr = orig(x, p, m, dout)
        dx0, g0 = sa.swin_block_adapt_backward_plain(x, p, m, dout)
        worst_rel = 0.0
        for name, a, b in [("dx", dx, dx0)] + [(k, gr[k], g0[k]) for k in g0]:
            e = (a.float() - b.float()).abs().max().item()
            s = b.float().abs().max().item()
            check(e <= 2.0 ** -6 * s, f"K5 block {j} {name} disagrees at B={B_TRAIN}")
            k5_err, worst_rel = max(k5_err, e), max(worst_rel, e / max(s, 1e-30))
        k5_rel = max(k5_rel, worst_rel)
        # the training form the step launched: exactly its wanted grads, and
        # those equal to the full form's bits
        dxm, grm = orig(x, p, m, dout, want)
        check(set(grm) == set(want) & set(gr) and torch.equal(dxm, dx)
              and all(torch.equal(grm[k], gr[k]) for k in grm),
              f"K5 block {j}: the training form differs from the full form")
        t = cuda_ms(lambda: orig(x, p, m, dout), reps=5)
        tm = cuda_ms(lambda: orig(x, p, m, dout, want), reps=5)
        tp = cuda_ms(lambda: sa.swin_block_adapt_backward_plain(x, p, m, dout), reps=1)
        t4 = cuda_ms(lambda: sa.swin_block_adapt_fused(x, p, m), reps=5)
        nb, fl = k5_work(B_TRAIN, p)
        nbm, flm = k5_work(B_TRAIN, p, masked=True)
        rows.append((t, tp, bound_ms(nb, bf16_flops=fl)[0], t4, tm,
                     bound_ms(nbm, bf16_flops=flm)[0]))
        log(f"  K5 block {j:2d} {p.base.H}x{p.base.W} C={p.base.C} shift={p.base.shift}: worst "
            f"{worst_rel:.3g} of scale, {t:.3f} ms (training form {tm:.3f}), plain {tp:.3f} ms, "
            f"bound {rows[-1][2]:.4f} ms (training form {rows[-1][5]:.4f}); K4 with masks "
            f"{k4_block_rel:.3g} of scale (<= 2^-6), {t4:.3f} ms")
    k5_ms, k5_plain, k5_bound = (sum(r[i] for r in rows) for i in range(3))
    k5_train_ms, k5_train_bound = sum(r[4] for r in rows), sum(r[5] for r in rows)
    k4_train = sum(r[3] for r in rows)
    k1_ms = cuda_ms(lambda: task.extractor(wavs[0]), reps=10)
    log(f"AdapterBit per step of {B_TRAIN} ({smi}): K1 (float32) {k1_ms:.3f} ms, K4 with masks "
        f"x12 {k4_train:.3f} ms, K5 x12 {k5_ms:.3f} ms (plain {k5_plain:.3f}, bound "
        f"{k5_bound:.3f}), K5 x12 in the training form {k5_train_ms:.3f} ms (bound "
        f"{k5_train_bound:.3f}), rest {dt * 1e3 - k1_ms - k4_train - k5_train_ms:.3f} ms")
    phases = log_phases("K5 (training form)", [((lambda r=r: orig(*r)), r) for r in recorded],
                        B_TRAIN, lambda r: k35_phase_flops(B_TRAIN, r[1].base, r[1].ch_pad,
                                                           masked=True), smi)
    phase_profile("one AdapterBit training step", lambda: step(wavs[0]))
    return launches, {"K4": (k4_err, k4_rel),
                      "K5": (k5_err, k5_rel, k5_ms, k5_plain, k5_bound, "operations", None, None,
                             {"training_form_ms": k5_train_ms,
                              "training_form_bound_ms": k5_train_bound,
                              "phases_ms_x12_training_form": phases})}


def random_vit_block(gen):
    """A full-width PaSST block (768, 12 heads of 64, MLP 3072) with seeded
    weights, on the card."""
    from pseldnets_tpu_torch.models.factory import init_weights
    from pseldnets_tpu_torch.models.passt import Block

    blk = Block(768, 12)
    init_weights(blk, gen)
    return blk.cuda().eval()


def phase_vit_block():
    """K6 against its plain version (bf16 and float32) at PaSST's full
    width: the served N=602 at B=4, a tail (N=130, B=3: N and B*N not
    multiples of 64), N=1800, N=3500 (a sequence whose float32 scores for
    16 query rows would not fit in shared memory) and B*N=385 (not a
    multiple of the 128-row tiles); at each shape a second launch on the
    same input must give the same bits."""
    import torch
    from pseldnets_tpu_torch.ops.vit_block import (prepare_vit_block, vit_block_fused,
                                                   vit_block_plain)

    gen = torch.Generator().manual_seed(21)
    for B, N in ((B_CHECK, 602), (3, 130), (1, 1800), (1, 3500), (5, 77)):
        blk = random_vit_block(gen)
        x = torch.randn(B, N, 768, generator=gen).cuda().bfloat16()
        p16 = prepare_vit_block(blk, torch.bfloat16)
        p32 = prepare_vit_block(blk, torch.float32)
        log(f"ViT block B={B} N={N} C=768, 12 heads:")
        got = vit_block_fused(x, p16)
        again = vit_block_fused(x, p16)
        torch.cuda.synchronize()
        check(torch.equal(got, again), f"K6 B={B} N={N}: two launches differ")
        compare("K6 out", got, vit_block_plain(x, p16), vit_block_plain(x.float(), p32), 2.0 ** -6)


def k6_work(B, N, p):
    """Bytes and bf16 FLOPs of one K6 call on B images of N tokens: the four
    GEMMs (2 M C (3C + C + 2 hidden)), Q K^T and P V (4 B N^2 C); x read and
    the output written once, the bf16 matrices and float32 vectors read
    once."""
    C, hidden = p.C, p.hidden
    M = B * N
    flops = 2 * M * C * (3 * C + C + 2 * hidden) + 4 * B * N * N * C
    w_bytes = sum(t.numel() * t.element_size() for t in
                  (p.qkv_w, p.proj_w, p.fc1_w, p.fc2_w, p.qkv_b, p.proj_b, p.fc1_b,
                   p.fc2_b, p.ln1_w, p.ln1_b, p.ln2_w, p.ln2_b))
    return 2 * M * C * 2 + w_bytes, flops


def library_layer(blk):
    """The one PyTorch call that computes K6's function, as a yardstick
    only: nn.TransformerEncoderLayer (pre-LN, exact GELU, eps 1e-6) with the
    block's weights, bf16, eval."""
    import torch

    C, nh = blk.dim, blk.num_heads
    layer = torch.nn.TransformerEncoderLayer(
        C, nh, blk.mlp.fc1.out_features, dropout=0.0, activation="gelu",
        layer_norm_eps=blk.norm1.eps, batch_first=True, norm_first=True)
    with torch.no_grad():
        for dst, src in ((layer.self_attn.in_proj_weight, blk.attn.qkv.weight),
                         (layer.self_attn.in_proj_bias, blk.attn.qkv.bias),
                         (layer.self_attn.out_proj.weight, blk.attn.proj.weight),
                         (layer.self_attn.out_proj.bias, blk.attn.proj.bias),
                         (layer.linear1.weight, blk.mlp.fc1.weight),
                         (layer.linear1.bias, blk.mlp.fc1.bias),
                         (layer.linear2.weight, blk.mlp.fc2.weight),
                         (layer.linear2.bias, blk.mlp.fc2.bias),
                         (layer.norm1.weight, blk.norm1.weight),
                         (layer.norm1.bias, blk.norm1.bias),
                         (layer.norm2.weight, blk.norm2.weight),
                         (layer.norm2.bias, blk.norm2.bias)):
            dst.copy_(src)
    return layer.to(device="cuda", dtype=torch.bfloat16).eval()


def phase_serve_passt(smi):
    """PaSST mACCDOA serving (bench_all.py passt_maccdoa at B=32):
    SERVE_BATCHES batches of B_SERVE 10 s clips through
    passt_fused_forward_from_wav (K1, then K6 on every block), the output
    against the plain path, K1 and K6 on the batch's own inputs, the library
    yardstick per block, and a profile."""
    import torch
    from pseldnets_tpu_torch.config import compose
    from pseldnets_tpu_torch.models import build_model
    from pseldnets_tpu_torch.ops import vit_block
    from pseldnets_tpu_torch.serving import (folded_wav_features, passt_fused_forward_from_wav,
                                             prepare_vit_blocks)
    from pseldnets_tpu_torch.serving.passt import passt_tokens

    cfg = compose(str(ROOT / "configs"), "train", PASST_OVERRIDES)
    model, _ = build_model(cfg, 13, device="cuda", seed=0)
    gen = torch.Generator().manual_seed(22)
    with torch.no_grad():  # non-trivial eval ScalarBN statistics
        model.scalar.running_mean.copy_(torch.randn(7, 64, generator=gen).cuda() * 5.0 - 20.0)
        model.scalar.running_var.copy_(torch.rand(7, 64, generator=gen).cuda() * 50.0 + 10.0)
    blocks = prepare_vit_blocks(model, torch.bfloat16)
    check(len(blocks) == 7 and all((p.C, p.nh, p.hidden) == (768, 12, 3072) for p in blocks)
          and model.encoder.grid_size == (6, 100), "PaSST block plan")
    g = torch.Generator(device="cuda").manual_seed(23)
    wavs = [torch.randn(B_SERVE, 4, N_SAMPLES, device="cuda", generator=g) * 0.1
            for _ in range(SERVE_BATCHES)]
    serve = lambda w: passt_fused_forward_from_wav(model, w, blocks=blocks)  # noqa: E731
    serve(wavs[0])  # warm-up
    torch.cuda.synchronize()

    # the main path: counts from 0, SERVE_BATCHES batches
    zero_counts()
    t0 = time.perf_counter()
    outs = [serve(w)["multi_accdoa"] for w in wavs]
    torch.cuda.synchronize()
    dt = (time.perf_counter() - t0) / SERVE_BATCHES
    launches = read_counts()
    want = expected(K1=SERVE_BATCHES, K6=7 * SERVE_BATCHES)
    log(f"PaSST: served {SERVE_BATCHES} batches of {B_SERVE} x 10 s clips: launches {launches} "
        f"(expect {want})")
    check(launches == want, "PaSST serving launch counts")
    for o in outs:
        check(o.shape == (B_SERVE, 100, 117) and o.dtype == torch.float32
              and torch.isfinite(o).all().item(), f"PaSST served output {tuple(o.shape)}")
    log(f"PaSST served: {dt * 1e3:.2f} ms/batch, {B_SERVE / dt:.1f} clips/s "
        f"(host clock, synchronized; {smi})")
    plain = passt_fused_forward_from_wav(model, wavs[0], blocks=blocks,
                                         use_kernels=False)["multi_accdoa"]
    f32 = passt_fused_forward_from_wav(model, wavs[0], compute_dtype=torch.float32,
                                       use_kernels=False)["multi_accdoa"]
    e_plain = (outs[0] - plain).abs().max().item()
    e_f32 = (outs[0] - f32).abs().max().item()
    p_f32 = (plain - f32).abs().max().item()
    log(f"PaSST served vs plain bf16 path: max |d| {e_plain:.3g} (<= 5e-2); vs float32 plain "
        f"path {e_f32:.3g} (plain bf16 {p_f32:.3g}); output std {f32.std().item():.3g}")
    check(e_plain <= 5e-2, "PaSST served output disagrees with the plain path")
    check(e_f32 <= 1.25 * p_f32 + 1e-2, "PaSST served output further from float32 than plain bf16")

    # K1 in its PaSST form (ScalarBN folded, bf16, no frame pad) on the batch
    wav = wavs[0]
    feats = folded_wav_features(model, wav)
    ref = folded_wav_features(model, wav, use_kernels=False).float()
    check(feats.shape == (B_SERVE, 7, 1001, 64), f"K1 PaSST form {tuple(feats.shape)}")
    k1_err = (feats.float() - ref).abs().max().item()
    k1_rel = k1_err / ref.abs().max().item()
    rel = ((feats.float() - ref).abs() / ref.abs().clamp(min=1.0)).max().item()
    log(f"K1 at B={B_SERVE} (PaSST form, 1001 frames): max err {rel:.3g} of max(|x|, 1) "
        f"(<= 2^-7)")
    check(rel <= 2.0 ** -7, f"K1 disagrees with its plain version at B={B_SERVE} (PaSST)")
    k1 = cuda_ms(lambda: folded_wav_features(model, wav), reps=10)

    # K6 against its plain version on each of the batch's 7 block inputs,
    # timed beside the plain version and the library call
    with torch.no_grad():
        xs = [passt_tokens(model, feats, torch.bfloat16)]
        for p in blocks[:-1]:
            xs.append(vit_block.vit_block_fused(xs[-1], p))
    check(xs[0].shape == (B_SERVE, 602, 768), f"PaSST tokens {tuple(xs[0].shape)}")
    rows, k6_err, k6_rel, lib_rel = [], 0.0, 0.0, 0.0
    for i, (x, p, blk) in enumerate(zip(xs, blocks, model.encoder.blocks)):
        ref = vit_block.vit_block_plain(x, p).float()
        scale = ref.abs().max().item()
        err = (vit_block.vit_block_fused(x, p).float() - ref).abs().max().item()
        check(err <= 2.0 ** -6 * scale, f"K6 block {i} disagrees with its plain version")
        k6_err, k6_rel = max(k6_err, err), max(k6_rel, err / scale)
        layer = library_layer(blk)
        with torch.no_grad():
            lib_e = (layer(x).float() - ref).abs().max().item() / scale
            t_lib = cuda_ms(lambda: layer(x), reps=5)
        # the library call rounds elsewhere (its own LayerNorm and attention)
        check(lib_e <= 2.0 ** -4, f"library call block {i}: {lib_e:.3g} of scale")
        lib_rel = max(lib_rel, lib_e)
        t = cuda_ms(lambda: vit_block.vit_block_fused(x, p), reps=5)
        tp = cuda_ms(lambda: vit_block.vit_block_plain(x, p), reps=2)
        nb, fl = k6_work(B_SERVE, 602, p)
        rows.append((t, tp, bound_ms(nb, bf16_flops=fl)[0], t_lib))
        log(f"  K6 block {i}: |k-plain| {err:.3g} (<= {2.0 ** -6 * scale:.3g}), {t:.3f} ms, "
            f"plain {tp:.3f} ms, library {t_lib:.3f} ms ({lib_e:.3g} of scale from plain), "
            f"bound {rows[-1][2]:.4f} ms")
    k6_ms, k6_plain, k6_bound, k6_lib = (sum(r[j] for r in rows) for j in range(4))
    log(f"PaSST per batch of {B_SERVE} ({smi}): K1 {k1:.3f} ms, K6 x7 {k6_ms:.3f} ms (plain "
        f"{k6_plain:.3f}, library {k6_lib:.3f}, bound {k6_bound:.3f}), rest "
        f"{dt * 1e3 - k1 - k6_ms:.3f} ms; library call within {lib_rel:.3g} of scale")
    phases = k6_phases(xs[0], blocks[0], smi)
    phase_profile("one PaSST served batch", lambda: serve(wav))
    return launches, {"K1": (k1_err, k1_rel),
                      "K6": (k6_err, k6_rel, k6_ms, k6_plain, k6_bound, "operations", k6_lib,
                             lib_rel, {"phases_ms_per_block": phases})}


def k6_phases(x, p, smi):
    """K6's seven launches on one served block input, timed by the CUDA
    events its C entry records between them (10 runs after 2); each GEMM and
    the attention with its TFLOP/s (attention on the two-pass FLOPs, 6 B N^2
    C: Q K^T twice and P V once)."""
    from pseldnets_tpu_torch.ops import vit_block

    B, N, C = x.shape
    M, hid = B * N, p.hidden
    flops = {"qkv": 2 * M * C * 3 * C, "attention": 6 * B * N * N * C, "proj": 2 * M * C * C,
             "fc1": 2 * M * C * hid, "fc2": 2 * M * hid * C}
    vit_block.vit_block_phases(x, p, reps=2)
    ms = vit_block.vit_block_phases(x, p, reps=10)
    log(f"K6 by phase, one block at B={B} N={N} ({smi}): " + ", ".join(
        f"{k} {v:.4f} ms" + (f" ({flops[k] / v / 1e9:.0f} TFLOP/s)" if k in flops else "")
        for k, v in ms.items()) + f"; sum {sum(ms.values()):.4f} ms")
    return {k: round(v, 5) for k, v in ms.items()}


def folded_conv_block(gen, cin, cout, dtype):
    """A ConvBlock of the trunk's shape with seeded weights and non-trivial
    eval BN statistics, folded as the serving path folds it (the stem's
    input channels padded to 8)."""
    import torch
    from pseldnets_tpu_torch.models.backbone import ConvBlock
    from pseldnets_tpu_torch.models.factory import init_weights
    from pseldnets_tpu_torch.ops.conv_block import padded_channels
    from pseldnets_tpu_torch.serving.crnn import prepare_conv_block

    blk = ConvBlock(cin, cout)
    init_weights(blk, gen)
    randomize_bn_stats(blk, gen)
    blk.cuda().eval()
    with torch.no_grad():
        return [prepare_conv_block(blk, dt, padded_channels(cin)) for dt in (dtype, torch.float32)]


def randomize_bn_stats(module, gen, scale=1.0):
    """Running statistics of every BatchNorm in ``module`` away from (0, 1):
    mean N(0, 0.3) and variance U(0.5, 1.5), times ``scale``**(1, 2)."""
    import torch
    from pseldnets_tpu_torch.models.common import ScalarBN, TorchBatchNorm

    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, TorchBatchNorm) and not isinstance(m, ScalarBN):
                shape, dev = m.running_mean.shape, m.running_mean.device
                m.running_mean.copy_(torch.randn(shape, generator=gen).to(dev) * 0.3 * scale)
                m.running_var.copy_((torch.rand(shape, generator=gen).to(dev) + 0.5) * scale ** 2)


def conv_args(mode, x, p):
    """The K7 call of ``mode`` on input x with folded ConvBlock params p."""
    if mode == "pair":
        return (x, p.w1, p.b1, p.w2, p.b2)
    if mode == "single":
        return (x, p.w1, p.b1)
    return (x, None, p.b1, p.w2, p.b2)  # relu_conv: x is a raw conv1 output


# K7's other shape classes, (mode, (B, T, F, Cin, Cmid, Cout)): F not
# dividing 128 with odd T and B = 3, F = 5 (25-row tiles), F over 128 (two
# 100-bin chunks), Cin 16, 24 and 32 (zero-filled channels of a K step),
# Cout 40 and the mid 48 (clipped output tiles), relu_conv on them
CONV_SHAPES = (("pair", (3, 7, 48, 16, 64, 64)), ("single", (3, 33, 5, 32, 128, 0)),
               ("pair", (2, 3, 200, 64, 48, 40)), ("relu_conv", (3, 13, 200, 64, 64, 128)),
               ("relu_conv", (3, 9, 5, 24, 24, 40)))


def conv_operands(gen, B, T, F, cin, cmid, cout, relu_conv):
    """Random bf16 NHWC input and HWIO weights N(0, 1/fan_in), float32
    biases large enough that a wrong edge halo shows; (plain16 args,
    plain32 args) in the argument order of ``mode``."""
    import torch

    x = torch.randn(B, T, F, cin, generator=gen)
    w1 = torch.randn(3, 3, cin, cmid, generator=gen) / (9 * cin) ** 0.5
    b1 = torch.randn(cin if relu_conv else cmid, generator=gen) * 0.5 + 0.5
    w2 = torch.randn(3, 3, cmid, cout, generator=gen) / (9 * cmid) ** 0.5
    b2 = torch.randn(cout, generator=gen) * 0.5
    return [(x.cuda().to(dt), w1.cuda().to(dt), b1.cuda(), w2.cuda().to(dt), b2.cuda())
            for dt in (torch.bfloat16, torch.float32)]


def phase_conv_block():
    """K7 against its plain version (bf16 and float32) at B_CHECK: the pair
    at all six ConvBlock shapes of the CNN12 trunk (T=1001 at the stem, its
    7 channels padded to 8), single and relu_conv at the stem shape and at
    one deep shape, folded random weights and BN statistics, so the biases
    are large enough for a wrong edge halo to show; then CONV_SHAPES with
    random weights. At each a second launch must give the same bits."""
    import torch

    gen = torch.Generator().manual_seed(31)
    cases = [("pair", shape) for shape in CRNN_BLOCKS]
    cases += [(mode, CRNN_BLOCKS[i]) for mode in ("single", "relu_conv") for i in (0, 4)]
    for mode, (T, Fq, cin, cout) in cases:
        p16, p32 = folded_conv_block(gen, cin, cout, torch.bfloat16)
        width = cout if mode == "relu_conv" else p16.w1.shape[2]
        x = torch.randn(B_CHECK, T, Fq, width, generator=gen)
        if width > cin and mode != "relu_conv":
            x[..., cin:] = 0.0  # the stem's zero channels
        x = x.cuda().bfloat16()
        a16, a32 = conv_args(mode, x, p16), conv_args(mode, x.float(), p32)
        check_conv(f"K7 {mode} B={B_CHECK} T={T} F={Fq} {cin}->{cout}", a16, a32)
    for mode, (B, T, Fq, cin, cmid, cout) in CONV_SHAPES:
        relu_conv = mode == "relu_conv"
        a16, a32 = (conv_args(mode, a[0], types.SimpleNamespace(w1=a[1], b1=a[2], w2=a[3], b2=a[4]))
                    for a in conv_operands(gen, B, T, Fq, cin, cin if relu_conv else cmid,
                                           cout or cmid, relu_conv))
        check_conv(f"K7 {mode} B={B} T={T} F={Fq} {cin}->{cmid}->{cout or cmid}", a16, a32)


def check_conv(what, a16, a32):
    """K7 on args a16 against its plain version on a16 and a32 (2^-6 of
    scale), and a second launch bitwise equal."""
    import torch
    from pseldnets_tpu_torch.ops.conv_block import conv3x3_bias_relu, conv3x3_bias_relu_plain

    got = conv3x3_bias_relu(*a16)
    again = conv3x3_bias_relu(*a16)
    torch.cuda.synchronize()
    plain16 = conv3x3_bias_relu_plain(*a16)
    plain32 = conv3x3_bias_relu_plain(*a32, compute_dtype=torch.float32)
    err = (got.float() - plain16.float()).abs().max().item()
    scale = plain16.float().abs().max().item()
    log(f"{what}: max |d| {err:.3g} = {err / scale:.3g} of scale (<= 2^-6, two bf16 "
        f"ulps); repeat bitwise {torch.equal(got, again)}")
    check(torch.equal(got, again), f"{what}: two launches differ")
    compare("K7", got, plain16, plain32, 2.0 ** -6)


def k7_work(B, T, Fq, cin, cout):
    """Bytes and bf16 FLOPs of one ConvBlock (both convs) on B images:
    2 M 9 (cin cout + cout cout) with the stem's 7 real channels; x read
    (cin channels, bf16), the bf16 weights and float32 biases read, the
    output written, once each."""
    M = B * T * Fq
    flops = 2 * M * 9 * (cin * cout + cout * cout)
    nbytes = M * cin * 2 + 9 * (cin * cout + cout * cout) * 2 + 2 * cout * 4 + M * cout * 2
    return nbytes, flops


def library_pair(x, p):
    """The one PyTorch call per conv that computes K7's pair, as a yardstick
    only: relu(conv2d(x, w, b, padding=1)) twice in bf16, channels_last
    (cuDNN), on the same inputs and folded weights."""
    import torch
    import torch.nn.functional as F

    xl = x.permute(0, 3, 1, 2)  # NHWC as a channels_last NCHW view
    w1, w2 = (w.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
              for w in (p.w1, p.w2))
    b1, b2 = p.b1.bfloat16(), p.b2.bfloat16()
    return lambda: F.relu(F.conv2d(F.relu(F.conv2d(xl, w1, b1, padding=1)), w2, b2, padding=1))


def phase_serve_crnn(smi):
    """CRNN ACCDOA serving (bench_all.py cnn14_accdoa at B=32, CNN12 +
    conformer at 2048): SERVE_BATCHES batches of B_SERVE 10 s clips through
    crnn_fused_forward_from_wav (K1, then K7 on every ConvBlock), the output
    against the plain path, K1 and K7 on the batch's own inputs, the cuDNN
    yardstick per ConvBlock, peak memory and a profile."""
    import torch
    from pseldnets_tpu_torch.config import compose
    from pseldnets_tpu_torch.models import build_model
    from pseldnets_tpu_torch.ops.conv_block import conv3x3_bias_relu, conv3x3_bias_relu_plain
    from pseldnets_tpu_torch.serving import (crnn_fused_forward_from_wav, folded_wav_features,
                                             prepare_crnn)
    from pseldnets_tpu_torch.serving.crnn import avg_pool, trunk_input

    cfg = compose(str(ROOT / "configs"), "train", CRNN_OVERRIDES)
    model, _ = build_model(cfg, 13, device="cuda", seed=0)
    gen = torch.Generator().manual_seed(32)
    randomize_bn_stats(model, gen)
    with torch.no_grad():  # non-trivial eval ScalarBN statistics
        model.scalar.running_mean.copy_(torch.randn(7, 64, generator=gen).cuda() * 5.0 - 20.0)
        model.scalar.running_var.copy_(torch.rand(7, 64, generator=gen).cuda() * 50.0 + 10.0)
    params = prepare_crnn(model, torch.bfloat16)
    n_params = sum(t.numel() for t in model.parameters())
    plan = [(p.w1.shape[2], p.w2.shape[3], p.pool) for p in params.blocks]
    check(plan == [(8, 64, (2, 2)), (64, 128, (2, 2)), (128, 256, (2, 2)), (256, 512, (1, 2)),
                   (512, 1024, (1, 2)), (1024, 2048, (1, 2))]
          and len(params.decoder) == 1 and params.num_heads == 8, f"CRNN plan {plan}")
    log(f"CRNN: {n_params / 1e6:.2f} M parameters (CNN12 64..2048, 1 conformer layer at 2048)")
    g = torch.Generator(device="cuda").manual_seed(33)
    wavs = [torch.randn(B_SERVE, 4, N_SAMPLES, device="cuda", generator=g) * 0.1
            for _ in range(SERVE_BATCHES)]
    serve = lambda w: crnn_fused_forward_from_wav(model, w, params=params)  # noqa: E731
    serve(wavs[0])  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    # the main path: counts from 0, SERVE_BATCHES batches
    zero_counts()
    t0 = time.perf_counter()
    outs = [serve(w)["accdoa"] for w in wavs]
    torch.cuda.synchronize()
    dt = (time.perf_counter() - t0) / SERVE_BATCHES
    launches = read_counts()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    want = expected(K1=SERVE_BATCHES, K7=6 * SERVE_BATCHES)
    log(f"CRNN: served {SERVE_BATCHES} batches of {B_SERVE} x 10 s clips: launches {launches} "
        f"(expect {want}: K7 one call per ConvBlock, two conv launches each)")
    check(launches == want, "CRNN serving launch counts")
    for o in outs:
        check(o.shape == (B_SERVE, 100, 39) and o.dtype == torch.float32
              and torch.isfinite(o).all().item(), f"CRNN served output {tuple(o.shape)}")
    log(f"CRNN served: {dt * 1e3:.2f} ms/batch, {B_SERVE / dt:.1f} clips/s (host clock, "
        f"synchronized; {smi}); peak device memory {peak:.2f} GiB")
    plain = crnn_fused_forward_from_wav(model, wavs[0], params=params,
                                        use_kernels=False)["accdoa"]
    f32 = crnn_fused_forward_from_wav(model, wavs[0], compute_dtype=torch.float32,
                                      use_kernels=False)["accdoa"]
    e_plain = (outs[0] - plain).abs().max().item()
    e_f32 = (outs[0] - f32).abs().max().item()
    p_f32 = (plain - f32).abs().max().item()
    log(f"CRNN served vs plain bf16 path: max |d| {e_plain:.3g} (<= 5e-2); vs float32 plain "
        f"path {e_f32:.3g} (plain bf16 {p_f32:.3g}); output std {f32.std().item():.3g}")
    check(e_plain <= 5e-2, "CRNN served output disagrees with the plain path")
    check(e_f32 <= 1.25 * p_f32 + 1e-2, "CRNN served output further from float32 than plain bf16")

    # K1 in its CRNN form (ScalarBN folded, bf16, 1001 frames) on the batch
    wav = wavs[0]
    feats = folded_wav_features(model, wav)
    ref = folded_wav_features(model, wav, use_kernels=False).float()
    check(feats.shape == (B_SERVE, 7, 1001, 64), f"K1 CRNN form {tuple(feats.shape)}")
    k1_err = (feats.float() - ref).abs().max().item()
    k1_rel = k1_err / ref.abs().max().item()
    rel = ((feats.float() - ref).abs() / ref.abs().clamp(min=1.0)).max().item()
    log(f"K1 at B={B_SERVE} (CRNN form, 1001 frames): max err {rel:.3g} of max(|x|, 1) "
        f"(<= 2^-7)")
    check(rel <= 2.0 ** -7, f"K1 disagrees with its plain version at B={B_SERVE} (CRNN)")
    k1 = cuda_ms(lambda: folded_wav_features(model, wav), reps=10)

    # K7 against its plain version on each of the batch's six ConvBlock
    # inputs, timed beside the plain version and the cuDNN yardstick
    with torch.no_grad():
        xs = [trunk_input(feats, torch.bfloat16, params.blocks[0].w1.shape[2])]
        for p in params.blocks[:-1]:
            xs.append(avg_pool(conv3x3_bias_relu(xs[-1], p.w1, p.b1, p.w2, p.b2), p.pool))
    rows, k7_err, k7_rel, lib_rel = [], 0.0, 0.0, 0.0
    for i, (x, p, (T, Fq, cin, cout)) in enumerate(zip(xs, params.blocks, CRNN_BLOCKS)):
        check(tuple(x.shape) == (B_SERVE, T, Fq, p.w1.shape[2]), f"block {i} input {x.shape}")
        args = (x, p.w1, p.b1, p.w2, p.b2)
        ref = conv3x3_bias_relu_plain(*args).float()
        scale = ref.abs().max().item()
        err = (conv3x3_bias_relu(*args).float() - ref).abs().max().item()
        check(err <= 2.0 ** -6 * scale, f"K7 block {i} disagrees with its plain version")
        k7_err, k7_rel = max(k7_err, err), max(k7_rel, err / scale)
        lib = library_pair(x, p)
        with torch.no_grad():
            lib_e = (lib().permute(0, 2, 3, 1).float() - ref).abs().max().item() / scale
        # cuDNN rounds elsewhere (the bias in bf16, its own accumulation order)
        check(lib_e <= 2.0 ** -4, f"library call block {i}: {lib_e:.3g} of scale")
        lib_rel = max(lib_rel, lib_e)
        t = cuda_ms(lambda: conv3x3_bias_relu(*args), reps=5)
        tp = cuda_ms(lambda: conv3x3_bias_relu_plain(*args), reps=2)
        t_lib = cuda_ms(lib, reps=5)
        nb, fl = k7_work(B_SERVE, T, Fq, cin, cout)
        rows.append((t, tp, bound_ms(nb, bf16_flops=fl)[0], t_lib, fl))
        log(f"  K7 block {i} T={T} F={Fq} {cin}->{cout}: |k-plain| {err:.3g} (<= "
            f"{2.0 ** -6 * scale:.3g}), {t:.3f} ms ({fl / t / 1e9:.0f} TFLOP/s), plain "
            f"{tp:.3f} ms, library {t_lib:.3f} ms ({lib_e:.3g} of scale from plain), bound "
            f"{rows[-1][2]:.4f} ms")
    k7_ms, k7_plain, k7_bound, k7_lib, k7_flops = (sum(r[j] for r in rows) for j in range(5))
    log(f"CRNN per batch of {B_SERVE} ({smi}): K1 {k1:.3f} ms, K7 x6 {k7_ms:.3f} ms "
        f"({k7_flops / 1e12:.3f} TFLOP, {k7_flops / k7_ms / 1e9:.0f} TFLOP/s; plain "
        f"{k7_plain:.3f}, library {k7_lib:.3f}, bound {k7_bound:.3f}), rest "
        f"{dt * 1e3 - k1 - k7_ms:.3f} ms; library call within {lib_rel:.3g} of scale")
    names = [r[0] for r in phase_profile("one CRNN served batch", lambda: serve(wav))]
    # cuDNN's and PyTorch's own conv kernels (cuBLAS GEMMs of the glue are
    # named *_xmma_gemm_* and are not convs)
    library_convs = [n for n in names if "conv3x3_wgmma" not in n and any(
        k in n.lower() for k in ("cudnn", "fprop", "implicit", "conv"))]
    log(f"CRNN served batch: library conv kernels in the profile: {library_convs or 'none'}"
        if names else "CRNN served batch: library conv kernels not measured (no profile)")
    check(not library_convs, "the served CRNN path launched a library conv")
    return launches, {"K1": (k1_err, k1_rel),
                      "K7": (k7_err, k7_rel, k7_ms, k7_plain, k7_bound, "operations", k7_lib,
                             lib_rel)}


def phase_patch_embed():
    """K8 against its plain version at B 1, 3 and 32 (a lone tile round, a
    partial one, B=32's persistent rounds with a partial last), on K1's
    serving output (ScalarBN folded, bf16, 1024 frames) and on the 5 s
    trick's input (the batch halves of 5 s features concatenated in time,
    1000 frames, ScalarBN, padded to 1024 by the kernel's TMA zeros); bf16
    within one bf16 ulp (2^-7 of max(|x|, 1)), float32 within 1e-5; each
    launched twice for equal bits. Then at 128 and 256 mel bins (HTSAT's
    spec_size 256 at freq_ratio 2 and 1) on K1's served form at those
    widths, random embed weights, the same checks, and the bf16 form timed
    at B_SERVE beside its plain version and bound."""
    import torch
    from pseldnets_tpu_torch.ops.frontend import fused_logmel_iv
    from pseldnets_tpu_torch.ops.patch_embed import (patch_embed_tokens,
                                                     patch_embed_tokens_plain)
    from pseldnets_tpu_torch.serving import folded_wav_features, prepare_patch_embed

    model = htsat_serving_model()
    g = torch.Generator(device="cuda").manual_seed(44)
    wav = torch.randn(B_SERVE, 4, N_SAMPLES, device="cuda", generator=g) * 0.1
    feats = folded_wav_features(model, wav, t_out=1024)
    raw = fused_logmel_iv(torch.randn(2 * B_SERVE, 4, N_SAMPLES // 2, device="cuda",
                                      generator=g) * 0.1)
    with torch.no_grad():
        five = model.scalar(torch.cat([raw[:B_SERVE, :, :-1], raw[B_SERVE:, :, :-1]], dim=2))
    check(tuple(feats.shape) == (B_SERVE, 7, 1024, 64)
          and tuple(five.shape) == (B_SERVE, 7, 1000, 64), "K8 inputs")
    for dtype in (torch.bfloat16, torch.float32):
        p = prepare_patch_embed(model.encoder, dtype)
        for what, xs in (("serving form", feats), ("5 s trick", five)):
            for B in (1, 3, B_SERVE):
                x = xs[:B].to(dtype).contiguous()
                got = patch_embed_tokens(x, p)
                again = patch_embed_tokens(x, p)
                torch.cuda.synchronize()
                ref = patch_embed_tokens_plain(x, p)
                check(got.shape == ref.shape == (B, 4096, 96) and got.dtype == dtype,
                      f"K8 shape {tuple(got.shape)}")
                check(torch.equal(got, again), f"K8 {what} B={B}: two launches differ")
                err = (got.float() - ref.float()).abs().max().item()
                if dtype == torch.bfloat16:
                    rel = ((got.float() - ref.float()).abs()
                           / ref.float().abs().clamp(min=1.0)).max().item()
                    log(f"K8 bf16 {what} B={B}: max |d| {err:.3g}, max err {rel:.3g} of "
                        f"max(|x|, 1) (<= 2^-7), two launches equal")
                    check(rel <= 2.0 ** -7,
                          f"K8 bf16 disagrees with its plain version ({what}, B={B})")
                else:
                    log(f"K8 float32 {what} B={B}: max |d| {err:.3g} (<= 1e-5), two launches "
                        f"equal")
                    check(err <= 1e-5,
                          f"K8 float32 disagrees with its plain version ({what}, B={B})")
    hold_patch_embed_wide()


def hold_patch_embed_wide():
    """K8 at F = 256 mel bins (freq_ratio 1, 256 image frames; F = 128 is
    held on serve_htsat128's own batch, ``phase_serve_wide``): on K1's
    served HTSAT form at that width (hop 960: 251 frames, the rest TMA's
    zero pad), random E = 96 embed weights, bf16 and float32 at B 1, 3 and
    B_SERVE, two launches bitwise equal, bf16 within one bf16 ulp of the
    plain version, float32 within 1e-5; the bf16 form timed at B_SERVE
    (WIDE_TIMES)."""
    import torch
    from pseldnets_tpu_torch.ops.frontend import fused_logmel_iv
    from pseldnets_tpu_torch.ops.patch_embed import (PatchEmbedParams, patch_embed_tokens,
                                                     patch_embed_tokens_plain)

    for F, fr, hop in ((256, 1, 960),):
        g = torch.Generator(device="cuda").manual_seed(F)
        wav = torch.randn(B_SERVE, 4, N_SAMPLES, device="cuda", generator=g) * 0.1
        aff = (torch.rand(7, F, device="cuda", generator=g) * 0.1 + 0.02,
               torch.randn(7, F, device="cuda", generator=g) * 0.1 + 2.0)
        feats = fused_logmel_iv(wav, hop=hop, n_mels=F, post_affine=aff,
                                out_dtype=torch.bfloat16, t_out=256 * fr)
        check(tuple(feats.shape) == (B_SERVE, 7, 256 * fr, F), f"K8 input at F={F}")
        w = torch.randn(7 * 16, 96, device="cuda", generator=g) * 0.1
        vec = lambda o: torch.randn(96, device="cuda", generator=g) * 0.1 + o  # noqa: E731
        bias, ln_w, ln_b = vec(0.0), vec(1.0), vec(0.0)
        for dtype in (torch.bfloat16, torch.float32):
            p = PatchEmbedParams(w=w.to(dtype).contiguous(), bias=bias, ln_w=ln_w, ln_b=ln_b,
                                 freq_ratio=fr, t_img=256 * fr)
            for B in (1, 3, B_SERVE):
                x = feats[:B].to(dtype).contiguous()
                got = patch_embed_tokens(x, p)
                again = patch_embed_tokens(x, p)
                torch.cuda.synchronize()
                ref = patch_embed_tokens_plain(x, p)
                check(got.shape == ref.shape == (B, 4096, 96) and got.dtype == dtype,
                      f"K8 shape {tuple(got.shape)} at F={F}")
                check(torch.equal(got, again), f"K8 F={F} B={B}: two launches differ")
                err = (got.float() - ref.float()).abs().max().item()
                rel = ((got.float() - ref.float()).abs()
                       / ref.float().abs().clamp(min=1.0)).max().item()
                ok = rel <= 2.0 ** -7 if dtype == torch.bfloat16 else err <= 1e-5
                log(f"K8 {str(dtype)[6:]} F={F} B={B}: max |d| {err:.3g}, max err {rel:.3g} "
                    f"of max(|x|, 1) (bf16 <= 2^-7, float32 |d| <= 1e-5), two launches equal")
                check(ok, f"K8 {dtype} F={F} B={B} disagrees with its plain version")
            if dtype == torch.bfloat16:
                x = feats
                ms = cuda_ms(lambda: patch_embed_tokens(x, p), reps=20)
                dev, host = device_ms(lambda: patch_embed_tokens(x, p), reps=40)
                plain_ms = cuda_ms(lambda: patch_embed_tokens_plain(x, p), reps=5)
                nb, fl = k8_work(B_SERVE, p, F)
                b_ms, by = bound_ms(nb, bf16_flops=fl)
                WIDE_TIMES.setdefault("K8", {})[f"F={F} bf16, B={B_SERVE}"] = {
                    "ms": ms, "device_ms": dev, "host_ms": host, "plain_ms": plain_ms,
                    "bound_ms": b_ms, "bound_by": by}
                log(f"K8 bf16 F={F} at B={B_SERVE}: {ms:.4f} ms back to back, {dev:.4f} ms "
                    f"queued (host {host:.4f} ms a call), plain {plain_ms:.3f} ms, bound "
                    f"{b_ms:.4f} ms by {by}")


def k8_work(B, p, F=64):
    """Bytes and bf16 FLOPs of K8's function on B clips of F mel bins: the
    (B, 7, t_img, F) bf16 features read once (t_img 1024 at 64 bins, 512 at
    128, 256 at 256), the (B, t_img F / 16, 96) bf16 tokens (4096 a clip)
    written once, the weights read once; 2 K E FLOPs per token for the conv
    (K = 7 x 16) and ~8 E for bias and LayerNorm."""
    K, E = p.w.shape
    tokens = B * p.t_img * F // 16
    nbytes = B * 7 * p.t_img * F * 2 + tokens * E * 2 + p.w.numel() * 2 + 3 * E * 4
    return nbytes, tokens * (2 * K * E + 8 * E)


def phase_serve_patch(smi):
    """HTSAT mACCDOA serving with the einsum patch embed
    (htsat_fused_forward_from_wav(..., patch_embed="einsum"); the other
    served HTSAT paths take K8, the default): SERVE_BATCHES batches of
    B_SERVE 10 s clips (K1 x1, K2 x12 per batch, K8 x0), counted from 0; the
    output against the plain path, float32, and the K8 path; the served
    time beside the K8 path's, in turns in this process ((K8, einsum,
    einsum, K8) x3 after the counted run); K8 on the batch's own features
    against its plain version, timed (device time) beside its plain
    version, the einsum embed and cuDNN's conv of the same wav2img image
    alone (a yardstick of the conv, not the whole function); K8's SASS
    counts; a profile."""
    import torch
    import torch.nn.functional as F
    from pseldnets_tpu_torch.ops.patch_embed import (patch_embed_tokens,
                                                     patch_embed_tokens_plain)
    from pseldnets_tpu_torch.serving import (embed_tokens, folded_wav_features,
                                             htsat_fused_forward_from_wav, prepare_blocks,
                                             prepare_patch_embed)

    model = htsat_serving_model()
    blocks = prepare_blocks(model.encoder, torch.bfloat16)
    embed = prepare_patch_embed(model.encoder, torch.bfloat16)
    g = torch.Generator(device="cuda").manual_seed(45)
    wavs = [torch.randn(B_SERVE, 4, N_SAMPLES, device="cuda", generator=g) * 0.1
            for _ in range(SERVE_BATCHES)]
    serve = lambda w: htsat_fused_forward_from_wav(  # noqa: E731
        model, w, blocks=blocks, patch_embed="einsum")
    serve_k8 = lambda w: htsat_fused_forward_from_wav(  # noqa: E731
        model, w, blocks=blocks, embed=embed)

    def timed(fn):
        t0 = time.perf_counter()
        out = [fn(w)["multi_accdoa"] for w in wavs]
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / SERVE_BATCHES, out

    serve(wavs[0])  # warm-up
    serve_k8(wavs[0])
    torch.cuda.synchronize()

    # the main path: counts from 0, SERVE_BATCHES batches
    zero_counts()
    dt_e1, outs = timed(serve)
    launches = read_counts()
    want = expected(K1=SERVE_BATCHES, K2=12 * SERVE_BATCHES)
    log(f"einsum patch embed: served {SERVE_BATCHES} batches of {B_SERVE} x 10 s clips: "
        f"launches {launches} (expect {want})")
    check(launches == want, "serving launch counts with the einsum embed")
    for o in outs:
        check(o.shape == (B_SERVE, 100, 117) and o.dtype == torch.float32
              and torch.isfinite(o).all().item(), f"served output {tuple(o.shape)}")
    # the K8 path and this one again, in turns: (K8, einsum, einsum, K8) x3
    # after the counted einsum run; medians and ranges of the turns
    k8_dts, e_dts = [], [dt_e1]
    for _ in range(3):
        for dts, fn in ((k8_dts, serve_k8), (e_dts, serve), (e_dts, serve), (k8_dts, serve_k8)):
            t, out = timed(fn)
            dts.append(t)
            if fn is serve_k8:
                k8_outs = out
    dt_k, dt_e = statistics.median(k8_dts), statistics.median(e_dts)
    log(f"served with the K8 embed: {dt_k * 1e3:.2f} ms/batch ({min(k8_dts) * 1e3:.2f}-"
        f"{max(k8_dts) * 1e3:.2f}), {B_SERVE / dt_k:.1f} clips/s; einsum embed {dt_e * 1e3:.2f} "
        f"ms/batch ({min(e_dts) * 1e3:.2f}-{max(e_dts) * 1e3:.2f}), {B_SERVE / dt_e:.1f} "
        f"clips/s (medians of {len(k8_dts)} and {len(e_dts)} runs of {SERVE_BATCHES} batches "
        f"in turns; host clock, synchronized; {smi})")
    plain = htsat_fused_forward_from_wav(model, wavs[0], blocks=blocks, use_kernels=False,
                                         patch_embed="einsum")["multi_accdoa"]
    f32 = htsat_fused_forward_from_wav(model, wavs[0], compute_dtype=torch.float32,
                                       use_kernels=False, patch_embed="einsum")["multi_accdoa"]
    e_plain = (outs[0] - plain).abs().max().item()
    e_f32 = (outs[0] - f32).abs().max().item()
    p_f32 = (plain - f32).abs().max().item()
    e_k8 = (outs[0] - k8_outs[0]).abs().max().item()
    log(f"served (einsum embed) vs plain bf16 path: max |d| {e_plain:.3g} (<= 5e-2); vs "
        f"float32 plain path {e_f32:.3g} (plain bf16 {p_f32:.3g}); vs the K8 embed's path "
        f"{e_k8:.3g} (<= 5e-2, the rounding before the LayerNorm)")
    check(e_plain <= 5e-2, "served output (einsum embed) disagrees with the plain path")
    check(e_f32 <= 1.25 * p_f32 + 1e-2, "served output (einsum embed) further from float32")
    check(e_k8 <= 5e-2, "the K8 and einsum embeds' served outputs differ beyond bf16")

    # K1 and K8 against their plain versions on the batch's own inputs;
    # K8 timed beside its plain version, the einsum embed and cuDNN's conv,
    # back to back (cuda_ms) and queued behind a sleeping kernel (device_ms)
    wav = wavs[0]
    feats = folded_wav_features(model, wav, t_out=1024)
    ref1 = folded_wav_features(model, wav, t_out=1024, use_kernels=False).float()
    k1_err = (feats.float() - ref1).abs().max().item()
    rel = ((feats.float() - ref1).abs() / ref1.abs().clamp(min=1.0)).max().item()
    check(rel <= 2.0 ** -7, f"K1 disagrees with its plain version at B={B_SERVE}")
    got = patch_embed_tokens(feats, embed).float()
    ref = patch_embed_tokens_plain(feats, embed).float()
    k8_err = (got - ref).abs().max().item()
    k8_rel = k8_err / ref.abs().max().item()
    rel8 = ((got - ref).abs() / ref.abs().clamp(min=1.0)).max().item()
    check(rel8 <= 2.0 ** -7, f"K8 disagrees with its plain version at B={B_SERVE}")
    proj = model.encoder.patch_embed.proj
    einsum = lambda: embed_tokens(model.encoder, feats, torch.bfloat16)  # noqa: E731
    with torch.no_grad():
        e_emb = (einsum().float() - ref).abs().max().item()
        k8 = cuda_ms(lambda: patch_embed_tokens(feats, embed), reps=20)
        k8_plain = cuda_ms(lambda: patch_embed_tokens_plain(feats, embed), reps=5)
        k8_einsum = cuda_ms(einsum, reps=20)
        k8_dev, k8_host = device_ms(lambda: patch_embed_tokens(feats, embed), reps=40)
        einsum_dev, _ = device_ms(einsum, reps=20)
        img = model.encoder.reshape_wav2img(feats).contiguous()
        cw, cb = proj.weight.to(torch.bfloat16), proj.bias.to(torch.bfloat16)
        conv_ms = cuda_ms(lambda: F.conv2d(img, cw, cb, stride=4), reps=40)
        conv_dev, _ = device_ms(lambda: F.conv2d(img, cw, cb, stride=4), reps=40)
    nb, fl = k8_work(B_SERVE, embed)
    k8_bound, k8_by = bound_ms(nb, bf16_flops=fl)
    sass = sass_text("K8")
    counts = sass_counts(sass, r"patch_embed_wgmma") if sass is not None else None
    log(f"K8 at B={B_SERVE}: max |d| {k8_err:.3g}, max err {rel8:.3g} of max(|x|, 1) (<= "
        f"2^-7); the einsum embed {e_emb:.3g} from it; {k8:.4f} ms (plain {k8_plain:.3f}, "
        f"einsum embed {k8_einsum:.4f}, bound {k8_bound:.4f} by {k8_by}; cuDNN conv of the "
        f"wav2img image alone (yardstick) {conv_ms:.4f} ms; back to back; queued behind a "
        f"sleeping kernel: K8 {k8_dev:.4f} ms, einsum embed {einsum_dev:.4f}, conv "
        f"{conv_dev:.4f}; host {k8_host:.4f} ms a K8 call; {smi})")
    log(f"K8 bf16 kernel SASS: "
        + (", ".join(f"{op} {n}" for op, n in counts.items()) if counts else "not measured"))
    phase_profile("one served batch with the einsum embed", lambda: serve(wav))
    return launches, {"K1": (k1_err, k1_err / ref1.abs().max().item()),
                      "K8": (k8_err, k8_rel, k8, k8_plain, k8_bound, k8_by, None, None,
                             {"einsum_ms": k8_einsum, "cudnn_conv_ms": conv_ms,
                              "device_ms": k8_dev, "einsum_device_ms": einsum_dev,
                              "cudnn_conv_device_ms": conv_dev, "host_ms": k8_host,
                              "sass": counts})}


# (n_fft, hop, window, fused_logmel_iv keywords, the kernel the route takes)
FORM_CASES = ((1024, 240, "hann", {"radix2": False}, "K9"),
              (1024, 240, "hann", {"variant": "dif"}, "K10"),
              (1024, 240, "hamming", {"variant": "dif"}, "K10"),
              (512, 100, "hann", {"radix2": False}, "K9"),
              (512, 100, "hann", {"variant": "dif"}, "K10"),
              (1024, 241, "hann", {}, "K9"),
              (1023, 241, "hamming", {}, "K9"),
              (2048, 240, "hann", {}, "K9"))
FEATURE_BUDGET = (8e-4, 7e-5)  # max |dB| log-mel, max |IV|
WIDE_MELS = (96, 128, 256)    # the mel widths over 64 the frontend forms take
# measurements at mel widths over 64, by kernel: each kernel's row of the
# `kernels` line carries its entry as "wide_mels"
WIDE_TIMES = {}
# each wide FORM_CASES case's share of its allowance under ``wide_check``,
# beside the controls' (a TF32 DFT, a bf16 mel table; K10's 3-tap)
WIDE_CONTROLS = []


def feature_errs(a, b):
    """(max |dB| over the 4 log-mel channels, max |d| over the 3 IV ones)."""
    d = (a.float() - b.float()).abs()
    return d[:, :4].max().item(), d[:, 4:].max().item()


def within_budget(errs):
    return errs[0] <= FEATURE_BUDGET[0] and errs[1] <= FEATURE_BUDGET[1]


# Over 64 mels the low bands hold one bin or none, and a one-bin band can
# sit 70-80 dB under its frame's loudest in a valley of the spectrum. A
# float32 DFT's error in a bin is set by the frame's energy, not the bin's,
# so its dB error in a band grows as the band's power falls: every float32
# form misses the float64 DFT by more than 8e-4 dB in such a valley (the
# float32 eager extractor by up to 2.8e-3 dB on this script's check data).
# So a form over 64 mels is held, in its log-mel channels, to 8e-4 dB of
# its plain version and of float64 in every band within 50 dB of its
# frame's loudest (WIDE_DEPTH, from float64), and in a deeper band to the
# larger of 8e-4 dB and what one float32 DFT's rounding can move that band
# by (``wide_bound``), DEEP_MARGIN times over against float64 and twice
# that against the plain version (two DFTs' rounding); the IV channels to
# 7e-5. A TF32 DFT and a bf16 mel table miss it (``wide_controls``).
WIDE_DEPTH = 1e-5
DEEP_MARGIN = 2.0


def wide_bound(x, n_fft, hop, window, n_mels, spec64):
    """(B, 4, n_frames, n_mels) float64: the most one float32 DFT's rounding
    moves each band, in dB. A bin's error e_k moves the band's power p =
    sum_k w_k |X_k|^2 by at most 2 d sqrt(W p) + d^2 W, W = sum_k w_k, where
    d bounds |e_k| in the frame: the independent float32 eager extractor's
    DFT (ops/stft.py::stft_dft) against the float64 one ``spec64``, its
    largest bin error over the batch relative to each frame's rms bin
    amplitude, times the frame's rms."""
    import torch
    from pseldnets_tpu_torch.ops.features import logmel_iv_filterbank
    from pseldnets_tpu_torch.ops.stft import stft_dft

    re64, im64 = spec64
    re32, im32 = stft_dft(x.float(), n_fft, hop, window)
    T = min(re32.shape[2], re64.shape[2])
    re64, im64 = re64[:, :, :T], im64[:, :, :T]
    err = torch.hypot(re32[:, :, :T].double() - re64, im32[:, :, :T].double() - im64)
    pow64 = re64 * re64 + im64 * im64
    rms = torch.sqrt(pow64.mean(dim=-1))
    rel = (err.amax(dim=-1) / rms.clamp(min=1e-300)).max()
    d = (rel * rms)[..., None]
    fb = torch.as_tensor(logmel_iv_filterbank(24000, n_fft, n_mels), device=x.device).double()
    W, p = fb.sum(dim=0), pow64 @ fb
    dp = 2.0 * d * torch.sqrt(W * p) + d * d * W
    return 10.0 / math.log(10.0) * dp / p.clamp(min=1e-300)


def wide_check(got, ref, f64, bound):
    """A form over 64 mels against its plain version ``ref`` and the
    float64 DFT ``f64`` under the rule above, ``bound`` from
    ``wide_bound``: (ok, {the largest log-mel distance from ref and from
    f64 over the bands within 50 dB of their frame's loudest, and over the
    deeper ones, the deep bands' count, the largest share of its allowance
    any distance takes, the largest IV distance})."""
    import torch

    lm = lambda t: t[:, :4].double()  # noqa: E731
    T = bound.shape[2]
    p64 = 10.0 ** (lm(f64) / 10.0)
    deep = (p64 < WIDE_DEPTH * p64.amax(dim=-1, keepdim=True))[:, :, :T]
    budget = FEATURE_BUDGET[0]
    allow = torch.where(deep, torch.clamp(DEEP_MARGIN * bound, min=budget),
                        torch.full_like(bound, budget))
    allow_ref = torch.where(deep, torch.clamp(2.0 * DEEP_MARGIN * bound, min=budget), allow)
    d_ref = (lm(got) - lm(ref)).abs()[:, :, :T]
    d_f64 = (lm(got) - lm(f64)).abs()[:, :, :T]
    worst = lambda d, m: d[m].max().item() if bool(m.any()) else 0.0  # noqa: E731
    iv = max((got[:, 4:].double() - r[:, 4:].double()).abs().max().item() for r in (ref, f64))
    info = {"shallow": (worst(d_ref, ~deep), worst(d_f64, ~deep)),
            "deep": (worst(d_ref, deep), worst(d_f64, deep)), "n_deep": int(deep.sum()),
            "share": max((d_ref / allow_ref).max().item(), (d_f64 / allow).max().item()),
            "iv": iv}
    # the frames past the float32 extractor's (an odd n_fft whose hop divides
    # N: none at these shapes) are held to the budget alone
    rest = max((lm(got) - lm(r)).abs()[:, :, T:].max().item() if got.shape[2] > T else 0.0
               for r in (ref, f64))
    return info["share"] <= 1.0 and iv <= FEATURE_BUDGET[1] and rest <= budget, info


def wide_note(info):
    """One log line's account of ``wide_check``'s numbers."""
    return (f"within 50 dB of the frame's loudest: vs plain {info['shallow'][0]:.3g} dB, vs "
            f"float64 {info['shallow'][1]:.3g} (<= 8e-4); {info['n_deep']} deeper bands: vs plain "
            f"{info['deep'][0]:.3g}, vs float64 {info['deep'][1]:.3g}; {info['share']:.3g} of the "
            f"allowance at most; IV {info['iv']:.3g} (<= 7e-5)")


def wide_controls(x, n_fft, hop, window, n_mels, f64, bound):
    """Lower-precision forms that ``wide_check`` must refuse, on the same
    clips: the flat form's DFT as one TF32 product a k (no split) and the
    float32 plain flat form with its mel table rounded to bf16. Returns
    {name: wide_check's info}, each with ok False."""
    import torch
    from pseldnets_tpu_torch.ops import frontend_forms
    from pseldnets_tpu_torch.ops.features import logmel_iv_filterbank, logmel_iv_from_spectrum

    n_frames = 1 + x.shape[-1] // hop
    frames = frontend_forms.padded_signal(x, n_fft, hop).unfold(-1, n_fft, hop)[..., :n_frames, :]
    tab = torch.as_tensor(frontend_forms._dft_table(n_fft, window), device=x.device).float()
    nf = n_fft // 2 + 1
    fb = torch.as_tensor(logmel_iv_filterbank(24000, n_fft, n_mels), device=x.device)
    # the operands rounded to tf32 as the tensor cores take them, the
    # products summed in float32
    spec = frontend_forms.tf32_round(frames) @ frontend_forms.tf32_round(tab)
    tf32 = logmel_iv_from_spectrum(spec[..., :nf], spec[..., nf:], fb)
    re, im = frontend_forms.flat_spectrum(x, n_fft, hop, window)
    bf16 = logmel_iv_from_spectrum(re, im, fb.bfloat16().float())
    out = {}
    for name, got in (("TF32 DFT", tf32), ("bf16 mel table", bf16)):
        ok, info = wide_check(got, got, f64, bound)
        out[name] = dict(info, ok=ok)
    return out


def raises(fn, exc):
    try:
        fn()
    except exc:
        return True
    return False


def phase_frontend_forms():
    """K9 and K10 at B_CHECK 10 s clips at each shape the routing gives them
    (FORM_CASES): each against its plain version and against the float32
    eager extractor, within the feature budget (8e-4 dB / 7e-5 IV), and
    beside a float64 DFT; then at 96, 128 and 256 mels (WIDE_MELS), each
    case one launch of its kernel, against its plain version and the
    float64 DFT by ``wide_check``, beside the controls it must refuse
    (``wide_controls``); K1 at 128 and 256 mels against its plain version
    (``wide_check``), float32 and in its served HTSAT form at those widths; n_fft
    2048 through LogmelIVExtractor, and in K1's folded serving form (affine,
    bf16, 1024 frames) within one bf16 ulp of the plain folded form, at 64
    and 128 mels; the routes that raise."""
    import torch
    from pseldnets_tpu_torch.ops import frontend_forms
    from pseldnets_tpu_torch.ops.features import (LogmelIVExtractor, logmel_iv_filterbank,
                                                  logmel_iv_from_spectrum)
    from pseldnets_tpu_torch.ops.frontend import (frontend_route, fused_logmel_iv,
                                                  fused_logmel_iv_plain)

    g = torch.Generator(device="cuda").manual_seed(46)
    x = torch.randn(B_CHECK, 4, N_SAMPLES, device="cuda", generator=g) * 0.1
    x[-1, :, : N_SAMPLES // 4] = 0.0  # a silent stretch: IV must stay finite
    plains = {"K9": frontend_forms.logmel_iv_flat_plain,
              "K10": frontend_forms.logmel_iv_dif_plain}

    def hold(name, what, got, ref, eager, f64, errs=feature_errs):
        e_plain, e_eager = errs(got, ref), errs(got, eager)
        log(f"{name} {what}: vs plain {e_plain[0]:.3g} dB / {e_plain[1]:.3g} IV, vs float32 "
            f"eager {e_eager[0]:.3g} / {e_eager[1]:.3g} (<= 8e-4 / 7e-5); from float64 "
            f"{feature_errs(got, f64)[0]:.3g} dB (plain {feature_errs(ref, f64)[0]:.3g}, "
            f"eager {feature_errs(eager, f64)[0]:.3g})")
        check(bool(torch.isfinite(got).all()) and within_budget(e_plain)
              and within_budget(e_eager), f"{name} {what} outside the feature budget")

    for n_fft, hop, window, kw, name in FORM_CASES:
        shape = dict(n_fft=n_fft, hop=hop, window=window)
        before = read_counts()
        got = fused_logmel_iv(x, **shape, **kw)
        torch.cuda.synchronize()
        after = read_counts()
        check(after[name] == before[name] + 1
              and sum(after.values()) == sum(before.values()) + 1,
              f"route of {shape} {kw}: counts {before} -> {after}")
        check(got.shape == (B_CHECK, 7, 1 + N_SAMPLES // hop, 64), f"{name} shape")
        fb64 = torch.as_tensor(logmel_iv_filterbank(24000, n_fft, 64), device="cuda").double()
        f64 = logmel_iv_from_spectrum(*frontend_forms.flat_spectrum(x.double(), n_fft, hop,
                                                                    window), fb64)
        hold(name, f"{shape} {kw}", got, plains[name](x, **shape),
             fused_logmel_iv_plain(x, **shape), f64)
        del f64

    # wider mels: each FORM_CASES shape at 96, 128 and 256 mels, one launch
    # of the route's kernel each (the wide form: the mel sums in a scratch
    # of the block's own), against the form's plain version and the float64
    # DFT (the float32 eager extractor logged beside)
    def f64_of(spec64, n_fft, n_mels):
        fb64 = torch.as_tensor(logmel_iv_filterbank(24000, n_fft, n_mels), device="cuda")
        return logmel_iv_from_spectrum(*spec64, fb64.double())

    def worst_band(got, ref, n_fft, n_mels):
        """Where got's largest dB distance from ref lies: (mel, the bins its
        band holds, ref's value there)."""
        d = (got[:, :4].double() - ref[:, :4].double()).abs()
        at = divmod(int(d.argmax()), n_mels)
        bins = int((logmel_iv_filterbank(24000, n_fft, n_mels)[:, at[1]] != 0).sum())
        return at[1], bins, ref[:, :4].reshape(-1)[int(d.argmax())].item()

    failed = []

    for n_fft, hop, window, kw, name in FORM_CASES:
        shape = dict(n_fft=n_fft, hop=hop, window=window)
        spec64 = frontend_forms.flat_spectrum(x.double(), n_fft, hop, window)
        for n_mels in WIDE_MELS:
            before = read_counts()
            got = fused_logmel_iv(x, **shape, n_mels=n_mels, **kw)
            torch.cuda.synchronize()
            after = read_counts()
            check(after[name] == before[name] + 1
                  and sum(after.values()) == sum(before.values()) + 1,
                  f"route of {shape} {kw} at {n_mels} mels: counts {before} -> {after}")
            check(got.shape == (B_CHECK, 7, 1 + N_SAMPLES // hop, n_mels),
                  f"{name} shape at {n_mels} mels")
            f64 = f64_of(spec64, n_fft, n_mels)
            ref = plains[name](x, **shape, n_mels=n_mels)
            eager = fused_logmel_iv_plain(x, **shape, n_mels=n_mels)
            bound = wide_bound(x, n_fft, hop, window, n_mels, spec64)
            ok, info = wide_check(got, ref, f64, bound)
            mel, bins, value = worst_band(got, f64, n_fft, n_mels)
            log(f"{name} {shape} {kw} at {n_mels} mels: {wide_note(info)}; raw largest: vs plain "
                f"{feature_errs(got, ref)[0]:.3g} dB, vs float64 {feature_errs(got, f64)[0]:.3g} "
                f"at mel {mel} ({bins} bins, {value:.2f} dB); from float64: plain "
                f"{feature_errs(ref, f64)[0]:.3g}, float32 eager {feature_errs(eager, f64)[0]:.3g}")
            if not (bool(torch.isfinite(got).all()) and ok):
                failed.append(f"{name} {shape} {kw} at {n_mels} mels")
            # what the rule refuses on the same clips: a TF32 DFT, a bf16
            # mel table; and, for K10, the 3-tap window of the narrow form
            controls = wide_controls(x, n_fft, hop, window, n_mels, f64, bound)
            if name == "K10":
                re, im = frontend_forms.dif_spectrum(x, n_fft, hop, window)
                tap = frontend_forms.tile_mel_features("dif", re, im, n_fft, n_mels, 24000)
                ok3, info3 = wide_check(tap, tap, f64, bound)
                controls["3-tap DIF (logged)"] = dict(info3, ok=ok3)
                del re, im, tap
            log("  refused: " + "; ".join(
                f"{c}: ok {v['ok']}, {v['share']:.3g} of the allowance, from float64 "
                f"{v['shallow'][1]:.3g} dB within 50 dB, {v['deep'][1]:.3g} deeper"
                for c, v in controls.items()))
            WIDE_CONTROLS.append({"case": f"{name} n_fft {n_fft} hop {hop} {window} {n_mels}",
                                  "share": info["share"],
                                  **{c: v["share"] for c, v in controls.items()}})
            if any(v["ok"] for c, v in controls.items() if "logged" not in c):
                failed.append(f"a control passed the rule at {name} {shape} {n_mels} mels")
            del f64, ref, got
        del spec64
    check(not failed, f"outside the feature budget: {failed}")

    # K1 at 128 and 256 mels: float32 against its plain version within the
    # budget (float64 logged), and in the served HTSAT form at that width
    # (ScalarBN affine, bf16, the frames of spec_size 256 x freq_ratio: hop
    # 480 and 512 frames at 128 mels, hop 960 and 256 at 256) within one
    # bf16 ulp
    spec64 = frontend_forms.flat_spectrum(x.double(), 1024, 240)
    for n_mels, hop, t_out in ((128, 480, 512), (256, 960, 256)):
        before = read_counts()
        got = fused_logmel_iv(x, n_mels=n_mels)
        torch.cuda.synchronize()
        check(read_counts()["K1"] == before["K1"] + 1, f"K1 at {n_mels} mels")
        ref = fused_logmel_iv_plain(x, n_mels=n_mels)  # also the eager extractor
        f64 = f64_of(spec64, 1024, n_mels)
        ok, info = wide_check(got, ref, f64, wide_bound(x, 1024, 240, "hann", n_mels, spec64))
        mel, bins, value = worst_band(got, f64, 1024, n_mels)
        log(f"K1 float32 at {n_mels} mels: {wide_note(info)}; raw largest: vs plain "
            f"{feature_errs(got, ref)[0]:.3g} dB, vs float64 {feature_errs(got, f64)[0]:.3g} at "
            f"mel {mel} ({bins} bins, {value:.2f} dB); plain from float64 "
            f"{feature_errs(ref, f64)[0]:.3g}")
        if not (bool(torch.isfinite(got).all()) and ok):
            failed.append(f"K1 float32 at {n_mels} mels")
        inv = torch.rand(7, n_mels, device="cuda", generator=g) + 0.5
        shift = torch.randn(7, n_mels, device="cuda", generator=g)
        kw = dict(post_affine=(inv, shift), out_dtype=torch.bfloat16, t_out=t_out, hop=hop,
                  n_mels=n_mels)
        got = fused_logmel_iv(x, **kw)
        ref = fused_logmel_iv_plain(x, **kw)
        check(got.shape == (B_CHECK, 7, t_out, n_mels) and got.dtype == torch.bfloat16
              and bool((got[:, :, 1 + N_SAMPLES // hop:] == 0).all())
              and torch.equal(got, fused_logmel_iv(x, **kw)), f"K1 served form at {n_mels} mels")
        rel = ((got.float() - ref.float()).abs() / ref.float().abs().clamp(min=1.0)).max().item()
        log(f"K1 served HTSAT form at {n_mels} mels (hop {hop}, affine, bf16, {t_out} frames): "
            f"max err {rel:.3g} of max(|x|, 1) (<= 2^-7), two launches equal")
        check(rel <= 2.0 ** -7, f"K1 served form at {n_mels} mels disagrees with its plain version")
        del f64
    del spec64
    check(not failed, f"outside the feature budget: {failed}")

    # n_fft 2048 through the extractor a SELDTask builds, then folded, at 64
    # and 128 mels
    shape = dict(n_fft=2048, hop=240)
    spec64 = frontend_forms.flat_spectrum(x.double(), 2048, 240)
    for n_mels in (64, 128):
        cfg = {"data": {"nfft": 2048, "hoplen": 240, "window": "hann", "sample_rate": 24000,
                        "n_mels": n_mels}}
        before = read_counts()["K9"]
        got = LogmelIVExtractor(cfg)(x)
        check(read_counts()["K9"] == before + 1, "LogmelIVExtractor at n_fft 2048 runs K9")
        check(got.shape == (B_CHECK, 7, 1001, n_mels), "LogmelIVExtractor shape")
        what = f"LogmelIVExtractor n_fft 2048, {n_mels} mels"
        ref = frontend_forms.logmel_iv_flat_plain(x, **shape, n_mels=n_mels)
        eager = fused_logmel_iv_plain(x, **shape, n_mels=n_mels)
        if n_mels <= 64:
            hold("K9", what, got, ref, eager, f64_of(spec64, 2048, n_mels))
        else:
            ok, info = wide_check(got, ref, f64_of(spec64, 2048, n_mels),
                                  wide_bound(x, 2048, 240, "hann", n_mels, spec64))
            log(f"K9 {what}: {wide_note(info)}")
            check(bool(torch.isfinite(got).all()) and ok, f"K9 {what} outside the feature budget")
        inv = torch.rand(7, n_mels, device="cuda", generator=g) + 0.5
        shift = torch.randn(7, n_mels, device="cuda", generator=g)
        kw = dict(post_affine=(inv, shift), out_dtype=torch.bfloat16, t_out=1024, n_mels=n_mels)
        got = fused_logmel_iv(x, **shape, **kw)
        ref = frontend_forms.logmel_iv_flat_plain(x, **shape, **kw)
        check(got.shape == (B_CHECK, 7, 1024, n_mels) and got.dtype == torch.bfloat16
              and bool((got[:, :, 1001:] == 0).all()), "K9 folded form shape, dtype, zero tail")
        rel = ((got.float() - ref.float()).abs() / ref.float().abs().clamp(min=1.0)).max().item()
        log(f"K9 folded serving form (n_fft 2048, {n_mels} mels, affine, bf16, 1024 frames): "
            f"max err {rel:.3g} of max(|x|, 1) (<= 2^-7)")
        check(rel <= 2.0 ** -7, "K9 folded form disagrees with its plain version")
    del spec64

    # the routes that raise, as in the JAX package
    nie = NotImplementedError
    inv = torch.rand(7, 64, device="cuda", generator=g) + 0.5
    shift = torch.randn(7, 64, device="cuda", generator=g)
    cases = {"hop >= n_fft": lambda: frontend_route(1024, 1024),
             "DIF with folds": lambda: fused_logmel_iv(x, variant="dif", out_dtype=torch.bfloat16),
             "radix2=False with folds": lambda: fused_logmel_iv(x, radix2=False,
                                                                post_affine=(inv, shift)),
             "odd hop with folds": lambda: fused_logmel_iv(x, hop=241, t_out=1024)}
    for what, fn in cases.items():
        check(raises(fn, nie), f"the route does not raise for {what}")
    log(f"routes that raise NotImplementedError: {', '.join(cases)}")


def phase_features_form(smi, name, kw):
    """One main path of the frontend's forms: B_SERVE 10 s clips (1001
    frames, n_fft 1024, hop 240, float32) through fused_logmel_iv(**kw),
    counted from 0 (the form's kernel once, K1 never); the output against
    the plain version within the feature budget; timed beside the plain
    version and K1 on the same batch (the same function), against k1_work's
    bound at this shape."""
    import torch
    from pseldnets_tpu_torch.ops import frontend_forms
    from pseldnets_tpu_torch.ops.features import logmel_iv_filterbank, logmel_iv_from_spectrum
    from pseldnets_tpu_torch.ops.frontend import fused_logmel_iv

    plain = {"K9": frontend_forms.logmel_iv_flat_plain,
             "K10": frontend_forms.logmel_iv_dif_plain}[name]
    g = torch.Generator(device="cuda").manual_seed(47)
    x = torch.randn(B_SERVE, 4, N_SAMPLES, device="cuda", generator=g) * 0.1
    run = lambda: fused_logmel_iv(x, **kw)  # noqa: E731
    run()  # warm-up: the tables
    torch.cuda.synchronize()

    zero_counts()
    out = run()
    torch.cuda.synchronize()
    launches = read_counts()
    want = expected(**{name: 1})
    log(f"fused_logmel_iv({kw}) on {B_SERVE} x 10 s clips: launches {launches} (expect {want})")
    check(launches == want, f"{name} path launch counts")
    check(out.shape == (B_SERVE, 7, 1001, 64) and bool(torch.isfinite(out).all()),
          f"{name} output {tuple(out.shape)}")
    ref = plain(x, n_fft=1024, hop=240)
    errs = feature_errs(out, ref)
    err = (out - ref).abs().max().item()
    check(within_budget(errs), f"{name} outside the feature budget at B={B_SERVE}")
    ms = cuda_ms(run, reps=5)
    plain_ms = cuda_ms(lambda: plain(x, n_fft=1024, hop=240), reps=2)
    k1_ms = cuda_ms(lambda: fused_logmel_iv(x), reps=10)
    nb, fl = k1_work(B_SERVE, t_out=1001, out_bytes=4, affine=False)
    bound, by = bound_ms(nb, f32_flops=fl)
    tables = (frontend_forms._flat_kernel_tables(1024, "hann", 64, 24000, x.device) if name == "K9"
              else frontend_forms._dif_kernel_tables(1024, 64, 24000, x.device))
    n_tiles, _, cols, Kp = tables[0].shape
    # the DFT GEMM once, and the tensor cores' work: its three split-TF32
    # products (the mel GEMM's are left out: 1/16 of K9's, 1/8 of K10's)
    gemm = 2.0 * B_SERVE * 4 * 1001 * Kp * cols * n_tiles
    log(f"{name} at B={B_SERVE} ({smi}): vs plain {errs[0]:.3g} dB / {errs[1]:.3g} IV; "
        f"{ms:.3f} ms ({gemm / 1e12:.3f} TFLOP of DFT, {3 * gemm / ms / 1e9:.1f} TFLOP/s of "
        f"split-TF32 products, {3 * gemm / ms / 1e9 / 495:.0%} of 495 dense TF32), plain "
        f"{plain_ms:.3f} ms, K1 on the same batch {k1_ms:.3f} ms, bound {bound:.4f} ms by {by}")
    # the same batch at 128 mels (the wide form), beside its plain version
    # and K1 at 128 mels; the tiles' mel groups and the scratch it needs
    wide = lambda: fused_logmel_iv(x, n_mels=128, **kw)  # noqa: E731
    out = wide()
    ref = plain(x, n_fft=1024, hop=240, n_mels=128)
    errs128 = feature_errs(out, ref)
    fb64 = torch.as_tensor(logmel_iv_filterbank(24000, 1024, 128), device=x.device).double()
    spec64 = frontend_forms.flat_spectrum(x.double(), 1024, 240)
    f64 = logmel_iv_from_spectrum(*spec64, fb64)
    ok, info = wide_check(out, ref, f64, wide_bound(x, 1024, 240, "hann", 128, spec64))
    del spec64
    ok = ok and out.shape == (B_SERVE, 7, 1001, 128)
    log(f"{name} at 128 mels, B={B_SERVE}: {wide_note(info)}")
    del f64
    check(ok, f"{name} at 128 mels outside the feature budget at B={B_SERVE}")
    ms128 = cuda_ms(wide, reps=5)
    plain128 = cuda_ms(lambda: plain(x, n_fft=1024, hop=240, n_mels=128), reps=2)
    k1_128 = cuda_ms(lambda: fused_logmel_iv(x, n_mels=128), reps=10)
    nb, fl = k1_work(B_SERVE, t_out=1001, out_bytes=4, affine=False, n_mels=128)
    b128, by128 = bound_ms(nb, f32_flops=fl)
    lp = frontend_forms.launch_plan("flat" if name == "K9" else "dif", B_SERVE, N_SAMPLES, 1024,
                                    240, 128, 24000, 1001)
    WIDE_TIMES.setdefault(name, {})[f"128 mels, n_fft 1024, hop 240, B={B_SERVE}"] = {
        "ms": ms128, "plain_ms": plain128, "bound_ms": b128, "bound_by": by128,
        "k1_ms": k1_128, "max_abs_err_db_iv": errs128, "mel_groups": lp["mel_groups"]}
    log(f"{name} at 128 mels, B={B_SERVE} ({smi}): vs plain {errs128[0]:.3g} dB / "
        f"{errs128[1]:.3g} IV; {ms128:.3f} ms (64 mels: {ms:.3f}), plain {plain128:.3f} ms, "
        f"K1 at 128 mels {k1_128:.3f} ms, bound {b128:.4f} ms by {by128}; mel groups a tile "
        f"{lp['mel_groups']}, scratch {math.prod(lp['scratch']) * 4 / 2 ** 20:.0f} MiB")
    return launches, {name: (err, err / ref.abs().max().item(), ms, plain_ms, bound, by, None,
                             None, {"k1_ms": k1_ms, "tf32_tflop_s": 3 * gemm / ms / 1e9})}


# the served paths at 128 mels through SELDTask's eval route, bf16: HTSAT
# mACCDOA at spec_size 256, freq_ratio 2 (hop 480: 501 frames of the
# 512-frame image, pred_res 5, 100 label frames) and PaSST mACCDOA at its
# published 128 bins (img_size (128, 1001): 12 x 100 patches + 2 tokens, 1202)
HTSAT128_OVERRIDES = ["loss=multi_accdoa", "model.kwargs.pretrained_path=null",
                      "model.kwargs.audioset_pretrain=false", "trainer.precision=bf16-mixed",
                      "data.n_mels=128", "data.hoplen=480"]
PASST128_OVERRIDES = PASST_OVERRIDES + ["trainer.precision=bf16-mixed", "data.n_mels=128",
                                        "model.kwargs.img_size=[128,1001]"]


def phase_serve_wide(smi, route, overrides, per_batch, seed):
    """A served path at 128 mels: SERVE_BATCHES batches of B_SERVE 10 s
    clips through ``SELDTask.eval_step`` (the eval route from the waveform,
    the eval ScalarBN folded into K1), counted from 0 (``per_batch`` launches
    a batch, no other kernel); the outputs against the same step on the
    plain versions (the serving bound 5e-2) and a float32 plain run; K1 on
    the batch against its plain version, and K8 (HTSAT) or K6 (PaSST) on
    the batch's own inputs, each timed beside its plain version and bound
    (WIDE_TIMES); the ms a batch."""
    import torch
    from pseldnets_tpu_torch import serving
    from pseldnets_tpu_torch.ops import patch_embed, vit_block
    from pseldnets_tpu_torch.serving.passt import passt_tokens

    task, _ = eval_task(overrides, seed)
    m, ex = task.full_model(), task.extractor
    check(task.eval_route() == route and ex.n_mels == 128, f"{route} at 128 mels: its route")
    g = torch.Generator(device="cuda").manual_seed(seed)
    wavs = [torch.randn(B_SERVE, 4, N_SAMPLES, device="cuda", generator=g) * 0.1
            for _ in range(SERVE_BATCHES)]
    check(task._folds_from_wav(wavs[0]), f"{route} at 128 mels: served from the waveform")
    step = lambda w: task.eval_step({"data": w})["multi_accdoa"]  # noqa: E731
    step(wavs[0])  # warm-up: the route's weights, the frontend's tables
    torch.cuda.synchronize()

    # the main path: counts from 0, SERVE_BATCHES batches
    zero_counts()
    t0 = time.perf_counter()
    outs = [step(w) for w in wavs]
    torch.cuda.synchronize()
    dt = (time.perf_counter() - t0) / SERVE_BATCHES
    launches = read_counts()
    want = expected(**{k: n * SERVE_BATCHES for k, n in per_batch.items()})
    log(f"{route} at 128 mels: served {SERVE_BATCHES} batches of {B_SERVE} x 10 s clips through "
        f"SELDTask.eval_step: launches {launches} (expect {want})")
    check(launches == want, f"{route} at 128 mels: launch counts")
    for o in outs:
        check(o.shape == (B_SERVE, 100, 117) and o.dtype == torch.float32
              and torch.isfinite(o).all().item(), f"{route} 128 mels output {tuple(o.shape)}")
    task.set_use_kernels(False)
    plain = step(wavs[0])
    task.set_use_kernels(True)
    fe = dict(n_fft=ex.n_fft, hop=ex.hop, window=ex.window, n_mels=ex.n_mels, sample_rate=ex.sr)
    fn = {"htsat": serving.htsat_fused_forward_from_wav,
          "passt": serving.passt_fused_forward_from_wav}[route]
    f32 = fn(m, wavs[0], compute_dtype=torch.float32, use_kernels=False, **fe)["multi_accdoa"]
    e_plain = (outs[0] - plain).abs().max().item()
    e_f32 = (outs[0] - f32).abs().max().item()
    p_f32 = (plain - f32).abs().max().item()
    log(f"{route} at 128 mels: {dt * 1e3:.2f} ms/batch, {B_SERVE / dt:.1f} clips/s (host clock, "
        f"synchronized; {smi}); vs the plain step {e_plain:.3g} (<= 5e-2), vs float32 plain "
        f"{e_f32:.3g} (plain bf16 {p_f32:.3g})")
    check(e_plain <= 5e-2, f"{route} at 128 mels disagrees with the plain step")
    check(e_f32 <= 1.25 * p_f32 + 1e-2, f"{route} at 128 mels further from float32 than plain")

    # K1 in the route's form on the batch, then the route's next kernel
    wav = wavs[0]
    t_out = m.encoder.spec_size * m.encoder.freq_ratio if route == "htsat" else None
    feats = serving.folded_wav_features(m, wav, t_out=t_out, **fe)
    ref = serving.folded_wav_features(m, wav, t_out=t_out, use_kernels=False, **fe).float()
    frames = t_out or 1001
    check(feats.shape == (B_SERVE, 7, frames, 128), f"K1 form {tuple(feats.shape)}")
    k1_err = (feats.float() - ref).abs().max().item()
    rel = ((feats.float() - ref).abs() / ref.abs().clamp(min=1.0)).max().item()
    check(rel <= 2.0 ** -7, f"K1 disagrees with its plain version ({route}, 128 mels)")
    k1 = cuda_ms(lambda: serving.folded_wav_features(m, wav, t_out=t_out, **fe), reps=10)
    k1_plain = cuda_ms(lambda: serving.folded_wav_features(m, wav, t_out=t_out,
                                                           use_kernels=False, **fe), reps=2)
    nb, fl = k1_work(B_SERVE, hop=ex.hop, t_out=frames, n_mels=128)
    k1_bound, k1_by = bound_ms(nb, f32_flops=fl)
    WIDE_TIMES.setdefault("K1", {})[f"serve_{route}128 (hop {ex.hop}, {frames} frames, "
                                    f"affine, bf16, B={B_SERVE})"] = {
        "ms": k1, "plain_ms": k1_plain, "bound_ms": k1_bound, "bound_by": k1_by}
    log(f"K1 at 128 mels ({route} form, {frames} frames): max err {rel:.3g} of max(|x|, 1) "
        f"(<= 2^-7); {k1:.3f} ms, plain {k1_plain:.3f} ms, bound {k1_bound:.4f} ms by {k1_by}")
    errs = {"K1": (k1_err, k1_err / ref.abs().max().item())}
    params = task._eval_params(route)
    if route == "htsat":
        embed = params["embed"]
        got = patch_embed.patch_embed_tokens(feats, embed).float()
        ref8 = patch_embed.patch_embed_tokens_plain(feats, embed).float()
        err = (got - ref8).abs().max().item()
        rel8 = ((got - ref8).abs() / ref8.abs().clamp(min=1.0)).max().item()
        check(got.shape == (B_SERVE, 4096, 96) and rel8 <= 2.0 ** -7,
              f"K8 at F=128 disagrees with its plain version ({rel8:.3g})")
        ms = cuda_ms(lambda: patch_embed.patch_embed_tokens(feats, embed), reps=20)
        plain_ms = cuda_ms(lambda: patch_embed.patch_embed_tokens_plain(feats, embed), reps=5)
        nb, fl = k8_work(B_SERVE, embed, 128)
        b_ms, by = bound_ms(nb, bf16_flops=fl)
        WIDE_TIMES.setdefault("K8", {})[f"serve_htsat128 (F=128, B={B_SERVE})"] = {
            "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": by}
        log(f"K8 at F=128 on the batch: max err {rel8:.3g} of max(|x|, 1) (<= 2^-7); {ms:.4f} "
            f"ms, plain {plain_ms:.3f} ms, bound {b_ms:.4f} ms by {by}")
        errs["K8"] = (err, err / ref8.abs().max().item())
    else:
        blocks = params["blocks"]
        with torch.no_grad():
            xs = [passt_tokens(m, feats, torch.bfloat16)]
            for p in blocks[:-1]:
                xs.append(vit_block.vit_block_fused(xs[-1], p))
        n_tok = math.prod(m.encoder.grid_size) + 2
        check(xs[0].shape == (B_SERVE, n_tok, 768), f"PaSST tokens {tuple(xs[0].shape)}")
        k6 = [0.0, 0.0, 0.0]
        err6, rel6 = 0.0, 0.0
        for i, (x, p) in enumerate(zip(xs, blocks)):
            ref6 = vit_block.vit_block_plain(x, p).float()
            scale = ref6.abs().max().item()
            err = (vit_block.vit_block_fused(x, p).float() - ref6).abs().max().item()
            check(err <= 2.0 ** -6 * scale, f"K6 block {i} at N={n_tok} disagrees with its plain")
            err6, rel6 = max(err6, err), max(rel6, err / scale)
            k6[0] += cuda_ms(lambda: vit_block.vit_block_fused(x, p), reps=3)
            k6[1] += cuda_ms(lambda: vit_block.vit_block_plain(x, p), reps=1)
            nb, fl = k6_work(B_SERVE, n_tok, p)
            k6[2] += bound_ms(nb, bf16_flops=fl)[0]
        WIDE_TIMES.setdefault("K6", {})[f"serve_passt128 (N={n_tok}, 7 blocks, B={B_SERVE})"] = {
            "ms": k6[0], "plain_ms": k6[1], "bound_ms": k6[2], "bound_by": "operations"}
        log(f"K6 x7 at N={n_tok} on the batch's block inputs: max err {rel6:.3g} of scale (<= "
            f"2^-6); {k6[0]:.3f} ms, plain {k6[1]:.3f} ms, bound {k6[2]:.3f} ms")
        errs["K6"] = (err6, rel6)
    WIDE_TIMES.setdefault("paths", {})[f"serve_{route}128"] = {
        "ms_per_batch": dt * 1e3, "clips_per_s": B_SERVE / dt}
    return launches, errs


def random_stage(i, gen, shifts=None):
    """Stage-i full-width Swin stage at its full depth (DEPTHS) with seeded
    weights, or with one block per entry of ``shifts``."""
    import torch
    from pseldnets_tpu_torch.models.factory import init_weights
    from pseldnets_tpu_torch.models.htsat import BasicLayer, SwinTransformerBlock

    H, C, nh = 64 >> i, 96 << i, 4 << i
    if shifts is None:
        layer = BasicLayer(C, (H, H), DEPTHS[i], nh, 8)
    else:
        layer = torch.nn.Module()
        layer.blocks = torch.nn.ModuleList(
            [SwinTransformerBlock(C, (H, H), nh, 8, shift_size=s) for s in shifts])
    init_weights(layer, gen)
    return layer.cuda().eval()


def k2_chained(x, sp):
    """K2 run block after block over a stage's blocks (no merge): what K11
    computes in one launch."""
    from pseldnets_tpu_torch.ops.swin_block import swin_block_fused

    for d in range(sp.depth):
        x = swin_block_fused(x, sp.block(d))
    return x


def check_stage(name, got, x, sp, sp32=None):
    """K11's output ``got`` on x against its plain version, block by block:
    bitwise equal to K2 run block after block (the same tile code in the
    same order), each of those blocks within K2's 2^-6 of the output's
    largest magnitude of its plain version on its own input; the whole stage
    within depth x 2^-6 of the plain stage's (each block's one-ulp flips
    carry into the next) and, given the float32 weights sp32, no further
    from the float32 plain stage than the plain bf16 stage is (x1.25 plus
    one bf16 ulp of the scale). Returns the stage's max abs error from the
    plain version, absolute and as a share of its scale."""
    import torch
    from pseldnets_tpu_torch.ops.swin_block import swin_block_fused, swin_block_plain
    from pseldnets_tpu_torch.ops.swin_stage import swin_stage_plain

    xs, blk_rel = x, 0.0
    for d in range(sp.depth):
        p = sp.block(d)
        y = swin_block_fused(xs, p)
        ref = swin_block_plain(xs, p).float()
        e, sc = (y.float() - ref).abs().max().item(), ref.abs().max().item()
        check(e <= 2.0 ** -6 * sc, f"{name}: K2 block {d} disagrees with its plain version")
        blk_rel, xs = max(blk_rel, e / sc), y
    plain16 = swin_stage_plain(x, sp).float()
    scale = plain16.abs().max().item()
    err = (got.float() - plain16).abs().max().item()
    tol = sp.depth * 2.0 ** -6
    msg = (f"  {name}: = K2 chained {torch.equal(got, xs)}, its blocks <= {blk_rel:.3g} of "
           f"scale from plain (<= 2^-6); stage |k-plain16| {err:.3g} = {err / scale:.3g} of "
           f"scale {scale:.3g} (<= {tol:.3g})")
    ok = torch.equal(got, xs) and err <= tol * scale
    if sp32 is not None:
        plain32 = swin_stage_plain(x.float(), sp32)
        e32 = (got.float() - plain32).abs().max().item()
        p_e32 = (plain16 - plain32).abs().max().item()
        msg += f", |k-plain32| {e32:.3g} (plain16 {p_e32:.3g})"
        ok = ok and e32 <= 1.25 * p_e32 + 2.0 ** -7 * scale
    log(msg)
    check(ok and torch.isfinite(got).all().item(), f"{name} disagrees with its plain version")
    return err, err / scale


def phase_swin_stage():
    """K11 against its plain version (check_stage, bf16 and float32) at
    B_CHECK at the four served stage shapes, full width and depth, through
    v2; then v1 on a pattern v2 refuses, (0, 4, 4, 0, 0, 4) at stage 2's
    shape. Each with a second launch bitwise equal to the first (a missing
    grid barrier shows as a difference)."""
    import torch
    from pseldnets_tpu_torch.ops.swin_stage import (prepare_stage, swin_stage_fused,
                                                    swin_stage_fused_v2)

    gen = torch.Generator().manual_seed(6)
    for i, shifts in [(i, None) for i in range(4)] + [(2, (0, 4, 4, 0, 0, 4))]:
        layer = random_stage(i, gen, shifts)
        H, C = 64 >> i, 96 << i
        x = torch.randn(B_CHECK, H * H, C, generator=gen).cuda().bfloat16()
        p16 = prepare_stage(layer, torch.bfloat16)
        fn = swin_stage_fused_v2 if shifts is None else swin_stage_fused
        got = fn(x, p16)
        torch.cuda.synchronize()
        again = fn(x, p16)
        torch.cuda.synchronize()
        log(f"K11 stage {i} {H}x{H} C={C} shifts {p16.shifts} "
            f"({'v2' if shifts is None else 'v1'}): second launch bitwise equal "
            f"{torch.equal(got, again)}")
        check(torch.equal(got, again), f"K11 stage {i}: two launches on one input differ")
        check_stage(f"K11 s{i}", got, x, p16, prepare_stage(layer, torch.float32))
        if shifts is not None:
            check(raises(lambda: swin_stage_fused_v2(x, p16), ValueError),
                  "swin_stage_fused_v2 took a non-alternating pattern")


def k11_work(B, sp):
    """Bytes and bf16 FLOPs of one K11 call on B images: K2's FLOPs
    (k2_work) summed over the stage's blocks, no merge; the tokens read and
    written once, every block's weights and the one mask read once."""
    tokens = B * sp.H * sp.W * sp.C * 2
    nbytes, flops = 2 * tokens, 0
    for d in range(sp.depth):
        p = sp.block(d)
        nb, fl = k2_work(B, p)
        nbytes += nb - 2 * tokens - (p.mask.numel() * 4 if p.mask is not None else 0)
        flops += fl
    if sp.mask is not None:
        nbytes += sp.mask.numel() * 4
    return nbytes, flops


def phase_serve_stage(smi):
    """HTSAT mACCDOA served one Swin stage per launch
    (htsat_fused_forward_from_wav(..., swin="stage")): SERVE_BATCHES batches
    of B_SERVE 10 s clips (K1 x1, K11 x4 per batch, K2 x0), counted from 0;
    the output against the plain stage path, float32 and the block path;
    the served time beside swin="block", in turns in this process; K11 on
    each stage's own input against its plain version (check_stage), timed
    beside K2 chained and the plain version; the eager merges timed; one
    batch at B=128; a profile."""
    import torch
    from pseldnets_tpu_torch.ops.patch_embed import patch_embed_tokens
    from pseldnets_tpu_torch.ops.swin_stage import swin_stage_fused_v2, swin_stage_plain
    from pseldnets_tpu_torch.serving import (folded_wav_features, htsat_fused_forward_from_wav,
                                             prepare_blocks, prepare_patch_embed, prepare_stages)
    from pseldnets_tpu_torch.serving.htsat import patch_merging

    model = htsat_serving_model()
    blocks = prepare_blocks(model.encoder, torch.bfloat16)
    stages = prepare_stages(model.encoder, torch.bfloat16)
    embed = prepare_patch_embed(model.encoder, torch.bfloat16)
    check([sp.depth for sp in stages] == list(DEPTHS)
          and [sp.shifts[-1] for sp in stages] == [4, 4, 4, 0], "stage plan")
    g = torch.Generator(device="cuda").manual_seed(46)
    wavs = [torch.randn(B_SERVE, 4, N_SAMPLES, device="cuda", generator=g) * 0.1
            for _ in range(SERVE_BATCHES)]
    serve = lambda w: htsat_fused_forward_from_wav(  # noqa: E731
        model, w, swin="stage", stages=stages, embed=embed)
    serve_block = lambda w: htsat_fused_forward_from_wav(  # noqa: E731
        model, w, blocks=blocks, embed=embed)

    def timed(fn):
        t0 = time.perf_counter()
        out = [fn(w)["multi_accdoa"] for w in wavs]
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / SERVE_BATCHES, out

    serve(wavs[0])  # warm-up
    serve_block(wavs[0])
    torch.cuda.synchronize()

    # the main path: counts from 0, SERVE_BATCHES batches
    zero_counts()
    dt, outs = timed(serve)
    launches = read_counts()
    want = expected(K1=SERVE_BATCHES, K8=SERVE_BATCHES, K11=4 * SERVE_BATCHES)
    log(f"one stage per launch: served {SERVE_BATCHES} batches of {B_SERVE} x 10 s clips: "
        f"launches {launches} (expect {want})")
    check(launches == want, "serving launch counts with swin='stage'")
    for o in outs:
        check(o.shape == (B_SERVE, 100, 117) and o.dtype == torch.float32
              and torch.isfinite(o).all().item(), f"served output {tuple(o.shape)}")
    # the block path and this one again, in turns: stage, block, block, stage
    dt_b1, blk = timed(serve_block)
    dt_b2, _ = timed(serve_block)
    dt2, _ = timed(serve)
    dt_s, dt_b = (dt + dt2) / 2, (dt_b1 + dt_b2) / 2
    log(f"served with swin='stage': {dt_s * 1e3:.2f} ms/batch ({dt * 1e3:.2f}, "
        f"{dt2 * 1e3:.2f}), {B_SERVE / dt_s:.1f} clips/s; swin='block' {dt_b * 1e3:.2f} "
        f"ms/batch ({dt_b1 * 1e3:.2f}, {dt_b2 * 1e3:.2f}), {B_SERVE / dt_b:.1f} clips/s "
        f"(host clock, synchronized; {smi})")
    plain = htsat_fused_forward_from_wav(model, wavs[0], use_kernels=False, swin="stage",
                                         stages=stages)["multi_accdoa"]
    f32 = htsat_fused_forward_from_wav(model, wavs[0], compute_dtype=torch.float32,
                                       use_kernels=False, swin="stage")["multi_accdoa"]
    e_plain = (outs[0] - plain).abs().max().item()
    e_f32 = (outs[0] - f32).abs().max().item()
    p_f32 = (plain - f32).abs().max().item()
    e_blk = (outs[0] - blk[0]).abs().max().item()
    log(f"served (swin='stage') vs plain bf16 stage path: max |d| {e_plain:.3g} (<= 5e-2); "
        f"vs float32 plain path {e_f32:.3g} (plain bf16 {p_f32:.3g}); vs the block path "
        f"{e_blk:.3g} (<= 5e-2, the merge's rounding)")
    check(e_plain <= 5e-2, "served output (swin='stage') disagrees with the plain path")
    check(e_f32 <= 1.25 * p_f32 + 1e-2, "served output (swin='stage') further from float32")
    check(e_blk <= 5e-2, "the stage and block paths' served outputs differ beyond bf16")

    # K1 on the batch's own waveform; K11 on each stage's own input against
    # its plain version, timed beside K2 chained and the plain version; the
    # merges timed
    wav = wavs[0]
    feats = folded_wav_features(model, wav, t_out=1024)
    ref1 = folded_wav_features(model, wav, t_out=1024, use_kernels=False).float()
    k1_err = (feats.float() - ref1).abs().max().item()
    rel = ((feats.float() - ref1).abs() / ref1.abs().clamp(min=1.0)).max().item()
    check(rel <= 2.0 ** -7, f"K1 disagrees with its plain version at B={B_SERVE}")
    rows, k11_err, k11_rel, merge_ms = [], 0.0, 0.0, 0.0
    with torch.no_grad():
        x = patch_embed_tokens(feats, embed)
        for i, (layer, sp) in enumerate(zip(model.encoder.layers, stages)):
            got = swin_stage_fused_v2(x, sp)
            err, rel = check_stage(f"K11 stage {i} at B={B_SERVE}", got, x, sp)
            k11_err, k11_rel = max(k11_err, err), max(k11_rel, rel)
            t = cuda_ms(lambda x=x, sp=sp: swin_stage_fused_v2(x, sp), reps=10)
            tk2 = cuda_ms(lambda x=x, sp=sp: k2_chained(x, sp), reps=10)
            tp = cuda_ms(lambda x=x, sp=sp: swin_stage_plain(x, sp), reps=2)
            nb, fl = k11_work(B_SERVE, sp)
            rows.append((t, tp, tk2) + bound_ms(nb, bf16_flops=fl))
            log(f"  K11 stage {i} {sp.H}x{sp.W} C={sp.C} depth {sp.depth}: {t:.3f} ms, "
                f"K2 chained {tk2:.3f} ms, plain {tp:.3f} ms, bound {rows[-1][3]:.4f} ms "
                f"by {rows[-1][4]}")
            x = got
            if layer.downsample is not None:
                mrg = layer.downsample
                tm = cuda_ms(lambda x=x, m=mrg: patch_merging(m, x, torch.bfloat16), reps=10)
                merge_ms += tm
                log(f"  merge after stage {i}: {tm:.3f} ms")
                x = patch_merging(mrg, x, torch.bfloat16)
    k11_ms, k11_plain, k2_ms, k11_bound = (sum(r[j] for r in rows) for j in range(4))
    k11_by = "operations" if all(r[4] == "operations" for r in rows) else "bytes"
    log(f"per batch of {B_SERVE} ({smi}): K11 x4 {k11_ms:.3f} ms (K2 x12 on the same stages "
        f"{k2_ms:.3f}, plain {k11_plain:.3f}, bound {k11_bound:.4f}), eager merges x3 "
        f"{merge_ms:.3f} ms")
    b128 = serve_b128("served with swin='stage'", serve, model, smi)
    phase_profile("one served batch, one Swin stage per launch", lambda: serve(wav))
    return launches, {"K1": (k1_err, k1_err / ref1.abs().max().item()),
                      "K11": (k11_err, k11_rel, k11_ms, k11_plain, k11_bound, k11_by,
                              None, None, {"k2_chained_ms": k2_ms, "merges_ms": merge_ms,
                                           "served_b128": b128})}


# bench_all.py's einv2_agg: EINV2 dual HTSAT with the AGG loss
# (configs/loss/einv2_pit_agg.yaml), full width, 13 classes
EINV2_OVERRIDES = ["loss=einv2_pit_agg", "model.kwargs.pretrained_path=null",
                   "model.kwargs.audioset_pretrain=false"]
EINV2_SHAPES = {"sed": (3, 13), "doa": (3, 3)}


def einv2_model():
    """The EINV2 dual HTSAT at full published width, seeded random weights,
    non-trivial eval ScalarBN statistics, on the card."""
    import torch
    from pseldnets_tpu_torch.config import compose
    from pseldnets_tpu_torch.models import build_model

    cfg = compose(str(ROOT / "configs"), "train", EINV2_OVERRIDES)
    model, meta = build_model(cfg, 13, device="cuda", seed=0)
    check(meta["method"] == "einv2" and meta["backbone"] == "HTSAT", "EINV2 configuration")
    gen = torch.Generator().manual_seed(17)
    with torch.no_grad():
        model.scalar.running_mean.copy_(torch.randn(7, 64, generator=gen) * 5.0 - 20.0)
        model.scalar.running_var.copy_(torch.rand(7, 64, generator=gen) * 50.0 + 10.0)
    return model


def max_diff(a, b):
    return max((a[k].float() - b[k].float()).abs().max().item() for k in EINV2_SHAPES)


def phase_serve_einv2(smi):
    """EINV2 dual HTSAT served from the waveform
    (einv2_htsat_fused_forward_from_wav): SERVE_BATCHES batches of B_SERVE
    10 s clips (K1 x1, K8 x1 (the DOA branch), K2 x24 (12 a branch) per
    batch), counted from 0; the outputs against the plain path and float32;
    K1, K8 and K2 (both branches, every block) on the batch's own inputs
    against their plain versions, timed; K8 refusing the SED branch's four
    channels; one batch at B=128; a profile."""
    import torch
    from pseldnets_tpu_torch.ops import swin_block
    from pseldnets_tpu_torch.ops.patch_embed import (patch_embed_tokens,
                                                     patch_embed_tokens_plain)
    from pseldnets_tpu_torch.serving import (einv2_htsat_fused_forward_from_wav, embed_tokens,
                                             folded_wav_features, prepare_einv2,
                                             prepare_patch_embed)
    from pseldnets_tpu_torch.serving import einv2 as serving_einv2

    model = einv2_model()
    params = prepare_einv2(model, torch.bfloat16)
    check(params.sed.embed is None and params.doa.embed is not None
          and all(len(b.blocks) == 12 and sum(p.merge for p in b.blocks) == 3
                  for b in (params.sed, params.doa)), "EINV2 block and embed plan")
    g = torch.Generator(device="cuda").manual_seed(47)
    wavs = [torch.randn(B_SERVE, 4, N_SAMPLES, device="cuda", generator=g) * 0.1
            for _ in range(SERVE_BATCHES)]
    serve = lambda w: einv2_htsat_fused_forward_from_wav(model, w, params=params)  # noqa: E731
    serve(wavs[0])  # warm-up
    torch.cuda.synchronize()

    # the main path: counts from 0, SERVE_BATCHES batches
    zero_counts()
    t0 = time.perf_counter()
    outs = [serve(w) for w in wavs]
    torch.cuda.synchronize()
    dt = (time.perf_counter() - t0) / SERVE_BATCHES
    launches = read_counts()
    want = expected(K1=SERVE_BATCHES, K8=SERVE_BATCHES, K2=24 * SERVE_BATCHES)
    log(f"EINV2: served {SERVE_BATCHES} batches of {B_SERVE} x 10 s clips: launches "
        f"{launches} (expect {want})")
    check(launches == want, "EINV2 serving launch counts")
    for o in outs:
        for key, shape in EINV2_SHAPES.items():
            check(o[key].shape == (B_SERVE, 100) + shape and o[key].dtype == torch.float32
                  and torch.isfinite(o[key]).all().item(), f"EINV2 {key} {tuple(o[key].shape)}")
    log(f"EINV2 served: {dt * 1e3:.2f} ms/batch, {B_SERVE / dt:.1f} clips/s "
        f"(host clock, synchronized; {smi})")

    # the same path on the plain versions, bf16 and float32
    plain = einv2_htsat_fused_forward_from_wav(model, wavs[0], params=params,
                                               use_kernels=False)
    f32 = einv2_htsat_fused_forward_from_wav(model, wavs[0], compute_dtype=torch.float32,
                                             use_kernels=False)
    e_plain, e_f32, p_f32 = max_diff(outs[0], plain), max_diff(outs[0], f32), max_diff(plain, f32)
    log(f"EINV2 served vs plain bf16 path: max |d| {e_plain:.3g} (<= 5e-2); vs float32 plain "
        f"path {e_f32:.3g} (plain bf16 {p_f32:.3g}); sed std {f32['sed'].std().item():.3g}, "
        f"doa std {f32['doa'].std().item():.3g}")
    check(e_plain <= 5e-2, "EINV2 served output disagrees with the plain path")
    check(e_f32 <= 1.25 * p_f32 + 1e-2, "EINV2 served output further from float32 than plain")

    # K1 and K8 (the DOA branch) on the batch's own inputs; K8 refuses the
    # SED branch's four channels before any launch
    wav = wavs[0]
    feats = folded_wav_features(model, wav, t_out=1024)
    ref1 = folded_wav_features(model, wav, t_out=1024, use_kernels=False).float()
    k1_err = (feats.float() - ref1).abs().max().item()
    rel = ((feats.float() - ref1).abs() / ref1.abs().clamp(min=1.0)).max().item()
    check(rel <= 2.0 ** -7, f"K1 disagrees with its plain version at B={B_SERVE} (EINV2)")
    got = patch_embed_tokens(feats, params.doa.embed).float()
    ref8 = patch_embed_tokens_plain(feats, params.doa.embed).float()
    k8_err = (got - ref8).abs().max().item()
    rel8 = ((got - ref8).abs() / ref8.abs().clamp(min=1.0)).max().item()
    check(rel8 <= 2.0 ** -7, f"K8 disagrees with its plain version at B={B_SERVE} (EINV2)")
    sed_feats = feats[:, :4].contiguous()
    before = read_counts()["K8"]
    check(raises(lambda: patch_embed_tokens(
        sed_feats, prepare_patch_embed(model.sed_encoder, torch.bfloat16)), NotImplementedError)
        and read_counts()["K8"] == before, "K8 must refuse the SED branch's 4 channels")
    with torch.no_grad():
        k1 = cuda_ms(lambda: folded_wav_features(model, wav, t_out=1024), reps=10)
        k8 = cuda_ms(lambda: patch_embed_tokens(feats, params.doa.embed), reps=20)
        sed_emb = cuda_ms(lambda: embed_tokens(model.sed_encoder, feats[:, :4],
                                               torch.bfloat16), reps=20)

    # K2 on both branches' own block inputs, recorded from one served batch
    recorded = []

    def record(x, p):
        recorded.append((x, p))
        return orig(x, p)

    orig = serving_einv2.swin_block_fused
    serving_einv2.swin_block_fused = record
    try:
        serve(wav)
    finally:
        serving_einv2.swin_block_fused = orig
    check(len(recorded) == 24, f"recorded {len(recorded)} EINV2 block calls")
    k2_err = k2_rel = k2_ms = k2_plain = k2_bound = 0.0
    for j, (x, p) in enumerate(recorded):
        y = swin_block.swin_block_fused(x, p).float()
        y0 = swin_block.swin_block_plain(x, p).float()
        e, sc = (y - y0).abs().max().item(), y0.abs().max().item()
        check(torch.isfinite(y).all().item() and e <= 2.0 ** -6 * sc,
              f"K2 EINV2 call {j} disagrees with its plain version at B={B_SERVE}")
        k2_err, k2_rel = max(k2_err, e), max(k2_rel, e / sc)
        k2_ms += cuda_ms(lambda: swin_block.swin_block_fused(x, p), reps=5)
        k2_plain += cuda_ms(lambda: swin_block.swin_block_plain(x, p), reps=2)
        nb, fl = k2_work(B_SERVE, p)
        k2_bound += bound_ms(nb, bf16_flops=fl)[0]
    log(f"K2 on the EINV2 batch's 24 block inputs (both branches): worst {k2_rel:.3g} of "
        f"scale (<= 2^-6)")
    log(f"EINV2 per batch of {B_SERVE} ({smi}): K1 {k1:.3f} ms, K8 (DOA) {k8:.3f} ms, "
        f"einsum embed (SED) {sed_emb:.3f} ms, K2 x24 {k2_ms:.3f} ms (plain {k2_plain:.3f}, "
        f"bound {k2_bound:.3f}), rest {dt * 1e3 - k1 - k8 - sed_emb - k2_ms:.3f} ms")
    serve_b128("EINV2 served", serve, model, smi, shapes=EINV2_SHAPES)
    phase_profile("one EINV2 served batch", lambda: serve(wav))
    return launches, {"K1": (k1_err, k1_err / ref1.abs().max().item()),
                      "K2": (k2_err, k2_rel),
                      "K8": (k8_err, k8_err / ref8.abs().max().item())}


def einv2_labels(rng, B, T_label, K_cls=13):
    """EINV2 targets: up to three active tracks a frame, a random class
    each, unit DOA vectors where active."""
    import numpy as np

    act = (rng.random((B, T_label, 3, 1)) < 0.5).astype(np.float32)
    sed = np.zeros((B, T_label, 3, K_cls), np.float32)
    np.put_along_axis(sed, rng.integers(0, K_cls, (B, T_label, 3, 1)), act, axis=3)
    doa = rng.standard_normal((B, T_label, 3, 3)).astype(np.float32)
    doa /= np.linalg.norm(doa, axis=-1, keepdims=True)
    return {"sed_label": sed, "doa_label": doa * act}


def phase_train_einv2(smi):
    """Eager EINV2 training through SELDTask (the JAX package trains EINV2
    eagerly only): SERVE_BATCHES steps of B_TRAIN clips, bf16-mixed,
    drop-path from a generator (K1 x1 per step, K2/K3 x0), counted from 0;
    the kernel step against the plain step, in float32 and bf16-mixed; K1's
    training form on the step's waveforms; a profile."""
    import numpy as np
    import torch
    from pseldnets_tpu_torch.config import compose
    from pseldnets_tpu_torch.ops.frontend import fused_logmel_iv_plain
    from pseldnets_tpu_torch.train.module import DatasetSpec, SELDTask

    cfg = compose(str(ROOT / "configs"), "train",
                  EINV2_OVERRIDES + ["trainer.precision=bf16-mixed"])
    task = SELDTask(cfg, DatasetSpec(num_classes=13), steps_per_epoch=100, device="cuda")
    check(not task.fused_forward and task.compute_dtype == torch.bfloat16,
          "EINV2 training configuration (eager, bf16-mixed)")
    task.init_state(0)
    g = torch.Generator(device="cuda").manual_seed(48)
    wavs = [torch.randn(B_TRAIN, 4, N_SAMPLES, device="cuda", generator=g) * 0.1
            for _ in range(SERVE_BATCHES)]
    labels = {k: torch.from_numpy(v).cuda()
              for k, v in einv2_labels(np.random.default_rng(1), B_TRAIN, 100).items()}
    gen = torch.Generator(device="cuda").manual_seed(49)
    step = lambda w: task.train_step(w, labels, gen)  # noqa: E731
    step(wavs[0])  # warm-up
    torch.cuda.synchronize()

    # the main path: counts from 0, SERVE_BATCHES steps
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    t0 = time.perf_counter()
    losses = [step(w)["loss_all"] for w in wavs]
    torch.cuda.synchronize()
    dt = (time.perf_counter() - t0) / SERVE_BATCHES
    launches = read_counts()
    want = expected(K1=SERVE_BATCHES)
    log(f"EINV2 trained {SERVE_BATCHES} eager steps of {B_TRAIN} x 10 s clips: launches "
        f"{launches} (expect {want}); losses {[round(float(v), 6) for v in losses]}; peak "
        f"device memory {torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB")
    check(launches == want, "EINV2 training launch counts")
    check(all(np.isfinite(float(v)) for v in losses), "EINV2 training loss not finite")
    log(f"EINV2 training: {dt * 1e3:.2f} ms/step, {B_TRAIN / dt:.1f} clips/s "
        f"(host clock, synchronized; {smi})")

    # one kernel step against one plain step, from the same parameters,
    # batch and drop-path masks. K1 is the step's one kernel, and its
    # training form is float32: in float32 the two steps differ by K1's
    # arithmetic alone, and phase_train's rule holds them (the float32 plain
    # step is both references, so every grad must lie within 2^-7 of its
    # scale). Under bf16-mixed autocast rounds every activation and
    # activation grad, and sums that nearly cancel (stage 3's
    # relative-position-bias grads) move by 3-14% of their scale between
    # any two bf16 runs and float32 (PERF.md §6): there the loss is held to
    # 2^-6 and the grads' worst distance is logged.
    def grads_with(use_kernels, dtype):
        task.set_use_kernels(use_kernels)
        task.compute_dtype = dtype
        losses, grads, _ = task.compute_grads(wavs[0], labels,
                                              torch.Generator(device="cuda").manual_seed(50))
        return losses["loss_all"].float().reshape(1), grads

    lk, gk = grads_with(True, torch.float32)
    lf, gf = grads_with(False, torch.float32)
    lk16, gk16 = grads_with(True, torch.bfloat16)
    lp16, gp16 = grads_with(False, torch.bfloat16)
    task.set_use_kernels(True)
    task.compute_dtype = torch.bfloat16
    log(f"EINV2 kernel step vs plain step: loss {lk.item():.6f} (plain {lf.item():.6f}) in "
        f"float32, {lk16.item():.6f} (plain {lp16.item():.6f}) in bf16-mixed")
    compare("EINV2 loss (float32)", lk, lf, lf, 2.0 ** -6)
    compare("EINV2 loss (bf16)", lk16, lp16, lf, 2.0 ** -6)
    worst = worst16 = noise16 = 0.0
    for name, a, c, a16, b16 in zip(task.trained_names, gk, gf, gk16, gp16):
        scale = max(c.abs().max().item(), 1e-30)
        worst = max(worst, compare(name[-36:], a, c, c, 2.0 ** -4) / scale)
        worst16 = max(worst16, (a16 - b16).abs().max().item() / scale)
        noise16 = max(noise16, (b16 - c).abs().max().item() / scale)
    log(f"EINV2: every parameter grad within {worst:.3g} of its scale of the plain step's in "
        f"float32; in bf16-mixed within {worst16:.3g}, the plain bf16 step's own distance "
        f"from float32 up to {noise16:.3g}")

    # K1 in its training form (float32, unfolded) on the step's own waveforms
    feats = task.extractor(wavs[0])
    ref = fused_logmel_iv_plain(wavs[0])
    db = (feats[:, :4] - ref[:, :4]).abs().max().item()
    iv = (feats[:, 4:] - ref[:, 4:]).abs().max().item()
    check(torch.isfinite(feats).all().item() and db <= 8e-4 and iv <= 7e-5,
          f"K1 training form disagrees with its plain version at B={B_TRAIN} (EINV2)")
    k1_rel = max(db / ref[:, :4].abs().max().item(), iv / ref[:, 4:].abs().max().item())
    phase_profile("one EINV2 training step", lambda: step(wavs[0]))
    return launches, {"K1": (max(db, iv), k1_rel)}


# PaSST training (BASELINE.json config 4, the ACCDOA head): configs/model/
# passt.yaml at full width (768, depth 7, 602 tokens), bf16-mixed, eager as in
# the JAX package; then the structured frequency patchout (402 tokens) with
# drop-path and position dropout
PASST_TRAIN = ["model=passt", "loss=accdoa", "model.kwargs.pretrained_path=null",
               "model.kwargs.audioset_pretrain=false", "trainer.precision=bf16-mixed"]
PASST_PATCHOUT = ["model.kwargs.s_patchout_f=2", "model.kwargs.drop_path_rate=0.1",
                  "model.kwargs.drop_rate=0.1"]


def accdoa_labels(adpit):
    """ADPIT labels (B, T, 6, 4, K) -> ACCDOA labels (B, T, 3K): track A's
    activity-scaled x, y, z blocks."""
    B, T = adpit.shape[:2]
    return adpit[:, :, 0, 1:].reshape(B, T, -1)


def grads_with(task, wav, targets, seed, use_kernels, dtype):
    """One ``task.compute_grads`` on (wav, targets) with the kernels or
    their plain versions in ``dtype``, the draws from a fresh generator of
    ``seed`` (the same masks each time): (loss (1,), grads)."""
    import torch

    was = (task.use_kernels, task.compute_dtype)
    task.set_use_kernels(use_kernels)
    task.compute_dtype = dtype
    losses, grads, _ = task.compute_grads(wav, targets,
                                          torch.Generator(device="cuda").manual_seed(seed))
    task.set_use_kernels(was[0])
    task.compute_dtype = was[1]
    return losses["loss_all"].float().reshape(1), grads


def phase_train_passt(smi):
    """PaSST ACCDOA training through SELDTask.train_step, eager under
    bf16 autocast (PASST_TRAIN): SERVE_BATCHES steps of B_TRAIN clips with
    the shipped kwargs, then with PASST_PATCHOUT, the draws from a
    generator (K1 x1 a step, no other kernel), counted from 0; for each
    the kernel step against the plain-frontend step on the same draws
    (float32: loss within 2^-6, every grad within 2^-4 of its scale;
    bf16-mixed: the loss within 2^-6 of the plain bf16 step's, the grads'
    distance logged), K1's training form on the step's waveforms,
    peak memory, a profile. Then one run_validation of the patchout task
    through an in-memory datamodule with ACCDOA labels (fit's PaSST
    validation: K1 x1, K6 x7 a batch), and K6 on a validation batch's
    block inputs against its plain version."""
    import numpy as np
    import torch
    from pseldnets_tpu_torch.config import compose
    from pseldnets_tpu_torch.metrics import SELDMetrics
    from pseldnets_tpu_torch.models import heads
    from pseldnets_tpu_torch.ops import vit_block
    from pseldnets_tpu_torch.serving import folded_wav_features, prepare_vit_blocks
    from pseldnets_tpu_torch.serving.passt import passt_tokens
    from pseldnets_tpu_torch.train import loop
    from pseldnets_tpu_torch.train.module import DatasetSpec, SELDTask

    total = expected()
    k1 = (0.0, 0.0)
    labels = torch.from_numpy(accdoa_labels(make_labels(np.random.default_rng(2), B_TRAIN,
                                                        100))).cuda()
    for name, extra, tokens in (("shipped kwargs", [], 602),
                                ("s_patchout_f=2, drop-path 0.1, drop_rate 0.1",
                                 PASST_PATCHOUT, 402)):
        cfg = compose(str(ROOT / "configs"), "train", PASST_TRAIN + extra)
        task = SELDTask(cfg, DatasetSpec(num_classes=13), steps_per_epoch=100, device="cuda")
        enc = task.model.encoder
        check(isinstance(task.model, heads.PASST) and not task.fused_forward
              and task.compute_dtype == torch.bfloat16 and len(enc.blocks) == 7
              and enc.embed_dim == 768, "PaSST training configuration (eager, bf16-mixed)")
        task.init_state(0)
        g = torch.Generator(device="cuda").manual_seed(90)
        wavs = [torch.randn(B_TRAIN, 4, N_SAMPLES, device="cuda", generator=g) * 0.1
                for _ in range(SERVE_BATCHES)]
        gen = torch.Generator(device="cuda").manual_seed(91)
        step = lambda w: task.train_step(w, {"accdoa_label": labels}, gen)  # noqa: E731
        # warm-up, the tokens that reach block 0 read from the step itself
        seen = []
        hook = enc.blocks[0].register_forward_pre_hook(
            lambda _m, args: seen.append(tuple(args[0].shape)))
        step(wavs[0])
        hook.remove()
        torch.cuda.synchronize()
        check(seen == [(B_TRAIN, tokens, 768)],
              f"PaSST train tokens at block 0 {seen} (expect {tokens})")

        # the main path: counts from 0, SERVE_BATCHES steps
        torch.cuda.reset_peak_memory_stats()
        zero_counts()
        t0 = time.perf_counter()
        losses = [step(w)["loss_all"] for w in wavs]
        torch.cuda.synchronize()
        dt = (time.perf_counter() - t0) / SERVE_BATCHES
        launches = read_counts()
        want = expected(K1=SERVE_BATCHES)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        log(f"PaSST ({name}) trained {SERVE_BATCHES} eager steps of {B_TRAIN} x 10 s clips, "
            f"{tokens} tokens: launches {launches} (expect {want}); losses "
            f"{[round(float(v), 6) for v in losses]}; peak device memory {peak:.2f} GiB")
        check(launches == want, "PaSST training launch counts")
        check(all(np.isfinite(float(v)) for v in losses), "PaSST training loss not finite")
        total = {k: total[k] + launches[k] for k in total}
        log(f"PaSST training ({name}): {dt * 1e3:.2f} ms/step, {B_TRAIN / dt:.1f} clips/s "
            f"(host clock, synchronized; {smi})")

        # one kernel step against one plain-frontend step, the same weights,
        # batch and draws (phase_train_einv2's rule: in float32 the steps
        # differ by K1's arithmetic alone; the bf16 step's loss is logged)
        target = {"accdoa_label": labels}
        lk, gk = grads_with(task, wavs[0], target, 92, True, torch.float32)
        lf, gf = grads_with(task, wavs[0], target, 92, False, torch.float32)
        lk16, gk16 = grads_with(task, wavs[0], target, 92, True, torch.bfloat16)
        lp16, gp16 = grads_with(task, wavs[0], target, 92, False, torch.bfloat16)
        log(f"PaSST ({name}) kernel step vs plain step: loss {lk.item():.6f} (plain "
            f"{lf.item():.6f}) in float32, {lk16.item():.6f} (plain {lp16.item():.6f}) in "
            f"bf16-mixed")
        compare("PaSST loss (float32)", lk, lf, lf, 2.0 ** -6)
        compare("PaSST loss (bf16)", lk16, lp16, lf, 2.0 ** -6)
        worst = worst16 = noise16 = 0.0
        for pname, a, c, a16, b16 in zip(task.trained_names, gk, gf, gk16, gp16):
            scale = max(c.abs().max().item(), 1e-30)
            worst = max(worst, compare(pname[-36:], a, c, c, 2.0 ** -4) / scale)
            worst16 = max(worst16, (a16 - b16).abs().max().item() / scale)
            noise16 = max(noise16, (b16 - c).abs().max().item() / scale)
        log(f"PaSST ({name}): every parameter grad within {worst:.3g} of its scale of the "
            f"plain step's in float32; in bf16-mixed within {worst16:.3g}, the plain bf16 "
            f"step's own distance from float32 up to {noise16:.3g}")
        del gk, gf, gk16, gp16
        e = hold_k1_train(task, wavs[0])
        k1 = (max(k1[0], e[0]), max(k1[1], e[1]))
        phase_profile(f"one PaSST training step ({name})", lambda: step(wavs[0]))
        if not extra:
            del task, wavs
            torch.cuda.empty_cache()

    # fit's PaSST validation: run_validation on the patchout task (eval: the
    # whole grid), an in-memory datamodule with ACCDOA labels
    dm = AccdoaMemoryDataModule(93)
    n_b = len(dm.batches)
    torch.cuda.synchronize()
    zero_counts()
    t0 = time.perf_counter()
    macro, micro, vlosses = loop.run_validation(task, dm, SELDMetrics(nb_classes=13,
                                                                      doa_threshold=20))
    val_s = time.perf_counter() - t0
    launches = read_counts()
    want = expected(K1=n_b, K6=7 * n_b)
    log(f"PaSST run_validation ({len(dm.wavs)} chunks, {n_b} batches): launches {launches} "
        f"(expect {want}); {val_s * 1e3:.1f} ms; macro {macro}; losses {vlosses} ({smi})")
    check(launches == want, "PaSST validation launch counts")
    vals = list(macro.values()) + list(micro.values()) + list(vlosses.values())
    check(all(np.isfinite(v) for v in vals), "a PaSST validation metric is not finite")
    total = {k: total[k] + launches[k] for k in total}

    # K6 on the first validation batch's seven block inputs
    model = task.model.eval()
    blocks = prepare_vit_blocks(model, torch.bfloat16)
    wav = dm.wavs[:EVAL_LOADER_B]
    with torch.no_grad():
        xs = [passt_tokens(model, folded_wav_features(model, wav), torch.bfloat16)]
        for p in blocks[:-1]:
            xs.append(vit_block.vit_block_fused(xs[-1], p))
    check(xs[0].shape == (EVAL_LOADER_B, 602, 768), f"validation tokens {tuple(xs[0].shape)}")
    k6 = (0.0, 0.0)
    for i, (x, p) in enumerate(zip(xs, blocks)):
        ref = vit_block.vit_block_plain(x, p).float()
        scale = ref.abs().max().item()
        err = (vit_block.vit_block_fused(x, p).float() - ref).abs().max().item()
        check(err <= 2.0 ** -6 * scale, f"K6 validation block {i} disagrees with its plain "
              "version")
        k6 = (max(k6[0], err), max(k6[1], err / scale))
    log(f"K6 on a validation batch's 7 block inputs (B={EVAL_LOADER_B}): max |d| {k6[0]:.3g}, "
        f"{k6[1]:.3g} of scale (<= 2^-6)")
    del task, dm, xs, wavs
    torch.cuda.empty_cache()
    return total, {"K1": k1, "K6": k6}


# configs/model/crnn.yaml (CNN14-Conformer: CNN12 64..2048, one conformer
# layer, its dropout 0.1) trained as bench_all.py:167-191 composes it, bf16
CRNN_TRAIN = CRNN_OVERRIDES + ["trainer.precision=bf16-mixed"]


def feature_sensitivity(task, wav, targets, seed, gf, scales):
    """How far the float32 plain step's grads move with its features alone:
    the plain step again on the plain features (its run-to-run spread) and
    on the plain features moved by K1's measured error, each element's sign
    drawn at random (K1's error without its structure), the dropout masks
    from a fresh generator of ``seed`` each time. -> per parameter (spread,
    moved) as shares of ``scales``, from the grads ``gf``."""
    import torch

    was = (task.use_kernels, task.compute_dtype)
    task.compute_dtype = torch.float32
    prepared = task._on_step_stream(task.prepare_batch({"data": wav, **targets}))
    feats = {}
    for use in (False, True):
        task.set_use_kernels(use)
        feats[use], tgt = task.step_inputs(prepared)
    task.set_use_kernels(was[0])
    err = (feats[True] - feats[False]).abs()
    g = torch.Generator(device="cuda").manual_seed(seed + 1)
    signs = torch.randint(0, 2, err.shape, generator=g, device="cuda").float() * 2 - 1
    out = []
    for f in (feats[False], feats[False] + err * signs):
        _, grads, _ = task.grads_on(f, tgt, torch.Generator(device="cuda").manual_seed(seed))
        out.append([(a - c).abs().max().item() / sc for a, c, sc in zip(grads, gf, scales)])
    task.compute_dtype = was[1]
    return list(zip(*out))


def hold_step_against_plain(task, what, wav, targets, seed):
    """The rule phase_train_passt states for a step whose only kernel is
    K1: the kernel step against the plain-frontend step on the same
    weights, batch and draws, in float32 (the loss within 2^-6 of its
    scale, every parameter grad within 2^-4 of its own scale, or of 2^-14
    of the largest grad where its own is below that) and in bf16-mixed
    (the loss within 2^-6 of the plain bf16 step's; the grads' distance
    logged beside the plain bf16 step's own distance from float32), the
    worst grad named. Each float32 grad is also held within 4x (plus 2^-12
    of its scale) of how far the plain step's grad moves when its features
    move by K1's error with random signs (``feature_sensitivity``): a step
    this sensitive to its features (the CNN14-Conformer's deep convs move
    by up to 2^-5 of scale) needs 2^-4, and a fault on the K1 path would
    stand out above its features' own sensitivity. -> the worst float32
    grad distance as a share of its scale."""
    import torch

    lk, gk = grads_with(task, wav, targets, seed, True, torch.float32)
    lf, gf = grads_with(task, wav, targets, seed, False, torch.float32)
    lk16, gk16 = grads_with(task, wav, targets, seed, True, torch.bfloat16)
    lp16, gp16 = grads_with(task, wav, targets, seed, False, torch.bfloat16)
    log(f"{what} kernel step vs plain step: loss {lk.item():.6f} (plain {lf.item():.6f}) in "
        f"float32, {lk16.item():.6f} (plain {lp16.item():.6f}) in bf16-mixed")
    compare(f"{what} loss (float32)", lk, lf, lf, 2.0 ** -6)
    compare(f"{what} loss (bf16)", lk16, lp16, lf, 2.0 ** -6)
    # a grad at float32 noise (the key projections' biases: softmax ignores
    # a constant added to every key, so their true grad is 0) is held
    # against 2^-14 of the largest grad instead of its own scale
    floor = 2.0 ** -14 * max(c.abs().max().item() for c in gf)
    scales = [max(c.abs().max().item(), floor) for c in gf]
    sens = feature_sensitivity(task, wav, targets, seed, gf, scales)
    worst, worst16, noise16, rels = (0.0, ""), 0.0, 0.0, []
    for pname, a, c, a16, b16, scale, (_, moved) in zip(task.trained_names, gk, gf, gk16,
                                                         gp16, scales, sens):
        rel = (a - c).abs().max().item() / scale
        check(torch.isfinite(a).all().item() and rel <= min(2.0 ** -4, 4 * moved + 2.0 ** -12),
              f"{what}: the {pname} grad {rel:.3g} of its scale from the plain step's (its "
              f"features' sensitivity {moved:.3g})")
        worst = max(worst, (rel, pname))
        rels.append(rel)
        worst16 = max(worst16, (a16 - b16).abs().max().item() / scale)
        noise16 = max(noise16, (b16 - c).abs().max().item() / scale)
    log(f"{what}: every parameter grad within {worst[0]:.3g} of its scale of the plain "
        f"step's in float32 (<= 2^-4 and <= 4x its sensitivity + 2^-12, scales floored at "
        f"{floor:.3g}; the worst {worst[1]}); in bf16-mixed within "
        f"{worst16:.3g}, the plain bf16 step's own distance from float32 up to {noise16:.3g}")
    spread = max(sp for sp, _ in sens)
    ratios = sorted(r / max(mv, 1e-12) for r, (_, mv) in zip(rels, sens))
    log(f"{what}: float32 grads' sensitivity to the features: the plain step again on the "
        f"same features within {spread:.3g} of scale; on features moved by K1's error with "
        f"random signs within {max(mv for _, mv in sens):.3g}; K1's gap over that moved gap, "
        f"per parameter: median {ratios[len(ratios) // 2]:.3g}, largest {ratios[-1]:.3g}")
    order = sorted(range(len(rels)), key=lambda i: -rels[i])[:6]
    for i in order:
        log(f"  {task.trained_names[i]}: K1 gap {rels[i]:.3g}, moved {sens[i][1]:.3g}, "
            f"spread {sens[i][0]:.3g}")
    return worst[0]


def timed_steps(task, what, step, wavs, smi):
    """``step`` on each of ``wavs`` after a warm-up on the first, counted
    from 0 (K1 one launch a step, no other kernel): -> (launches, ms a
    step); logs the losses, peak memory and clips/s."""
    import numpy as np
    import torch

    step(wavs[0])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    t0 = time.perf_counter()
    losses = [step(w)["loss_all"] for w in wavs]
    torch.cuda.synchronize()
    dt = (time.perf_counter() - t0) / len(wavs)
    launches = read_counts()
    want = expected(K1=len(wavs))
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    log(f"{what}: {len(wavs)} eager steps of {B_TRAIN} x 10 s clips: launches {launches} "
        f"(expect {want}); losses {[round(float(v), 6) for v in losses]}; {dt * 1e3:.2f} "
        f"ms/step, {B_TRAIN / dt:.1f} clips/s (host clock, synchronized); peak device memory "
        f"{peak:.2f} GiB ({smi})")
    check(launches == want, f"{what} launch counts")
    check(all(np.isfinite(float(v)) for v in losses), f"{what}: a loss is not finite")
    return launches, dt * 1e3


def phase_train_crnn(smi):
    """CNN14-Conformer training (CRNN_TRAIN: model=crnn ACCDOA, CNN12 at
    2048, one conformer layer with its dropout 0.1, eager under bf16
    autocast, the masks from the step's generator): SERVE_BATCHES steps of
    B_TRAIN clips, then one with ``model.decoder=transformer`` (its dropout
    0.1 too), each counted from 0 (K1 x1 a step, no other kernel); the
    conformer step against the plain-frontend step on the same generator
    state (``hold_step_against_plain``), K1's training form, a profile; then
    one run_validation of the conformer task on an in-memory datamodule
    with ACCDOA labels (the CRNN eval route, serving/crnn.py: K1 x1, K7 x6 a
    batch) and K7 on a validation batch's six ConvBlock inputs against its
    plain version."""
    import numpy as np
    import torch
    from pseldnets_tpu_torch.config import compose
    from pseldnets_tpu_torch.metrics import SELDMetrics
    from pseldnets_tpu_torch.models import heads
    from pseldnets_tpu_torch.ops.conv_block import conv3x3_bias_relu, conv3x3_bias_relu_plain
    from pseldnets_tpu_torch.serving import folded_wav_features, prepare_crnn
    from pseldnets_tpu_torch.serving.crnn import avg_pool, trunk_input
    from pseldnets_tpu_torch.train import loop
    from pseldnets_tpu_torch.train.module import DatasetSpec, SELDTask

    total = expected()
    targets = {"accdoa_label": torch.from_numpy(
        accdoa_labels(make_labels(np.random.default_rng(4), B_TRAIN, 100))).cuda()}
    g = torch.Generator(device="cuda").manual_seed(94)
    wavs = [torch.randn(B_TRAIN, 4, N_SAMPLES, device="cuda", generator=g) * 0.1
            for _ in range(SERVE_BATCHES)]
    k1 = k7 = (0.0, 0.0)
    for decoder, extra, n_steps in (("conformer", [], SERVE_BATCHES),
                                    ("transformer", ["model.decoder=transformer"], 1)):
        what = f"CRNN training ({decoder} decoder)"
        task = SELDTask(compose(str(ROOT / "configs"), "train", CRNN_TRAIN + extra),
                        DatasetSpec(num_classes=13), steps_per_epoch=100, device="cuda")
        m = task.model
        dec = m.decoder if decoder == "conformer" else m.decoder.decoder
        rate = (dec.layers[0].sequential[0].module.dropout if decoder == "conformer"
                else dec.layers[0].dropout)
        check(isinstance(m, heads.CRNN) and m.num_features[-1] == 2048
              and m.decoder_kind == decoder and rate == 0.1 and not task.fused_forward
              and task.compute_dtype == torch.bfloat16,
              f"{what} configuration (CNN12 at 2048, dropout 0.1, eager, bf16-mixed)")
        task.init_state(0)
        gen = torch.Generator(device="cuda").manual_seed(95)
        step = lambda w: task.train_step(w, targets, gen)  # noqa: E731
        launches, _ = timed_steps(task, what, step, wavs[:n_steps], smi)
        total = {k: total[k] + launches[k] for k in total}
        phase_profile(f"one {what} step ({smi})", lambda: step(wavs[0]))
        if decoder != "conformer":
            break
        hold_step_against_plain(task, what, wavs[0], targets, 96)
        e = hold_k1_train(task, wavs[0])
        k1 = (max(k1[0], e[0]), max(k1[1], e[1]))

        # fit's CRNN validation: run_validation on the trained conformer task
        dm = AccdoaMemoryDataModule(97)
        n_b = len(dm.batches)
        check(task.eval_route() == "crnn", f"CRNN eval route {task.eval_route()}")
        torch.cuda.synchronize()
        zero_counts()
        t0 = time.perf_counter()
        macro, micro, vlosses = loop.run_validation(task, dm, SELDMetrics(nb_classes=13,
                                                                          doa_threshold=20))
        val_s = time.perf_counter() - t0
        launches = read_counts()
        want = expected(K1=n_b, K7=6 * n_b)
        log(f"CRNN run_validation ({len(dm.wavs)} chunks, {n_b} batches): launches {launches} "
            f"(expect {want}); {val_s * 1e3:.1f} ms; macro {macro}; losses {vlosses} ({smi})")
        check(launches == want, "CRNN validation launch counts")
        vals = list(macro.values()) + list(micro.values()) + list(vlosses.values())
        check(all(np.isfinite(v) for v in vals), "a CRNN validation metric is not finite")
        total = {k: total[k] + launches[k] for k in total}

        # K7 on the first validation batch's six ConvBlock inputs
        model = task.model.eval()
        params = prepare_crnn(model, torch.bfloat16)
        with torch.no_grad():
            feats = folded_wav_features(model, dm.wavs[:EVAL_LOADER_B])
            xs = [trunk_input(feats, torch.bfloat16, params.blocks[0].w1.shape[2])]
            for p in params.blocks[:-1]:
                xs.append(avg_pool(conv3x3_bias_relu(xs[-1], p.w1, p.b1, p.w2, p.b2), p.pool))
            for i, (x, p) in enumerate(zip(xs, params.blocks)):
                args = (x, p.w1, p.b1, p.w2, p.b2)
                ref = conv3x3_bias_relu_plain(*args).float()
                scale = ref.abs().max().item()
                err = (conv3x3_bias_relu(*args).float() - ref).abs().max().item()
                check(err <= 2.0 ** -6 * scale, f"K7 validation block {i} disagrees with its "
                      "plain version")
                k7 = (max(k7[0], err), max(k7[1], err / scale))
        log(f"K7 on a validation batch's 6 ConvBlock inputs (B={EVAL_LOADER_B}): max |d| "
            f"{k7[0]:.3g}, {k7[1]:.3g} of scale (<= 2^-6)")
        del task, dm, xs, feats, model, params
        torch.cuda.empty_cache()
    del task, wavs
    torch.cuda.empty_cache()
    return total, {"K1": k1, "K7": k7}


# the full-width HTSAT (configs/model/htsat.yaml) trained eagerly: LoRA
# (configs/adapt/lora.yaml), the eager-only AdapterBit settings and the drop
# rates, none of which the kernels take
HTSAT_EAGER_TRAIN = ["loss=multi_accdoa", "model.kwargs.pretrained_path=null",
                     "model.kwargs.audioset_pretrain=false", "trainer.precision=bf16-mixed"]
EAGER_SETTINGS = (("LoRA", ["adapt=lora"], SERVE_BATCHES),
                  ("AdapterBit, learnable scalar, relu, new_adapter",
                   ["adapt=adapter", "adapt.adapt_kwargs.adapter_scalar=learnable_scalar",
                    "adapt.adapt_kwargs.act_layer=relu",
                    "+adapt.adapt_kwargs.new_adapter.mlp_ratio=0.25"], 1),
                  ("drop_rate = attn_drop_rate = 0.1",
                   ["model.kwargs.drop_rate=0.1", "model.kwargs.attn_drop_rate=0.1"], 1))


def phase_train_lora(smi):
    """HTSAT mACCDOA training on the eager modules (HTSAT_EAGER_TRAIN,
    bf16-mixed, B_TRAIN clips): SERVE_BATCHES steps with LoRA, one with the
    eager-only AdapterBit settings (its frozen parameters unchanged after
    it), one with the drop rates, each counted from 0 (K1 x1 a step, no
    other kernel: the patch embed and the blocks run eagerly, as the JAX
    package routes them; eval takes the eager route too, but for the drop
    rates); then the LoRA task's eval batch (route "eager": K1 x1), the
    LoRA step against the plain-frontend step on the same generator state,
    K1's training form, a profile of each setting's step."""
    import numpy as np
    import torch
    from pseldnets_tpu_torch.config import compose
    from pseldnets_tpu_torch.models.adapters import has_lora
    from pseldnets_tpu_torch.models.heads import HTSAT
    from pseldnets_tpu_torch.train.module import DatasetSpec, SELDTask

    total = expected()
    targets = {"adpit_label": torch.from_numpy(
        make_labels(np.random.default_rng(5), B_TRAIN, 100)).cuda()}
    g = torch.Generator(device="cuda").manual_seed(98)
    wavs = [torch.randn(B_TRAIN, 4, N_SAMPLES, device="cuda", generator=g) * 0.1
            for _ in range(SERVE_BATCHES)]
    k1 = (0.0, 0.0)
    for name, extra, n_steps in EAGER_SETTINGS:
        what = f"HTSAT training ({name})"
        task = SELDTask(compose(str(ROOT / "configs"), "train", HTSAT_EAGER_TRAIN + extra),
                        DatasetSpec(num_classes=13), steps_per_epoch=100, device="cuda")
        enc = task.model.encoder
        # eval ignores dropout: the drop rates keep the kernels' eval route
        route = "htsat" if name.startswith("drop") else "eager"
        check(isinstance(task.model, HTSAT) and enc.embed_dim == 96 and sum(enc.depths) == 12
              and not task.fused_forward and task.eval_route() == route,
              f"{what}: the full-width HTSAT trained eagerly, eval route {task.eval_route()}")
        check(has_lora(enc) == (name == "LoRA"), f"{what}: LoRA layers")
        task.init_state(0)
        before = {n: p.detach().clone() for n, p in task.model.named_parameters()
                  if not p.requires_grad}
        check(bool(before) == name.startswith("AdapterBit"), f"{what}: the frozen set")
        gen = torch.Generator(device="cuda").manual_seed(99)
        step = lambda w: task.train_step(w, targets, gen)  # noqa: E731
        launches, _ = timed_steps(task, what, step, wavs[:n_steps], smi)
        total = {k: total[k] + launches[k] for k in total}
        params = dict(task.model.named_parameters())
        check(all(torch.equal(params[n], v) for n, v in before.items()),
              f"{what}: a frozen parameter moved")
        if before:
            log(f"{what}: the {len(before)} frozen parameters unchanged after "
                f"{n_steps + 1} steps")
        phase_profile(f"one {what} step ({smi})", lambda: step(wavs[0]))
        if name != "LoRA":
            del task
            continue
        lora_b = [p for n, p in params.items() if n.endswith("lora_B")]
        check(len(lora_b) == 12 * 4 + 3 and all(p.abs().max() > 0 for p in lora_b),
              "LoRA: every qkv/proj/fc1/fc2 and merge lora_B trained away from zero")
        zero_counts()
        out = task.eval_step({"data": wavs[0]})["multi_accdoa"]
        torch.cuda.synchronize()
        launches = read_counts()
        want = expected(K1=1)
        log(f"{what}: an eval batch on route {task.eval_route()!r}: launches {launches} "
            f"(expect {want})")
        check(launches == want and out.shape == (B_TRAIN, 100, 117)
              and torch.isfinite(out).all().item(), "LoRA eval batch")
        total = {k: total[k] + launches[k] for k in total}
        hold_step_against_plain(task, what, wavs[0], targets, 100)
        e = hold_k1_train(task, wavs[0])
        k1 = (max(k1[0], e[0]), max(k1[1], e[1]))
        del task
    del wavs
    torch.cuda.empty_cache()
    return total, {"K1": k1}


# the eval path: SELDTask.eval_step in the served HTSAT cell's configuration
# (bench.py's mACCDOA, bf16), B_EVAL clips a batch (the pad path: 32 after
# the repeat pad)
EVAL_OVERRIDES = ["loss=multi_accdoa", "model.kwargs.pretrained_path=null",
                  "trainer.precision=bf16-mixed"]
B_EVAL = 31
# the in-memory datamodule: files of EVAL_FILE_SEC seconds cut into 10 s
# chunks every 5 s (move_avg stitches them), EVAL_LOADER_B chunks a batch
EVAL_FILES, EVAL_FILE_SEC, EVAL_HOP_SEC, EVAL_LOADER_B = 3, 30, 5, 8
B_ROUTE = 8  # clips of the one eval_step of each other route
EVAL_ROUNDS, EVAL_REPS = 7, 10  # eval_step and the served forward timed in turns


def eval_task(overrides, seed):
    """A SELDTask on the card from compose(configs, train, overrides):
    seeded weights, non-trivial eval ScalarBN statistics; and the seeded
    generator, for more."""
    import torch
    from pseldnets_tpu_torch.config import compose
    from pseldnets_tpu_torch.train.module import DatasetSpec, SELDTask

    task = SELDTask(compose(str(ROOT / "configs"), "train", overrides),
                    DatasetSpec(num_classes=13), device="cuda")
    task.init_state(seed)
    gen = torch.Generator().manual_seed(seed)
    n_mels = task.model.scalar.running_mean.shape[1]
    with torch.no_grad():
        task.model.scalar.running_mean.copy_(torch.randn(7, n_mels, generator=gen) * 5.0 - 20.0)
        task.model.scalar.running_var.copy_(torch.rand(7, n_mels, generator=gen) * 50.0 + 10.0)
    return task, gen


class MemoryDataModule:
    """What run_validation and run_test read of a datamodule
    (``val_dataloader``, ``test_dataloader``, ``paths_dict``,
    ``valid_gt_dcaseformat``), from seeded arrays: EVAL_FILES files of
    EVAL_FILE_SEC s, each cut into 10 s chunks every EVAL_HOP_SEC s (the
    dataset's test segmentation), waveforms and ADPIT labels on the card,
    DCASE ground truth of up to three events a frame. The CLI's readers
    (data/dataset.py) read HDF5 labels through h5py, which the card's
    machine lacks."""

    def __init__(self, seed):
        import numpy as np
        import torch
        from collections import OrderedDict

        rng = np.random.default_rng(seed)
        frames = EVAL_FILE_SEC * 10
        per_file = int(np.ceil((frames - 100) / (EVAL_HOP_SEC * 10))) + 1
        self.paths_dict = OrderedDict((f"fold1_room1_mix{i:03d}.wav", frames)
                                      for i in range(EVAL_FILES))
        self.valid_gt_dcaseformat = OrderedDict(
            (path, {fr: [[int(rng.integers(0, 13)), int(rng.integers(-180, 180)),
                          int(rng.integers(-60, 60))] for _ in range(int(rng.integers(1, 4)))]
                    for fr in range(0, frames, 2)}) for path in self.paths_dict)
        n = per_file * EVAL_FILES
        g = torch.Generator(device="cuda").manual_seed(seed)
        self.wavs = torch.randn(n, 4, N_SAMPLES, device="cuda", generator=g) * 0.1
        self.labels = torch.from_numpy(make_labels(rng, n, 100)).cuda()
        self.batches = [(i, min(i + EVAL_LOADER_B, n)) for i in range(0, n, EVAL_LOADER_B)]

    def val_dataloader(self):
        return ({"data": self.wavs[a:b], "adpit_label": self.labels[a:b]}
                for a, b in self.batches)

    def test_dataloader(self):
        return ({"data": self.wavs[a:b]} for a, b in self.batches)


class AccdoaMemoryDataModule(MemoryDataModule):
    """MemoryDataModule with ACCDOA labels (track A's) in place of ADPIT."""

    def __init__(self, seed):
        import torch

        super().__init__(seed)
        self.labels = torch.from_numpy(accdoa_labels(self.labels.cpu().numpy())).cuda()

    def val_dataloader(self):
        return ({"data": self.wavs[a:b], "accdoa_label": self.labels[a:b]}
                for a, b in self.batches)


class HostClock:
    """Wall milliseconds spent in methods (``(owner, name)`` pairs) while
    the context is active, and their call counts."""

    def __init__(self, *targets):
        self.targets, self.ms, self.calls = targets, {}, {}

    def __enter__(self):
        self.saved = [(owner, name, getattr(owner, name)) for owner, name in self.targets]
        for owner, name, fn in self.saved:
            def timed(*a, _fn=fn, _name=name, **k):
                t0 = time.perf_counter()
                try:
                    return _fn(*a, **k)
                finally:
                    self.ms[_name] = self.ms.get(_name, 0.0) + (time.perf_counter() - t0) * 1e3
                    self.calls[_name] = self.calls.get(_name, 0) + 1
            setattr(owner, name, timed)
        return self

    def __exit__(self, *exc):
        for owner, name, fn in self.saved:
            setattr(owner, name, fn)


def acs_loop(task, x):
    """ACS as 16 single-rotation eval steps: each rotation's outputs
    de-rotated, then the mean (the reference's per-rotation loop)."""
    import torch

    in_perm, in_sign, out_mat = (torch.as_tensor(t, device=x.device) for t in task.acs_tables())
    outs = []
    for v in range(len(in_perm)):
        y = task.eval_step({"data": x[:, in_perm[v]] * in_sign[v][None, :, None]})
        y = y["multi_accdoa"]
        B, T = y.shape[:2]
        y = torch.einsum("ts,bmrsc->bmrtc", out_mat[v], y.reshape(B, T, 3, 3, -1))
        outs.append(y.reshape(B, T, -1))
    return torch.stack(outs).mean(0)


def folded_errs(task, wav, chunk, blocks, embed):
    """K1, K8 and K2 x12 on the first ACS chunk's folded batch (``chunk``
    rotations of ``wav`` in (half, variant, item) order) against their plain
    versions on the same inputs: K1 within 2^-7 of max(|x|, 1), K8 and each
    K2 block within 2^-6 of the plain output's scale. -> {kernel: (max |d|,
    of scale)}."""
    import torch
    from pseldnets_tpu_torch.ops import patch_embed, swin_block
    from pseldnets_tpu_torch.serving import folded_wav_features

    perm, sign, _ = (torch.as_tensor(t, device="cuda") for t in task.acs_tables())
    folded = task.acs_fold(wav, perm[:chunk], sign[:chunk])
    n = folded.shape[0]
    errs = {}
    with torch.no_grad():
        feats = folded_wav_features(task.model, folded, t_out=1024)
        ref = folded_wav_features(task.model, folded, t_out=1024, use_kernels=False).float()
        del folded
        err = (feats.float() - ref).abs().max().item()
        rel = ((feats.float() - ref).abs() / ref.abs().clamp(min=1.0)).max().item()
        check(rel <= 2.0 ** -7, f"K1 disagrees with its plain version at the folded {n} clips")
        errs["K1"] = (err, err / ref.abs().max().item())
        x = patch_embed.patch_embed_tokens(feats, embed)
        ref = patch_embed.patch_embed_tokens_plain(feats, embed).float()
        del feats
        err, scale = (x.float() - ref).abs().max().item(), ref.abs().max().item()
        check(err <= 2.0 ** -6 * scale, f"K8 disagrees with its plain version at the folded {n} "
              "clips")
        errs["K8"] = (err, err / scale)
        k2 = (0.0, 0.0)
        for i, p in enumerate(blocks):
            y = swin_block.swin_block_fused(x, p)
            ref = swin_block.swin_block_plain(x, p).float()
            err, scale = (y.float() - ref).abs().max().item(), ref.abs().max().item()
            check(err <= 2.0 ** -6 * scale,
                  f"K2 block {i} disagrees with its plain version at the folded {n} clips")
            k2 = (max(k2[0], err), max(k2[1], err / scale))
            x = y
        errs["K2"] = k2
    log(f"at the folded batch of {n} clips: K1 max |d| {errs['K1'][0]:.3g}, K8 "
        f"{errs['K8'][0]:.3g} ({errs['K8'][1]:.3g} of scale), K2 x12 {errs['K2'][0]:.3g} "
        f"({errs['K2'][1]:.3g} of scale)")
    del x, y, ref
    torch.cuda.empty_cache()
    return errs


def phase_eval(smi):
    """The eval path (SELDTask.eval_step, train/loop.py) at the served
    HTSAT cell's configuration: SERVE_BATCHES batches of B_EVAL 10 s clips
    (the repeat pad to 32; K1 x1, K8 x1, K2 x12 a batch) against the plain
    step, timed beside htsat_fused_forward_from_wav alone; ACS at B=32 (two
    chunks of 256 folded clips: K1 x2, K8 x2, K2 x24) against its plain
    version and a loop of 16 single-rotation steps; ACS at the infer CLI's
    B=128 (four chunks of 512 folded clips: K1 x4, K8 x4, K2 x48) against
    its plain version; K1, K8 and K2 on both folded batches against their
    plain versions (folded_errs); run_validation with move_avg
    and run_test on an in-memory datamodule, the host's milliseconds of the
    aggregation and the metrics apart from the device's; then one eval_step
    of each other route (AdapterBit K4, PaSST K6, EINV2 K2 x24, CRNN K7)
    against its plain step. Every counted run is counted from 0; the path's
    launches are their sum."""
    import tempfile

    import numpy as np
    import torch
    from pseldnets_tpu_torch.metrics import SELDMetrics
    from pseldnets_tpu_torch.serving import htsat_fused_forward_from_wav
    from pseldnets_tpu_torch.train import loop

    total = expected()

    def counted(fn):
        """fn() with every count from 0; its counts added to the path's."""
        zero_counts()
        out = fn()
        torch.cuda.synchronize()
        got = read_counts()
        for k, n in got.items():
            total[k] += n
        return out, got

    task, _ = eval_task(EVAL_OVERRIDES, 60)
    model = task.model
    check(task.eval_route() == "htsat" and task.compute_dtype == torch.bfloat16,
          f"eval route {task.eval_route()}")
    g = torch.Generator(device="cuda").manual_seed(61)
    wavs = [torch.randn(B_EVAL, 4, N_SAMPLES, device="cuda", generator=g) * 0.1
            for _ in range(SERVE_BATCHES)]
    step = lambda w, post=None: task.eval_step({"data": w}, post)  # noqa: E731
    step(wavs[0])  # warm-up: prepares the route's weights
    torch.cuda.synchronize()

    t0 = time.perf_counter()
    outs, launches = counted(lambda: [step(w)["multi_accdoa"] for w in wavs])
    dt = (time.perf_counter() - t0) / SERVE_BATCHES
    want = expected(K1=SERVE_BATCHES, K8=SERVE_BATCHES, K2=12 * SERVE_BATCHES)
    log(f"eval_step on {SERVE_BATCHES} batches of {B_EVAL} x 10 s clips: launches {launches} "
        f"(expect {want})")
    check(launches == want, "eval_step launch counts")
    for o in outs:
        check(o.shape == (B_EVAL, 100, 117) and bool(torch.isfinite(o).all()), f"eval {o.shape}")
    task.set_use_kernels(False)
    plain = step(wavs[0])["multi_accdoa"]
    task.compute_dtype = torch.float32
    f32 = step(wavs[0])["multi_accdoa"]
    task.compute_dtype = torch.bfloat16
    task.set_use_kernels(True)
    e_plain = (outs[0] - plain).abs().max().item()
    e_f32 = (outs[0] - f32).abs().max().item()
    p_f32 = (plain - f32).abs().max().item()
    log(f"eval_step vs plain bf16 step: max |d| {e_plain:.3g} (<= 5e-2); vs float32 plain "
        f"step {e_f32:.3g} (plain bf16 {p_f32:.3g})")
    check(e_plain <= 5e-2, "eval_step disagrees with the plain step")
    check(e_f32 <= 1.25 * p_f32 + 1e-2, "eval_step further from float32 than the plain step")
    w32 = torch.cat([wavs[0], wavs[0][-1:]])
    blocks, embed = (task._eval_params("htsat")[k] for k in ("blocks", "embed"))
    # in turns, EVAL_ROUNDS rounds of EVAL_REPS calls each: the task's own
    # cost is each round's difference, given as its median and range
    turns = [(cuda_ms(lambda: step(wavs[0]), reps=EVAL_REPS),
              cuda_ms(lambda: htsat_fused_forward_from_wav(model, w32, blocks=blocks,
                                                           embed=embed), reps=EVAL_REPS))
             for _ in range(EVAL_ROUNDS)]
    eval_ms, serve_ms, gap = (sorted(v) for v in zip(*((e, f, e - f) for e, f in turns)))
    mid = EVAL_ROUNDS // 2
    log(f"eval_step: {dt * 1e3:.2f} ms/batch of {B_EVAL} (host clock, synchronized); in turns "
        f"({EVAL_ROUNDS} rounds of {EVAL_REPS} calls, CUDA events) {eval_ms[mid]:.3f} "
        f"({eval_ms[0]:.3f}-{eval_ms[-1]:.3f}) ms beside htsat_fused_forward_from_wav alone on "
        f"the padded 32 {serve_ms[mid]:.3f} ({serve_ms[0]:.3f}-{serve_ms[-1]:.3f}) ms: the "
        f"task's own cost {gap[mid]:.3f} ({gap[0]:.3f}-{gap[-1]:.3f}) ms ({smi})")

    # ACS at B=32: 8 rotations folded a forward, 2 chunks of 256 clips
    wav = torch.randn(32, 4, N_SAMPLES, device="cuda", generator=g) * 0.1
    check(task.acs_chunk(32) == 8, "ACS chunk at B=32")
    step(wav, "ACS")  # warm-up at the folded batch
    t0 = time.perf_counter()
    acs, launches = counted(lambda: step(wav, "ACS")["multi_accdoa"])
    acs_dt = time.perf_counter() - t0
    want = expected(K1=2, K8=2, K2=24)
    log(f"ACS at B=32 (2 chunks of 256 folded clips): launches {launches} (expect {want}); "
        f"{acs_dt * 1e3:.2f} ms/batch, {32 / acs_dt:.1f} clips/s, {16 * 32 / acs_dt:.1f} "
        f"rotated clips/s (host clock, synchronized; {smi})")
    check(launches == want, "ACS launch counts")
    check(acs.shape == (32, 100, 117) and bool(torch.isfinite(acs).all()), "ACS output")
    task.set_use_kernels(False)
    acs_plain = step(wav, "ACS")["multi_accdoa"]
    task.set_use_kernels(True)
    looped = acs_loop(task, wav)
    e_acs = (acs - acs_plain).abs().max().item()
    e_loop = (acs - looped).abs().max().item()
    # the loop runs the same kernels on the same tables: only the fold and
    # de-rotation order differ, so it is held far tighter than the plain path
    log(f"ACS vs its plain version: max |d| {e_acs:.3g} (<= 5e-2); vs 16 single-rotation "
        f"eval steps on the kernels {e_loop:.3g} (<= 1e-4)")
    check(e_acs <= 5e-2, "ACS disagrees with its plain version")
    check(e_loop <= 1e-4, "ACS disagrees with the loop of single-rotation steps")

    errs = {256: folded_errs(task, wav, 8, blocks, embed)}
    del wav

    # ACS at the infer CLI's B=128 (configs/model/htsat.yaml): 4 rotations
    # folded a forward, 4 chunks of 512 clips, K1's input 1.97e9 bytes
    wav = torch.randn(128, 4, N_SAMPLES, device="cuda", generator=g) * 0.1
    check(task.acs_chunk(128) == 4, "ACS chunk at B=128")
    step(wav, "ACS")  # warm-up at the folded batch
    t0 = time.perf_counter()
    acs, launches = counted(lambda: step(wav, "ACS")["multi_accdoa"])
    acs_dt = time.perf_counter() - t0
    want = expected(K1=4, K8=4, K2=48)
    log(f"ACS at B=128 (4 chunks of 512 folded clips): launches {launches} (expect {want}); "
        f"{acs_dt * 1e3:.2f} ms/batch, {128 / acs_dt:.1f} clips/s, {16 * 128 / acs_dt:.1f} "
        f"rotated clips/s (host clock, synchronized; {smi})")
    check(launches == want, "ACS launch counts at B=128")
    check(acs.shape == (128, 100, 117) and bool(torch.isfinite(acs).all()), "ACS output")
    task.set_use_kernels(False)
    acs_plain = step(wav, "ACS")["multi_accdoa"]
    task.set_use_kernels(True)
    e_acs = (acs - acs_plain).abs().max().item()
    log(f"ACS at B=128 vs its plain version: max |d| {e_acs:.3g} (<= 5e-2)")
    check(e_acs <= 5e-2, "ACS at B=128 disagrees with its plain version")
    del acs, acs_plain
    errs[512] = folded_errs(task, wav, 4, blocks, embed)
    torch.cuda.empty_cache()

    # run_validation (move_avg) and run_test on the in-memory datamodule
    dm = MemoryDataModule(62)
    task.cfg["post_processing"] = "move_avg"
    task.cfg["data"]["test_hoplen_sec"] = EVAL_HOP_SEC
    metrics = SELDMetrics(nb_classes=13, doa_threshold=20)
    host = ((loop.Aggregator, "aggregate"), (loop.Aggregator, "to_dcase_polar"),
            (SELDMetrics, "update_seld_scores"), (SELDMetrics, "compute_seld_scores"))
    n_b = len(dm.batches)
    with HostClock(*host, (loop.Aggregator, "append"), (type(task), "eval_step")) as clock:
        t0 = time.perf_counter()
        (macro, micro, losses), launches = counted(
            lambda: loop.run_validation(task, dm, metrics))
        val_s = time.perf_counter() - t0
    want = expected(K1=n_b, K8=n_b, K2=12 * n_b)
    check(launches == want, f"run_validation launch counts {launches}")
    host_ms = sum(clock.ms[n] for _, n in host)
    log(f"run_validation (move_avg, {EVAL_FILES} files of {EVAL_FILE_SEC} s, "
        f"{len(dm.wavs)} chunks of 10 s every {EVAL_HOP_SEC} s, {n_b} batches): launches "
        f"{launches}; {val_s * 1e3:.1f} ms in all, eval_step {clock.ms['eval_step']:.1f} ms "
        f"(queued), the fetch in Aggregator.append {clock.ms['append']:.1f} ms, the host's "
        f"aggregation and metrics {host_ms:.1f} ms ({host_ms / n_b:.2f} ms a batch: "
        + ", ".join(f"{n} {clock.ms[n]:.1f}" for _, n in host) + f") ({smi})")
    log(f"  macro {macro}; micro {micro}; losses {losses}")
    vals = list(macro.values()) + list(micro.values()) + list(losses.values())
    check(all(np.isfinite(v) for v in vals) and len(vals) == 13, "a metric is not finite")
    with tempfile.TemporaryDirectory() as out:
        _, launches = counted(lambda: loop.run_test(task, dm, Path(out) / "submissions"))
        csvs = sorted((Path(out) / "submissions").glob("*.csv"))
        check(len(csvs) == EVAL_FILES and all(c.stat().st_size for c in csvs),
              "run_test submissions")
    check(launches == want, f"run_test launch counts {launches}")
    log(f"run_test: launches {launches}, {len(csvs)} submission CSVs")
    task.cfg["post_processing"] = None
    del task, model, dm, wavs, outs, wav
    torch.cuda.empty_cache()

    # one eval_step of each other route, against its plain step
    for name, over, prep, want in (
            ("AdapterBit", EVAL_OVERRIDES + ADAPT, randomize_adapters,
             expected(K1=1, K8=1, K4=12)),
            ("PaSST", PASST_OVERRIDES + EVAL_OVERRIDES[2:], None, expected(K1=1, K6=7)),
            ("EINV2", EINV2_OVERRIDES + EVAL_OVERRIDES[2:], None, expected(K1=1, K8=1, K2=24)),
            ("CRNN", CRNN_OVERRIDES + EVAL_OVERRIDES[2:], randomize_bn_stats,
             expected(K1=1, K7=6))):
        task, gen = eval_task(over, 63)
        if prep is not None:
            prep(task.model, gen)
        w = torch.randn(B_ROUTE, 4, N_SAMPLES, device="cuda", generator=g) * 0.1
        step(w)  # warm-up
        out, launches = counted(lambda: step(w))
        check(launches == want, f"{name} eval_step launch counts {launches}")
        task.set_use_kernels(False)
        ref = step(w)
        diff = max((out[k] - ref[k]).abs().max().item() for k in ref)
        log(f"{name} eval_step (route {task.eval_route()}, {B_ROUTE} clips): launches "
            f"{ {k: v for k, v in launches.items() if v} }, vs plain step max |d| {diff:.3g} "
            f"(<= 5e-2)")
        check(all(bool(torch.isfinite(v).all()) for v in out.values()), f"{name} output")
        check(diff <= 5e-2, f"{name} eval_step disagrees with its plain step")
        del task, out, ref
        torch.cuda.empty_cache()
    log(f"eval path launches: {total}")
    # the kernels line takes each kernel's largest error over both folded batches
    return total, {k: tuple(max(e[k][i] for e in errs.values()) for i in range(2))
                   for k in ("K1", "K8", "K2")}


# the fit path: train/loop.py's fit at the training cell's configuration
# (TRAIN_OVERRIDES, B_TRAIN), FIT_EPOCHS epochs of FIT_STEPS steps, a
# validation of the in-memory files after each (move_avg)
FIT_STEPS, FIT_EPOCHS = 4, 2
FIT_TURNS, FIT_TURN_STEPS = 4, 16  # rounds, and steps a side, of fit in turns with bare steps


class FitDataModule(MemoryDataModule):
    """MemoryDataModule's validation files and FIT_STEPS train batches of
    B_TRAIN ten-second clips as host numpy arrays, as data/datamodule.py's
    ``collate`` yields them (waveforms, ADPIT labels, ov), the same batches
    every epoch: the copy to the device is part of what fit runs."""

    def __init__(self, seed):
        import numpy as np
        import torch

        super().__init__(seed)
        rng = np.random.default_rng(seed + 1)
        g = torch.Generator(device="cuda").manual_seed(seed + 1)
        self.train = [{"data": (torch.randn(B_TRAIN, 4, N_SAMPLES, device="cuda", generator=g)
                                * 0.1).cpu().numpy(),
                       "adpit_label": make_labels(rng, B_TRAIN, 100), "ov": ["1"] * B_TRAIN}
                      for _ in range(FIT_STEPS)]

    def steps_per_epoch(self):
        return len(self.train)

    def train_dataloader(self, num_batches=None):
        n = len(self.train) if num_batches is None else num_batches
        return (self.train[i % len(self.train)] for i in range(n))


def task_state(task):
    """What an exact resume restores, cloned on the card: the model's
    tensors, the optimizer's state and groups (without ``lr_fn``), step,
    epoch and best score."""
    import torch

    opt = task.state.optimizer.state_dict()
    return ({k: v.clone() for k, v in task.model.state_dict().items()},
            {i: {k: v.clone() if torch.is_tensor(v) else v for k, v in st.items()}
             for i, st in opt["state"].items()},
            [{k: v for k, v in g.items() if k != "lr_fn"} for g in opt["param_groups"]],
            task.state.step, task.state.epoch, task.state.best_score)


def same_state(a, b):
    """Whether two ``task_state``s are equal bit for bit."""
    import torch

    def eq(x, y):
        return torch.equal(x, y) if torch.is_tensor(x) else x == y

    return (a[0].keys() == b[0].keys() and all(torch.equal(a[0][k], b[0][k]) for k in a[0])
            and a[1].keys() == b[1].keys()
            and all(st.keys() == b[1][i].keys() and all(eq(v, b[1][i][k]) for k, v in st.items())
                    for i, st in a[1].items())
            and a[2:] == b[2:])


def phase_fit(smi):
    """train/loop.py's fit at full width on the card: HTSAT mACCDOA,
    TRAIN_OVERRIDES (bf16-mixed, fused forward, drop-path 0.1), B_TRAIN,
    FIT_EPOCHS epochs of FIT_STEPS steps from host numpy batches (K1 x1, K2
    x12, K3 x12 a step), a validation after each (move_avg, the in-memory
    files: K1 x1, K8 x1, K2 x12 a batch), checkpoints into a temporary
    directory. Checks the metrics.jsonl lines, the best and last files,
    the exact resume from last.ckpt (bit for bit against the state at the
    save), the best file's validation score, K1, K2 with masks and K3 on
    the main run's step inputs against their plain versions, a resumed
    third epoch; times the steps inside fit (from host batches and from
    device-resident ones) in turns with bare train_steps, splits the epoch
    end, and profiles one more epoch (the device's idle share)."""
    import copy
    import json
    import tempfile

    import numpy as np
    import torch
    from pseldnets_tpu_torch.config import compose
    from pseldnets_tpu_torch.metrics import SELDMetrics
    from pseldnets_tpu_torch.train import loop
    from pseldnets_tpu_torch.train.module import DatasetSpec, SELDTask

    tmp = tempfile.TemporaryDirectory()
    out = Path(tmp.name) / "run"
    cfg = compose(str(ROOT / "configs"), "train", TRAIN_OVERRIDES + [
        f"trainer.max_epochs={FIT_EPOCHS}", "logger=csv", f"paths.log_dir={tmp.name}/logs"])
    cfg["post_processing"] = "move_avg"
    cfg["data"]["test_hoplen_sec"] = EVAL_HOP_SEC

    def epochs(n):
        c = copy.deepcopy(cfg)
        c["trainer"]["max_epochs"] = n
        return c

    def new_task():
        return SELDTask(cfg, DatasetSpec(num_classes=13), steps_per_epoch=FIT_STEPS,
                        device="cuda")

    dm = FitDataModule(70)
    task = new_task()
    check(task.fused_forward and task.compute_dtype == torch.bfloat16, "fit configuration")
    task.init_state(0)
    host = ((loop.Aggregator, "aggregate"), (loop.Aggregator, "to_dcase_polar"),
            (SELDMetrics, "update_seld_scores"), (SELDMetrics, "compute_seld_scores"))
    timings = []

    # the main path: counts from 0, one fit of FIT_EPOCHS epochs
    zero_counts()
    with HostClock(*host, (loop.Aggregator, "append"), (SELDTask, "eval_step")) as clock:
        t0 = time.perf_counter()
        loop.fit(task, dm, cfg, out, timings=timings)
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
    launches = read_counts()
    n_val = len(dm.batches)
    n_steps = FIT_EPOCHS * FIT_STEPS
    want = expected(K1=n_steps + FIT_EPOCHS * n_val, K2=12 * (n_steps + FIT_EPOCHS * n_val),
                    K3=12 * n_steps, K8=FIT_EPOCHS * n_val)
    log(f"fit: {FIT_EPOCHS} epochs of {FIT_STEPS} steps of {B_TRAIN} x 10 s clips, a "
        f"validation of {n_val} batches after each, {fit_s:.2f} s: launches {launches} "
        f"(expect {want})")
    check(launches == want, "fit launch counts")
    lines = [json.loads(s) for s in (out / "metrics.jsonl").read_text().splitlines()]
    check([ln["epoch"] for ln in lines] == list(range(1, FIT_EPOCHS + 1)), "fit epoch lines")
    for ln in lines:
        vals = (list(ln["train"].values()) + list(ln["val"]["losses"].values())
                + list(ln["val"]["macro"].values()) + list(ln["val"]["micro"].values()))
        check(all(np.isfinite(v) for v in vals), f"fit epoch {ln['epoch']}: a value not finite")
        log(f"  epoch {ln['epoch']}: lr {ln['lr']}, train {ln['train']}, val macro "
            f"{ln['val']['macro']}, val losses {ln['val']['losses']}")
    best_line = min(lines, key=lambda ln: ln["val"]["macro"]["SELD_scr"])
    ckpts = sorted(p.name for p in (out / "checkpoints").iterdir())
    check(ckpts == [f"epoch_{best_line['epoch']:03d}.ckpt", "last.ckpt"], f"checkpoints {ckpts}")
    host_ms = sum(clock.ms.get(n, 0.0) for _, n in host)
    for t in timings:
        log(f"  epoch {t['epoch']}: steps {t['train_s'] * 1e3 / FIT_STEPS:.2f} ms/step inside fit "
            f"(host clock, until the epoch's losses are fetched), validation "
            f"{t['val_s'] * 1e3:.1f} ms, checkpoints {t['ckpt_bytes']} bytes written in "
            f"{t['ckpt_s'] * 1e3:.1f} ms ({smi})")
    log(f"  validations ({FIT_EPOCHS} x {n_val} batches): eval_step {clock.ms['eval_step']:.1f} "
        f"ms (queued), the fetch in Aggregator.append {clock.ms['append']:.1f} ms, the host's "
        f"decoding and metrics {host_ms:.1f} ms ("
        + ", ".join(f"{n} {clock.ms.get(n, 0.0):.1f}" for _, n in host) + ")")

    # the exact resume: a new task from last.ckpt against the state at the save
    saved = task_state(task)
    task2 = new_task()
    task2.init_state(0, ckpt_path=str(out / "checkpoints" / "last.ckpt"))
    check(same_state(task_state(task2), saved), "last.ckpt does not restore the state bit for bit")
    log(f"last.ckpt restores {len(saved[0])} model tensors, {len(saved[1])} optimizer states, "
        f"step {saved[3]}, epoch {saved[4]}, best {saved[5]} bit for bit")
    del saved
    # the best file, loaded as weights, scores its epoch's validation again
    task2.init_state(0, ckpt_path=str(out / "checkpoints" / ckpts[0]))
    macro, _, _ = loop.run_validation(task2, dm, SELDMetrics(nb_classes=13, doa_threshold=20))
    d_best = abs(macro["SELD_scr"] - best_line["val"]["macro"]["SELD_scr"])
    log(f"{ckpts[0]} + run_validation: SELD_scr {macro['SELD_scr']!r} against the epoch line's "
        f"{best_line['val']['macro']['SELD_scr']!r}, |d| {d_best:.3g} (<= 1e-6)")
    check(d_best <= 1e-6, "the best checkpoint does not reproduce its validation score")

    # K1, K2 with masks and K3 on the main run's step inputs: one step of its
    # end state on fit's second batch (scripts/torch_fit_grad_drift.py
    # follows K3 against its plain versions over more epochs)
    dev = [(torch.from_numpy(b["data"]).cuda(), {"adpit_label": torch.from_numpy(
        b["adpit_label"]).cuda()}) for b in dm.train]
    w1, lab1 = dev[1]
    k1 = hold_k1_train(task, dev[0][0])
    k2 = k3 = (0.0, 0.0)
    for j, (x, p, m, dout, _) in enumerate(reversed(record_block_backwards(task, w1, lab1, 72))):
        e2, r2, e3, r3 = hold_train_block(x, p, m, dout, j)
        k2, k3 = (max(k2[0], e2), max(k2[1], r2)), (max(k3[0], e3), max(k3[1], r3))
    log(f"on fit's step inputs (epoch {FIT_EPOCHS}'s end state): K1 max |d| {k1[0]:.3g}, K2 "
        f"with masks {k2[1]:.3g} and K3 {k3[1]:.3g} of scale (<= 2^-6)")

    # the resumed third epoch (a fresh task from last.ckpt)
    task2.init_state(0, ckpt_path=str(out / "checkpoints" / "last.ckpt"))
    more = []
    loop.fit(task2, dm, epochs(FIT_EPOCHS + 1), out, timings=more)
    lines = [json.loads(s) for s in (out / "metrics.jsonl").read_text().splitlines()]
    check(lines[-1]["epoch"] == FIT_EPOCHS + 1 and task2.state.epoch == FIT_EPOCHS + 1
          and task2.state.step == (FIT_EPOCHS + 1) * FIT_STEPS
          and np.isfinite(lines[-1]["train"]["loss_all"]), "the resumed epoch")
    log(f"resumed epoch {lines[-1]['epoch']}: train {lines[-1]['train']}, val macro "
        f"{lines[-1]['val']['macro']}")

    # steps inside fit in turns with bare train_steps (phase_train's step) on
    # device-resident copies of the same batches, FIT_TURN_STEPS steps a side
    # (the batches repeated): fit from the host batches (pinned and copied by
    # its thread), bare, fit from the device-resident copies (no copy), the
    # order reversed every other round
    reps = FIT_TURN_STEPS // FIT_STEPS
    gen = torch.Generator(device="cuda").manual_seed(71)
    dm_host, dm_dev = copy.copy(dm), copy.copy(dm)
    dm_host.train = dm.train * reps
    dm_dev.train = [{"data": w, "adpit_label": lab["adpit_label"], "ov": b["ov"]}
                    for (w, lab), b in zip(dev, dm.train)] * reps

    def bare():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for w, lab in dev * reps:
            task2.train_step(w, lab, gen)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3 / FIT_TURN_STEPS

    def in_fit(d):
        loop.fit(task2, d, epochs(task2.state.epoch + 1), out, timings=more)
        return more[-1]["train_s"] * 1e3 / FIT_TURN_STEPS

    sides = {"host": lambda: in_fit(dm_host), "bare": bare, "device": lambda: in_fit(dm_dev)}
    turns = {k: [] for k in sides}
    for r in range(FIT_TURNS):
        for k in (list(sides) if r % 2 == 0 else list(sides)[::-1]):
            turns[k].append(sides[k]())
    log(f"steps inside fit against bare train_steps, in turns ({FIT_TURNS} rounds of "
        f"{FIT_TURN_STEPS} steps a side; host clock; median (range) ms a step): "
        + ", ".join(f"{k} {statistics.median(v):.2f} ({min(v):.2f}-{max(v):.2f})"
                    for k, v in turns.items()) + f"; fit from host batches, bare "
        f"train_step, fit from device-resident batches ({smi})")
    for t in more:
        log(f"  epoch {t['epoch']}: validation {t['val_s'] * 1e3:.1f} ms, checkpoints "
            f"{t['ckpt_bytes']} bytes written in {t['ckpt_s'] * 1e3:.1f} ms")

    # one more epoch under torch.profiler: the device's idle share over an epoch
    phase_profile(f"one epoch of fit ({FIT_STEPS} steps, a validation, checkpoints)",
                  lambda: loop.fit(task2, dm, epochs(task2.state.epoch + 1), out), warm=False)

    del task, task2, dev, dm
    torch.cuda.empty_cache()
    tmp.cleanup()
    return launches, {"K1": k1, "K2": k2, "K3": k3}


# the shipped training recipes (phase_finetune): experiment=synth_maccdoa
# (AugMix: the loader's B_TRAIN clips become 3 x B_TRAIN) from a synthetic
# AudioSet HTSAT file, FT_EPOCHS epochs of fit on FitDataModule's FIT_STEPS
# batches, then experiment=starss23/finetune_maccdoa_augmix1 from the best
# file, FT_TUNE_STEPS steps and one validation batch; then the two L3DAS22
# mono recipes from that file, FT_MONO_STEPS steps each on clips the port's
# mono_adapter spatialisation made; bf16-mixed, fused forward
FT_EPOCHS, FT_TUNE_STEPS, FT_MONO_STEPS = 2, 2, 2
MONO_SAMPLES = 320000  # 10 s at L3DAS22's 32 kHz
FT_OVERRIDES = ["trainer.precision=bf16-mixed", "trainer.fused_forward=true"]
BN_LEAVES = ("weight", "bias", "running_mean", "running_var")


def audioset_htsat_file(path, model, gen):
    """A synthetic file shaped as the released AudioSet HTSAT checkpoint
    (HTSAT-fullset-imagenet-768d-32000hz): ``model``'s encoder keys (the
    768-d layout: embed 96, depths 2-2-6-2) under ``sed_model.``, a
    1-channel ``patch_embed.proj.weight``, ``bn0.*`` over the 64 mels, and
    ``head.*`` / ``tscam_conv.*`` keys, which the load skips; seeded values
    (weights N(0, 0.02), LayerNorm scales 1 + N(0, 0.02)) on the CPU. ->
    the state dict without the prefix."""
    import torch

    def randn(*shape, std=0.02):
        return torch.randn(shape, generator=gen) * std

    sd = {}
    for k, v in model.state_dict().items():
        if k.startswith("encoder."):
            name = k[len("encoder."):]
            one_d_scale = v.dim() == 1 and name.endswith("weight")
            sd[name] = 1.0 + randn(*v.shape) if one_d_scale else randn(*v.shape)
    w = sd["patch_embed.proj.weight"]
    sd["patch_embed.proj.weight"] = randn(w.shape[0], 1, *w.shape[2:], std=0.25)
    F, E = model.scalar.weight.shape[1], model.encoder.norm.weight.shape[0]
    sd.update({"bn0.weight": 1.0 + randn(F, std=0.1), "bn0.bias": randn(F, std=0.1),
               "bn0.running_mean": randn(F, std=3.0) - 20.0,
               "bn0.running_var": 20.0 + 40.0 * torch.rand(F, generator=gen),
               "bn0.num_batches_tracked": torch.tensor(100000),
               "head.weight": randn(527, E), "head.bias": randn(527),
               "tscam_conv.weight": randn(527, E, 2, 3), "tscam_conv.bias": randn(527)})
    torch.save({"state_dict": {f"sed_model.{k}": v for k, v in sd.items()}}, str(path))
    return sd


def phase_finetune(smi):
    """The shipped training recipes through SELDTask, train/loop.py's fit
    and load_pretrained at full width (HTSAT mACCDOA, bf16-mixed, fused
    forward). (a) experiment=synth_maccdoa (augment=augmix: specaug, crop,
    freqshift, rotate, trackmix, wavmix, AugMix) with audioset_pretrain and
    a synthetic AudioSet HTSAT file: the surgery checked bit for bit (the
    patch embed repeated over 7 channels and divided by 7, bn0 in every
    ScalarBN row, the skipped head keeping the seed's init, the backbone
    the file's), then FT_EPOCHS epochs of fit of FIT_STEPS steps of B_TRAIN
    loader clips, 3 x B_TRAIN reaching the model (K1 x1, K2 x12, K3 x12 a
    step) with a validation before (the recipe's sanity pass) and after
    each (K1, K8, K2 x12 a batch). Then one
    step's augmentation twice from the same generator and RandomState
    states (bit-identical features), the kernel step against the plain
    step on those features (phase_train's rule), K1, K2 with masks and K3
    at the step's B=96 against their plain versions, the TF chain's own
    time, the host half's time, a profiled step. (b)
    experiment=starss23/finetune_maccdoa_augmix1 from (a)'s best file: the
    backbone (a)'s, the head the seed's init, FT_TUNE_STEPS steps and one
    validation batch (K1, K8, K2)."""
    import json
    import tempfile

    import numpy as np
    import torch
    from pseldnets_tpu_torch.config import compose
    from pseldnets_tpu_torch.train import loop
    from pseldnets_tpu_torch.augment import Rotation, WavMix
    from pseldnets_tpu_torch.train.checkpoint import load_torch_state_dict, stack_scalar_rows
    from pseldnets_tpu_torch.train.module import DatasetSpec, SELDTask

    tmp = tempfile.TemporaryDirectory()
    root = Path(tmp.name)
    n_model = 3 * B_TRAIN

    def task_of(over, steps):
        cfg = compose(str(ROOT / "configs"), "train", over + FT_OVERRIDES + [
            "logger=csv", f"paths.log_dir={tmp.name}/logs"])
        cfg["post_processing"] = "move_avg"
        cfg["data"]["test_hoplen_sec"] = EVAL_HOP_SEC
        return cfg, SELDTask(cfg, DatasetSpec(num_classes=13), steps_per_epoch=steps,
                             device="cuda")

    def timed_init(task, seed):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        task.init_state(seed)
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    # (a) the AudioSet file and the pre-training recipe
    path = root / "HTSAT-fullset-imagenet-768d-32000hz.ckpt"
    _, fresh = task_of(["experiment=synth_maccdoa", "model.kwargs.pretrained_path=null"],
                       FIT_STEPS)
    fresh.init_state(0)
    sd = audioset_htsat_file(path, fresh.model, torch.Generator().manual_seed(80))
    cfg, task = task_of(["experiment=synth_maccdoa", "model.kwargs.audioset_pretrain=true",
                         f"model.kwargs.pretrained_path={path}",
                         f"trainer.max_epochs={FT_EPOCHS}"], FIT_STEPS)
    check(task.augmix and task.fused_forward and task.compute_dtype == torch.bfloat16
          and task.aug_type == ["specaug", "crop", "freqshift", "rotate", "trackmix", "wavmix"]
          and not task.rotate_on_device, "synth_maccdoa configuration")
    load_a = timed_init(task, 0)
    rep = task.pretrained_report
    got, init = task.model.state_dict(), fresh.model.state_dict()
    check(rep["missing"] == [] and sorted(rep["skipped"]) == ["tscam_conv.bias",
                                                              "tscam_conv.weight"],
          f"AudioSet load report {rep}")
    w = sd["patch_embed.proj.weight"]
    check(torch.equal(got["encoder.patch_embed.proj.weight"].cpu(), w.repeat(1, 7, 1, 1) / 7),
          "the patch embed is not the file's repeated over 7 channels and divided by 7")
    for leaf in BN_LEAVES:
        check(torch.equal(got[f"scalar.{leaf}"].cpu(), sd[f"bn0.{leaf}"].expand(7, -1)),
              f"a ScalarBN {leaf} row is not bn0's")
    for k in rep["skipped"]:
        check(torch.equal(got[k], init[k]), f"{k} does not keep the seed's init")
    enc = [k for k in got if k.startswith("encoder.") and k != "encoder.patch_embed.proj.weight"]
    check(all(torch.equal(got[k].cpu(), sd[k[len("encoder."):]]) for k in enc),
          "the encoder is not the file's")
    log(f"finetune (a): experiment=synth_maccdoa from a synthetic AudioSet HTSAT file "
        f"({path.stat().st_size} bytes, {len(sd)} keys): init_state with the load {load_a:.3f} s "
        f"({smi}); patch embed = file / 7 over 7 channels, 7 x 4 ScalarBN rows = bn0, "
        f"{len(enc) + 1} encoder keys loaded, skipped {rep['skipped']} at the seed's init, "
        f"unused {len(rep['unused'])} file keys, all bit for bit")
    del fresh, init

    # fit: FT_EPOCHS epochs of FIT_STEPS AugMix steps, counted from 0
    dm = FitDataModule(90)
    out = root / "run"
    timings = []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    t0 = time.perf_counter()
    loop.fit(task, dm, cfg, out, timings=timings)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    launches = read_counts()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    # the recipe's num_sanity_val_steps=-1: a whole validation before training
    n_val, n_steps = len(dm.batches), FT_EPOCHS * FIT_STEPS
    n_vals = (FT_EPOCHS + 1) * n_val
    want = expected(K1=n_steps + n_vals, K2=12 * (n_steps + n_vals), K3=12 * n_steps, K8=n_vals)
    log(f"finetune (a) fit: {FT_EPOCHS} epochs of {FIT_STEPS} AugMix steps ({B_TRAIN} loader "
        f"clips, {n_model} to the model), a validation of {n_val} batches before (the "
        f"recipe's sanity pass) and after each, "
        f"{fit_s:.2f} s: launches {launches} (expect {want}); peak device memory "
        f"{peak:.2f} GiB at B={n_model} ({smi})")
    check(launches == want, "finetune fit launch counts")
    lines = [json.loads(s) for s in (out / "metrics.jsonl").read_text().splitlines()]
    check([ln["epoch"] for ln in lines] == list(range(1, FT_EPOCHS + 1)), "finetune epoch lines")
    for ln in lines:
        vals = (list(ln["train"].values()) + list(ln["val"]["losses"].values())
                + list(ln["val"]["macro"].values()))
        check(all(np.isfinite(v) for v in vals), f"finetune epoch {ln['epoch']}: not finite")
        log(f"  epoch {ln['epoch']}: train {ln['train']}, ov {ln['ov_stat']}, val macro "
            f"{ln['val']['macro']}")
    for t in timings:
        ms = t["train_s"] * 1e3 / FIT_STEPS
        log(f"  epoch {t['epoch']}: {ms:.2f} ms/step inside fit (host clock, until the "
            f"epoch's losses are fetched), {B_TRAIN * 1e3 / ms:.1f} loader clips/s, "
            f"{n_model * 1e3 / ms:.1f} clips/s to the model; validation "
            f"{t['val_s'] * 1e3:.1f} ms ({smi})")
    best_line = min(lines, key=lambda ln: ln["val"]["macro"]["SELD_scr"])
    best = out / "checkpoints" / f"epoch_{best_line['epoch']:03d}.ckpt"
    check(best.exists(), f"{best.name} missing")

    # one step's augmentation twice from the same states: bit-identical
    batch = dm.train[0]
    gen_state, np_state = task.aug_generator.get_state(), task._np_rng.get_state()
    parts = ((SELDTask, "host_augment"), (SELDTask, "sample_aug_flags"),
             (SELDTask, "_host_to_device"))
    prepared = []
    for _ in range(2):
        task.aug_generator.set_state(gen_state)
        task._np_rng.set_state(np_state)
        with HostClock(*parts) as clock, HostClock((Rotation, "__call__")) as rot, \
                HostClock((WavMix, "__call__")) as wav:
            t0 = time.perf_counter()
            p = task.prepare_batch(batch)
            host_ms = (time.perf_counter() - t0) * 1e3
        prepared.append((p, task.step_inputs(task._on_step_stream(p))))
    (p, (feats, tgt)), (_, (feats2, tgt2)) = prepared
    check(feats.shape == (n_model, 7, 1001, 64) and torch.equal(feats, feats2)
          and all(torch.equal(tgt[k], tgt2[k]) for k in tgt),
          "the augmented features differ between two runs from the same states")
    log(f"finetune (a): one step's augmentation twice from the same generator and "
        f"RandomState states: {tuple(feats.shape)} features and labels bit-identical; flags "
        f"{p.flags.int().tolist()} (specaug, crop, freqshift, trackmix a copy); the host "
        f"half {host_ms:.1f} ms: host_augment {clock.ms['host_augment']:.1f} (of it rotate "
        f"{rot.ms['__call__']:.1f}, wavmix {wav.ms['__call__']:.1f}, the rest the "
        f"triplication), flags {clock.ms['sample_aug_flags']:.2f}, "
        f"the pinned copies {clock.ms['_host_to_device']:.1f}, the rest (the loader "
        f"batch's host copy) {host_ms - clock.ms['host_augment'] - clock.ms['sample_aug_flags'] - clock.ms['_host_to_device']:.1f} "
        f"(host clock, {smi})")
    del feats2, tgt2, prepared

    # the kernel step against the plain step on the same augmented features
    def grads_with(use_kernels, dtype):
        task.set_use_kernels(use_kernels)
        task.compute_dtype = dtype
        losses, grads, _ = task.grads_on(feats, tgt, torch.Generator(device="cuda").manual_seed(81))
        return losses["loss_all"].float().reshape(1), grads

    lk, gk = grads_with(True, torch.bfloat16)
    lp, gp = grads_with(False, torch.bfloat16)
    lf, gf = grads_with(False, torch.float32)
    task.set_use_kernels(True)
    task.compute_dtype = torch.bfloat16
    log(f"finetune (a) kernel step vs plain step at B={n_model}: loss {lk.item():.6f} (plain "
        f"bf16 {lp.item():.6f}, float32 {lf.item():.6f}; {smi})")
    compare("loss", lk, lp, lf, 2.0 ** -6)
    worst = 0.0
    for name, a, b, c in zip(task.trained_names, gk, gp, gf):
        worst = max(worst, compare(name[-36:], a, b, c, 2.0 ** -4)
                    / max(c.abs().max().item(), 1e-30))
    log(f"every parameter grad within {worst:.3g} of its scale of the plain step's")
    del gk, gp, gf

    # K1, K2 with masks and K3 at B=96 on the step's own inputs
    k1 = hold_k1_train(task, p.x)
    k2 = k3 = (0.0, 0.0)
    for j, (x, bp, m, dout, _) in enumerate(reversed(
            record_block_backwards(task, None, None, 83, feats=(feats, tgt)))):
        e2, r2, e3, r3 = hold_train_block(x, bp, m, dout, j)
        k2, k3 = (max(k2[0], e2), max(k2[1], r2)), (max(k3[0], e3), max(k3[1], r3))
    log(f"on the AugMix step's inputs at B={n_model}: K1 max |d| {k1[0]:.3g}, K2 with masks "
        f"{k2[1]:.3g} and K3 {k3[1]:.3g} of scale (<= 2^-6; {smi})")

    # the TF chain's own time: both AugMix copies' chains on the step's features
    n = B_TRAIN

    def chain():
        for c in range(2):
            sl = slice((c + 1) * n, (c + 2) * n)
            task._apply_tf_chain(feats[sl], {k: v[sl] for k, v in tgt.items()}, p.flags[c],
                                 p.ov1_mask[sl])

    chain_dev, chain_host = device_ms(chain, reps=5)
    chain_ms = cuda_ms(chain, reps=5)
    k1_ms = cuda_ms(lambda: task.extractor(p.x), reps=3)
    log(f"TF chain a step (two copies of {n}: specaug, crop, freqshift, trackmix drawn, applied "
        f"and gated): {chain_ms:.3f} ms back to back, {chain_dev:.3f} ms device (queued), "
        f"{chain_host:.3f} ms host a call; K1 at B={n_model} {k1_ms:.3f} ms ({smi})")
    phase_profile(f"one AugMix step ({B_TRAIN} -> {n_model} clips)",
                  lambda: task.train_step(batch["data"], {"adpit_label": batch["adpit_label"],
                                                          "ov": batch["ov"]},
                                          torch.Generator(device="cuda").manual_seed(84)))
    del feats, tgt, p, task
    torch.cuda.empty_cache()

    # (b) the SELD fine-tune from (a)'s best file
    tune_over = ["experiment=starss23/finetune_maccdoa_augmix1",
                 f"model.kwargs.pretrained_path={best}"]
    cfg_b, tune = task_of(tune_over, FT_TUNE_STEPS)
    check(tune.augmix and tune.aug_type == ["specaug", "crop", "freqshift", "rotate"]
          and len(tune.wave_augs["rotate"].trans) == 2 and not tune.rotate_on_device
          and tune.meta["audioset_pretrain"] is False, "finetune_maccdoa_augmix1 configuration")
    load_b = timed_init(tune, 1)
    _, fresh = task_of(tune_over[:1] + ["model.kwargs.pretrained_path=null"], FT_TUNE_STEPS)
    fresh.init_state(1)
    rep = tune.pretrained_report
    saved = stack_scalar_rows(load_torch_state_dict(best), tune.model)
    got, init = tune.model.state_dict(), fresh.model.state_dict()
    check(rep["missing"] == [] and sorted(rep["skipped"]) == ["tscam_conv.bias",
                                                              "tscam_conv.weight"],
          f"SELD load report {rep}")
    for k, v in got.items():
        ref = init[k] if k in rep["skipped"] else saved[k].to(v.device)
        check(torch.equal(v, ref), f"{k}: not {'the init' if k in rep['skipped'] else 'the file'}")
    del fresh, init, saved
    log(f"finetune (b): experiment=starss23/finetune_maccdoa_augmix1 from {best.name}: "
        f"init_state with the load {load_b:.3f} s ({smi}); {len(got) - 2} keys (a)'s, "
        f"tscam_conv at the seed's init, bit for bit")
    gen = torch.Generator(device="cuda").manual_seed(85)
    vb = next(iter(dm.val_dataloader()))
    torch.cuda.synchronize()
    zero_counts()
    t0 = time.perf_counter()
    losses = [tune.train_step(b["data"], {"adpit_label": b["adpit_label"], "ov": b["ov"]}, gen)
              ["loss_all"] for b in dm.train[:FT_TUNE_STEPS]]
    torch.cuda.synchronize()
    tune_ms = (time.perf_counter() - t0) * 1e3 / FT_TUNE_STEPS
    pred = tune.eval_step(vb)
    torch.cuda.synchronize()
    launches_b = read_counts()
    nb = vb["data"].shape[0]
    want_b = expected(K1=FT_TUNE_STEPS + 1, K2=12 * (FT_TUNE_STEPS + 1), K3=12 * FT_TUNE_STEPS,
                      K8=1)
    log(f"finetune (b): {FT_TUNE_STEPS} steps ({tune_ms:.2f} ms/step, host clock, from host "
        f"batches, {smi}) and one validation batch of {nb}: launches {launches_b} (expect "
        f"{want_b}); losses {[round(float(v), 6) for v in losses]}")
    check(launches_b == want_b, "fine-tune launch counts")
    check(all(np.isfinite(float(v)) for v in losses), "fine-tune loss not finite")
    check(pred["multi_accdoa"].shape == (nb, 100, 117)
          and bool(torch.isfinite(pred["multi_accdoa"]).all()), "fine-tune validation output")
    del tune, dm
    torch.cuda.empty_cache()
    launches_c = phase_mono_recipes(smi, task_of, best)
    tmp.cleanup()
    total = {k: launches[k] + launches_b[k] + launches_c[k] for k in launches}
    return total, {"K1": k1, "K2": k2, "K3": k3}


def mono_batches(seed):
    """FT_MONO_STEPS host batches of B_TRAIN 10 s L3DAS22 clips made as the
    mono_adapter data path makes them: a mono waveform and a single-source
    label (make_labels) through data/dataset.py's generate_spatial_samples,
    one RandomState for all."""
    import numpy as np
    from pseldnets_tpu_torch.data.dataset import generate_spatial_samples

    rs = np.random.RandomState(seed)
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(FT_MONO_STEPS):
        clips = [generate_spatial_samples((rs.randn(MONO_SAMPLES) * 0.1).astype(np.float32),
                                          "multi_accdoa", rs, adpit_label=lab)
                 for lab in make_labels(rng, B_TRAIN, 100)]
        out.append({"data": np.stack([c[0] for c in clips]).astype(np.float32),
                    "adpit_label": np.stack([c[1] for c in clips]), "ov": ["1"] * B_TRAIN})
    return out


def phase_mono_recipes(smi, task_of, best):
    """The two L3DAS22 mono recipes (experiment=l3das22/
    finetune_maccdoa_ov1mono{,_adapterbit}: adapt=mono_finetune trains
    every parameter on K2/K3, mono_adapter the AdapterBit adapters, biases
    and head on K4/K5) from ``best``: FT_MONO_STEPS steps of B_TRAIN
    spatialised clips each (K1 x1 and K2, K3 or K4, K5 x12 a step), counted
    from 0, then the kernel step against the plain step on the first batch
    (phase_finetune's rule). -> the launches of both."""
    import numpy as np
    import torch

    batches = mono_batches(86)
    x = batches[0]["data"][0]  # channels 1-3 are channel 0 panned
    gains = x[1:] @ x[0] / (x[0] @ x[0])
    check(np.allclose(x[1:], gains[:, None] * x[0], atol=1e-6), "mono batches")
    total = expected()
    for exp, kernels_a_step in (("l3das22/finetune_maccdoa_ov1mono", {"K2": 12, "K3": 12}),
                                ("l3das22/finetune_maccdoa_ov1mono_adapterbit",
                                 {"K4": 12, "K5": 12})):
        _, task = task_of([f"experiment={exp}", f"model.kwargs.pretrained_path={best}"],
                          FT_MONO_STEPS)
        check(task.cfg["adapt"]["method"] == "mono_adapter" and task.fused_forward
              and task.cfg["data"]["sample_rate"] == 32000 and not task.augmix,
              f"{exp} configuration")
        task.init_state(2)
        rep = task.pretrained_report
        check(rep is not None and rep["missing"] == [], f"{exp} load report {rep}")
        frozen = {n: p.detach().clone() for n, p in zip(task.names, task.params)
                  if not p.requires_grad}
        gen = torch.Generator(device="cuda").manual_seed(87)
        torch.cuda.synchronize()
        zero_counts()
        t0 = time.perf_counter()
        losses = [task.train_step(b["data"], {"adpit_label": b["adpit_label"], "ov": b["ov"]},
                                  gen)["loss_all"] for b in batches]
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3 / FT_MONO_STEPS
        launches = read_counts()
        want = expected(K1=FT_MONO_STEPS,
                        **{k: v * FT_MONO_STEPS for k, v in kernels_a_step.items()})
        log(f"{exp} from {best.name}: {FT_MONO_STEPS} steps of {B_TRAIN} spatialised 10 s "
            f"clips at 32 kHz ({ms:.2f} ms/step, host clock, from host batches; "
            f"{len(task.trained)} of {len(task.params)} parameter tensors train, "
            f"{len(frozen)} frozen): launches {launches} (expect {want}); losses "
            f"{[round(float(v), 6) for v in losses]} ({smi})")
        check(launches == want, f"{exp} launch counts")
        check(all(np.isfinite(float(v)) for v in losses), f"{exp} loss not finite")
        named = dict(zip(task.names, task.params))
        check(all(torch.equal(named[n], v) for n, v in frozen.items()),
              f"{exp}: a frozen parameter moved")
        total = {k: total[k] + launches[k] for k in total}

        def grads_with(use_kernels, dtype):
            task.set_use_kernels(use_kernels)
            task.compute_dtype = dtype
            b = batches[0]
            losses, grads, _ = task.compute_grads(
                b["data"], {"adpit_label": b["adpit_label"]},
                torch.Generator(device="cuda").manual_seed(88))
            return losses["loss_all"].float().reshape(1), grads

        lk, gk = grads_with(True, torch.bfloat16)
        lp, gp = grads_with(False, torch.bfloat16)
        lf, gf = grads_with(False, torch.float32)
        task.set_use_kernels(True)
        task.compute_dtype = torch.bfloat16
        log(f"{exp} kernel step vs plain step: loss {lk.item():.6f} (plain bf16 "
            f"{lp.item():.6f}, float32 {lf.item():.6f})")
        compare("loss", lk, lp, lf, 2.0 ** -6)
        worst = 0.0
        for name, a, b, c in zip(task.trained_names, gk, gp, gf):
            worst = max(worst, compare(name[-36:], a, b, c, 2.0 ** -4)
                        / max(c.abs().max().item(), 1e-30))
        log(f"{exp}: every trained grad within {worst:.3g} of its scale of the plain step's")
        del task, gk, gp, gf
        torch.cuda.empty_cache()
    return total


# data-parallel training (phase_train_ddp1, phase_train_ddp2): the full
# width HTSAT step of phase_train (TRAIN_OVERRIDES: bf16-mixed, fused, drop-
# path 0.1) in a torch.distributed group; DDP_STEPS timed steps a run
DDP_STEPS = 5
DDP2_STEPS = 3


def ddp_batch(B):
    """phase_train's global batch: B 10 s clips from a CUDA generator of
    seed 6 (the same values in every process) and bench_train.py's labels."""
    import numpy as np
    import torch

    g = torch.Generator(device="cuda").manual_seed(6)
    wavs = [torch.randn(B, 4, N_SAMPLES, device="cuda", generator=g) * 0.1
            for _ in range(DDP_STEPS)]
    labels = torch.from_numpy(make_labels(np.random.default_rng(0), B, 100)).cuda()
    return wavs, labels


def ddp_steps(task, wavs, labels, rows=slice(None)):
    """A warm-up step, then one step a batch (``rows`` of each), the
    drop-path masks from a generator of seed 7: -> (launches counted from
    0 over the timed steps, ms a step (host clock, synchronized), losses)."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(7)
    mine = labels[rows].contiguous()
    step = lambda w: task.train_step(w[rows].contiguous(), {"adpit_label": mine}, gen)  # noqa: E731
    step(wavs[0])
    torch.cuda.synchronize()
    zero_counts()
    t0 = time.perf_counter()
    losses = [step(w)["loss_all"] for w in wavs]
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / len(wavs)
    return read_counts(), ms, [float(v) for v in losses]


def phase_train_ddp1(smi):
    """``train_ddp1``: DDP_STEPS full-width steps of B_TRAIN on one rank of
    an NCCL group on cuda:0 (the grads' all-reduce over one flat buffer,
    the state broadcast from rank 0; with one rank the BatchNorm statistics
    and the draws are the one process's), against the same steps with no
    process group: every parameter and statistic bit-identical, K1 x1, K2
    x12, K3 x12 a step; the ms a step of each, whose difference is the
    collectives' cost on one card."""
    import tempfile

    import torch
    from pseldnets_tpu_torch.config import compose
    from pseldnets_tpu_torch.parallel import init_data_parallel, shutdown, world
    from pseldnets_tpu_torch.train.module import DatasetSpec, SELDTask

    cfg = compose(str(ROOT / "configs"), "train", TRAIN_OVERRIDES)
    wavs, labels = ddp_batch(B_TRAIN)
    dev = torch.device("cuda", 0)
    runs = {}
    for grouped in (False, True):
        store = tempfile.TemporaryDirectory()
        if grouped:
            init_data_parallel(0, 1, "nccl", f"file://{store.name}/store", dev)
        try:
            task = SELDTask(cfg, DatasetSpec(num_classes=13), steps_per_epoch=100, device=dev)
            task.init_state(0)
            launches, ms, losses = ddp_steps(task, wavs, labels)
            check(world() == 1, "one rank")
            runs[grouped] = (launches, ms, losses,
                             {k: v.clone() for k, v in task.model.state_dict().items()})
        finally:
            shutdown()
            store.cleanup()
        del task
    launches, ms, losses, state = runs[True]
    want = expected(K1=DDP_STEPS, K2=12 * DDP_STEPS, K3=12 * DDP_STEPS)
    log(f"train_ddp1: {DDP_STEPS} steps of {B_TRAIN} on one NCCL rank: launches {launches} "
        f"(expect {want}); losses {[round(v, 6) for v in losses]}; {ms:.2f} ms/step, "
        f"without a process group {runs[False][1]:.2f} ms/step (host clock, synchronized; "
        f"{smi})")
    check(launches == want, "train_ddp1 launch counts")
    check(losses == runs[False][2], "train_ddp1 losses differ from the steps without a group")
    differ = [k for k, v in runs[False][3].items() if not torch.equal(v, state[k])]
    check(not differ, f"train_ddp1: {differ[:5]} differ from the steps without a group")
    log(f"train_ddp1: all {len(state)} parameters and statistics bit-identical to the steps "
        f"without a process group")
    torch.cuda.empty_cache()
    return launches, {}


def _ddp2_rank(rank, world, init_method, out):
    """One rank of phase_train_ddp2 on cuda:0 in a gloo group: rank 0
    builds the kernels (a cache hit after phase_build) and the other waits
    at a barrier; then the global batch's rows rank::world, the grads of
    the first (averaged over the ranks) and its loss (the ranks' mean), and
    DDP2_STEPS timed steps; the ranks' states compared bit for bit through
    a broadcast of rank 0's; its record to ``out``."""
    sys.path.insert(0, str(ROOT))
    import torch
    from pseldnets_tpu_torch.config import compose
    from pseldnets_tpu_torch.ops import _cuda
    from pseldnets_tpu_torch.parallel import (all_reduce_mean_, barrier, init_data_parallel,
                                              shutdown)
    from pseldnets_tpu_torch.train.module import DatasetSpec, SELDTask

    dev = torch.device("cuda", 0)
    init_data_parallel(rank, world, "gloo", init_method, dev)
    try:
        if rank == 0:
            _cuda.build_all(list(kernels().values()))
        barrier()
        cfg = compose(str(ROOT / "configs"), "train", TRAIN_OVERRIDES)
        task = SELDTask(cfg, DatasetSpec(num_classes=13), steps_per_epoch=100, device=dev)
        task.init_state(0)
        wavs, labels = ddp_batch(B_TRAIN)
        rows = slice(rank, None, world)
        losses, grads, _ = task.compute_grads(wavs[0][rows].contiguous(),
                                              {"adpit_label": labels[rows].contiguous()},
                                              torch.Generator(device="cuda").manual_seed(8))
        loss = losses["loss_all"].detach().float().reshape(1)
        all_reduce_mean_(grads + [loss])
        launches, ms, step_losses = ddp_steps(task, wavs[:DDP2_STEPS], labels, rows)
        flat = torch.cat([v.float().reshape(-1) for v in task.model.state_dict().values()])
        mine = flat.clone()
        torch.distributed.broadcast(flat, 0)
        same = torch.tensor([float(torch.equal(flat, mine))], device=dev)
        torch.distributed.all_reduce(same)
        record = {"launches": launches, "ms": ms, "losses": step_losses,
                  "identical": bool(same.item() == world), "loss": float(loss.item())}
        if rank == 0:
            record["grads"] = [g.cpu() for g in grads]
        torch.save(record, str(Path(out) / f"rank{rank}.pt"))
    finally:
        shutdown()


def ranks_on_card(target, W, what):
    """``target(rank, W, init_method, out)`` in W spawned processes sharing
    cuda:0 (a gloo group over a file store), each writing its record to
    ``out/rank{r}.pt``; -> the records, after every rank exited with 0
    within 420 s (a rank still running then is ended)."""
    import multiprocessing as mp
    import tempfile

    import torch

    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as out:
        ctx = mp.get_context("spawn")
        procs = [ctx.Process(target=target, args=(r, W, f"file://{out}/store", out))
                 for r in range(W)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + 420
        for p in procs:
            p.join(timeout=max(0.0, deadline - time.monotonic()))
        codes = [p.exitcode for p in procs]
        for p in procs:
            if p.is_alive():
                p.terminate()
                p.join()
        check(codes == [0] * W, f"{what} ranks exited with {codes}")
        return [torch.load(str(Path(out) / f"rank{r}.pt"), weights_only=False)
                for r in range(W)]


def phase_train_ddp2(smi):
    """``train_ddp2``: two ranks sharing cuda:0 in a gloo group (NCCL
    refuses two ranks on one device, and the machine has one card), B =
    B_TRAIN / 2 clips each, rows rank::2 of phase_train's global batch: the
    first batch's grads averaged over the ranks and its loss against the
    one-process kernel step at B_TRAIN on the same batch and drop-path
    masks (hold_step_against_plain's rule: the loss within 2^-6 of its
    scale, every grad within 2^-4 of its own scale, floored at 2^-14 of the
    largest), then DDP2_STEPS steps (K1 x1, K2 x12, K3 x12 a step on each
    rank), after which the ranks' parameters and statistics are
    bit-identical; ms a step of two ranks sharing one card."""
    import torch
    from pseldnets_tpu_torch.config import compose
    from pseldnets_tpu_torch.train.module import DatasetSpec, SELDTask

    W = 2
    recs = ranks_on_card(_ddp2_rank, W, "train_ddp2")

    cfg = compose(str(ROOT / "configs"), "train", TRAIN_OVERRIDES)
    task = SELDTask(cfg, DatasetSpec(num_classes=13), steps_per_epoch=100, device="cuda")
    task.init_state(0)
    wavs, labels = ddp_batch(B_TRAIN)
    losses, gf, _ = task.compute_grads(wavs[0], {"adpit_label": labels},
                                       torch.Generator(device="cuda").manual_seed(8))
    lf = float(losses["loss_all"].detach())
    lk = recs[0]["loss"]
    log(f"train_ddp2: the two ranks' step (B={B_TRAIN // W} each) vs the one-process kernel "
        f"step at B={B_TRAIN}: loss {lk:.6f} (one process {lf:.6f})")
    check(abs(lk - lf) <= 2.0 ** -6 * abs(lf), "train_ddp2 loss disagrees")
    floor = 2.0 ** -14 * max(g.abs().max().item() for g in gf)
    worst = (0.0, "")
    for name, a, c in zip(task.trained_names, recs[0]["grads"], gf):
        scale = max(c.abs().max().item(), floor)
        rel = (a.cuda() - c).abs().max().item() / scale
        check(torch.isfinite(a).all().item() and rel <= 2.0 ** -4,
              f"train_ddp2: the {name} grad {rel:.3g} of its scale from the one-process step's")
        worst = max(worst, (rel, name))
    log(f"train_ddp2: every reduced grad within {worst[0]:.3g} of its scale of the one-process "
        f"step's (<= 2^-4, scales floored at {floor:.3g}; the worst {worst[1]})")
    want = expected(K1=DDP2_STEPS, K2=12 * DDP2_STEPS, K3=12 * DDP2_STEPS)
    for r, rec in enumerate(recs):
        log(f"train_ddp2 rank {r}: {DDP2_STEPS} steps of {B_TRAIN // W}: launches "
            f"{rec['launches']} (expect {want}); losses {[round(v, 6) for v in rec['losses']]}; "
            f"{rec['ms']:.2f} ms/step, two ranks sharing one card over gloo (host clock, "
            f"synchronized; {smi})")
        check(rec["launches"] == want, f"train_ddp2 rank {r} launch counts")
        check(rec["identical"], "train_ddp2: the ranks' parameters differ after the steps")
    log("train_ddp2: the ranks' parameters and statistics bit-identical after the steps")
    del task
    torch.cuda.empty_cache()
    return {n: sum(rec["launches"][n] for rec in recs) for n in kernels()}, {}


TP_STEPS = 3
# the eager full-width HTSAT (fused_forward auto takes the eager modules
# under tensor parallelism), bf16-mixed, drop-path 0.1
TP_OVERRIDES = TRAIN_OVERRIDES + ["trainer.fused_forward=auto"]


def _tp2_rank(rank, world, init_method, out):
    """One rank of phase_train_tp2 on cuda:0 in a gloo group, laid out as
    one data row of two model ranks: rank 0 builds the kernels (a cache hit
    after phase_build) and the other waits; the first batch's grads (the
    split ones gathered to full width) and loss, TP_STEPS timed steps of
    the whole batch (both model ranks read it), one step profiled on rank
    0, the gathered states compared through a broadcast of rank 0's; its
    record to ``out``."""
    sys.path.insert(0, str(ROOT))
    import torch
    from pseldnets_tpu_torch.config import compose
    from pseldnets_tpu_torch.ops import _cuda
    from pseldnets_tpu_torch.parallel import barrier, init_data_parallel, model_world, shutdown
    from pseldnets_tpu_torch.parallel import tp as tensor_parallel
    from pseldnets_tpu_torch.train.module import DatasetSpec, SELDTask

    dev = torch.device("cuda", 0)
    init_data_parallel(rank, world, "gloo", init_method, dev)
    try:
        if rank == 0:
            _cuda.build_all(list(kernels().values()))
        barrier()
        cfg = compose(str(ROOT / "configs"), "train",
                      TP_OVERRIDES + [f"trainer.tensor_parallel={world}"])
        task = SELDTask(cfg, DatasetSpec(num_classes=13), steps_per_epoch=100, device=dev)
        check(model_world() == world and not task.fused_forward, "train_tp2 layout")
        task.init_state(0)
        wavs, labels = ddp_batch(B_TRAIN)
        losses, grads, _ = task.compute_grads(wavs[0], {"adpit_label": labels},
                                              torch.Generator(device="cuda").manual_seed(8))
        split = [(n, g) for n, g in zip(task.trained_names, grads) if n in task.tp_plan]
        full = dict(zip([n for n, _ in split], tensor_parallel.gather_tensors(
            [g for _, g in split], [task.tp_plan[n] for n, _ in split])))
        torch.cuda.reset_peak_memory_stats(dev)
        launches, ms, step_losses = ddp_steps(task, wavs[:TP_STEPS], labels)
        gen = torch.Generator(device="cuda").manual_seed(9)
        step = lambda: task.train_step(wavs[0], {"adpit_label": labels}, gen)  # noqa: E731
        if rank == 0:  # its device busy share, by kernel
            phase_profile("train_tp2 rank 0's step", step, warm=False)
        else:
            step()
        state = task.full_model().state_dict()
        flat = torch.cat([v.float().reshape(-1) for v in state.values()])
        mine = flat.clone()
        torch.distributed.broadcast(flat, 0)
        same = torch.tensor([float(torch.equal(flat, mine))], device=dev)
        torch.distributed.all_reduce(same)
        record = {"launches": launches, "ms": ms, "losses": step_losses,
                  "identical": bool(same.item() == world),
                  "loss": float(losses["loss_all"].detach()), "n_split": len(task.tp_plan),
                  "peak_gib": torch.cuda.max_memory_allocated(dev) / 2 ** 30}
        if rank == 0:
            record["grads"] = [full.get(n, g).cpu() for n, g in zip(task.trained_names, grads)]
        torch.save(record, str(Path(out) / f"rank{rank}.pt"))
    finally:
        shutdown()


def phase_train_tp2(smi):
    """``train_tp2``: tensor parallelism (trainer.tensor_parallel=2) on two
    gloo ranks sharing cuda:0 (one data row of two model ranks: each holds
    half the heads of every attention, half of every MLP's columns and half
    of each merge's input), the full-width HTSAT mACCDOA eager step,
    bf16-mixed, B_TRAIN clips on each, against one process's eager step on
    the same batch and drop-path generator: the loss within 1e-3 relative,
    every grad within 3e-2 of its scale (floored at 2^-14 of the largest),
    or within 4x the one-process bf16 step's largest distance from float32
    (``hold_bf16_grads``); then
    TP_STEPS steps on each rank (K1 x1 a step, no K2/K3: the kernels take
    whole weight matrices), after which the ranks' gathered parameters and
    statistics are bit-identical; ms a step of the two ranks sharing one
    card, rank 0's device busy share (torch.profiler), peak memory."""
    import torch
    from pseldnets_tpu_torch.config import compose
    from pseldnets_tpu_torch.train.module import DatasetSpec, SELDTask

    W = 2
    recs = ranks_on_card(_tp2_rank, W, "train_tp2")

    wavs, labels = ddp_batch(B_TRAIN)
    ref = {}
    for dtype in ("bf16-mixed", "32-true"):
        cfg = compose(str(ROOT / "configs"), "train", TP_OVERRIDES + [
            "trainer.fused_forward=false", f"trainer.precision={dtype}"])
        task = SELDTask(cfg, DatasetSpec(num_classes=13), steps_per_epoch=100, device="cuda")
        task.init_state(0)
        losses, g, _ = task.compute_grads(wavs[0], {"adpit_label": labels},
                                          torch.Generator(device="cuda").manual_seed(8))
        ref[dtype] = (float(losses["loss_all"].detach()), [x.detach() for x in g])
        names = task.trained_names
        del task
        torch.cuda.empty_cache()
    lf, gf = ref["bf16-mixed"]
    g32 = ref["32-true"][1]
    lk = recs[0]["loss"]
    log(f"train_tp2: the two model ranks' step (B={B_TRAIN} on each, {recs[0]['n_split']} "
        f"tensors split) vs one process's eager step: loss {lk:.6f} (one process {lf:.6f}, "
        f"float32 {ref['32-true'][0]:.6f})")
    check(abs(lk - lf) <= 1e-3 * abs(lf), "train_tp2 loss disagrees")
    hold_bf16_grads("train_tp2", names, recs[0]["grads"], gf, g32)
    want = expected(K1=TP_STEPS)
    for r, rec in enumerate(recs):
        log(f"train_tp2 rank {r}: {TP_STEPS} steps of {B_TRAIN}: launches {rec['launches']} "
            f"(expect {want}); losses {[round(v, 6) for v in rec['losses']]}; {rec['ms']:.2f} "
            f"ms/step, two model ranks sharing one card over gloo (host clock, synchronized); "
            f"peak device memory {rec['peak_gib']:.2f} GiB ({smi})")
        check(rec["launches"] == want, f"train_tp2 rank {r} launch counts")
        check(rec["identical"], "train_tp2: the ranks' gathered parameters differ")
    log("train_tp2: the ranks' gathered parameters and statistics bit-identical after the steps")
    torch.cuda.empty_cache()
    return {n: sum(rec["launches"][n] for rec in recs) for n in kernels()}, {}


def hold_bf16_grads(what, names, got, gf, g32):
    """Grads ``got`` of a bf16 step (split over model ranks) against one
    process's bf16 step ``gf``: each within 3e-2 of its scale (floored at
    2^-14 of the largest), or, where bf16 rounding alone moves a grad
    further, within 4x the one-process bf16 step's largest distance from
    its float32 step ``g32`` over all grads (two bf16 steps differ by
    bf16's rounding, heavy-tailed in a grad's largest element; the split
    layers keep their partial sums in float32, parallel/tp.py). -> the
    worst distance as a share of scale."""
    floor = 2.0 ** -14 * max(g.abs().max().item() for g in gf)
    scales = [max(g.abs().max().item(), floor) for g in gf]
    noise = max((c - c32).abs().max().item() / sc for c, c32, sc in zip(gf, g32, scales))
    worst, widened = (0.0, ""), []
    for name, a, c, c32, scale in zip(names, got, gf, g32, scales):
        a = a.to(c.device)
        rel = (a - c).abs().max().item() / scale
        check(a.isfinite().all().item() and rel <= max(3e-2, 4 * noise),
              f"{what}: the {name} grad {rel:.3g} of its scale from the one-process step's "
              f"(the one-process bf16 step up to {noise:.3g} from float32)")
        if rel > 3e-2:
            widened.append((name, round(rel, 4), round((a - c32).abs().max().item() / scale, 4)))
        worst = max(worst, (rel, name))
    log(f"{what}: every grad within {worst[0]:.3g} of its scale of the one-process step's "
        f"(<= 3e-2, or 4x the one-process bf16 step's largest distance from float32, "
        f"{noise:.3g}: (name, distance, its distance from float32) {widened or 'none needed'}; "
        f"scales floored at {floor:.3g}; the worst {worst[1]})")
    return worst[0]


MIC_CLIPS, MIC_CHECK = 32, 4  # clips timed on the card; clips held against the CPU
# the SALSA-lite paper's limits (no shipped config has a data.salsalite entry)
SALSALITE = {"fmin_doa": 50.0, "fmax_doa": 2000.0, "fmax_spectra": 9000.0}


def phase_features_mic(smi):
    """``features_mic``: the mic features on the card (no kernel of the
    port: the JAX package has no Pallas kernel for them) at 10 s, 24 kHz,
    n_fft 1024, hop 240, 64 mels or lags: LogmelExtractor (the windowed-DFT
    STFT, cuDNN's float32 convolution with TF32 off) on 1 and 4 channels,
    GCC-PHAT of the 6 pairs and SALSA-lite (SALSALITE) on the FFT STFT of
    4 channels, each on MIC_CHECK clips against the same function on the
    CPU: log-mel within 1e-3 dB, GCC-PHAT lags within 1e-4, SALSA-lite's
    log power within 1e-5 of the largest power (in the power domain) and
    its phase within 1e-4 as the wrapped angle times the bin's
    cross-spectrum magnitude, of the largest; then each timed on
    MIC_CLIPS clips."""
    import numpy as np
    import torch
    from pseldnets_tpu_torch.config import compose
    from pseldnets_tpu_torch.ops.features import (LogmelExtractor, gcc_phat, salsa_lite,
                                                  salsa_lite_bins)
    from pseldnets_tpu_torch.ops.stft import stft

    cfg = compose(str(ROOT / "configs"), "train", ["data.audio_feature=logmel"])
    data = cfg["data"]
    sr, n_fft, hop, mels = (int(data[k]) for k in ("sample_rate", "nfft", "hoplen", "n_mels"))
    check((sr, n_fft, hop, mels) == (24000, 1024, 240, 64), "the mic features' shape")
    ex = LogmelExtractor(cfg)
    g = torch.Generator(device="cuda").manual_seed(12)
    x = torch.randn(MIC_CLIPS, 4, N_SAMPLES, device="cuda", generator=g) * 0.1
    salsa_args = (sr, n_fft, *SALSALITE.values())

    def spectra(w):
        return stft(w, n_fft, hop, "hann")

    funcs = {"logmel_1ch": lambda w: ex(w[:, :1]), "logmel_4ch": lambda w: ex(w),
             "gcc_phat": lambda w: gcc_phat(*spectra(w), mels),
             "salsa_lite": lambda w: salsa_lite(*spectra(w), *salsa_args)}
    lo, _, cut = salsa_lite_bins(*salsa_args)
    f = torch.arange(n_fft // 2 + 1, dtype=torch.float64)[lo:cut]
    delta = 2.0 * math.pi * sr / (n_fft * 343.0)
    zero_counts()
    out, errs = {}, {}
    for name, fn in funcs.items():
        got = fn(x[:MIC_CHECK]).double().cpu()
        want = fn(x[:MIC_CHECK].cpu()).double()
        check(got.shape == want.shape and torch.isfinite(got).all().item(), f"{name} shape")
        if name.startswith("logmel"):
            err, bound = (got - want).abs().max().item(), 1e-3
        elif name == "gcc_phat":
            err, bound = (got - want).abs().max().item(), 1e-4
        else:
            pg, pw = 10.0 ** (got[:, :4] / 10.0), 10.0 ** (want[:, :4] / 10.0)
            err_p = (pg - pw).abs().max().item() / pw.max().item()
            turn = (got[:, 4:] - want[:, 4:]) * delta * f
            turn = ((turn + math.pi) % (2 * math.pi) - math.pi).abs()
            mag = (pw[:, 1:] * pw[:, :1]).sqrt()
            err_a = (turn * mag).max().item() / mag.max().item()
            check(err_p <= 1e-5, f"salsa_lite log power {err_p:.3g} of the largest power")
            err, bound = err_a, 1e-4
        check(err <= bound, f"{name}: the card's {err:.3g} from the CPU's (bound {bound})")
        ms = cuda_ms(lambda: fn(x), 5)
        out[name] = {"shape": list(fn(x).shape), "ms": ms, "err": err, "bound": bound}
        log(f"features_mic {name}: {MIC_CLIPS} clips of 10 s -> {out[name]['shape']} in "
            f"{ms:.3f} ms on the device; {MIC_CHECK} clips within {err:.3g} of the CPU's "
            f"(<= {bound}) ({smi})")
    launches = read_counts()
    check(launches == expected(), f"features_mic launched {launches}: no kernel expected")
    log(f"features_mic: launches {launches} (no kernel of the port on this path)")
    return launches, {}


def phase_profile(what, fn, warm=True):
    """Device time by kernel over one call of fn (torch.profiler, CUPTI),
    after a warm-up call unless ``warm`` is false; returns the (kernel, ms,
    count) rows, empty when nothing was recorded."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    if warm:
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    # kernel events only: an aten op's own device time repeats its kernels',
    # and a user annotation's (torch.optim's "Optimizer.step#...") spans them
    rows = [(e.key, e.self_device_time_total / 1e3, e.count) for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0
            and not getattr(e, "is_user_annotation", False)]
    busy = sum(r[1] for r in rows)
    if not rows:
        log("profile: no device time recorded (not measured)")
        return rows
    log(f"profile of {what}: device busy {busy:.3f} ms of {wall * 1e3:.3f} ms "
        f"wall ({100 * busy / (wall * 1e3):.1f}%), {sum(r[2] for r in rows)} device "
        f"events, by kernel:")
    for name, ms, n in sorted(rows, key=lambda r: -r[1])[:20]:
        log(f"  {ms:8.3f} ms {100 * ms / busy:5.1f}% x{n:<3d} {name[:90]}")
    return rows


def main():
    t_start = time.perf_counter()
    smi = phase_device()
    sys.path.insert(0, str(ROOT))
    import torch

    phase_build()
    phase_frontend()
    phase_swin_block()
    phase_swin_block_train()
    # the plain paths first, in the same process state as before the adapter
    # kernels existed, so their times compare with earlier runs
    results = {"serve": phase_serve(smi), "train": phase_train(smi)}
    phase_swin_block_adapt()
    results["serve_adapter"] = phase_serve_adapter(smi)
    results["train_adapter"] = phase_train_adapter(smi)
    phase_vit_block()
    results["serve_passt"] = phase_serve_passt(smi)
    phase_conv_block()
    results["serve_crnn"] = phase_serve_crnn(smi)
    phase_patch_embed()
    results["serve_patch"] = phase_serve_patch(smi)
    phase_frontend_forms()
    results["features_flat"] = phase_features_form(smi, "K9", {"radix2": False})
    results["features_dif"] = phase_features_form(smi, "K10", {"variant": "dif"})
    results["serve_passt128"] = phase_serve_wide(smi, "passt", PASST128_OVERRIDES,
                                                 {"K1": 1, "K6": 7}, 251)
    results["serve_htsat128"] = phase_serve_wide(smi, "htsat", HTSAT128_OVERRIDES,
                                                 {"K1": 1, "K8": 1, "K2": 12}, 252)
    phase_swin_stage()
    results["serve_stage"] = phase_serve_stage(smi)
    results["serve_einv2"] = phase_serve_einv2(smi)
    results["train_einv2"] = phase_train_einv2(smi)
    results["train_passt"] = phase_train_passt(smi)
    results["train_crnn"] = phase_train_crnn(smi)
    results["train_lora"] = phase_train_lora(smi)
    results["eval"] = phase_eval(smi)
    results["fit"] = phase_fit(smi)
    results["finetune"] = phase_finetune(smi)
    results["train_ddp1"] = phase_train_ddp1(smi)
    results["train_ddp2"] = phase_train_ddp2(smi)
    results["train_tp2"] = phase_train_tp2(smi)
    results["features_mic"] = phase_features_mic(smi)
    rows = []
    # launches: the sum over the main paths' runs (served batches and training
    # steps, plain, AdapterBit, PaSST and CRNN, HTSAT with the einsum embed, one
    # call of each frontend form, PaSST and HTSAT at 128 mels through the eval
    # route, HTSAT one stage per launch, EINV2 served and
    # trained eagerly, PaSST trained with its validation, the CRNN trained with
    # its dropout and its validation, HTSAT trained eagerly with LoRA, the
    # eager-only adapters and the drop rates, the eval path, fit,
    # the shipped recipes' pre-training, fine-tune and mono recipes, the
    # data-parallel steps on one NCCL rank and on two gloo ranks, both
    # ranks' launches, the tensor-parallel steps on two gloo ranks, both
    # ranks' launches, and the mic features, none), each
    # counted from 0; errors: the largest over the
    # checks at each path's own shapes,
    # absolute and as a share of the plain output's largest magnitude; ms and
    # bounds per served batch (K1, K2, K4, K6, K7, K8, K11), per training step
    # (K3, K5) or per call on a batch (K9, K10); library_ms: one PyTorch call
    # computing the same function (K6, K7), with its error from the plain
    # version as a share of scale; einsum_ms (K8): the einsum embed it
    # replaces, cudnn_conv_ms: cuDNN's conv of the wav2img image alone,
    # *device_ms: the same three queued behind a sleeping kernel (device time
    # without the host's cost a call), host_ms: that host cost a K8 call,
    # sass: its bf16 kernel's SASS counts; served_b128 (K1, K4, K11): one batch
    # of the plain, AdapterBit and stage paths at B=128; k1_ms (K9, K10): K1
    # on the same batch; k2_chained_ms (K11): K2 block after block on the
    # same stage inputs, merges_ms (K11): the three eager merges between the
    # stages
    for name, route_src, replaces in (
            ("K1 fused_logmel_iv", "pseldnets_tpu_torch/csrc/frontend.cu",
             "pseldnets_tpu/ops/pallas/frontend.py:754"),
            ("K2 swin_block_fused", "pseldnets_tpu_torch/csrc/swin_block.cu",
             "pseldnets_tpu/ops/pallas/swin_block.py:663"),
            ("K3 swin_block_backward", "pseldnets_tpu_torch/csrc/swin_block_bwd.cu",
             "pseldnets_tpu/ops/pallas/swin_block_vjp.py:303"),
            ("K4 swin_block_adapt_fused", "pseldnets_tpu_torch/csrc/swin_block_adapt.cu",
             "pseldnets_tpu/ops/pallas/swin_block_adapt_vjp.py:463"),
            ("K5 swin_block_adapt_backward", "pseldnets_tpu_torch/csrc/swin_block_adapt_bwd.cu",
             "pseldnets_tpu/ops/pallas/swin_block_adapt_vjp.py:532"),
            ("K6 vit_block_fused", "pseldnets_tpu_torch/csrc/vit_block.cu",
             "pseldnets_tpu/ops/pallas/vit_block.py:222"),
            ("K7 conv3x3_bias_relu", "pseldnets_tpu_torch/csrc/conv_block.cu",
             "pseldnets_tpu/ops/pallas/conv_block.py:193"),
            ("K8 patch_embed_tokens", "pseldnets_tpu_torch/csrc/patch_embed.cu",
             "pseldnets_tpu/ops/pallas/patch_embed.py:119"),
            ("K9 logmel_iv_flat", "pseldnets_tpu_torch/csrc/frontend_flat.cu",
             "pseldnets_tpu/ops/pallas/frontend.py:556"),
            ("K10 logmel_iv_dif", "pseldnets_tpu_torch/csrc/frontend_dif.cu",
             "pseldnets_tpu/ops/pallas/frontend.py:847"),
            ("K11 swin_stage_fused", "pseldnets_tpu_torch/csrc/swin_stage.cu",
             "pseldnets_tpu/ops/pallas/swin_block.py:848; "
             "pseldnets_tpu/ops/pallas/swin_block.py:1043")):
        key = name.split()[0]
        errs = {path: r[1][key][:2] for path, r in results.items() if key in r[1]}
        timed = next(r[1][key] for r in results.values() if len(r[1].get(key, ())) >= 6)
        ms, plain_ms, b_ms, by = timed[2:6]
        library_ms, library_err = timed[6:8] if len(timed) > 6 else (None, None)
        by_path = {path: results[path][0][key] for path in PATHS}
        rows.append({"name": name, "route": "cuda", "source": route_src,
                     "replaces": replaces, "launches": sum(by_path.values()),
                     "launches_by_path": by_path,
                     "max_abs_err": max(e[0] for e in errs.values()),
                     "max_abs_err_by_path": {k: e[0] for k, e in errs.items()},
                     "max_err_of_scale": max(e[1] for e in errs.values()),
                     "ms": ms, "plain_ms": plain_ms,
                     "bound_ms": b_ms, "bound_by": by, "library_ms": library_ms,
                     "library_err_of_scale": library_err,
                     **(timed[8] if len(timed) > 8 else {}),
                     **({"wide_mels": WIDE_TIMES[key]} if key in WIDE_TIMES else {})})
    log(f"served at 128 mels: {json.dumps(WIDE_TIMES.get('paths', {}))}")
    log(f"wide frontend forms and their controls, share of the allowance: "
        f"{json.dumps(WIDE_CONTROLS)}")
    log(f"chip_smoke: {time.perf_counter() - t_start:.1f} s in all")
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
