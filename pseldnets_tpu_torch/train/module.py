"""SELDTask: the training and eval steps, the counterpart of the JAX
package's train/module.py (:46-159, :175-219, :249-335, :337-654).

One step (reference common_step, model_module.py:47-68): FOA waveform ->
frontend (kernel K1 on the card) -> train-mode forward -> loss -> backward
-> clip by global norm -> optimizer -> ScalarBN batch-stat update.
``trainer.fused_forward`` picks the forward: "auto" and true run every Swin
block on kernels K2/K3 (K4/K5 for AdapterBit blocks; train/fused_forward.py),
false the eager ``model.train()`` module (under bf16 autocast with bf16-mixed
precision), the one forward of the CRNN heads (their BatchNorms use batch
statistics there), of PaSST and of the EINV2 heads, which the JAX package
also trains eagerly only (its train/fused_forward.py:34-44 takes
``heads.HTSAT``).

The freeze policy is the JAX step's (train/module.py:276-295): the
parameters that ``trainable_mask`` freezes (AdapterBit: all but biases,
adapters and the head) get ``requires_grad`` False, so they receive no
gradient and stay out of the clip's global norm, as ``stop_gradient`` keeps
them out there; gradients still flow through them to what trains.

Augmentation (the JAX task's registry and step, :65-95, :222-275,
:447-497): ``prepare_batch`` runs the host half, AugMix's triplication then
the waveform augs (rotate, wavmix) in numpy from the task's
``np.random.RandomState`` (``_np_rng``, seeded from ``cfg["seed"]``), then
draws the TF flags from it, in that order; the step rotates on the device
where ``rotate.on_device`` asks (and wavmix is off), runs the frontend,
then the TF chain on the features (SpecAugment, Crop, FreqShift,
TrackMixDevice in the fixed ``TF_AUG_ORDER``, each gated by its flag with
``torch.where``, the flags a device tensor: no host synchronization), one
chain for each AugMix copy, from the task's ``torch.Generator``
(``aug_generator``, on the task's device, seeded from ``cfg["seed"]``).

PaSST (single head and EINV2) trains eagerly, as in the JAX package
(:312-315): its patchout draws (the time-pos-embed crop, the three
patchout forms, position dropout; ``patchout_draws``) and drop-path masks
come from the step's ``generator`` unless injected. So do the dropout
masks (``dropout_draws``, models/common.py ``DropoutDraws``) of the CRNN's
conformer or transformer decoder (rate 0.1, the shipped ``model=crnn``),
of an HTSAT with ``drop_rate``/``attn_drop_rate`` and of the EINV2 heads'
decoders. An HTSAT with LoRA or an eager-only adapter setting (a learnable
``adapter_scalar``, ``new_adapter``, a non-gelu ``act_layer``) or a drop
rate trains and evaluates on the eager modules, as the JAX package routes
it (:137-151, :337-374); ``trainer.fused_forward=true`` refuses it.

Data parallelism (the JAX task over its ``('data',)`` mesh, module.py:
101-125): inside a ``torch.distributed`` group of W processes, one device
each (parallel/mesh.py; cli/train.py starts them), a step on each rank's B
clips is the one-process step on the global batch of W * B clips, up to
float32 summation order. ``init_state`` ends with rank 0's state broadcast
(``broadcast_state``); the training BatchNorms take the global batch's
statistics (models/common.py ``TorchBatchNorm.batch_forward``); the step's
device-side per-clip draws (drop-path, the dropout masks with a batch axis,
the TF chain's, the device rotation's) are this rank's rows of the global
batch's (``parallel.batch_rows``), while draws without a batch axis and the
host half's ``_np_rng`` are the same on every rank; and the trained grads
are averaged over the ranks (``all_reduce_mean_``, one flat buffer) before
the clip, which so sees the global norm, as optax does in the JAX step.
The grads come from ``torch.autograd.grad``, which fires no
``DistributedDataParallel`` hook: the reduction is explicit. Injected draws
(``dp_masks``, ``dropout_draws``, ``aug_draws``, ``patchout_draws``) are the
rank's own. The 5 s clip trick and TrackMix pair clips within a rank's
batch, as the reference's DDP does.

Not in this slice, and raising with the ROADMAP.md queue A step that brings
it: tensor parallelism (``trainer.tensor_parallel`` > 1: step 11).

The step comes in two halves, as in the JAX task (:473-506):
``prepare_batch`` takes the loader's batch to the device (on the card from
pinned memory on a side stream) and keeps its ``ov`` list;
``train_step_prepared`` waits on that copy and steps. train/loop.py's
``fit`` runs the first half a batch ahead on a thread of its own (one
thread: the loader's order, so the host draws stay deterministic).

Eval (``eval_step``): the route of the JAX package's ``_select_fused_eval``
(:337-374), taken on every device: an HTSAT to serving/htsat.py (K1, K8,
K2, or K4 for AdapterBit blocks), PaSST to serving/passt.py (K6), an EINV2
HTSAT without adapters to serving/einv2.py (K2 on both encoders), a CRNN
with a conformer decoder or none to serving/crnn.py (K7), every other head
to the eager ``model.eval()`` forward. A clip the frontend can fold (10 s,
an even hop below a radix-2 n_fft) goes in from the waveform (K1 with the
eval ScalarBN, the cast and the frame pad folded, as served); other clips
(5 s, the trick of models.heads.concat_5s) through the extractor. On the
CPU, or with ``use_kernels=False``, the same functions run the kernels'
plain versions. An odd batch is padded with repeats of its last clip and
sliced back (:527-555); ``post_processing="ACS"`` folds the 16 rotations
into the batch (:557-654). ``init_state(ckpt_path=...)`` resumes exactly
from the port's ``last.ckpt`` and loads any other ``.ckpt`` (the port's
best, the reference's) as weights (train/checkpoint.py); without it,
``model.kwargs.pretrained_path`` loads where it exists, with the JAX
package's load-time surgery (train/checkpoint.py ``load_pretrained``).
"""

import itertools
import math
import os
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..augment import (Crop, FreqShift, Rotation, RotationDevice, SpecAugment,
                       TrackMixDevice, WavMix)
from ..losses import build_loss
from ..models import build_model, einv2_heads, heads
from ..models.adapters import kernel_refusal
from ..models.common import NO_DECODER
from ..models.factory import init_weights
from ..models.heads import HTSAT
from ..ops._cuda import resolve_device
from ..ops.features import LogmelIVExtractor, make_extractor
from ..ops.frontend import frontend_route
from ..parallel import all_reduce_mean_, broadcast_state
from .checkpoint import (is_training_ckpt, load_pretrained, load_seld_inference_ckpt,
                         restore_training_ckpt)
from .fused_forward import htsat_fused_train_forward, supports_fused_train
from .optim import build_optimizer, optimizer_step, trainable_mask


@dataclass
class DatasetSpec:
    """What the task needs of a dataset: the class count, the most sources
    per frame (3, the multi-ACCDOA tracks) and the label frame in seconds."""

    num_classes: int
    max_ov: int = 3
    label_resolution: float = 0.1


@dataclass
class TrainState:
    """The optimizer (and its state), the step count, and the epochs done
    and best validation score so far (train/loop.py's ``fit`` keeps both);
    the parameters and the batch statistics live in ``SELDTask.model``."""

    optimizer: torch.optim.Optimizer
    step: int = 0
    epoch: int = 0
    best_score: float = math.inf


# canonical device-chain order (the JAX package's TF_AUG_ORDER, module.py:36;
# the reference shuffles the chain's order, a documented deviation there)
TF_AUG_ORDER = ("specaug", "crop", "freqshift", "trackmix")


@dataclass
class PreparedBatch:
    """A batch on the task's device (``prepare_batch``): waveforms (B, 4,
    samples) float32 after the host augmentation, the label tensors, the
    raw batch's ``ov`` list (or None), on the card the event of the copy
    that made them, and with a TF chain configured its flags (2,
    len(TF_AUG_ORDER)) bool and the ov1 mask (B,) bool of the augmented
    batch, on the device."""

    x: torch.Tensor
    targets: Dict[str, torch.Tensor]
    ov: Optional[List[str]] = None
    event: Optional[Any] = None
    flags: Optional[torch.Tensor] = None
    ov1_mask: Optional[torch.Tensor] = None


# the heads with drop-path, which take its masks; every head takes the
# step's generator and injected dropout masks, only the PaSST heads
# patchout draws
_DROP_PATH_HEADS = (HTSAT, einv2_heads.HTSAT, einv2_heads.HTSAT_SEDDOA, heads.PASST,
                    einv2_heads.PASST)


def _check_frames(preds: Dict[str, torch.Tensor], targets: Dict[str, torch.Tensor]) -> None:
    """Every output has the label frames (axis 1)."""
    want = {t.shape[1] for k, t in targets.items() if k.endswith("label")}
    got = {p.shape[1] for p in preds.values()}
    if len(want) == 1 and got != want:
        raise ValueError(f"the model gives {sorted(got)} output frames where the labels have "
                         f"{sorted(want)} (PaSST's s_patchout_t drops time patches, and with "
                         "them output frames; the JAX package's step fails here too)")


def _truthy(v) -> bool:
    return v is True or str(v).lower() in ("true", "1", "yes")


class SELDTask:
    def __init__(self, cfg, dataset_spec, steps_per_epoch: int = 1, *, device="cuda",
                 use_kernels: bool = True):
        """``device`` defaults to the card and raises when CUDA is absent;
        ``use_kernels=False`` runs the kernels' plain versions on the same
        device."""
        self.cfg = cfg
        self.device = resolve_device(device)
        self.num_classes = dataset_spec.num_classes
        self.max_ov = dataset_spec.max_ov
        self.label_res = float(getattr(dataset_spec, "label_resolution", 0.1))
        self.method = cfg["model"]["method"]
        self.steps_per_epoch = steps_per_epoch
        self.use_kernels = use_kernels
        trainer = cfg.get("trainer") or {}
        precision = str(trainer.get("precision", "32-true"))
        self.compute_dtype = torch.bfloat16 if "bf16" in precision else torch.float32

        if int(trainer.get("tensor_parallel", 1) or 1) > 1:
            raise NotImplementedError("tensor parallelism is not ported yet "
                                      "(ROADMAP queue A, step 11)")

        self.model, self.meta = build_model(cfg, self.num_classes, device=self.device,
                                            seed=int(cfg.get("seed", 0)))
        self.extractor = make_extractor(cfg, use_kernels=use_kernels)
        self.loss = build_loss(cfg["model"]["loss"])
        self.loss_type = cfg["model"]["loss"].get("loss_type", "loss_all")
        self._build_augmentation(cfg)

        ff = trainer.get("fused_forward", "auto")
        if isinstance(ff, str) and ff.lower() == "auto":
            self.fused_forward = supports_fused_train(self.model)
        else:
            self.fused_forward = _truthy(ff)
            if self.fused_forward and not supports_fused_train(self.model):
                raise ValueError("trainer.fused_forward=true requires an HTSAT with zero "
                                 "attention / projection / position dropout and no LoRA or "
                                 "eager-only adapter setting (constant-scalar gelu adapters "
                                 "run on the kernels)")
        named = list(self.model.named_parameters())
        self.names: List[str] = [n for n, _ in named]
        self.params: List[torch.nn.Parameter] = [p for _, p in named]
        mask = trainable_mask(self.names, (cfg.get("adapt") or {}).get("method", "none"))
        for p, trains in zip(self.params, mask):
            p.requires_grad_(trains)
        # the parameters that train, in model order, and their names
        self.trained_names: List[str] = [n for n, m in zip(self.names, mask) if m]
        self.trained: List[torch.nn.Parameter] = [p for p, m in zip(self.params, mask) if m]
        self.max_norm = trainer.get("gradient_clip_val")
        self.lr_fn = None
        self.pretrained_report: Optional[Dict[str, List[str]]] = None
        self.state: Optional[TrainState] = None
        self._eval_cache = None
        self._eval_tensors = None
        self._copy_stream = None

    def _build_augmentation(self, cfg) -> None:
        """The augmentation registry (the JAX task's, module.py:65-95): the
        host waveform augs on ``_np_rng``, the device TF augs, device
        rotation where ``rotate.on_device`` asks and wavmix is off, and the
        TF chain's combinations (reference model_module.py:61-78)."""
        aug = cfg.get("augment") or {"type": [], "AugMix": False}
        self.aug_type = list(aug.get("type", []) or [])
        self.augmix = bool(aug.get("AugMix", False))
        data = cfg["data"]
        xy_ratio = data["sample_rate"] / data["hoplen"] * self.label_res
        seed = int(cfg.get("seed", 2024))
        self._np_rng = np.random.RandomState(seed)
        self.aug_generator = torch.Generator(device=self.device).manual_seed(seed)
        rotate_cfg = _kw(aug.get("rotate"))
        on_device = rotate_cfg.pop("on_device", False)
        self.wave_augs = {"rotate": Rotation(**rotate_cfg, rng=self._np_rng),
                          "wavmix": WavMix(**_kw(aug.get("wavmix")), rng=self._np_rng)}
        self.tf_augs = {"specaug": SpecAugment(xy_ratio=xy_ratio, **_kw(aug.get("specaug"))),
                        "crop": Crop(**_kw(aug.get("crop"))),
                        "freqshift": FreqShift(**_kw(aug.get("freqshift"))),
                        # trackmix runs on the features only, as in the JAX task
                        "trackmix": TrackMixDevice(**_kw(aug.get("trackmix")))}
        self.rotate_on_device = (_truthy(on_device) and "rotate" in self.aug_type
                                 and "wavmix" not in self.aug_type)
        self.rotate_device = RotationDevice(**rotate_cfg) if self.rotate_on_device else None
        aug_tf = [a for a in self.aug_type if a in TF_AUG_ORDER]
        self.aug_tf_comb = []
        for n in range(1, len(aug_tf) + 1):
            self.aug_tf_comb += list(itertools.combinations(aug_tf, n))

    def set_use_kernels(self, use_kernels: bool) -> None:
        """Run the kernels (True) or their plain versions (False) on the same
        device from the next step on: the frontend's and the blocks'."""
        self.use_kernels = use_kernels
        if self.extractor is not None:
            self.extractor.use_kernels = use_kernels

    def init_state(self, seed: Optional[int] = None,
                   ckpt_path: Optional[str] = None) -> TrainState:
        """Seeded random float32 parameters, fresh batch statistics and a
        fresh optimizer state; then the JAX order (module.py:186-209): a
        ``ckpt_path`` wins over ``model.kwargs.pretrained_path``. The port's
        ``last.ckpt`` (a file that carries ``optimizer_states``,
        ``global_step``, ``epoch`` and ``best_score``) is an exact resume:
        weights, batch statistics, optimizer state, step, epoch and best
        score (the JAX rule for a directory with ``opt_state``,
        src/train.py:60-63, loop.py:394-411). Any other file, the port's
        best and the reference's ``.ckpt`` included, loads strictly as
        weights (train/checkpoint.py). A ``ckpt_path`` directory (the JAX
        package's orbax checkpoint) raises: the port reads only ``.ckpt``
        files. Without ``ckpt_path``, ``pretrained_path`` loads whenever it
        exists (``load_pretrained``: the AudioSet surgery, or a
        SELD-pretrained whole model with the head skips; its report in
        ``pretrained_report``), before the optimizer is built; a file that
        is not a checkpoint, or a directory, raises as ``torch.load``
        does. In a process group every rank loads the same files, then
        takes rank 0's parameters and statistics (``broadcast_state``, the
        JAX ``replicate``)."""
        pretrained = self.meta.get("pretrained_path")
        if ckpt_path and os.path.isdir(str(ckpt_path)):
            raise NotImplementedError(
                f"ckpt_path={str(ckpt_path)!r} is a directory (the JAX package's orbax "
                "checkpoint): the port reads only .ckpt files (one torch.save each), its own "
                "and the reference's")
        ckpt = (torch.load(str(ckpt_path), map_location="cpu", weights_only=False)
                if ckpt_path else None)
        seed = int(self.cfg.get("seed", 0)) if seed is None else int(seed)
        init_weights(self.model, torch.Generator().manual_seed(seed))
        with torch.no_grad():
            self.model.scalar.running_mean.zero_()
            self.model.scalar.running_var.fill_(1.0)
        self.pretrained_report = None
        if ckpt is None and pretrained and os.path.exists(str(pretrained)):
            self.pretrained_report = load_pretrained(self.model, pretrained, self.meta)
        optimizer, self.lr_fn = build_optimizer(self.cfg, zip(self.names, self.params),
                                                self.steps_per_epoch)
        state = TrainState(optimizer=optimizer)
        if is_training_ckpt(ckpt):
            got = restore_training_ckpt(ckpt_path, self.model, optimizer, ckpt)
            state.step, state.epoch, state.best_score = (got["global_step"], got["epoch"],
                                                         got["best_score"])
        elif ckpt is not None:
            load_seld_inference_ckpt(self.model, ckpt_path, ckpt)
        broadcast_state(self.model)
        self.model.train()
        self.state = state
        return state

    def forward_train(self, feats: torch.Tensor, generator: Optional[torch.Generator] = None,
                      dp_masks: Optional[Sequence[torch.Tensor]] = None,
                      patchout_draws=None, dropout_draws=None
                      ) -> Tuple[Dict[str, torch.Tensor], Optional[Dict[str, torch.Tensor]]]:
        """Train-mode forward, drop-path masks given (``dp_masks``, one (B',
        2) float32 mask per block; for the EINV2 HTSAT and PaSST a pair of
        such lists, SED encoder's and DOA encoder's) or drawn from
        ``generator`` (the HTSAT and PaSST heads only: the others have no
        drop-path); PaSST's patchout draws (``patchout_draws``: a
        ``models.passt.PatchoutDraws``, for the EINV2 PaSST a pair) and the
        dropout masks (``dropout_draws``: a ``models.common.DropoutDraws``
        or the list of keep-masks in the forward's call order) likewise,
        passed on only when given: (preds, ScalarBN update), the update
        None on the eager path, whose BatchNorm writes its statistics
        itself."""
        self.model.train()
        if self.fused_forward:
            if patchout_draws is not None or dropout_draws is not None:
                raise ValueError("the fused HTSAT forward takes no patchout draws and has no "
                                 "dropout")
            return htsat_fused_train_forward(self.model, feats, dp_masks=dp_masks,
                                             generator=generator,
                                             compute_dtype=self.compute_dtype,
                                             use_kernels=self.use_kernels)
        kw = {"generator": generator}
        if patchout_draws is not None:
            kw["patchout_draws"] = patchout_draws
        if dropout_draws is not None:
            kw["dropout_draws"] = dropout_draws
        if isinstance(self.model, _DROP_PATH_HEADS):
            kw["dp_masks"] = dp_masks
        elif dp_masks is not None:
            raise ValueError(f"{type(self.model).__name__} takes no drop-path masks")
        with torch.autocast(device_type=self.device.type, dtype=torch.bfloat16,
                            enabled=self.compute_dtype == torch.bfloat16):
            return self.model(feats, **kw), None

    def compute_grads(self, batch_x, targets: Dict, generator: Optional[torch.Generator] = None,
                      dp_masks: Optional[Sequence[torch.Tensor]] = None,
                      aug_draws: Optional[Dict] = None, patchout_draws=None,
                      dropout_draws=None):
        """Host augmentation -> frontend -> TF chain -> forward -> loss ->
        grads of ``self.trained`` (the frozen parameters get none); returns
        (losses, grads, ScalarBN update or None). Changes no parameter.
        ``targets`` may carry the batch's ``ov`` list."""
        prepared = self._on_step_stream(self.prepare_batch({"data": batch_x, **targets}))
        return self._grads(prepared, generator, dp_masks, aug_draws, patchout_draws,
                           dropout_draws)

    def step_inputs(self, prepared: PreparedBatch, aug_draws: Optional[Dict] = None
                    ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """The augmentation half of a step (the JAX step, module.py:250-275)
        on a prepared batch: device rotation of the waveforms where
        configured, the frontend (K1 on the card), then the TF chain on the
        features, one chain for each AugMix copy (clean, copy 1, copy 2
        thirds). -> (features, label tensors). Random draws come from
        ``aug_generator``, or from ``aug_draws`` where given: {"rotate":
        RotationDevice draws, "chains": [{aug name: its draws}, one dict a
        chain]}."""
        x, tgt = prepared.x, prepared.targets
        aug_draws = aug_draws or {}
        with torch.no_grad():
            if self.rotate_device is not None:
                d = aug_draws.get("rotate") or self.rotate_device.draw(self.aug_generator, x.shape)
                x, tgt = self.rotate_device.apply(x, tgt, d)
            feats = self.extractor(x) if self.extractor is not None else x
            if not self.aug_tf_comb:
                return feats, tgt
            chains = aug_draws.get("chains") or [None, None]
            flags, ov1 = prepared.flags, prepared.ov1_mask
            if not self.augmix:
                return self._apply_tf_chain(feats, tgt, flags[0], ov1, chains[0])
            n = feats.shape[0] // 3
            parts = [(feats[:n], {k: v[:n] for k, v in tgt.items()})]
            for c in range(2):
                sl = slice((c + 1) * n, (c + 2) * n if c == 0 else None)
                parts.append(self._apply_tf_chain(feats[sl], {k: v[sl] for k, v in tgt.items()},
                                                  flags[c], ov1[sl], chains[c]))
            feats = torch.cat([p[0] for p in parts], dim=0)
            tgt = {k: torch.cat([p[1][k] for p in parts], dim=0) for k in tgt}
        return feats, tgt

    def _apply_tf_chain(self, feats: torch.Tensor, targets: Dict[str, torch.Tensor],
                        flags: torch.Tensor, ov1_mask: torch.Tensor,
                        draws: Optional[Dict] = None):
        """The configured TF augs in ``TF_AUG_ORDER``, each drawn (or taken
        from ``draws``) and applied, its result kept where its flag is set
        (a 0-d device bool, through ``torch.where``: no host sync). The
        fixed order is the JAX package's documented deviation from the
        reference's shuffled chains (module.py:222-242)."""
        for i, name in enumerate(TF_AUG_ORDER):
            if name not in self.aug_type:
                continue
            aug = self.tf_augs[name]
            d = draws[name] if draws else aug.draw(self.aug_generator, feats.shape)
            if name == "trackmix":
                aug_x, aug_t = aug.apply(feats, targets, d, ov1_mask)
            else:
                aug_x, aug_t = aug.apply(feats, targets, d)
            take = flags[i]
            feats = torch.where(take, aug_x, feats)
            targets = {k: torch.where(take, aug_t[k], v) if "label" in k else v
                       for k, v in targets.items()}
        return feats, targets

    def _grads(self, prepared: PreparedBatch, generator: Optional[torch.Generator], dp_masks,
               aug_draws: Optional[Dict] = None, patchout_draws=None, dropout_draws=None):
        feats, tgt = self.step_inputs(prepared, aug_draws)
        return self.grads_on(feats, tgt, generator, dp_masks, patchout_draws, dropout_draws)

    def grads_on(self, feats: torch.Tensor, tgt: Dict[str, torch.Tensor],
                 generator: Optional[torch.Generator] = None,
                 dp_masks: Optional[Sequence[torch.Tensor]] = None, patchout_draws=None,
                 dropout_draws=None):
        """Forward -> loss -> grads on given (augmented) features: (losses,
        grads, ScalarBN update or None). Outputs whose frames are not the
        labels' raise (PaSST's time patchout drops output frames; the JAX
        step fails there in its loss)."""
        preds, bs = self.forward_train(feats, generator, dp_masks, patchout_draws, dropout_draws)
        _check_frames(preds, tgt)
        losses = self.loss(preds, tgt)
        grads = torch.autograd.grad(losses[self.loss_type], self.trained, allow_unused=True)
        grads = [g if g is not None else torch.zeros_like(p) for g, p in zip(grads, self.trained)]
        return losses, grads, bs

    def train_step(self, batch_x, targets: Dict, generator: Optional[torch.Generator] = None,
                   dp_masks: Optional[Sequence[torch.Tensor]] = None,
                   aug_draws: Optional[Dict] = None, patchout_draws=None,
                   dropout_draws=None) -> Dict[str, Any]:
        """One optimizer step on a batch: FOA waveforms (B, 4, samples) and
        label arrays (``adpit_label``, ``accdoa_label``, or for the EINV2
        heads ``sed_label`` (B, T, 3, K) and ``doa_label`` (B, T, 3, 3)),
        and where given the batch's ``ov`` list. Drop-path masks, PaSST's
        patchout draws and the dropout masks are ``dp_masks``,
        ``patchout_draws`` and ``dropout_draws`` or come from
        ``generator``. Returns the losses as device tensors (no
        host synchronization)."""
        prepared = self.prepare_batch({"data": batch_x, **targets})
        return self.train_step_prepared(prepared, generator, dp_masks, aug_draws,
                                        patchout_draws, dropout_draws)[0]

    def _host_to_device(self, v) -> torch.Tensor:
        """One host array or tensor on the task's device (float32, booleans
        kept); on the card from pinned memory without blocking (run on the
        copy stream)."""
        if isinstance(v, torch.Tensor):
            t = v if v.dtype == torch.bool else v.float()
        else:
            v = np.asarray(v)
            t = torch.from_numpy(np.ascontiguousarray(
                v, dtype=np.bool_ if v.dtype == np.bool_ else np.float32))
        if self.device.type == "cuda":
            return t.pin_memory().to(self.device, non_blocking=True)
        return t.to(self.device)

    @property
    def host_augments(self) -> bool:
        """Whether ``prepare_batch`` changes the batch on the host: AugMix,
        a host rotation or wavmix."""
        return (self.augmix or "wavmix" in self.aug_type
                or ("rotate" in self.aug_type and not self.rotate_on_device))

    def sample_aug_flags(self) -> np.ndarray:
        """(2, len(TF_AUG_ORDER)) booleans: per-AugMix-copy random subset of
        the configured TF augs, drawn from ``_np_rng`` (the JAX task's,
        module.py:447-457; reference augment_data, model_module.py:115-121)."""
        flags = np.zeros((2, len(TF_AUG_ORDER)), bool)
        if not self.aug_tf_comb:
            return flags
        for c in range(2):
            combo = self.aug_tf_comb[self._np_rng.randint(len(self.aug_tf_comb))]
            for i, name in enumerate(TF_AUG_ORDER):
                flags[c, i] = name in combo
        return flags

    def host_augment(self, batch_x: np.ndarray, targets: Dict) -> Tuple:
        """AugMix triplication + waveform augs, host-side (the JAX task's,
        module.py:459-471; reference common_step model_module.py:47-57 +
        data_copy :83-90): rotate, then wavmix, from ``_np_rng``."""
        if self.augmix:
            batch_x = np.concatenate([batch_x] * 3, axis=0)
            targets = {k: (np.concatenate([v] * 3, axis=0)
                           if isinstance(v, np.ndarray) else list(v) * 3)
                       for k, v in targets.items()}
        if "rotate" in self.aug_type and not self.rotate_on_device:
            batch_x, targets = self.wave_augs["rotate"](batch_x, targets)
        if "wavmix" in self.aug_type:
            batch_x, targets = self.wave_augs["wavmix"](batch_x, targets)
        return batch_x, targets

    def prepare_batch(self, batch: Dict) -> PreparedBatch:
        """The host half of a step (the JAX task's prepare_batch,
        module.py:476-497): the host augmentation (``host_augment``, on
        copies of the loader's arrays: a tensor is brought to the host for
        it), then the TF flags (``sample_aug_flags``), both from
        ``_np_rng`` in that order, then the batch (numpy arrays, as
        data/datamodule.py's ``collate`` yields them, or tensors), the flags
        and the ov1 mask of the augmented batch's ``ov`` to the device. The
        raw batch's ``ov`` list, which feeds the ov statistics, goes with
        it. On the card a host array is copied from pinned memory on a side
        stream, and the copy's event goes with the batch; a tensor already
        on the device is taken as it is. Prepare batches in loader order
        from one thread (fit's pipeline does)."""
        ov = list(batch["ov"]) if "ov" in batch else None
        if self.host_augments:
            copy = not self.augmix  # the triplication copies already
            x = _host_array(batch["data"], copy)
            targets = {k: _host_array(v, copy) if (k.endswith("label")
                                                   or isinstance(v, torch.Tensor))
                       else v for k, v in batch.items() if k != "data"}
            x, targets = self.host_augment(x, targets)
            batch = {"data": x, **targets}
        arrays = {k: v for k, v in batch.items() if k == "data" or k.endswith("label")}
        if self.aug_tf_comb:
            aug_ov = batch.get("ov")
            if aug_ov is None or len(aug_ov) == 0:
                aug_ov = ["1"] * batch["data"].shape[0]
            arrays["_flags"] = self.sample_aug_flags()
            arrays["_ov1"] = np.asarray(aug_ov) == "1"
        dev = self.device
        out = {k: v if v.dtype == torch.bool else v.float() for k, v in arrays.items()
               if isinstance(v, torch.Tensor) and v.device.type == dev.type
               and dev.index in (None, v.device.index)}
        host = {k: v for k, v in arrays.items() if k not in out}
        event = None
        if host and self.device.type == "cuda":
            if self._copy_stream is None:
                self._copy_stream = torch.cuda.Stream(self.device)
            with torch.cuda.stream(self._copy_stream):
                out.update({k: self._host_to_device(v) for k, v in host.items()})
                event = torch.cuda.Event()
                event.record(self._copy_stream)
        else:
            out.update({k: self._host_to_device(v) for k, v in host.items()})
        flags, ov1 = out.pop("_flags", None), out.pop("_ov1", None)
        return PreparedBatch(out.pop("data"), out, ov, event, flags, ov1)

    def _on_step_stream(self, prepared: PreparedBatch) -> PreparedBatch:
        """The current stream waits on the batch's copy, and the batch's
        tensors are marked as used there, so the caching allocator does not
        hand their memory back to the copy stream early."""
        if prepared.event is not None:
            current = torch.cuda.current_stream(self.device)
            current.wait_event(prepared.event)
            for t in (prepared.x, *prepared.targets.values(), prepared.flags,
                      prepared.ov1_mask):
                if t is not None:
                    t.record_stream(current)
        return prepared

    def train_step_prepared(self, prepared: PreparedBatch,
                            generator: Optional[torch.Generator] = None,
                            dp_masks: Optional[Sequence[torch.Tensor]] = None,
                            aug_draws: Optional[Dict] = None, patchout_draws=None,
                            dropout_draws=None
                            ) -> Tuple[Dict[str, Any], Optional[List[str]]]:
        """The device half of a step over a ``prepare_batch`` result, on the
        step's stream once the batch's copy is done. -> (losses as device
        tensors, the raw batch's ``ov`` list). In a process group the grads
        are averaged over the ranks before the clip and the optimizer; the
        losses stay this rank's (fit averages an epoch's over the ranks)."""
        if self.state is None:
            raise RuntimeError("call init_state() first")
        self._on_step_stream(prepared)
        losses, grads, bs = self._grads(prepared, generator, dp_masks, aug_draws, patchout_draws,
                                        dropout_draws)
        all_reduce_mean_(grads)
        optimizer_step(self.state.optimizer, self.trained, grads, self.state.step, self.max_norm)
        if bs is not None:
            with torch.no_grad():
                self.model.scalar.running_mean.copy_(bs["running_mean"])
                self.model.scalar.running_var.copy_(bs["running_var"])
        self.state.step += 1
        return ({k: v.detach() if isinstance(v, torch.Tensor) else v for k, v in losses.items()},
                prepared.ov)

    # ---------------------------------------------------------------- eval
    def eval_route(self) -> str:
        """The eval forward this model takes (the JAX package's
        ``_select_fused_eval``, module.py:337-374, on every device): "htsat",
        "passt", "einv2", "crnn" or "eager" (an HTSAT with LoRA or an
        eager-only adapter setting, the EINV2 HTSAT with adapters or LoRA,
        the other heads)."""
        m = self.model
        if isinstance(m, heads.HTSAT) and kernel_refusal(m) is None:
            return "htsat"
        if isinstance(m, heads.PASST):
            return "passt"
        if isinstance(m, einv2_heads.HTSAT) and kernel_refusal(m, adapters=False) is None:
            return "einv2"
        if isinstance(m, heads.CRNN) and (m.decoder_kind == "conformer"
                                          or m.decoder_kind in NO_DECODER):
            return "crnn"
        return "eager"

    def _eval_params(self, route: str) -> Dict[str, Any]:
        """The route's kernel-layout weights in the compute dtype, prepared
        once and kept while no parameter or statistic changes (an in-place
        write, an optimizer step or a load, bumps a tensor's version)."""
        from .. import serving

        if self._eval_tensors is None:  # the model's leaves, listed once
            self._eval_tensors = list(self.model.state_dict(keep_vars=True).values())
        key = (route, self.compute_dtype,
               tuple((t.data_ptr(), t._version) for t in self._eval_tensors))
        if self._eval_cache is not None and self._eval_cache[0] == key:
            return self._eval_cache[1]
        cd, m = self.compute_dtype, self.model
        with torch.no_grad():
            if route == "htsat":
                params = {"blocks": serving.prepare_blocks(m.encoder, cd),
                          "embed": serving.prepare_patch_embed(m.encoder, cd)}
            elif route == "passt":
                params = {"blocks": serving.prepare_vit_blocks(m, cd)}
            elif route in ("einv2", "crnn"):
                prepare = serving.prepare_einv2 if route == "einv2" else serving.prepare_crnn
                params = {"params": prepare(m, cd)}
            else:
                params = {}
        self._eval_cache = (key, params)
        return params

    def _folds_from_wav(self, x: torch.Tensor) -> bool:
        """Whether the route takes clips ``x`` from the waveform, the
        frontend folding the eval ScalarBN, the cast and the frame pad: a
        logmel-IV extractor at a shape whose frontend form takes folds (an
        even hop below an even n_fft), and for the HTSAT heads full clips
        (tgt_output_frames label frames), for PaSST clips of img_size
        frames."""
        ex = self.extractor
        if not isinstance(ex, LogmelIVExtractor):
            return False
        try:
            frontend_route(ex.n_fft, ex.hop, ex.window, folds=True)
        except NotImplementedError:
            return False
        n_frames = 1 + x.shape[-1] // ex.hop
        m = self.model
        if isinstance(m, heads.PASST):
            return n_frames == m.encoder.img_size[1]
        if isinstance(m, (heads.HTSAT, einv2_heads.HTSAT)):
            return (n_frames - 1) // m.pred_res == m.tgt_output_frames
        return True

    def _eval_forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        """(B, 4, samples) waveforms (or offline features) on the task's
        device -> the head's outputs, float32, through the eval route."""
        from .. import serving

        route = self.eval_route()
        if self.model.training:
            self.model.eval()
        if route == "eager":
            with torch.no_grad(), torch.autocast(
                    device_type=self.device.type, dtype=torch.bfloat16,
                    enabled=self.compute_dtype == torch.bfloat16):
                feats = self.extractor(x) if self.extractor is not None else x
                out = self.model(feats)
            return {k: v.float() for k, v in out.items()}
        kw = dict(compute_dtype=self.compute_dtype, use_kernels=self.use_kernels,
                  **self._eval_params(route))
        if self._folds_from_wav(x):
            ex = self.extractor
            fn = {"htsat": serving.htsat_fused_forward_from_wav,
                  "passt": serving.passt_fused_forward_from_wav,
                  "einv2": serving.einv2_htsat_fused_forward_from_wav,
                  "crnn": serving.crnn_fused_forward_from_wav}[route]
            return fn(self.model, x, device=self.device, n_fft=ex.n_fft, hop=ex.hop,
                      window=ex.window, n_mels=ex.n_mels, sample_rate=ex.sr, **kw)
        with torch.no_grad():
            feats = self.extractor(x) if self.extractor is not None else x
        fn = {"htsat": serving.htsat_fused_forward, "passt": serving.passt_fused_forward,
              "einv2": serving.einv2_htsat_fused_forward,
              "crnn": serving.crnn_fused_forward}[route]
        return fn(self.model, feats, **kw)

    def eval_step(self, batch: Dict, post_processing: Optional[str] = None
                  ) -> Dict[str, torch.Tensor]:
        """The eval forward of one batch (``batch["data"]``: (B, 4, samples)
        waveforms, numpy or a tensor) -> the head's outputs as float32
        device tensors (no host synchronization). An odd batch is padded
        with repeats of its last clip to an even size, as the 5 s trick
        needs, and the outputs are sliced back (module.py:527-555);
        ``post_processing="ACS"`` averages the 16 ACS rotations."""
        x = torch.as_tensor(batch["data"], dtype=torch.float32, device=self.device)
        B = x.shape[0]
        if B % 2:
            x = torch.cat([x, x[-1:]], dim=0)
        out = self._acs_forward(x) if post_processing == "ACS" else self._eval_forward(x)
        return {k: v[:B] for k, v in out.items()}

    def validation_losses(self, preds: Dict[str, torch.Tensor], batch: Dict
                          ) -> Dict[str, torch.Tensor]:
        """The loss of eval outputs against ``batch``'s labels, on the
        device (no host synchronization); empty when the batch has none."""
        targets = {k: torch.as_tensor(v, dtype=torch.float32, device=self.device)
                   for k, v in batch.items() if "label" in k}
        if not targets:
            return {}
        with torch.no_grad():
            return self.loss(preds, targets)

    _ACS_SIGNS = ((1, 1, 1), (-1, 1, 1), (1, -1, 1), (-1, -1, 1),
                  (1, 1, -1), (-1, 1, -1), (1, -1, -1), (-1, -1, -1))

    @staticmethod
    def acs_tables() -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """The 16 ACS rotations in the reference's order (8 sign
        combinations x 2 channel swaps, components/model_module.py:269-303;
        the JAX package's ``_acs_tables``): input channel permutations and
        signs, x_v[c] = in_sign[v, c] * x[in_perm[v, c]], and the 3 x 3
        signed permutations that de-rotate the outputs' DOA components."""
        trans = {(0, 1, 2): (1, 2, 3), (1, 0, 2): (3, 2, 1)}
        in_perm, in_sign, out_mat = [], [], []
        for sign_x, sign_y, sign_z in SELDTask._ACS_SIGNS:
            for (xx, yy, zz), (s_x, s_y, s_z) in trans.items():
                in_perm.append([0, s_x, s_y, s_z])
                in_sign.append([1.0, sign_y, sign_z, sign_x])
                m = np.zeros((3, 3), np.float32)
                for t, p in enumerate((xx, yy, zz)):
                    m[t, p] = (sign_x, sign_y, sign_z)[p]
                out_mat.append(m)
        return (np.asarray(in_perm, np.int64), np.asarray(in_sign, np.float32),
                np.stack(out_mat))

    @staticmethod
    def acs_chunk(B: int) -> int:
        """Rotations folded into one forward of a batch of B: the largest of
        8, 4, 2 and 1 that keeps the folded batch at 512 clips or fewer (the
        JAX package's choice, module.py:640-644)."""
        return next(c for c in (8, 4, 2, 1) if c * B <= 512 or c == 1)

    @staticmethod
    def acs_fold(x: torch.Tensor, perm: torch.Tensor, sign: torch.Tensor) -> torch.Tensor:
        """An even batch x (B, 4, samples) under V rotations (``perm``,
        ``sign``: V rows of ``acs_tables``) as one batch (V * B, 4,
        samples) in the (half, variant, item) order."""
        B, V = x.shape[0], perm.shape[0]
        xv = x[:, perm.reshape(-1)].reshape(B, V, 4, -1) * sign[None, :, :, None]
        return xv.reshape(2, B // 2, V, 4, -1).transpose(1, 2).reshape(V * B, 4, -1)

    def _acs_forward(self, x: torch.Tensor, chunk: Optional[int] = None
                     ) -> Dict[str, torch.Tensor]:
        """16-way rotation test-time augmentation of an even batch x (B, 4,
        samples): ``chunk`` rotations folded into the batch a forward in the
        (half, variant, item) order, so that the 5 s trick pairs item j with
        item j + B/2 under one rotation as the reference's per-rotation
        forwards do (module.py:581-622), never variant-major; the outputs
        de-rotated and summed on the device, then averaged."""
        if self.method not in ("accdoa", "multi_accdoa"):
            raise ValueError(f"ACS takes an accdoa or multi_accdoa head, not {self.method!r}")
        key = self.method
        tracks = 3 if key == "multi_accdoa" else 1
        in_perm, in_sign, out_mat = (torch.as_tensor(t, device=x.device)
                                     for t in self.acs_tables())
        B = x.shape[0]
        chunk = self.acs_chunk(B) if chunk is None else int(chunk)
        total = None
        for v0 in range(0, len(in_perm), chunk):
            perm, sign, mat = (t[v0:v0 + chunk] for t in (in_perm, in_sign, out_mat))
            V = perm.shape[0]
            y = self._eval_forward(self.acs_fold(x, perm, sign))[key]
            T = y.shape[1]
            y = y.reshape(2, V, B // 2, T, tracks, 3, -1).transpose(0, 1)
            y = torch.einsum("vts,vbmrsc->vbmrtc", mat, y.reshape(V, B, T, tracks, 3, -1))
            part = y.sum(0).reshape(B, T, -1)
            total = part if total is None else total + part
        return {key: total / len(in_perm)}


def _kw(cfg_entry) -> Dict:
    """An augmentation's config entry as keyword arguments (no _target_)."""
    d = dict(cfg_entry or {})
    d.pop("_target_", None)
    return d


def _host_array(v, copy: bool = True) -> np.ndarray:
    """A batch array as float32 numpy on the host, copied where ``copy``
    (the host augmentation writes into its arrays: without AugMix's
    triplication, into the loader's own)."""
    if isinstance(v, torch.Tensor):
        v = v.detach().to("cpu", torch.float32).numpy()
    return np.array(v, dtype=np.float32, copy=True) if copy else np.asarray(v, np.float32)
