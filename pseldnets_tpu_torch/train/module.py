"""SELDTask: the training step, the counterpart of the JAX package's
train/module.py (:46-159, :249-335).

One step (reference common_step, model_module.py:47-68): FOA waveform ->
frontend (kernel K1 on the card) -> train-mode forward -> loss -> backward
-> clip by global norm -> optimizer -> ScalarBN batch-stat update.
``trainer.fused_forward`` picks the forward: "auto" and true run every Swin
block on kernels K2/K3 (K4/K5 for AdapterBit blocks; train/fused_forward.py),
false the eager ``model.train()`` module (under bf16 autocast with bf16-mixed
precision), the one forward of the CRNN heads (their BatchNorms use batch
statistics there) and of the EINV2 heads, which the JAX package also trains
eagerly only (its train/fused_forward.py:34-44 takes ``heads.HTSAT``).

The freeze policy is the JAX step's (train/module.py:276-295): the
parameters that ``trainable_mask`` freezes (AdapterBit: all but biases,
adapters and the head) get ``requires_grad`` False, so they receive no
gradient and stay out of the clip's global norm, as ``stop_gradient`` keeps
them out there; gradients still flow through them to what trains.

Not in this slice, and raising with the ROADMAP.md queue A step that brings
them: augmentation (non-empty ``augment.type``, AugMix, ``rotate.on_device``:
step 5), tensor parallelism (``trainer.tensor_parallel`` > 1: step 11),
LoRA and the eager-only adapter settings (models/adapters.py: step 6), PaSST
training (models/passt.py: step 8) and a conformer or transformer decoder
that trains with dropout (models/common.py ``check_no_dropout``: step 9). The
epoch loop, data loading, checkpoint save and resume and the
``src/train.py`` entry point are the rest of step 4.
"""

import os
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch

from ..losses import build_loss
from ..models import build_model, einv2_heads
from ..models.factory import init_weights
from ..models.heads import HTSAT
from ..ops._cuda import resolve_device
from ..ops.features import make_extractor
from .fused_forward import htsat_fused_train_forward, supports_fused_train
from .optim import build_optimizer, optimizer_step, trainable_mask


@dataclass
class DatasetSpec:
    """What the task needs of a dataset: the class count and the most
    sources per frame (3, the multi-ACCDOA tracks)."""

    num_classes: int
    max_ov: int = 3


@dataclass
class TrainState:
    """The optimizer (and its state) and the step count; the parameters and
    the batch statistics live in ``SELDTask.model``."""

    optimizer: torch.optim.Optimizer
    step: int = 0


# the heads with drop-path, which take masks or a generator
_DROP_PATH_HEADS = (HTSAT, einv2_heads.HTSAT, einv2_heads.HTSAT_SEDDOA)


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
        self.steps_per_epoch = steps_per_epoch
        self.use_kernels = use_kernels
        trainer = cfg.get("trainer") or {}
        precision = str(trainer.get("precision", "32-true"))
        self.compute_dtype = torch.bfloat16 if "bf16" in precision else torch.float32

        aug = cfg.get("augment") or {}
        if list(aug.get("type", []) or []) or aug.get("AugMix", False) or \
                (aug.get("rotate") or {}).get("on_device", False):
            raise NotImplementedError("augmentation is not ported yet (ROADMAP queue A, step 5)")
        if int(trainer.get("tensor_parallel", 1) or 1) > 1:
            raise NotImplementedError("tensor parallelism is not ported yet "
                                      "(ROADMAP queue A, step 11)")

        self.model, self.meta = build_model(cfg, self.num_classes, device=self.device,
                                            seed=int(cfg.get("seed", 0)))
        self.extractor = make_extractor(cfg, use_kernels=use_kernels)
        self.loss = build_loss(cfg["model"]["loss"])
        self.loss_type = cfg["model"]["loss"].get("loss_type", "loss_all")

        ff = trainer.get("fused_forward", "auto")
        if isinstance(ff, str) and ff.lower() == "auto":
            self.fused_forward = supports_fused_train(self.model)
        else:
            self.fused_forward = _truthy(ff)
            if self.fused_forward and not supports_fused_train(self.model):
                raise ValueError("trainer.fused_forward=true requires an HTSAT with zero "
                                 "attention / projection / position dropout")
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
        self.state: Optional[TrainState] = None

    def set_use_kernels(self, use_kernels: bool) -> None:
        """Run the kernels (True) or their plain versions (False) on the same
        device from the next step on: the frontend's and the blocks'."""
        self.use_kernels = use_kernels
        if self.extractor is not None:
            self.extractor.use_kernels = use_kernels

    def init_state(self, seed: Optional[int] = None) -> TrainState:
        """Seeded random float32 parameters, fresh batch statistics and a
        fresh optimizer state. Raises where the JAX step would load
        ``model.kwargs.pretrained_path`` (a non-empty path that exists):
        the port has no loader yet, and random weights would silently
        stand in for the checkpoint."""
        pretrained = self.meta.get("pretrained_path")
        if pretrained and os.path.exists(str(pretrained)):
            raise NotImplementedError(
                f"loading pretrained_path={pretrained!r} is not ported yet "
                "(ROADMAP.md queue A, step 17)")
        seed = int(self.cfg.get("seed", 0)) if seed is None else int(seed)
        init_weights(self.model, torch.Generator().manual_seed(seed))
        with torch.no_grad():
            self.model.scalar.running_mean.zero_()
            self.model.scalar.running_var.fill_(1.0)
        self.model.train()
        optimizer, self.lr_fn = build_optimizer(self.cfg, zip(self.names, self.params),
                                                self.steps_per_epoch)
        self.state = TrainState(optimizer=optimizer)
        return self.state

    def _to_device(self, batch_x, targets: Dict) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        x = torch.as_tensor(batch_x, dtype=torch.float32, device=self.device)
        t = {k: torch.as_tensor(v, dtype=torch.float32, device=self.device)
             for k, v in targets.items() if k.endswith("label")}
        return x, t

    def forward_train(self, feats: torch.Tensor, generator: Optional[torch.Generator] = None,
                      dp_masks: Optional[Sequence[torch.Tensor]] = None
                      ) -> Tuple[Dict[str, torch.Tensor], Optional[Dict[str, torch.Tensor]]]:
        """Train-mode forward, drop-path masks given (``dp_masks``, one (B',
        2) float32 mask per block; for the EINV2 HTSAT a pair of such lists,
        SED encoder's and DOA encoder's) or drawn from ``generator`` (the
        HTSAT heads only: the others have no drop-path): (preds, ScalarBN
        update), the update None on the eager path, whose BatchNorm writes
        its statistics itself."""
        self.model.train()
        if self.fused_forward:
            return htsat_fused_train_forward(self.model, feats, dp_masks=dp_masks,
                                             generator=generator,
                                             compute_dtype=self.compute_dtype,
                                             use_kernels=self.use_kernels)
        with torch.autocast(device_type=self.device.type, dtype=torch.bfloat16,
                            enabled=self.compute_dtype == torch.bfloat16):
            if isinstance(self.model, _DROP_PATH_HEADS):
                return self.model(feats, dp_masks=dp_masks, generator=generator), None
            if dp_masks is not None:
                raise ValueError(f"{type(self.model).__name__} takes no drop-path masks")
            return self.model(feats), None

    def compute_grads(self, batch_x, targets: Dict, generator: Optional[torch.Generator] = None,
                      dp_masks: Optional[Sequence[torch.Tensor]] = None):
        """Frontend -> forward -> loss -> grads of ``self.trained`` (the
        frozen parameters get none); returns (losses, grads, ScalarBN update
        or None). Changes no parameter."""
        x, tgt = self._to_device(batch_x, targets)
        with torch.no_grad():
            feats = self.extractor(x) if self.extractor is not None else x
        preds, bs = self.forward_train(feats, generator, dp_masks)
        losses = self.loss(preds, tgt)
        grads = torch.autograd.grad(losses[self.loss_type], self.trained, allow_unused=True)
        grads = [g if g is not None else torch.zeros_like(p) for g, p in zip(grads, self.trained)]
        return losses, grads, bs

    def train_step(self, batch_x, targets: Dict, generator: Optional[torch.Generator] = None,
                   dp_masks: Optional[Sequence[torch.Tensor]] = None) -> Dict[str, Any]:
        """One optimizer step on a batch: FOA waveforms (B, 4, samples) and
        label arrays (``adpit_label``, ``accdoa_label``, or for the EINV2
        heads ``sed_label`` (B, T, 3, K) and ``doa_label`` (B, T, 3, 3)).
        Drop-path masks are ``dp_masks`` or come from ``generator``. Returns the losses as
        device tensors (no host synchronization)."""
        if self.state is None:
            raise RuntimeError("call init_state() first")
        losses, grads, bs = self.compute_grads(batch_x, targets, generator, dp_masks)
        optimizer_step(self.state.optimizer, self.trained, grads, self.state.step, self.max_norm)
        if bs is not None:
            with torch.no_grad():
                self.model.scalar.running_mean.copy_(bs["running_mean"])
                self.model.scalar.running_var.copy_(bs["running_var"])
        self.state.step += 1
        return {k: v.detach() if isinstance(v, torch.Tensor) else v for k, v in losses.items()}
