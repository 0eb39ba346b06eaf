"""SELDTask: the training and eval steps, the counterpart of the JAX
package's train/module.py (:46-159, :175-219, :249-335, :337-654).

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
that trains with dropout (models/common.py ``check_no_dropout``: step 9).

The step comes in two halves, as in the JAX task (:473-506):
``prepare_batch`` takes the loader's batch to the device (on the card from
pinned memory on a side stream) and keeps its ``ov`` list;
``train_step_prepared`` waits on that copy and steps. train/loop.py's
``fit`` runs the first half a batch ahead on a thread of its own.

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
best, the reference's) as weights (train/checkpoint.py).
"""

import math
import os
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..losses import build_loss
from ..models import build_model, einv2_heads, heads
from ..models.common import NO_DECODER
from ..models.factory import init_weights
from ..models.heads import HTSAT
from ..ops._cuda import resolve_device
from ..ops.features import LogmelIVExtractor, make_extractor
from ..ops.frontend import frontend_route
from ..ops.swin_block_adapt import has_adapters
from .checkpoint import is_training_ckpt, load_seld_inference_ckpt, restore_training_ckpt
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


@dataclass
class PreparedBatch:
    """A batch on the task's device (``prepare_batch``): waveforms (B, 4,
    samples) float32, the label tensors, the raw batch's ``ov`` list (or
    None), and on the card the event of the copy that made them."""

    x: torch.Tensor
    targets: Dict[str, torch.Tensor]
    ov: Optional[List[str]] = None
    event: Optional[Any] = None


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
        self.label_res = float(getattr(dataset_spec, "label_resolution", 0.1))
        self.method = cfg["model"]["method"]
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
        self._eval_cache = None
        self._eval_tensors = None
        self._copy_stream = None

    def set_use_kernels(self, use_kernels: bool) -> None:
        """Run the kernels (True) or their plain versions (False) on the same
        device from the next step on: the frontend's and the blocks'."""
        self.use_kernels = use_kernels
        if self.extractor is not None:
            self.extractor.use_kernels = use_kernels

    def init_state(self, seed: Optional[int] = None,
                   ckpt_path: Optional[str] = None) -> TrainState:
        """Seeded random float32 parameters, fresh batch statistics and a
        fresh optimizer state; then, with ``ckpt_path``, the file there, in
        the JAX order (module.py:186-209): a ``ckpt_path`` wins over
        ``model.kwargs.pretrained_path``. The port's ``last.ckpt`` (a file
        that carries ``optimizer_states``, ``global_step``, ``epoch`` and
        ``best_score``) is an exact resume: weights, batch statistics,
        optimizer state, step, epoch and best score (the JAX rule for a
        directory with ``opt_state``, src/train.py:60-63, loop.py:394-411).
        Any other file, the port's best and the reference's ``.ckpt``
        included, loads strictly as weights (train/checkpoint.py). A
        directory (the JAX package's orbax checkpoint) raises: the port
        reads only ``.ckpt`` files. Without ``ckpt_path``, raises where the
        JAX step would load ``pretrained_path`` (a non-empty path that
        exists): the port has no AudioSet loader yet, and random weights
        would silently stand in for the checkpoint."""
        pretrained = self.meta.get("pretrained_path")
        if ckpt_path and os.path.isdir(str(ckpt_path)):
            raise NotImplementedError(
                f"ckpt_path={str(ckpt_path)!r} is a directory (the JAX package's orbax "
                "checkpoint): the port reads only .ckpt files (one torch.save each), its own "
                "and the reference's")
        if not ckpt_path and pretrained and os.path.exists(str(pretrained)):
            raise NotImplementedError(
                f"loading pretrained_path={pretrained!r} is not ported yet "
                "(ROADMAP.md queue A, step 17)")
        ckpt = (torch.load(str(ckpt_path), map_location="cpu", weights_only=False)
                if ckpt_path else None)
        seed = int(self.cfg.get("seed", 0)) if seed is None else int(seed)
        init_weights(self.model, torch.Generator().manual_seed(seed))
        with torch.no_grad():
            self.model.scalar.running_mean.zero_()
            self.model.scalar.running_var.fill_(1.0)
        optimizer, self.lr_fn = build_optimizer(self.cfg, zip(self.names, self.params),
                                                self.steps_per_epoch)
        state = TrainState(optimizer=optimizer)
        if is_training_ckpt(ckpt):
            got = restore_training_ckpt(ckpt_path, self.model, optimizer, ckpt)
            state.step, state.epoch, state.best_score = (got["global_step"], got["epoch"],
                                                         got["best_score"])
        elif ckpt is not None:
            load_seld_inference_ckpt(self.model, ckpt_path, ckpt)
        self.model.train()
        self.state = state
        return state

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
        prepared = self._on_step_stream(self.prepare_batch({"data": batch_x, **targets}))
        return self._grads(prepared.x, prepared.targets, generator, dp_masks)

    def _grads(self, x: torch.Tensor, tgt: Dict[str, torch.Tensor],
               generator: Optional[torch.Generator], dp_masks):
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
        prepared = self.prepare_batch({"data": batch_x, **targets})
        return self.train_step_prepared(prepared, generator, dp_masks)[0]

    def _host_to_device(self, v) -> torch.Tensor:
        """One host array or tensor as float32 on the task's device; on the
        card from pinned memory without blocking (run on the copy stream)."""
        t = v.float() if isinstance(v, torch.Tensor) else \
            torch.from_numpy(np.ascontiguousarray(v, dtype=np.float32))
        if self.device.type == "cuda":
            return t.pin_memory().to(self.device, non_blocking=True)
        return t.to(self.device)

    def prepare_batch(self, batch: Dict) -> PreparedBatch:
        """The host half of a step (the JAX task's prepare_batch,
        module.py:483-498): the loader's batch (numpy arrays, as
        data/datamodule.py's ``collate`` yields them, or tensors) to the
        device, and the raw batch's ``ov`` list, which feeds the ov
        statistics. On the card a host array is copied from pinned memory on
        a side stream, and the copy's event goes with the batch; a tensor
        already on the device is taken as it is. Prepare batches in loader
        order from one thread (fit's pipeline does)."""
        ov = list(batch["ov"]) if "ov" in batch else None
        arrays = {k: v for k, v in batch.items() if k == "data" or k.endswith("label")}
        dev = self.device
        out = {k: v.float() for k, v in arrays.items()
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
        return PreparedBatch(out.pop("data"), out, ov, event)

    def _on_step_stream(self, prepared: PreparedBatch) -> PreparedBatch:
        """The current stream waits on the batch's copy, and the batch's
        tensors are marked as used there, so the caching allocator does not
        hand their memory back to the copy stream early."""
        if prepared.event is not None:
            current = torch.cuda.current_stream(self.device)
            current.wait_event(prepared.event)
            for t in (prepared.x, *prepared.targets.values()):
                t.record_stream(current)
        return prepared

    def train_step_prepared(self, prepared: PreparedBatch,
                            generator: Optional[torch.Generator] = None,
                            dp_masks: Optional[Sequence[torch.Tensor]] = None
                            ) -> Tuple[Dict[str, Any], Optional[List[str]]]:
        """The device half of a step over a ``prepare_batch`` result, on the
        step's stream once the batch's copy is done. -> (losses as device
        tensors, the raw batch's ``ov`` list)."""
        if self.state is None:
            raise RuntimeError("call init_state() first")
        self._on_step_stream(prepared)
        losses, grads, bs = self._grads(prepared.x, prepared.targets, generator, dp_masks)
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
        "passt", "einv2", "crnn" or "eager"."""
        m = self.model
        if isinstance(m, heads.HTSAT) and m.adapt.kernels_support():
            return "htsat"
        if isinstance(m, heads.PASST):
            return "passt"
        if isinstance(m, einv2_heads.HTSAT) and not any(
                has_adapters(b) for enc in (m.sed_encoder, m.doa_encoder)
                for layer in enc.layers for b in layer.blocks):
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
