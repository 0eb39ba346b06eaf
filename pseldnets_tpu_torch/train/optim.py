"""Optimizers and learning-rate schedules, the counterpart of the JAX package's
train/optim.py (:18-140).

Parity: reference BaseModelModule.configure_optimizers
(src/models/components/model_module.py:128-146): AdamW / Adam / SGD /
RMSprop from cfg.model.optimizer, StepLR / MultiStepLR / CosineAnnealingLR
stepped per epoch, optional two-group ``multi_opt`` (sed_encoder vs rest),
the adapter freeze policy, and gradient clipping by global norm
(trainer.gradient_clip_val).

torch.optim's AdamW, Adam and SGD carry the updates: they are optax's (the
JAX package's optimizer library) to float32 rounding, AdamW's decoupled
decay included, which acts on every trained parameter as optax.adamw with
no mask does. Two rules differ between optax and torch's helpers, and the
optax rule is kept: ``clip_by_global_norm_`` scales by max_norm / norm only
when norm > max_norm (torch.nn.utils.clip_grad_norm_ adds 1e-6 to the
norm), and ``RMSprop`` adds eps inside the square root and traces the
rate-scaled step (torch.optim.RMSprop does neither). Each param group
carries its schedule as ``lr_fn``; frozen parameters stay out of the
optimizer, which leaves them as they are (optax.set_to_zero).
"""

import math
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch


def epoch_schedule(base_lr: float, sched_cfg: Optional[Dict],
                   steps_per_epoch: int) -> Callable[[int], float]:
    """torch lr_scheduler semantics, stepped once per epoch: step -> lr."""
    if not sched_cfg:
        return lambda step: base_lr
    method = sched_cfg.get("method", "StepLR")
    kw = dict(sched_cfg.get("kwargs", {}) or {})

    def epoch_of(step):
        return step // steps_per_epoch

    if method == "StepLR":
        size, gamma = int(kw.get("step_size", 30)), float(kw.get("gamma", 0.1))
        return lambda step: base_lr * gamma ** (epoch_of(step) // size)
    if method == "MultiStepLR":
        milestones = sorted(kw.get("milestones", []))
        gamma = float(kw.get("gamma", 0.1))
        return lambda step: base_lr * gamma ** sum(epoch_of(step) >= m for m in milestones)
    if method == "CosineAnnealingLR":
        t_max, eta_min = float(kw["T_max"]), float(kw.get("eta_min", 0.0))

        def cosine(step):
            e = min(epoch_of(step), t_max)
            return eta_min + (base_lr - eta_min) * 0.5 * (1 + math.cos(math.pi * e / t_max))
        return cosine
    raise NotImplementedError(f"lr_scheduler '{method}'")


@torch.no_grad()
def clip_by_global_norm_(grads: List[torch.Tensor], max_norm: float,
                         split: Optional[Sequence[bool]] = None) -> None:
    """g *= max_norm / ||g|| when ||g|| > max_norm, in place (optax).
    ``split`` (tensor parallelism, parallel/tp.py): which grads are this
    model rank's part of a split parameter; their squares are summed over
    the model row, the replicated ones' (equal on every model rank) counted
    once, so the norm is the one process's."""
    norms = torch.stack(torch._foreach_norm(grads))
    if split is None or not any(split):
        norm = torch.linalg.vector_norm(norms)
    else:
        from ..parallel.tp import sum_over_model_

        mine = torch.tensor(list(split), device=norms.device)
        sq = sum_over_model_((norms[mine].float() ** 2).sum())
        norm = torch.sqrt(sq + (norms[~mine].float() ** 2).sum())
    torch._foreach_mul_(grads, torch.clamp(max_norm / norm, max=1.0))


class RMSprop(torch.optim.Optimizer):
    """optax.rmsprop: nu = alpha nu + (1 - alpha) g^2 from 0, the step
    -lr g / sqrt(nu + eps), then a momentum trace of that step."""

    def __init__(self, params, lr=1e-2, alpha=0.99, eps=1e-8, momentum=0.0):
        super().__init__(params, dict(lr=lr, alpha=alpha, eps=eps, momentum=momentum))

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            for p in group["params"]:
                st = self.state[p]
                if not st:
                    st["nu"], st["trace"] = torch.zeros_like(p), torch.zeros_like(p)
                nu = st["nu"].mul_(group["alpha"])
                nu.addcmul_(p.grad, p.grad, value=1.0 - group["alpha"])
                upd = p.grad * torch.rsqrt(nu + group["eps"]) * -group["lr"]
                if group["momentum"]:
                    upd = st["trace"].mul_(group["momentum"]).add_(upd)
                p.add_(upd)


def _optimizer(method: str, kwargs: Dict) -> Tuple[type, Dict]:
    """The optimizer class and a param group's options, read from the
    config's kwargs as the JAX package's map reads them."""
    kw = dict(kwargs)
    if method == "AdamW":
        return torch.optim.AdamW, dict(betas=tuple(kw.get("betas", (0.9, 0.999))),
                                       eps=kw.get("eps", 1e-8),
                                       weight_decay=kw.get("weight_decay", 0.01))
    if method == "Adam":
        return torch.optim.Adam, dict(eps=kw.get("eps", 1e-8))
    if method == "SGD":
        return torch.optim.SGD, dict(momentum=kw.get("momentum", 0.0),
                                     nesterov=kw.get("nesterov", False))
    if method == "RMSprop":
        return RMSprop, dict(alpha=kw.get("alpha", 0.99), eps=kw.get("eps", 1e-8),
                             momentum=kw.get("momentum", 0.0))
    raise NotImplementedError(f"optimizer '{method}'")


def trainable_mask(names: Sequence[str], adapt_method: str) -> List[bool]:
    """Freeze policy (reference accdoa.py:148-170) over torch parameter names:
    with 'adapter' in the adapt method only biases, adapter/LoRA parameters and
    the task head (tscam_conv / fc) train; mono_adapter with no adapter
    parameters present unfreezes everything."""
    if "adapter" not in (adapt_method or ""):
        return [True] * len(names)
    if adapt_method == "mono_adapter" and not any("adapter" in n or "lora" in n for n in names):
        return [True] * len(names)

    def trains(name):
        if name.rsplit(".", 1)[-1] == "bias" or "adapter" in name or "lora" in name:
            return True
        return "tscam_conv" in name or name.startswith("fc.") or ".fc." in name
    return [trains(n) for n in names]


def build_optimizer(cfg, named_params: Sequence[Tuple[str, torch.Tensor]],
                    steps_per_epoch: int) -> Tuple[torch.optim.Optimizer, Callable]:
    """-> (optimizer, lr_fn) over the trained ones of ``named_params``.
    Honors multi_opt two-group kwargs and the adapter freeze policy; the
    clip (trainer.gradient_clip_val) is ``optimizer_step``'s."""
    opt_cfg = cfg["model"]["optimizer"]
    sched_cfg = cfg["model"].get("lr_scheduler")
    method = opt_cfg["method"]
    kwargs = dict(opt_cfg.get("kwargs", {}) or {})
    lr_fn = epoch_schedule(float(kwargs.get("lr", 1e-3)), sched_cfg, steps_per_epoch)
    named = list(named_params)
    mask = trainable_mask([n for n, _ in named], (cfg.get("adapt") or {}).get("method", "none"))
    trained = [(n, p) for (n, p), m in zip(named, mask) if m]

    if opt_cfg.get("multi_opt", False):
        kwargs1 = dict(opt_cfg.get("kwargs1", {}) or {})
        lr1_fn = epoch_schedule(float(kwargs1.get("lr", kwargs.get("lr", 1e-3))), sched_cfg,
                                steps_per_epoch)
        groups = [([p for n, p in trained if "sed_encoder" in n], kwargs1, lr1_fn),
                  ([p for n, p in trained if "sed_encoder" not in n], kwargs, lr_fn)]
    else:
        groups = [([p for _, p in trained], kwargs, lr_fn)]
    cls = _optimizer(method, kwargs)[0]
    return cls([dict(params=ps, lr=fn(0), lr_fn=fn, **_optimizer(method, kw)[1])
                for ps, kw, fn in groups if ps]), lr_fn


@torch.no_grad()
def optimizer_step(opt: torch.optim.Optimizer, params: Sequence[torch.Tensor],
                   grads: List[torch.Tensor], step: int,
                   max_norm: Optional[float] = None,
                   split: Optional[Sequence[bool]] = None) -> None:
    """Update ``step`` (counted from 0): clip ``grads`` (one per trained
    parameter; frozen ones have none and stay out of the norm) by their
    global norm when ``max_norm`` is set (``split``: which are split over
    the model ranks, ``clip_by_global_norm_``), give each group its rate
    for the step, and step the optimizer."""
    if max_norm:
        clip_by_global_norm_(grads, float(max_norm), split)
    for p, g in zip(params, grads):
        p.grad = g
    for group in opt.param_groups:
        group["lr"] = group["lr_fn"](step)
    opt.step()
    for p in params:
        p.grad = None
