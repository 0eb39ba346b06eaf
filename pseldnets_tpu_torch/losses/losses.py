"""SELD losses in PyTorch, the counterpart of the JAX package's
losses/losses.py (:33-92, :182-190).

Parity targets: reference src/loss/accdoa.py:3-23 (ACCDOA: MSE or L1 on the
ACCDOA vectors) and src/loss/multi_accdoa.py:5-106 (auxiliary duplicating
permutation-invariant training for multi-ACCDOA: 13 permutations of the
same-class-overlap track groups, the per-(frame, class) minimum taken with
the first permutation winning ties). The EINV2 losses belong to a later slice
and raise.
"""

from typing import Any, Dict

import torch


def _mse_none(pred, target):
    d = pred - target
    return d * d


def _l1_none(pred, target):
    return (pred - target).abs()


def _bce_logits_none(pred, target):
    # torch BCEWithLogitsLoss: max(x, 0) - x*z + log(1 + exp(-|x|))
    return pred.clamp(min=0) - pred * target + torch.log1p(torch.exp(-pred.abs()))


_ELEMWISE = {"mse": _mse_none, "l1": _l1_none, "bce": _bce_logits_none}


class AccdoaLoss:
    """MSE/L1 on pred['accdoa'] vs target['accdoa_label']."""

    loss_dict_keys = ("loss_all", "loss_accdoa", "loss_other")

    def __init__(self, loss_fn: str = "mse", loss_type: str = "loss_all", **_):
        self.fn = _ELEMWISE[loss_fn]

    def __call__(self, pred: Dict, target: Dict, epoch_it: int = 0) -> Dict:
        loss = self.fn(pred["accdoa"], target["accdoa_label"]).mean()
        return {"loss_all": loss + 0.0, "loss_accdoa": loss, "loss_other": 0.0}


# ADPIT: 13 track-permutations of the (A, B, C) same-class-overlap groups
# (reference src/loss/multi_accdoa.py:36-69). Index order: A0 B0 B1 C0 C1 C2.
_B_PERMS = [(1, 1, 2), (1, 2, 1), (1, 2, 2), (2, 1, 1), (2, 1, 2), (2, 2, 1)]
_C_PERMS = [(3, 4, 5), (3, 5, 4), (4, 3, 5), (4, 5, 3), (5, 3, 4), (5, 4, 3)]


class AdpitLoss:
    """Auxiliary duplicating PIT for multi-ACCDOA: pred['multi_accdoa']
    (B, T, 9K) against target['adpit_label'] (B, T, 6, 4, K)."""

    loss_dict_keys = ("loss_all", "loss_adpit", "loss_other")

    def __init__(self, loss_fn: str = "mse", loss_type: str = "loss_all", **_):
        pass

    def __call__(self, pred: Dict, target: Dict, epoch_it: int = 0) -> Dict:
        out = pred["multi_accdoa"]
        tgt = target["adpit_label"]
        B, T = out.shape[:2]
        K = tgt.shape[-1]
        groups = tgt[:, :, :, 0:1, :] * tgt[:, :, :, 1:, :]  # activity-masked DOA (B, T, 6, 3, K)

        def cat3(i, j, k):
            return torch.cat([groups[:, :, i], groups[:, :, j], groups[:, :, k]], dim=2)

        A = cat3(0, 0, 0)
        b_first = cat3(*_B_PERMS[0])
        c_first = cat3(*_C_PERMS[0])
        pad_a, pad_b, pad_c = b_first + c_first, A + c_first, A + b_first
        targets = ([A + pad_a] + [cat3(*p) + pad_b for p in _B_PERMS]
                   + [cat3(*p) + pad_c for p in _C_PERMS])
        targets = torch.stack(targets, dim=0)  # (13, B, T, 9, K)
        out = out.reshape(B, T, 9, K)
        losses = ((out[None] - targets) ** 2).mean(dim=3)  # (13, B, T, K)
        idx = torch.argmin(losses, dim=0)  # the first index on ties
        loss = torch.gather(losses, 0, idx[None])[0].mean()
        return {"loss_all": loss + 0.0, "loss_adpit": loss, "loss_other": 0.0}


class _NotPorted:
    def __init__(self, *_, **__):
        raise NotImplementedError(f"{type(self).__name__} belongs to the EINV2 slice of "
                                  "the port (ROADMAP queue A, step 7)")


class Einv2PitLoss(_NotPorted):
    """Track-wise PIT of the EINV2 heads (not ported yet)."""


class AggPitLoss(_NotPorted):
    """Activity-coupled AGG loss of the EINV2 heads (not ported yet)."""


_TARGETS = {
    "loss.accdoa.Losses": AccdoaLoss,
    "loss.multi_accdoa.Losses": AdpitLoss,
    "loss.einv2.Losses_pit": Einv2PitLoss,
    "loss.einv2.Losses_agg_pit": AggPitLoss,
}


def build_loss(loss_cfg: Dict[str, Any]):
    """Instantiate from the reference's hydra ``_target_`` spec
    (configs/loss/*.yaml)."""
    cfg = dict(loss_cfg)
    target = cfg.pop("_target_")
    if target not in _TARGETS:
        raise KeyError(f"unknown loss target '{target}'")
    return _TARGETS[target](**cfg)
