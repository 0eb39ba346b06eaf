"""SELD losses in PyTorch, the counterpart of the JAX package's
losses/losses.py.

Parity targets: reference src/loss/accdoa.py:3-23 (ACCDOA: MSE or L1 on the
ACCDOA vectors), src/loss/multi_accdoa.py:5-106 (auxiliary duplicating
permutation-invariant training for multi-ACCDOA: 13 permutations of the
same-class-overlap track groups, the per-(frame, class) minimum taken with
the first permutation winning ties) and src/loss/einv2.py:30-188 (the EINV2
heads' track-wise PIT and the activity-coupled AGG loss, the per-frame
minimum over the 3! track orders, the first order winning ties).
"""

import itertools
from typing import Any, Dict

import torch
import torch.nn.functional as F


def _mse_none(pred, target):
    d = pred - target
    return d * d


def _l1_none(pred, target):
    return (pred - target).abs()


def _bce_logits_none(pred, target):
    # torch BCEWithLogitsLoss: max(x, 0) - x*z + log(1 + exp(-|x|))
    return pred.clamp(min=0) - pred * target + torch.log1p(torch.exp(-pred.abs()))


_ELEMWISE = {"mse": _mse_none, "l1": _l1_none, "bce": _bce_logits_none}
_TRACK_ORDERS = [list(p) for p in itertools.permutations(range(3))]


def _pit_reduce(x: torch.Tensor) -> torch.Tensor:
    """Mean over the dims after (B, T) (reference loss_utilities.py:20)."""
    return x.mean(dim=tuple(range(2, x.dim())))


def _pit_min(losses: torch.Tensor, *others: torch.Tensor):
    """Per (B, T): the minimum over the track orders of ``losses`` (6, B,
    T), the first order winning ties, and ``others`` taken at that order."""
    idx = torch.argmin(losses, dim=0)[None]
    return [torch.gather(t, 0, idx)[0] for t in (losses,) + others]


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


class Einv2PitLoss:
    """Track-wise PIT over the 3! track orders of beta BCE(sed) + (1 - beta)
    MSE(doa) on pred['sed'] (B, T, 3, K) logits and pred['doa'] (B, T, 3, 3)
    against target['sed_label'] and target['doa_label'] (reference
    src/loss/einv2.py:30-116); ``method`` without "PIT": no permutation."""

    loss_dict_keys = ("loss_all", "loss_sed", "loss_doa", "loss_other")

    def __init__(self, loss_fn=None, loss_type: str = "loss_all", method: str = "tPIT",
                 loss_beta: float = 0.5, **_):
        loss_fn = loss_fn or {"sed": "bce", "doa": "mse"}
        self.sed_fn = _ELEMWISE[loss_fn["sed"]]
        self.doa_fn = _ELEMWISE[loss_fn["doa"]]
        self.beta = float(loss_beta)
        self.pit = "PIT" in method
        self.max_ov = 3

    def __call__(self, pred: Dict, target: Dict, epoch_it: int = 0) -> Dict:
        sed_t = target["sed_label"][:, :, : self.max_ov]
        doa_t = target["doa_label"][:, :, : self.max_ov]
        if not self.pit:
            loss_sed = self.sed_fn(pred["sed"], sed_t).mean()
            loss_doa = self.doa_fn(pred["doa"], doa_t).mean()
        else:
            sed_l = torch.stack([_pit_reduce(self.sed_fn(pred["sed"], sed_t[:, :, p]))
                                 for p in _TRACK_ORDERS])  # (6, B, T)
            doa_l = torch.stack([_pit_reduce(self.doa_fn(pred["doa"], doa_t[:, :, p]))
                                 for p in _TRACK_ORDERS])
            _, sed_min, doa_min = _pit_min(self.beta * sed_l + (1 - self.beta) * doa_l,
                                           sed_l, doa_l)
            loss_sed, loss_doa = sed_min.mean(), doa_min.mean()
        loss_all = self.beta * loss_sed + (1 - self.beta) * loss_doa
        return {"loss_all": loss_all, "loss_sed": loss_sed, "loss_doa": loss_doa,
                "loss_other": 0.0}


class AggPitLoss:
    """Activity-coupled AGG loss (reference src/loss/einv2.py:118-188): the
    prediction sigmoid(sed) x normalize(doa) (F.normalize, eps 1e-12) and
    the target sed_label x doa_label, (B, T, 3, K, 3), compared by
    ``loss_fn`` with ``method`` "mACCDOA_pit" (track-wise PIT), "ACCDOA"
    (the tracks summed, no permutation) or any other name (alpha times the
    first plus 1 - alpha times the second)."""

    loss_dict_keys = ("loss_all", "loss_agg", "loss_accdoa", "loss_other")

    def __init__(self, loss_fn: str = "mse", loss_type: str = "loss_all",
                 loss_alpha: float = 0.0, method: str = "mACCDOA_pit", **_):
        self.fn = _ELEMWISE[loss_fn]
        self.alpha = float(loss_alpha)
        self.method = method
        self.max_ov = 3

    def _tpit(self, pred, target):
        losses = torch.stack([_pit_reduce(self.fn(pred, target[:, :, p]))
                              for p in _TRACK_ORDERS])  # (6, B, T)
        return _pit_min(losses)[0]

    def __call__(self, pred: Dict, target: Dict, epoch_it: int = 0) -> Dict:
        sed_p = torch.sigmoid(pred["sed"])  # (B, T, 3, K)
        doa_p = F.normalize(pred["doa"], dim=-1, eps=1e-12)
        tgt = target["sed_label"][..., None] * target["doa_label"][:, :, :, None, :]
        prd = sed_p[..., None] * doa_p[:, :, :, None, :]  # (B, T, 3, K, 3)
        loss_agg = loss_accdoa = 0.0
        if self.method != "ACCDOA":
            loss_agg = self._tpit(prd, tgt).mean()
        if self.method != "mACCDOA_pit":
            loss_accdoa = self.fn(prd.sum(dim=2), tgt.sum(dim=2)).mean()
        if self.method == "mACCDOA_pit":
            loss_all = loss_agg
        elif self.method == "ACCDOA":
            loss_all = loss_accdoa
        else:
            loss_all = self.alpha * loss_agg + (1 - self.alpha) * loss_accdoa
        return {"loss_all": loss_all, "loss_agg": loss_agg, "loss_accdoa": loss_accdoa,
                "loss_other": 0.0}


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
