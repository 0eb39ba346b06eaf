"""SELD losses in PyTorch: ACCDOA, multi-ACCDOA ADPIT and the EINV2 tPIT
and AGG losses."""

from .losses import AccdoaLoss, AdpitLoss, AggPitLoss, Einv2PitLoss, build_loss  # noqa: F401
