"""SELD losses in PyTorch (ACCDOA and multi-ACCDOA ADPIT in this slice)."""

from .losses import AccdoaLoss, AdpitLoss, build_loss  # noqa: F401
