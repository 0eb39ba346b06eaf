"""SELD models in PyTorch: the ACCDOA / mACCDOA heads and the EINV2 heads."""

from .factory import build_model  # noqa: F401
