"""Offline preprocessing: segment indexing, ACCDOA/track/ADPIT label HDF5
extraction and L3DAS22 metadata conversion (a copy of the JAX package's
preproc/; the offline mic features raise)."""

from .preprocess import Preprocess

__all__ = ["Preprocess"]
