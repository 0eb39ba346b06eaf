"""Data pipeline: corpus descriptors, runtime segment datasets, the distributed
batch sampler, and the prefetching datamodule: a copy of the JAX package's
data/ (numpy; ``h5py`` is imported where a reader opens a file, so the
package imports without it)."""

from .datasets import get_dataset, dataset_dict
from .datamodule import SELDDataModule

__all__ = ["get_dataset", "dataset_dict", "SELDDataModule"]
