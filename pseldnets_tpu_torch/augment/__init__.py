"""Augmentation suite (the JAX package's augment/, the same names).

Waveform-domain augs (Rotation, WavMix, TrackMix) run host-side in numpy
before the copy to the device (augment/wave_np.py, a copy of the JAX
package's, one ``np.random.RandomState`` giving the same draws). TF-domain
augs (SpecAugment, Crop, FreqShift, TrackMixDevice) and RotationDevice are
torch ops on the task's device, each a ``draw`` from a ``torch.Generator``
and a deterministic ``apply`` (augment/tf_device.py,
augment/rotate_device.py).

AugMix orchestration (batch triplication, clean copy 0, independent random
chains on copies 1/2) lives in train/module.py mirroring reference
src/models/components/model_module.py:83-121.
"""

from .wave_np import Rotation, TrackMix, WavMix
from .tf_device import Crop, FreqShift, SpecAugment, TrackMixDevice
from .rotate_device import RotationDevice

__all__ = ["Rotation", "WavMix", "TrackMix", "SpecAugment", "Crop", "FreqShift",
           "TrackMixDevice", "RotationDevice"]
