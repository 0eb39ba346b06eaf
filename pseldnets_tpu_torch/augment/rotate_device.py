"""Device-side FOA rotation of the waveforms and their labels: the JAX
package's augment/rotate_device.py (``RotationDevice`` :27), as torch ops,
split as augment/tf_device.py splits its augmentations: ``draw(generator,
shape)`` gives the raw draws (a uniform per clip, applied where below p;
the table row, a randint; three sign bernoullis, +1 where true) and
``apply(x, targets, draws)`` is deterministic.

Same transform family as augment.wave_np.Rotation (reference
src/augment/rotate.py): per-sample random channel permutation + sign flips of
the (Y, Z, X) waveform channels with the matching DOA label rotation, run
on the device before the frontend. Used only when wavmix is not in the
chain (the reference applies rotate BEFORE wavmix on the host; SELDTask
keeps the host Rotation otherwise). Under data parallelism ``draw`` draws
for the global batch and keeps this rank's clips (``parallel.batch_rows``).
"""

from typing import Dict

import numpy as np
import torch

from ..parallel import batch_rows

# (xx, yy, zz) label permutation -> (s_x, s_y, s_z) source waveform channels
_TRANS48 = {
    (0, 1, 2): (1, 2, 3), (0, 2, 1): (2, 1, 3), (1, 0, 2): (3, 2, 1),
    (1, 2, 0): (2, 3, 1), (2, 0, 1): (3, 1, 2), (2, 1, 0): (1, 3, 2),
}
_TRANS16 = {(0, 1, 2): (1, 2, 3), (1, 0, 2): (3, 2, 1)}


class RotationDevice:
    def __init__(self, p: float, rotation_type: int = 48, **_):
        self.p = float(p)
        trans = _TRANS48 if int(rotation_type) == 48 else _TRANS16
        self.perm_table = np.asarray(list(trans.keys()), np.int64)    # (P, 3) xx, yy, zz
        self.src_table = np.asarray(list(trans.values()), np.int64)   # (P, 3) s_x, s_y, s_z

    def draw(self, generator, shape) -> Dict[str, torch.Tensor]:
        B = shape[0]
        dev = generator.device
        P = len(self.perm_table)
        return {"apply": batch_rows(lambda n: torch.rand((n,), generator=generator, device=dev),
                                    B),
                "index": batch_rows(lambda n: torch.randint(0, P, (n,), generator=generator,
                                                            device=dev), B),
                "signs": batch_rows(lambda n: torch.rand((n, 3), generator=generator,
                                                         device=dev), B) < 0.5}

    def apply(self, batch_x: torch.Tensor, batch_target: Dict, draws: Dict):
        B = batch_x.shape[0]
        dev = batch_x.device
        apply = draws["apply"] < self.p
        pidx = draws["index"].to(torch.int64)
        signs = torch.where(draws["signs"], 1.0, -1.0).to(batch_x.dtype)
        perm = torch.as_tensor(self.perm_table, device=dev)[pidx]  # (B, 3)
        src = torch.as_tensor(self.src_table, device=dev)[pidx]    # (B, 3)

        def ch(j):
            idx = src[:, j][:, None, None].expand(B, 1, batch_x.shape[-1])
            return torch.gather(batch_x, 1, idx)[:, 0]

        rotated = torch.stack((batch_x[:, 0], signs[:, 1:2] * ch(0), signs[:, 2:3] * ch(1),
                               signs[:, 0:1] * ch(2)), dim=1)
        batch_x = torch.where(apply[:, None, None], rotated, batch_x)

        def rot_doa(doa):
            """doa: (B, ..., 3) -> rotated, gated by ``apply``."""
            extra = doa.dim() - 2
            idx = perm.reshape((B,) + (1,) * extra + (3,)).expand(doa.shape)
            y = torch.gather(doa, -1, idx) * signs.reshape((B,) + (1,) * extra + (3,))
            gate = apply.reshape((B,) + (1,) * (doa.dim() - 1))
            return torch.where(gate, y, doa)

        new_target = dict(batch_target)
        if "accdoa_label" in batch_target:
            lab = batch_target["accdoa_label"]
            B_, T, C3 = lab.shape
            doa = lab.reshape(B_, T, 3, C3 // 3).transpose(2, 3)
            new_target["accdoa_label"] = rot_doa(doa).transpose(2, 3).reshape(B_, T, C3)
        elif "doa_label" in batch_target:
            new_target["doa_label"] = rot_doa(batch_target["doa_label"])
        elif "adpit_label" in batch_target:
            seddoa = batch_target["adpit_label"].transpose(-1, -2)  # (B, T, 6, K, 4)
            doa = rot_doa(seddoa[..., 1:])
            out = torch.cat([seddoa[..., :1], doa], dim=-1)
            new_target["adpit_label"] = out.transpose(-1, -2)
        return batch_x, new_target
