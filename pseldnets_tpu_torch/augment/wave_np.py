"""Waveform-domain augmentations (host-side numpy): the port's own copy of
the JAX package's augment/wave_np.py, so that one ``np.random.RandomState``
gives the same draws, in the same order, and the same batches bit for bit
in both. Line for line but for the waveform work, done clip by clip in
place (Rotation, ``_mix_rows``): the same float32 products, without the
batch-sized temporaries that cost ~1 s a step of 96 ten-second clips.

Parity: reference src/augment/rotate.py:6-101 (FOA channel/label rotation,
48-way or 16-way), wavmix.py:7-116 (ov1 + ov1/ov2 time-domain mixing with
ADPIT slot surgery), trackmix.py:6-75 (ov1+ov1 mixup into 2-track labels).
"""

import numpy as np

_TRANS48 = {
    (0, 1, 2): (1, 2, 3),
    (0, 2, 1): (2, 1, 3),
    (1, 0, 2): (3, 2, 1),
    (1, 2, 0): (2, 3, 1),
    (2, 0, 1): (3, 1, 2),
    (2, 1, 0): (1, 3, 2),
}
_TRANS16 = {(0, 1, 2): (1, 2, 3), (1, 0, 2): (3, 2, 1)}


class Rotation:
    def __init__(self, p, rotation_type=48, rng=None):
        self.p = p
        self.trans = _TRANS48 if int(rotation_type) == 48 else _TRANS16
        self.rng = rng or np.random

    def __call__(self, batch_x, batch_target):
        """Per-sample draws stay in a loop (RNG-sequence compatible); the
        array work is applied batched — the per-sample numpy version was a
        train-step bottleneck on few-core hosts."""
        N = batch_x.shape[0]
        perms = list(self.trans.keys())
        sel, perm_rows, sign_rows = [], [], []
        for n in range(N):
            if self.rng.uniform() >= self.p:
                continue
            perm_rows.append(perms[self.rng.randint(len(perms))])
            sign_rows.append(self.rng.choice([-1, 1], size=3))
            sel.append(n)
        if not sel:
            return batch_x, batch_target
        sel = np.asarray(sel)
        perm_arr = np.asarray(perm_rows)            # (M, 3): xx, yy, zz
        signs = np.asarray(sign_rows, np.float32)   # (M, 3): sx, sy, sz
        src = np.asarray([self.trans[tuple(p)] for p in perm_rows])  # (M, 3)

        # clip by clip in place, whole channel rows (the JAX copy's
        # take_along_axis builds broadcast index arrays: ~1 s for 96
        # ten-second clips); the same float32 products, so the same bits
        buf = np.empty((3,) + batch_x.shape[2:], batch_x.dtype)
        for j, n in enumerate(sel):
            buf[...] = batch_x[n, 1:]  # the Y, Z, X sources; W stays
            for c, col in ((1, 1), (2, 2), (3, 0)):
                np.multiply(buf[src[j, c - 1] - 1], signs[j, col], out=batch_x[n, c])

        if "accdoa_label" in batch_target:
            key = "accdoa_label"
            T, C3 = batch_target[key].shape[1:]
            doa = batch_target[key][sel].reshape(len(sel), T, 3, C3 // 3)
            doa = np.swapaxes(doa, 2, 3)  # (M, T, K, 3)
        elif "doa_label" in batch_target:
            key = "doa_label"
            doa = batch_target[key][sel]  # (M, T, tracks, 3)
        else:
            key = "adpit_label"
            seddoa = np.swapaxes(batch_target[key][sel], -1, -2)  # (M,T,6,K,4)
            doa = seddoa[..., 1:]

        gather = np.take_along_axis(
            doa, perm_arr.reshape((len(sel),) + (1,) * (doa.ndim - 2) + (3,)),
            axis=-1)
        y = gather * signs.reshape((len(sel),) + (1,) * (doa.ndim - 2) + (3,))
        if key == "accdoa_label":
            batch_target[key][sel] = np.swapaxes(y, 2, 3).reshape(len(sel), T, -1)
        elif key == "adpit_label":
            out = np.concatenate([seddoa[..., :1], y], axis=-1)
            batch_target[key][sel] = np.swapaxes(out, -1, -2)
        else:
            batch_target[key][sel] = y
        return batch_x, batch_target


def _mix_rows(batch_x, tgt, src, lams):
    """batch_x[tgt] = lams * batch_x[tgt] + (1 - lams) * batch_x[src], every
    source read before any row is written: the JAX copy's one expression
    clip by clip, the same float32 products and sums, without its
    batch-sized temporaries."""
    rest = 1 - lams
    out = np.empty((len(tgt),) + batch_x.shape[1:], batch_x.dtype)
    tmp = np.empty(batch_x.shape[1:], batch_x.dtype)
    for j, (t, s) in enumerate(zip(tgt, src)):
        np.multiply(lams[j], batch_x[t], out=out[j])
        np.multiply(rest[j], batch_x[s], out=tmp)
        np.add(out[j], tmp, out=out[j])
    batch_x[tgt] = out


def _beta(rng, alpha, size):
    return rng.beta(alpha, alpha, size=size).astype(np.float32)


class TrackMix:
    def __init__(self, alpha=0.5, rng=None):
        self.alpha = alpha
        self.rng = rng or np.random

    def __call__(self, batch_x, batch_target):
        ov = batch_target["ov"]
        idx_ov1 = [n for n in range(len(ov)) if ov[n] == "1"]
        new_idx = self.rng.permutation(idx_ov1)
        N = len(idx_ov1)
        if N == 0:
            return batch_x, batch_target
        label_keys = [k for k in batch_target if "label" in k]
        lams = _beta(self.rng, self.alpha, (N,))
        _mix_rows(batch_x, idx_ov1, new_idx, lams)

        if len(label_keys) == 2:
            sed, doa = batch_target["sed_label"], batch_target["doa_label"]
            l_sed = lams.reshape((N,) + (1,) * (sed.ndim - 2))
            sed[idx_ov1] = np.stack((
                l_sed * sed[idx_ov1][:, :, 0],
                (1 - l_sed) * sed[new_idx][:, :, 0],
                np.zeros_like(sed[idx_ov1][:, :, 0])), axis=2)
            doa[idx_ov1] = np.stack((
                doa[idx_ov1][:, :, 0], doa[new_idx][:, :, 0],
                np.zeros_like(doa[idx_ov1][:, :, 0])), axis=2)
        elif label_keys[0] == "accdoa_label":
            lab = batch_target["accdoa_label"]
            l_y = lams.reshape((N,) + (1,) * (lab.ndim - 1))
            lab[idx_ov1] = l_y * lab[idx_ov1] + (1 - l_y) * lab[new_idx]
        else:  # adpit
            lab = batch_target["adpit_label"]
            l_y = lams.reshape((N,) + (1,) * (lab.ndim - 1))
            a = lab[idx_ov1]
            bnew = lab[new_idx]
            assert a[:, :, 1:].sum() == 0, "trackmix inputs must be single-source"
            new = np.zeros_like(a)
            new[:, :, :, 0] = l_y[:, 0] * a[:, :, :, 0] + (1 - l_y[:, 0]) * bnew[:, :, :, 0]
            new[:, :, :, 1:] = a[:, :, :, 1:] + bnew[:, :, :, 1:]
            B_i, T_i, C_i = np.nonzero(a[:, :, 0, 0] * bnew[:, :, 0, 0])
            lam_b = lams[B_i]
            new[B_i, T_i] = 0.0
            new[B_i, T_i, 1, 0, C_i] = lam_b * a[B_i, T_i, 0, 0, C_i]
            new[B_i, T_i, 1, 1:, C_i] = a[B_i, T_i, 0, 1:, C_i]
            new[B_i, T_i, 2, 0, C_i] = (1 - lam_b) * bnew[B_i, T_i, 0, 0, C_i]
            new[B_i, T_i, 2, 1:, C_i] = bnew[B_i, T_i, 0, 1:, C_i]
            lab[idx_ov1] = new
        ov_arr = np.array(batch_target["ov"])
        ov_arr[idx_ov1] = "2"
        batch_target["ov"] = list(ov_arr)
        return batch_x, batch_target


class WavMix:
    def __init__(self, alpha=0.5, p=0.5, rng=None):
        self.alpha = alpha
        self.p = p
        self.rng = rng or np.random

    def __call__(self, batch_x, batch_target):
        if self.rng.random() > self.p:
            return batch_x, batch_target
        ov = np.array(batch_target["ov"])
        idx_ov1 = [n for n in range(len(ov)) if ov[n] == "1"]
        idx_ov2 = [n for n in range(len(ov)) if ov[n] == "2"]
        add_ov = "1" if self.rng.random() < 0.5 else "2"
        pool = idx_ov1 if add_ov == "1" else idx_ov2
        new_idx = self.rng.permutation(pool)
        N = min(len(idx_ov1), len(new_idx))
        if N == 0:
            return batch_x, batch_target
        tgt_idx = idx_ov1[:N]
        src_idx = new_idx[:N]
        label_keys = [k for k in batch_target if "label" in k]
        lams = _beta(self.rng, self.alpha, (N,))
        _mix_rows(batch_x, tgt_idx, src_idx, lams)

        if len(label_keys) == 2:
            sed, doa = batch_target["sed_label"], batch_target["doa_label"]
            l_sed = lams.reshape((N,) + (1,) * (sed.ndim - 2))
            sed[tgt_idx] = np.stack((
                l_sed * sed[tgt_idx][:, :, 0],
                (1 - l_sed) * sed[src_idx][:, :, 0],
                (1 - l_sed) * sed[src_idx][:, :, 1]), axis=2)
            doa[tgt_idx] = np.stack((
                doa[tgt_idx][:, :, 0], doa[src_idx][:, :, 0],
                doa[src_idx][:, :, 1]), axis=2)
        elif label_keys[0] == "accdoa_label":
            lab = batch_target["accdoa_label"]
            l_y = lams.reshape((N,) + (1,) * (lab.ndim - 1))
            lab[tgt_idx] = l_y * lab[tgt_idx] + (1 - l_y) * lab[src_idx]
        else:  # adpit slot surgery (reference wavmix.py:76-110)
            lab = batch_target["adpit_label"]
            l_y = lams.reshape((N,) + (1,) * (lab.ndim - 1))
            a = lab[tgt_idx]
            b = lab[src_idx]
            assert a[:, :, 1:].sum() == 0, "wavmix targets must be single-source"
            new = np.zeros_like(a)
            new[:, :, :, 0] = l_y[:, 0] * a[:, :, :, 0] + (1 - l_y[:, 0]) * b[:, :, :, 0]
            new[:, :, :, 1:] = a[:, :, :, 1:] + b[:, :, :, 1:]
            if add_ov == "1":
                assert b[:, :, 1:].sum() == 0
                B_i, T_i, C_i = np.nonzero(a[:, :, 0, 0] * b[:, :, 0, 0])
                lam_b = lams[B_i]
                new[B_i, T_i] = 0.0
                new[B_i, T_i, 1, 0, C_i] = lam_b * a[B_i, T_i, 0, 0, C_i]
                new[B_i, T_i, 1, 1:, C_i] = a[B_i, T_i, 0, 1:, C_i]
                new[B_i, T_i, 2, 0, C_i] = (1 - lam_b) * b[B_i, T_i, 0, 0, C_i]
                new[B_i, T_i, 2, 1:, C_i] = b[B_i, T_i, 0, 1:, C_i]
            else:
                assert b[:, :, 3:].sum() == 0
                # two same-class sources -> b slots
                B_i, T_i, C_i = np.nonzero(a[:, :, 0, 0] * b[:, :, 0, 0])
                lam_b = lams[B_i]
                new[B_i, T_i, :, :, C_i] = 0.0
                new[B_i, T_i, 1, 0, C_i] = lam_b * a[B_i, T_i, 0, 0, C_i]
                new[B_i, T_i, 2, 0, C_i] = (1 - lam_b) * b[B_i, T_i, 0, 0, C_i]
                new[B_i, T_i, 1, 1:, C_i] = a[B_i, T_i, 0, 1:, C_i]
                new[B_i, T_i, 2, 1:, C_i] = b[B_i, T_i, 0, 1:, C_i]
                # three same-class sources -> c slots
                B_i, T_i, C_i = np.nonzero(a[:, :, 0, 0] * b[:, :, 1, 0])
                lam_b = lams[B_i]
                new[B_i, T_i, :, :, C_i] = 0.0
                new[B_i, T_i, 3, 0, C_i] = lam_b * a[B_i, T_i, 0, 0, C_i]
                new[B_i, T_i, 3, 1:, C_i] = a[B_i, T_i, 0, 1:, C_i]
                new[B_i, T_i, 4, 0, C_i] = (1 - lam_b) * b[B_i, T_i, 1, 0, C_i]
                new[B_i, T_i, 4, 1:, C_i] = b[B_i, T_i, 1, 1:, C_i]
                new[B_i, T_i, 5, 0, C_i] = (1 - lam_b) * b[B_i, T_i, 2, 0, C_i]
                new[B_i, T_i, 5, 1:, C_i] = b[B_i, T_i, 2, 1:, C_i]
            lab[tgt_idx] = new
        ov[tgt_idx] = [str(int(n) + 1) for n in ov[src_idx]]
        batch_target["ov"] = list(ov)
        return batch_x, batch_target
