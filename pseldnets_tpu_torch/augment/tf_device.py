"""TF-domain augmentations as torch ops on the task's device: the JAX
package's augment/tf_device.py (SpecAugment :15, Crop :66, FreqShift :90,
TrackMixDevice :121), each split in two.

``draw(generator, shape)`` returns the raw random tensors for features of
``shape`` (N, C, T, F), drawn from ``generator`` on its device: the
uniforms before scaling, the bernoullis, the randints, the Beta weights and
TrackMix's ordering jitter, under the names ``apply`` reads. ``apply(x,
targets, draws)`` is deterministic and keeps the JAX arithmetic in float32
in the JAX order (``uniform * T``, then ``uniform * (T_dim - value)``,
truncation by ``.to(torch.int32)``, SpecAugment's raw-float frequency
bounds, FreqShift's pad in every ``jnp.pad`` mode, TrackMixDevice's argsort
pairing), so the JAX draws given to ``apply`` give the JAX outputs.

Under data parallelism every per-clip draw comes through
``parallel.batch_rows``: ``draw`` draws for the global batch (W times the
rank's N clips) and keeps this rank's rows, so the ranks' draws together
are one process's on the global batch. TrackMixDevice pairs the ov1 clips
within the rank's batch, as the reference's DDP does (each rank mixes its
own batch).

torch's Beta and Gamma samplers take no generator: ``beta`` draws
Beta(a, a) as X / (X + Y) of two Gamma(a) draws from the generator's normals
and uniforms (``gamma``), so every draw comes from the generator given.

Parity: reference src/augment/specaug.py:5-63 (time masks applied
consistently to features AND labels via the xy_ratio frames-per-label
scaling, iid freq masks), crop.py:3-32 (per-(sample,channel) random T x F
rectangles), freqshift.py:7-38 (random up/down mel shift with reflect
padding), trackmix.py (feature-domain, inside the TF chains).
"""

import math
from typing import Dict, Sequence

import torch
import torch.nn.functional as F

from ..parallel import batch_rows

# candidates a Gamma draw tries: Marsaglia-Tsang accepts each with
# probability above 0.95 at a >= 1, so all GAMMA_ROUNDS fail with
# probability below 0.05 ** 16 ~ 1.5e-21 (then the draw takes its mode d)
GAMMA_ROUNDS = 16


def gamma(generator: torch.Generator, alpha: float, shape: Sequence[int]) -> torch.Tensor:
    """Gamma(alpha, 1) float32 draws of ``shape`` from ``generator``'s
    normals and uniforms (Marsaglia and Tsang 2000, a fixed GAMMA_ROUNDS
    candidates a draw, the first accepted taken: no host synchronization);
    alpha < 1 through Gamma(alpha + 1) * U^(1 / alpha)."""
    dev = generator.device
    shape = tuple(shape)
    a = alpha + 1.0 if alpha < 1.0 else float(alpha)
    d = a - 1.0 / 3.0
    c = 1.0 / math.sqrt(9.0 * d)
    z = torch.randn((GAMMA_ROUNDS,) + shape, generator=generator, device=dev)
    u = torch.rand((GAMMA_ROUNDS,) + shape, generator=generator, device=dev)
    v = (1.0 + c * z) ** 3
    ok = (v > 0) & (torch.log(u) < 0.5 * z * z + d - d * v
                    + d * torch.log(v.clamp_min(1e-30)))
    first = ok.to(torch.int8).argmax(0, keepdim=True)
    x = d * torch.where(ok.any(0), torch.gather(v, 0, first)[0], torch.ones_like(v[0]))
    if alpha < 1.0:
        u1 = 1.0 - torch.rand(shape, generator=generator, device=dev)  # (0, 1]
        x = x * u1 ** (1.0 / alpha)
    return x


def beta(generator: torch.Generator, alpha: float, shape: Sequence[int]) -> torch.Tensor:
    """Beta(alpha, alpha) float32 draws of ``shape`` from ``generator``."""
    x = gamma(generator, alpha, shape)
    y = gamma(generator, alpha, shape)
    return x / (x + y)


def _uniform(generator, shape):
    return torch.rand(tuple(shape), generator=generator, device=generator.device)


def _clip_uniform(generator, shape, axis: int = 0):
    """Uniforms of ``shape`` whose ``axis`` is the batch's clips, this
    rank's rows of the global batch's (``parallel.batch_rows``)."""
    shape = tuple(shape)

    def draw(n):
        return _uniform(generator, shape[:axis] + (n,) + shape[axis + 1:])

    return batch_rows(draw, shape[axis], axis)


class SpecAugment:
    def __init__(self, xy_ratio, T=40, F=8, mT=4, mF=2, mask_value=0.0, **_):
        self.T = T
        self.F = F
        self.mT = mT
        self.mF = mF
        self.xy_ratio = int(xy_ratio)
        self.T_y = int(T / self.xy_ratio)
        self.mask_value = mask_value

    def draw(self, generator, shape) -> Dict[str, torch.Tensor]:
        """Time-mask lengths and starts (mT, N), then per freq mask i the
        lengths and starts (N, C), stacked (mF, N, C): uniforms in [0, 1)."""
        N, C = shape[:2]
        return {"t_value": _clip_uniform(generator, (self.mT, N), 1),
                "t_start": _clip_uniform(generator, (self.mT, N), 1),
                "f_value": _clip_uniform(generator, (self.mF, N, C), 1),
                "f_start": _clip_uniform(generator, (self.mF, N, C), 1)}

    def apply(self, batch_x: torch.Tensor, batch_target: Dict, draws: Dict):
        N, C, T_dim, F_dim = batch_x.shape
        T_y_dim = T_dim // self.xy_ratio
        dev = batch_x.device

        # time masks: shared between features and every *_label target
        value = draws["t_value"] * self.T_y
        min_value = draws["t_start"] * (T_y_dim - value)
        start = min_value.to(torch.int32)
        end = start + value.to(torch.int32)

        t_y = torch.arange(T_y_dim, device=dev)
        mask_y = ((t_y[None, None] >= start[..., None])
                  & (t_y[None, None] < end[..., None])).any(0)  # (N, T_y)
        new_target = dict(batch_target)
        for k, v in batch_target.items():
            if "label" not in k:
                continue
            m = mask_y.reshape(mask_y.shape + (1,) * (v.dim() - 2))
            new_target[k] = v.masked_fill(m, self.mask_value)

        t_x = torch.arange(T_dim, device=dev)
        mask_x = ((t_x[None, None] >= start[..., None] * self.xy_ratio)
                  & (t_x[None, None] < end[..., None] * self.xy_ratio)).any(0)
        batch_x = batch_x.masked_fill(mask_x[:, None, :, None], self.mask_value)

        # iid freq masks (torchaudio mask_along_axis_iid semantics: per (N, C)),
        # raw-float bounds as torchaudio compares them
        f = torch.arange(F_dim, device=dev)
        for i in range(self.mF):
            value = draws["f_value"][i] * self.F
            min_v = draws["f_start"][i] * (F_dim - value)
            m = (f[None, None] >= min_v[..., None]) & (f[None, None] < (min_v + value)[..., None])
            batch_x = batch_x.masked_fill(m[:, :, None, :], self.mask_value)
        return batch_x, new_target



class Crop:
    def __init__(self, T=8, F=4, mC=4, mask_value=0.0, **_):
        self.T = T
        self.F = F
        self.mC = mC
        self.mask_value = mask_value

    def draw(self, generator, shape) -> Dict[str, torch.Tensor]:
        """Rectangle lengths and starts in time and in frequency, (mC, N, C)
        uniforms each."""
        N, C = shape[:2]
        u = [_clip_uniform(generator, (self.mC, N, C), 1) for _ in range(4)]
        return dict(zip(("t_value", "t_start", "f_value", "f_start"), u))

    def apply(self, batch_x: torch.Tensor, batch_target: Dict, draws: Dict):
        N, C, T_dim, F_dim = batch_x.shape
        dev = batch_x.device
        value_t = draws["t_value"] * self.T
        min_t = draws["t_start"] * (T_dim - value_t)
        value_f = draws["f_value"] * self.F
        min_f = draws["f_start"] * (F_dim - value_f)
        st, et = min_t.to(torch.int32), min_t.to(torch.int32) + value_t.to(torch.int32)
        sf, ef = min_f.to(torch.int32), min_f.to(torch.int32) + value_f.to(torch.int32)
        t = torch.arange(T_dim, device=dev)
        f = torch.arange(F_dim, device=dev)
        mask = torch.zeros((N, C, T_dim, F_dim), dtype=torch.bool, device=dev)
        for i in range(self.mC):  # the union of the mC rectangles, one at a time
            in_t = (t >= st[i, :, :, None]) & (t < et[i, :, :, None])  # (N, C, T)
            in_f = (f >= sf[i, :, :, None]) & (f < ef[i, :, :, None])  # (N, C, F)
            mask |= in_t[..., :, None] & in_f[..., None, :]
        return batch_x.masked_fill(mask, self.mask_value), batch_target



# jnp.pad's modes (numpy's), which the JAX FreqShift passes on (tf_device.py:108)
PAD_MODES = ("constant", "edge", "reflect", "symmetric", "wrap", "linear_ramp", "maximum",
             "mean", "median", "minimum", "empty")


def pad_last(x: torch.Tensor, R: int, mode: str) -> torch.Tensor:
    """``x`` (N, C, T, F) padded by R on both ends of its last axis as ``jnp.pad`` pads
    it in ``mode`` with its defaults: ``constant`` with 0, ``edge``,
    ``reflect``, ``symmetric`` and ``wrap`` by index, ``linear_ramp`` from 0
    at the outer end towards the edge value (exclusive), the statistics
    (``maximum``, ``mean``, ``median`` (the mean of the two middle values of
    an even count), ``minimum``) of the whole axis, and ``empty`` as zeros
    (what ``jnp.pad`` gives on the CPU: its ``empty`` is ``zeros``)."""
    if mode == "reflect":
        return F.pad(x, (R, R, 0, 0), mode="reflect")
    if mode in ("constant", "empty"):
        return F.pad(x, (R, R))
    n = x.shape[-1]
    if mode in ("edge", "symmetric", "wrap"):
        i = torch.arange(-R, n + R, device=x.device)
        if mode == "edge":
            i = i.clamp(0, n - 1)
        elif mode == "wrap":
            i = i % n
        else:
            i = i % (2 * n)
            i = torch.where(i < n, i, 2 * n - 1 - i)
        return x.index_select(-1, i)
    if mode == "linear_ramp":
        step = torch.arange(R, device=x.device, dtype=x.dtype) / R  # 0, 1/R, ..., (R-1)/R
        left = x[..., :1] * step
        right = (x[..., -1:] * step).flip(-1)
        return torch.cat([left, x, right], dim=-1)
    if mode in ("maximum", "minimum", "mean"):
        stat = {"maximum": torch.amax, "minimum": torch.amin, "mean": torch.mean}[mode](
            x, dim=-1, keepdim=True)
    elif mode == "median":
        srt = x.sort(dim=-1).values
        stat = (srt[..., (n - 1) // 2:(n - 1) // 2 + 1] + srt[..., n // 2:n // 2 + 1]) / 2
    else:
        raise ValueError(f"FreqShift mode {mode!r}: jnp.pad takes {PAD_MODES}")
    side = stat.expand(*x.shape[:-1], R)
    return torch.cat([side, x, side], dim=-1)


class FreqShift:
    def __init__(self, p=0.5, shift_range=15, direction=None, mode="reflect", **_):
        self.p = p
        self.shift_range = shift_range
        self.direction = None if direction in (None, "None", "none") else direction
        if mode not in PAD_MODES:
            raise ValueError(f"FreqShift mode {mode!r}: jnp.pad takes {PAD_MODES}")
        self.mode = mode

    def _range(self, F_dim: int) -> int:
        return self.shift_range or int(F_dim * 0.08)

    def draw(self, generator, shape) -> Dict[str, torch.Tensor]:
        """Per clip: a uniform (apply where below p), the shift, a randint
        in [0, shift_range), and the direction, a bernoulli(0.5) draw (up
        where true), or the configured direction."""
        N, F_dim = shape[0], shape[-1]
        dev = generator.device
        apply = _clip_uniform(generator, (N,))
        shift = batch_rows(lambda n: torch.randint(0, max(self._range(F_dim), 1), (n,),
                                                   generator=generator, device=dev), N)
        if self.direction is None:
            up = _clip_uniform(generator, (N,)) < 0.5
        else:
            up = torch.full((N,), self.direction == "up", device=dev)
        return {"apply": apply, "shift": shift, "up": up}

    def apply(self, batch_x: torch.Tensor, batch_target: Dict, draws: Dict):
        N, C, T_dim, F_dim = batch_x.shape
        R = self._range(F_dim)
        apply = draws["apply"] < self.p
        shift = draws["shift"].to(torch.int64)
        pad = pad_last(batch_x, R, self.mode)
        f = torch.arange(F_dim, device=batch_x.device)
        # up: content moves up (pad left by s, keep first F) -> src = f - s + R
        # down: pad right by s, drop first s -> src = f + s + R
        src_up = f[None] - shift[:, None] + R
        src_dn = f[None] + shift[:, None] + R
        src = torch.where(draws["up"][:, None], src_up, src_dn)
        src = torch.where(apply[:, None], src, f[None] + R)
        shifted = torch.gather(pad, 3, src[:, None, None, :].expand(N, C, T_dim, F_dim))
        return shifted, batch_target



class TrackMixDevice:
    """Feature-domain TrackMix for the device TF chain (the JAX package's
    TrackMixDevice, tf_device.py:121-196): ov1 samples are mixed pairwise
    with Beta(a, a) weights and their labels move into 2-track form. The
    ov1 subset is selected with masks; the pairing is a cyclic shift over
    the ov1 samples in a random order (an argsort of the ov1 flag plus a
    1e-3 jitter)."""

    def __init__(self, alpha=0.5, **_):
        self.alpha = float(alpha)

    def draw(self, generator, shape) -> Dict[str, torch.Tensor]:
        """The ordering jitter, uniforms (B,), and the mixing weights,
        Beta(alpha, alpha) (B,)."""
        B = shape[0]
        return {"order": _clip_uniform(generator, (B,)),
                "lam": batch_rows(lambda n: beta(generator, self.alpha, (n,)), B)}

    def apply(self, batch_x: torch.Tensor, batch_target: Dict, draws: Dict,
              ov1_mask: torch.Tensor):
        B = batch_x.shape[0]
        dev = batch_x.device
        # random order with ov1 first; cyclic pairing within the ov1 prefix
        key = torch.where(ov1_mask, 0.0, 1.0).to(torch.float32) + draws["order"] * 1e-3
        order = torch.argsort(key, stable=True)
        m = ov1_mask.to(torch.int32).sum()
        pos = torch.argsort(order, stable=True)  # position of each sample in `order`
        nxt = torch.where(pos + 1 < m, pos + 1, torch.zeros((), dtype=pos.dtype, device=dev))
        partner = order[nxt]  # for ov1 samples: another ov1 sample
        lam = draws["lam"].to(batch_x.dtype)
        gate = ov1_mask  # only ov1 samples are mixed

        def mix(x, l):
            shape = (B,) + (1,) * (x.dim() - 1)
            lm = l.reshape(shape)
            g = gate.reshape(shape)
            return torch.where(g, lm * x + (1 - lm) * x[partner], x)

        batch_x = mix(batch_x, lam)
        new_target = dict(batch_target)
        if "sed_label" in batch_target:
            sed, doa = batch_target["sed_label"], batch_target["doa_label"]
            l_s = lam.reshape((B,) + (1,) * (sed.dim() - 2))
            g_s = gate.reshape((B,) + (1,) * (sed.dim() - 1))
            mixed_sed = torch.stack((l_s * sed[:, :, 0], (1 - l_s) * sed[partner][:, :, 0],
                                     torch.zeros_like(sed[:, :, 0])), dim=2)
            mixed_doa = torch.stack((doa[:, :, 0], doa[partner][:, :, 0],
                                     torch.zeros_like(doa[:, :, 0])), dim=2)
            new_target["sed_label"] = torch.where(g_s, mixed_sed, sed)
            new_target["doa_label"] = torch.where(
                gate.reshape((B,) + (1,) * (doa.dim() - 1)), mixed_doa, doa)
        elif "accdoa_label" in batch_target:
            new_target["accdoa_label"] = mix(batch_target["accdoa_label"], lam)
        elif "adpit_label" in batch_target:
            lab = batch_target["adpit_label"]  # (B, T, 6, 4, K)
            a = lab
            b = lab[partner]
            l_y = lam.reshape(B, 1, 1, 1, 1)
            base_act = l_y * a[:, :, :, 0:1] + (1 - l_y) * b[:, :, :, 0:1]
            base = torch.cat([base_act, a[:, :, :, 1:] + b[:, :, :, 1:]], dim=3)
            # same-class collision (ov1 inputs: at most one active class) ->
            # move to b0/b1 slots, zero the rest of the frame
            coll = (a[:, :, 0, 0] * b[:, :, 0, 0]).sum(-1) > 0  # (B, T)
            collf = coll[:, :, None, None, None]
            slot1 = torch.cat([l_y * a[:, :, 0:1, 0:1], a[:, :, 0:1, 1:]], dim=3)
            slot2 = torch.cat([(1 - l_y) * b[:, :, 0:1, 0:1], b[:, :, 0:1, 1:]], dim=3)
            zeros = torch.zeros_like(base[:, :, 0:1])
            coll_label = torch.cat([zeros, slot1, slot2, zeros, zeros, zeros], dim=2)
            mixed = torch.where(collf, coll_label, base)
            g = gate.reshape(B, 1, 1, 1, 1)
            new_target["adpit_label"] = torch.where(g, mixed, lab)
        return batch_x, new_target
