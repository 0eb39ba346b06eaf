"""The port's augmentation (pseldnets_tpu_torch/augment, the SELDTask
registry and step) against the JAX package on the CPU: the host augs bit
for bit from one ``np.random.RandomState``; each device aug's ``apply``
given the draws that the JAX function takes from its key (the JAX splits of
tf_device.py:28-55, :75-79, :100-104, :140-149 and rotate_device.py:37-40
recomputed here), masks exact and mixes within 1e-6; the TF chain;
``sample_aug_flags`` and ``prepare_batch``; one AugMix ``SELDTask`` step with
the JAX step's draws injected against one JAX step; the generator-only Beta
sampler."""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pseldnets_tpu import augment as jaug
from pseldnets_tpu.config import compose as jax_compose
from pseldnets_tpu.train.module import TF_AUG_ORDER as JAX_TF_AUG_ORDER
from pseldnets_tpu.train.module import SELDTask as JaxTask
from pseldnets_tpu_torch import augment as taug
from pseldnets_tpu_torch.augment.tf_device import beta
from pseldnets_tpu_torch.config import compose
from pseldnets_tpu_torch.train.checkpoint import jax_to_torch_state_dict, load_jax_variables
from pseldnets_tpu_torch.train.module import TF_AUG_ORDER, DatasetSpec, SELDTask
import torch_threads  # noqa: F401  (each xdist worker's share of the cores)
from test_torch_train import TINY_TASK, _JaxSpec

ROOT = Path(__file__).resolve().parents[1]
K = 3


# --- labels ------------------------------------------------------------------

def _doa(rng, shape):
    d = rng.standard_normal(shape + (3,)).astype(np.float32)
    return d / np.linalg.norm(d, axis=-1, keepdims=True)


def adpit_labels(rng, ov, T):
    """ADPIT labels (B, T, 6, 4, K) for the ``ov`` list: an ov1 clip one
    source on track A (random class, active 70%), an ov2 clip also a second
    source, on A where its class differs and on B0/B1 where it is the same
    (the wavmix surgery's input contract, wave_np.py:205, :219)."""
    B = len(ov)
    lab = np.zeros((B, T, 6, 4, K), np.float32)
    for b, o in enumerate(ov):
        for t in range(T):
            if rng.random() > 0.7:
                continue
            c1 = rng.integers(K)
            if o == "1":
                lab[b, t, 0, 0, c1] = 1.0
                lab[b, t, 0, 1:, c1] = _doa(rng, ())
                continue
            c2 = rng.integers(K)
            if c1 == c2:
                for s in (1, 2):
                    lab[b, t, s, 0, c1] = 1.0
                    lab[b, t, s, 1:, c1] = _doa(rng, ())
            else:
                for c in (c1, c2):
                    lab[b, t, 0, 0, c] = 1.0
                    lab[b, t, 0, 1:, c] = _doa(rng, ())
    return lab


def accdoa_labels(rng, B, T):
    act = (rng.random((B, T, 1, K)) < 0.5).astype(np.float32)
    return (np.swapaxes(_doa(rng, (B, T, K)), 2, 3) * act).reshape(B, T, 3 * K)


def seddoa_labels(rng, B, T):
    """EINV2 targets: one source on track 0 (sed (B, T, 3, K), doa (B, T, 3, 3))."""
    sed = np.zeros((B, T, 3, K), np.float32)
    act = rng.random((B, T)) < 0.7
    cls = rng.integers(0, K, (B, T))
    bi, ti = np.nonzero(act)
    sed[bi, ti, 0, cls[bi, ti]] = 1.0
    doa = np.zeros((B, T, 3, 3), np.float32)
    doa[:, :, 0] = _doa(rng, (B, T)) * act[..., None]
    return {"sed_label": sed, "doa_label": doa}


def labels_of(kind, rng, ov, T):
    if kind == "adpit":
        return {"adpit_label": adpit_labels(rng, ov, T)}
    if kind == "accdoa":
        return {"accdoa_label": accdoa_labels(rng, len(ov), T)}
    return seddoa_labels(rng, len(ov), T)


def _copy(t):
    return {k: (v.copy() if isinstance(v, np.ndarray) else list(v)) for k, v in t.items()}


def _same(a, b):
    assert a.keys() == b.keys()
    for k in a:
        if isinstance(a[k], np.ndarray):
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        else:
            assert list(a[k]) == list(b[k]), k


# --- host augs -----------------------------------------------------------------

OV = ["1", "2", "1", "1", "2", "1", "1", "1"]


@pytest.mark.parametrize("rotation_type", [48, 16])
@pytest.mark.parametrize("kind", ["adpit", "accdoa", "seddoa"])
def test_rotation_matches_jax(rotation_type, kind):
    rng = np.random.default_rng(rotation_type + len(kind))
    x = rng.standard_normal((8, 4, 300)).astype(np.float32)
    t = labels_of(kind, rng, OV, 10) | {"ov": list(OV)}
    xj, tj = jaug.Rotation(0.8, rotation_type, rng=np.random.RandomState(5))(x.copy(), _copy(t))
    xt, tt = taug.Rotation(0.8, rotation_type, rng=np.random.RandomState(5))(x.copy(), _copy(t))
    np.testing.assert_array_equal(xt, xj)
    _same(tt, tj)
    assert not np.array_equal(xt, x)


@pytest.mark.parametrize("seed", [0, 1, 2, 3, 4, 5])
@pytest.mark.parametrize("kind", ["adpit", "accdoa", "seddoa"])
def test_wavmix_matches_jax(seed, kind):
    """WavMix from one RandomState: whichever branch its draws take (skip,
    add an ov1 clip, add an ov2 clip), the same waveforms, labels and ov."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((8, 4, 300)).astype(np.float32)
    t = labels_of(kind, rng, OV, 10) | {"ov": list(OV)}
    xj, tj = jaug.WavMix(0.5, 0.7, rng=np.random.RandomState(seed))(x.copy(), _copy(t))
    xt, tt = taug.WavMix(0.5, 0.7, rng=np.random.RandomState(seed))(x.copy(), _copy(t))
    np.testing.assert_array_equal(xt, xj)
    _same(tt, tj)


@pytest.mark.parametrize("kind", ["adpit", "accdoa", "seddoa"])
def test_host_trackmix_matches_jax(kind):
    rng = np.random.default_rng(9)
    ov = ["1"] * 6 + ["2"] * 2
    x = rng.standard_normal((8, 4, 300)).astype(np.float32)
    t = labels_of(kind, rng, ov, 10) | {"ov": list(ov)}
    xj, tj = jaug.TrackMix(0.5, rng=np.random.RandomState(2))(x.copy(), _copy(t))
    xt, tt = taug.TrackMix(0.5, rng=np.random.RandomState(2))(x.copy(), _copy(t))
    np.testing.assert_array_equal(xt, xj)
    _same(tt, tj)
    assert tt["ov"].count("2") == 8


# --- the JAX draws of each device aug, from its key --------------------------

def jax_draws(name, aug, key, shape):
    """The raw random tensors that the JAX ``aug`` draws from ``key`` for
    features (or waveforms) of ``shape``, as numpy, under the port's names."""
    N = shape[0]
    u = jax.random.uniform
    if name == "specaug":
        C = shape[1]
        k_t1, k_t2, k_f = jax.random.split(key, 3)
        fv, fs = [], []
        for i in range(aug.mF):
            kf1, kf2, k_f = jax.random.split(jax.random.fold_in(k_f, i), 3)
            fv.append(u(kf1, (N, C)))
            fs.append(u(kf2, (N, C)))
        d = {"t_value": u(k_t1, (aug.mT, N)), "t_start": u(k_t2, (aug.mT, N)),
             "f_value": jnp.stack(fv), "f_start": jnp.stack(fs)}
    elif name == "crop":
        ks = jax.random.split(key, 4)
        d = {n: u(k, (aug.mC, N, shape[1]))
             for n, k in zip(("t_value", "t_start", "f_value", "f_start"), ks)}
    elif name == "freqshift":
        R = aug.shift_range or int(shape[-1] * 0.08)
        k1, k2, k3 = jax.random.split(key, 3)
        up = (jax.random.bernoulli(k3, 0.5, (N,)) if aug.direction is None
              else jnp.full((N,), aug.direction == "up"))
        d = {"apply": u(k1, (N,)), "shift": jax.random.randint(k2, (N,), 0, max(R, 1)), "up": up}
    elif name == "trackmix":
        k1, k2 = jax.random.split(key)
        d = {"order": u(k1, (N,)), "lam": jax.random.beta(k2, aug.alpha, aug.alpha, (N,))}
    elif name == "rotate":
        k1, k2, k3 = jax.random.split(key, 3)
        d = {"apply": u(k1, (N,)), "index": jax.random.randint(k2, (N,), 0, len(aug.perm_table)),
             "signs": jax.random.bernoulli(k3, 0.5, (N, 3))}
    return {k: torch.from_numpy(np.array(v)) for k, v in d.items()}


def _torch(t):
    return {k: torch.from_numpy(np.array(v)) for k, v in t.items() if "label" in k}


def _close(got, ref, tol, what):
    ref = np.asarray(ref)
    got = got.numpy()
    if tol == 0:
        np.testing.assert_array_equal(got, ref, err_msg=what)
    else:
        np.testing.assert_allclose(got, ref, rtol=0, atol=tol, err_msg=what)


FEAT_SHAPE = (6, 7, 201, 16)  # the tiny task's features: 4 s at hop 320, 16 mels


@pytest.mark.parametrize("name,kw", [
    ("specaug", {"xy_ratio": 5}), ("specaug", {"xy_ratio": 5, "T": 100, "F": 12, "mF": 3}),
    ("crop", {}), ("crop", {"T": 50, "F": 9, "mC": 2}),
    ("freqshift", {}), ("freqshift", {"p": 0.9, "direction": "up"}),
    ("freqshift", {"p": 0.9, "shift_range": 5, "direction": "down"}),
])
@pytest.mark.parametrize("kind", ["adpit", "seddoa"])
def test_tf_aug_apply_matches_jax(name, kw, kind):
    """SpecAugment, Crop and FreqShift: the port's ``apply`` on the JAX
    draws equals the JAX aug on its key, bit for bit (masks and reflect
    shifts), features and labels; the mask rate is not trivial."""
    cls = {"specaug": "SpecAugment", "crop": "Crop", "freqshift": "FreqShift"}[name]
    rng = np.random.default_rng(len(name) + len(kw))
    x = rng.standard_normal(FEAT_SHAPE).astype(np.float32)
    t = labels_of(kind, rng, ["1"] * FEAT_SHAPE[0], 40)
    ja, ta = getattr(jaug, cls)(**kw), getattr(taug, cls)(**kw)
    changed = []
    for seed in (17, 18, 19):
        key = jax.random.PRNGKey(seed)
        xj, tj = ja(key, jnp.asarray(x), {k: jnp.asarray(v) for k, v in t.items()})
        xt, tt = ta.apply(torch.from_numpy(x), _torch(t), jax_draws(name, ja, key, x.shape))
        _close(xt, xj, 0, "features")
        for k in t:
            _close(tt[k], tj[k], 0, k)
        changed.append(float((xt.numpy() != x).mean()))
    assert 0.0 < max(changed) and min(changed) < 1.0, changed


@pytest.mark.parametrize("kind", ["adpit", "accdoa", "seddoa"])
@pytest.mark.parametrize("ov1", ["all", "some", "none"])
def test_trackmix_device_apply_matches_jax(kind, ov1):
    """TrackMixDevice: the argsort pairing and the gate exactly, the mixed
    features and labels within 1e-6, given the JAX jitter and Beta draws;
    a same-class collision moves into the B slots (adpit)."""
    rng = np.random.default_rng(21)
    B = 6
    mask = {"all": [True] * B, "some": [True, False, True, True, False, True],
            "none": [False] * B}[ov1]
    x = rng.standard_normal((B, 7, 50, 16)).astype(np.float32)
    t = labels_of(kind, rng, ["1"] * B, 10)
    if kind == "adpit":  # clips 0 and 2 share a class on every frame
        t["adpit_label"][[0, 2]] = 0.0
        t["adpit_label"][[0, 2], :, 0, 0, 1] = 1.0
        t["adpit_label"][[0, 2], :, 0, 1:, 1] = 0.5
    ja, ta = jaug.TrackMixDevice(0.5), taug.TrackMixDevice(0.5)
    key = jax.random.PRNGKey(4)
    xj, tj = ja(key, jnp.asarray(x), {k: jnp.asarray(v) for k, v in t.items()},
                jnp.asarray(mask))
    xt, tt = ta.apply(torch.from_numpy(x), _torch(t), jax_draws("trackmix", ja, key, x.shape),
                      torch.tensor(mask))
    _close(xt, xj, 1e-6, "features")
    for k in t:
        _close(tt[k], tj[k], 1e-6, k)
    if ov1 == "none":
        np.testing.assert_array_equal(xt.numpy(), x)
    else:
        assert not np.array_equal(xt.numpy(), x)


@pytest.mark.parametrize("rotation_type", [48, 16])
@pytest.mark.parametrize("kind", ["adpit", "accdoa", "seddoa"])
def test_rotation_device_apply_matches_jax(rotation_type, kind):
    rng = np.random.default_rng(rotation_type)
    x = rng.standard_normal((8, 4, 300)).astype(np.float32)
    t = labels_of(kind, rng, ["1"] * 8, 10)
    ja, ta = jaug.RotationDevice(0.8, rotation_type), taug.RotationDevice(0.8, rotation_type)
    key = jax.random.PRNGKey(rotation_type)
    xj, tj = ja(key, jnp.asarray(x), {k: jnp.asarray(v) for k, v in t.items()})
    xt, tt = ta.apply(torch.from_numpy(x), _torch(t), jax_draws("rotate", ja, key, x.shape))
    _close(xt, xj, 0, "waveforms")
    for k in t:
        _close(tt[k], tj[k], 0, k)


def test_draws_have_the_jax_shapes_and_ranges():
    """Each port aug's ``draw`` gives the keys, shapes and dtypes that
    ``apply`` reads, in the JAX draws' ranges, from the generator alone."""
    g = torch.Generator().manual_seed(3)
    augs = {"specaug": taug.SpecAugment(5), "crop": taug.Crop(), "freqshift": taug.FreqShift(),
            "trackmix": taug.TrackMixDevice(0.5), "rotate": taug.RotationDevice(0.8)}
    jaxs = {"specaug": jaug.SpecAugment(5), "crop": jaug.Crop(), "freqshift": jaug.FreqShift(),
            "trackmix": jaug.TrackMixDevice(0.5), "rotate": jaug.RotationDevice(0.8)}
    before = torch.random.get_rng_state()
    for name, aug in augs.items():
        shape = (8, 4, 300) if name == "rotate" else FEAT_SHAPE
        d = aug.draw(g, shape)
        ref = jax_draws(name, jaxs[name], jax.random.PRNGKey(0), shape)
        assert d.keys() == ref.keys(), name
        for k in d:
            assert d[k].shape == ref[k].shape, (name, k)
            assert (d[k].dtype == torch.bool) == (ref[k].dtype == torch.bool), (name, k)
            if d[k].dtype.is_floating_point:
                assert 0.0 <= float(d[k].min()) and float(d[k].max()) <= 1.0, (name, k)
    assert torch.equal(torch.random.get_rng_state(), before), "a draw used the global RNG"


def test_beta_from_a_generator():
    """Beta(0.5, 0.5) from the generator's normals and uniforms: the same
    generator state gives the same draws, and 200k draws have the Beta's
    mean 1/2, variance 1/8 and arcsine CDF (within 1%)."""
    a = beta(torch.Generator().manual_seed(1), 0.5, (200_000,))
    b = beta(torch.Generator().manual_seed(1), 0.5, (200_000,))
    assert torch.equal(a, b) and a.dtype == torch.float32
    assert float(a.min()) >= 0.0 and float(a.max()) <= 1.0
    assert abs(float(a.mean()) - 0.5) < 0.005 and abs(float(a.var()) - 0.125) < 0.002
    for q in (0.05, 0.25, 0.5, 0.9):
        cdf = 2 / np.pi * np.arcsin(np.sqrt(q))
        assert abs(float((a <= q).float().mean()) - cdf) < 0.01, q
    g = beta(torch.Generator().manual_seed(2), 2.5, (100_000,))
    assert abs(float(g.mean()) - 0.5) < 0.005 and abs(float(g.var()) - 1 / 24) < 0.002


# --- the task: registry, flags, prepare_batch, the chain, one step ---------

def _tasks(over, fused=False):
    cfg_j = jax_compose(str(ROOT / "configs"), "train", TINY_TASK + over
                        + ["trainer.fused_forward=false"])
    task_j = JaxTask(cfg_j, _JaxSpec(), steps_per_epoch=2, num_devices=1)
    cfg = compose(str(ROOT / "configs"), "train",
                  TINY_TASK + over + [f"trainer.fused_forward={str(fused).lower()}"])
    task = SELDTask(cfg, DatasetSpec(num_classes=K), steps_per_epoch=2, device="cpu")
    return task_j, task


def _batch(rng, B, ov, kind="adpit"):
    return {"data": (rng.standard_normal((B, 4, 64000)) * 0.1).astype(np.float32),
            **labels_of(kind, rng, ov, 40), "ov": list(ov),
            "filename": [f"clip{i}" for i in range(B)]}


AUG_CASES = {"augmix": ["augment=augmix"],
             "augmix1_on_device": ["augment=augmix1", "+augment.rotate.on_device=true"],
             "augment": ["augment=augment"],
             "einv2_augmix": ["loss=einv2_pit_agg", "augment=augmix"]}


@pytest.mark.parametrize("case", list(AUG_CASES))
def test_registry_flags_and_prepare_batch_match_jax(case):
    """The registry (aug_type, AugMix, the TF combinations, device rotation)
    equals the JAX task's; three batches through ``prepare_batch`` in turn
    give the JAX host batches, labels, flags, ov1 masks and raw ov lists
    exactly (one RandomState drawn rotate -> wavmix -> flags)."""
    task_j, task = _tasks(AUG_CASES[case])
    assert TF_AUG_ORDER == JAX_TF_AUG_ORDER
    assert (task.aug_type, task.augmix, task.aug_tf_comb, task.rotate_on_device) == (
        task_j.aug_type, task_j.augmix, task_j.aug_tf_comb, task_j.rotate_on_device)
    rng = np.random.default_rng(31)
    for _ in range(3):
        batch = _batch(rng, 4, ["1", "2", "1", "1"])
        xj, lj, fj, mj, ovj = task_j.prepare_batch({k: (v.copy() if isinstance(v, np.ndarray)
                                                        else list(v)) for k, v in batch.items()})
        p = task.prepare_batch(batch)
        np.testing.assert_array_equal(p.x.numpy(), np.asarray(xj))
        assert p.targets.keys() == lj.keys()
        for k in lj:
            np.testing.assert_array_equal(p.targets[k].numpy(), np.asarray(lj[k]))
        np.testing.assert_array_equal(p.flags.numpy(), np.asarray(fj))
        np.testing.assert_array_equal(p.ov1_mask.numpy(), np.asarray(mj))
        assert p.ov == ovj == ["1", "2", "1", "1"]
    assert task._np_rng.randint(1 << 30) == task_j._np_rng.randint(1 << 30)


def test_tf_chain_matches_jax():
    """``_apply_tf_chain`` with every aug flagged, then with a subset, on
    the same features, labels and ov1 mask, the draws taken from the JAX
    chain's keys (one split per configured aug, TF_AUG_ORDER): masks
    exact, TrackMix's mixes within 1e-6."""
    task_j, task = _tasks(["augment=augmix"])
    rng = np.random.default_rng(41)
    feats = rng.standard_normal(FEAT_SHAPE).astype(np.float32)
    lab = adpit_labels(rng, ["1"] * 6, 40)
    ov1 = np.array([True, True, False, True, True, False])
    for flags in ([True] * 4, [False, True, False, True]):
        key = jax.random.PRNGKey(len(flags) + sum(flags))
        fj, tj = task_j._apply_tf_chain(key, jnp.asarray(feats), {"adpit_label": jnp.asarray(lab)},
                                        jnp.asarray(flags), jnp.asarray(ov1))
        draws = chain_draws(task_j, key, feats.shape)
        ft, tt = task._apply_tf_chain(torch.from_numpy(feats),
                                      {"adpit_label": torch.from_numpy(lab)},
                                      torch.tensor(flags), torch.from_numpy(ov1), draws)
        _close(ft, fj, 1e-6, "features")
        _close(tt["adpit_label"], tj["adpit_label"], 1e-6, "labels")
        assert not np.array_equal(ft.numpy(), feats)


def chain_draws(task_j, key, shape):
    """The draws of one JAX TF chain on ``key`` (module.py:230-241)."""
    out = {}
    for name in JAX_TF_AUG_ORDER:
        if name in task_j.aug_type:
            key, sub = jax.random.split(key)
            out[name] = jax_draws(name, task_j.tf_augs[name], sub, shape)
    return out


def step_draws(task_j, key, wav_shape, feat_shape):
    """The device draws of one JAX train step on ``key`` (module.py:250-274):
    device rotation first, then one chain each AugMix copy (or one)."""
    draws = {}
    if task_j.rotate_device is not None:
        key, sub = jax.random.split(key)
        draws["rotate"] = jax_draws("rotate", task_j.rotate_device, sub, wav_shape)
    if task_j.augmix:
        n = feat_shape[0] // 3
        k1, k2, key = jax.random.split(key, 3)
        draws["chains"] = [chain_draws(task_j, k, (n,) + tuple(feat_shape[1:]))
                           for k in (k1, k2)]
    else:
        key, sub = jax.random.split(key)
        draws["chains"] = [chain_draws(task_j, sub, feat_shape)]
    return draws


@pytest.mark.parametrize("case,fused", [("augmix", True), ("augmix1_on_device", False),
                                        ("augment", True), ("einv2_augmix", False)])
def test_augmented_step_matches_jax(case, fused):
    """One SELDTask.train_step with the shipped augmentation (AugMix with
    wavmix and trackmix; AugMix with the 16-way rotation on the device;
    the chain without AugMix; AugMix on the eager EINV2 HTSAT with its SED
    and DOA labels, the AGG loss) from the same weights, batch and seed, the
    JAX step's device draws injected, against one JAX step (flax forward):
    the loss within 1e-5, every parameter within AdamW's sign-flip band
    (test_seld_task_step_matches_jax), the ScalarBN statistics within 1e-5
    of their size, or 1e-6 of their largest (the masks' zeros among log-mels near -20 make a running
    variance near 10, where float32 steps by 1e-6; the two frontends'
    features differ by a few 1e-6)."""
    task_j, task = _tasks(AUG_CASES[case], fused)
    assert task.fused_forward is fused
    state = task_j.init_state(jax.random.PRNGKey(0))
    variables = jax.tree_util.tree_map(np.asarray, {"params": state.params,
                                                    "batch_stats": state.batch_stats})
    rng = np.random.default_rng(51)
    batch = _batch(rng, 2 if task.augmix else 6, ["1", "2"] if task.augmix
                   else ["1", "2", "1", "1", "2", "1"], "seddoa" if "einv2" in case else "adpit")
    key = jax.random.PRNGKey(1)
    new_state, losses_j, _ = task_j.train_step(
        state, {k: (v.copy() if isinstance(v, np.ndarray) else list(v)) for k, v in batch.items()},
        key)
    B = batch["data"].shape[0] * (3 if task.augmix else 1)
    draws = step_draws(task_j, key, (B, 4, 64000), (B, 7, 201, 16))

    task.init_state(0)
    load_jax_variables(task.model, variables)
    losses = task.train_step(batch["data"], {k: v for k, v in batch.items() if k != "data"},
                             aug_draws=draws)
    assert abs(float(losses["loss_all"]) - float(losses_j["loss_all"])) < 1e-5
    ref = jax_to_torch_state_dict(jax.tree_util.tree_map(
        np.asarray, {"params": new_state.params, "batch_stats": new_state.batch_stats}))
    got = task.model.state_dict()
    lr = 1e-4
    n_far = n_all = 0
    assert set(ref) == set(got)
    for k in losses_j:
        assert abs(float(losses[k]) - float(losses_j[k])) < 1e-5, k
    for name, r in ref.items():
        if name.startswith("scalar.running"):
            torch.testing.assert_close(got[name], r, rtol=1e-5, atol=1e-6 * float(r.abs().max()))
            continue
        d = (got[name] - r).abs()
        assert float(d.max()) <= 2.01 * lr, name
        n_far += int((d > 1e-6).sum())
        n_all += d.numel()
    assert n_far <= 0.005 * n_all, (n_far, n_all)


def test_step_draws_come_from_the_task_generator():
    """Without injected draws the chain draws from ``aug_generator``: two
    tasks from one seed give the same augmented features bit for bit, and a
    generator moved on gives others; the global RNG is not used."""
    _, a = _tasks(["augment=augmix"])
    _, b = _tasks(["augment=augmix"])
    rng = np.random.default_rng(61)
    batch = _batch(rng, 2, ["1", "1"])
    before = torch.random.get_rng_state()
    pa = a.prepare_batch(dict(batch))
    fa, ta = a.step_inputs(pa)
    fb, tb = b.step_inputs(b.prepare_batch(dict(batch)))
    assert torch.equal(torch.random.get_rng_state(), before)
    assert fa.shape == (6, 7, 201, 16) and torch.equal(fa, fb)
    assert torch.equal(ta["adpit_label"], tb["adpit_label"])
    b._np_rng.seed(2024)
    fc, _ = b.step_inputs(b.prepare_batch(dict(batch)))
    assert not torch.equal(fa, fc)
    assert torch.equal(fa[:2], a.extractor(pa.x[:2]))  # the clean third: no TF aug
