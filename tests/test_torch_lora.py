"""LoRA, the eager-only AdapterBit settings (a learnable adapter scalar, a
non-gelu activation, the second bottleneck ``new_adapter``) and HTSAT's
drop rates in the port against the JAX package on the CPU at tiny sizes:
the LoRA layers, the eval forward of a LoRA and of an eager-only AdapterBit
HTSAT, one eager SELDTask step of each setting against the JAX step (the
JAX draws recorded with test_torch_passt.recorded_jax_draws and injected),
and their routes: they train and evaluate on the eager modules, and the
kernels' paths refuse them. Every leaf is filled with seeded random values:
a zero ``lora_B`` or adapter fc2 would hide the term."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pseldnets_tpu.config import compose as jax_compose
from pseldnets_tpu.models import adapters as jax_adapters
from pseldnets_tpu.models import heads as jax_heads
from pseldnets_tpu.train.module import SELDTask as JaxTask
from pseldnets_tpu.train.optim import trainable_mask as jax_trainable_mask
from pseldnets_tpu_torch.config import compose
from pseldnets_tpu_torch.models import heads
from pseldnets_tpu_torch.models.adapters import AdaptConfig, AdaptConv, AdaptDense, Adapter
from pseldnets_tpu_torch.ops.patch_embed import prepare_patch_embed
from pseldnets_tpu_torch.serving import htsat_fused_forward, prepare_blocks
from pseldnets_tpu_torch.train.checkpoint import jax_to_torch_state_dict, load_jax_variables
from pseldnets_tpu_torch.train.module import DatasetSpec, SELDTask
from pseldnets_tpu_torch.train.optim import trainable_mask
import torch_threads  # noqa: F401  (each xdist worker's share of the cores)
from test_torch_htsat import ENC
from test_torch_passt import recorded_jax_draws, take_block_mask
from test_torch_swin_block import randomize
from test_torch_train import ROOT, TINY_TASK, _adpit_labels, _JaxSpec

# configs/adapt/lora.yaml at ranks the tiny widths take
LORA = ["adapt=lora", "adapt.linear_kwargs.r=4", "adapt.linear_kwargs.lora_alpha=2",
        "adapt.conv_kwargs.r=3"]
EAGER_ADAPTER = ["adapt=adapter", "adapt.adapt_kwargs.adapter_scalar=learnable_scalar",
                 "adapt.adapt_kwargs.act_layer=relu",
                 "+adapt.adapt_kwargs.new_adapter.act_layer=tanh"]
DROP_RATES = ["model.kwargs.drop_rate=0.1", "model.kwargs.attn_drop_rate=0.1"]
SETTINGS = {"lora": LORA, "adapter_eager": EAGER_ADAPTER, "drop_rates": DROP_RATES}


def test_lora_layers_match_flax(rng):
    """AdaptDense (with and without bias) and AdaptConv (stride 2, padding
    1, the JAX (kh, kw, Cin, r) then 1 x 1 parametrisation) against the JAX
    layers, every leaf random, weights through the bridge: < 1e-5."""
    x = rng.standard_normal((3, 5, 6)).astype(np.float32)
    for bias in (True, False):
        jl = jax_adapters.AdaptDense(7, use_bias=bias, lora_r=3, lora_alpha=2.0)
        params = randomize(jl.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"], rng)
        tl = AdaptDense(6, 7, bias=bias, lora_r=3, lora_alpha=2.0)
        load_jax_variables(tl, {"params": params})
        assert tl.lora_A.shape == (3, 6) and tl.lora_B.shape == (7, 3)
        ref = np.asarray(jl.apply({"params": params}, jnp.asarray(x)))
        with torch.no_grad():
            got = tl(torch.from_numpy(x)).numpy()
        assert np.abs(got - ref).max() < 1e-5
    img = rng.standard_normal((2, 9, 10, 4)).astype(np.float32)  # NHWC
    jc = jax_adapters.AdaptConv(5, kernel_size=(3, 3), strides=(2, 2), padding=((1, 1), (1, 1)),
                                lora_r=2, lora_alpha=3.0)
    params = randomize(jc.init(jax.random.PRNGKey(1), jnp.asarray(img))["params"], rng)
    tc = AdaptConv(4, 5, (3, 3), (2, 2), (1, 1), lora_r=2, lora_alpha=3.0)
    load_jax_variables(tc, {"params": params})
    assert tc.lora_A.weight.shape == (2, 4, 3, 3) and tc.lora_B.weight.shape == (5, 2, 1, 1)
    ref = np.asarray(jc.apply({"params": params}, jnp.asarray(img))).transpose(0, 3, 1, 2)
    with torch.no_grad():
        got = tc(torch.from_numpy(img.transpose(0, 3, 1, 2).copy())).numpy()
    assert got.shape == ref.shape and np.abs(got - ref).max() < 1e-5


def _adapt(setting):
    """The ``adapt`` config entry that ``SETTINGS[setting]`` composes."""
    return compose(str(ROOT / "configs"), "train", SETTINGS[setting])["adapt"]


@pytest.mark.parametrize("setting", ["lora", "adapter_eager"])
def test_eval_forward_matches_flax(rng, setting):
    """The eager HTSAT (tiny, 241 frames, mACCDOA) with LoRA or the
    eager-only adapters in eval against flax model.apply(train=False),
    every leaf random (``lora_B``, the adapters' fc2 and learnable scales
    not at their init), float32: < 5e-5."""
    cfg = _adapt(setting)
    kw = dict(num_classes=5, in_channels=7, mel_bins=16, num_tracks=3, tgt_output_frames=24)
    jm = jax_heads.HTSAT(adapt=jax_adapters.AdaptConfig(cfg), **kw,
                         encoder_kwargs=tuple(ENC.items()) + (("drop_path_rate", 0.0),))
    v = jm.init({"params": jax.random.PRNGKey(0)}, jnp.zeros((2, 7, 241, 16)), train=False)
    variables = {"params": randomize(v["params"], rng),
                 "batch_stats": jax.tree_util.tree_map(np.asarray, v["batch_stats"])}
    tm = heads.HTSAT(adapt=AdaptConfig(cfg), encoder_kwargs=ENC, **kw)
    load_jax_variables(tm, variables)
    sd = tm.state_dict()
    if setting == "lora":
        assert sd["encoder.layers.0.blocks.0.attn.qkv.lora_B"].abs().min() > 0
        assert sd["encoder.patch_embed.proj.lora_B.weight"].shape == (16, 3, 1, 1)
    else:
        ads = [m for m in tm.modules() if isinstance(m, Adapter)]
        assert len(ads) == 12 and sum(a.scale is None for a in ads) == 8
        assert {a.act_layer for a in ads} == {"relu", "tanh"}
    x = (rng.standard_normal((2, 7, 241, 16)) * 0.5).astype(np.float32)
    ref = np.asarray(jm.apply(variables, jnp.asarray(x), train=False)["multi_accdoa"])
    with torch.no_grad():
        got = tm.eval()(torch.from_numpy(x))["multi_accdoa"].numpy()
    assert got.shape == ref.shape == (2, 24, 45)
    assert np.abs(got - ref).max() < 5e-5, np.abs(got - ref).max()


@pytest.mark.parametrize("setting", ["lora", "adapter_eager", "drop_rates"])
def test_seld_task_step_matches_jax(rng, setting):
    """One eager SELDTask.train_step of the tiny HTSAT task (B=2, float32)
    with LoRA, with the eager-only adapters (the freeze policy's frozen
    backbone) and with drop_rate = attn_drop_rate = 0.1,
    against the JAX SELDTask's step from the same weights (every leaf
    random) and batch; the JAX step's dropout draws recorded from an
    unjitted apply on its keys and injected: loss within 1e-5,
    every parameter within 2.01 lr of the JAX one (AdamW's sign-flip band),
    all but 0.5% of the elements within 1e-6, the frozen ones unchanged in
    both."""
    over = TINY_TASK + SETTINGS[setting]
    task_j = JaxTask(jax_compose(str(ROOT / "configs"), "train", over), _JaxSpec(),
                     steps_per_epoch=2, num_devices=1)
    state = task_j.init_state(jax.random.PRNGKey(0))
    params = randomize(jax.tree_util.tree_map(np.asarray, state.params), rng)
    state = state.replace(params=jax.tree_util.tree_map(jnp.asarray, params))
    variables = {"params": params,
                 "batch_stats": jax.tree_util.tree_map(np.asarray, state.batch_stats)}
    wav = (rng.standard_normal((2, 4, 64000)) * 0.1).astype(np.float32)
    lab = _adpit_labels(rng, 2, 40, 3)
    key = jax.random.PRNGKey(1)
    new_state, losses_j, _ = task_j.train_step(state, {"data": wav, "adpit_label": lab}, key)
    with recorded_jax_draws() as rec:
        task_j.model.apply(variables, jnp.zeros((2, 7, 201, 16)), train=True,
                           mutable=["batch_stats"],
                           rngs={"dropout": jax.random.fold_in(key, 1),
                                 "patchout": jax.random.fold_in(key, 2)})
    task = SELDTask(compose(str(ROOT / "configs"), "train", over), DatasetSpec(num_classes=3),
                    steps_per_epoch=2, device="cpu")
    assert not task.fused_forward and not task_j.fused_forward
    assert task.eval_route() == ("htsat" if setting == "drop_rates" else "eager")
    task.init_state(0)
    load_jax_variables(task.model, variables)
    drops = [torch.from_numpy(np.array(v)) for name, v in rec if name == "bernoulli"]
    uniforms = iter([(name, v) for name, v in rec if name == "uniform"])
    dp = [take_block_mask(uniforms, r, 2) for r in task.model.encoder.block_rates()]
    # pos_drop, then 4 sites a block; TINY_TASK's drop-path rate is 0
    assert len(drops) == (9 if setting == "drop_rates" else 0)
    assert all(not m.all() for m in drops) and all(m.all() for m in dp)
    before = {k: v.clone() for k, v in task.model.state_dict().items()}
    losses = task.train_step(wav, {"adpit_label": lab}, dp_masks=dp, dropout_draws=drops)
    assert abs(float(losses["loss_all"]) - float(losses_j["loss_all"])) < 1e-5
    ref = jax_to_torch_state_dict(jax.tree_util.tree_map(
        np.asarray, {"params": new_state.params, "batch_stats": new_state.batch_stats}))
    got = task.model.state_dict()
    assert set(ref) == set(got)
    trained = set(task.trained_names)
    frozen = set(dict(task.model.named_parameters())) - trained
    assert bool(frozen) == (setting == "adapter_eager")
    lr = float(task.cfg["model"]["optimizer"]["kwargs"]["lr"])
    n_far = n_all = 0
    for name, r in ref.items():
        d = (got[name] - r).abs()
        assert float(d.max()) <= 2.01 * lr, name
        if name in frozen:  # unchanged in both steps
            assert torch.equal(got[name], before[name]) and torch.equal(got[name], r), name
        n_far += int((d > 1e-6).sum())
        n_all += d.numel()
    assert n_far <= 0.005 * n_all, (n_far, n_all)


def test_settings_route_to_the_eager_modules():
    """LoRA, the eager-only adapters and a drop rate take the eager forward
    in training ("auto"), LoRA and the adapters in eval too, as the JAX
    package routes them;
    ``trainer.fused_forward=true`` raises ValueError in both packages; the
    kernels' preparations refuse a LoRA or eager-only block and a LoRA patch
    embed (K8 and the einsum embed have no LoRA term). ``method=lora`` trains
    every parameter ("adapter" is not in "lora"), as the JAX freeze policy
    does (optim.py:75-76), and AdapterBit freezes the same parameters in
    both."""
    for setting, over in SETTINGS.items():
        task = SELDTask(compose(str(ROOT / "configs"), "train", TINY_TASK + over),
                        DatasetSpec(num_classes=3), device="cpu")
        # eval ignores dropout: the drop rates leave the kernels' eval route
        route = "htsat" if setting == "drop_rates" else "eager"
        assert not task.fused_forward and task.eval_route() == route, setting
        forced = TINY_TASK + over + ["trainer.fused_forward=true"]
        with pytest.raises(ValueError, match="fused_forward=true"):
            SELDTask(compose(str(ROOT / "configs"), "train", forced), DatasetSpec(num_classes=3),
                     device="cpu")
        with pytest.raises(ValueError, match="fused_forward=true"):
            JaxTask(jax_compose(str(ROOT / "configs"), "train", forced), _JaxSpec(),
                    steps_per_epoch=2, num_devices=1)
        enc = task.model.encoder
        if setting == "drop_rates":
            prepare_blocks(enc, torch.float32)  # eval takes the kernels' path
            continue
        with pytest.raises(NotImplementedError, match="eager modules"):
            prepare_blocks(enc, torch.float32)
        with pytest.raises(NotImplementedError, match="eager"):
            htsat_fused_forward(task.model, torch.zeros(2, 7, 201, 16), use_kernels=False)
        if setting == "lora":
            with pytest.raises(NotImplementedError, match="LoRA"):
                prepare_patch_embed(enc, torch.float32)
        mask = trainable_mask(task.names, _adapt(setting)["method"])
        assert all(mask) if setting == "lora" else (any(mask) and not all(mask))
    # the JAX policy on a LoRA tree: every leaf trains
    tree = {"encoder": {"qkv": {"lora_A": 0, "lora_B": 0, "base": {"kernel": 0, "bias": 0}}}}
    assert all(jax.tree_util.tree_leaves(jax_trainable_mask(tree, "lora")))
