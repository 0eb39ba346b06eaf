"""The port's AdapterBit path against the JAX package on the CPU: the eager
block with bottleneck adapters against the flax block, the plain versions of
K4 and K5 against the Pallas swin_block_adapt_vjp kernels in interpret mode
(tests/test_swin_adapt_vjp.py's size), AdapterBit serving from the waveform,
the frozen-backbone training step with clipping, the config gate and the
weight bridge. Every adapter leaf is filled with seeded random values: a
zero adapter fc2 would hide wiring bugs."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pseldnets_tpu.config import compose as jax_compose
from pseldnets_tpu.models import heads as jax_heads
from pseldnets_tpu.models.adapters import AdaptConfig as JaxAdaptConfig
from pseldnets_tpu.models.htsat import SwinTransformerBlock as JaxBlock
from pseldnets_tpu.ops.pallas.swin_block_adapt_vjp import _bwd_call, swin_block_train_adapt
from pseldnets_tpu.serving import htsat_fused_forward_from_wav as jax_from_wav
from pseldnets_tpu.train.module import SELDTask as JaxTask
from pseldnets_tpu_torch.config import compose
from pseldnets_tpu_torch.models import build_model, heads
from pseldnets_tpu_torch.models.adapters import AdaptConfig, Adapter, kernel_refusal
from pseldnets_tpu_torch.models.htsat import SwinTransformerBlock
from pseldnets_tpu_torch.ops import swin_block, swin_block_adapt
from pseldnets_tpu_torch.serving import htsat_fused_forward_from_wav, prepare_blocks
from pseldnets_tpu_torch.train.checkpoint import jax_to_torch_state_dict, load_jax_variables
from pseldnets_tpu_torch.train.module import DatasetSpec, SELDTask
import torch_threads  # noqa: F401  (each xdist worker's share of the cores)
from test_torch_htsat import ENC, FE
from test_torch_swin_block import randomize
from test_torch_swin_vjp import PARAM_NAMES, _masks
from test_torch_train import ROOT, TINY_TASK, _adpit_labels, _jax_masks, _JaxSpec

H = W = 16
C, NH, WIN = 32, 4, 8
SCALE = 0.1
BOTH = ("MlpAdapter", "SpatialAdapter")
ADAPTER_NAMES = {"attn": ("attn.adapter.fc1.weight", "attn.adapter.fc1.bias",
                          "attn.adapter.fc2.weight", "attn.adapter.fc2.bias"),
                 "mlp": ("mlp.adapter.fc1.weight", "mlp.adapter.fc1.bias",
                         "mlp.adapter.fc2.weight", "mlp.adapter.fc2.bias")}


def _adapt_cfg(positions, scalar=SCALE):
    return {"method": "adapter",
            "adapt_kwargs": {"position": list(positions), "type": "adapter", "mlp_ratio": 0.5,
                             "adapter_scalar": scalar, "act_layer": "gelu"}}


def _block_pair(rng, shift, positions=BOTH, B=3):
    cfg = _adapt_cfg(positions)
    blk = JaxBlock(dim=C, input_resolution=(H, W), num_heads=NH, window_size=WIN,
                   shift_size=shift, adapt=JaxAdaptConfig(cfg))
    x = rng.standard_normal((B, H * W, C)).astype(np.float32)
    params = randomize(blk.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"], rng)
    tblk = SwinTransformerBlock(C, (H, W), NH, WIN, shift_size=shift, adapt=AdaptConfig(cfg))
    load_jax_variables(tblk, {"params": params})
    return blk, params, tblk.eval(), x


def _names(tblk):
    return PARAM_NAMES + sum((ADAPTER_NAMES[w] for w in swin_block_adapt.block_adapters(tblk)), ())


def _rel(a, b):
    return float(np.abs(np.asarray(a) - np.asarray(b)).max() / np.abs(np.asarray(b)).max())


@pytest.mark.parametrize("shift,positions", [(0, BOTH), (4, BOTH), (4, ("MlpAdapter",))])
def test_eager_block_with_adapters_matches_flax(rng, shift, positions):
    """float32: the eager block with adapters against the flax block with the
    same weights: output < 2e-5, the grads of x and of every parameter (the
    adapters' included) < 2e-4 of each one's largest magnitude."""
    blk, params, tblk, x = _block_pair(rng, shift, positions)
    dout = rng.standard_normal(x.shape).astype(np.float32)
    ref = blk.apply({"params": params}, jnp.asarray(x))
    g_p, g_x = jax.grad(lambda p, xx: jnp.sum(blk.apply({"params": p}, xx) * dout),
                        argnums=(0, 1))(jax.tree_util.tree_map(jnp.asarray, params), jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    out = tblk(xt)
    assert np.abs(out.detach().numpy() - np.asarray(ref)).max() < 2e-5
    names = _names(tblk)
    mods = dict(tblk.named_parameters())
    got = torch.autograd.grad((out * torch.from_numpy(dout)).sum(), [xt] + [mods[n] for n in names])
    sd = jax_to_torch_state_dict({"params": jax.tree_util.tree_map(np.asarray, g_p)})
    assert _rel(got[0].numpy(), g_x) < 2e-4
    for n, g in zip(names, got[1:]):
        assert _rel(g.numpy(), sd[n].numpy()) < 2e-4, n
    assert ("attn.adapter.fc1.weight" in mods) == ("SpatialAdapter" in positions)


@pytest.mark.parametrize("shift,positions", [(0, BOTH), (4, BOTH), (4, ("MlpAdapter",)),
                                             (0, ("SpatialAdapter",))])
def test_plain_forward_matches_pallas_interpret(rng, shift, positions):
    """K4's plain version against the Pallas forward (interpret mode) with
    drop-path masks that drop branches: float32 < 5e-5; bf16 within 3e-2
    of the output's largest magnitude (the bf16 Pallas path's fast erf and
    its twice-rounded q, one-ulp flips)."""
    _, params, tblk, x = _block_pair(rng, shift, positions)
    masks = _masks(rng, x.shape[0])
    p32 = swin_block_adapt.prepare_adapt_block(tblk, torch.float32)
    assert p32.ch == C // 2 and p32.ch_pad == 32 and len(p32.where) == len(positions)
    ref = np.asarray(swin_block_train_adapt(jnp.asarray(x), params, jnp.asarray(masks), H, W,
                                            NH, WIN, shift, SCALE, jnp.float32, True))
    got = swin_block_adapt.swin_block_adapt_fused(torch.from_numpy(x), p32,
                                                  torch.from_numpy(masks)).numpy()
    assert np.abs(got - ref).max() < 5e-5, np.abs(got - ref).max()
    # the masks act, and the adapters do
    ones = swin_block_adapt.swin_block_adapt_plain(torch.from_numpy(x), p32).numpy()
    assert np.abs(got - ones).max() > 1e-2
    no_adapters = swin_block.swin_block_plain(torch.from_numpy(x), p32.base).numpy()
    assert np.abs(ones - no_adapters).max() > 1e-3
    ref16 = np.asarray(swin_block_train_adapt(jnp.asarray(x, jnp.bfloat16), params,
                                              jnp.asarray(masks), H, W, NH, WIN, shift, SCALE,
                                              jnp.bfloat16, True), np.float32)
    p16 = swin_block_adapt.prepare_adapt_block(tblk, torch.bfloat16)
    got16 = swin_block_adapt.swin_block_adapt_fused(torch.from_numpy(x).bfloat16(), p16,
                                                    torch.from_numpy(masks)).float().numpy()
    assert _rel(got16, ref16) < 3e-2


def _jax_bwd(x, params, masks, dout, shift, dtype):
    dx, tree = _bwd_call(jnp.asarray(x, dtype), params, jnp.asarray(masks),
                         jnp.asarray(dout, dtype), H=H, W=W, nh=NH, window=WIN, shift=shift,
                         scale=SCALE, compute_dtype=dtype, interpret=True)
    sd = jax_to_torch_state_dict({"params": jax.tree_util.tree_map(np.asarray, tree)})
    return np.asarray(dx, np.float32), {k: v.numpy() for k, v in sd.items()}


def _port_bwd(x, tblk, masks, dout, dtype):
    p = swin_block_adapt.prepare_adapt_block(tblk, dtype)
    dx, g = swin_block_adapt.swin_block_adapt_backward(
        torch.from_numpy(x).to(dtype), p, torch.from_numpy(masks), torch.from_numpy(dout).to(dtype))
    grads = swin_block_adapt.adapt_module_grads(tblk, g)
    return dx.float().numpy(), g, {n: v.numpy() for n, v in zip(_names(tblk), grads)}


@pytest.mark.parametrize("shift", [0, 4])
def test_plain_backward_matches_pallas_bwd_f32(rng, shift):
    """float32: dx and every grad, the eight adapter tensors included,
    within 2e-4 of each tensor's largest magnitude of the Pallas _bwd_call
    (interpret mode), masks with dropped branches."""
    _, params, tblk, x = _block_pair(rng, shift)
    masks = _masks(rng, x.shape[0])
    dout = rng.standard_normal(x.shape).astype(np.float32)
    ref_dx, ref = _jax_bwd(x, params, masks, dout, shift, jnp.float32)
    dx, _, got = _port_bwd(x, tblk, masks, dout, torch.float32)
    assert set(got) == set(ref) and len(got) == 21
    assert _rel(dx, ref_dx) <= 2e-4
    errs = {k: _rel(got[k], ref[k]) for k in ref}
    assert max(errs.values()) <= 2e-4, errs


def test_plain_backward_bf16_rounds_like_pallas_bwd(rng):
    """bf16: the plain backward rounds where _bwd_kernel rounds (y and the
    adapter chains in float32, g2s, g2m, df1s, df1m, dA, ...); what differs
    is the Pallas bf16 path's fast erf, its twice-rounded q and one-ulp
    flips of bf16 intermediates (2^-8 relative), which the adapter chains
    add more of than K3 has: measured up to 7.6e-3 of scale on the spatial
    adapter's fc1, as far as either bf16 backward lies from float32. Bound,
    as K3's test: 2^-5 of each tensor's largest magnitude, and, summed over
    the parameter grads, the port sits closer to the Pallas bf16 kernel
    than that kernel does to float32."""
    _, params, tblk, x = _block_pair(rng, 4)
    masks = _masks(rng, x.shape[0])
    dout = rng.standard_normal(x.shape).astype(np.float32)
    ref_dx, ref = _jax_bwd(x, params, masks, dout, 4, jnp.bfloat16)
    dx, _, got = _port_bwd(x, tblk, masks, dout, torch.bfloat16)
    x16 = torch.from_numpy(x).bfloat16().float().numpy()
    d16 = torch.from_numpy(dout).bfloat16().float().numpy()
    _, _, f32 = _port_bwd(x16, tblk, masks, d16, torch.float32)
    errs = {k: _rel(got[k], ref[k]) for k in ref}
    assert _rel(dx, ref_dx) <= 2 ** -5 and max(errs.values()) <= 2 ** -5, errs
    gap = {k: _rel(ref[k], f32[k]) for k in ref}
    assert sum(errs.values()) < sum(gap.values()), (errs, gap)


def test_one_adapter_backward_has_no_spurious_grads(rng):
    """An MlpAdapter-only block runs a zero-filled spatial slot: no attn
    adapter grads come back (kernel layout or module layout), and the rest
    match the Pallas backward, whose tree has no attn adapter either."""
    _, params, tblk, x = _block_pair(rng, 0, ("MlpAdapter",))
    masks = _masks(rng, x.shape[0])
    dout = rng.standard_normal(x.shape).astype(np.float32)
    ref_dx, ref = _jax_bwd(x, params, masks, dout, 0, jnp.float32)
    dx, g, got = _port_bwd(x, tblk, masks, dout, torch.float32)
    assert not any(k.startswith("sa") for k in g) and "ma1_w" in g
    assert set(got) == set(ref) and not any(k.startswith("attn.adapter") for k in got)
    assert max(_rel(got[k], ref[k]) for k in ref) <= 2e-4
    assert _rel(dx, ref_dx) <= 2e-4


def test_adapt_train_function_matches_autograd_and_skips_frozen(rng):
    """SwinBlockAdaptTrain (plain K4 forward, plain K5 backward) against
    torch.autograd through the eager block, float32, < 1e-5 of scale; a
    frozen parameter (requires_grad False) gets no grad."""
    _, _, tblk, x = _block_pair(rng, 4)
    masks = torch.from_numpy(_masks(rng, x.shape[0]))
    dout = torch.from_numpy(rng.standard_normal(x.shape).astype(np.float32))
    params = swin_block_adapt.adapt_block_parameters(tblk)
    xa = torch.from_numpy(x).requires_grad_(True)
    ref_g = torch.autograd.grad((tblk(xa, masks) * dout).sum(), [xa] + params)
    xb = torch.from_numpy(x).requires_grad_(True)
    out = swin_block_adapt.swin_block_adapt_train(xb, tblk, masks, torch.float32)
    got_g = torch.autograd.grad((out * dout).sum(), [xb] + params)
    for a, b in zip(ref_g, got_g):
        assert (a - b).abs().max() <= 1e-5 * a.abs().max()
    tblk.attn.qkv.weight.requires_grad_(False)
    out = swin_block_adapt.swin_block_adapt_train(xb, tblk, masks, torch.float32)
    out.backward(dout)
    assert tblk.attn.qkv.weight.grad is None and tblk.attn.adapter.fc1.weight.grad is not None
    assert swin_block_adapt.FWD_KERNEL._lib is None and swin_block_adapt.BWD_KERNEL._lib is None


def test_adapter_wrappers_count_launches_only_on_cuda(rng):
    """K4's and K5's wrappers take the plain versions for CPU tensors only:
    no launch counted, nothing built; any other device is refused."""
    _, _, tblk, x = _block_pair(rng, 4, B=2)
    p = swin_block_adapt.prepare_adapt_block(tblk, torch.float32)
    xt, m = torch.from_numpy(x), torch.from_numpy(_masks(rng, 2))
    fwd, bwd = swin_block_adapt.FWD_KERNEL, swin_block_adapt.BWD_KERNEL
    fwd.launches = bwd.launches = 0
    swin_block_adapt.swin_block_adapt_fused(xt, p, m)
    swin_block_adapt.swin_block_adapt_backward(xt, p, m, xt)
    assert fwd.launches == bwd.launches == 0 and fwd._lib is None and bwd._lib is None
    with pytest.raises(ValueError, match="expected a CUDA tensor"):
        swin_block_adapt.swin_block_adapt_fused(xt.to("meta"), p, m.to("meta"))
    with pytest.raises(ValueError, match="expected a CUDA tensor"):
        swin_block_adapt.swin_block_adapt_backward(xt.to("meta"), p, m.to("meta"), xt.to("meta"))
    assert fwd.launches == bwd.launches == 0


def _serving_models(rng):
    cfg = _adapt_cfg(BOTH)
    jm = jax_heads.HTSAT(num_classes=5, in_channels=7, mel_bins=16, num_tracks=3,
                         tgt_output_frames=24, adapt=JaxAdaptConfig(cfg),
                         encoder_kwargs=tuple(ENC.items()) + (("drop_path_rate", 0.0),))
    v = jm.init({"params": jax.random.PRNGKey(0)}, jnp.zeros((2, 7, 241, 16)), train=False)
    variables = {"params": randomize(v["params"], rng),
                 "batch_stats": {"scalar": {"bn": {
                     "running_mean": (rng.standard_normal((7, 16)) * 0.5).astype(np.float32),
                     "running_var": (rng.random((7, 16)) + 0.5).astype(np.float32)}}}}
    tm = heads.HTSAT(num_classes=5, in_channels=7, mel_bins=16, num_tracks=3,
                     tgt_output_frames=24, encoder_kwargs=ENC, adapt=AdaptConfig(cfg))
    load_jax_variables(tm, variables)
    return jm, variables, tm.eval()


def test_adapter_serving_from_wav_matches_jax(rng):
    """AdapterBit serving from the waveform, float32, plain versions on the
    CPU, against the JAX from-wav path (adapter eval kernel in interpret
    mode, unfolded merges, split3=False): < 5e-5. Every block runs K4's
    plain version (no K2 plan, no merge fold); the eager model agrees."""
    jm, variables, tm = _serving_models(rng)
    blocks = prepare_blocks(tm.encoder, torch.float32)
    assert all(isinstance(p, swin_block_adapt.AdaptBlockParams) for p in blocks)
    wav = (rng.standard_normal((2, 4, 57600)) * 0.1).astype(np.float32)
    swin_block.KERNEL.launches = swin_block_adapt.FWD_KERNEL.launches = 0
    got = htsat_fused_forward_from_wav(tm, wav, compute_dtype=torch.float32, device="cpu",
                                       n_mels=16, patch_embed="einsum")["multi_accdoa"].numpy()
    assert swin_block.KERNEL.launches == swin_block_adapt.FWD_KERNEL.launches == 0
    ref = np.asarray(jax_from_wav(jm, variables, jnp.asarray(wav), compute_dtype=jnp.float32,
                                  interpret=True, split3=False, patch_embed="einsum",
                                  **FE)["multi_accdoa"])
    assert got.shape == ref.shape == (2, 24, 45)
    assert np.abs(got - ref).max() < 5e-5, np.abs(got - ref).max()
    bf = htsat_fused_forward_from_wav(tm, wav, device="cpu", n_mels=16,
                                      patch_embed="einsum")["multi_accdoa"].numpy()
    assert np.abs(bf - got).max() < 5e-2


def _task_pair(rng, extra, seed_batch=1):
    """A JAX SELDTask and a port SELDTask with the same AdapterBit weights
    (adapter leaves random), one batch of 2 clips."""
    cfg_j = jax_compose(str(ROOT / "configs"), "train", TINY_TASK + ["adapt=adapter"] + extra)
    task_j = JaxTask(cfg_j, _JaxSpec(), steps_per_epoch=2, num_devices=1)
    state = task_j.init_state(jax.random.PRNGKey(0))
    params = randomize(jax.tree_util.tree_map(np.asarray, state.params), rng)
    state = state.replace(params=jax.tree_util.tree_map(jnp.asarray, params))
    variables = {"params": params,
                 "batch_stats": jax.tree_util.tree_map(np.asarray, state.batch_stats)}
    cfg = compose(str(ROOT / "configs"), "train", TINY_TASK + ["adapt=adapter"] + extra)
    task = SELDTask(cfg, DatasetSpec(num_classes=3), steps_per_epoch=2, device="cpu")
    task.init_state(0)
    load_jax_variables(task.model, variables)
    wav = (rng.standard_normal((2, 4, 64000)) * 0.1).astype(np.float32)
    lab = _adpit_labels(rng, 2, 40, 3)
    return task_j, state, task, wav, lab


def _frozen_and_trained(task, before, ref):
    got = task.model.state_dict()
    trained = set(task.trained_names)
    frozen = set(dict(task.model.named_parameters())) - trained
    for name, r in ref.items():
        if name in frozen:
            assert torch.equal(got[name], before[name]), name
            assert torch.equal(got[name], r), name
    return got, trained


def test_adapter_training_step_matches_jax(rng, monkeypatch):
    """One AdapterBit SELDTask step (tiny config, drop-path 0.1, clip 1e-3 so
    that clipping engages) on the fused forward with K4/K5's plain versions
    against the JAX fused step (its adapter kernels in interpret mode), the
    JAX drop-path masks injected: loss < 1e-5; every trained parameter
    (biases, adapters, head) within AdamW's sign-flip band of the JAX one;
    every frozen parameter bit-identical to before, as in the JAX step."""
    import pseldnets_tpu.train.fused_forward as jff

    orig = jff.swin_block_train_adapt
    monkeypatch.setattr(jff, "swin_block_train_adapt",
                        lambda *a: orig(*a[:-1], True))  # interpret mode on the CPU
    extra = ["model.kwargs.drop_path_rate=0.1", "trainer.fused_forward=true",
             "trainer.gradient_clip_val=0.001"]
    task_j, state, task, wav, lab = _task_pair(rng, extra)
    assert task.fused_forward and task_j.fused_forward
    key = jax.random.PRNGKey(1)
    masks = [torch.from_numpy(np.array(m))
             for m in _jax_masks(jax.random.fold_in(key, 1), 2, 0.1, 2)]
    assert not all(torch.equal(m, torch.ones_like(m)) for m in masks)
    new_state, losses_j, _ = task_j.train_step(state, {"data": wav, "adpit_label": lab}, key)
    before = {k: v.clone() for k, v in task.model.state_dict().items()}
    losses = task.train_step(wav, {"adpit_label": lab}, dp_masks=masks)
    assert abs(float(losses["loss_all"]) - float(losses_j["loss_all"])) < 1e-5
    ref = jax_to_torch_state_dict(jax.tree_util.tree_map(
        np.asarray, {"params": new_state.params, "batch_stats": new_state.batch_stats}))
    got, trained = _frozen_and_trained(task, before, ref)
    assert any("adapter" in n for n in trained) and "encoder.layers.0.blocks.0.attn.qkv.weight" \
        not in trained
    lr = 1e-4
    for name in trained:
        assert float((got[name] - ref[name]).abs().max()) <= 2.01 * lr, name
        assert not torch.equal(got[name], before[name]), name


def test_freeze_policy_clip_matches_jax_two_steps(rng):
    """The freeze policy with clipping engaged: two SGD steps (clip 1e-3)
    against the JAX flax step, whose stop_gradient keeps the frozen
    backbone's grads out of the clip's global norm. Each trained parameter
    lies within 1e-3 of its move (+ 1e-8) of the JAX one: they share the
    clip scale (measured: 6e-5 of the move); frozen ones stay unchanged.
    Computing grads for the frozen parameters and clipping over all of them
    moves the trained ones by another scale (measured: 24% of the move)."""
    extra = ["trainer.fused_forward=false", "trainer.gradient_clip_val=0.001",
             "model.optimizer.method=SGD", "model.optimizer.kwargs.lr=1.0"]
    task_j, state, task, wav, lab = _task_pair(rng, extra)
    assert not task_j.fused_forward
    before = {k: v.clone() for k, v in task.model.state_dict().items()}
    for step in range(2):
        state, _, _ = task_j.train_step(state, {"data": wav, "adpit_label": lab},
                                        jax.random.PRNGKey(step))
        task.train_step(wav, {"adpit_label": lab})
    ref = jax_to_torch_state_dict(jax.tree_util.tree_map(
        np.asarray, {"params": state.params, "batch_stats": state.batch_stats}))
    got, trained = _frozen_and_trained(task, before, ref)
    for name in trained:
        moved = float((ref[name] - before[name]).abs().max())
        err = float((got[name] - ref[name]).abs().max())
        assert err <= 1e-3 * moved + 1e-8, (name, err, moved)


def test_layer_norm_with_frozen_scale_trains_its_shift(rng):
    """AdapterBit freezes LayerNorm scales and trains their shifts: the
    port's LayerNorm (module and function) then applies the affine outside
    the fused LayerNorm (PyTorch's CUDA backward returns no shift grad in
    that case) with the same output and shift grad as nn.LayerNorm."""
    from pseldnets_tpu_torch.models.common import LayerNorm, layer_norm

    x = torch.from_numpy(rng.standard_normal((4, 32)).astype(np.float32))
    g = torch.from_numpy(rng.standard_normal((4, 32)).astype(np.float32))
    ref = torch.nn.LayerNorm(32)
    ln = LayerNorm(32)
    with torch.no_grad():
        for m in (ref, ln):
            m.weight.copy_(torch.linspace(0.5, 1.5, 32))
            m.bias.copy_(torch.linspace(-1, 1, 32))
    ln.weight.requires_grad_(False)
    out_ref, out = ref(x), ln(x)
    (gb_ref,) = torch.autograd.grad((out_ref * g).sum(), [ref.bias])
    (gb,) = torch.autograd.grad((out * g).sum(), [ln.bias])
    (gb_fn,) = torch.autograd.grad((layer_norm(x, ln) * g).sum(), [ln.bias])
    assert torch.allclose(out, out_ref, atol=1e-6) and torch.allclose(gb, gb_ref, atol=1e-6)
    assert torch.allclose(gb_fn, gb_ref, atol=1e-6)


def _refusal(cfg, adapters=True):
    """``kernel_refusal`` of a tiny block built with adapt config ``cfg``."""
    return kernel_refusal(SwinTransformerBlock(C, (H, W), NH, WIN, adapt=AdaptConfig(cfg)),
                          adapters)


def test_kernels_support_coerces_the_scalar():
    """adapter_scalar as a numeric string (a command-line override) or a
    bool builds the constant float(value) the JAX Adapter takes, and the
    kernels run such a block (``kernel_refusal`` is None); the JAX
    AdaptConfig's kernels_support sends a numeric string to its eager
    modules and a bool to its kernels, the same arithmetic either way. The
    learnable keyword, new_adapter, a non-gelu activation and LoRA build the
    JAX forms (the learnable scale a parameter of ones; None raises
    TypeError in both) and run on the eager modules, where the JAX
    AdaptConfig's kernels_support sends them too; a route that takes no
    adapter (K11's stages, the EINV2 forward) refuses any adapter."""
    ok = AdaptConfig(_adapt_cfg(BOTH, "0.1"))
    assert ok.adapter_args() == {"mlp_ratio": 0.5, "adapter_scalar": 0.1, "act_layer": "gelu"}
    assert _refusal(_adapt_cfg(BOTH, "0.1")) is None
    assert not JaxAdaptConfig(_adapt_cfg(BOTH, "0.1")).kernels_support()
    assert "adapters" in _refusal(_adapt_cfg(BOTH, "0.1"), adapters=False)
    assert AdaptConfig(_adapt_cfg(BOTH, 1)).adapter_args()["adapter_scalar"] == 1.0
    assert _refusal(None) is None and _refusal(None, adapters=False) is None
    assert not AdaptConfig(None).mlp_adapter
    assert Adapter(8, **AdaptConfig(_adapt_cfg(BOTH, True)).adapter_args()).scale == 1.0
    assert _refusal(_adapt_cfg(BOTH, True)) is None
    assert JaxAdaptConfig(_adapt_cfg(BOTH, True)).kernels_support()
    learnable_cfg = _adapt_cfg(BOTH, "learnable_scalar")
    assert "learnable" in _refusal(learnable_cfg)
    assert not JaxAdaptConfig(learnable_cfg).kernels_support()
    learnable = Adapter(8, **AdaptConfig(learnable_cfg).adapter_args())
    assert learnable.scale is None
    assert torch.equal(learnable.weight, torch.ones(1)) and learnable.weight.requires_grad
    with pytest.raises(TypeError):
        AdaptConfig(_adapt_cfg(BOTH, None)).adapter_args()
    with pytest.raises(TypeError):
        float(JaxAdaptConfig(_adapt_cfg(BOTH, None)).adapter_args()["adapter_scalar"])
    for kw, why in (({"act_layer": "relu"}, "non-gelu"),
                    ({"new_adapter": {"mlp_ratio": 0.25}}, "new_adapter")):
        cfg = _adapt_cfg(BOTH)
        cfg["adapt_kwargs"].update(kw)
        assert why in _refusal(cfg)
        assert not JaxAdaptConfig(cfg).kernels_support()
    assert AdaptConfig(cfg).ds_adapter_args() == {"mlp_ratio": 0.25, "adapter_scalar": 1.0,
                                                  "act_layer": "gelu"}
    lora_cfg = {"method": "lora", "linear_kwargs": {"r": 16, "lora_alpha": 1}}
    lora = AdaptConfig(lora_cfg)
    assert "LoRA" in _refusal(lora_cfg) and not JaxAdaptConfig(lora_cfg).kernels_support()
    assert lora.lora_linear_args() == {"lora_r": 16, "lora_alpha": 1.0}
    assert lora.lora_conv_args() == {"lora_r": 0, "lora_alpha": 1.0}
    assert AdaptConfig(None).lora_linear_args() == {"lora_r": 0}


def test_adapterbit_model_builds_with_zero_adapters():
    """compose(configs, train, adapt=adapter) builds the full-width model:
    both adapters in all 12 blocks, hidden C/2 (48 at stage 0), fc2 zero
    after the seeded init (the flax zeros init); 12 K4 plans, no merge fold."""
    cfg = compose(str(ROOT / "configs"), "train",
                  ["loss=multi_accdoa", "model.kwargs.pretrained_path=null", "adapt=adapter"])
    model, _ = build_model(cfg, 13, device="cpu")
    ads = [m for m in model.modules() if isinstance(m, Adapter)]
    assert len(ads) == 24 and {a.scale for a in ads} == {0.1}
    assert ads[0].fc1.out_features == 48 and ads[-1].fc1.out_features == 384
    assert all(not a.fc2.weight.any() and not a.fc2.bias.any() for a in ads)
    assert all(a.fc1.weight.any() for a in ads)
    blocks = prepare_blocks(model.encoder, torch.bfloat16)
    assert len(blocks) == 12 and all(isinstance(p, swin_block_adapt.AdaptBlockParams)
                                     for p in blocks)
    assert blocks[0].ch_pad == 64 and blocks[0].ch == 48


def test_bridge_carries_adapter_keys():
    """attn/adapter/fc{1,2} and mlp/adapter/fc{1,2} land on
    attn.adapter.fc{1,2} and mlp.adapter.fc{1,2}, (out, in) transposed, and
    the bridge stays strict both ways on an adapter model."""
    cfg = _adapt_cfg(BOTH)
    jm = jax_heads.HTSAT(num_classes=5, in_channels=7, mel_bins=16, num_tracks=3,
                         tgt_output_frames=24, adapt=JaxAdaptConfig(cfg),
                         encoder_kwargs=tuple(ENC.items()))
    v = jm.init({"params": jax.random.PRNGKey(0)}, jnp.zeros((1, 7, 241, 16)), train=False)
    variables = jax.tree_util.tree_map(np.asarray, {"params": v["params"],
                                                    "batch_stats": v["batch_stats"]})
    tm = heads.HTSAT(num_classes=5, mel_bins=16, num_tracks=3, tgt_output_frames=24,
                     encoder_kwargs=ENC, adapt=AdaptConfig(cfg))
    sd = jax_to_torch_state_dict(variables, tm)
    assert set(sd) == set(tm.state_dict())
    blk = variables["params"]["encoder"]["layers_1"]["blocks_0"]
    pre = "encoder.layers.1.blocks.0."
    for where in ("attn", "mlp"):
        for fc in ("fc1", "fc2"):
            k = blk[where]["adapter"][fc]["kernel"]
            np.testing.assert_array_equal(sd[f"{pre}{where}.adapter.{fc}.weight"].numpy(), k.T)
            np.testing.assert_array_equal(sd[f"{pre}{where}.adapter.{fc}.bias"].numpy(),
                                          blk[where]["adapter"][fc]["bias"])
    assert sd[f"{pre}mlp.adapter.fc1.weight"].shape == (16, 32)
    plain = heads.HTSAT(num_classes=5, mel_bins=16, num_tracks=3, tgt_output_frames=24,
                        encoder_kwargs=ENC)
    with pytest.raises(KeyError, match="adapter"):
        jax_to_torch_state_dict(variables, plain)
    short = {"params": dict(variables["params"])}
    short["params"]["encoder"] = dict(short["params"]["encoder"])
    short["params"]["encoder"]["layers_0"] = {
        k: v for k, v in variables["params"]["encoder"]["layers_0"].items() if k != "blocks_1"}
    with pytest.raises(KeyError, match="blocks.1"):
        jax_to_torch_state_dict(dict(short, batch_stats=variables["batch_stats"]), tm)


# AdapterBit's trained grads of a block (train/optim.py::trainable_mask)
_TRAINED = ("ln1_b", "qkv_b", "proj_b", "ln2_b", "fc1_b", "fc2_b", "sa1_w", "sa1_b", "sa2_w",
            "sa2_b", "ma1_w", "ma1_b", "ma2_w", "ma2_b")


@pytest.mark.parametrize("positions,want", [(BOTH, _TRAINED), (("MlpAdapter",), _TRAINED),
                                            (BOTH, ("qkv_w", "bias", "sa2_w", "ma1_b"))])
def test_masked_plain_backward_returns_exactly_the_wanted_grads(rng, positions, want):
    """K5's plain version asked for some grads returns those of the block's
    present adapters and K3's set only, each with the full form's bits, and
    the full form's dx."""
    _, _, tblk, x = _block_pair(rng, 4, positions)
    p = swin_block_adapt.prepare_adapt_block(tblk, torch.float32)
    xt, m = torch.from_numpy(x), torch.from_numpy(_masks(rng, x.shape[0]))
    dout = torch.from_numpy(rng.standard_normal(x.shape).astype(np.float32))
    dx, g = swin_block_adapt.swin_block_adapt_backward_plain(xt, p, m, dout)
    dxm, gm = swin_block_adapt.swin_block_adapt_backward_plain(xt, p, m, dout, want)
    assert set(gm) == set(want) & set(g)
    assert torch.equal(dxm, dx) and all(torch.equal(gm[k], g[k]) for k in gm)


def test_adapt_train_asks_only_for_what_autograd_wants(rng, monkeypatch):
    """Under AdapterBit's freeze (train/optim.py::trainable_mask on the
    block's names), SwinBlockAdaptTrain's backward asks K5 for the biases
    and adapters only, and their grads equal the full backward's."""
    from pseldnets_tpu_torch.train.optim import trainable_mask

    _, _, tblk, x = _block_pair(rng, 4)
    masks = torch.from_numpy(_masks(rng, x.shape[0]))
    dout = torch.from_numpy(rng.standard_normal(x.shape).astype(np.float32))
    asked = []
    plain = swin_block_adapt.swin_block_adapt_backward_plain

    def record(*args):
        asked.append(args[4])
        return plain(*args)

    monkeypatch.setattr(swin_block_adapt, "swin_block_adapt_backward_plain", record)
    params = swin_block_adapt.adapt_block_parameters(tblk)
    xb = torch.from_numpy(x).requires_grad_(True)
    full = torch.autograd.grad((swin_block_adapt.swin_block_adapt_train(
        xb, tblk, masks, torch.float32, use_kernels=False) * dout).sum(), [xb] + params)
    names = [n for n, _ in tblk.named_parameters()]
    for (n, prm), trains in zip(tblk.named_parameters(), trainable_mask(names, "adapter")):
        prm.requires_grad_(trains)
    out = swin_block_adapt.swin_block_adapt_train(xb, tblk, masks, torch.float32,
                                                  use_kernels=False)
    (out * dout).sum().backward()
    assert set(asked[-1]) == set(_TRAINED)
    for prm, ref in zip(params, full[1:]):
        if prm.requires_grad:
            assert torch.equal(prm.grad, ref)
        else:
            assert prm.grad is None
