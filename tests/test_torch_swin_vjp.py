"""The port's training Swin block against the JAX package, at that package's
own test size (tests/test_swin_vjp.py:16-17): K2's plain version with
drop-path masks against the Pallas swin_block_fused(dp_masks) in interpret
mode, the plain version of K3 against the Pallas _bwd_call in interpret mode
(float32 and bf16), and SwinBlockTrain's gradients against torch.autograd of
the eager block. Weights are moved across by the bridge."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pseldnets_tpu.ops.pallas.swin_block import swin_block_fused as jax_block_fused
from pseldnets_tpu.ops.pallas.swin_block_vjp import _bwd_call
from pseldnets_tpu_torch.ops import swin_block, swin_block_vjp
from pseldnets_tpu_torch.train.checkpoint import jax_to_torch_state_dict
import torch_threads  # noqa: F401  (each xdist worker's share of the cores)
from test_torch_swin_block import H, NH, W, WIN, _block_pair

PARAM_NAMES = ("norm1.weight", "norm1.bias", "attn.qkv.weight", "attn.qkv.bias",
               "attn.proj.weight", "attn.proj.bias", "norm2.weight", "norm2.bias",
               "mlp.fc1.weight", "mlp.fc1.bias", "mlp.fc2.weight", "mlp.fc2.bias",
               "attn.relative_position_bias_table")


def _masks(rng, B):
    """Drop-path scales with dropped branches: 0 or 1/keep per image."""
    keep = 0.9
    m = (rng.random((B, 2)) < 0.7).astype(np.float32) / np.float32(keep)
    m[0] = (1.0 / keep, 0.0)
    m[1] = (0.0, 1.0 / keep)
    return m


def _jax_grads_torch_layout(dx, tree, tblk):
    """JAX _bwd_call output -> {torch param name: grad} plus dx, in the torch
    module's layout (the bridge's key map and transposes)."""
    sd = jax_to_torch_state_dict({"params": jax.tree_util.tree_map(np.asarray, tree)})
    return np.asarray(dx, np.float32), {k: sd[k].numpy() for k in PARAM_NAMES}


def _port_grads(x, tblk, masks, dout, dtype):
    p = swin_block.prepare_block(tblk, dtype)
    dx, g = swin_block_vjp.swin_block_backward_plain(
        torch.from_numpy(x).to(dtype), p, torch.from_numpy(masks),
        torch.from_numpy(dout).to(dtype))
    grads = swin_block_vjp.module_grads(tblk, g)
    return dx.float().numpy(), {k: v.numpy() for k, v in zip(PARAM_NAMES, grads)}


def _rel_errs(got, ref):
    return {k: float(np.abs(got[k] - ref[k]).max() / np.abs(ref[k]).max()) for k in ref}


@pytest.mark.parametrize("shift", [0, 4])
def test_plain_block_with_masks_matches_pallas_interpret(rng, shift):
    """f32: K2's plain version with drop-path masks against the Pallas
    forward with dp_masks (same folds and rounding points): 5e-5, as the
    unmasked block."""
    _, params, tblk, x = _block_pair(rng, shift)
    masks = _masks(rng, x.shape[0])
    ref = np.asarray(jax_block_fused(jnp.asarray(x), params, H=H, W=W, nh=NH, window=WIN,
                                     shift=shift, compute_dtype=jnp.float32,
                                     attn_impl="exact", dp_masks=jnp.asarray(masks),
                                     interpret=True))
    p = swin_block.prepare_block(tblk, torch.float32)
    got = swin_block.swin_block_fused(torch.from_numpy(x), p, torch.from_numpy(masks)).numpy()
    assert np.abs(got - ref).max() < 5e-5, np.abs(got - ref).max()
    # the masks act: image 0's MLP branch and image 1's attention branch are off
    plain = swin_block.swin_block_plain(torch.from_numpy(x), p).numpy()
    assert np.abs(got - plain).max() > 1e-2


@pytest.mark.parametrize("shift", [0, 4])
def test_plain_backward_matches_pallas_bwd_f32(rng, shift):
    """f32: dx and every parameter grad (the folded relative-position table
    and the q-scaled qkv columns included) within 2e-4 of each tensor's
    largest magnitude, the band the JAX package holds its backward kernel to
    (test_swin_vjp.py:108-110)."""
    _, params, tblk, x = _block_pair(rng, shift)
    masks = _masks(rng, x.shape[0])
    dout = rng.standard_normal(x.shape).astype(np.float32)
    dx_j, tree = _bwd_call(jnp.asarray(x), params, jnp.asarray(masks), jnp.asarray(dout),
                           H=H, W=W, nh=NH, window=WIN, shift=shift,
                           compute_dtype=jnp.float32, interpret=True)
    ref_dx, ref = _jax_grads_torch_layout(dx_j, tree, tblk)
    dx, got = _port_grads(x, tblk, masks, dout, torch.float32)
    assert np.abs(dx - ref_dx).max() <= 2e-4 * np.abs(ref_dx).max()
    errs = _rel_errs(got, ref)
    assert max(errs.values()) <= 2e-4, errs


def test_plain_backward_bf16_rounds_like_pallas_bwd(rng):
    """bf16 compute: the plain backward rounds where _bwd_kernel rounds
    (y recomputed in f32, P, dS, dqkv, the attention-output and window
    grads, the drop-path-scaled cotangents). Three differences remain: the
    Pallas bf16 path uses a fast erf in GELU and GELU' (~1e-4 relative), it
    rounds q and then q * scale where the port rounds the folded q once, and
    one-ulp flips of bf16 intermediates (2^-8 relative) propagate into sums
    (measured: at most 5.5e-3 of scale). Bound: 2^-5 of each tensor's
    largest magnitude, and, summed over the parameter grads, the port sits
    closer to the Pallas bf16 kernel than that kernel does to float32 (dx is
    left out of that: both bf16 results round dx itself to bf16)."""
    _, params, tblk, x = _block_pair(rng, 4)
    masks = _masks(rng, x.shape[0])
    dout = rng.standard_normal(x.shape).astype(np.float32)
    dx_j, tree = _bwd_call(jnp.asarray(x, jnp.bfloat16), params, jnp.asarray(masks),
                           jnp.asarray(dout, jnp.bfloat16), H=H, W=W, nh=NH, window=WIN,
                           shift=4, compute_dtype=jnp.bfloat16, interpret=True)
    ref_dx, ref = _jax_grads_torch_layout(dx_j, tree, tblk)
    dx, got = _port_grads(x, tblk, masks, dout, torch.bfloat16)
    x16 = torch.from_numpy(x).bfloat16().float().numpy()
    d16 = torch.from_numpy(dout).bfloat16().float().numpy()
    _, f32 = _port_grads(x16, tblk, masks, d16, torch.float32)
    e_dx = np.abs(dx - ref_dx).max() / np.abs(ref_dx).max()
    errs = _rel_errs(got, ref)
    assert e_dx <= 2 ** -5 and max(errs.values()) <= 2 ** -5, (e_dx, errs)
    gap = _rel_errs(ref, f32)
    assert sum(errs.values()) < sum(gap.values()), (errs, gap)


@pytest.mark.parametrize("shift", [0, 4])
def test_swin_block_train_grads_match_autograd(rng, shift):
    """SwinBlockTrain on the CPU (plain K2 forward, plain K3 backward) against
    torch.autograd through the eager block with the same masks, f32: output
    and every grad of x and the module's parameters within 1e-5 of scale."""
    _, _, tblk, x = _block_pair(rng, shift)
    masks = torch.from_numpy(_masks(rng, x.shape[0]))
    dout = torch.from_numpy(rng.standard_normal(x.shape).astype(np.float32))
    params = swin_block_vjp.block_parameters(tblk)
    xa = torch.from_numpy(x).requires_grad_(True)
    ref = tblk(xa, masks)
    ref_g = torch.autograd.grad((ref * dout).sum(), [xa] + params)
    xb = torch.from_numpy(x).requires_grad_(True)
    out = swin_block_vjp.swin_block_train(xb, tblk, masks, torch.float32)
    got_g = torch.autograd.grad((out * dout).sum(), [xb] + params)
    assert (out - ref).abs().max() <= 1e-5 * ref.abs().max()
    for name, a, b in zip(("x",) + PARAM_NAMES, ref_g, got_g):
        assert a.shape == b.shape, name
        assert (a - b).abs().max() <= 1e-5 * a.abs().max(), name
    # no kernel was launched or built for CPU tensors
    assert swin_block_vjp.KERNEL._lib is None


def test_backward_wrapper_counts_launches_only_on_cuda(rng):
    """K3's wrapper takes the plain version for CPU tensors only, counting
    no launch and building nothing; any other device is refused, not routed
    to the plain version. The training extractor does the same with K1."""
    from pseldnets_tpu_torch.config import compose
    from pseldnets_tpu_torch.ops import frontend
    from pseldnets_tpu_torch.ops.features import LogmelIVExtractor, make_extractor
    from test_torch_train import ROOT, TINY_TASK

    _, _, tblk, x = _block_pair(rng, 4)
    p = swin_block.prepare_block(tblk, torch.float32)
    xt = torch.from_numpy(x)
    m = torch.from_numpy(_masks(rng, x.shape[0]))
    swin_block_vjp.KERNEL.launches = 0
    swin_block_vjp.swin_block_backward(xt, p, m, xt)
    assert swin_block_vjp.KERNEL.launches == 0 and swin_block_vjp.KERNEL._lib is None
    with pytest.raises(ValueError, match="expected a CUDA tensor"):
        swin_block_vjp.swin_block_backward(xt.to("meta"), p, m, xt.to("meta"))
    cfg = compose(str(ROOT / "configs"), "train", ["loss=multi_accdoa"])
    ext = make_extractor(cfg)
    assert isinstance(ext, LogmelIVExtractor) and ext.use_kernels
    wav = torch.from_numpy((rng.standard_normal((1, 4, 4800)) * 0.1).astype(np.float32))
    frontend.KERNEL.launches = 0
    assert ext(wav).shape == (1, 7, 21, 64) and frontend.KERNEL.launches == 0
    with pytest.raises(ValueError, match="expected a CUDA tensor"):
        ext(wav.to("meta"))
    assert swin_block_vjp.KERNEL.launches == frontend.KERNEL.launches == 0
    with pytest.raises(NotImplementedError, match="queue A, step 1"):
        make_extractor(compose(str(ROOT / "configs"), "train",
                               ["loss=multi_accdoa", "data.audio_feature=logmel"]))
    # the tiny task's hop >= n_fft: the JAX package keeps it off its kernel too
    tiny = LogmelIVExtractor(compose(str(ROOT / "configs"), "train", TINY_TASK))
    assert tiny.hop >= tiny.n_fft


@pytest.mark.parametrize("want", [
    ("ln1_b", "qkv_b", "proj_b", "ln2_b", "fc1_b", "fc2_b"), ("qkv_w", "bias", "ln2_w"), ()])
def test_masked_plain_backward_returns_exactly_the_wanted_grads(rng, want):
    """K3's plain version asked for some grads (the mask K3's C entry takes as
    null pointers) returns those keys only, each with the full form's bits,
    and the full form's dx."""
    _, _, tblk, x = _block_pair(rng, 4)
    p = swin_block.prepare_block(tblk, torch.float32)
    xt, m = torch.from_numpy(x), torch.from_numpy(_masks(rng, x.shape[0]))
    dout = torch.from_numpy(rng.standard_normal(x.shape).astype(np.float32))
    dx, g = swin_block_vjp.swin_block_backward_plain(xt, p, m, dout)
    dxm, gm = swin_block_vjp.swin_block_backward_plain(xt, p, m, dout, want)
    assert set(g) == set(swin_block_vjp.GRAD_KEYS) and set(gm) == set(want)
    assert torch.equal(dxm, dx) and all(torch.equal(gm[k], g[k]) for k in want)


def test_swin_block_train_asks_only_for_what_autograd_wants(rng, monkeypatch):
    """SwinBlockTrain's backward passes ``ctx.needs_input_grad`` on as the
    grads it wants: a frozen parameter's grad is neither asked for nor
    returned, and the trained ones equal the full backward's."""
    _, _, tblk, x = _block_pair(rng, 0)
    masks = torch.from_numpy(_masks(rng, x.shape[0]))
    dout = torch.from_numpy(rng.standard_normal(x.shape).astype(np.float32))
    asked = []
    plain = swin_block_vjp.swin_block_backward_plain

    def record(*args):
        asked.append(args[4])
        return plain(*args)

    monkeypatch.setattr(swin_block_vjp, "swin_block_backward_plain", record)
    params = swin_block_vjp.block_parameters(tblk)
    xb = torch.from_numpy(x).requires_grad_(True)
    full = torch.autograd.grad((swin_block_vjp.swin_block_train(
        xb, tblk, masks, torch.float32, use_kernels=False) * dout).sum(), [xb] + params)
    assert set(asked[-1]) == set(swin_block_vjp.GRAD_KEYS)
    for prm in (tblk.attn.qkv.weight, tblk.norm1.weight, tblk.attn.relative_position_bias_table):
        prm.requires_grad_(False)
    out = swin_block_vjp.swin_block_train(xb, tblk, masks, torch.float32, use_kernels=False)
    (out * dout).sum().backward()
    assert set(asked[-1]) == set(swin_block_vjp.GRAD_KEYS) - {"qkv_w", "ln1_w", "bias"}
    assert tblk.attn.qkv.weight.grad is None and tblk.norm1.weight.grad is None
    for prm, ref in zip(params, full[1:]):
        if prm.requires_grad:
            assert torch.equal(prm.grad, ref)
    assert torch.equal(xb.grad, full[0])
