"""The port's Swin block (plain version of kernel K2) against the JAX package:
the Pallas swin_block_fused in interpret mode (exact softmax, f32) and the flax
SwinTransformerBlock, with the same weights moved across by the bridge."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pseldnets_tpu.models.htsat import PatchMerging as JaxMerge
from pseldnets_tpu.models.htsat import SwinTransformerBlock as JaxBlock
from pseldnets_tpu.ops.pallas.swin_block import swin_block_fused as jax_block_fused
from pseldnets_tpu_torch.models.htsat import PatchMerging, SwinTransformerBlock
from pseldnets_tpu_torch.ops import swin_block
from pseldnets_tpu_torch.train.checkpoint import load_jax_variables
import torch_threads  # noqa: F401  (each xdist worker's share of the cores)

H = W = 16
C, NH, WIN = 32, 4, 8


def abstract_init(model, x, **kw):
    """A flax model's variables as zeros of their shapes and dtypes, from an
    abstract init (``jax.eval_shape``: none of an eager init's op-by-op
    compiles), for ``randomize`` to fill; keys in sorted order."""
    shapes = jax.eval_shape(lambda x: model.init({"params": jax.random.PRNGKey(0)}, x, **kw), x)
    return jax.tree_util.tree_map(lambda a: np.zeros(a.shape, a.dtype), shapes)


def randomize(tree, rng):
    """Every leaf of a flax tree replaced by seeded numpy noise: kernels
    N(0, 1/fan_in), LayerNorm scales 1 + N(0, 0.1), everything else
    N(0, 0.3) - so biases, norms and the relative-position table all matter."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict) or hasattr(v, "items"):
            out[k] = randomize(v, rng)
            continue
        v = np.asarray(v)
        if k == "kernel":
            fan_in = int(np.prod(v.shape[:-1]))
            out[k] = (rng.standard_normal(v.shape) / np.sqrt(fan_in)).astype(np.float32)
        elif k == "scale":
            out[k] = (1.0 + 0.1 * rng.standard_normal(v.shape)).astype(np.float32)
        else:
            out[k] = (0.3 * rng.standard_normal(v.shape)).astype(np.float32)
    return out


def _block_pair(rng, shift):
    blk = JaxBlock(dim=C, input_resolution=(H, W), num_heads=NH,
                   window_size=WIN, shift_size=shift)
    x = rng.standard_normal((3, H * W, C)).astype(np.float32)
    params = randomize(blk.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"], rng)
    tblk = SwinTransformerBlock(C, (H, W), NH, WIN, shift_size=shift)
    load_jax_variables(tblk, {"params": params})
    return blk, params, tblk.eval(), x


def _merge_pair(rng):
    mrg = JaxMerge(input_resolution=(H, W), dim=C)
    params = randomize(mrg.init(jax.random.PRNGKey(1),
                                jnp.zeros((1, H * W, C)))["params"], rng)
    tm = PatchMerging((H, W), C)
    load_jax_variables(tm, {"params": params})
    return mrg, params, tm.eval()


@pytest.mark.parametrize("shift", [0, 4])
@pytest.mark.parametrize("merge", [False, True])
def test_plain_block_matches_pallas_interpret(rng, shift, merge):
    """f32 compute: same folds (q-scale in the weights) and the same rounding
    points, so only summation order differs - bound 5e-5."""
    _, params, tblk, x = _block_pair(rng, shift)
    mp, tm = None, None
    if merge:
        _, mp, tm = _merge_pair(rng)
    ref = np.asarray(jax_block_fused(jnp.asarray(x), params, H=H, W=W, nh=NH,
                                     window=WIN, shift=shift,
                                     compute_dtype=jnp.float32, attn_impl="exact",
                                     merge_params=mp, interpret=True))
    p = swin_block.prepare_block(tblk, torch.float32, tm)
    got = swin_block.swin_block_fused(torch.from_numpy(x), p).numpy()
    assert got.shape == ref.shape == ((3, H * W // 4, 2 * C) if merge else x.shape)
    assert np.abs(got - ref).max() < 5e-5, np.abs(got - ref).max()


@pytest.mark.parametrize("shift", [0, 4])
def test_block_modules_match_flax(rng, shift):
    """The eager torch block (plain version of the whole encoder) and the
    plain kernel version against flax SwinTransformerBlock (+ PatchMerging),
    f32. The kernel form folds the q-scale into the weights, flax scales q:
    a few f32 ulps apart - bound 5e-5."""
    blk, params, tblk, x = _block_pair(rng, shift)
    mrg, mp, tm = _merge_pair(rng)
    ref = np.asarray(blk.apply({"params": params}, jnp.asarray(x)))
    ref_m = np.asarray(mrg.apply({"params": mp}, jnp.asarray(ref)))
    with torch.no_grad():
        eager = tblk(torch.from_numpy(x))
        eager_m = tm(eager)
    assert np.abs(eager.numpy() - ref).max() < 5e-5
    assert np.abs(eager_m.numpy() - ref_m).max() < 5e-5
    plain = swin_block.swin_block_plain(torch.from_numpy(x),
                                        swin_block.prepare_block(tblk, torch.float32, tm))
    assert np.abs(plain.numpy() - ref_m).max() < 5e-5


def test_plain_block_bf16_rounds_like_pallas(rng):
    """bf16 compute: the plain version rounds where the Pallas kernel does
    (qkv, softmax probabilities, heads, proj, residual sums, GELU output,
    merge LN). GELU differs (exact erf vs the kernel's polynomial, <= 5.2e-5,
    below bf16 rounding) and one-ulp flips propagate: bound 3e-2 on O(1)
    activations, against a bf16-vs-f32 gap an order larger."""
    _, params, tblk, x = _block_pair(rng, 4)
    _, mp, tm = _merge_pair(rng)
    ref = np.asarray(jax_block_fused(jnp.asarray(x, jnp.bfloat16), params, H=H, W=W,
                                     nh=NH, window=WIN, shift=4,
                                     compute_dtype=jnp.bfloat16, attn_impl="exact",
                                     merge_params=mp, interpret=True)
                     .astype(jnp.float32))
    p = swin_block.prepare_block(tblk, torch.bfloat16, tm)
    got = swin_block.swin_block_fused(torch.from_numpy(x).bfloat16(), p).float().numpy()
    f32 = swin_block.swin_block_plain(torch.from_numpy(x),
                                      swin_block.prepare_block(tblk, torch.float32, tm)).numpy()
    assert np.abs(got - ref).max() < 3e-2, np.abs(got - ref).max()
    assert np.abs(got - ref).max() < np.abs(got - f32).max()
