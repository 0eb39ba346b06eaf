"""The port's whole-stage Swin (plain version of kernel K11) against the JAX
package's swin_stage_fused and swin_stage_fused_v2 (Pallas, interpret mode),
with the same weights moved across by the bridge. Each test draws its inputs
from its own seeded numpy generator."""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pseldnets_tpu.models.htsat import SwinTransformerBlock as JaxBlock
from pseldnets_tpu.ops.pallas.swin_block import swin_stage_fused as jax_stage_v1
from pseldnets_tpu.ops.pallas.swin_block import swin_stage_fused_v2 as jax_stage_v2
from pseldnets_tpu_torch.models.htsat import BasicLayer, SwinTransformerBlock
from pseldnets_tpu_torch.ops import swin_block, swin_stage
from pseldnets_tpu_torch.train.checkpoint import load_jax_variables
import torch_threads  # noqa: F401  (each xdist worker's share of the cores)
from test_torch_swin_block import randomize

C, NH, WIN = 32, 4, 8


def _stage(seed, shifts, H=16, B=3):
    """Random flax params for len(shifts) blocks at H x H, the torch blocks
    carrying them (block j shifted by shifts[j]) and an input (B, H*H, C)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, H * H, C)).astype(np.float32)
    params, tblocks = [], []
    for j, shift in enumerate(shifts):
        blk = JaxBlock(dim=C, input_resolution=(H, H), num_heads=NH, window_size=WIN,
                       shift_size=shift)
        p = randomize(blk.init(jax.random.PRNGKey(j), jnp.asarray(x))["params"], rng)
        tblk = SwinTransformerBlock(C, (H, H), NH, WIN, shift_size=shift)
        load_jax_variables(tblk, {"params": p})
        params.append(p)
        tblocks.append(tblk.eval())
    return params, types.SimpleNamespace(blocks=tblocks), x


def _jax(fn, x, params, H, shifts, dtype):
    out = fn(jnp.asarray(x, dtype), params, H=H, W=H, nh=NH, window=WIN, shifts=shifts,
             compute_dtype=dtype, interpret=True)
    return np.asarray(out.astype(jnp.float32))


@pytest.mark.parametrize("form", ["v1", "v2"])
@pytest.mark.parametrize("H,shifts", [(16, (0, 4, 0, 4)), (8, (0, 0))])
def test_plain_stage_matches_pallas_interpret(form, H, shifts):
    """f32: K2's folds (q-scale in the weights) and rounding points, block
    after block, against the Pallas stage kernels - summation order only,
    bound 5e-5. The 8x8 stage is the clamped one: the window covers the map,
    no shift, no mask."""
    params, layer, x = _stage(10 + H, shifts, H=H)
    ref = _jax(jax_stage_v1 if form == "v1" else jax_stage_v2, x, params, H, shifts,
               jnp.float32)
    sp = swin_stage.prepare_stage(layer, torch.float32)
    assert sp.shifts == shifts and (sp.mask is None) == (max(shifts) == 0)
    fn = swin_stage.swin_stage_fused if form == "v1" else swin_stage.swin_stage_fused_v2
    got = fn(torch.from_numpy(x), sp).numpy()
    assert got.shape == ref.shape == x.shape
    assert np.abs(got - ref).max() < 5e-5, np.abs(got - ref).max()


def test_v1_pattern_matches_pallas_and_v2_rejects_it():
    """Shifts (0, 4, 4, 0): v1 takes any 0/base pattern and matches the
    Pallas v1; v2 raises where the JAX package asserts."""
    shifts = (0, 4, 4, 0)
    params, layer, x = _stage(20, shifts)
    ref = _jax(jax_stage_v1, x, params, 16, shifts, jnp.float32)
    sp = swin_stage.prepare_stage(layer, torch.float32)
    got = swin_stage.swin_stage_fused(torch.from_numpy(x), sp).numpy()
    assert np.abs(got - ref).max() < 5e-5, np.abs(got - ref).max()
    with pytest.raises(ValueError, match="0, s, 0, s"):
        swin_stage.swin_stage_fused_v2(torch.from_numpy(x), sp)


def test_plain_stage_bf16_rounds_like_pallas():
    """bf16: the rounding points are the Pallas stage kernel's, but it
    scales q in bf16 after rounding qkv (the port folds the scale into the
    weights) and takes a polynomial GELU, so one-ulp flips differ and
    propagate through 4 blocks: within 3e-2 of the output's scale (the block
    tests' bf16 bound; about 1.4e-2 here), and no further from float32 than
    the Pallas bf16 output is (x1.25 plus one bf16 ulp of the scale, the
    rule chip_smoke.py holds the kernels to)."""
    shifts = (0, 4, 0, 4)
    params, layer, x = _stage(30, shifts)
    ref = _jax(jax_stage_v2, x, params, 16, shifts, jnp.bfloat16)
    ref32 = _jax(jax_stage_v2, x, params, 16, shifts, jnp.float32)
    got = swin_stage.swin_stage_fused_v2(
        torch.from_numpy(x).bfloat16(), swin_stage.prepare_stage(layer, torch.bfloat16))
    got = got.float().numpy()
    scale = np.abs(ref32).max()
    assert np.abs(got - ref).max() < 3e-2 * scale, (np.abs(got - ref).max(), scale)
    assert np.abs(got - ref32).max() <= (1.25 * np.abs(ref - ref32).max()
                                         + 2.0 ** -7 * scale)


def test_plain_stage_is_plain_blocks_chained():
    """swin_stage_plain is swin_block_plain of each block's own prepared
    weights in turn (the stacking and the shared mask change nothing), on a
    BasicLayer as the served model builds it."""
    rng = np.random.default_rng(40)
    layer = BasicLayer(C, (16, 16), 4, NH, WIN).eval()
    with torch.no_grad():
        for prm in layer.parameters():
            prm.copy_(torch.from_numpy(0.3 * rng.standard_normal(prm.shape).astype(np.float32)))
    x = torch.from_numpy(rng.standard_normal((2, 256, C)).astype(np.float32))
    sp = swin_stage.prepare_stage(layer, torch.float32)
    assert sp.shifts == (0, 4, 0, 4) and sp.bias.shape == (4, NH, 64, 64)
    ref = x
    for blk in layer.blocks:
        ref = swin_block.swin_block_plain(ref, swin_block.prepare_block(blk, torch.float32))
    got = swin_stage.swin_stage_plain(x, sp)
    assert (got - ref).abs().max() <= 1e-6
    with torch.no_grad():
        eager = layer(x)
    assert (got - eager).abs().max() < 5e-5


def test_cpu_tensor_counts_no_launch():
    """A CPU tensor takes the plain version: K11's count stays, and so does
    K2's."""
    _, layer, x = _stage(50, (0, 4))
    sp = swin_stage.prepare_stage(layer, torch.bfloat16)
    before = swin_stage.KERNEL.launches, swin_block.KERNEL.launches
    out = swin_stage.swin_stage_fused(torch.from_numpy(x).bfloat16(), sp)
    out2 = swin_stage.swin_stage_fused_v2(torch.from_numpy(x).bfloat16(), sp)
    assert torch.equal(out, out2) and out.dtype == torch.bfloat16
    assert (swin_stage.KERNEL.launches, swin_block.KERNEL.launches) == before


def test_prepare_stage_raises_on_what_the_kernel_does_not_take():
    """Mixed shifts other than 0/base, and blocks of differing width."""
    _, layer, _ = _stage(60, (0, 4, 4))
    layer.blocks[2].shift_size = 2
    with pytest.raises(ValueError, match="0 or one base shift"):
        swin_stage.prepare_stage(layer, torch.float32)
    mixed = types.SimpleNamespace(blocks=[SwinTransformerBlock(C, (16, 16), NH, WIN),
                                          SwinTransformerBlock(2 * C, (16, 16), NH, WIN)])
    with pytest.raises(ValueError, match="geometry"):
        swin_stage.prepare_stage(mixed, torch.float32)
