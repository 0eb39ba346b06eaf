"""The port's ACS and bf16 eval against the JAX package's on the CPU: batched
ACS (SELDTask._acs_forward) against the JAX ``_acs_forward`` with the 5 s
trick active and not, and against a loop of 16 port eval steps; ACS through
eval_step on an odd batch against the JAX step; and the bf16 eval step
against the body of the JAX step's route in bf16 and against float32.

Bounds: < 5e-5 against the JAX step in float32, < 1e-5 between the batched
ACS and the loop, < 3e-2 of the output's scale in bf16 (the port's bands)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pseldnets_tpu_torch.train.module import SELDTask
import torch_threads  # noqa: F401  (each xdist worker's share of the cores)
from test_torch_eval import HTSAT, _max_diff, _pair, _wav


def test_eval_step_bf16_within_band():
    """bf16-mixed: the port's routed step against the body of the JAX eval
    step's route in bf16 (serving.htsat_fused_forward, module.py:421-424,
    its Pallas kernels in interpret mode; the JAX step routes there on a
    TPU only) and against the port's float32 step: within 3e-2 of the
    output's scale."""
    from pseldnets_tpu.serving import htsat_fused_forward as jax_fused

    over = HTSAT + ["trainer.precision=bf16-mixed"]
    task_j, state, task, _ = _pair(over)
    assert task.compute_dtype == torch.bfloat16
    x = _wav(3, 64000)
    got = task.eval_step({"data": x})["multi_accdoa"]
    feats = task_j._forward_features(jnp.asarray(np.concatenate([x, x[-1:]])))
    want = jax_fused(task_j.model, {"params": state.params, "batch_stats": state.batch_stats},
                     feats, compute_dtype=jnp.bfloat16, interpret=True)["multi_accdoa"]
    task.compute_dtype = torch.float32
    ref = task.eval_step({"data": x})["multi_accdoa"]
    scale = float(ref.abs().max())
    assert float(np.abs(got.numpy() - np.asarray(want, np.float32)[:3]).max()) < 3e-2 * scale
    assert float((got - ref).abs().max()) < 3e-2 * scale


def _naive_acs(task, x):
    """The reference's per-rotation loop (components/model_module.py:269-303)
    over 16 port eval steps."""
    trans = {(0, 1, 2): (1, 2, 3), (1, 0, 2): (3, 2, 1)}
    key = task.method
    tracks = 3 if key == "multi_accdoa" else 1
    outs = []
    for sign_x, sign_y, sign_z in SELDTask._ACS_SIGNS:
        for (xx, yy, zz), (s_x, s_y, s_z) in trans.items():
            xv = torch.stack([x[:, 0], sign_y * x[:, s_x], sign_z * x[:, s_y],
                              sign_x * x[:, s_z]], dim=1)
            y = task.eval_step({"data": xv})[key]
            B, T = y.shape[:2]
            y = y.reshape(B, T, tracks, 3, -1)
            y = torch.stack([sign_x * y[..., 0, :], sign_y * y[..., 1, :],
                             sign_z * y[..., 2, :]], dim=-2)
            y = torch.stack([y[..., xx, :], y[..., yy, :], y[..., zz, :]], dim=-2)
            outs.append(y.reshape(B, T, -1))
    return torch.stack(outs).mean(0)


@pytest.mark.parametrize("n,over", [(64000, HTSAT), (32000, HTSAT),
                                    (64000, HTSAT + ["loss=accdoa"])],
                         ids=["multi_accdoa", "multi_accdoa_5s", "accdoa"])
def test_acs_matches_jax_and_the_loop(n, over):
    """Batched ACS (chunks of 16 and 4 rotations, B=4) against the JAX
    ``_acs_forward`` (< 5e-5) and a loop of 16 port eval steps (< 1e-5).
    At 2 s the 5 s trick pairs item j with item j + B/2 inside each
    rotation: the (half, variant, item) fold must keep that pairing
    (tests/test_acs_batched.py::test_acs_batched_matches_naive_loop_5s_trick)."""
    task_j, state, task, _ = _pair(over)
    loss = task.method
    x = _wav(4, n, seed=3)
    loop = _naive_acs(task, torch.from_numpy(x))
    for chunk in (16, 4):
        want = np.asarray(task_j._acs_forward(state, jnp.asarray(x), chunk=chunk)[loss])
        got = task._acs_forward(torch.from_numpy(x), chunk=chunk)[loss]
        assert float(np.abs(got.numpy() - want).max()) < 5e-5, chunk
        assert float((got - loop).abs().max()) < 1e-5, chunk


def test_acs_eval_step_odd_batch_matches_jax():
    """post_processing="ACS" through eval_step on an odd batch (padded to 4,
    the chunk chosen as the JAX package chooses it) against the JAX step."""
    task_j, state, task, _ = _pair(HTSAT)
    assert [SELDTask.acs_chunk(b) for b in (2, 32, 64, 128, 600)] == [8, 8, 8, 4, 1]
    x = _wav(3, 64000, seed=4)
    want = task_j.eval_step(state, {"data": x}, post_processing="ACS")
    got = task.eval_step({"data": x}, post_processing="ACS")
    assert got["multi_accdoa"].shape == (3, 40, 27)
    assert _max_diff(got, want) < 5e-5


