"""Kernel K7's decomposition on the CPU (csrc/conv_block.cu cannot be compiled
here): the host's tile plan (``ops/conv_block.py::tile_plan``) and a replay
of what the kernel computes from it, held against the plain version.

The replay follows the kernel's ring form step by step: the tiles in the kernel's order
(bins fastest, then time rows, then images), per tile and tap (dt, df) and
channel step c0 a box of BK channels x Fb bins x tT time rows gathered at
(c0, f0 + df - 1, t0 + dt - 1) with zeros wherever a coordinate falls
outside the tensor (TMA's fill: the SAME padding and the channels past Cin),
the weight rows of that tap and channel step (zero past Cin), float32 sums
over the 9 ceil(Cin / BK) steps, the float32 bias, ReLU and one rounding to
bf16, and a store that drops the positions past T and F. relu_conv rewrites
each box as relu(x + b1) rounded to bf16 except where TMA filled zeros.
The resident form reads the same rows out of one taller box per channel
step and df. Change the replay with the kernel.
"""

import itertools

import numpy as np
import pytest
import torch

from pseldnets_tpu_torch.ops import conv_block
import torch_threads  # noqa: F401  (each xdist worker's share of the cores)

# (T, F) of the CNN12 trunk's six ConvBlocks at 10 s, then ragged shapes
TRUNK = ((1001, 64, 8, 64), (500, 32, 64, 128), (250, 16, 128, 256), (125, 8, 256, 512),
         (125, 4, 512, 1024), (125, 2, 1024, 2048))
PLANS = [(T, F) for T, F, _, _ in TRUNK] + [
    (7, 48), (33, 5), (3, 200), (13, 200), (1, 1), (5, 129), (300, 1), (2, 257), (9, 3),
    (64, 100), (1, 128), (2, 1000)]


def tile_origins(B, T, F):
    """The kernel's tiles in its order (tile_at, without the output-channel
    panel): arrays of (b, t0, f0), and the plan (tT, Fb)."""
    tt, fb = conv_block.tile_plan(T, F)
    n_t, n_f = -(-T // tt), -(-F // fb)
    m = np.arange(B * n_t * n_f)
    return (m // (n_f * n_t), m // n_f % n_t * tt, m % n_f * fb), (tt, fb)


@pytest.mark.parametrize("T,F", PLANS)
def test_tile_plan_covers_every_position_once(T, F):
    """Every output position of every image lies in exactly one tile; a tile
    is at most 128 positions (two warpgroups of 64 rows), each box dimension
    at most 256 (TMA's limit), and a tile's rows are whole Fb-bin rows of one
    image."""
    B = 3
    (bi, t0, f0), (tt, fb) = tile_origins(B, T, F)
    assert 1 <= tt <= min(T, 256) and 1 <= fb <= 256 and tt * fb <= conv_block.MAX_ROWS
    assert fb == F or F > conv_block.MAX_ROWS  # whole rows of F up to 128 bins
    hits = np.zeros((B, T, F), np.int64)
    for b, t, f in zip(bi, t0, f0):
        hits[b, t:t + tt, f:f + fb] += 1  # numpy clips at T and F, as the store does
    assert (hits == 1).all()


def box(xf, bi, t0, f0, rows_t, fb, c):
    """TMA's box of x at tiles (bi, t0, f0): rows_t time rows x fb bins x
    channels c, zeros wherever a coordinate lies outside x. Returns the box
    (tiles, rows_t fb, channels) and where it read x."""
    _, T, F, cin = xf.shape
    r = torch.arange(rows_t * fb)
    ts = t0[:, None] + (r // fb)[None, :]
    fs = f0[:, None] + (r % fb)[None, :]
    inside = ((ts >= 0) & (ts < T) & (fs >= 0) & (fs < F))[..., None] & (c < cin)
    got = xf[bi[:, None], ts.clamp(0, T - 1), fs.clamp(0, F - 1)][..., c.clamp(max=cin - 1)]
    return torch.where(inside, got, torch.zeros(())), inside


def test_resident_form_boxes_are_the_tap_boxes():
    """The resident form loads, per channel step and df, one box of tT + 2
    time rows at t0 - 1 and reads tap dt's A rows at row offset dt Fb: those
    rows are the ring form's box of tap (dt, df), zero fill included."""
    g = torch.Generator().manual_seed(3)
    for B, T, F, cin in ((2, 1001, 64, 8), (3, 7, 48, 16), (2, 9, 8, 24), (1, 5, 16, 64)):
        xf = torch.randn(B, T, F, cin, generator=g)
        (bi, t0, f0), (tt, fb) = tile_origins(B, T, F)
        bi, t0, f0 = (torch.from_numpy(a) for a in (bi, t0, f0))
        assert fb % 8 == 0  # the resident form's row offsets are whole swizzle groups
        c = torch.arange(16)
        for df in range(3):
            tall, _ = box(xf, bi, t0 - 1, f0 + df - 1, tt + 2, fb, c)
            for dt in range(3):
                ring, _ = box(xf, bi, t0 + dt - 1, f0 + df - 1, tt, fb, c)
                assert torch.equal(tall[:, dt * fb:dt * fb + tt * fb], ring)


def replay(x, w, b, bin_=None, bk=64, mask=True):
    """K7's arithmetic for one conv on x (B, T, F, Cin) bf16 with HWIO w (3,
    3, Cin, Cout) bf16 and float32 bias b; relu_conv when ``bin_`` (Cin,)
    is given (``mask=False``: its transform also over TMA's zero fill).
    Returns (B, T, F, Cout) bf16."""
    B, T, F, cin = x.shape
    cout = w.shape[3]
    (bi, t0, f0), (tt, fb) = tile_origins(B, T, F)
    bi, t0, f0 = (torch.from_numpy(a) for a in (bi, t0, f0))
    xf, wf = x.float(), w.float()
    acc = torch.zeros(len(bi), tt * fb, cout)
    for tap, cs in itertools.product(range(9), range(-(-cin // bk))):
        dt, df = divmod(tap, 3)
        c = torch.arange(cs * bk, (cs + 1) * bk)
        c_ok = c < cin
        a, filled = box(xf, bi, t0 + dt - 1, f0 + df - 1, tt, fb, c)
        if bin_ is not None:
            act = torch.relu(a + bin_[c.clamp(max=cin - 1)]).bfloat16().float()
            a = torch.where(filled, act, a) if mask else act
        wt = torch.where(c_ok[:, None], wf[dt, df][c.clamp(max=cin - 1)], torch.zeros(()))
        acc += a @ wt
    y = torch.relu(acc + b).bfloat16()
    out = torch.zeros(B, T, F, cout, dtype=torch.bfloat16)
    r = torch.arange(tt * fb)
    ts, fs = t0[:, None] + (r // fb)[None, :], f0[:, None] + (r % fb)[None, :]
    keep = (ts < T) & (fs < F)
    out[bi[:, None].expand_as(ts)[keep], ts[keep], fs[keep]] = y[keep]
    return out


def _operands(seed, B, T, F, cin, cout, real_cin=None):
    """bf16 x and HWIO w (channels past ``real_cin`` zero, as the padded
    stem), float32 biases large enough that a wrong halo shows."""
    g = np.random.default_rng(seed)
    real_cin = real_cin or cin
    x = g.standard_normal((B, T, F, cin)).astype(np.float32)
    w = (g.standard_normal((3, 3, cin, cout)) / np.sqrt(9 * real_cin)).astype(np.float32)
    x[..., real_cin:] = 0.0
    w[:, :, real_cin:] = 0.0
    b = (g.standard_normal(cout) * 0.5 + 0.5).astype(np.float32)
    bin_ = (g.standard_normal(cin) * 0.5).astype(np.float32)
    t = torch.from_numpy
    return t(x).bfloat16(), t(w).bfloat16(), t(b), t(bin_)


def _close(got, ref, ulps):
    """Within ``ulps`` bf16 ulps (2^-7 each) of the reference's largest
    magnitude: float32 sums in another order may round to the neighbour."""
    got, ref = got.float(), ref.float()
    assert got.shape == ref.shape
    err = (got - ref).abs().max().item()
    assert err <= ulps * 2.0 ** -7 * ref.abs().max().item(), err


@pytest.mark.parametrize("block", range(6))
def test_kernel_replay_matches_plain_at_trunk_shapes(block):
    """One conv of each ConvBlock of the CNN12 trunk at B=1 (T x F and Cin
    as served: the stem's 7 channels padded to 8 and its conv1 in K steps of
    16; the output-channel panels are not replayed, so Cout is cut to 128)."""
    T, F, cin, cout = TRUNK[block]
    x, w, b, _ = _operands(block, 1, T, F, cin, min(cout, 128), real_cin=min(cin, 7))
    bk = conv_block.conv_tile(cin, cout)[1]
    assert bk == (16 if block == 0 else 64)
    _close(replay(x, w, b, bk=bk), conv_block.conv3x3_bias_relu_plain(x, w, b), 1)


@pytest.mark.parametrize("bk", [16, 64])
def test_kernel_replay_matches_plain_stem_pair(bk):
    """The stem's pair (8 -> 64 -> 64 at T=1001, F=64, B=1) as the kernel's
    two launches, conv1 in K steps of 16 or 64 channels (the 64-channel box
    reads 56 zero channels)."""
    x, w1, b1, _ = _operands(7, 1, 1001, 64, 8, 64, real_cin=7)
    _, w2, b2, _ = _operands(8, 1, 1, 1, 64, 64)
    mid = replay(x, w1, b1, bk=bk)
    _close(replay(mid, w2, b2), conv_block.conv3x3_bias_relu_plain(x, w1, b1, w2, b2), 2)


@pytest.mark.parametrize("B,T,F,cin,cout", [
    (3, 7, 48, 16, 64), (3, 33, 5, 32, 40), (2, 3, 200, 64, 48), (3, 13, 129, 24, 16),
    (2, 9, 3, 80, 72), (1, 2, 257, 8, 8)])
def test_kernel_replay_matches_plain_at_ragged_shapes(B, T, F, cin, cout):
    """Odd T with several images (each image's last tile clipped), F not
    dividing 128, F over 128 (equal chunks), Cin not a multiple of the
    64-channel K step, Cout not a multiple of 64."""
    x, w, b, _ = _operands(B * T + F, B, T, F, cin, cout)
    _close(replay(x, w, b), conv_block.conv3x3_bias_relu_plain(x, w, b), 1)


@pytest.mark.parametrize("B,T,F,cin,cout", [
    (2, 19, 8, 64, 128), (3, 9, 5, 24, 40), (2, 5, 200, 72, 200), (1, 1001, 64, 64, 64)])
def test_kernel_replay_matches_plain_relu_conv(B, T, F, cin, cout):
    """relu_conv: relu(x + b1) is rewritten in each box except where TMA
    filled zeros (outside the image, channels past Cin); without that mask
    the replay would put relu(b1) in the halo and disagree."""
    x, w, b, bin_ = _operands(B + T + F, B, T, F, cin, cout)
    ref = conv_block.conv3x3_bias_relu_plain(x, None, bin_, w, b)
    _close(replay(x, w, b, bin_), ref, 1)
    # the trap the mask avoids: relu(0 + b1) written over TMA's zeros
    wrong = replay(x, w, b, bin_, mask=False).float()
    assert (wrong - ref.float()).abs().max() > 2.0 ** -4 * ref.float().abs().max()
