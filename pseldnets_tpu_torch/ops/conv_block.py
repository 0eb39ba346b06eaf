"""Fused 3x3 conv + bias + ReLU (the CNN trunk's ConvBlock): kernel K7 and its
plain version. The counterpart of the JAX package's
``ops/pallas/conv_block.py::conv3x3_bias_relu`` in its three modes, on NHWC
activations with the eval BatchNorm already folded into the weights
(serving/crnn.py::fold_conv_bn):

- single: relu(conv3x3(x, w) + b);
- pair (``w2``/``b2`` given): the whole ConvBlock,
  relu(conv3x3(relu(conv3x3(x, w) + b), w2) + b2), the mid activation rounded
  to the compute dtype once and zero in conv2's SAME pad outside the image
  (``_kernel_double``, ``_zero_mid_halo``);
- relu_conv (``w`` None): ``x`` is a raw bias-free conv1 output and the
  result is relu(conv3x3(relu(x + b), w2) + b2), relu(x + b) rounded to the
  compute dtype and zero outside the image (``_kernel_relu_conv``).

SAME padding, stride 1; ``w`` (3, 3, Cin, Cout) HWIO in the compute dtype,
``b`` float32; output (B, T, F, Cout) in the compute dtype. The numeric
contract is the Pallas kernel's: compute-dtype operands, float32
accumulation, the float32 bias added before the one rounding.

The served path runs the pair mode on every ConvBlock, the stem included: the
arithmetic of both JAX paths, the default ``conv_impl="xla"`` trunk and
``_kernel_double``. The JAX ``"pallas"`` path splits the stem (Cin = 7) into
an XLA conv that rounds the raw conv1 output to bf16 before the bias, then
relu_conv (serving/crnn.py:202-209); in float32 the three are identical.
On Hopper an implicit GEMM pays no lane padding at Cin = 7, so the port does
not split the stem.

On a CUDA tensor ``conv3x3_bias_relu`` launches the hand-written kernel of
``csrc/conv_block.cu`` (bf16; both convs of the pair in one call): an
implicit GEMM on TMA and wgmma whose output tiles are ``tile_plan``'s tT x
Fb positions of one image by ``conv_tile``'s output channels; on a CPU
tensor it runs ``conv3x3_bias_relu_plain``.
"""

from typing import Optional

import torch
import torch.nn.functional as F

from ._cuda import CudaKernel, check_cuda_tensor, i32, ptr

KERNEL = CudaKernel("conv_block.cu", {
    "conv_block_forward": [ptr] * 7 + [i32] * 15 + [ptr],
})

CIN_ALIGN = 8    # channel granule (16-byte TMA strides): x and w pad Cin to a multiple
COUT_ALIGN = 8   # every output width (and the pair's mid) a multiple
MAX_ROWS = 128   # output positions per tile: two consumer warpgroups of 64 rows
MAX_M = 2 ** 31  # B T F x the widest channel count stays below it
MODES = {"single": 0, "pair": 1, "relu_conv": 2}
# each conv's tile, the fastest at the CNN12 trunk's convs in
# scripts/torch_k7_tiles.py (PERF.md): output channels per tile by the
# conv's Cout (negative: ping-pong, each consumer warpgroup owning whole
# 128-row tiles), input channels per K step where Cin <= 16 (16 or 64),
# ring depth (0: as deep as shared memory allows), and whether a conv whose
# weights fit in shared memory keeps them there (the stem's; its A boxes
# then hold the halo rows and serve three taps each)
TILES = {"bn_cout64": -64, "bn_cout128": 128, "bn_wider": 256, "bk_cin16": 16, "stages": 0,
         "resident": True}


def tile_plan(T: int, F: int):
    """The kernel's output tile: (tT, Fb), tT time rows x Fb frequency bins
    of one image, tT Fb <= 128. Up to 128 bins a tile holds whole rows of F
    (F = 64, 32, 16, 8, 4, 2 give tT = 2, 4, 8, 16, 32, 64); wider F is cut
    into the fewest equal chunks of at most 128. Tiles never cross an image:
    the last tile of each image (and of each row of chunks) is clipped."""
    n_f = -(-F // MAX_ROWS)
    fb = -(-F // n_f)
    return min(MAX_ROWS // fb, T), fb


def conv_tile(cin: int, cout: int, relu_in: bool = False):
    """(bn, bk) of one conv from ``TILES``: the tile width for Cout <= 64,
    <= 128 or wider; K steps of ``TILES["bk_cin16"]`` channels where Cin <=
    16 on a 64-wide tile (not for relu_conv, whose A transform takes
    64-channel rows), else 64."""
    bn = TILES["bn_cout64" if cout <= 64 else "bn_cout128" if cout <= 128 else "bn_wider"]
    bk = TILES["bk_cin16"] if cin <= 16 and not relu_in and abs(bn) == 64 else 64
    return bn, bk


def _mode(w, w2) -> str:
    if w is None:
        if w2 is None:
            raise ValueError("relu_conv mode (w=None) needs w2 and b2")
        return "relu_conv"
    return "single" if w2 is None else "pair"


def _conv_plain(a: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                cd: torch.dtype) -> torch.Tensor:
    """relu(conv3x3(a, w) + b) with SAME zero padding: compute-dtype
    operands, float32 products and sums, the float32 bias, one rounding.
    a (B, T, F, Cin), w (3, 3, Cin, Cout)."""
    y = F.conv2d(a.to(cd).float().permute(0, 3, 1, 2),
                 w.to(cd).float().permute(3, 2, 0, 1), padding=1)
    return torch.relu(y + b.float()[None, :, None, None]).to(cd).permute(0, 2, 3, 1)


def conv3x3_bias_relu_plain(x: torch.Tensor, w: Optional[torch.Tensor], b: torch.Tensor,
                            w2: Optional[torch.Tensor] = None,
                            b2: Optional[torch.Tensor] = None, *,
                            compute_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """Plain PyTorch version of kernel K7, on any device, in any of the three
    modes (see the module docstring); rounds where the kernel rounds."""
    cd = compute_dtype
    mode = _mode(w, w2)
    if mode == "relu_conv":
        # relu(x + b) is zero outside the image: the conv's own zero pad
        mid = torch.relu(x.to(cd).float() + b.float()).to(cd)
        return _conv_plain(mid, w2, b2, cd)
    y = _conv_plain(x, w, b, cd)
    return y if mode == "single" else _conv_plain(y, w2, b2, cd)


def padded_channels(cin: int) -> int:
    """The kernel's input width for ``cin`` channels: the next multiple of 8
    (the stem's 7 -> 8: TMA's 16-byte row strides). Zero channels in x and
    zero rows in w make the same conv; the kernel reads a contiguous HWIO
    ``w`` tap by tap (the Pallas kernel's ``wmat`` rows (3 dt + df) Cin + c,
    conv_block.py:160-162)."""
    return -(-cin // CIN_ALIGN) * CIN_ALIGN


def _check_conv(name: str, w: torch.Tensor, b: torch.Tensor, cin: int) -> int:
    if w.dim() != 4 or tuple(w.shape[:3]) != (3, 3, cin):
        raise ValueError(f"{name}: expected (3, 3, {cin}, Cout), got {tuple(w.shape)}")
    check_cuda_tensor(name, w, torch.bfloat16)
    check_cuda_tensor("b" + name[1:], b, torch.float32, (w.shape[3],))
    if w.shape[3] % COUT_ALIGN:
        raise NotImplementedError(f"the conv block kernel takes Cout % {COUT_ALIGN} == 0 "
                                  f"(got {name} {tuple(w.shape)})")
    return w.shape[3]


def conv3x3_bias_relu(x: torch.Tensor, w: Optional[torch.Tensor], b: torch.Tensor,
                      w2: Optional[torch.Tensor] = None, b2: Optional[torch.Tensor] = None,
                      *, compute_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """The fused ConvBlock conv(s). A CPU tensor takes
    ``conv3x3_bias_relu_plain``; a CUDA tensor launches kernel K7 (one call
    runs both convs of a pair) or raises: x (B, T, F, Cin) contiguous bf16,
    weights contiguous bf16 HWIO, biases float32, every tensor 16-byte
    aligned, Cin and every output width (the pair's mid included) multiples
    of 8 (``padded_channels``: the stem's 7 channels are zero-padded to 8 by
    the caller), B T F times the widest channel count below 2^31."""
    if x.device.type == "cpu":
        return conv3x3_bias_relu_plain(x, w, b, w2, b2, compute_dtype=compute_dtype)
    mode = _mode(w, w2)
    if compute_dtype != torch.bfloat16:
        raise NotImplementedError(f"the conv block kernel computes in bf16, not {compute_dtype}")
    if x.dim() != 4:
        raise ValueError(f"x: expected (B, T, F, Cin), got {tuple(x.shape)}")
    check_cuda_tensor("x", x, torch.bfloat16)
    B, T, Fq, cin = x.shape
    if cin % CIN_ALIGN or cin == 0:
        raise NotImplementedError(f"the conv block kernel takes Cin % {CIN_ALIGN} == 0 (got "
                                  f"{cin}): pad x and w with zero channels")
    if mode == "relu_conv":
        check_cuda_tensor("b", b, torch.float32, (cin,))
        cmid = cin
    else:
        cmid = _check_conv("w", w, b, cin)
    cout = cmid if mode == "single" else _check_conv("w2", w2, b2, cmid)
    if B * T * Fq * max(cin, cmid, cout) >= MAX_M:
        raise NotImplementedError(f"the conv block kernel takes B T F x channels < 2^31 "
                                  f"(got {tuple(x.shape)} -> {cmid}, {cout})")
    for name, t in (("x", x), ("w", w), ("b", b), ("w2", w2), ("b2", b2)):
        if t is not None and t.data_ptr() % 16:
            raise ValueError(f"{name}: the conv block kernel needs 16-byte aligned tensors")
    dev = x.device
    mid = (torch.empty((B, T, Fq, cmid), device=dev, dtype=torch.bfloat16)
           if mode == "pair" else None)
    out = torch.empty((B, T, Fq, cout), device=dev, dtype=torch.bfloat16)
    tt, fb = tile_plan(T, Fq)
    bn1, bk1 = conv_tile(cin, cmid)
    bn2, bk2 = conv_tile(cmid, cout, mode == "relu_conv")
    data = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    KERNEL.launches += 1
    KERNEL.call("conv_block_forward", x.data_ptr(), data(w), b.data_ptr(), data(w2), data(b2),
                data(mid), out.data_ptr(), MODES[mode], B, T, Fq, cin, cmid, cout, tt, fb,
                bn1, bk1, bn2, bk2, TILES["stages"], int(TILES["resident"]))
    return out
