"""PANNs-style CNN backbones (CNN8 / CNN12) in PyTorch, the counterpart of the
JAX package's models/backbone.py.

Parity: reference src/models/components/backbone.py:6-61 and
model_utilities.py ConvBlock (:92-126): conv 3x3 (no bias) + BN + ReLU twice,
then avg-pool, (2, 2) x 3 then (1, 2). CNN12 is the PANNs Cnn14 conv trunk.
NCHW in and out, as the reference; the pools floor (1001 frames -> 500).
These eager modules are the plain version of the trunk; the serving path
(serving/crnn.py) runs each ConvBlock through kernel K7 (ops/conv_block.py).
"""

from typing import List, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from .common import BatchNorm2d


class ConvBlock(nn.Module):
    def __init__(self, in_channels: int, out_channels: int,
                 pool_size: Tuple[int, int] = (2, 2)):
        super().__init__()
        self.pool_size = tuple(pool_size)
        self.conv1 = nn.Conv2d(in_channels, out_channels, 3, padding=1, bias=False)
        self.bn1 = BatchNorm2d(out_channels)
        self.conv2 = nn.Conv2d(out_channels, out_channels, 3, padding=1, bias=False)
        self.bn2 = BatchNorm2d(out_channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """NCHW in and out."""
        x = F.relu(self.bn1(self.conv1(x)))
        x = F.relu(self.bn2(self.conv2(x)))
        return F.avg_pool2d(x, self.pool_size)


class CNN(nn.Module):
    """CNN8 (4 blocks) / CNN12 (6 blocks) depending on len(num_features);
    the blocks are ``conv_block1`` ... (the reference's keys)."""

    def __init__(self, in_channels: int, num_features: Sequence[int] = (32, 64, 128, 256)):
        super().__init__()
        self.num_features = tuple(num_features)
        pools = [(2, 2)] * 3 + [(1, 2)] * (len(self.num_features) - 3)
        cin = in_channels
        for i, cout in enumerate(self.num_features):
            self.add_module(f"conv_block{i + 1}", ConvBlock(cin, cout, pools[i]))
            cin = cout

    @property
    def blocks(self) -> List[ConvBlock]:
        return [getattr(self, f"conv_block{i + 1}") for i in range(len(self.num_features))]

    def run_block(self, i: int, x: torch.Tensor) -> torch.Tensor:
        """Block ``i`` alone, NCHW in and out (the EINV2 cross-stitch hook)."""
        return self.blocks[i](x)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(B, C, T, F) -> (B, C', T', F')."""
        for blk in self.blocks:
            x = blk(x)
        return x
