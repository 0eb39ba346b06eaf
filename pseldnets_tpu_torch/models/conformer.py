"""Conformer blocks in PyTorch (the decoder of the CNN backbones), the
counterpart of the JAX package's models/conformer.py.

Parity: reference src/models/components/conformer/* (sooftware/conformer):
macaron half-step FFN, Transformer-XL relative MHSA with u/v biases and the
relative shift, the depthwise-conv module (pointwise -> GLU -> depthwise k=31
-> BN -> SiLU -> pointwise), half-step FFN, final LayerNorm. Module and
parameter names are the reference's torch keys (the JAX package's
train/checkpoint.py ``_CONFORMER_MAP``): each block is ``sequential`` of
five residual modules and a LayerNorm, the pointwise convs are
``Conv1d(k=1)`` and the depthwise one ``Conv1d(groups=C)``. The reference's
positional-encoding buffer is computed on the fly, not stored.

In train mode each block draws its dropout (rate 0.1, not a config key, as
in the JAX ConformerBlock) at seven sites from the forward's
``models.common.DropoutDraws``, in the JAX package's order: the first
feed-forward module's two (after the SiLU, after fc2), the attention
weights, the attention module's output, the conv module's output, the
second feed-forward module's two; each in ``nn.Dropout``'s form. Eval
ignores dropout.
"""

import math
from typing import Optional

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from .common import DropoutDraws, TorchBatchNorm, dropout


def sinusoid_position_encoding(length: int, d_model: int) -> np.ndarray:
    pos = np.arange(length, dtype=np.float64)[:, None]
    div = np.exp(np.arange(0, d_model, 2, dtype=np.float64) * -(math.log(10000.0) / d_model))
    pe = np.zeros((length, d_model), np.float32)
    pe[:, 0::2] = np.sin(pos * div)
    pe[:, 1::2] = np.cos(pos * div)
    return pe


def relative_shift(pos: torch.Tensor) -> torch.Tensor:
    """Transformer-XL shift of (B, H, T, T) scores: left-pad a zero column,
    fold to (T + 1, T), drop the first row (reference attention.py:107-117)."""
    B, H, T, S = pos.shape
    padded = torch.cat([pos.new_zeros(B, H, T, 1), pos], dim=-1)
    return padded.reshape(B, H, S + 1, T)[:, :, 1:].reshape(B, H, T, S)


class Residual(nn.Module):
    """x + factor * module(x) (the reference's ResidualConnectionModule)."""

    def __init__(self, module: nn.Module, factor: float = 1.0):
        super().__init__()
        self.module = module
        self.factor = factor

    def forward(self, x: torch.Tensor, drops: Optional[DropoutDraws] = None) -> torch.Tensor:
        return x + self.factor * self.module(x, drops)


class FeedForwardModule(nn.Module):
    def __init__(self, dim: int, expansion: int = 4, dropout: float = 0.1):
        super().__init__()
        self.dropout = dropout
        self.sequential = nn.Sequential(
            nn.LayerNorm(dim, eps=1e-5), nn.Linear(dim, dim * expansion), nn.SiLU(),
            nn.Dropout(dropout), nn.Linear(dim * expansion, dim), nn.Dropout(dropout))

    def forward(self, x: torch.Tensor, drops: Optional[DropoutDraws] = None) -> torch.Tensor:
        """LayerNorm -> fc1 -> SiLU -> dropout -> fc2 -> dropout (the
        ``sequential``'s Dropout entries, indices 3 and 5, hold no
        parameters: the drawn masks apply in their places)."""
        s = self.sequential
        h = dropout(F.silu(s[1](s[0](x))), self.dropout, drops, self.training)
        return dropout(s[4](h), self.dropout, drops, self.training)


class RelativeMultiHeadAttention(nn.Module):
    """Transformer-XL relative MHSA (reference attention.py:28-117): scores
    (content + shifted position) / sqrt(d_model), float32 softmax."""

    def __init__(self, d_model: int, num_heads: int, dropout: float = 0.1):
        super().__init__()
        self.d_model, self.num_heads, self.dropout = d_model, num_heads, dropout
        D = d_model // num_heads
        self.query_proj = nn.Linear(d_model, d_model)
        self.key_proj = nn.Linear(d_model, d_model)
        self.value_proj = nn.Linear(d_model, d_model)
        self.pos_proj = nn.Linear(d_model, d_model, bias=False)
        self.out_proj = nn.Linear(d_model, d_model)
        self.u_bias = nn.Parameter(torch.zeros(num_heads, D))
        self.v_bias = nn.Parameter(torch.zeros(num_heads, D))

    def forward(self, x: torch.Tensor, pos_emb: torch.Tensor,
                drops: Optional[DropoutDraws] = None) -> torch.Tensor:
        B, T, _ = x.shape
        H = self.num_heads
        D = self.d_model // H
        q = self.query_proj(x).reshape(B, T, H, D)
        k = self.key_proj(x).reshape(B, T, H, D)
        v = self.value_proj(x).reshape(B, T, H, D)
        p = self.pos_proj(pos_emb).reshape(1, T, H, D)
        content = torch.einsum("bthd,bshd->bhts", (q + self.u_bias.to(q.dtype)).float(),
                               k.float())
        pos = torch.einsum("bthd,zshd->bhts", (q + self.v_bias.to(q.dtype)).float(), p.float())
        score = (content + relative_shift(pos)) / math.sqrt(self.d_model)
        attn = torch.softmax(score, dim=-1).to(x.dtype)
        attn = dropout(attn, self.dropout, drops, self.training)
        ctx = torch.einsum("bhts,bshd->bthd", attn, v).reshape(B, T, self.d_model)
        return self.out_proj(ctx)


class MultiHeadedSelfAttentionModule(nn.Module):
    """LayerNorm -> relative MHSA with the sinusoid table of the sequence ->
    dropout (the JAX ConformerBlock's, conformer.py:141-142)."""

    def __init__(self, d_model: int, num_heads: int, dropout: float = 0.1):
        super().__init__()
        self.dropout = dropout
        self.layer_norm = nn.LayerNorm(d_model, eps=1e-5)
        self.attention = RelativeMultiHeadAttention(d_model, num_heads, dropout)

    def forward(self, x: torch.Tensor, drops: Optional[DropoutDraws] = None) -> torch.Tensor:
        B, T, C = x.shape
        pos = torch.as_tensor(sinusoid_position_encoding(T, C), device=x.device).to(x.dtype)
        h = self.attention(self.layer_norm(x), pos[None], drops)
        return dropout(h, self.dropout, drops, self.training)


class PointwiseConv1d(nn.Module):
    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.conv = nn.Conv1d(cin, cout, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(B, T, Cin) -> (B, T, Cout)."""
        return F.linear(x, self.conv.weight[:, :, 0], self.conv.bias)


class DepthwiseConv1d(nn.Module):
    def __init__(self, dim: int, kernel_size: int):
        super().__init__()
        self.conv = nn.Conv1d(dim, dim, kernel_size, padding=(kernel_size - 1) // 2,
                              groups=dim, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(B, T, C) -> (B, T, C), SAME padding."""
        return self.conv(x.transpose(1, 2)).transpose(1, 2)


class GLU(nn.Module):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        a, b = x.chunk(2, dim=-1)
        return a * torch.sigmoid(b)


class ConformerConvModule(nn.Module):
    """Reference convolution.py ConformerConvModule; ``sequential`` indices
    follow the reference (1 is its transpose, here the identity, since the
    port keeps (B, T, C))."""

    def __init__(self, dim: int, kernel_size: int = 31, dropout: float = 0.1):
        super().__init__()
        self.dropout = dropout
        self.sequential = nn.Sequential(
            nn.LayerNorm(dim, eps=1e-5), nn.Identity(), PointwiseConv1d(dim, 2 * dim), GLU(),
            DepthwiseConv1d(dim, kernel_size), TorchBatchNorm((dim,), reduce_axes=(0, 1)),
            nn.SiLU(), PointwiseConv1d(dim, dim), nn.Dropout(dropout))

    def forward(self, x: torch.Tensor, drops: Optional[DropoutDraws] = None) -> torch.Tensor:
        """The ``sequential`` up to its last Dropout (index 8), then the
        drawn mask in its place."""
        return dropout(self.sequential[:8](x), self.dropout, drops, self.training)


class ConformerBlock(nn.Module):
    def __init__(self, encoder_dim: int, num_heads: int = 8, ffn_expansion: int = 4,
                 conv_kernel_size: int = 31, dropout: float = 0.1):
        super().__init__()
        self.sequential = nn.Sequential(
            Residual(FeedForwardModule(encoder_dim, ffn_expansion, dropout), 0.5),
            Residual(MultiHeadedSelfAttentionModule(encoder_dim, num_heads, dropout)),
            Residual(ConformerConvModule(encoder_dim, conv_kernel_size, dropout)),
            Residual(FeedForwardModule(encoder_dim, ffn_expansion, dropout), 0.5),
            nn.LayerNorm(encoder_dim, eps=1e-5))

    def forward(self, x: torch.Tensor, drops: Optional[DropoutDraws] = None) -> torch.Tensor:
        for residual in self.sequential[:4]:
            x = residual(x, drops)
        return self.sequential[4](x)


class ConformerBlocks(nn.Module):
    def __init__(self, encoder_dim: int, num_layers: int = 2, num_heads: int = 8):
        super().__init__()
        self.layers = nn.ModuleList(ConformerBlock(encoder_dim, num_heads)
                                    for _ in range(num_layers))

    def forward(self, x: torch.Tensor, drops: Optional[DropoutDraws] = None) -> torch.Tensor:
        """``drops``: the blocks' dropout masks in train mode (seven a
        block)."""
        for layer in self.layers:
            x = layer(x, drops)
        return x
