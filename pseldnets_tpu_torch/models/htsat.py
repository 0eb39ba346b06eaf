"""HTS-AT (hierarchical token-semantic audio transformer, Swin-style) encoder
in PyTorch, the counterpart of the JAX package's models/htsat.py.

Reimplements the reference encoder (src/models/components/htsat.py:23-568):
reshape_wav2img -> PatchEmbed 4x4/4 -> 4 BasicLayers of windowed attention with
relative-position bias, cyclic shift every other block and PatchMerging between
stages -> final LayerNorm + token-map reshape. Parameter names are the
reference torch state_dict keys. These eager modules are the plain version of
the whole encoder, in eval and in train mode; the serving path
(serving/htsat.py) and the fused training forward (train/fused_forward.py)
run each block through the kernels of ops/swin_block.py and
ops/swin_block_vjp.py instead, or, for blocks that carry AdapterBit adapters
(``adapt``, models/adapters.py), those of ops/swin_block_adapt.py.

Train mode has stochastic depth (drop-path): the per-block (B, 2) masks
come from the caller (``models.common.drop_path_masks`` draws them from an
explicit generator). With ``drop_rate`` / ``attn_drop_rate`` it has the
JAX package's dropout too, its masks from the forward's
``models.common.DropoutDraws`` in the JAX order (models/htsat.py:133-140,
:373-377; common.py:156-162): position dropout after the patch embed, then
in each block the attention weights (``attn_drop_rate``), the projection,
the MLP's two (``drop_rate``), all in ``nn.Dropout``'s form. No module
keeps random state.

``adapt`` (models/adapters.py) adds the AdapterBit bottlenecks, or with
LoRA turns qkv, proj, the MLP's fc1/fc2, the merges' reduction and the
patch embed into ``AdaptDense``/``AdaptConv`` layers; the kernels take
neither LoRA nor the eager-only adapter settings, which train and evaluate
on these modules.
"""

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from .adapters import NO_ADAPT, AdaptConfig, AdaptDense, Adapter
from .common import DropoutDraws, LayerNorm, Mlp, PatchEmbed, dropout


def window_partition(x: torch.Tensor, w: int) -> torch.Tensor:
    """(B, H, W, C) -> (B*nW, w*w, C)."""
    B, H, W, C = x.shape
    x = x.reshape(B, H // w, w, W // w, w, C).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(-1, w * w, C)


def window_reverse(windows: torch.Tensor, w: int, H: int, W: int) -> torch.Tensor:
    """(B*nW, w*w, C) -> (B, H, W, C)."""
    C = windows.shape[-1]
    B = windows.shape[0] // (H * W // w // w)
    x = windows.reshape(B, H // w, W // w, w, w, C).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(B, H, W, C)


def relative_position_index(w: int) -> np.ndarray:
    """Static (w*w, w*w) index into the (2w-1)^2 bias table (htsat.py:79-90)."""
    coords = np.stack(np.meshgrid(np.arange(w), np.arange(w), indexing="ij"))
    flat = coords.reshape(2, -1)
    rel = flat[:, :, None] - flat[:, None, :]  # (2, N, N)
    rel = rel.transpose(1, 2, 0)
    rel[:, :, 0] += w - 1
    rel[:, :, 1] += w - 1
    rel[:, :, 0] *= 2 * w - 1
    return rel.sum(-1)


def shift_attn_mask(H: int, W: int, w: int, shift: int) -> np.ndarray:
    """Static (nW, w*w, w*w) additive mask for shifted windows (htsat.py:203-222)."""
    img = np.zeros((1, H, W, 1))
    cnt = 0
    for hs in (slice(0, -w), slice(-w, -shift), slice(-shift, None)):
        for ws in (slice(0, -w), slice(-w, -shift), slice(-shift, None)):
            img[:, hs, ws, :] = cnt
            cnt += 1
    win = img.reshape(1, H // w, w, W // w, w, 1).transpose(0, 1, 3, 2, 4, 5)
    win = win.reshape(-1, w * w)
    mask = win[:, None, :] - win[:, :, None]
    return np.where(mask != 0, -100.0, 0.0).astype(np.float32)


def window_and_shift(H: int, W: int, window: int, shift: int) -> Tuple[int, int]:
    """The reference's clamp: a window that covers the whole map is not
    shifted (htsat.py:181-184)."""
    if min(H, W) <= window:
        return min(H, W), 0
    return window, shift


class WindowAttention(nn.Module):
    """W-MSA with relative position bias (htsat.py:53-148); with a
    SpatialAdapter, ``a + adapter(a)`` on the projection's output a. In
    train mode the attention weights drop out at ``attn_drop`` and the
    projection's output at ``proj_drop`` (masks from ``drops``)."""

    def __init__(self, dim: int, window_size: int, num_heads: int,
                 qkv_bias: bool = True, adapt: AdaptConfig = NO_ADAPT,
                 attn_drop: float = 0.0, proj_drop: float = 0.0):
        super().__init__()
        self.dim, self.window_size, self.num_heads = dim, window_size, num_heads
        self.attn_drop, self.proj_drop = float(attn_drop), float(proj_drop)
        self.qkv = AdaptDense(dim, 3 * dim, bias=qkv_bias, **adapt.lora_linear_args())
        self.proj = AdaptDense(dim, dim, **adapt.lora_linear_args())
        self.adapter = (Adapter(dim, **adapt.adapter_args())
                        if adapt.spatial_adapter else None)
        self.relative_position_bias_table = nn.Parameter(
            torch.zeros((2 * window_size - 1) ** 2, num_heads))
        self.register_buffer(
            "relative_position_index",
            torch.as_tensor(relative_position_index(window_size).reshape(-1)),
            persistent=False)

    def rel_bias(self) -> torch.Tensor:
        """(nh, N, N) float32 bias gathered from the table."""
        n = self.window_size ** 2
        b = self.relative_position_bias_table[self.relative_position_index]
        return b.reshape(n, n, self.num_heads).permute(2, 0, 1).float()

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None,
                drops: Optional[DropoutDraws] = None) -> torch.Tensor:
        B_, N, C = x.shape
        nh = self.num_heads
        hd = C // nh
        qkv = self.qkv(x).reshape(B_, N, 3, nh, hd).permute(2, 0, 3, 1, 4)
        q, k, v = qkv[0], qkv[1], qkv[2]  # (B_, nh, N, hd)
        attn = torch.matmul(q * hd ** -0.5, k.transpose(-1, -2))
        attn = attn + self.rel_bias()[None]
        if mask is not None:
            nW = mask.shape[0]
            attn = attn.reshape(B_ // nW, nW, nh, N, N) + mask[None, :, None]
            attn = attn.reshape(B_, nh, N, N)
        attn = torch.softmax(attn.float(), dim=-1).to(x.dtype)
        attn = dropout(attn, self.attn_drop, drops, self.training)
        x = self.proj(torch.matmul(attn, v).transpose(1, 2).reshape(B_, N, C))
        x = dropout(x, self.proj_drop, drops, self.training)
        return x if self.adapter is None else x + self.adapter(x)


class SwinTransformerBlock(nn.Module):
    """(htsat.py:152-268). ``dp_masks`` (B, 2): per-image drop-path scales
    of the attention and MLP branches, y = x + m0 * attn, out = y + m1 * mlp
    (None: the identity, as in eval). ``adapt`` adds the AdapterBit
    bottlenecks (``attn.adapter``, ``mlp.adapter``, ``mlp.adapter_ds``) or
    the LoRA terms. ``drops``: the dropout masks in train mode."""

    def __init__(self, dim: int, input_resolution: Tuple[int, int], num_heads: int,
                 window_size: int = 8, shift_size: int = 0, mlp_ratio: float = 4.0,
                 qkv_bias: bool = True, adapt: AdaptConfig = NO_ADAPT, drop: float = 0.0,
                 attn_drop: float = 0.0):
        super().__init__()
        self.dim, self.input_resolution = dim, tuple(input_resolution)
        self.num_heads = num_heads
        H, W = self.input_resolution
        self.window_size, self.shift_size = window_and_shift(H, W, window_size,
                                                             shift_size)
        self.norm1 = LayerNorm(dim)
        self.attn = WindowAttention(dim, self.window_size, num_heads, qkv_bias, adapt,
                                    attn_drop=attn_drop, proj_drop=drop)
        self.norm2 = LayerNorm(dim)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), dim, adapt, drop=drop)
        mask = (torch.as_tensor(shift_attn_mask(H, W, self.window_size,
                                                self.shift_size))
                if self.shift_size > 0 else None)
        self.register_buffer("attn_mask", mask, persistent=False)

    def forward(self, x: torch.Tensor, dp_masks: Optional[torch.Tensor] = None,
                drops: Optional[DropoutDraws] = None) -> torch.Tensor:
        H, W = self.input_resolution
        w, shift = self.window_size, self.shift_size
        B, L, C = x.shape
        shortcut = x
        h = self.norm1(x).reshape(B, H, W, C)
        if shift > 0:
            h = torch.roll(h, shifts=(-shift, -shift), dims=(1, 2))
        h = self.attn(window_partition(h, w), self.attn_mask, drops)
        h = window_reverse(h, w, H, W)
        if shift > 0:
            h = torch.roll(h, shifts=(shift, shift), dims=(1, 2))
        h = h.reshape(B, H * W, C)
        if dp_masks is None:
            x = shortcut + h
            return x + self.mlp(self.norm2(x), drops)
        m = dp_masks.to(h.dtype)
        x = shortcut + m[:, 0, None, None] * h
        return x + m[:, 1, None, None] * self.mlp(self.norm2(x), drops)


class PatchMerging(nn.Module):
    """2x2 token merge + linear reduction (htsat.py:272-311), with the
    config's LoRA term."""

    def __init__(self, input_resolution: Tuple[int, int], dim: int,
                 adapt: AdaptConfig = NO_ADAPT):
        super().__init__()
        self.input_resolution = tuple(input_resolution)
        self.norm = LayerNorm(4 * dim)
        self.reduction = AdaptDense(4 * dim, 2 * dim, bias=False, **adapt.lora_linear_args())

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        H, W = self.input_resolution
        B, L, C = x.shape
        x = x.reshape(B, H, W, C)
        x = torch.cat([x[:, 0::2, 0::2], x[:, 1::2, 0::2],
                       x[:, 0::2, 1::2], x[:, 1::2, 1::2]], dim=-1)
        return self.reduction(self.norm(x.reshape(B, -1, 4 * C)))


class BasicLayer(nn.Module):
    """One Swin stage (htsat.py:317-381)."""

    def __init__(self, dim: int, input_resolution: Tuple[int, int], depth: int,
                 num_heads: int, window_size: int, mlp_ratio: float = 4.0,
                 qkv_bias: bool = True, downsample: bool = False,
                 adapt: AdaptConfig = NO_ADAPT, drop: float = 0.0, attn_drop: float = 0.0):
        super().__init__()
        self.blocks = nn.ModuleList([
            SwinTransformerBlock(dim, input_resolution, num_heads, window_size,
                                 shift_size=0 if i % 2 == 0 else window_size // 2,
                                 mlp_ratio=mlp_ratio, qkv_bias=qkv_bias, adapt=adapt,
                                 drop=drop, attn_drop=attn_drop)
            for i in range(depth)])
        self.downsample = (PatchMerging(input_resolution, dim, adapt)
                           if downsample else None)

    def forward(self, x: torch.Tensor,
                dp_masks: Optional[Sequence[torch.Tensor]] = None,
                drops: Optional[DropoutDraws] = None) -> torch.Tensor:
        for i, blk in enumerate(self.blocks):
            x = blk(x, None if dp_masks is None else dp_masks[i], drops)
        if self.downsample is not None:
            x = self.downsample(x)
        return x


class HTSATEncoder(nn.Module):
    """Full HTS-AT encoder (htsat.py:385-568): maps a logmel(+IV) clip
    (B, C, T, mel) to the token map (B, num_features, SF, ST')."""

    def __init__(self, in_chans: int = 7, spec_size: int = 256, patch_size: int = 4,
                 patch_stride: Sequence[int] = (4, 4), embed_dim: int = 96,
                 depths: Sequence[int] = (2, 2, 6, 2),
                 num_heads: Sequence[int] = (4, 8, 16, 32), window_size: int = 8,
                 mlp_ratio: float = 4.0, qkv_bias: bool = True, mel_bins: int = 64,
                 ape: bool = False, patch_norm: bool = True, drop_rate: float = 0.0,
                 attn_drop_rate: float = 0.0, drop_path_rate: float = 0.1,
                 adapt: AdaptConfig = NO_ADAPT, **unused):
        # norm_before_mlp and use_checkpoint land in unused
        super().__init__()
        self.adapt = adapt
        if ape:
            raise NotImplementedError("absolute position embedding (ape=True)")
        self.drop_rate, self.attn_drop_rate = float(drop_rate), float(attn_drop_rate)
        self.drop_path_rate = float(drop_path_rate)
        self.spec_size, self.mel_bins = spec_size, mel_bins
        self.patch_stride = tuple(patch_stride)
        self.patch_size = patch_size
        self.embed_dim, self.depths = embed_dim, tuple(depths)
        self.num_heads, self.window_size = tuple(num_heads), window_size
        self.patch_embed = PatchEmbed((spec_size, spec_size), (patch_size, patch_size),
                                      self.patch_stride, in_chans, embed_dim,
                                      use_norm=patch_norm, adapt=adapt)
        grid = (spec_size // self.patch_stride[0], spec_size // self.patch_stride[1])
        self.layers = nn.ModuleList([
            BasicLayer(int(embed_dim * 2 ** i),
                       (grid[0] // 2 ** i, grid[1] // 2 ** i), self.depths[i],
                       self.num_heads[i], window_size, mlp_ratio, qkv_bias,
                       downsample=i < self.num_layers - 1, adapt=adapt,
                       drop=self.drop_rate, attn_drop=self.attn_drop_rate)
            for i in range(self.num_layers)])
        self.norm = LayerNorm(self.num_features)

    @property
    def num_layers(self) -> int:
        return len(self.depths)

    @property
    def num_features(self) -> int:
        return int(self.embed_dim * 2 ** (self.num_layers - 1))

    @property
    def freq_ratio(self) -> int:
        return self.spec_size // self.mel_bins

    @property
    def time_res(self) -> int:
        """STFT frames per output token (= patch_stride_t * 2^(stages-1))."""
        return self.patch_stride[1] * 2 ** (self.num_layers - 1)

    @property
    def SF(self) -> int:
        return (self.spec_size // (2 ** (self.num_layers - 1))
                // self.patch_stride[0] // self.freq_ratio)

    def reshape_wav2img(self, x: torch.Tensor) -> torch.Tensor:
        """(B, C, T, F) -> (B, C, r*F, T'/r) image (htsat.py:493-511)."""
        r = self.freq_ratio
        target_T = self.spec_size * r
        B, C, T, Fq = x.shape
        if T > target_T:
            raise ValueError(f"clip too long: {T} > {target_T}")
        x = F.pad(x, (0, 0, 0, target_T - T)).transpose(2, 3)  # (B, C, F, T')
        x = x.reshape(B, C, Fq, r, target_T // r).transpose(2, 3)
        return x.reshape(B, C, r * Fq, target_T // r)

    def embed(self, x: torch.Tensor, drops: Optional[DropoutDraws] = None) -> torch.Tensor:
        """reshape_wav2img + the patch embed + position dropout (train
        mode, ``drop_rate``): (B, C, T, F) -> stage-0 tokens (the
        reference's forward_patch, htsat.py:547-553 with pos_drop)."""
        x = self.patch_embed(self.reshape_wav2img(x))
        return dropout(x, self.drop_rate, drops, self.training)

    def run_stage(self, i: int, x: torch.Tensor,
                  dp_masks: Optional[Sequence[torch.Tensor]] = None,
                  drops: Optional[DropoutDraws] = None) -> torch.Tensor:
        """Stage ``i``'s blocks and its PatchMerging; ``dp_masks``: one (B, 2)
        mask per block of the stage, ``drops`` the dropout masks (train
        mode)."""
        return self.layers[i](x, dp_masks, drops)

    def stage_masks(self, dp_masks: Optional[Sequence[torch.Tensor]]
                    ) -> List[Optional[Sequence[torch.Tensor]]]:
        """One flat list of per-block masks split by stage (None: None for
        every stage)."""
        if dp_masks is None:
            return [None] * self.num_layers
        ends = np.cumsum(self.depths)
        return [dp_masks[e - d:e] for d, e in zip(self.depths, ends)]

    def finalize(self, x: torch.Tensor) -> torch.Tensor:
        """norm + token-map reshape with frequency unfolding
        (= reference forward_reshape, htsat.py:555-568)."""
        return self.token_map(self.norm(x))

    def token_map(self, x: torch.Tensor) -> torch.Tensor:
        """(B, N, C) normed tokens -> (B, C, SF/fr, ST*fr) token map."""
        B, N, C = x.shape
        SF = self.spec_size // (2 ** (self.num_layers - 1)) // self.patch_stride[0]
        ST = self.spec_size // (2 ** (self.num_layers - 1)) // self.patch_stride[1]
        x = x.transpose(1, 2).reshape(B, C, SF, ST)
        c_freq_bin = SF // self.freq_ratio
        x = x.reshape(B, C, SF // c_freq_bin, c_freq_bin, ST).transpose(2, 3)
        return x.reshape(B, C, c_freq_bin, -1)

    def block_rates(self) -> List[float]:
        """Drop-path rate of every block in order: linspace(0, rate, blocks)
        (reference htsat.py:446-447)."""
        return [float(r) for r in np.linspace(0, self.drop_path_rate, sum(self.depths))]

    def forward(self, x: torch.Tensor,
                dp_masks: Optional[Sequence[torch.Tensor]] = None,
                drops: Optional[DropoutDraws] = None) -> torch.Tensor:
        """``dp_masks``: one (B, 2) mask per block, in order; ``drops``: the
        dropout masks (train mode)."""
        x = self.embed(x, drops)
        for i, masks in enumerate(self.stage_masks(dp_masks)):
            x = self.run_stage(i, x, masks, drops)
        return self.finalize(x)
