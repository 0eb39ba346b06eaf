"""PaSST (a ViT with decomposed time/frequency position embeddings) encoder in
PyTorch, the counterpart of the JAX package's models/passt.py, in eval form.

Reimplements the reference encoder (src/models/components/passt.py:50-380):
PatchEmbed 16x16 stride 10 on the (B, C, F, T) map -> time and frequency
position embeddings added on the (E, F', T') map -> cls + dist tokens with
their position embedding -> plain pre-LN ViT blocks -> final LayerNorm ->
frequency mean of the token map -> ``head`` (LayerNorm, Identity).
Parameter names are the reference torch state_dict keys. These eager modules
are the plain version of the whole encoder; the serving path
(serving/passt.py) runs each block through kernel K6 (ops/vit_block.py).

Eval only: training's random time-pos-embed crop, the three patchout forms,
position dropout and drop-path are not ported, and a train-mode forward
raises (ROADMAP.md queue A step 8).
"""

from typing import Tuple

import torch
import torch.nn as nn

from .common import LayerNorm, Mlp, PatchEmbed

LN_EPS = 1e-6  # timm ViT's LayerNorm eps

TRAIN_NOT_PORTED = ("PaSST training (the random time-pos-embed crop, patchout, "
                    "position dropout, drop-path) is not ported yet "
                    "(ROADMAP.md queue A step 8)")


class Attention(nn.Module):
    """Plain ViT attention (passt.py:50-82): q scaled by D^-0.5 before
    Q K^T, scores and softmax in float32."""

    def __init__(self, dim: int, num_heads: int = 12, qkv_bias: bool = True):
        super().__init__()
        self.num_heads = num_heads
        self.qkv = nn.Linear(dim, 3 * dim, bias=qkv_bias)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, N, C = x.shape
        H = self.num_heads
        D = C // H
        qkv = self.qkv(x).reshape(B, N, 3, H, D).permute(2, 0, 3, 1, 4)
        q, k, v = qkv[0], qkv[1], qkv[2]
        attn = torch.matmul((q * D ** -0.5).float(), k.float().transpose(-1, -2))
        attn = torch.softmax(attn, dim=-1).to(x.dtype)
        x = torch.matmul(attn, v).transpose(1, 2).reshape(B, N, C)
        return self.proj(x)


class Block(nn.Module):
    """Pre-LN ViT block: x + attn(norm1 x), then + mlp(norm2 x), eps 1e-6."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 4.0,
                 qkv_bias: bool = True):
        super().__init__()
        self.dim, self.num_heads = dim, num_heads
        self.norm1 = LayerNorm(dim, eps=LN_EPS)
        self.attn = Attention(dim, num_heads, qkv_bias)
        self.norm2 = LayerNorm(dim, eps=LN_EPS)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.attn(self.norm1(x))
        return x + self.mlp(self.norm2(x))


class PaSSTEncoder(nn.Module):
    def __init__(self, in_chans: int = 7, u_patchout: int = 0, s_patchout_t: int = 0,
                 s_patchout_f: int = 0, img_size: Tuple[int, int] = (64, 1001),
                 patch_size: int = 16, stride: int = 10, embed_dim: int = 768,
                 depth: int = 7, num_heads: int = 12, mlp_ratio: float = 4.0,
                 qkv_bias: bool = True, distilled: bool = True, drop_rate: float = 0.0,
                 drop_path_rate: float = 0.0):
        super().__init__()
        # the patchout forms and the two rates act only in training: taken so
        # a configuration builds; a train-mode forward raises
        self.img_size = tuple(img_size)
        self.stride, self.embed_dim, self.distilled = stride, embed_dim, distilled
        self.patch_embed = PatchEmbed(self.img_size, (patch_size, patch_size),
                                      (stride, stride), in_chans, embed_dim,
                                      use_norm=False, flatten=False)
        Fg, Tg = self.grid_size
        self.cls_token = nn.Parameter(torch.zeros(1, 1, embed_dim))
        self.dist_token = nn.Parameter(torch.zeros(1, 1, embed_dim)) if distilled else None
        self.new_pos_embed = nn.Parameter(torch.zeros(1, self.num_tokens, embed_dim))
        self.freq_new_pos_embed = nn.Parameter(torch.zeros(1, embed_dim, Fg, 1))
        self.time_new_pos_embed = nn.Parameter(torch.zeros(1, embed_dim, 1, Tg))
        self.blocks = nn.ModuleList(Block(embed_dim, num_heads, mlp_ratio, qkv_bias)
                                    for _ in range(depth))
        self.norm = LayerNorm(embed_dim, eps=LN_EPS)
        # the reference's head: Sequential(LayerNorm, Identity) on the token map
        self.head = nn.Sequential(LayerNorm(embed_dim, eps=LN_EPS), nn.Identity())

    @property
    def grid_size(self) -> Tuple[int, int]:
        return (self.img_size[0] // self.stride, self.img_size[1] // self.stride)

    @property
    def num_tokens(self) -> int:
        return 2 if self.distilled else 1

    @property
    def num_features(self) -> int:
        return self.embed_dim

    def prefix_tokens(self, dtype: torch.dtype) -> torch.Tensor:
        """(1, num_tokens, E): cls (and dist) plus their position embedding,
        each operand and the sum in ``dtype``."""
        npe = self.new_pos_embed.to(dtype)
        toks = [self.cls_token.to(dtype) + npe[:, :1]]
        if self.distilled:
            toks.append(self.dist_token.to(dtype) + npe[:, 1:])
        return torch.cat(toks, dim=1)

    def add_pos_embed(self, x: torch.Tensor) -> torch.Tensor:
        """(B, E, F', T') patch map -> (B, num_tokens + F'T', E) tokens: the
        eval time pos-embed (its first T' columns) and the frequency one
        added in the map's dtype, flattened, the prefix tokens in front."""
        B, _, _, Tg = x.shape
        x = x + self.time_new_pos_embed[..., :Tg].to(x.dtype)
        x = x + self.freq_new_pos_embed.to(x.dtype)
        x = x.flatten(2).transpose(1, 2)
        pre = self.prefix_tokens(x.dtype).expand(B, -1, -1)
        return torch.cat([pre, x], dim=1)

    def forward_before(self, x: torch.Tensor) -> torch.Tensor:
        """(B, C, T, F) -> (B, num_tokens + F'T', E)."""
        if self.training:
            raise NotImplementedError(TRAIN_NOT_PORTED)
        return self.add_pos_embed(self.patch_embed(x.transpose(2, 3)))

    def run_block(self, i: int, x: torch.Tensor) -> torch.Tensor:
        """Block ``i`` alone (the EINV2 cross-stitch hook)."""
        return self.blocks[i](x)

    def token_map(self, x: torch.Tensor) -> torch.Tensor:
        """Normed tokens (B, num_tokens + F'T', E) -> the frequency mean of
        the token map (B, T', E)."""
        fm = x[:, self.num_tokens:]
        B, N, E = fm.shape
        Fg = self.grid_size[0]
        return fm.transpose(1, 2).reshape(B, E, Fg, N // Fg).mean(dim=2).transpose(1, 2)

    def forward_after(self, x: torch.Tensor) -> torch.Tensor:
        """-> head(token map) (B, T', E). The cls/dist feature the JAX
        package also returns has no consumer on this eval path."""
        return self.head(self.token_map(self.norm(x)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.forward_before(x)
        for i in range(len(self.blocks)):
            h = self.run_block(i, h)
        return self.forward_after(h)
