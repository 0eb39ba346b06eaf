"""PaSST (a ViT with decomposed time/frequency position embeddings) encoder in
PyTorch, the counterpart of the JAX package's models/passt.py.

Reimplements the reference encoder (src/models/components/passt.py:50-380):
PatchEmbed 16x16 stride 10 on the (B, C, F, T) map -> time and frequency
position embeddings added on the (E, F', T') map -> cls + dist tokens with
their position embedding -> plain pre-LN ViT blocks -> final LayerNorm ->
frequency mean of the token map -> ``head`` (LayerNorm, Identity).
Parameter names are the reference torch state_dict keys. These eager modules
are the plain version of the whole encoder; the serving path
(serving/passt.py) runs each block through kernel K6 (ops/vit_block.py).

Train mode (the JAX package's forward_before(train=True), :136-189, and
its DropPath blocks) is split as the augmentations are: ``draw`` takes the
random choices from an explicit generator (``PatchoutDraws``: the
time-pos-embed crop, the sorted time, frequency and token keep-sets of the
three patchout forms, the position-dropout mask), then a deterministic
apply; the blocks take one (B, 2) drop-path mask each
(``models.common.drop_path_masks``). No module keeps random state. Time
patchout shrinks the output frames and a token patchout that leaves a
count not divisible by the frequency rows raises, as in the JAX package.
"""

from dataclasses import dataclass
from typing import List, Optional, Tuple

import torch
import torch.nn as nn

from ..parallel import batch_rows
from .common import LayerNorm, Mlp, PatchEmbed, drop_path

LN_EPS = 1e-6  # timm ViT's LayerNorm eps


@dataclass
class PatchoutDraws:
    """One encoder's train-mode draws (``PaSSTEncoder.draw``), None where
    the setting takes none: ``offset`` the time-pos-embed crop's start (a
    0-d long tensor), ``keep_t``/``keep_f``/``keep_u`` the sorted kept time
    columns, frequency rows and tokens, ``pos_keep`` the (B, num_tokens +
    N, E) position-dropout mask (True: kept, scaled by 1 / (1 -
    drop_rate))."""

    offset: Optional[torch.Tensor] = None
    keep_t: Optional[torch.Tensor] = None
    keep_f: Optional[torch.Tensor] = None
    keep_u: Optional[torch.Tensor] = None
    pos_keep: Optional[torch.Tensor] = None


def _keep_set(generator: torch.Generator, n: int, drop: int, device) -> torch.Tensor:
    """The sorted first n - drop entries of a random permutation of n (the
    JAX package's sort(permutation(key, n)[:keep]))."""
    perm = torch.randperm(n, generator=generator, device=device)
    return perm[:n - drop].sort().values


class Attention(nn.Module):
    """Plain ViT attention (passt.py:50-82): q scaled by D^-0.5 before
    Q K^T, scores and softmax in float32."""

    def __init__(self, dim: int, num_heads: int = 12, qkv_bias: bool = True):
        super().__init__()
        self.num_heads = num_heads
        self.head_dim = dim // num_heads
        self.qkv = nn.Linear(dim, 3 * dim, bias=qkv_bias)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, N, C = x.shape
        D = self.head_dim
        # all the heads, or split by heads (parallel/tp.py) this rank's
        qkv = self.qkv(x).reshape(B, N, 3, -1, D).permute(2, 0, 3, 1, 4)
        q, k, v = qkv[0], qkv[1], qkv[2]
        attn = torch.matmul((q * D ** -0.5).float(), k.float().transpose(-1, -2))
        attn = torch.softmax(attn, dim=-1).to(x.dtype)
        x = torch.matmul(attn, v).transpose(1, 2).reshape(B, N, -1)
        return self.proj(x)


class Block(nn.Module):
    """Pre-LN ViT block: x + attn(norm1 x), then + mlp(norm2 x), eps 1e-6.
    In train mode ``dp_mask`` (B, 2) drops each branch per sample at the
    block's ``drop_path_rate`` (attention branch, MLP branch)."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 4.0,
                 qkv_bias: bool = True, drop_path_rate: float = 0.0):
        super().__init__()
        self.dim, self.num_heads = dim, num_heads
        self.drop_path_rate = float(drop_path_rate)
        self.norm1 = LayerNorm(dim, eps=LN_EPS)
        self.attn = Attention(dim, num_heads, qkv_bias)
        self.norm2 = LayerNorm(dim, eps=LN_EPS)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), dim)

    def forward(self, x: torch.Tensor, dp_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        if dp_mask is None or not self.drop_path_rate:
            x = x + self.attn(self.norm1(x))
            return x + self.mlp(self.norm2(x))
        x = x + drop_path(self.attn(self.norm1(x)), dp_mask[:, 0], self.drop_path_rate)
        return x + drop_path(self.mlp(self.norm2(x)), dp_mask[:, 1], self.drop_path_rate)


class PaSSTEncoder(nn.Module):
    def __init__(self, in_chans: int = 7, u_patchout: int = 0, s_patchout_t: int = 0,
                 s_patchout_f: int = 0, img_size: Tuple[int, int] = (64, 1001),
                 patch_size: int = 16, stride: int = 10, embed_dim: int = 768,
                 depth: int = 7, num_heads: int = 12, mlp_ratio: float = 4.0,
                 qkv_bias: bool = True, distilled: bool = True, drop_rate: float = 0.0,
                 drop_path_rate: float = 0.0):
        super().__init__()
        self.img_size = tuple(img_size)
        self.stride, self.embed_dim, self.distilled = stride, embed_dim, distilled
        self.u_patchout, self.s_patchout_t = int(u_patchout), int(s_patchout_t)
        self.s_patchout_f = int(s_patchout_f)
        self.drop_rate, self.drop_path_rate = float(drop_rate), float(drop_path_rate)
        self.patch_embed = PatchEmbed(self.img_size, (patch_size, patch_size),
                                      (stride, stride), in_chans, embed_dim,
                                      use_norm=False, flatten=False)
        Fg, Tg = self.grid_size
        self.cls_token = nn.Parameter(torch.zeros(1, 1, embed_dim))
        self.dist_token = nn.Parameter(torch.zeros(1, 1, embed_dim)) if distilled else None
        self.new_pos_embed = nn.Parameter(torch.zeros(1, self.num_tokens, embed_dim))
        self.freq_new_pos_embed = nn.Parameter(torch.zeros(1, embed_dim, Fg, 1))
        self.time_new_pos_embed = nn.Parameter(torch.zeros(1, embed_dim, 1, Tg))
        # drop-path rate drop_path_rate * i / max(depth - 1, 1) at block i
        rates = [self.drop_path_rate * i / max(depth - 1, 1) for i in range(depth)]
        self.blocks = nn.ModuleList(Block(embed_dim, num_heads, mlp_ratio, qkv_bias, rate)
                                    for rate in rates)
        self.norm = LayerNorm(embed_dim, eps=LN_EPS)
        # the reference's head: Sequential(LayerNorm, Identity) on the token map
        self.head = nn.Sequential(LayerNorm(embed_dim, eps=LN_EPS), nn.Identity())

    @property
    def grid_size(self) -> Tuple[int, int]:
        return (self.img_size[0] // self.stride, self.img_size[1] // self.stride)

    @property
    def patch_grid(self) -> Tuple[int, int]:
        """The patch-embed conv's (F', T') on an img_size input; T' can be
        narrower than the time position embedding (an odd patch - stride),
        which leaves the train-mode crop room."""
        conv = self.patch_embed.proj
        return tuple((n + 2 * p - k) // s + 1 for n, p, k, s in
                     zip(self.img_size, conv.padding, conv.kernel_size, conv.stride))

    @property
    def crop_room(self) -> int:
        """How many offsets the train-mode time-pos-embed crop can take:
        1 + the pos-embed's columns - the conv's (1: always offset 0)."""
        return 1 + self.grid_size[1] - self.patch_grid[1]

    @property
    def num_tokens(self) -> int:
        return 2 if self.distilled else 1

    @property
    def num_features(self) -> int:
        return self.embed_dim

    def block_rates(self) -> List[float]:
        """Each block's drop-path rate: drop_path_rate * i / max(depth - 1,
        1) (the JAX package's models/passt.py:122-125)."""
        return [blk.drop_path_rate for blk in self.blocks]

    def draw(self, generator: Optional[torch.Generator], B: int, device=None) -> PatchoutDraws:
        """The train-mode draws of a batch of B, in the JAX package's order
        (models/passt.py:142-188): the crop's offset in [0, 1 + T_grid -
        T'), the time, frequency and token keep-sets, the position-dropout
        mask. Settings that draw nothing leave their entry None (a crop
        with no room is offset 0); a generator is needed only where
        something is drawn. Under data parallelism the position-dropout
        mask is this rank's rows of the global batch's
        (``parallel.batch_rows``); the others have no batch axis and are
        the same on every rank."""
        Fg, Tg = self.patch_grid
        room = self.crop_room
        kept_t, kept_f = Tg - self.s_patchout_t, Fg - self.s_patchout_f
        N = kept_t * kept_f - self.u_patchout
        if generator is None and (room > 1 or self.s_patchout_t or self.s_patchout_f
                                  or self.u_patchout or self.drop_rate > 0):
            raise ValueError("train mode with a random crop, patchout or position dropout "
                             "needs patchout draws or a generator")
        d = PatchoutDraws()
        if room > 1:
            d.offset = torch.randint(0, room, (), generator=generator, device=device)
        if self.s_patchout_t:
            d.keep_t = _keep_set(generator, Tg, self.s_patchout_t, device)
        if self.s_patchout_f:
            d.keep_f = _keep_set(generator, Fg, self.s_patchout_f, device)
        if self.u_patchout:
            d.keep_u = _keep_set(generator, kept_t * kept_f, self.u_patchout, device)
        if self.drop_rate > 0:
            shape = (self.num_tokens + N, self.embed_dim)
            d.pos_keep = batch_rows(lambda n: torch.rand((n,) + shape, generator=generator,
                                                         device=device), B) < (
                1.0 - self.drop_rate)
        return d

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

    def add_pos_embed_train(self, x: torch.Tensor, d: PatchoutDraws) -> torch.Tensor:
        """The train-mode counterpart of ``add_pos_embed`` on the draws
        ``d`` (the JAX package's models/passt.py:142-188): the time
        pos-embed cropped at ``d.offset``, then time and frequency patchout
        on the map, flattened, token patchout, the prefix tokens, then
        position dropout (x / keep where kept, 0 elsewhere, in the map's
        dtype)."""
        self.check_draws(d)
        B, _, _, Tg = x.shape
        tpe = self.time_new_pos_embed.to(x.dtype)
        if d.offset is None:
            tpe = tpe[..., :Tg]
        else:
            tpe = tpe.index_select(3, d.offset + torch.arange(Tg, device=d.offset.device))
        x = x + tpe
        x = x + self.freq_new_pos_embed.to(x.dtype)
        if d.keep_t is not None:
            x = x.index_select(3, d.keep_t)
        if d.keep_f is not None:
            x = x.index_select(2, d.keep_f)
        x = x.flatten(2).transpose(1, 2)
        if d.keep_u is not None:
            x = x.index_select(1, d.keep_u)
        pre = self.prefix_tokens(x.dtype).expand(B, -1, -1)
        x = torch.cat([pre, x], dim=1)
        if d.pos_keep is not None:
            x = torch.where(d.pos_keep, x / (1.0 - self.drop_rate), torch.zeros_like(x))
        return x

    def check_draws(self, d: PatchoutDraws) -> None:
        """Every setting that draws has its draw (the crop's offset where
        the crop has room)."""
        for name, need in (("offset", self.crop_room > 1), ("keep_t", self.s_patchout_t),
                           ("keep_f", self.s_patchout_f), ("keep_u", self.u_patchout),
                           ("pos_keep", self.drop_rate > 0)):
            if need and getattr(d, name) is None:
                raise ValueError(f"PaSST patchout draws lack {name}, which this encoder's "
                                 "settings draw")

    def forward_before(self, x: torch.Tensor,
                       draws: Optional[PatchoutDraws] = None) -> torch.Tensor:
        """(B, C, T, F) -> (B, num_tokens + N, E); in train mode on
        ``draws`` (``draw``'s), which train mode needs even where nothing is
        drawn."""
        if self.training and draws is None:
            raise ValueError("a train-mode PaSST encoder needs its patchout draws "
                             "(PaSSTEncoder.draw)")
        x = self.patch_embed(x.transpose(2, 3))
        if not self.training:
            return self.add_pos_embed(x)
        return self.add_pos_embed_train(x, draws)

    def run_block(self, i: int, x: torch.Tensor,
                  dp_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Block ``i`` alone (the EINV2 cross-stitch hook)."""
        return self.blocks[i](x, dp_mask)

    @property
    def freq_rows(self) -> int:
        """The token map's frequency rows: the grid's, less the rows that
        frequency patchout drops in train mode (the JAX package's
        models/passt.py:195-196)."""
        return self.grid_size[0] - (self.s_patchout_f if self.training else 0)

    def token_map(self, x: torch.Tensor, freq_rows: Optional[int] = None) -> torch.Tensor:
        """Normed tokens (B, num_tokens + N, E) -> the frequency mean of
        the token map (B, N / F'', E), F'' = ``freq_rows`` (the eval grid's
        by default). N must be a multiple of F'' (a token patchout that
        leaves another count fails in the JAX package's reshape too)."""
        fm = x[:, self.num_tokens:]
        B, N, E = fm.shape
        Fg = self.grid_size[0] if freq_rows is None else freq_rows
        if N % Fg:
            raise ValueError(f"{N} tokens do not fill a token map of {Fg} frequency rows "
                             f"(u_patchout={self.u_patchout} must leave a multiple of them)")
        return fm.transpose(1, 2).reshape(B, E, Fg, N // Fg).mean(dim=2).transpose(1, 2)

    def forward_after(self, x: torch.Tensor) -> torch.Tensor:
        """-> head(token map) (B, T'', E). The cls/dist feature the JAX
        package also returns has no consumer in the SELD heads."""
        return self.head(self.token_map(self.norm(x), self.freq_rows))

    def forward(self, x: torch.Tensor, draws: Optional[PatchoutDraws] = None,
                dp_masks: Optional[List[torch.Tensor]] = None) -> torch.Tensor:
        """``draws`` and ``dp_masks`` (one (B, 2) mask a block) in train
        mode."""
        h = self.forward_before(x, draws)
        for i in range(len(self.blocks)):
            h = self.run_block(i, h, None if dp_masks is None else dp_masks[i])
        return self.forward_after(h)
