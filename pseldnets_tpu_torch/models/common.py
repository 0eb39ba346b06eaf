"""Shared model plumbing in PyTorch, the counterpart of the JAX package's
models/common.py: BatchNorm with torch semantics (per-channel "scalar" BN,
BatchNorm2d), the ViT Mlp, PatchEmbed and drop-path, dropout from drawn
keep-masks (``DropoutDraws``), the EINV2 CrossStitch, the GRU / transformer
/ conformer sequence decoders, and the time-axis interpolate used by every
head.

Parity targets: reference src/models/components/model_utilities.py
(CrossStitch :35-54, Mlp :129-171, PatchEmbed :174-213, DropPath :216-242,
Decoder :245-269) and
src/models/components/utils.py (interpolate :25-52).
"""

import math
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..parallel import all_reduce_sum, batch_rows, world
from .adapters import NO_ADAPT, AdaptConfig, AdaptConv, AdaptDense, Adapter

NO_DECODER = (None, "None", "null", "identity")


class DropoutDraws:
    """A train-mode forward's dropout keep-masks, taken by its dropout sites
    in call order (``keep``): the injected ``masks`` one after the other
    (bool, True where kept; a test feeds the JAX package's draws in that
    package's order), or else Bernoulli(keep) masks drawn on the device
    from ``generator``, never from the global generator. No module keeps
    random state.

    ``batch`` is the forward's batch B: a site's leading axis holds B clips
    (times windows, clip-major). Under data parallelism a drawn mask with
    that axis comes through ``parallel.batch_rows``: every rank draws the
    global batch's mask and keeps its own clips' rows. A mask without a
    batch axis (flax's (1, 1, T, S) attention-weights mask) is the same on
    every rank, from the shared seed. Injected masks are the rank's own."""

    def __init__(self, generator: Optional[torch.Generator] = None,
                 masks: Optional[Sequence[torch.Tensor]] = None, batch: Optional[int] = None):
        self.generator = generator
        self.masks = None if masks is None else list(masks)
        self.batch = batch
        self.taken = 0

    def keep(self, shape: Sequence[int], rate: float, device,
             batched: bool = True) -> torch.Tensor:
        """The next site's (shape) bool keep-mask, P(True) = 1 - rate;
        ``batched``: whether its leading axis is the batch's."""
        if self.masks is not None:
            if self.taken >= len(self.masks):
                raise ValueError(f"a dropout site past the {len(self.masks)} injected masks")
            m = self.masks[self.taken]
            self.taken += 1
            if tuple(m.shape) != tuple(shape):
                raise ValueError(f"injected dropout mask {self.taken - 1} has shape "
                                 f"{tuple(m.shape)}, the site {tuple(shape)}")
            return m.to(device=device, dtype=torch.bool)
        if self.generator is None:
            raise ValueError("train mode with dropout needs dropout draws or a generator")
        shape = tuple(shape)
        if not batched or world() == 1:
            return torch.rand(shape, generator=self.generator, device=device) < 1.0 - rate
        B = self.batch
        if B is None or shape[0] % B:
            raise ValueError(f"a dropout site of shape {shape} under data parallelism needs "
                             f"the forward's batch (got {B}) to divide its leading axis")
        rest = (shape[0] // B,) + shape[1:]
        u = batch_rows(lambda n: torch.rand((n,) + rest, generator=self.generator,
                                            device=device), B)
        return u.reshape(shape) < 1.0 - rate

    def check_used(self) -> None:
        """Every injected mask was taken."""
        if self.masks is not None and self.taken != len(self.masks):
            raise ValueError(f"{len(self.masks)} dropout masks injected, {self.taken} taken")


def dropout(x: torch.Tensor, rate: float, drops: Optional[DropoutDraws],
            training: bool) -> torch.Tensor:
    """flax ``nn.Dropout`` (linen/stochastic.py:99-107): select(m, x / keep,
    0) in x's dtype with a keep-mask of x's shape from ``drops``; x as it is
    in eval or at rate 0. Train mode with a rate needs ``drops``."""
    if not training or not rate:
        return x
    if drops is None:
        raise ValueError("train mode with dropout needs dropout draws or a generator")
    m = drops.keep(x.shape, rate, x.device)
    return torch.where(m, x / (1.0 - rate), torch.zeros_like(x))


def dropout_weights(w: torch.Tensor, rate: float, drops: Optional[DropoutDraws],
                    training: bool, shape: Optional[Sequence[int]] = None) -> torch.Tensor:
    """The attention-weights dropout of flax ``nn.MultiHeadDotProductAttention``
    (linen/attention.py:153-161): w * (m / keep) in w's dtype, the mask of
    ``shape`` (flax broadcasts one (1, 1, T, S) mask over batch and heads)
    broadcast over w; w as it is in eval or at rate 0."""
    if not training or not rate:
        return w
    if drops is None:
        raise ValueError("train mode with dropout needs dropout draws or a generator")
    m = drops.keep(w.shape if shape is None else shape, rate, w.device, batched=shape is None)
    return w * (m.to(w.dtype) / (1.0 - rate))


def drop_path_masks(generator: Optional[torch.Generator], B: int, rates: Sequence[float],
                    device=None) -> List[torch.Tensor]:
    """Per-block (B, 2) float32 drop-path masks (attention branch, MLP
    branch), drawn from ``generator``: ones where the block's rate is 0,
    else Bernoulli(keep) / keep with keep = 1 - rate (the JAX package's
    train/fused_forward.py:119-128; reference model_utilities.py:216-231).
    Under data parallelism each mask is this rank's rows of the global
    batch's (``parallel.batch_rows``).

    This is the one mask format of the port. The HTSAT blocks (eager and
    fused) multiply a branch by the mask as it is; ``drop_path`` (PaSST)
    takes the 0/1 draw back from it (mask > 0) and divides by keep, in the
    JAX package's arithmetic for that model."""
    out = []
    for rate in rates:
        if rate > 0.0:
            keep = 1.0 - float(rate)
            u = batch_rows(lambda n: torch.rand((n, 2), generator=generator, device=device), B)
            out.append((u < keep).float() / keep)
        else:
            out.append(torch.ones((B, 2), device=device))
    return out


def drop_path(x: torch.Tensor, mask: torch.Tensor, rate: float) -> torch.Tensor:
    """Stochastic depth of a residual branch ``x`` (B, ...) in the JAX
    package's arithmetic (models/common.py:111-118): x / keep * m in x's
    dtype, keep = 1 - rate, m each sample's 0/1 draw, taken from ``mask``
    (B,), a column of a ``drop_path_masks`` mask."""
    m = (mask > 0).to(x.dtype).reshape((-1,) + (1,) * (x.dim() - 1))
    return x / (1.0 - float(rate)) * m


class TorchBatchNorm(nn.Module):
    """BatchNorm over arbitrary reduce axes with feature shape ``feat_shape``
    and torch.nn.BatchNorm semantics (the JAX package's models/common.py:
    32-75): eval normalizes with the running statistics; training with the
    biased batch variance, and moves the running mean and the unbiased
    (n / (n - 1)) running variance by momentum 0.1; eps 1e-5. Output float32.

    Under data parallelism (a group of W > 1 ranks) training takes the
    global batch's statistics, as the JAX step does under GSPMD: whatever
    ``trainer.sync_batchnorm`` says (the reference's gpu recipe sets it),
    the statistics are always global there. Eval is unchanged.
    """

    momentum = 0.1
    eps = 1e-5

    def __init__(self, feat_shape: Tuple[int, ...], reduce_axes: Tuple[int, ...]):
        super().__init__()
        self.reduce_axes = tuple(reduce_axes)
        self.weight = nn.Parameter(torch.ones(feat_shape))
        self.bias = nn.Parameter(torch.zeros(feat_shape))
        self.register_buffer("running_mean", torch.zeros(feat_shape))
        self.register_buffer("running_var", torch.ones(feat_shape))

    def _bshape(self, x: torch.Tensor):
        shape = list(x.shape)
        for ax in self.reduce_axes:
            shape[ax] = 1
        return shape

    def _normalize(self, x, mean, var):
        shape = self._bshape(x)
        y = (x.float() - mean.reshape(shape)) * torch.rsqrt(var.reshape(shape) + self.eps)
        return y * self.weight.reshape(shape) + self.bias.reshape(shape)

    def eval_affine(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """Eval BN as float32 y = x * inv + shift over the feature shape."""
        inv = self.weight.float() * torch.rsqrt(self.running_var.float() + self.eps)
        return inv, self.bias.float() - self.running_mean.float() * inv

    def batch_forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """Training-mode BN without side effects: (output, new running mean,
        new running variance). Under W > 1 ranks the statistics are the
        global batch's, in two passes through the differentiable
        all-reduce (``parallel.all_reduce_sum``): the mean from the summed
        local sums, then the variance from the summed squared deviations
        from that mean. Every rank holds a batch of one size (the sampler
        gives each B clips), so n, for the unbiased running variance, is W
        times the local count; nothing is read back to the host."""
        xf = x.float()
        n = math.prod(x.shape[ax] for ax in self.reduce_axes)
        W = world()
        if W > 1:
            n *= W
            mean = all_reduce_sum(xf.sum(dim=self.reduce_axes)) / n
            sq = ((xf - mean.reshape(self._bshape(x))) ** 2).sum(dim=self.reduce_axes)
            var = all_reduce_sum(sq) / n
        else:
            mean = xf.mean(dim=self.reduce_axes)
            var = ((xf - mean.reshape(self._bshape(x))) ** 2).mean(dim=self.reduce_axes)
        with torch.no_grad():
            new_mean = (1 - self.momentum) * self.running_mean + self.momentum * mean
            new_var = ((1 - self.momentum) * self.running_var
                       + self.momentum * var * (n / max(n - 1, 1)))
        return self._normalize(x, mean, var), new_mean, new_var

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return self._normalize(x, self.running_mean, self.running_var)
        y, new_mean, new_var = self.batch_forward(x)
        with torch.no_grad():
            self.running_mean.copy_(new_mean)
            self.running_var.copy_(new_var)
        return y


class ScalarBN(TorchBatchNorm):
    """The reference's per-channel "scalar" layers - one BatchNorm2d(mel_bins)
    per input channel over (B, T) for each (channel, mel) pair (reference
    src/models/accdoa.py:26,73-77), fused into ONE BN with feature shape
    (C, F) on (B, C, T, F) input.

    Its state_dict keys are ``weight``/``bias``/``running_mean``/
    ``running_var`` of shape (C, F): the one place where the port's keys are
    not the reference torch keys (``scalar.{c}.weight`` of shape (F,)).
    """

    def __init__(self, num_channels: int, mel_bins: int):
        super().__init__((num_channels, mel_bins), reduce_axes=(0, 2))


class BatchNorm2d(TorchBatchNorm):
    """torch BatchNorm2d on NCHW input (the JAX package's BatchNorm2d over
    NHWC): statistics per channel over (B, H, W)."""

    def __init__(self, features: int):
        super().__init__((features,), reduce_axes=(0, 2, 3))


def layer_norm(x: torch.Tensor, ln: nn.LayerNorm) -> torch.Tensor:
    """float32 LayerNorm of ``x`` with ``ln``'s affine. When only one of the
    scale and the shift needs a gradient (AdapterBit freezes LayerNorm scales
    and trains their shifts), the affine runs outside the fused LayerNorm,
    whose CUDA backward then returns no shift gradient."""
    w, b = ln.weight.float(), ln.bias.float()
    if w.requires_grad == b.requires_grad:
        return F.layer_norm(x.float(), ln.normalized_shape, w, b, ln.eps)
    return F.layer_norm(x.float(), ln.normalized_shape, None, None, ln.eps) * w + b


class LayerNorm(nn.LayerNorm):
    """nn.LayerNorm (eps 1e-5 by default; PaSST's are 1e-6) that also trains
    a shift beside a frozen scale on the card (see ``layer_norm``);
    otherwise nn.LayerNorm itself."""

    def __init__(self, dim: int, eps: float = 1e-5):
        super().__init__(dim, eps=eps)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.weight.requires_grad == self.bias.requires_grad:
            return super().forward(x)
        y = layer_norm(x, self)  # float32, as LayerNorm under autocast
        return y if torch.is_autocast_enabled(x.device.type) else y.to(x.dtype)


class Mlp(nn.Module):
    """ViT MLP: fc1 -> exact erf GELU -> dropout -> fc2, plus the parallel
    bottleneck ``adapter`` (and ``adapter_ds``, the config's
    ``new_adapter``) on the input when the config has an MlpAdapter, ->
    dropout: ``drop(fc2(drop(gelu(fc1 x))) + (adapter(x) + adapter_ds(x)))``
    (reference model_utilities.py:129-171; the JAX package's Mlp,
    common.py:131-163). fc1 and fc2 carry the config's LoRA terms. Dropout
    (rate ``drop``) takes its masks from ``drops`` in train mode."""

    def __init__(self, in_features: int, hidden_features: int, out_features: int,
                 adapt: AdaptConfig = NO_ADAPT, drop: float = 0.0):
        super().__init__()
        self.drop = float(drop)
        self.fc1 = AdaptDense(in_features, hidden_features, **adapt.lora_linear_args())
        self.fc2 = AdaptDense(hidden_features, out_features, **adapt.lora_linear_args())
        self.adapter = (Adapter(in_features, **adapt.adapter_args())
                        if adapt.mlp_adapter else None)
        self.adapter_ds = (Adapter(in_features, **adapt.ds_adapter_args())
                           if adapt.mlp_adapter and adapt.new_adapter else None)

    def forward(self, x: torch.Tensor, drops: Optional[DropoutDraws] = None) -> torch.Tensor:
        h = dropout(F.gelu(self.fc1(x), approximate="none"), self.drop, drops, self.training)
        h = self.fc2(h)
        if self.adapter is not None:
            xs = self.adapter(x)
            h = h + (xs if self.adapter_ds is None else xs + self.adapter_ds(x))
        return dropout(h, self.drop, drops, self.training)


class PatchEmbed(nn.Module):
    """2D patch embedding conv + LayerNorm (reference model_utilities.py:174-213);
    the conv carries the config's LoRA term (the JAX package's
    common.py:200-202).

    Input NCHW; output (B, N, C) tokens in row-major (H', W') order, or with
    ``flatten=False`` the conv's NCHW map (B, C, H', W') and no norm (PaSST
    adds its position embeddings on that map).
    """

    def __init__(self, img_size: Tuple[int, int], patch_size: Tuple[int, int],
                 patch_stride: Tuple[int, int], in_chans: int, embed_dim: int,
                 use_norm: bool = True, flatten: bool = True, adapt: AdaptConfig = NO_ADAPT):
        super().__init__()
        self.img_size = tuple(img_size)
        self.flatten = flatten
        use_norm = use_norm and flatten
        pad = ((patch_size[0] - patch_stride[0]) // 2,
               (patch_size[1] - patch_stride[1]) // 2)
        self.proj = AdaptConv(in_chans, embed_dim, tuple(patch_size), tuple(patch_stride), pad,
                              **adapt.lora_conv_args())
        self.norm = LayerNorm(embed_dim) if use_norm else nn.Identity()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if tuple(x.shape[2:]) != self.img_size:
            raise ValueError(f"input {tuple(x.shape[2:])} != img_size {self.img_size}")
        x = self.proj(x)
        if not self.flatten:
            return x
        return self.norm(x.flatten(2).transpose(1, 2))


class CrossStitch(nn.Module):
    """Learnable per-channel 2 x 2 mixing of two branches' features (the JAX
    package's models/common.py:212-240): ``weight`` (C, 2, 2), init U(0.1,
    0.9); the channel axis is 1 on 4-D (N, C, T, F) input and -1 on 3-D
    (N, L, C) tokens. The update is sequential, as the reference's
    (model_utilities.py:50-53): y mixes with the already mixed x. The
    products promote with the inputs' dtype (a float32 weight on bf16
    tokens gives float32)."""

    def __init__(self, feat_dim: int):
        super().__init__()
        self.feat_dim = feat_dim
        self.weight = nn.Parameter(torch.empty(feat_dim, 2, 2).uniform_(0.1, 0.9))

    def forward(self, x: torch.Tensor, y: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        if x.dim() == 4:
            shape = (1, self.feat_dim, 1, 1)
        elif x.dim() == 3:
            shape = (1, 1, self.feat_dim)
        else:
            raise ValueError(f"x must be 3D or 4D, got {x.dim()}D")
        w = self.weight
        x_new = w[:, 0, 0].reshape(shape) * x + w[:, 0, 1].reshape(shape) * y
        y_new = w[:, 1, 0].reshape(shape) * x_new + w[:, 1, 1].reshape(shape) * y
        return x_new, y_new


def _linear_upsample_matrix(t_in: int, ratio: int) -> np.ndarray:
    """(t_in*ratio, t_in) interpolation matrix with half-pixel centers -
    identical to torch F.interpolate(mode='bilinear', align_corners=False)
    along time."""
    t_out = t_in * ratio
    src = (np.arange(t_out) + 0.5) / ratio - 0.5
    i0 = np.clip(np.floor(src).astype(int), 0, t_in - 1)
    i1 = np.clip(i0 + 1, 0, t_in - 1)
    w1 = np.clip(src - np.floor(src), 0.0, 1.0)
    w1 = np.where(src < 0, 0.0, w1)  # edge clamp at the left boundary
    m = np.zeros((t_out, t_in), np.float32)
    m[np.arange(t_out), i0] += 1.0 - w1
    m[np.arange(t_out), i1] += w1
    return m


def interpolate(x: torch.Tensor, ratio: int, method: str = "repeat") -> torch.Tensor:
    """(B, T, ...) -> (B, T*ratio, ...). 'repeat' duplicates frames; 'bilinear'
    is a linear resize along time with half-pixel centers."""
    if method == "repeat":
        return torch.repeat_interleave(x, ratio, dim=1)
    m = torch.as_tensor(_linear_upsample_matrix(x.shape[1], ratio),
                        dtype=x.dtype, device=x.device)
    return torch.einsum("st,bt...->bs...", m, x)


class TorchGRU(nn.GRU):
    """Bidirectional multi-layer GRU on (B, T, C) -> (B, T, 2 * hidden): torch's
    nn.GRU, whose gate order (r, z, n) and parameter names
    (``weight_ih_l0[_reverse]``, ...) are the JAX package's TorchGRU
    (models/common.py:276)."""

    def __init__(self, input_size: int, hidden_size: int, num_layers: int = 2):
        super().__init__(input_size, hidden_size, num_layers=num_layers, batch_first=True,
                         bidirectional=True)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return super().forward(x)[0]


class TransformerEncoderLayer(nn.Module):
    """torch nn.TransformerEncoderLayer, post-LN and relu (the JAX package's
    models/common.py:331-355), with its parameter names: ``self_attn``
    (packed ``in_proj_weight``), ``linear1``, ``linear2``, ``norm1``,
    ``norm2``. In train mode with dropout, four draws from ``drops`` in the
    JAX order: the attention weights' mask ((1, 1, T, T), broadcast over
    batch and heads, flax's attention form), then the attention output, the
    relu and the second linear's (``nn.Dropout``'s form). The attention
    runs explicitly from ``self_attn``'s packed parameters in both modes,
    since ``nn.MultiheadAttention`` takes no mask of ours; ``self_attn``
    only holds them, under the reference's keys."""

    def __init__(self, d_model: int, nhead: int = 8, dim_feedforward: int = 2048,
                 dropout: float = 0.1):
        super().__init__()
        self.dropout = dropout
        self.self_attn = nn.MultiheadAttention(d_model, nhead, dropout=0.0, batch_first=True)
        self.linear1 = nn.Linear(d_model, dim_feedforward)
        self.linear2 = nn.Linear(dim_feedforward, d_model)
        self.norm1 = nn.LayerNorm(d_model, eps=1e-5)
        self.norm2 = nn.LayerNorm(d_model, eps=1e-5)

    def _attention(self, x: torch.Tensor, drops: Optional[DropoutDraws]) -> torch.Tensor:
        """flax's dot-product attention (q / sqrt(D), softmax in x's dtype,
        the weights' dropout) on ``self_attn``'s q/k/v rows and out_proj."""
        att = self.self_attn
        B, T, E = x.shape
        H = att.num_heads
        q, k, v = (F.linear(x, w, b).reshape(B, T, H, E // H) for w, b in
                   zip(att.in_proj_weight.chunk(3), att.in_proj_bias.chunk(3)))
        w = torch.einsum("bqhd,bkhd->bhqk", q / math.sqrt(E // H), k)
        w = dropout_weights(torch.softmax(w, dim=-1), self.dropout, drops, self.training,
                            (1, 1, T, T))
        ctx = torch.einsum("bhqk,bkhd->bqhd", w.to(v.dtype), v).reshape(B, T, E)
        return att.out_proj(ctx)

    def forward(self, x: torch.Tensor, drops: Optional[DropoutDraws] = None) -> torch.Tensor:
        def drop(h):
            return dropout(h, self.dropout, drops, self.training)

        x = self.norm1(x + drop(self._attention(x, drops)))
        return self.norm2(x + drop(self.linear2(drop(F.relu(self.linear1(x))))))


class TransformerEncoder(nn.Module):
    """``num_layers`` TransformerEncoderLayers under ``layers`` (the
    reference's nn.TransformerEncoder keys)."""

    def __init__(self, d_model: int, num_layers: int):
        super().__init__()
        self.layers = nn.ModuleList(TransformerEncoderLayer(d_model) for _ in range(num_layers))

    def forward(self, x: torch.Tensor, drops: Optional[DropoutDraws] = None) -> torch.Tensor:
        for layer in self.layers:
            x = layer(x, drops)
        return x


class Decoder(nn.Module):
    """gru | conformer | transformer | None on (B, T, C) (reference
    model_utilities.py:245-269; the JAX package's models/common.py:358); the
    decoder module sits under ``decoder``."""

    def __init__(self, decoder: Optional[str], num_feats: int, num_layers: int = 2):
        super().__init__()
        self.kind = decoder
        if decoder in NO_DECODER:
            self.decoder = None
        elif decoder == "gru":
            self.decoder = TorchGRU(num_feats, num_feats // 2, num_layers)
        elif decoder == "conformer":
            from .conformer import ConformerBlocks

            self.decoder = ConformerBlocks(num_feats, num_layers)
        elif decoder == "transformer":
            self.decoder = TransformerEncoder(num_feats, num_layers)
        else:
            raise NotImplementedError(f"decoder '{decoder}' is not implemented")

    def forward(self, x: torch.Tensor, drops: Optional[DropoutDraws] = None) -> torch.Tensor:
        """``drops``: the conformer's or transformer's dropout masks in train
        mode (the GRU has no dropout)."""
        if self.decoder is None:
            return x
        return self.decoder(x) if self.kind == "gru" else self.decoder(x, drops)
