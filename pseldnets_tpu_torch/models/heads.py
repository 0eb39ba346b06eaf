"""Single-branch SELD heads in PyTorch, the counterpart of the JAX package's
models/heads.py (CRNN / ConvConformer, HTSAT and PaSST).

Parity: reference src/models/accdoa.py (CRNN :12-95, HTSAT :107-246, PaSST
:249-329) and src/models/multi_accdoa.py. Output dict keys match the reference:
{'accdoa': (B, T, 3K)} or {'multi_accdoa': (B, T, 9K)} with channel layout
[track0 x(K) y(K) z(K) | track1 ... | track2 ...].
"""

from typing import Any, Dict, Optional, Sequence, Tuple

import torch
import torch.nn as nn

from .adapters import NO_ADAPT, AdaptConfig
from .backbone import CNN
from .common import Decoder, DropoutDraws, ScalarBN, drop_path_masks, interpolate
from .conformer import ConformerBlocks
from .htsat import HTSATEncoder
from .passt import PaSSTEncoder, PatchoutDraws


class CRNN(nn.Module):
    """CNN8/CNN12 (+ GRU/conformer/transformer decoder) ACCDOA head (reference
    accdoa.py:12-95): ScalarBN -> CNN -> frequency mean -> decoder ->
    repeat-interpolate x8 (the three time pools) -> mean over ``pred_res``
    frames -> fc -> tanh. The conformer sits directly under ``decoder``; the
    other decoders under ``decoder.decoder`` (the reference's keys).

    In train mode the BatchNorms use batch statistics and the conformer or
    transformer decoder drops out (rate 0.1, as the JAX CRNN passes
    ``deterministic=not train`` to its decoder, heads.py:64-71): its masks
    are ``dropout_draws`` (a ``models.common.DropoutDraws`` or a list of
    injected keep-masks in the JAX order) or are drawn from
    ``generator``."""

    ENCODER_BLOCKS = {"CNN8": 4, "CNN12": 6}

    def __init__(self, num_classes: int, in_channels: int = 7, encoder: str = "CNN8",
                 num_features: Sequence[int] = (32, 64, 128, 256),
                 decoder: Optional[str] = "gru", num_decoder_layers: int = 2,
                 mel_bins: int = 64, pred_res: int = 10, num_tracks: int = 1):
        super().__init__()
        expected = self.ENCODER_BLOCKS.get(encoder)
        if expected is not None and len(num_features) != expected:
            raise ValueError(f"encoder={encoder} expects {expected} num_features, got "
                             f"{len(num_features)}: {tuple(num_features)}")
        self.num_classes, self.in_channels, self.mel_bins = num_classes, in_channels, mel_bins
        self.num_features = tuple(num_features)
        self.decoder_kind, self.num_decoder_layers = decoder, num_decoder_layers
        self.pred_res, self.num_tracks = pred_res, num_tracks
        self.scalar = ScalarBN(in_channels, mel_bins)
        self.convs = CNN(in_channels, self.num_features)
        C = self.num_features[-1]
        self.decoder = (ConformerBlocks(C, num_decoder_layers) if decoder == "conformer"
                        else Decoder(decoder, C, num_decoder_layers))
        self.fc = nn.Linear(C, 3 * num_tracks * num_classes)

    @property
    def output_key(self) -> str:
        return "accdoa" if self.num_tracks == 1 else "multi_accdoa"

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None,
                dropout_draws=None) -> Dict[str, torch.Tensor]:
        B, _, T, _ = x.shape
        output_frames = T // self.pred_res
        drops = train_draws(self.training, dropout_draws, generator, B)
        x = self.convs(self.scalar(x))          # (B, C, T', F')
        x = self.decoder(x.mean(dim=3).transpose(1, 2), drops)  # (B, T', C)
        check_draws(drops)
        x = interpolate(x, ratio=8)
        x = x.reshape(B, output_frames, self.pred_res, -1).mean(dim=2)
        return {self.output_key: torch.tanh(self.fc(x).float())}


class ConvConformer(CRNN):
    """CRNN with a conformer decoder (reference accdoa.py:98-104)."""

    def __init__(self, *args, decoder: Optional[str] = "conformer", **kwargs):
        super().__init__(*args, decoder=decoder, **kwargs)


def concat_5s(x: torch.Tensor, pred_res: int,
              tgt_output_frames: int) -> Tuple[torch.Tensor, int, bool]:
    """The 5 s clip trick of the HTSAT heads (reference accdoa.py:211-240):
    when (B, C, T, F) clips yield tgt_output_frames / 2 label frames, the
    two batch halves, each without its last frame, are concatenated in time
    into 10 s clips. Returns (encoder input, output_frames, five_sec)."""
    B = x.shape[0]
    output_frames = x.shape[2] // pred_res
    five_sec = output_frames < tgt_output_frames
    if five_sec:
        if output_frames != tgt_output_frames // 2 or B % 2:
            raise ValueError("only 5-second (even batch) or 10-second "
                             "clips are supported")
        x = torch.cat([x[: B // 2, :, :-1], x[B // 2:, :, :-1]], dim=2)
    elif output_frames > tgt_output_frames:
        raise NotImplementedError("output_frames > tgt_output_frames")
    return x, output_frames, five_sec


def tscam_head(tok: torch.Tensor, conv: nn.Conv2d, time_res: int, B: int,
               output_frames: int, five_sec: bool, tgt_output_frames: int,
               pred_res: int) -> torch.Tensor:
    """Token map (B', C, SF, ST) -> tscam conv -> bilinear interpolation by
    ``time_res`` -> the first tgt_output_frames * pred_res frames (split back
    into the batch halves after the 5 s trick) -> mean over each label
    frame's pred_res frames: (B, output_frames, conv outputs)."""
    x = conv(tok).flatten(2).transpose(1, 2)  # (B', ST, out)
    x = interpolate(x, ratio=time_res, method="bilinear")
    x = x[:, : tgt_output_frames * pred_res]
    if five_sec:
        half = output_frames * pred_res
        x = torch.cat([x[:, :half], x[:, half:]], dim=0)
    return x.reshape(B, output_frames, pred_res, -1).mean(dim=2)


def train_draws(training: bool, dropout_draws, generator: Optional[torch.Generator],
                batch: int) -> Optional[DropoutDraws]:
    """A train-mode forward's dropout draws: ``dropout_draws`` as given (a
    ``DropoutDraws`` or a list of injected keep-masks), else draws from
    ``generator``; None in eval. ``batch``: the clips on the leading axis
    of the forward's dropout sites (after the 5 s trick, the encoder's)."""
    if not training:
        return None
    if isinstance(dropout_draws, DropoutDraws):
        if dropout_draws.batch is None:
            dropout_draws.batch = batch
        return dropout_draws
    return DropoutDraws(generator, dropout_draws, batch)


def check_draws(drops: Optional[DropoutDraws]) -> None:
    """Every injected dropout mask was taken by the forward."""
    if drops is not None:
        drops.check_used()


def block_masks(enc: nn.Module, training: bool, B: int,
                dp_masks: Optional[Sequence[torch.Tensor]],
                generator: Optional[torch.Generator], device) -> Optional[Sequence[torch.Tensor]]:
    """``dp_masks`` as given, or, in train mode with drop-path rates not all
    0, one (B, 2) mask per block of ``enc`` (an HTSAT or PaSST encoder)
    drawn from ``generator``."""
    rates = enc.block_rates()
    if training and dp_masks is None and any(rates):
        if generator is None:
            raise ValueError("train mode with drop-path needs dp_masks or a generator")
        dp_masks = drop_path_masks(generator, B, rates, device)
    return dp_masks


class HTSAT(nn.Module):
    """HTS-AT backbone + tscam conv head (reference accdoa.py:107-246).

    In train mode the ScalarBN uses batch statistics and the blocks take
    drop-path masks: ``dp_masks`` (one (B', 2) mask per block, B' the
    encoder batch) or, when the rates are not all 0, masks drawn from
    ``generator``; with ``drop_rate`` / ``attn_drop_rate`` the encoder's
    dropout masks likewise (``dropout_draws``: a ``DropoutDraws`` or a list
    of keep-masks in the JAX order), drawn after the drop-path masks.

    Handles the 5 s clip trick: when the incoming clip yields
    tgt_output_frames/2 label frames, the two batch halves are concatenated
    time-wise into 10 s clips for the encoder and split back afterwards
    (accdoa.py:211-240).
    """

    def __init__(self, num_classes: int, in_channels: int = 7, mel_bins: int = 64,
                 pred_res: int = 10, num_tracks: int = 1, tgt_output_frames: int = 100,
                 encoder_kwargs: Dict[str, Any] = None, adapt: AdaptConfig = NO_ADAPT):
        super().__init__()
        self.num_classes, self.in_channels = num_classes, in_channels
        self.mel_bins, self.pred_res = mel_bins, pred_res
        self.num_tracks, self.tgt_output_frames = num_tracks, tgt_output_frames
        self.adapt = adapt
        self.encoder = HTSATEncoder(in_chans=in_channels, mel_bins=mel_bins, adapt=adapt,
                                    **dict(encoder_kwargs or {}))
        self.scalar = ScalarBN(in_channels, mel_bins)
        self.tscam_conv = nn.Conv2d(self.encoder.num_features,
                                    num_classes * 3 * num_tracks,
                                    kernel_size=(self.encoder.SF, 3), padding=(0, 1))

    @property
    def output_key(self) -> str:
        return "accdoa" if self.num_tracks == 1 else "multi_accdoa"

    def forward(self, x: torch.Tensor, dp_masks: Optional[Sequence[torch.Tensor]] = None,
                generator: Optional[torch.Generator] = None,
                dropout_draws=None) -> Dict[str, torch.Tensor]:
        B = x.shape[0]
        x, output_frames, five_sec = concat_5s(x, self.pred_res, self.tgt_output_frames)
        dp_masks = block_masks(self.encoder, self.training, x.shape[0], dp_masks, generator,
                               x.device)
        drops = train_draws(self.training, dropout_draws, generator, x.shape[0])
        x = self.encoder(self.scalar(x), dp_masks, drops)  # (B', C, SF, ST)
        check_draws(drops)
        x = tscam_head(x, self.tscam_conv, self.encoder.time_res, B, output_frames, five_sec,
                       self.tgt_output_frames, self.pred_res)
        return {self.output_key: torch.tanh(x.float())}


class PASST(nn.Module):
    """PaSST backbone + linear head (reference accdoa.py:249-329): ScalarBN
    -> encoder -> fc on the (B, T', E) token map -> tanh.

    In train mode the ScalarBN uses batch statistics, and the encoder takes
    its patchout draws (``patchout_draws``, a ``models.passt.PatchoutDraws``)
    and drop-path masks (``dp_masks``, one (B, 2) mask per block), each
    drawn from ``generator`` where not given (the patchout draws first, as
    the JAX package's forward_before precedes its blocks)."""

    def __init__(self, num_classes: int, in_channels: int = 7, mel_bins: int = 64,
                 num_tracks: int = 1, encoder_kwargs: Dict[str, Any] = None):
        super().__init__()
        self.num_tracks = num_tracks
        self.scalar = ScalarBN(in_channels, mel_bins)
        self.encoder = PaSSTEncoder(in_chans=in_channels, **dict(encoder_kwargs or {}))
        self.fc = nn.Linear(self.encoder.num_features, 3 * num_tracks * num_classes)

    @property
    def output_key(self) -> str:
        return "accdoa" if self.num_tracks == 1 else "multi_accdoa"

    def forward(self, x: torch.Tensor, dp_masks: Optional[Sequence[torch.Tensor]] = None,
                generator: Optional[torch.Generator] = None,
                patchout_draws: Optional[PatchoutDraws] = None) -> Dict[str, torch.Tensor]:
        draws, dp_masks = passt_draws(self.encoder, self.training, x.shape[0], patchout_draws,
                                      dp_masks, generator, x.device)
        fm = self.encoder(self.scalar(x), draws, dp_masks)
        return {self.output_key: torch.tanh(self.fc(fm).float())}


def passt_draws(enc: PaSSTEncoder, training: bool, B: int, draws: Optional[PatchoutDraws],
                dp_masks: Optional[Sequence[torch.Tensor]],
                generator: Optional[torch.Generator], device
                ) -> Tuple[Optional[PatchoutDraws], Optional[Sequence[torch.Tensor]]]:
    """A PaSST encoder's train-mode draws: ``draws`` and ``dp_masks`` as
    given, the missing ones drawn from ``generator``, patchout first;
    (None, None) in eval."""
    if not training:
        return None, None
    if draws is None:
        draws = enc.draw(generator, B, device)
    return draws, block_masks(enc, training, B, dp_masks, generator, device)
