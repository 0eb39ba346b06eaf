"""EINV2 dual-branch heads in PyTorch, the counterpart of the JAX package's
models/einv2_heads.py: a SED branch on the first four feature channels and
a DOA branch on all of them, sharing features through CrossStitch (soft
parameter sharing), and the single-encoder SEDDOA variant.

Parity: reference src/models/einv2.py - CRNN (:17-171), HTSAT (:189-327),
HTSAT_SEDDOA (:329-442), PASST (:446-576). Parameter names are the
reference's torch keys. Output dict: {"sed": (B, T, 3, K) logits, "doa":
(B, T, 3, 3) tanh}, float32.

Train mode follows the single-branch heads (models/heads.py): the HTSAT
and PaSST heads take drop-path masks (``dp_masks``: for HTSAT and PaSST a
pair of flat per-block lists, SED encoder's then DOA encoder's; for
HTSAT_SEDDOA one list) or draw them from ``generator``, and PaSST its
patchout draws as a pair too (``patchout_draws``); every head takes its
dropout masks (an HTSAT's drop rates, a conformer or transformer
decoder's) as ``dropout_draws`` (one ``DropoutDraws`` or list of keep-masks
for the whole forward, in its call order) or draws them from
``generator``. The JAX package calls the CRNN's track decoders without a
``deterministic`` flag (einv2_heads.py:72-73), so they run in eval form
there even in training; the port trains them as the reference does, with
their dropout (a deviation ROADMAP.md records).
"""

from typing import Any, Dict, Optional, Sequence, Tuple

import torch
import torch.nn as nn

from .adapters import NO_ADAPT, AdaptConfig
from .backbone import CNN
from .common import CrossStitch, Decoder, ScalarBN, interpolate
from .heads import (block_masks, check_draws, concat_5s, passt_draws, train_draws,
                    tscam_head)
from .htsat import HTSATEncoder
from .passt import PaSSTEncoder, PatchoutDraws

SED_IN_CHANNELS = 4  # the SED branch sees the four log-mel channels


def _stack_tracks(sed, doa) -> Dict[str, torch.Tensor]:
    """Three per-track (B, T, K) logits and (B, T, 3) pre-tanh DOA -> the
    output dict."""
    return {"sed": torch.stack([s.float() for s in sed], dim=2),
            "doa": torch.stack([torch.tanh(d.float()) for d in doa], dim=2)}


class CRNN(nn.Module):
    """Two CNN trunks stitched after every conv block but the last, three
    track decoders a branch stitched pairwise, per-track fc layers
    (reference einv2.py:17-171). ``encoder`` is carried for the config: the
    trunk's depth follows ``num_features``, as in the JAX package."""

    def __init__(self, num_classes: int, in_channels: int = 7, encoder: str = "CNN8",
                 num_features: Sequence[int] = (32, 64, 128, 256),
                 decoder: Optional[str] = "gru", num_decoder_layers: int = 2,
                 mel_bins: int = 64, pred_res: int = 10):
        super().__init__()
        nf = tuple(num_features)
        self.num_features, self.pred_res = nf, pred_res
        self.scalar = ScalarBN(in_channels, mel_bins)
        self.sed_convs = CNN(SED_IN_CHANNELS, nf)
        self.doa_convs = CNN(in_channels, nf)
        # len(nf) + 2 stitches: the blocks' first len(nf) - 1, then the three
        # tracks' (reference einv2.py:36-38, 137-139)
        self.stitch = nn.ModuleList(CrossStitch(f) for f in nf + (nf[-1], nf[-1]))
        for branch in ("sed", "doa"):
            for i in range(1, 4):
                self.add_module(f"{branch}_track{i}", Decoder(decoder, nf[-1], num_decoder_layers))
        for i in range(1, 4):
            self.add_module(f"fc_sed_track{i}", nn.Linear(nf[-1], num_classes))
            self.add_module(f"fc_doa_track{i}", nn.Linear(nf[-1], 3))

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None,
                dropout_draws=None) -> Dict[str, torch.Tensor]:
        """In train mode the track decoders' dropout masks come from
        ``dropout_draws`` or ``generator``, SED track 1 then DOA track 1,
        and so on."""
        N, _, T, _ = x.shape
        output_frames = T // self.pred_res
        drops = train_draws(self.training, dropout_draws, generator, N)
        x = self.scalar(x)
        x_sed, x_doa = x[:, :SED_IN_CHANNELS], x
        n = len(self.num_features)
        for i in range(n - 1):
            x_sed = self.sed_convs.run_block(i, x_sed)
            x_doa = self.doa_convs.run_block(i, x_doa)
            x_sed, x_doa = self.stitch[i](x_sed, x_doa)
        x_sed = self.sed_convs.run_block(n - 1, x_sed).mean(dim=3).transpose(1, 2)  # (N, T', C)
        x_doa = self.doa_convs.run_block(n - 1, x_doa).mean(dim=3).transpose(1, 2)
        sed, doa = [], []
        for i in range(1, 4):
            s, d = self.stitch[-4 + i](getattr(self, f"sed_track{i}")(x_sed, drops),
                                       getattr(self, f"doa_track{i}")(x_doa, drops))
            s = interpolate(s, ratio=8).reshape(N, output_frames, self.pred_res, -1).mean(dim=2)
            d = interpolate(d, ratio=8).reshape(N, output_frames, self.pred_res, -1).mean(dim=2)
            sed.append(getattr(self, f"fc_sed_track{i}")(s))
            doa.append(getattr(self, f"fc_doa_track{i}")(d))
        check_draws(drops)
        return _stack_tracks(sed, doa)


class HTSAT(nn.Module):
    """Two HTS-AT encoders (SED on 4 channels, DOA on ``in_channels``)
    stitched before every stage, one tscam conv head each (reference
    einv2.py:189-327), with the 5 s clip trick of models.heads.HTSAT."""

    def __init__(self, num_classes: int, in_channels: int = 7, mel_bins: int = 64,
                 pred_res: int = 10, tgt_output_frames: int = 100,
                 encoder_kwargs: Dict[str, Any] = None, adapt: AdaptConfig = NO_ADAPT):
        super().__init__()
        kw = dict(encoder_kwargs or {})
        self.pred_res, self.tgt_output_frames = pred_res, tgt_output_frames
        self.scalar = ScalarBN(in_channels, mel_bins)
        self.sed_encoder = HTSATEncoder(in_chans=SED_IN_CHANNELS, mel_bins=mel_bins,
                                        adapt=adapt, **kw)
        self.doa_encoder = HTSATEncoder(in_chans=in_channels, mel_bins=mel_bins, adapt=adapt,
                                        **kw)
        enc = self.sed_encoder
        self.stitch1 = nn.ModuleList(CrossStitch(enc.embed_dim * 2 ** i)
                                     for i in range(enc.num_layers))
        self.sed_tscam_conv = nn.Conv2d(enc.num_features, num_classes * 3,
                                        kernel_size=(enc.SF, 3), padding=(0, 1))
        self.doa_tscam_conv = nn.Conv2d(enc.num_features, 3 * 3,
                                        kernel_size=(enc.SF, 3), padding=(0, 1))

    def forward(self, x: torch.Tensor,
                dp_masks: Optional[Tuple[Sequence[torch.Tensor], Sequence[torch.Tensor]]] = None,
                generator: Optional[torch.Generator] = None,
                dropout_draws=None) -> Dict[str, torch.Tensor]:
        """``dp_masks``: (SED encoder's, DOA encoder's) flat per-block mask
        lists, or None (drawn from ``generator`` in train mode, SED first);
        then the dropout masks in the JAX call order (SED embed, DOA embed,
        then stage by stage SED's and DOA's)."""
        B = x.shape[0]
        x, output_frames, five_sec = concat_5s(x, self.pred_res, self.tgt_output_frames)
        encs = (self.sed_encoder, self.doa_encoder)
        masks = [enc.stage_masks(block_masks(enc, self.training, x.shape[0], m, generator,
                                             x.device))
                 for enc, m in zip(encs, dp_masks or (None, None))]
        drops = train_draws(self.training, dropout_draws, generator, x.shape[0])
        x = self.scalar(x)
        x_sed = self.sed_encoder.embed(x[:, :SED_IN_CHANNELS], drops)
        x_doa = self.doa_encoder.embed(x, drops)
        for i, stitch in enumerate(self.stitch1):
            x_sed, x_doa = stitch(x_sed, x_doa)
            x_sed = self.sed_encoder.run_stage(i, x_sed, masks[0][i], drops)
            x_doa = self.doa_encoder.run_stage(i, x_doa, masks[1][i], drops)
        check_draws(drops)
        frames = (B, output_frames, five_sec, self.tgt_output_frames, self.pred_res)
        sed = tscam_head(self.sed_encoder.finalize(x_sed), self.sed_tscam_conv,
                         self.sed_encoder.time_res, *frames)
        doa = tscam_head(self.doa_encoder.finalize(x_doa), self.doa_tscam_conv,
                         self.doa_encoder.time_res, *frames)
        return {"sed": sed.float().reshape(B, output_frames, 3, -1),
                "doa": torch.tanh(doa.float()).reshape(B, output_frames, 3, 3)}


class HTSAT_SEDDOA(nn.Module):
    """One HTS-AT encoder, two tscam conv heads (reference einv2.py:329-442)."""

    def __init__(self, num_classes: int, in_channels: int = 7, mel_bins: int = 64,
                 pred_res: int = 10, tgt_output_frames: int = 100,
                 encoder_kwargs: Dict[str, Any] = None, adapt: AdaptConfig = NO_ADAPT):
        super().__init__()
        self.pred_res, self.tgt_output_frames = pred_res, tgt_output_frames
        self.scalar = ScalarBN(in_channels, mel_bins)
        self.encoder = HTSATEncoder(in_chans=in_channels, mel_bins=mel_bins, adapt=adapt,
                                    **dict(encoder_kwargs or {}))
        enc = self.encoder
        self.sed_tscam_conv = nn.Conv2d(enc.num_features, num_classes * 3,
                                        kernel_size=(enc.SF, 3), padding=(0, 1))
        self.doa_tscam_conv = nn.Conv2d(enc.num_features, 3 * 3,
                                        kernel_size=(enc.SF, 3), padding=(0, 1))

    def forward(self, x: torch.Tensor, dp_masks: Optional[Sequence[torch.Tensor]] = None,
                generator: Optional[torch.Generator] = None,
                dropout_draws=None) -> Dict[str, torch.Tensor]:
        B = x.shape[0]
        x, output_frames, five_sec = concat_5s(x, self.pred_res, self.tgt_output_frames)
        dp_masks = block_masks(self.encoder, self.training, x.shape[0], dp_masks, generator,
                               x.device)
        drops = train_draws(self.training, dropout_draws, generator, x.shape[0])
        tok = self.encoder(self.scalar(x), dp_masks, drops)
        check_draws(drops)
        frames = (B, output_frames, five_sec, self.tgt_output_frames, self.pred_res)
        sed = tscam_head(tok, self.sed_tscam_conv, self.encoder.time_res, *frames)
        doa = tscam_head(tok, self.doa_tscam_conv, self.encoder.time_res, *frames)
        return {"sed": sed.float().reshape(B, output_frames, 3, -1),
                "doa": torch.tanh(doa.float()).reshape(B, output_frames, 3, 3)}


class PASST(nn.Module):
    """Two PaSST encoders stitched before every ``ps_gap``-th block, three
    track decoders a branch stitched pairwise, per-track fc layers
    (reference einv2.py:446-576). In train mode each encoder takes its own
    patchout draws and drop-path masks (``patchout_draws``, ``dp_masks``:
    (SED encoder's, DOA encoder's) pairs), drawn from ``generator`` where
    not given, the SED encoder's first, as the JAX package calls its
    forward_before first (einv2_heads.py:238-239)."""

    def __init__(self, num_classes: int, in_channels: int = 7, mel_bins: int = 64,
                 ps_gap: int = 2, decoder: Optional[str] = None, num_decoder_layers: int = 2,
                 encoder_kwargs: Dict[str, Any] = None):
        super().__init__()
        kw = dict(encoder_kwargs or {})
        self.ps_gap = ps_gap
        self.scalar = ScalarBN(in_channels, mel_bins)
        self.sed_encoder = PaSSTEncoder(in_chans=SED_IN_CHANNELS, **kw)
        self.doa_encoder = PaSSTEncoder(in_chans=in_channels, **kw)
        E, depth = self.sed_encoder.embed_dim, len(self.sed_encoder.blocks)
        self.stitch1 = nn.ModuleList(CrossStitch(E) for _ in range((depth - 1) // ps_gap + 1))
        self.stitch2 = nn.ModuleList(CrossStitch(E) for _ in range(3))
        self.sed_decoder = nn.ModuleList(Decoder(decoder, E, num_decoder_layers)
                                         for _ in range(3))
        self.doa_decoder = nn.ModuleList(Decoder(decoder, E, num_decoder_layers)
                                         for _ in range(3))
        self.fc_sed = nn.ModuleList(nn.Linear(E, num_classes) for _ in range(3))
        self.fc_doa = nn.ModuleList(nn.Linear(E, 3) for _ in range(3))

    def forward(self, x: torch.Tensor,
                dp_masks: Optional[Tuple[Sequence[torch.Tensor], Sequence[torch.Tensor]]] = None,
                generator: Optional[torch.Generator] = None,
                patchout_draws: Optional[Tuple[PatchoutDraws, PatchoutDraws]] = None,
                dropout_draws=None) -> Dict[str, torch.Tensor]:
        encs = (self.sed_encoder, self.doa_encoder)
        draws = [passt_draws(enc, self.training, x.shape[0], d, m, generator, x.device)
                 for enc, d, m in zip(encs, patchout_draws or (None, None),
                                      dp_masks or (None, None))]
        drops = train_draws(self.training, dropout_draws, generator, x.shape[0])
        (d_sed, m_sed), (d_doa, m_doa) = draws
        x = self.scalar(x)
        x_sed = self.sed_encoder.forward_before(x[:, :SED_IN_CHANNELS], d_sed)
        x_doa = self.doa_encoder.forward_before(x, d_doa)
        for i in range(len(self.sed_encoder.blocks)):
            if i % self.ps_gap == 0:
                x_sed, x_doa = self.stitch1[i // self.ps_gap](x_sed, x_doa)
            x_sed = self.sed_encoder.run_block(i, x_sed, None if m_sed is None else m_sed[i])
            x_doa = self.doa_encoder.run_block(i, x_doa, None if m_doa is None else m_doa[i])
        x_sed = self.sed_encoder.forward_after(x_sed)
        x_doa = self.doa_encoder.forward_after(x_doa)
        sed, doa = [], []
        for i in range(3):
            s, d = self.stitch2[i](self.sed_decoder[i](x_sed, drops),
                                   self.doa_decoder[i](x_doa, drops))
            sed.append(self.fc_sed[i](s))
            doa.append(self.fc_doa[i](d))
        check_draws(drops)
        return _stack_tracks(sed, doa)
