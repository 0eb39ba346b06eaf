"""Entry point of the port, the counterpart of the JAX package's
``__graft_entry__.entry``: the flagship model (HTSAT multi-ACCDOA, 13
classes x 3 tracks, configs/model/htsat.yaml at its published width, seeded
random weights) served from raw FOA waveforms at full production shapes.

    fn, args = entry()          # on the card
    out = fn(*args)             # {"multi_accdoa": (2, 100, 117)}

``fn(model, waveforms)`` is ``htsat_fused_forward_from_wav`` (kernels K1,
K8 and K2 x12 on the card; their plain versions on the CPU).
``dryrun_multichip`` is not ported yet (ROADMAP.md queue A step 11).
"""

from pathlib import Path

import torch

REPO = Path(__file__).resolve().parents[1]


def entry(device="cuda"):
    """-> (fn, example_args): ``fn(model, waveforms)`` the served forward,
    ``example_args`` the model on ``device`` and a (2, 4, samples) float32
    batch of zeros there (240000 samples, 10 s at 24 kHz)."""
    from .config import compose
    from .models import build_model
    from .serving import htsat_fused_forward_from_wav, prepare_blocks, prepare_patch_embed

    cfg = compose(str(REPO / "configs"), "train",
                  ["loss=multi_accdoa", "model.kwargs.pretrained_path=null"])
    model, _ = build_model(cfg, 13, device=device, seed=0)
    data = cfg["data"]
    blocks = prepare_blocks(model.encoder, torch.bfloat16)
    embed = prepare_patch_embed(model.encoder, torch.bfloat16)
    frontend = dict(n_fft=int(data["nfft"]), hop=int(data["hoplen"]), window=str(data["window"]),
                    n_mels=int(data["n_mels"]), sample_rate=int(data["sample_rate"]))

    def fn(model, waveforms):
        return htsat_fused_forward_from_wav(model, waveforms, device=device, blocks=blocks,
                                            embed=embed, **frontend)

    n = int(data["train_chunklen_sec"] * data["sample_rate"])
    batch = torch.zeros((2, 4, n), dtype=torch.float32, device=model.scalar.weight.device)
    return fn, (model, batch)
