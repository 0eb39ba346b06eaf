"""Package hygiene of the PyTorch port: no JAX or JAX-package import, default
device is the card, kernel wrappers count launches only on CUDA, the weight
bridge covers every key both ways, unported settings raise."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from pseldnets_tpu.models import heads as jax_heads
from pseldnets_tpu.models.adapters import AdaptConfig as JaxAdaptConfig
from pseldnets_tpu.train.checkpoint import flax_to_torch_key as jax_key
from pseldnets_tpu_torch.config import compose
from pseldnets_tpu_torch.models import build_model, heads
from pseldnets_tpu_torch.models.adapters import AdaptConfig
from pseldnets_tpu_torch.ops import frontend, swin_block
from pseldnets_tpu_torch.serving import htsat_fused_forward_from_wav, prepare_blocks
from pseldnets_tpu_torch.train.checkpoint import (_flatten, flax_to_torch_key,
                                                  jax_to_torch_state_dict, unstack_scalar_rows)
import torch_threads  # noqa: F401  (each xdist worker's share of the cores)

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "pseldnets_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "pseldnets_tpu")
OVERRIDES = ["loss=multi_accdoa", "model.kwargs.pretrained_path=null"]
ENC = dict(spec_size=64, patch_size=4, patch_stride=(4, 4), embed_dim=16,
           depths=(2, 2), num_heads=(2, 4), window_size=4, mlp_ratio=2.0)


def _port_files():
    return sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


@pytest.mark.parametrize("path", _port_files(), ids=lambda p: str(p.relative_to(ROOT)))
def test_source_imports_nothing_of_jax(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        for n in names:
            assert n.split(".")[0] not in FORBIDDEN, f"{path.name} imports {n}"


def test_importing_every_module_loads_no_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import pseldnets_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, 'pseldnets_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        f"bad = [m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r}]\n"
        "print(len([m for m in sys.modules if m.startswith('pseldnets_tpu_torch')]), bad)\n"
        "print(' '.join(m for m in sys.modules if m.startswith('pseldnets_tpu_torch')))\n"
        "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
    assert int(r.stdout.split()[0]) >= 15
    loaded = set(r.stdout.splitlines()[1].split())
    assert {f"pseldnets_tpu_torch.{m}" for m in (
        "metrics.seld", "metrics.dcase", "data.dataset", "data.datamodule", "data.sampler",
        "utils.audio_io", "cli.infer", "cli.evaluate", "entry", "train.loop", "cli.train",
        "cli.preproc", "preproc.preprocess", "utils.utilities", "parallel.mesh")} <= loaded


def test_cli_imports_without_h5py():
    """The card's machine has no h5py: the CLIs, the data and preproc
    packages, the loops and the loggers import without it (the dataset
    readers and the label writers import it where they open a file)."""
    code = ("import sys\n"
            "sys.modules['h5py'] = None  # import h5py raises ImportError\n"
            "import pseldnets_tpu_torch.cli.infer, pseldnets_tpu_torch.data\n"
            "import pseldnets_tpu_torch.train.loop, pseldnets_tpu_torch.entry\n"
            "import pseldnets_tpu_torch.cli.train, pseldnets_tpu_torch.cli.preproc\n"
            "import pseldnets_tpu_torch.preproc, pseldnets_tpu_torch.utils.utilities\n"
            "from pseldnets_tpu_torch.data.dataset import USER_DATASETS\n"
            "assert sorted(USER_DATASETS) == ['accdoa', 'einv2', 'multi_accdoa']\n"
            "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0 and r.stdout.strip() == "ok", r.stdout + r.stderr


def test_default_device_is_the_card():
    from pseldnets_tpu_torch.cli import train as train_cli

    cfg = compose(str(ROOT / "configs"), "train", OVERRIDES)
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        build_model(cfg, 13)
    # the training CLI raises before it reads any data: no silent CPU run
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train_cli.main(OVERRIDES)
    tm = heads.HTSAT(num_classes=5, mel_bins=16, num_tracks=3, tgt_output_frames=24,
                     encoder_kwargs=ENC).eval()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        htsat_fused_forward_from_wav(tm, np.zeros((1, 4, 57600), np.float32), n_mels=16)


def test_full_size_model_from_configs():
    """compose(configs, train, multi_accdoa) builds the published width:
    13 classes x 3 tracks, 12 blocks, 3 merges folded into stage ends."""
    cfg = compose(str(ROOT / "configs"), "train", OVERRIDES)
    model, meta = build_model(cfg, 13, device="cpu")
    enc = model.encoder
    assert (enc.embed_dim, enc.depths, enc.num_heads, enc.window_size) == \
        (96, (2, 2, 6, 2), (4, 8, 16, 32), 8)
    assert model.output_key == "multi_accdoa" and model.tscam_conv.out_channels == 117
    assert meta["backbone"] == "HTSAT" and not model.training
    blocks = prepare_blocks(model.encoder, torch.bfloat16)
    plan = [(p.H, p.C, p.nh, p.window, p.shift, p.merge) for p in blocks]
    assert plan[0] == (64, 96, 4, 8, 0, False) and plan[1] == (64, 96, 4, 8, 4, True)
    assert plan[3] == (32, 192, 8, 8, 4, True) and plan[9] == (16, 384, 16, 8, 4, True)
    assert plan[10] == plan[11] == (8, 768, 32, 8, 0, False)
    assert sum(p.merge for p in blocks) == 3 and blocks[-1].shift == 0


# the ids the cases had when these settings were not ported and raised
@pytest.mark.parametrize("override,match", [
    ("ckpt_path={orbax_dir}", "reads only .ckpt files"),
    pytest.param("adapt=adapter adapt.adapt_kwargs.adapter_scalar=learnable_scalar",
                 "fused_forward=true",
                 id="adapt=adapter adapt.adapt_kwargs.adapter_scalar=learnable_scalar-queue A "
                    "step 6"),
    pytest.param("adapt=lora", "fused_forward=true", id="adapt=lora-queue A step 6"),
    pytest.param("model=crnn loss=einv2_pit model.kwargs.num_features=[8,8,8,8,8,8]",
                 "dropout draws or a generator",
                 id="model=crnn loss=einv2_pit model.kwargs.num_features=[8,8,8,8,8,8]-queue A "
                    "step 9"),
    # (its id is the one the case had when EINV2 PaSST training raised)
    pytest.param("model=passt loss=einv2_pit model.kwargs.depth=1 model.kwargs.embed_dim=24 "
                 "model.kwargs.num_heads=2 model.kwargs.img_size=[64,80] "
                 "model.kwargs.u_patchout=5", "token map",
                 id="model=passt loss=einv2_pit model.kwargs.depth=1 "
                    "model.kwargs.embed_dim=24 model.kwargs.num_heads=2-queue A step 8")])
def test_unported_settings_raise(tmp_path, override, match):
    """What the port does not run raises: ``init_state`` on a ``ckpt_path``
    directory (the JAX package's orbax checkpoint: the port reads only
    .ckpt files) naming what it reads. What the JAX package does not run
    either raises ValueError: an EINV2 PaSST whose token patchout leaves 43
    tokens for a token map of 6 frequency rows (JAX fails in its reshape);
    the eager-only adapters and LoRA (which now train on the eager modules)
    with ``trainer.fused_forward=true``. The EINV2 CRNN (narrowed), whose
    conformer trains with dropout 0.1, raises ValueError at a train-mode
    forward without dropout draws or a generator."""
    if "{orbax_dir}" in override:
        from pseldnets_tpu_torch.train.module import DatasetSpec, SELDTask

        (tmp_path / "last" / "d").mkdir(parents=True)
        cfg = compose(str(ROOT / "configs"), "train",
                      OVERRIDES + [override.format(orbax_dir=tmp_path / "last")])
        task = SELDTask(cfg, DatasetSpec(num_classes=13), device="cpu")
        with pytest.raises(NotImplementedError, match=match):
            task.init_state(0, ckpt_path=cfg["ckpt_path"])
        assert task.state is None
        return
    cfg = compose(str(ROOT / "configs"), "train", OVERRIDES + override.split())
    if match == "fused_forward=true":
        from pseldnets_tpu_torch.models.adapters import kernel_refusal
        from pseldnets_tpu_torch.train.module import DatasetSpec, SELDTask

        assert kernel_refusal(build_model(cfg, 13, device="cpu")[0]) is not None
        forced = compose(str(ROOT / "configs"), "train",
                         OVERRIDES + override.split() + ["trainer.fused_forward=true"])
        with pytest.raises(ValueError, match=match):
            SELDTask(forced, DatasetSpec(num_classes=13), device="cpu")
        return
    with pytest.raises(ValueError, match=match):
        model, _ = build_model(cfg, 13, device="cpu")
        kw = {"generator": torch.Generator().manual_seed(0)} if "passt" in override else {}
        model.train()(torch.zeros(2, 7, 80, 64), **kw)


def test_wrappers_count_launches_only_on_cuda(rng):
    tm = heads.HTSAT(num_classes=5, mel_bins=16, num_tracks=3, tgt_output_frames=24,
                     encoder_kwargs=ENC).eval()
    p = prepare_blocks(tm.encoder, torch.float32)[0]
    x = torch.from_numpy(rng.standard_normal((1, p.H * p.W, p.C)).astype(np.float32))
    wav = torch.from_numpy(rng.standard_normal((1, 4, 4800)).astype(np.float32))
    frontend.KERNEL.launches = swin_block.KERNEL.launches = 0
    frontend.fused_logmel_iv(wav, n_mels=16)
    swin_block.swin_block_fused(x, p)
    assert frontend.KERNEL.launches == swin_block.KERNEL.launches == 0
    # nothing was built or loaded for a CPU call
    assert frontend.KERNEL._lib is None and swin_block.KERNEL._lib is None
    # a tensor that is neither on the CPU nor on the card is refused, not
    # routed to the plain version
    with pytest.raises(ValueError, match="expected a CUDA tensor"):
        frontend.fused_logmel_iv(wav.to("meta"), n_mels=16)
    with pytest.raises(ValueError, match="expected a CUDA tensor"):
        swin_block.swin_block_fused(x.to("meta"), p)
    assert frontend.KERNEL.launches == swin_block.KERNEL.launches == 0


def _tiny_variables(adapt=None):
    jm = jax_heads.HTSAT(num_classes=5, in_channels=7, mel_bins=16, num_tracks=3,
                         tgt_output_frames=24, encoder_kwargs=tuple(ENC.items()),
                         adapt=JaxAdaptConfig(adapt))
    v = jm.init({"params": jax.random.PRNGKey(0)}, jax.numpy.zeros((1, 7, 241, 16)),
                train=False)
    return jax.tree_util.tree_map(np.asarray, {"params": v["params"],
                                               "batch_stats": v["batch_stats"]})


# LoRA (dense and conv) and the eager-only adapters (the learnable scale,
# the second bottleneck adapter_ds)
BRIDGE_ADAPT = (None, {"method": "lora", "linear_kwargs": {"r": 4}, "conv_kwargs": {"r": 3}},
                {"method": "adapter", "adapt_kwargs": {
                    "position": ["MlpAdapter", "SpatialAdapter"], "type": "adapter",
                    "mlp_ratio": 0.5, "adapter_scalar": "learnable_scalar",
                    "new_adapter": {"mlp_ratio": 0.25}}})


def test_bridge_maps_every_key_both_ways():
    """The bridge on the tiny HTSAT tree, plain, with LoRA and with the
    eager-only adapters: strict both ways (a leaf the model lacks and a model
    key the tree does not fill raise), the copied key map agreeing with the
    JAX package's on every leaf, and the JAX loader (convert_state_dict)
    reading the port's state dict back into the flax tree exactly: LoRA
    dense (r, in)/(out, r), LoRA conv OIHW under ``lora_A.weight``/
    ``lora_B.weight``, the learnable scale under ``adapter.weight`` (the key
    map's LN-scale rule), ``adapter_ds``."""
    from pseldnets_tpu.train.checkpoint import convert_state_dict as jax_convert

    for adapt in BRIDGE_ADAPT:
        variables = _tiny_variables(adapt)
        tm = heads.HTSAT(num_classes=5, mel_bins=16, num_tracks=3, tgt_output_frames=24,
                         encoder_kwargs=ENC, adapt=AdaptConfig(adapt))
        sd = jax_to_torch_state_dict(variables, tm)
        assert set(sd) == set(tm.state_dict())
        # the copied key map agrees with the JAX package's on every HTSAT leaf
        for coll in ("params", "batch_stats"):
            for path in _flatten(variables[coll]):
                assert flax_to_torch_key(path) == jax_key(path), path
        back, report = jax_convert({k: v.numpy() for k, v in unstack_scalar_rows(sd, tm).items()},
                                   variables)
        assert not report["missing"] and not report["unused"]
        for coll in ("params", "batch_stats"):
            flat_back = _flatten(back[coll])
            for path, v in _flatten(variables[coll]).items():
                assert np.array_equal(np.asarray(flat_back[path]), v), path
        # reference names: Linear/LayerNorm/conv weights under the torch keys
        assert sd["encoder.layers.0.blocks.1.attn.qkv.weight"].shape == (48, 16)
        assert sd["encoder.layers.0.downsample.reduction.weight"].shape == (32, 64)
        assert sd["encoder.patch_embed.proj.weight"].shape == (16, 7, 4, 4)
        assert sd["tscam_conv.weight"].shape == (45, 32, 2, 3)
        assert sd["scalar.running_var"].shape == (7, 16)
        if adapt and adapt["method"] == "lora":
            assert sd["encoder.layers.0.blocks.1.attn.qkv.lora_A"].shape == (4, 16)
            assert sd["encoder.layers.0.blocks.1.attn.qkv.lora_B"].shape == (48, 4)
            assert sd["encoder.layers.0.downsample.reduction.lora_B"].shape == (32, 4)
            assert sd["encoder.patch_embed.proj.lora_A.weight"].shape == (3, 7, 4, 4)
            assert sd["encoder.patch_embed.proj.lora_B.weight"].shape == (16, 3, 1, 1)
        elif adapt:
            assert sd["encoder.layers.0.blocks.1.attn.adapter.weight"].shape == (1,)
            assert sd["encoder.layers.0.blocks.1.mlp.adapter_ds.fc1.weight"].shape == (4, 16)
    # a leaf the model lacks, and a model key the tree does not fill, raise
    extra = dict(variables, params=dict(variables["params"], stray={"kernel": np.zeros((2, 2))}))
    with pytest.raises(KeyError, match="stray"):
        jax_to_torch_state_dict(extra, tm)
    short = dict(variables, params={k: v for k, v in variables["params"].items()
                                    if k != "tscam_conv"})
    with pytest.raises(KeyError, match="tscam_conv"):
        jax_to_torch_state_dict(short, tm)


def test_chip_smoke_builds_every_kernel_source():
    """Every ``csrc/*.cu`` is one kernel of chip_smoke.py's K1-K11 (built,
    checked and counted there), conv_block.cu (K7), patch_embed.cu (K8),
    the frontend's flat and DIF forms (K9, K10) and the whole-stage Swin
    swin_stage.cu (K11) among them, each with the main path that runs it;
    no module imports JAX (above)."""
    sys.path.insert(0, str(ROOT))
    import chip_smoke

    sources = {k.source.name for k in chip_smoke.kernels().values()}
    assert sources == {p.name for p in (PORT / "csrc").glob("*.cu")}
    assert {"conv_block.cu", "patch_embed.cu", "frontend_flat.cu", "frontend_dif.cu",
            "swin_stage.cu"} <= sources
    assert list(chip_smoke.kernels()) == [f"K{i}" for i in range(1, 12)]
    assert {"serve_crnn", "serve_patch", "features_flat", "features_dif",
            "serve_stage", "serve_einv2", "train_einv2", "train_passt", "train_crnn",
            "train_lora", "eval"} <= set(chip_smoke.PATHS)
