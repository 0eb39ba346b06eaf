"""Observability utilities: a copy of the JAX package's utils/utilities.py
(its parameter count, config tree printer and logger backends; the two
helpers no caller uses are left out).

Parity: reference src/utils/utilities.py — rich config tree printing
(:145-203), param counting — plus logger backends (TensorBoard / CSV /
JSONL, and wandb/mlflow/neptune/comet/aim with loud JSONL fallbacks)
instantiated from the reference's configs/logger/* `_target_` strings. Rank
zero is torch.distributed's when a process group is up, else this process.
"""

import json
import logging
from pathlib import Path
from typing import Dict, Iterable, Optional


def process_rank() -> int:
    """torch.distributed's rank when a process group is up, else 0."""
    import torch.distributed as dist

    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def count_params(params: Iterable) -> int:
    """Elements over ``params`` (torch tensors, e.g. ``model.parameters()``)."""
    return sum(p.numel() for p in params)


def print_config_tree(cfg):
    """Rich tree of the composed config (reference utilities.py:145-203)."""
    try:
        import rich
        import rich.syntax
        import rich.tree
        import yaml

        from ..config import to_dict

        tree = rich.tree.Tree("CONFIG", style="dim")
        for key, value in to_dict(cfg).items():
            branch = tree.add(str(key))
            if isinstance(value, dict):
                branch.add(rich.syntax.Syntax(
                    yaml.dump(value, default_flow_style=False), "yaml"))
            else:
                branch.add(str(value))
        rich.print(tree)
    except Exception:
        logging.getLogger("pseldnets").info("config: %s", cfg)


class JsonlLogger:
    def __init__(self, path: Path):
        self.path = Path(path)
        self.path.parent.mkdir(parents=True, exist_ok=True)

    def log_metrics(self, metrics: Dict, step: int):
        with open(self.path, "a") as f:
            f.write(json.dumps({"step": step, **metrics}) + "\n")

    def close(self):
        pass


class CsvLogger:
    def __init__(self, save_dir, name="csv", **_):
        self.path = Path(save_dir) / name / "metrics.csv"
        self.path.parent.mkdir(parents=True, exist_ok=True)
        self._keys = None

    def log_metrics(self, metrics: Dict, step: int):
        row = {"step": step, **metrics}
        if self._keys is None:
            self._keys = list(row.keys())
            with open(self.path, "a") as f:
                f.write(",".join(self._keys) + "\n")
        with open(self.path, "a") as f:
            f.write(",".join(str(row.get(k, "")) for k in self._keys) + "\n")

    def close(self):
        pass


class TensorBoardLogger:
    def __init__(self, save_dir, name=None, **_):
        from torch.utils.tensorboard import SummaryWriter

        path = Path(save_dir) / (name or "")
        path.mkdir(parents=True, exist_ok=True)
        self.writer = SummaryWriter(str(path))

    def log_metrics(self, metrics: Dict, step: int):
        for k, v in metrics.items():
            if isinstance(v, (int, float)):
                self.writer.add_scalar(k, v, step)

    def close(self):
        self.writer.close()


class WandbLogger:
    """Experiment tracking via wandb (reference configs/logger/wandb.yaml).

    Uses the real wandb package when importable (honoring ``offline``); when
    it is missing the run does NOT silently lose its dashboard — a loud
    warning fires at startup and metrics stream to
    <save_dir>/wandb_offline.jsonl instead."""

    def __init__(self, save_dir=".", offline=False, project=None, name=None,
                 id=None, group=None, tags=None, job_type=None, prefix="",
                 **_):
        self.prefix = prefix or ""
        self.run = None
        self._fallback = None
        try:
            import wandb
        except ImportError:
            wandb = None
        if wandb is not None:
            self.run = wandb.init(
                project=project or None, name=name or None, id=id or None,
                dir=str(save_dir), mode="offline" if offline else "online",
                group=group or None, tags=list(tags) if tags else None,
                job_type=job_type or None, reinit=True)
        else:
            logging.getLogger("pseldnets").warning(
                "logger=wandb requested but the wandb package is NOT "
                "installed — no wandb dashboard for this run; metrics are "
                "streamed to %s instead", Path(save_dir) / "wandb_offline.jsonl")
            self._fallback = JsonlLogger(Path(save_dir) / "wandb_offline.jsonl")

    def log_metrics(self, metrics: Dict, step: int):
        m = {self.prefix + k if self.prefix else k: v
             for k, v in metrics.items()}
        if self.run is not None:
            self.run.log(m, step=step)
        else:
            self._fallback.log_metrics(m, step)

    def close(self):
        if self.run is not None:
            self.run.finish()


class MlflowLogger:
    """MLflow tracking (reference configs/logger/mlflow.yaml).

    Uses the mlflow package when importable; otherwise writes the plain-file
    FileStore layout (mlruns/<exp>/<run>/{meta.yaml,metrics/<key>}) natively —
    one "timestamp value step" line per metric point — which `mlflow ui`
    reads directly, so the backend works without the dependency."""

    def __init__(self, tracking_uri=None, experiment_name="pseldnets",
                 run_name=None, prefix="", tags=None, **_):
        import time
        import uuid

        self.prefix = prefix or ""
        self._mlflow = None
        uri = str(tracking_uri or "mlruns")
        if uri.startswith("file:"):
            uri = uri[len("file:"):]
        try:
            import mlflow

            mlflow.set_tracking_uri(str(tracking_uri or "mlruns"))
            mlflow.set_experiment(experiment_name)
            self._run = mlflow.start_run(run_name=run_name)
            self._mlflow = mlflow
            return
        except ImportError:
            pass
        root = Path(uri)
        exp_id = "0"
        exp_dir = root / exp_id
        run_id = uuid.uuid4().hex
        self._run_dir = exp_dir / run_id
        (self._run_dir / "metrics").mkdir(parents=True, exist_ok=True)
        (self._run_dir / "artifacts").mkdir(parents=True, exist_ok=True)
        now_ms = int(time.time() * 1000)
        if not (exp_dir / "meta.yaml").exists():
            (exp_dir / "meta.yaml").write_text(
                f"artifact_location: {exp_dir.resolve().as_uri()}\n"
                f"creation_time: {now_ms}\n"
                f"experiment_id: '{exp_id}'\n"
                f"last_update_time: {now_ms}\n"
                f"lifecycle_stage: active\n"
                f"name: {experiment_name}\n")
        (self._run_dir / "meta.yaml").write_text(
            f"artifact_uri: {(self._run_dir / 'artifacts').resolve().as_uri()}\n"
            f"end_time: null\n"
            f"entry_point_name: ''\n"
            f"experiment_id: '{exp_id}'\n"
            f"lifecycle_stage: active\n"
            f"run_id: {run_id}\n"
            f"run_name: {run_name or run_id}\n"
            f"run_uuid: {run_id}\n"
            f"source_name: ''\n"
            f"source_type: 4\n"
            f"source_version: ''\n"
            f"start_time: {now_ms}\n"
            f"status: 1\n"
            f"user_id: pseldnets\n")
        tdir = self._run_dir / "tags"
        tdir.mkdir(exist_ok=True)
        (tdir / "mlflow.runName").write_text(str(run_name or run_id))

    def log_metrics(self, metrics: Dict, step: int):
        import time

        now_ms = int(time.time() * 1000)
        if self._mlflow is not None:
            self._mlflow.log_metrics(
                {self.prefix + k: v for k, v in metrics.items()
                 if isinstance(v, (int, float))}, step=step)
            return
        for k, v in metrics.items():
            if not isinstance(v, (int, float)):
                continue
            safe = (self.prefix + k).replace("/", "-")
            with open(self._run_dir / "metrics" / safe, "a") as f:
                f.write(f"{now_ms} {v} {step}\n")

    def close(self):
        if self._mlflow is not None:
            self._mlflow.end_run()
        else:
            import re
            import time

            meta = self._run_dir / "meta.yaml"
            txt = meta.read_text()
            txt = re.sub(r"end_time: null", f"end_time: {int(time.time()*1000)}", txt)
            meta.write_text(txt.replace("status: 1", "status: 3"))


class _FallbackMixin:
    """Shared real-if-importable plumbing (the WandbLogger pattern): when the
    backend package is missing, warn LOUDLY at startup and stream metrics to
    <save_dir>/<name>_offline.jsonl instead of silently dropping them."""

    def _fall_back(self, save_dir, backend: str):
        path = Path(save_dir or ".") / f"{backend}_offline.jsonl"
        logging.getLogger("pseldnets").warning(
            "logger=%s requested but the %s package is NOT installed — no "
            "%s dashboard for this run; metrics are streamed to %s instead",
            backend, backend, backend, path)
        self._fallback = JsonlLogger(path)

    def log_metrics(self, metrics: Dict, step: int):
        m = {self.prefix + k if self.prefix else k: v
             for k, v in metrics.items() if isinstance(v, (int, float))}
        if self._fallback is not None:
            self._fallback.log_metrics(m, step)
        else:
            self._log_real(m, step)


class NeptuneLogger(_FallbackMixin):
    """Neptune tracking (reference configs/logger/neptune.yaml). Real
    neptune run when the package is importable, loud JSONL fallback
    otherwise."""

    def __init__(self, api_key=None, project=None, name=None, prefix="",
                 save_dir=".", **_):
        self.prefix = prefix or ""
        self._fallback = None
        self._run = None
        try:
            import neptune
        except ImportError:
            self._fall_back(save_dir, "neptune")
            return
        self._run = neptune.init_run(project=project or None,
                                     api_token=api_key or None,
                                     name=name or None)

    def _log_real(self, m: Dict, step: int):
        for k, v in m.items():
            self._run[k].append(v, step=step)

    def close(self):
        if self._run is not None:
            self._run.stop()


class CometLogger(_FallbackMixin):
    """Comet tracking (reference configs/logger/comet.yaml). Real comet_ml
    Experiment when importable (OfflineExperiment when offline=True), loud
    JSONL fallback otherwise."""

    def __init__(self, api_key=None, save_dir=".", project_name=None,
                 experiment_name=None, experiment_key=None, offline=False,
                 prefix="", **_):
        self.prefix = prefix or ""
        self._fallback = None
        self._exp = None
        try:
            import comet_ml
        except ImportError:
            self._fall_back(save_dir, "comet")
            return
        if offline:
            self._exp = comet_ml.OfflineExperiment(
                project_name=project_name or None,
                offline_directory=str(save_dir))
        else:
            self._exp = comet_ml.Experiment(
                api_key=api_key or None, project_name=project_name or None)
        if experiment_name:
            self._exp.set_name(experiment_name)

    def _log_real(self, m: Dict, step: int):
        self._exp.log_metrics(m, step=step)

    def close(self):
        if self._exp is not None:
            self._exp.end()


class AimLogger(_FallbackMixin):
    """Aim tracking (reference configs/logger/aim.yaml). Real aim.Run when
    importable, loud JSONL fallback otherwise. The reference's per-split
    metric prefixes are honored by passing keys through unchanged (our keys
    already carry the train/ val/ test/ prefixes)."""

    def __init__(self, repo=None, experiment=None, prefix="",
                 system_tracking_interval=None, log_system_params=False,
                 capture_terminal_logs=False, save_dir=".", **_):
        self.prefix = prefix or ""
        self._fallback = None
        self._run = None
        try:
            from aim import Run
        except ImportError:
            self._fall_back(repo or save_dir, "aim")
            return
        self._run = Run(repo=str(repo) if repo else None,
                        experiment=experiment or None,
                        system_tracking_interval=system_tracking_interval,
                        log_system_params=bool(log_system_params),
                        capture_terminal_logs=bool(capture_terminal_logs))

    def _log_real(self, m: Dict, step: int):
        for k, v in m.items():
            self._run.track(v, name=k, step=step)

    def close(self):
        if self._run is not None:
            self._run.close()


_LOGGER_TARGETS = {
    "lightning.pytorch.loggers.tensorboard.TensorBoardLogger": TensorBoardLogger,
    "lightning.pytorch.loggers.csv_logs.CSVLogger": CsvLogger,
    "lightning.pytorch.loggers.wandb.WandbLogger": WandbLogger,
    "lightning.pytorch.loggers.mlflow.MLFlowLogger": MlflowLogger,
    "lightning.pytorch.loggers.neptune.NeptuneLogger": NeptuneLogger,
    "lightning.pytorch.loggers.comet.CometLogger": CometLogger,
    "aim.pytorch_lightning.AimLogger": AimLogger,
}


def instantiate_loggers(logger_cfg: Optional[Dict], output_dir: Path):
    """Resolve reference-style logger configs. Every reference logger target
    (TB, CSV, wandb, mlflow, neptune, comet, aim) has a backend class; the
    package-backed ones use the real package when importable and fall back
    to a loud warning + per-backend JSONL stream when not. Truly unknown
    targets warn LOUDLY at startup instead of silently degrading; the global
    JSONL stream is always appended so no run ever loses metrics."""
    loggers = []
    for name, sub in (logger_cfg or {}).items():
        if not isinstance(sub, dict) or "_target_" not in sub:
            continue
        cls = _LOGGER_TARGETS.get(sub["_target_"])
        kwargs = {k: v for k, v in sub.items() if k != "_target_"}
        # reference neptune/aim configs carry no save_dir — anchor their
        # offline fallbacks to the run's output dir, not the process cwd
        kwargs.setdefault("save_dir", str(output_dir))
        try:
            if cls is not None:
                loggers.append(cls(**kwargs))
            else:
                logging.getLogger("pseldnets").warning(
                    "logger '%s' (%s) has no backend in this build — its "
                    "dashboard will NOT be populated; metrics still stream "
                    "to %s", name, sub["_target_"],
                    Path(output_dir) / "metrics_stream.jsonl")
        except Exception as e:
            logging.getLogger("pseldnets").warning("logger %s failed: %s", name, e)
    loggers.append(JsonlLogger(Path(output_dir) / "metrics_stream.jsonl"))
    return loggers


def flatten_metrics(d: Dict, prefix: str = "") -> Dict:
    out = {}
    for k, v in d.items():
        key = f"{prefix}{k}"
        if isinstance(v, dict):
            out.update(flatten_metrics(v, key + "/"))
        elif isinstance(v, (int, float)):
            out[key] = float(v)
    return out
