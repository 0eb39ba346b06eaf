"""Command-line entry points: ``python -m pseldnets_tpu_torch.cli.infer`` and
``python -m pseldnets_tpu_torch.cli.evaluate``."""
