"""Command-line entry points: ``python -m dalle_tpu_torch.cli.train_dalle``
and ``python -m dalle_tpu_torch.cli.generate``."""
