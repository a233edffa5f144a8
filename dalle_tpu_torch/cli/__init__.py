"""Command-line entry points: ``python -m dalle_tpu_torch.cli.train_vae``,
``.train_dalle``, ``.train_clip`` and ``.generate``."""
