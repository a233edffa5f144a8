"""Training: the optimizer and mixed precision (``train_state``), the
DALL·E trainer (``trainer_dalle``) and its counters (``metrics``)."""
