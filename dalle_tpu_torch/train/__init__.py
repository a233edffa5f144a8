"""Training: the optimizer and mixed precision (``train_state``), the
trainers' shell with checkpoints and NaN rollback (``base_trainer``), the
DALL·E, dVAE and CLIP trainers (``trainer_dalle``, ``trainer_vae``,
``trainer_clip``) and their counters (``metrics``)."""
