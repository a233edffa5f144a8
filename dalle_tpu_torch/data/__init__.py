"""Training data: the synthetic shapes fixture (``synthetic``)."""
