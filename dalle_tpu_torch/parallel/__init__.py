"""Sequence parallelism: ring attention over P ranks (``ring_attention.py``)."""
