"""Attention, rotary, masks, sampling and the CUDA kernels' wrappers."""
