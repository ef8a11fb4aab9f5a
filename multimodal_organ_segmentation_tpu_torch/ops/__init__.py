"""Attention kernels (CUDA, under ``csrc/``), their plain versions, and
sliding-window inference."""
