"""Decode-attention kernels (hand-written CUDA for sm_90a) and their plain
PyTorch versions."""
