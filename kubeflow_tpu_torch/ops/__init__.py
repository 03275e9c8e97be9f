"""Attention ops: hand-written CUDA kernels (``csrc/``) and their plain
PyTorch twins."""
