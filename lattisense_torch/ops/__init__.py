"""Hand-written CUDA kernels (csrc/), their ctypes wrappers and plain PyTorch twins."""
