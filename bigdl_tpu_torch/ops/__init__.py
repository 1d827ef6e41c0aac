"""Hand-written CUDA kernels of the port and their plain PyTorch versions."""
