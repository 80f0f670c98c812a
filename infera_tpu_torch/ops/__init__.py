"""The port's CUDA kernels, each beside its plain PyTorch version."""
