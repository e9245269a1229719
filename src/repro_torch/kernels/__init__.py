"""Hand-written Hopper kernels, their plain PyTorch versions and the
nvcc/ctypes build that binds them."""
