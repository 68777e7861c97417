"""Hand-written CUDA kernels (csrc/) and their nvcc + ctypes build."""
