"""Host-side utilities of the PyTorch/CUDA port: analytic matmul FLOPs."""
