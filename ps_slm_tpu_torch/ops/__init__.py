"""Serving ops of the PyTorch/CUDA port: attention, norms, PSD, merge."""
