"""Ops of the PyTorch/CUDA port: attention, norms, PSD, merge, CE loss."""
