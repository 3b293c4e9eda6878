"""Decoding of the PyTorch/CUDA port."""
