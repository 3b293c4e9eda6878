"""Training of the PyTorch/CUDA port: AdamW with warmup-cosine, the train and eval steps."""
