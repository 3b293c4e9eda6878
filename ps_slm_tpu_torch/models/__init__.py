"""Models of the PyTorch/CUDA port: SenseVoice encoder, projector, Qwen2, TASU."""
