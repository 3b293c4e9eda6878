"""ps_slm_tpu_torch: the TASU speech-LLM in PyTorch, with hand-written CUDA
kernels for an NVIDIA H100 (sm_90a).

It mirrors the module paths of the JAX package ``ps_slm_tpu`` (the
reference, which this package never imports).  Entry points run on
``device="cuda"`` unless the caller asks for the CPU; kernel wrappers launch
their CUDA kernel for CUDA tensors and take their plain PyTorch version only
for CPU tensors.  See ``chip_smoke.py`` at the repository root for a run on
the card.
"""
