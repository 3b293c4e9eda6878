"""The plain float32 reference that decides ``correct``.

Written from the published descriptions, one row at a time, with no
padding, no cache, no kernel and no batching: torch operations in float32
(float64 for the front end's spectra), TF32 off.  It imports neither JAX,
nor the JAX package, nor anything of ``ps_slm_tpu_torch``, and takes
nothing the program made: it is handed the benchmark's own inputs and
weights and works out again whatever the program derives from them
(features, posteriors, PSD segments, int8 codes, merged sequences).
"""

import torch


def strict_fp32() -> None:
    """Float32 products in float32: no TF32 in matmuls or convolutions."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
