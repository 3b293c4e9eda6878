"""Locate the optional C++ helper library (``libps_native.so``).

Counterpart of ``ps_slm_tpu/data/_native_lib.py``.  The helper
(``native/csrc/{audio_io,flac,spm_bpe}.cc``, built by ``make -C native``)
parses audio and encodes BPE on the host; the pure-Python readers and
encoder are its equals (the tests hold them to the JAX package's).

Search order: the ``PS_NATIVE_LIB`` environment variable (an absolute
path to the ``.so``), then ``<repo root>/native/build/libps_native.so``.
Returns ``None`` when neither exists.
"""

from __future__ import annotations

import os
from typing import Optional


def find_native_lib() -> Optional[str]:
    env = os.environ.get("PS_NATIVE_LIB")
    if env:
        return env if os.path.exists(env) else None
    root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    cand = os.path.join(root, "native", "build", "libps_native.so")
    return cand if os.path.exists(cand) else None
