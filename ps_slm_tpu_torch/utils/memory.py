"""Memory tracing: device memory statistics and host RSS.

Counterpart of ``ps_slm_tpu/utils/memory.py`` (the reference's
``MemoryTrace``, logged once an epoch), built on ``torch.cuda``'s caching
allocator statistics: bytes held by tensors now and at peak, the peak
reset when a trace begins.  Without CUDA every device figure is 0.
"""

from __future__ import annotations

import contextlib
from typing import Dict

import torch


def device_memory_stats() -> Dict[str, float]:
    """Bytes allocated to tensors now and at peak, per CUDA device, in GB."""
    out = {}
    if not torch.cuda.is_available():
        return out
    for i in range(torch.cuda.device_count()):
        out[f"device{i}_gb"] = torch.cuda.memory_allocated(i) / 2 ** 30
        out[f"device{i}_peak_gb"] = torch.cuda.max_memory_allocated(i) / 2 ** 30
    return out


def host_rss_gb() -> float:
    """This process's resident set in GB (0 without psutil)."""
    try:
        import psutil
    except ImportError:
        return 0.0
    return psutil.Process().memory_info().rss / 2 ** 30


class MemoryTrace(contextlib.AbstractContextManager):
    """Context manager reporting the peak device memory inside it (each
    device's peak reset on enter), the memory in use at its end and the
    host RSS."""

    def __enter__(self):
        if torch.cuda.is_available():
            for i in range(torch.cuda.device_count()):
                torch.cuda.reset_peak_memory_stats(i)
        return self

    def __exit__(self, *exc):
        end = device_memory_stats()
        self.peak_gb = max((v for k, v in end.items() if k.endswith("peak_gb")), default=0.0)
        self.used_gb = max(
            (v for k, v in end.items() if k.endswith("_gb") and not k.endswith("peak_gb")),
            default=0.0,
        )
        self.cpu_rss_gb = host_rss_gb()
        return False

    def report(self) -> str:
        return (
            f"device used {self.used_gb:.2f} GB, peak {self.peak_gb:.2f} GB, "
            f"host RSS {self.cpu_rss_gb:.2f} GB"
        )
