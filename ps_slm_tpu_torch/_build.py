"""Build the port's CUDA kernels with nvcc and load them with ctypes.

Every ``csrc/<name>.cu`` becomes its own shared library with a plain C
interface: each ``extern "C"`` entry point takes the device index, a dtype
code, raw pointers, sizes and the CUDA stream, launches on that stream and
returns ``cudaGetLastError()``.  Libraries are built at first use into
``build/ps_slm_tpu_torch/`` beside the package (``.gitignore`` lists
``build/``), named by a hash of their sources and flags, so a changed source
is rebuilt and an unchanged one is loaded as it is.  :func:`build_all` starts
one nvcc per source, all at once, waits for them together, and returns each
build's log, which holds ptxas's report (``-Xptxas -v``: registers, spills
and shared memory of every kernel).

Nothing here is imported by a kernel wrapper until it launches on a CUDA
tensor, so the CPU tests never look for nvcc.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Dict, Sequence

import torch

PACKAGE_DIR = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(PACKAGE_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(PACKAGE_DIR), "build", "ps_slm_tpu_torch")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
SOURCES = ("flash_fwd", "flash_bwd", "norms", "ln_bwd")
# dtype codes understood by every C entry point (csrc/common.cuh)
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

_libs: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def resolve_device(device) -> torch.device:
    """``torch.device`` for an entry point's ``device`` argument.

    Raises when CUDA is asked for and absent: the port never carries on
    on the CPU unless the caller asks for it.
    """
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "device='cuda' but torch.cuda.is_available() is False; pass "
                "device='cpu' to run the plain PyTorch versions"
            )
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    return dev


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    return os.path.join(home, "bin", "nvcc")


def _lib_path(name: str) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for fname in sorted(os.listdir(CSRC)):
        if fname == f"{name}.cu" or fname.endswith(".cuh"):
            with open(os.path.join(CSRC, fname), "rb") as f:
                h.update(fname.encode() + f.read())
    return os.path.join(BUILD_DIR, f"lib{name}-{h.hexdigest()[:16]}.so")


def _start(name: str):
    """Start nvcc for one source unless its library exists; returns the job."""
    out = _lib_path(name)
    if os.path.exists(out):
        return None
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC, f"{name}.cu")]
    proc = subprocess.Popen(
        cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
    )
    return proc, tmp, out


def _finish(name: str, job) -> str:
    proc, tmp, out = job
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on csrc/{name}.cu:\n{log}")
    os.replace(tmp, out)  # atomic: a concurrent loader sees all or nothing
    return log


def build_all() -> Dict[str, str]:
    """Build every library that is missing, one nvcc per source in parallel;
    returns the nvcc log of each source built (none for one already built)."""
    jobs = {n: _start(n) for n in SOURCES}
    errors, logs = [], {}
    for n, job in jobs.items():
        if job is not None:
            try:
                logs[n] = _finish(n, job)
            except RuntimeError as e:
                errors.append(str(e))
    if errors:
        raise RuntimeError("\n".join(errors))
    return logs


def load(name: str, signatures: Dict[str, Sequence]) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built if needed.

    ``signatures`` maps each C entry point to its ctypes ``argtypes``; all
    entry points return ``int`` (a ``cudaError_t``).
    """
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            job = _start(name)
            if job is not None:
                _finish(name, job)
            lib = ctypes.CDLL(_lib_path(name))
            for fn, argtypes in signatures.items():
                getattr(lib, fn).argtypes = list(argtypes)
                getattr(lib, fn).restype = ctypes.c_int
            lib.ps_error_string.argtypes = [ctypes.c_int]
            lib.ps_error_string.restype = ctypes.c_char_p
            _libs[name] = lib
    return lib


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if err != 0:
        msg = lib.ps_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")


def stream_ptr(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream
