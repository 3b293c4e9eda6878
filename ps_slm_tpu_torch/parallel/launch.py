"""Start the processes of a local mesh.

``launch(argv, n)`` runs ``n`` copies of a command on this machine, each
with ``PS_COORDINATOR`` (a free ``localhost`` port), ``PS_NUM_HOSTS`` and
``PS_HOST_ID`` set, as the finetune CLI reads them
(``parallel.mesh.init_distributed``), waits for all of them within one
time limit, and stops every one that is left when one fails or the limit
passes.  For example two ranks sharing one card over gloo:

    launch([sys.executable, "-m", "ps_slm_tpu_torch.cli.finetune", *overrides], 2,
           env={"PS_DIST_BACKEND": "gloo"})
"""

from __future__ import annotations

import os
import socket
import subprocess
import time
from typing import Dict, List, NamedTuple, Optional, Sequence


def free_port() -> int:
    """A TCP port free on ``localhost`` now."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


class Finished(NamedTuple):
    rank: int
    returncode: int
    stdout: str
    stderr: str


def launch(argv: Sequence[str], n: int, *, env: Optional[Dict[str, str]] = None,
           timeout: float = 600.0, cwd: Optional[str] = None) -> List[Finished]:
    """Run ``argv`` as ranks 0..n-1 of one process group and return each
    rank's exit code and output.  A rank that has not finished when
    ``timeout`` seconds have passed since the start, or that is still
    running when another has failed, is killed (return code -9)."""
    base = dict(os.environ if env is None else {**os.environ, **env})
    base.update(PS_COORDINATOR=f"localhost:{free_port()}", PS_NUM_HOSTS=str(n))
    procs = []
    for rank in range(n):
        procs.append(subprocess.Popen(
            list(argv), env={**base, "PS_HOST_ID": str(rank)}, cwd=cwd,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    deadline = time.monotonic() + timeout
    outs: Dict[int, tuple] = {}
    try:
        while len(outs) < n:
            failed = any(rc != 0 for rc, _, _ in outs.values())
            for rank, p in enumerate(procs):
                if rank in outs:
                    continue
                left = deadline - time.monotonic()
                if failed or left <= 0:
                    p.kill()
                try:
                    out, err = p.communicate(timeout=max(min(left, 1.0), 0.01))
                except subprocess.TimeoutExpired:
                    continue
                outs[rank] = (p.returncode, out, err)
                if p.returncode != 0:
                    break
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    return [Finished(r, *outs[r]) for r in range(n)]
