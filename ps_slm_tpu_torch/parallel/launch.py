"""Start the processes of a local mesh.

``launch(argv, n)`` runs ``n`` copies of a command on this machine, each
with ``PS_COORDINATOR`` (a ``localhost`` port from :func:`coordinator_port`),
``PS_NUM_HOSTS`` and ``PS_HOST_ID`` set, as the finetune CLI reads them
(``parallel.mesh.init_distributed``), waits for all of them within one
time limit, and stops every one that is left when one fails or the limit
passes.  For example two ranks sharing one card over gloo:

    launch([sys.executable, "-m", "ps_slm_tpu_torch.cli.finetune", *overrides], 2,
           env={"PS_DIST_BACKEND": "gloo"})

The coordinator's port lies below the kernel's ephemeral range
(``/proc/sys/net/ipv4/ip_local_port_range``), never a port the kernel
chose (a bind to port 0).  A rank that connects before rank 0 listens
retries, and each retry takes a local port from the ephemeral range: had
the coordinator's port come from there too, a retry could be given that
very port and connect to itself (a TCP self-connection), and every rank
would wait in the rendezvous until its time limit.  Ranks started by hand
take their port the same way: ``PS_COORDINATOR=localhost:$(python -c
"from ps_slm_tpu_torch.parallel.launch import coordinator_port as p;
print(p())")``.
"""

from __future__ import annotations

import contextlib
import os
import random
import socket
import subprocess
import tempfile
import time
from typing import Dict, List, NamedTuple, Optional, Sequence, Set


PORT_RANGE = "/proc/sys/net/ipv4/ip_local_port_range"


def ephemeral_low() -> int:
    """The lowest port the kernel hands out as a connection's local port
    (the first field of ``ip_local_port_range``; Linux's default, 32768,
    where it cannot be read)."""
    try:
        with open(PORT_RANGE) as f:
            return int(f.read().split()[0])
    except (OSError, ValueError, IndexError):
        return 32768


def coordinator_port(taken: Optional[Set[int]] = None) -> int:
    """A ``localhost`` port for a process group's rendezvous: free now, not
    in ``taken`` (which it joins), at or above 1024 and below the kernel's
    ephemeral range (some hosts start it as low as 16000), so no
    connection's local port is ever this one.  It scans the window
    ``[max(1024, low // 2), low)`` from a random point, wrapping around, so
    that processes choosing at one moment (test workers, launches side by
    side) rarely test the same port first.  Raises when no port of the
    window is free."""
    taken = set() if taken is None else taken
    low = ephemeral_low()
    first = max(1024, low // 2)
    span = max(low - first, 0)
    start = random.SystemRandom().randrange(span) if span else 0
    for i in range(span):
        port = first + (start + i) % span
        if port in taken:
            continue
        with socket.socket() as sock:
            try:
                sock.bind(("localhost", port))
            except OSError:
                continue
        taken.add(port)
        return port
    raise RuntimeError(f"no free port in [{first}, {low}), below the ephemeral range")


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
    running when another has failed, is killed (return code -9).  Each
    rank writes its output to files of its own, read when it ends, so a
    rank that prints much never waits on a full pipe while the others wait
    on it in a collective."""
    base = dict(os.environ if env is None else {**os.environ, **env})
    base.update(PS_COORDINATOR=f"localhost:{coordinator_port()}", PS_NUM_HOSTS=str(n))
    with contextlib.ExitStack() as files:
        procs, logs = [], []
        for rank in range(n):
            out, err = (files.enter_context(tempfile.TemporaryFile("w+", errors="replace"))
                        for _ in range(2))
            logs.append((out, err))
            procs.append(subprocess.Popen(
                list(argv), env={**base, "PS_HOST_ID": str(rank)}, cwd=cwd,
                stdout=out, stderr=err))
        deadline = time.monotonic() + timeout
        codes: Dict[int, int] = {}
        try:
            while len(codes) < n:
                failed = any(rc != 0 for rc in codes.values())
                for rank, p in enumerate(procs):
                    if rank in codes:
                        continue
                    left = deadline - time.monotonic()
                    if failed or left <= 0:
                        p.kill()
                    try:
                        codes[rank] = p.wait(timeout=max(min(left, 0.5), 0.01))
                    except subprocess.TimeoutExpired:
                        continue
                    if codes[rank] != 0:
                        break
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        done = []
        for rank, (out, err) in enumerate(logs):
            out.seek(0)
            err.seek(0)
            done.append(Finished(rank, codes[rank], out.read(), err.read()))
    return done
