"""The launcher's coordinator port (``ps_slm_tpu_torch/parallel/launch.py``):
free, at or above 1024, below the kernel's ephemeral range, distinct
within a ``taken`` set, scanned from a point of each process's own; and
no port of the port's code comes from a bind to port 0."""

import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from ps_slm_tpu_torch.parallel import launch  # noqa: E402


def _range_low() -> int:
    """The range's first field, read here apart from the launcher."""
    try:
        with open("/proc/sys/net/ipv4/ip_local_port_range") as f:
            return int(f.read().split()[0])
    except (OSError, ValueError, IndexError):
        return 32768


def test_launch_gives_every_rank_one_port_below_the_ephemeral_range():
    done = launch.launch([sys.executable, "-c", "import os; print(os.environ['PS_COORDINATOR'])"],
                         2, timeout=60)
    assert [f.returncode for f in done] == [0, 0], [f.stderr for f in done]
    coords = {f.stdout.strip() for f in done}
    assert len(coords) == 1, coords
    host, port = coords.pop().rsplit(":", 1)
    assert host == "localhost" and 1024 <= int(port) < _range_low()


@pytest.mark.parametrize("low", [16000, 32768])
def test_port_lies_below_the_range_low_end(monkeypatch, low):
    """A host whose ephemeral range starts at ``low`` (16000 on some):
    every port chosen, and launch()'s, lies in [max(1024, low // 2), low)."""
    monkeypatch.setattr(launch, "ephemeral_low", lambda: low)
    ports = [launch.coordinator_port() for _ in range(20)]
    assert all(max(1024, low // 2) <= p < low for p in ports), ports
    done = launch.launch([sys.executable, "-c", "import os; print(os.environ['PS_COORDINATOR'])"],
                         1, timeout=60)
    assert done[0].returncode == 0, done[0].stderr
    assert int(done[0].stdout.strip().rsplit(":", 1)[1]) < low


def test_taken_ports_are_never_given_again():
    taken: set = set()
    ports = [launch.coordinator_port(taken) for _ in range(32)]
    assert len(set(ports)) == 32 and set(ports) == taken


def test_no_free_port_below_the_range_raises(monkeypatch):
    """It never falls back to a port the kernel would choose."""
    monkeypatch.setattr(launch, "ephemeral_low", lambda: 1030)
    with pytest.raises(RuntimeError, match="below the ephemeral range"):
        launch.coordinator_port(set(range(1024, 1030)))


def test_unreadable_range_falls_back_to_linux_default(monkeypatch, tmp_path):
    monkeypatch.setattr(launch, "PORT_RANGE", str(tmp_path / "missing"))
    assert launch.ephemeral_low() == 32768
    garbled = tmp_path / "garbled"
    garbled.write_text("")
    monkeypatch.setattr(launch, "PORT_RANGE", str(garbled))
    assert launch.ephemeral_low() == 32768


def test_processes_choosing_at_once_start_apart():
    """Four processes started together, as test workers start their
    process groups: their first free ports (their scans' starting points,
    where the window is free) are not all one."""
    code = ("import sys; sys.path.insert(0, sys.argv[1]); "
            "from ps_slm_tpu_torch.parallel.launch import coordinator_port; "
            "print(coordinator_port())")
    procs = [subprocess.Popen([sys.executable, "-c", code, ROOT], stdout=subprocess.PIPE,
                              text=True) for _ in range(4)]
    ports = [int(p.communicate(timeout=60)[0]) for p in procs]
    assert all(p.returncode == 0 for p in procs)
    assert len(set(ports)) > 1, ports


def test_no_coordinator_port_from_a_bind_to_port_zero():
    """The port's modules, chip_smoke.py and the port's tests take ports by
    the launcher's rule only."""
    needle = "bind((" + '"localhost", 0))'
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for base, _, names in os.walk(os.path.join(ROOT, "ps_slm_tpu_torch")):
        files += [os.path.join(base, n) for n in names if n.endswith(".py")]
    tests = os.path.join(ROOT, "tests")
    files += [os.path.join(tests, n) for n in os.listdir(tests)
              if n.startswith("test_torch_") and n.endswith(".py")]
    found = [f for f in files if needle in open(f, encoding="utf-8").read()]
    assert not found, found
