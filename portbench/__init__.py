"""The benchmark of ``ps_slm_tpu_torch`` on one NVIDIA H100.

``python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>``
runs one cell of ``BENCHMARK.json``.  Everything that belongs to one
configuration, traffic mix or per-layer metric is a file of its own
(``configs/``, ``traffic/``, ``metrics/``), found by the name that
``BENCHMARK.json`` gives it.  ``reference/`` is the plain float32
reference that decides ``correct``; ``counting.py`` and ``assets.py`` are
the frozen work counts and stand-in writers.
"""
