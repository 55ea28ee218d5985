"""The benchmark of the PyTorch / CUDA port (``repro_torch``).

``python portbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` on the card it is
started on and prints one JSON line.  Everything a cell needs is found by
name: its configuration under ``configs/``, its traffic mix under
``traffic/``, each per-layer metric's reader under ``metrics/``.  The
plain reference that decides ``correct`` is ``reference/``; it imports
nothing of the port.
"""
