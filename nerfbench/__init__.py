"""The benchmark of ``mipnerf360_torch`` on one NVIDIA H100.

``python -m nerfbench.run --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json``. Everything a cell
needs is found by name under this folder: its configuration in
``configs/<config>.json``, its traffic mix in ``traffic/<mix>.json`` (which
names a driver, ``drivers/<driver>.py``), its correctness limits in
``limits/<cell>.json`` and each per-layer metric's reader in
``metrics/<metric>.py``. The yardstick (peaks, operation and byte counts,
kernel classes, busy intervals) is ``yardstick.py``; the plain float32
reference that decides ``correct`` is ``reference/``, which imports nothing
of the program.
"""
