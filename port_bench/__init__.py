"""The benchmark of ``gnn_fpga_tpu_torch`` on one NVIDIA H100.

``python3 -m port_bench.run --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once and prints one
JSON line.  Everything a cell needs is found by name: its configuration
in ``configs/<config>.json``, its traffic mix in ``traffic/<mix>.json``,
the limits of its correctness check in ``limits/<cell>.json`` and each
per-layer metric's reader in ``metrics/<metric>.py``.  Kernel-name
patterns are data too (``kernels.json``).

The yardstick lives here, apart from the program: the traffic generator
(``gen.py``), the plain reference (``reference.py``), the comparison that
decides ``correct`` (``judge.py``), the FLOP and byte counts and the
card's peaks (``yardstick.py``) and the reading of the profiler's trace
(``tracing.py``).  Every call into the program goes through
``program.py``.  Nothing here imports JAX or the JAX package.
"""
