"""The program's side of each model family: ``builders/<model>.py``,
found by a configuration's ``model`` (:func:`port_bench.manifest.builder`)
and loaded by path.  Each file gives

- ``make_model(cfg, mix, device)``: the port's module for the
  configuration on the mix's route (``mix["route"]``), its parameters
  named as the family's ``leaves`` name them; the benchmark copies its
  weights in (:func:`port_bench.program.make_model`);
- ``kernel_shapes(batch, cfg)``: the shapes the kernels' tables have on
  ``batch`` (``v``, ``e``, ``d``, ``hdim``, ``dtype_bytes``), which the
  rooflines read.

They import the program inside these functions, never when loaded.
"""
