"""The reference side of each model family: ``families/<model>.py``,
found by a configuration's ``model`` (:func:`port_bench.manifest.family`)
and loaded by path.  Each file gives

- ``leaves(cfg)``: ``(name, shape, fan_in)`` of every parameter, in a
  fixed order (the order the weights are drawn in);
- ``logits(w, g, cfg, r)``: the plain float32 forward on
  :func:`port_bench.reference.graph_tensors` arrays, ``r`` rounding what
  a lower precision would;
- ``forward_flops(cfg, n_node, n_edge)``: the benchmark's frozen count
  of one forward's useful FLOPs on real nodes and edges.

These files import nothing of the program.  Its side of the family is
``builders/<model>.py``.
"""
