"""The port's probes and measurement modules: the counterparts of the TPU
probes under ``benchmarks/`` and of ``bench_scaling.py``.

Instruments that measure the card (their kernels in ``ops/cuda/probes.py``):

    python -m gnn_fpga_tpu_torch.probes.bw           # copy rate, matmuls
    python -m gnn_fpga_tpu_torch.probes.ops          # gathers, scatters
    python -m gnn_fpga_tpu_torch.probes.spmm_ablate  # SpMM ablations
    python -m gnn_fpga_tpu_torch.probes.iter [--ablate-stash]

Measurement modules, on the port's existing kernels:

    python -m gnn_fpga_tpu_torch.probes.blocked      # train step by route
    python -m gnn_fpga_tpu_torch.probes.spmm         # aggregation paths
    python -m gnn_fpga_tpu_torch.probes.doublets     # doublet graphs, AUC gate
    python -m gnn_fpga_tpu_torch.probes.windowcut    # 256-step stack, AUC gate
    python -m gnn_fpga_tpu_torch.probes.scaling      # dp / partitioned, comm model

Each runs on the card unless given ``--device cpu`` (which runs the plain
versions and measures no device metric, and is for tests only), and
raises without a card.  ``common`` holds ``layered_graph``, ``timed``,
``device_busy_ms`` and ``device_line``.
"""
