"""The port's probes: instruments that measure the card, the counterparts
of the TPU probes under ``benchmarks/`` that hold Pallas kernels.

    python -m gnn_fpga_tpu_torch.probes.bw           # copy rate, matmuls
    python -m gnn_fpga_tpu_torch.probes.ops          # gathers, scatters
    python -m gnn_fpga_tpu_torch.probes.spmm_ablate  # SpMM ablations
    python -m gnn_fpga_tpu_torch.probes.iter [--ablate-stash]

Each runs on the card unless given ``--device cpu`` (which times PyTorch's
CPU kernels and the plain versions, and is for tests only), and raises
without a card.  ``common`` holds ``layered_graph`` and ``timed``; the
kernels are in ``ops/cuda/probes.py``.
"""
