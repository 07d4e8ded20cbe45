"""gnn_fpga_tpu_torch — the PyTorch/CUDA counterpart of ``gnn_fpga_tpu``.

It keeps the JAX package's module names so that each function has an
obvious counterpart there, and runs on an NVIDIA Hopper card through
hand-written CUDA kernels (``csrc/``) where the JAX package has Pallas
kernels.  On CPU tensors every kernel wrapper takes its plain PyTorch
version instead.

Subpackages:
  core      COO graph container, padding/packing, NPZ I/O, kernel plans,
            bucketed batching, prefetching to the card
  data      Toy2D synthetic tracking graphs and grid/GCN task data
  ops       gather / segment-sum primitives and the CUDA kernel wrappers
  models    the interaction-network heads, the GCN family, the baselines
  train     training engine (Trainer), checkpoints, metrics
  compress  magnitude pruning masks
  cli       the train and infer command lines
  utils     carrying parameters to and from the JAX package, profiling
"""

__version__ = "0.1.0"
