"""gnn_fpga_tpu_torch — the PyTorch/CUDA counterpart of ``gnn_fpga_tpu``.

It keeps the JAX package's module names so that each function has an
obvious counterpart there, and runs on an NVIDIA Hopper card through
hand-written CUDA kernels (``csrc/``) where the JAX package has Pallas
kernels.  On CPU tensors every kernel wrapper takes its plain PyTorch
version instead.

Subpackages:
  core      COO graph container, padding/packing, NPZ I/O, kernel plans
  data      Toy2D synthetic tracking graphs
  ops       gather / segment-sum primitives and the CUDA kernel wrappers
  models    the SegmentClassifier interaction network
  train     training engine (Trainer), checkpoints, metrics
  compress  magnitude pruning masks
  utils     carrying parameters to and from the JAX package
"""

__version__ = "0.1.0"
