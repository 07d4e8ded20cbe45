"""gemm_share.train: the GEMM kernels' share of the device's busy time
in training (the model's MLPs, the blocked route's batched products)."""

from port_bench import readers


def read(s):
    return readers.share_of_busy(s, "train", "gemm")
