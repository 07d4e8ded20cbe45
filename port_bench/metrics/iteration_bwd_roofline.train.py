"""iteration_bwd_roofline.train: the fused iteration backward
(iteration_pair_bwd: recv, send, finish kernels) against its bytes at the
card's memory rate, in training."""

from port_bench import readers


def read(s):
    return readers.roofline(s, "train", "iteration_pair_bwd")
