"""iteration_fwd_roofline.train: the fused iteration forward
(iteration_pair: score, walk, combine kernels) against its bytes at the
card's memory rate, in training."""

from port_bench import readers


def read(s):
    return readers.roofline(s, "train", "iteration_pair")
