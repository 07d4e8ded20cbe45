"""iteration_fwd_roofline.infer: the fused iteration forward
(iteration_pair: score, walk, combine kernels) against its bytes at the
card's memory rate, in scoring."""

from port_bench import readers


def read(s):
    return readers.roofline(s, "infer", "iteration_pair")
