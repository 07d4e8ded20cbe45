"""gather_pair_roofline.train: the edge gather of two node tables
(``csrc/gather.cu``'s ``gather_pair_kernel``, kernel #6: ``gather_pair``
forward, and ``edge_sum`` backward) against its bytes at the card's
memory rate, in training: ``kernel_work("gather_pair")`` at the cell's
shapes over the kernel's trace time a call, the calls the program's
``gather_pair`` counter counts."""

import dataclasses

from port_bench import readers

KERNEL = "gather_pair"
PATTERNS = ["(?<![A-Za-z0-9_])gather_pair_kernel(?![A-Za-z0-9_])"]
COUNTERS = ["gather_pair"]


def read(s):
    entry = {"counter": KERNEL, "patterns": PATTERNS}
    calls = sum(s.launches.get(c, 0) for c in COUNTERS)
    return readers.roofline(
        dataclasses.replace(s, kernels={KERNEL: entry},
                            launches={KERNEL: calls}), "train", KERNEL)
