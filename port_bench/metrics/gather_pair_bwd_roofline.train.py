"""gather_pair_bwd_roofline.train: the sum of edge rows onto both their
ends (``csrc/rows.cuh``'s ``segment_rows_kernel`` unweighted, kernel #5:
``gather_pair`` backward, and ``edge_sum`` forward) against its bytes at
the card's memory rate, in training: ``kernel_work("gather_pair_bwd")``
at the cell's shapes over the kernel's trace time a call, the calls the
program's ``gather_pair_bwd`` and ``edge_sum`` counters count."""

import dataclasses

from port_bench import readers

KERNEL = "gather_pair_bwd"
# the weighted instances (template argument true) are aggregate_pair's
# and spmm's
PATTERNS = ["(?<![A-Za-z0-9_])segment_rows_kernel<[^>]*false>"]
COUNTERS = ["gather_pair_bwd", "edge_sum"]


def read(s):
    entry = {"counter": KERNEL, "patterns": PATTERNS}
    calls = sum(s.launches.get(c, 0) for c in COUNTERS)
    return readers.roofline(
        dataclasses.replace(s, kernels={KERNEL: entry},
                            launches={KERNEL: calls}), "train", KERNEL)
