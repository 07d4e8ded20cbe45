"""layernorm_share.train: PyTorch's LayerNorm kernels, forward and
backward (the row statistics and normalisation, the input gradient, the
scale and shift gradients), as a share of the device's busy time in
training."""

import dataclasses

from port_bench import readers

GROUP = "layernorm"
PATTERNS = ["(?i)layer_?norm", "GammaBeta", "RowwiseMoments",
            "ComputeInternalGradients", "ComputeGradientFusedParams",
            "cuComputePartGrad", "cuComputeGradGammaBeta",
            "cuComputeGradInput"]


def read(s):
    return readers.share_of_busy(
        dataclasses.replace(s, kernels={GROUP: {"patterns": PATTERNS}}),
        "train", GROUP)
