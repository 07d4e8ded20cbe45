"""step_mfu.train: useful FLOPs of the traced training steps over the
slice's wall time at the card's bf16 peak (the whole step, device)."""

from port_bench import readers


def read(s):
    return readers.step_mfu(s, "train")
