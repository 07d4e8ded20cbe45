"""step_mfu.infer: useful forward FLOPs of the traced events over the
slice's wall time at the card's bf16 peak (the whole forward, device)."""

from port_bench import readers


def read(s):
    return readers.step_mfu(s, "infer")
