"""h2d_ms_per_event.infer: device milliseconds of host-to-device copies
an event in the traced scoring slice (the prefetching input path)."""

from port_bench import readers


def read(s):
    return readers.ms_per_unit(s, "infer", "h2d")
