"""device_idle_share.infer: the share of the traced scoring slice in which
no operation ran on the device (the trace's own timeline)."""

from port_bench import readers


def read(s):
    return readers.idle_share(s, "infer")
