"""device_idle_share.train: the share of the traced training slice in
which no operation ran on the device (the trace's own timeline)."""

from port_bench import readers


def read(s):
    return readers.idle_share(s, "train")
