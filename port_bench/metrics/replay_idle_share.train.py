"""replay_idle_share.train: the share of the traced training slice in
which the device runs nothing while the host is inside the program's
spans gnn.captured.replay or gnn.run_steps.readback, that is while a
K-step replay is outstanding: the captured graph's own gaps.  Never above
device_idle_share.train; the difference is the host's part."""

from port_bench import spans


def read(s):
    return spans.replay_idle_share(s)
