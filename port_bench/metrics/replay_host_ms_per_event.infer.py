"""replay_host_ms_per_event.infer: host milliseconds an event of the
program's spans gnn.prefetch.handoff (the stream wait and record_stream
of each tensor), gnn.captured.load (the copies into the static buffers)
and gnn.captured.replay (the graph's launch)."""

from port_bench import spans


def read(s):
    return spans.replay_host_ms_per_event(s)
