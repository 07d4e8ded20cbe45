"""input_wait_ms_per_event.infer: host milliseconds an event in which the
scoring loop waits on the prefetch queue (the program's span
gnn.prefetch.wait): the input path holding the consumer back."""

from port_bench import spans


def read(s):
    return spans.input_wait_ms_per_event(s)
