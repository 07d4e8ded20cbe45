"""prologue_ms_per_call.train: host milliseconds a training call spends
before its replay, in the program's spans gnn.run_steps.prepare (the
stacks, the rank's part, the signature, the captured call looked up) and
gnn.captured.load (the signature check and the copies into the static
buffers), over the calls (gnn.run_steps.readback spans)."""

from port_bench import spans


def read(s):
    return spans.prologue_ms_per_call(s)
