"""capture_s: host seconds of the cell's capture, the eager first call,
the recording and the instantiation (CapturedCall.timings)."""


def read(s):
    return s.capture_s
