"""The share of the traced window in which no operation ran on the device
(the union of kernel, copy and fill intervals on the profiler's
timeline), in percent."""


def read(w):
    if w.trace is None or w.trace.busy_s <= 0:
        return None
    return 100.0 * (1.0 - w.trace.busy_s / w.seconds)
