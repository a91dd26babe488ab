"""``device_idle.acquired``: the share of the profiled part of the window in
which no operation ran on the device, %: 100 (1 - busy / window), busy the
length of the union of the device's intervals (``yardstick.busy_ns``)."""


def read(trace):
    if trace.path != "acquired" or trace.window_ns <= 0 or trace.busy_ns <= 0:
        return None
    return 100.0 * (1.0 - trace.busy_ns / trace.window_ns)
