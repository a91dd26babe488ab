"""``device_idle.nvis``: the share of a step in which no operation runs on
the device, %: 100 (1 - busy / step), read as ``device_idle.cox`` reads it.
busy is the union of the device's intervals (``yardstick.busy_ns``) in the
profiled stretch, a step; step is the mean device milliseconds from a
step's first to its last harness span event (``trace.span_ms``, the steps
before the profiler).

The step is taken from the unprofiled steps because the profiler
stretches a replay of a CUDA graph (here the refined path's and the
TX's): CUPTI adds a few microseconds to each node, which lengthens a
profiled step without adding device work."""


def read(trace):
    if trace.path != "acquired" or trace.profiled_steps <= 0 \
            or trace.busy_ns <= 0 or not trace.span_ms:
        return None
    steps = min(len(ms) for ms in trace.span_ms.values())
    if steps <= 0:
        return None
    step_ms = sum(sum(ms[:steps]) for ms in trace.span_ms.values()) / steps
    busy_ms = trace.busy_ns / 1e6 / trace.profiled_steps
    return 100.0 * (1.0 - busy_ms / step_ms)
