"""``ldpc_roofline.presynced``: the LDPC kernel's share of its bound, %.

The bound (``yardstick.ldpc_bound`` of each profiled batch, on the
iterations its lanes ran, ``yardstick.ldpc_passes`` of its own decoder
output) over the device time of ``ldpc_minsum_kernel`` in the profiled
part of the window.  Nothing when the profiler saw no such kernel."""

from benchmark import yardstick


def read(trace):
    if trace.path != "presynced":
        return None
    ns = yardstick.kernel_ns(trace.device_events, "ldpc_minsum")
    code = trace.code
    bound_ms = sum(yardstick.ldpc_bound(
        code["lanes"], code["n"], code["edges"],
        float(yardstick.ldpc_passes(out["iters"]).sum()))[0]
        for out in trace.outputs)
    if ns <= 0 or bound_ms <= 0:
        return None
    return 100.0 * bound_ms * 1e6 / ns
