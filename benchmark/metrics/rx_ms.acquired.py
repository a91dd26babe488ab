"""``rx_ms.acquired``: the mean device milliseconds a batch spends in
``psk/mc_dpsk.decode_chirp_batch`` (``sync/chirp.detect_dual_chirp``, the
span cut, CFO correction, demodulation, ``csrc/ldpc_minsum.cu``), between
the CUDA events the harness records around the call.  On a host-bound
path this is the host's enqueue time as much as the device's work."""

from statistics import fmean


def read(trace):
    ms = trace.span_ms.get("rx")
    if trace.path != "acquired" or not ms:
        return None
    return fmean(ms)
