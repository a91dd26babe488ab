"""``rx_ms.dpsk``: the mean device milliseconds a batch spends in
``psk/dpsk.decode_dpsk_batch`` (``find_preamble``: the FFT matched filter,
``csrc/dpsk_score.cu``, the rules, the refine; the cut,
``demodulate_soft``, ``csrc/ldpc_minsum.cu``), between the CUDA events the
harness records around the call."""

from statistics import fmean


def read(trace):
    ms = trace.span_ms.get("rx")
    if trace.path != "acquired" or not ms:
        return None
    return fmean(ms)
