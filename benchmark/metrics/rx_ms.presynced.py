"""``rx_ms.presynced``: the mean device milliseconds a batch spends in the
presynced receive chain (``ofdm/demodulator``, ``ops/demap``, the
deinterleave, ``ops/ldpc.decode_totals`` -> ``csrc/ldpc_minsum.cu``),
between the CUDA events the harness records around it."""

from statistics import fmean


def read(trace):
    ms = trace.span_ms.get("rx")
    if trace.path != "presynced" or not ms:
        return None
    return fmean(ms)
