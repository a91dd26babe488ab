"""``tx_ms.presynced``: the mean device milliseconds a batch spends in the
presynced TX (``ofdm/pipeline.tx_frame``: ``ops/ldpc.encode_with``, the
interleave, ``ofdm/modulator``), between the CUDA events the harness
records around the call."""

from statistics import fmean


def read(trace):
    ms = trace.span_ms.get("tx")
    if trace.path != "presynced" or not ms:
        return None
    return fmean(ms)
