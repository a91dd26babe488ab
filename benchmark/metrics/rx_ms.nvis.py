"""``rx_ms.nvis``: the mean device milliseconds a batch spends in
``sync/schmidl_cox.decode_cox_batch`` on the NVIS plan (``detect_preamble``:
the Hilbert FFT, ``csrc/sc_windows.cu`` at half 512, the gates, the CFO,
``csrc/lts_timing.cu`` on the 1,120-sample template; the cut at each LTS,
its analytic half, the LTS estimate, the refined path as one CUDA graph
replay; the deinterleave, ``csrc/ldpc_minsum.cu``), between the CUDA
events the harness records around the call."""

from statistics import fmean


def read(trace):
    ms = trace.span_ms.get("rx")
    if trace.path != "acquired" or not ms:
        return None
    return fmean(ms)
