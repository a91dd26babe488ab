"""``sc_windows_roofline.nvis``: the Schmidl-Cox window kernel's share of
its bound on the NVIS buffer, %.

The bound of one launch (``yardstick.sc_bound``) at the batch's lanes,
half a symbol (N/2 = 512) and the detection's stride-8 grid of G points
over the configuration's buffer of T samples (``search_grid_size`` of
``sync/schmidl_cox.py``: 3,986 at N = 1,024, CP 96, T = 33,000), times the
launches of ``sc_windows_kernel`` in the profiled part of the window, over
their device time.  Nothing when the profiler saw no such kernel."""

import json
from pathlib import Path

from benchmark import yardstick

CONFIG = Path(__file__).resolve().parent.parent / "configs" \
    / "nvis_qam32_r34.json"
#: The detection's candidate grid step.
STRIDE = 8


def grid(T: int, N: int, cp: int, stride: int = STRIDE) -> int:
    n_off = T - N - cp + 1
    return min(-(-n_off // stride),
               T // stride - 2 * (N // 2 // stride) + 1 - cp // stride)


def read(trace):
    if trace.path != "acquired":
        return None
    name = yardstick.KERNEL_EVENT["sc_windows"]
    launches = sum(1 for n, _, _ in trace.device_events if name in n)
    ns = yardstick.kernel_ns(trace.device_events, "sc_windows")
    if launches == 0 or ns <= 0:
        return None
    cfg = json.loads(CONFIG.read_text())
    N, cp, T = cfg["fft_size"], cfg["cyclic_prefix"], cfg["frame_samples"]
    bound_ms = yardstick.sc_bound(trace.code["lanes"], N // 2, STRIDE,
                                  grid(T, N, cp))[0]
    return 100.0 * launches * bound_ms * 1e6 / ns
