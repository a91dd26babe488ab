"""``dpsk_score_roofline.dpsk``: DPSK's preamble-score kernel's share of
its bound, %.

The bound of one launch (``yardstick.dpsk_bound``) at the batch's lanes,
the configuration's L samples a symbol and its O = min(156 L, T - 39 L)
search offsets (119,808 for ``medium`` at T = 287,584), times the launches
of ``dpsk_score_kernel`` in the profiled part of the window, over their
device time.  Nothing when the profiler saw no such kernel."""

import json
from pathlib import Path

from benchmark import yardstick

CONFIG = Path(__file__).resolve().parent.parent / "configs" \
    / "dpsk_medium_r14.json"
#: The preamble's symbols and the symbols ``find_preamble`` searches.
PREAMBLE_SYMBOLS, SEARCH_SYMBOLS = 39, 156


def offsets(T: int, L: int) -> int:
    return min(SEARCH_SYMBOLS * L, T - PREAMBLE_SYMBOLS * L)


def read(trace):
    if trace.path != "acquired":
        return None
    name = yardstick.KERNEL_EVENT["dpsk_score"]
    launches = sum(1 for n, _, _ in trace.device_events if name in n)
    ns = yardstick.kernel_ns(trace.device_events, "dpsk_score")
    if launches == 0 or ns <= 0:
        return None
    cfg = json.loads(CONFIG.read_text())
    L, T = cfg["samples_per_symbol"], cfg["frame_samples"]
    bound_ms = yardstick.dpsk_bound(trace.code["lanes"], L, offsets(T, L))[0]
    return 100.0 * launches * bound_ms * 1e6 / ns
