#!/usr/bin/env python3
"""Run one cell of the port's benchmark and print its result line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

Runs on the card of the machine it is started on, from the root of a
checkout.  Prints the run's log and, as its last lines on standard error,
each number ``correct`` compared beside its limit; the last line of
standard output is one JSON object (``correct``, ``attempted``,
``failed``, ``metrics``, ``device``, with ``--trace 1`` ``breakdown``, and
last ``checks``).  Exits non-zero, printing no result, without a card, or
when JAX or the JAX package was loaded.
"""

from __future__ import annotations

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch
    from benchmark import harness

    cell = harness.load_cell(args.workload)
    if not torch.cuda.is_available() \
            or torch.cuda.device_count() < cell.chips:
        log(f"needs {cell.chips} CUDA card(s): cuda available "
            f"{torch.cuda.is_available()}, {torch.cuda.device_count()} found")
        return 2
    device = torch.device("cuda", 0)
    result = harness.run(cell, args.seed, args.seconds, bool(args.trace),
                         device, T_PROCESS, log)
    bad = harness.forbidden_modules()
    if bad:
        log(f"forbidden modules loaded: {', '.join(bad)}")
        return 3
    for name, c in result["checks"].items():
        log(f"check {name}: {c['value']!r} (limit {c['limit']!r})")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
