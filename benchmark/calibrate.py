#!/usr/bin/env python3
"""The readings that the limits of ``correct`` are set from.

    python3 benchmark/calibrate.py --workload <cell> --seeds 1,2,3 \\
        --seconds 3 [--control] [--out chiprun_out/calibrate.jsonl]

Runs the cell once per seed in one process, at the cell's own batch and
load for a short window, and prints (and appends to ``--out``) every
number ``correct`` compares: with the program as configured (the lower
readings), or with ``--control`` the control: the program's own bfloat16
paths switched on (LDPC messages, and the chirp refine on the acquired
path) and its TX and channel outputs kept in bfloat16 where made (the
upper readings).  The compared steps are drawn from the first
``--span`` steps, so a short window compares as many lanes as a full run.
Not part of a benchmark run; needs the card.
"""

from __future__ import annotations

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import dataclasses  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--span", type=int, default=20)
    ap.add_argument("--control", action="store_true")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    import torch
    from benchmark import harness

    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    cell = harness.load_cell(args.workload)
    cell.traffic = dataclasses.replace(cell.traffic, compare_span=args.span)
    device = torch.device("cuda", 0)
    rows = []
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        res = harness.run(cell, seed, args.seconds, False, device,
                          T_PROCESS if not rows else t0,
                          lambda m: print(m, file=sys.stderr, flush=True),
                          control=args.control)
        row = {"workload": args.workload, "seed": seed,
               "control": args.control, "correct": res["correct"],
               "numbers": {k: v["value"] for k, v in res["checks"].items()},
               "metrics": {k: v["value"] for k, v in res["metrics"].items()},
               "card": res["device"]["kind"]}
        rows.append(row)
        print(json.dumps(row), flush=True)
        if args.out:
            Path(args.out).parent.mkdir(parents=True, exist_ok=True)
            with open(args.out, "a") as f:
                f.write(json.dumps(row) + "\n")
    keys = rows[0]["numbers"]
    pick = min if args.control else max
    print(json.dumps({"workload": args.workload, "control": args.control,
                      "seeds": len(rows),
                      "reading": {k: pick(r["numbers"][k] for r in rows)
                                  for k in keys}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
