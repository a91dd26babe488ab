"""Helpers of the benchmark's tests: cells cut to a size a CPU test run
holds (the traffic's batch and row blocks; every width as configured)."""

from __future__ import annotations

import dataclasses
import time

import torch

from benchmark import harness

CPU = torch.device("cpu")
PRESYNCED = ("ofdm_chirp-presynced-17db", "ofdm_chirp-presynced-waterfall")
ACQUIRED = ("mcdpsk_l10-chirp-acquire-5db-b2048",)
TINY_BATCH = {"presynced": 16, "acquired": 4}


def tiny_cell(name: str, root=harness.ROOT) -> harness.Cell:
    cell = harness.load_cell(name, root)
    b = TINY_BATCH[cell.entry.PATH]
    cell.traffic = dataclasses.replace(cell.traffic, batch=b,
                                       reference_rows=b // 2, warmup_steps=1,
                                       compare_steps=2, compare_span=2)
    return cell


def run_tiny(cell: harness.Cell, seed: int = 2**31 + 17, seconds: float = 0.2,
             trace: bool = False, control: bool = False) -> dict:
    return harness.run(cell, seed, seconds, trace, CPU, time.perf_counter(),
                       log=lambda _msg: None, control=control)
