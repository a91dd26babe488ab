"""The benchmark's one traffic generator, driven by a traffic mix's file.

A mix (``benchmark/traffic/<name>.json``) is a closed loop with one batch
in flight: each step is one batch of ``batch`` frames, each frame's info
bits uniform in {0, 1} and its channel AWGN at ``snr_db`` (wideband, over
the frame's active samples).  Step i draws its bits and standard normals on
the device from a ``torch.Generator`` seeded from (seed, stream, i), so
the same seed gives the same inputs, each step's inputs are fresh, and the
reference can draw any step's again.  Stream 0 is the measured window,
stream 1 the warm-up.

Keys of a mix file:

* ``batch``: frames a step;
* ``snr_db``: the AWGN's SNR;
* ``warmup_steps``: untimed steps of the same shapes before the window;
* ``compare_steps``, ``compare_span``: the window's steps whose outputs
  are held to the reference, ``compare_steps`` of them drawn from the seed
  among the first ``compare_span`` (the window's last step when none of
  them was reached);
* ``reference_rows``: rows the reference computes at a time;
* ``why``: what the mix stands for.
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path

import numpy as np
import torch

WINDOW, WARMUP = 0, 1


@dataclasses.dataclass(frozen=True)
class Traffic:
    name: str
    batch: int
    snr_db: float
    warmup_steps: int
    compare_steps: int
    compare_span: int
    reference_rows: int

    @classmethod
    def load(cls, path: Path) -> "Traffic":
        d = json.loads(path.read_text())
        return cls(name=path.stem, batch=int(d["batch"]),
                   snr_db=float(d["snr_db"]),
                   warmup_steps=int(d["warmup_steps"]),
                   compare_steps=int(d["compare_steps"]),
                   compare_span=int(d["compare_span"]),
                   reference_rows=int(d["reference_rows"]))


def step_seed(seed: int, stream: int, step: int) -> int:
    """A 63-bit seed of (seed, stream, step) (numpy's SeedSequence hash)."""
    state = np.random.SeedSequence([seed % 2**64, stream, step]) \
        .generate_state(2)
    return int((int(state[0]) << 32 | int(state[1])) >> 1)


def inputs(traffic: Traffic, k: int, T: int, seed: int, step: int,
           device: torch.device, stream: int = WINDOW,
           rows: slice = slice(None), generator: torch.Generator = None):
    """(info bits [B, k] float32, standard normals [B, T] float32) of one
    step, on ``device``; ``rows`` picks rows of them (the draws are of the
    whole batch either way).  ``generator``, a generator on ``device``, is
    re-seeded and used instead of a new one."""
    g = generator if generator is not None \
        else torch.Generator(device=device)
    g.manual_seed(step_seed(seed, stream, step))
    info = torch.randint(0, 2, (traffic.batch, k), generator=g,
                         device=device, dtype=torch.float32)
    noise = torch.randn((traffic.batch, T), generator=g, device=device,
                        dtype=torch.float32)
    return info[rows], noise[rows]


def compared_steps(traffic: Traffic, seed: int) -> set[int]:
    """The window steps whose outputs the reference checks."""
    rng = np.random.default_rng(np.random.SeedSequence([seed % 2**64, 2]))
    n = min(traffic.compare_steps, traffic.compare_span)
    return set(int(i) for i in rng.choice(traffic.compare_span, n,
                                          replace=False))
