"""The numbers that decide ``correct``: the program's outputs held to the
reference's, lane by lane.

A ``Tally`` gathers, over the compared steps and row blocks:

* ``<name>_err`` for a signal (``tx``, ``rx``): the largest absolute
  difference over the largest absolute reference value;
* ``corr_err``: the detected chirps' correlation peaks (up and down), on
  lanes whose detection agrees: the largest absolute difference;
* ``lanes_differ``: the share of lanes whose detection (found, either
  chirp's start, the CFO), ok flag or LDPC iteration count differs;
* ``bits_differ``: the share of lanes that both sides decoded whose info
  bits differ.

A number over no lanes reads 0; a NaN fails every limit.
"""

from __future__ import annotations

import math

import torch


class Tally:
    def __init__(self):
        self.diff: dict[str, float] = {}
        self.scale: dict[str, float] = {}
        self.lanes = 0
        self.counts: dict[str, int] = {}
        self.worst: dict[str, float] = {}
        self.present: list[str] = []

    def _note(self, name: str) -> None:
        if name not in self.present:
            self.present.append(name)

    def _count(self, name: str, n) -> None:
        self.counts[name] = self.counts.get(name, 0) + int(n)

    def _max(self, name: str, x: float) -> None:
        self.worst[name] = max(self.worst.get(name, 0.0), x) \
            if not math.isnan(x) else math.nan

    def signal(self, name: str, prog: torch.Tensor, ref: torch.Tensor):
        key = f"{name}_err"
        self._note(key)
        d = float((prog - ref).abs().max())
        s = float(ref.abs().max())
        self.diff[key] = max(self.diff.get(key, 0.0), d) \
            if not math.isnan(d) else math.nan
        self.scale[key] = max(self.scale.get(key, 0.0), s)

    def decoded(self, bits, ok, iters, ref_bits, ref_ok, ref_iters,
                differ=None):
        """``differ``: lanes already found to differ (their detection)."""
        for key in ("lanes_differ", "bits_differ"):
            self._note(key)
        self.lanes += ok.shape[0]
        lanes = (ok != ref_ok) | (iters != ref_iters)
        if differ is not None:
            lanes |= differ
        self._count("lanes_differ", lanes.sum())
        both = ok & ref_ok
        self._count("bits_differ",
                    (both & (bits != ref_bits).any(-1)).sum())

    def detection(self, det: dict, ref_det: dict, keys,
                  corr_keys) -> torch.Tensor:
        """The lanes whose detection differs; ``corr_err`` on the others."""
        self._note("corr_err")
        differ = torch.zeros_like(det[keys[0]], dtype=torch.bool)
        for key in keys:
            differ |= det[key] != ref_det[key]
        same = ~differ
        if bool(same.any()):
            d = max(float((det[k][same] - ref_det[k][same]).abs().max())
                    for k in corr_keys)
            self._max("corr_err", d)
        return differ

    def merge(self, other: "Tally") -> None:
        for key in other.present:
            self._note(key)
        for key, d in other.diff.items():
            self.diff[key] = max(self.diff.get(key, 0.0), d) \
                if not math.isnan(d) else math.nan
            self.scale[key] = max(self.scale.get(key, 0.0), other.scale[key])
        self.lanes += other.lanes
        for key, n in other.counts.items():
            self._count(key, n)
        for key, x in other.worst.items():
            self._max(key, x)

    def numbers(self) -> dict[str, float]:
        """Each number by name, in the order they were first met."""
        out = {}
        for key in self.present:
            if key in self.diff:
                s = self.scale[key]
                out[key] = self.diff[key] / s if s > 0 else self.diff[key]
            elif key in self.counts:
                out[key] = self.counts[key] / self.lanes if self.lanes else 0.0
            else:
                out[key] = self.worst.get(key, 0.0)
        return out


def verdict(numbers: dict[str, float], limits: dict[str, float],
            lanes: int) -> bool:
    """True when every number is within its limit and lanes were compared;
    a number without a limit, or a limit without a number, fails."""
    if lanes <= 0 or set(numbers) != set(limits):
        return False
    return all(numbers[k] <= limits[k] for k in numbers)
