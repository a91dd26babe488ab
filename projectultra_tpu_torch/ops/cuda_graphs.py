"""Fixed sequences of tensor operations replayed as CUDA graphs.

A function whose operations depend only on its tensors' shapes (the
pilot-tracking scan, the Cox TX) costs one host launch per operation when
run eagerly; captured once as a CUDA graph it costs one launch a call.
``Captured`` holds one such capture: the function's inputs are copied into
the graph's own tensors before each replay, and its outputs are the
graph's own tensors, which the next replay overwrites (a caller that hands
them on copies them first).  ``Cache`` keeps captures by a key that fixes
the operation sequence, and captures a key at its second call: a key met
once (a station's frame of a new length) costs no capture.

Graphs are made only on a card; CPU callers never reach this module.
"""

from __future__ import annotations

import collections
import functools

import torch


@functools.lru_cache(maxsize=None)
def _capture_stream(device: torch.device) -> torch.cuda.Stream:
    return torch.cuda.Stream(device)


class Captured:
    """``fn(*inputs)`` captured as one CUDA graph.  Before the capture,
    ``fn`` runs once eagerly on the capture stream, so every per-device
    table it looks up exists before capture starts (capture allows no
    host-to-device copy).  The capture neither synchronises nor empties the
    allocator's cache (``torch.cuda.graph`` does both, and collects
    garbage): a station that captures mid-stream pays for the capture
    alone."""

    def __init__(self, fn, inputs):
        self.inputs = tuple(torch.empty_like(x) for x in inputs)
        self._fill(inputs)
        dev = self.inputs[0].device
        side = _capture_stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.stream(side):
            fn(*self.inputs)
            self.graph.capture_begin(capture_error_mode="thread_local")
            try:
                self.out = fn(*self.inputs)
            finally:
                self.graph.capture_end()
        torch.cuda.current_stream(dev).wait_stream(side)

    def _fill(self, inputs) -> None:
        for dst, src in zip(self.inputs, inputs):
            dst.copy_(src)

    def __call__(self, inputs):
        """Replays the graph on ``inputs``; returns its own outputs."""
        self._fill(inputs)
        self.graph.replay()
        return self.out


class Cache:
    """Captures by key, the ``graphs`` most recently used kept; keys seen
    once, the ``seen`` most recent kept."""

    def __init__(self, graphs: int, seen: int):
        self.size, self.seen_size = graphs, seen
        self.graphs: collections.OrderedDict = collections.OrderedDict()
        self.seen: collections.OrderedDict = collections.OrderedDict()

    @staticmethod
    def _remember(cache: collections.OrderedDict, key, value, size: int):
        cache[key] = value
        while len(cache) > size:
            cache.popitem(last=False)

    def get(self, key, capture):
        """The capture of ``key``: the kept one, or ``capture()``'s at the
        key's second call; None at its first."""
        graph = self.graphs.get(key)
        if graph is not None:
            self.graphs.move_to_end(key)
        elif key in self.seen:
            graph = capture()
            self._remember(self.graphs, key, graph, self.size)
        else:
            self._remember(self.seen, key, True, self.seen_size)
        return graph

    def clear(self) -> None:
        self.graphs.clear()
        self.seen.clear()

    def __len__(self) -> int:
        return len(self.graphs)

    def __iter__(self):
        return iter(self.graphs)
