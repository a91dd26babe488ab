"""Frame-axis data parallelism over ``torch.distributed`` ranks (port of
projectultra_tpu/parallel/mesh.py).

The domain's only parallel axis is frames (SURVEY.md §2.6: embarrassingly
parallel; the only algorithmically required collective is the sum of
aggregate BER/FER counts).  Torch has no device mesh: a [B, ...] frame
batch is split into contiguous rows, one block per rank, and the counts
are summed with one ``all_reduce``.

Backends: NCCL when every rank has a card of its own; gloo on the CPU, and
when ranks share one card (NCCL refuses two ranks on one GPU), in which
case the counts travel through host memory.  Nothing tells a process of a
cluster: a world larger than one needs its ``init_method``
(``tcp://localhost:<port>`` or ``file://<path>``), its size and the rank.
"""

from __future__ import annotations

import contextlib
import dataclasses
import datetime
import os
import queue
import tempfile
import time
import traceback
from typing import Callable

import numpy as np
import torch
import torch.distributed as dist

from ..device import resolve

# Long enough for a rank's first kernel build and its step; short enough
# that a rank whose partner died does not wait for the default 30 minutes.
TIMEOUT = datetime.timedelta(seconds=600)
RESULT_TIMEOUT_S = 900.0   # the launcher's wait for every rank's result


@dataclasses.dataclass(frozen=True)
class FrameMesh:
    """One rank's view of the frame axis: its rank, the world size, the
    device it computes on and the backend of the process group."""
    rank: int
    world: int
    device: torch.device
    backend: str


def _placement(device: torch.device, world: int, rank: int):
    """(backend, the rank's device): NCCL with a card per rank, else gloo
    (a shared card keeps its own index)."""
    if device.type == "cuda" and torch.cuda.device_count() >= world:
        return "nccl", torch.device("cuda", rank)
    return "gloo", device


@contextlib.contextmanager
def frame_mesh(world_size: int = 1, rank: int = 0,
               init_method: str | None = None, device=None):
    """Join the default process group (or reuse the one already joined)
    and yield this rank's ``FrameMesh``; a group joined here is destroyed
    on exit.  ``device=None`` is the card.  A world of one needs no
    ``init_method`` (an in-memory store)."""
    backend, dev = _placement(resolve(device), world_size, rank)
    joined = not dist.is_initialized()
    if joined:
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        if init_method is None:
            if world_size != 1:
                raise ValueError("a world larger than one needs init_method")
            dist.init_process_group(backend, store=dist.HashStore(),
                                    world_size=1, rank=0, timeout=TIMEOUT)
        else:
            dist.init_process_group(backend, init_method=init_method,
                                    world_size=world_size, rank=rank,
                                    timeout=TIMEOUT)
    try:
        yield FrameMesh(dist.get_rank(), dist.get_world_size(), dev,
                        dist.get_backend())
    finally:
        if joined:
            dist.destroy_process_group()


def shard_frames(mesh: FrameMesh, *arrays):
    """This rank's contiguous rows of each [B, ...] array (numpy or torch),
    on the mesh's device; B must divide by the world size."""
    out = []
    for a in arrays:
        B = a.shape[0]
        if B % mesh.world:
            raise ValueError(f"{B} frames do not split over {mesh.world} ranks")
        n = B // mesh.world
        rows = a[mesh.rank * n:(mesh.rank + 1) * n]
        if isinstance(rows, np.ndarray):
            rows = torch.from_numpy(np.ascontiguousarray(rows))
        out.append(rows.to(mesh.device))
    return tuple(out) if len(out) > 1 else out[0]


def all_sum(mesh: FrameMesh, counts: torch.Tensor) -> torch.Tensor:
    """The sum over the group of each rank's int64 ``counts``, read to the
    host (the one host read of a step).  NCCL reduces on the card; gloo on
    the host copy."""
    counts = counts.to(torch.int64)
    if mesh.backend == "nccl":
        dist.all_reduce(counts)
        return counts.cpu()
    counts = counts.cpu()
    dist.all_reduce(counts)
    return counts


def all_sum_ms(mesh: FrameMesh, reps: int = 20) -> float:
    """Median host milliseconds of one ``all_sum`` of three int64 counts
    (the reduction and the host read), after one warm-up."""
    counts = torch.zeros(3, dtype=torch.int64, device=mesh.device)
    all_sum(mesh, counts)
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        all_sum(mesh, counts)
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times))


def pmapped_metrics(mesh: FrameMesh, step: Callable):
    """Wrap a per-shard ``step(info, noise) -> (out, ok)`` into one that
    also sums [bit_errors, frame_errors] over the group:
    ``wrapped(info, noise) -> (out, ok, totals)``, ``totals`` an int64 CPU
    tensor equal on every rank."""

    def wrapped(info, noise):
        out, ok = step(info, noise)
        bit_errors = (out.to(torch.float32) != info).sum()
        frame_errors = (~ok).sum()
        return out, ok, all_sum(mesh, torch.stack([bit_errors, frame_errors]))

    return wrapped


def sharded_pipeline_step(config, mod, rate, mesh: FrameMesh):
    """The flagship frame pipeline on a rank's shard: returns
    ``step(info [b, k], noise [b, T])`` (``b`` = B / world) ->
    (out, ok, totals summed over the group)."""
    from ..ofdm import pipeline as P

    def step(info, noise):
        tx = P.tx_frame(config, mod, rate, info)
        out, ok, _ = P.rx_frame(config, mod, rate, tx + noise)
        return out, ok

    return pmapped_metrics(mesh, step)


# ---------------------------------------------------------------------------
# Launching ranks
# ---------------------------------------------------------------------------

def _rank_main(fn, rank: int, world: int, init_method: str, device: str,
               args: tuple, results) -> None:
    """A spawned rank: join the group, run fn(mesh, *args), report."""
    try:
        with frame_mesh(world, rank, init_method, device) as mesh:
            results.put((rank, True, fn(mesh, *args)))
    except Exception:  # reported to the launcher, which raises it
        results.put((rank, False, traceback.format_exc()))
        raise


def run_ranks(fn: Callable, world: int, device=None, *args) -> list:
    """Run ``fn(mesh, *args)`` in ``world`` spawned processes joined in one
    group (rendezvous through a file in a temporary directory); returns
    each rank's result in rank order.  ``fn`` and its results must pickle;
    ``device=None`` is the card.  Raises RuntimeError with the failing
    rank's traceback, and stops every rank it started."""
    device = str(resolve(device))
    ctx = torch.multiprocessing.get_context("spawn")
    results = ctx.Queue()
    with tempfile.TemporaryDirectory() as tmp:
        init = "file://" + os.path.join(tmp, "rendezvous")
        procs = [ctx.Process(target=_rank_main, daemon=True,
                             args=(fn, r, world, init, device, args, results))
                 for r in range(world)]
        for p in procs:
            p.start()
        got = {}
        try:
            for _ in range(world):
                try:
                    rank, ok, value = results.get(timeout=RESULT_TIMEOUT_S)
                except queue.Empty:
                    raise RuntimeError(f"no result from the ranks within "
                                       f"{RESULT_TIMEOUT_S} s") from None
                if not ok:
                    raise RuntimeError(f"rank {rank} failed:\n{value}")
                got[rank] = value
            for p in procs:
                p.join(timeout=60)
        finally:
            for p in procs:
                if p.is_alive():
                    p.terminate()
                    p.join(timeout=10)
    failed = [p.exitcode for p in procs if p.exitcode != 0]
    if failed:
        raise RuntimeError(f"ranks exited with codes {failed}")
    return [got[r] for r in range(world)]
