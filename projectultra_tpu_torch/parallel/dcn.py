"""Multi-process sweep scaling: the frame axis split over
``torch.distributed`` ranks (port of projectultra_tpu/parallel/dcn.py).

The workload is the acquisition-inclusive MC-DPSK sweep (the
``parallel/sweep.run_point_mc_dpsk`` path at ``level10``, R1/4): dual-chirp
detection -> per-frame slice at the detected training start -> demod at
the detected CFO -> LDPC -> global counts.  Every rank builds the same
deterministic host inputs, computes on its own rows only, and receives the
counts summed over the group.

The counts do not depend on the topology: JAX gets that from threefry
inside one program; here every rank draws the noise of the WHOLE [B, T]
batch from one generator seeded the same on every rank, and keeps its own
rows, so one process of world 1 and two of world 2 see the same noise on
every frame (within one device type: a CUDA generator's stream is not the
CPU's).
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import CodeRate
from ..fec import ldpc
from ..psk import mc_dpsk as MC
from ..sim import watterson as W
from . import mesh as mesh_mod

RATE = CodeRate.R1_4


def build_inputs(B: int, seed: int = 7):
    """Deterministic host sweep inputs, identical on every rank:
    (mc config, its chirp config, the code, info [B, k] and tx [B, T],
    both float32 numpy)."""
    mc = MC.level10()
    code = ldpc.get_code(RATE)
    rng = np.random.default_rng(seed)
    info = rng.integers(0, 2, size=(B, code.k)).astype(np.float32)
    tx = MC.tx_chirp_frame(mc, RATE, torch.from_numpy(info)).numpy()
    return mc, mc.chirp_config(), code, info, tx


def noisy_rows(mesh: mesh_mod.FrameMesh, tx: np.ndarray, snr_db: float,
               seed: int) -> torch.Tensor:
    """This rank's rows of the harness AWGN (``add_noise_active``) on
    ``tx`` [B, T], the normals of the whole batch drawn from one generator
    seeded ``seed`` on the rank's device: each frame's noise is the same at
    every world size."""
    g = torch.Generator(device=mesh.device).manual_seed(seed)
    noise = torch.randn(tx.shape, generator=g, device=mesh.device)
    tx_l, noise_l = mesh_mod.shard_frames(mesh, tx, noise)
    return W.add_noise_with(tx_l, snr_db, noise_l)


def acq_sweep_counts(B: int = 16, snr_db: float = 5.0, seed: int = 7,
                     device=None, mesh: mesh_mod.FrameMesh | None = None
                     ) -> dict:
    """The global acquisition sweep over every rank of ``mesh`` (a world of
    one on ``device`` when None; ``device=None`` is the card).

    Returns {"decoded": int, "found": int, "bit_errors": int}, equal on
    every rank and identical whatever the number of ranks."""
    if mesh is None:
        with mesh_mod.frame_mesh(device=device) as mesh:
            return acq_sweep_counts(B, snr_db, seed, mesh=mesh)
    mc, _, _, info, tx = build_inputs(B, seed)
    rx = noisy_rows(mesh, tx, snr_db, seed + 1)
    out, ok, _, det = MC.decode_chirp_batch(mc, RATE, rx)
    truth = mesh_mod.shard_frames(mesh, info).to(torch.uint8)
    good = ok & (out == truth).all(-1)
    counts = mesh_mod.all_sum(mesh, torch.stack([
        good.sum(), det["success"].sum(), (out != truth).sum()]))
    decoded, found, errors = counts.tolist()
    return {"decoded": decoded, "found": found, "bit_errors": errors}
