"""The entry points of ``__graft_entry__.py`` on the port (its twin):
the single-step compile check ``entry`` and the multi-rank dry run
``dryrun_multichip``.

``dryrun_multichip(n)`` spawns n ranks (``mesh.run_ranks``) and runs five
frame-sharded steps on each at the JAX dry run's tiny shapes, each ending
in the sum of its failure count over the group (the only collective the
domain needs): the presynced OFDM pipeline (DQPSK R1/2), single-carrier
DPSK ``medium`` at 48 samples a symbol, the 8-tone MFSK, chirp acquisition
(``level10``, 5 dB) and Schmidl-Cox acquisition (the ``ModemConfig()``
pilot plan at 17 dB, which runs the window kernel on a card).  Every step
must decode every frame.  The inputs are made on the host from numpy seeds
and are the same on every rank; acquisition noise is drawn for the whole
batch on every rank (``dcn.noisy_rows``), so no step depends on n.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..config import CodeRate, ModemConfig, Modulation
from ..device import resolve
from ..fec import ldpc
from ..ofdm import pipeline as P
from ..ops import cuda_ldpc, cuda_sc
from ..ops import ldpc as ldpc_ops
from ..psk import dpsk as DP
from ..psk import fsk as FSK
from ..sim import watterson as W
from ..sync import schmidl_cox as SC
from . import dcn
from . import mesh as mesh_mod

MOD, RATE = Modulation.DQPSK, CodeRate.R1_2
RATE4 = CodeRate.R1_4


def entry(device=None):
    """(fn, example_args): one OFDM-DQPSK-R1/2 frame encode + 17 dB channel
    + decode step on the flagship pipeline, on ``device`` (the card when
    None): ``fn(info_bits, generator) -> (out, ok)``."""
    dev = resolve(device)
    cfg = P.chirp_ofdm_config()
    code = ldpc.get_code(RATE)

    def fn(info_bits, generator):
        tx = P.tx_frame(cfg, MOD, RATE, info_bits)
        rx_in = W.add_noise_active(tx, 17.0, generator)
        out, ok, _ = P.rx_frame(cfg, MOD, RATE, rx_in)
        return out, ok

    rng = np.random.default_rng(0)
    info = torch.from_numpy(
        rng.integers(0, 2, size=(8, code.k)).astype(np.float32)).to(dev)
    return fn, (info, torch.Generator(device=dev).manual_seed(0))


def _require(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"multichip dryrun: {what}")


def _failures(mesh, ok: torch.Tensor) -> int:
    return int(mesh_mod.all_sum(mesh, (~ok).sum()[None])[0])


def _step_ofdm(mesh) -> int:
    """Per-shard TX -> 0.05 x noise -> RX, with the summed bit and frame
    errors (two frames a rank)."""
    cfg = P.chirp_ofdm_config()
    code = ldpc.get_code(RATE)
    B = 2 * mesh.world
    rng = np.random.default_rng(0)
    info = rng.integers(0, 2, (B, code.k)).astype(np.float32)
    noise = rng.standard_normal((B, P.frame_samples(cfg, MOD))) \
        .astype(np.float32)
    info_l, noise_l = mesh_mod.shard_frames(mesh, info, noise)
    step = mesh_mod.sharded_pipeline_step(cfg, MOD, RATE, mesh)
    out, ok, totals = step(info_l, 0.05 * noise_l)
    _require(tuple(out.shape) == (B // mesh.world, code.k), "output shape")
    _require(bool(ok.all()), "decode failed")
    _require(int(totals[1]) == 0, "frame errors on another rank")
    return int(totals[1])


def _steps_dpsk_mfsk(mesh) -> tuple[int, int]:
    """Presynced single-carrier DPSK and MFSK on tiny symbols: TX -> 0.05 x
    noise -> soft demod -> LDPC (the MFSK tones are mapped on the host)."""
    code4 = ldpc.get_code(RATE4)
    B = 2 * mesh.world
    dcfg = dataclasses.replace(DP.medium(), samples_per_symbol=48)
    # Tiny-but-orthogonal: tone spacing = fs/L (250 Hz over 192 samples)
    # keeps the 8 tones separable in the short analysis window.
    mcfg = FSK.MFSKConfig(num_tones=8, samples_per_symbol=192,
                          tone_spacing=250.0, repetition=1)
    rng = np.random.default_rng(1)
    info4 = rng.integers(0, 2, (B, code4.k)).astype(np.float32)
    tones = FSK.mfsk_bits_to_tones(
        mcfg, ldpc_ops.encode(code4, torch.from_numpy(info4))).numpy()
    n_sym_d = -(-code4.n // dcfg.bits_per_symbol)
    noise_d = rng.standard_normal(
        (B, n_sym_d * dcfg.samples_per_symbol)).astype(np.float32)
    noise_m = rng.standard_normal(
        (B, tones.shape[1] * mcfg.samples_per_symbol)).astype(np.float32)

    info_l, noise_l = mesh_mod.shard_frames(mesh, info4, noise_d)
    b = info_l.shape[0]
    d_rx = DP.modulate(dcfg, ldpc_ops.encode(code4, info_l)) + 0.05 * noise_l
    llr_d = DP.demodulate_soft(
        dcfg, d_rx, torch.ones(b, dtype=torch.complex64, device=mesh.device),
        torch.zeros(b, device=mesh.device), torch.zeros(b, device=mesh.device))
    _, ok_d, _ = ldpc_ops.decode(code4, llr_d[:, :code4.n].contiguous())
    fails_d = _failures(mesh, ok_d)
    _require(fails_d == 0, "DPSK decode failed")

    tones_l, noise_l = mesh_mod.shard_frames(mesh, tones, noise_m)
    m_rx = FSK.mfsk_modulate_tones(mcfg, tones_l) + 0.05 * noise_l
    llr_m = FSK.mfsk_demodulate_soft(mcfg, m_rx)
    _, ok_m, _ = ldpc_ops.decode(code4, llr_m[:, :code4.n].contiguous())
    fails_m = _failures(mesh, ok_m)
    _require(fails_m == 0, "MFSK decode failed")
    return fails_d, fails_m


def _step_chirp(mesh) -> int:
    """Real acquisition, nothing presynced: dual-chirp detection over the
    noisy buffer, each frame cut at its detected training start, MC-DPSK at
    the detected CFO, LDPC (``dcn.acq_sweep_counts``, one frame a rank)."""
    counts = dcn.acq_sweep_counts(mesh.world, 5.0, seed=2, mesh=mesh)
    fails = mesh.world - counts["decoded"]
    _require(fails == 0, "sharded chirp acquisition failed")
    return fails


def _step_cox(mesh) -> int:
    """Schmidl-Cox acquisition, nothing presynced: STS plateau search and
    LTS fine timing (``detect_preamble``, the window kernel on a card),
    each frame cut at its detected first LTS, pilot-tracked demodulation
    at the detected CFO, the deinterleaving gather, LDPC (one frame a
    rank)."""
    cfg = ModemConfig()  # the default 512-FFT pilot plan (OFDM_COX)
    code = ldpc.get_code(RATE)
    rng = np.random.default_rng(3)
    info = rng.integers(0, 2, (mesh.world, code.k)).astype(np.float32)
    tx = P.tx_cox_frame(cfg, MOD, RATE, torch.from_numpy(info), lead=1504,
                        tail=2048).numpy()
    rx = dcn.noisy_rows(mesh, tx, 17.0, seed=9)
    out, ok, _, _ = SC.decode_cox_batch(cfg, MOD, RATE, rx)
    truth = mesh_mod.shard_frames(mesh, info).to(torch.uint8)
    fails = _failures(mesh, ok & (out == truth).all(-1))
    _require(fails == 0, "sharded Schmidl-Cox acquisition failed")
    return fails


def _dryrun_rank(mesh) -> dict:
    """The five steps on one rank; returns their summed failure counts,
    the all-reduce's median ms and this rank's kernel launches."""
    fails = {"ofdm": _step_ofdm(mesh)}
    fails["dpsk"], fails["mfsk"] = _steps_dpsk_mfsk(mesh)
    fails["chirp"] = _step_chirp(mesh)
    fails["cox"] = _step_cox(mesh)
    return {"rank": mesh.rank, "world": mesh.world,
            "backend": mesh.backend, "device": str(mesh.device),
            "failures": fails, "allreduce_ms": mesh_mod.all_sum_ms(mesh),
            "launches": {"ldpc_minsum": cuda_ldpc.launches,
                         "sc_windows": cuda_sc.launches}}


def dryrun_multichip(n_devices: int, device=None) -> list[dict]:
    """Run the five frame-sharded steps on ``n_devices`` spawned ranks
    (NCCL with a card per rank, gloo on a shared card or on the CPU;
    ``device=None`` is the card).  Raises if any rank fails a step;
    returns each rank's report (``_dryrun_rank``)."""
    return mesh_mod.run_ranks(_dryrun_rank, int(n_devices), device)
