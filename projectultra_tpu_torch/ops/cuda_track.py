"""Wrapper of the hand-written pilot-tracking kernel (``csrc/pilot_track.cu``):
one OFDM symbol's pilot tracking, equalization and DQPSK demap, one thread a
lane, in one launch where the plain PyTorch path
(``ofdm/demodulator.update_channel_estimate``, ``equalize``,
``demodulate_symbol``) takes ~250.

A CUDA graph captures the kernel with the scan around it; this wrapper
allocates the new state's tensors (the channel estimate as a copy of the
old one, whose used bins the kernel then writes).  ``launches``
counts the kernel's runs on the card: each call of ``track_dqpsk_cuda``
outside a graph capture, and, added by the scan, each captured launch a
replay of its graph runs again.  The PyTorch path is its oracle on the
card.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from . import cuda_build

SOURCE = cuda_build.CSRC_DIR / "pilot_track.cu"
FLAGS: tuple[str, ...] = ()

#: Kernel runs: eager launches, and captured ones each time their graph
#: is replayed (a capture itself runs nothing).
launches = 0

#: The state fields the kernel reads and writes, in its order.
FIELDS = ("freq_offset_hz", "freq_offset_filtered", "channel_estimate",
          "dbpsk_prev", "pilot_phase_correction", "prev_pilot_phases",
          "have_prev_pilots", "noise_variance", "estimated_snr_linear",
          "snr_symbol_count", "symbols_since_sync", "timing_offset_samples")


def _bind(lib: ctypes.CDLL) -> None:
    vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.pilot_track_launch.argtypes = [vp, ctypes.POINTER(vp),
                                       ctypes.POINTER(vp), vp,
                                       ctypes.POINTER(vp)] + [ci] * 6 \
        + [cf] * 4 + [vp]
    lib.pilot_track_launch.restype = ci


LIBRARY = cuda_build.KernelLibrary("pilot_track", SOURCE, FLAGS, _bind)


@functools.lru_cache(maxsize=None)
def _tables(config, device: torch.device):
    """The kernel's constant tables on ``device`` (int32 bins, float32
    values, uint8 flags), made once per device."""
    from ..ofdm import carriers as carriers_mod
    from ..ofdm.demodulator import _interp_arrays
    cm = carriers_mod.carrier_map(config)
    two_pi = np.float32(2.0 * np.pi)
    bins, lo, up, a, has_l, has_u = _interp_arrays(config)

    def on(x, dtype):
        return torch.as_tensor(np.ascontiguousarray(x), dtype=dtype,
                               device=device)

    i32, f32, u8 = torch.int32, torch.float32, torch.uint8
    return (on(cm.data_idx, i32), on(cm.pilot_idx, i32),
            on(np.real(cm.pilot_seq), f32),
            on(np.asarray(cm.pilot_k, np.float32), f32),
            on(two_pi * np.asarray(cm.pilot_k, np.float32), f32),
            on(two_pi * np.asarray(cm.data_k, np.float32), f32),
            on(bins, i32), on(lo, i32), on(up, i32), on(a, f32),
            on(has_l & has_u, u8), on(has_l & ~has_u, u8))


def _pointers(tensors) -> ctypes.Array:
    return (ctypes.c_void_p * len(tensors))(*(t.data_ptr() for t in tensors))


def track_dqpsk_cuda(config, state, fd: torch.Tensor):
    """One symbol's tracking, equalization and DQPSK demap on the card:
    (state, fd [B, Cd + Np] complex64 used bins, data then pilots) ->
    (new state, llrs [B, Cd * 2]); the counterpart of
    ``update_channel_estimate`` -> ``equalize`` -> ``demodulate_symbol``
    for DQPSK on a pilot plan."""
    global launches
    from ..config import is_differential
    dev = fd.device
    tables = _tables(config, dev)
    Cd, Np, Ci = (int(tables[0].numel()), int(tables[1].numel()),
                  int(tables[6].numel()))
    B = fd.shape[0]
    if fd.dtype != torch.complex64 or fd.shape != (B, Cd + Np):
        raise ValueError(f"fd must be [B, {Cd + Np}] complex64, got "
                         f"{tuple(fd.shape)} {fd.dtype}")
    fd = fd.contiguous()
    old = [getattr(state, name).contiguous() for name in FIELDS]
    new = [t.clone() if name == "channel_estimate" else torch.empty_like(t)
           for name, t in zip(FIELDS, old)]
    llrs = torch.empty((B, Cd * 2), dtype=torch.float32, device=dev)
    N = config.fft_size
    sym_dur = config.symbol_duration / config.sample_rate
    inv_sym = float(np.float32(1.0) / np.float32(2 * np.pi * sym_dur))
    inv_two_pi = float(np.float32(1.0) / np.float32(2 * np.pi))
    with torch.cuda.device(dev):
        LIBRARY.run(
            "pilot_track_launch", fd.data_ptr(), _pointers(old),
            _pointers(new), llrs.data_ptr(), _pointers(tables), B, Cd, Np,
            Ci, N, int(not is_differential(config.modulation)), inv_sym,
            inv_two_pi, float(np.float32(1.0 / N)), 50.0 * (N / 512.0),
            torch.cuda.current_stream(dev).cuda_stream)
    if not torch.cuda.is_current_stream_capturing():
        launches += 1
    return state._replace(**dict(zip(FIELDS, new))), llrs
