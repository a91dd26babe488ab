"""End-to-end OFDM frame pipeline (port of projectultra_tpu/ofdm/pipeline.py).

LDPC encode -> channel interleave -> OFDM modulate -> (channel) ->
presynced demodulate -> deinterleave -> LDPC decode, batched over frames.
``FramePipeline`` holds every constant table as a buffer; the plain
functions ``tx_frame``/``rx_frame`` keep the JAX signatures over a
per-(config, mod, rate, n_codewords, device) pipeline cache.

The deinterleave is the exact index gather ``blocks[:, perm]``.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
from torch import nn

from projectultra_tpu.config import (ModemConfig, Modulation, CodeRate,
                                     bits_per_symbol)
from projectultra_tpu.fec import ldpc
from projectultra_tpu.ofdm import carriers as carriers_mod

from ..fec.interleave import channel_interleaver
from ..ops import ldpc as ldpc_ops
from . import demodulator as demod_mod
from . import modulator as mod_mod

TRAINING_SYMBOLS = 2  # OFDM_CHIRP uses chirp + 2 LTS (ofdm_chirp_waveform.cpp:110-118)


def _interleave_perms(config: ModemConfig, mod: Modulation):
    """(inv, perm) of the channel interleaver for this carrier plan."""
    cm = carriers_mod.carrier_map(config)
    bps = len(cm.data_idx) * bits_per_symbol(mod)
    ci = channel_interleaver(bps, ldpc.BLOCK_LENGTH)
    return np.asarray(ci.inv), np.asarray(ci.perm)


def num_data_symbols(config: ModemConfig, mod: Modulation,
                     n_codewords: int = 1) -> int:
    cm = carriers_mod.carrier_map(config)
    per_sym = len(cm.data_idx) * bits_per_symbol(mod)
    return -(-(ldpc.BLOCK_LENGTH * n_codewords) // per_sym)


def frame_samples(config: ModemConfig, mod: Modulation,
                  n_codewords: int = 1) -> int:
    """Total samples per frame (training + data symbols)."""
    S = num_data_symbols(config, mod, n_codewords)
    return (TRAINING_SYMBOLS + S) * config.symbol_duration


def chirp_ofdm_config(modulation: Modulation = Modulation.DQPSK,
                      rate: CodeRate = CodeRate.R1_2) -> ModemConfig:
    """OFDM_CHIRP waveform config (ofdm_chirp_waveform.cpp:10-31):
    512-FFT, 30 carriers, differential, no pilots."""
    return ModemConfig(fft_size=512, num_carriers=30, modulation=modulation,
                       code_rate=rate, use_pilots=False)


def build_tables(config: ModemConfig, mod: Modulation, rate: CodeRate,
                 n_codewords: int = 1) -> dict:
    """Every constant table of a pipeline, as numpy arrays, from the
    port's own builders (keys as ``FramePipeline``'s ``tables`` takes them)."""
    L = config.symbol_duration
    S = num_data_symbols(config, mod, n_codewords)
    inv, perm = _interleave_perms(config, mod)
    Ar, Ai, pilot_wave = mod_mod._synthesis_tensors(
        config, TRAINING_SYMBOLS * L, S)
    Wr, Wi = demod_mod._used_bins_w(config, L)
    Mr, Mi = demod_mod._analysis_tensor(config, TRAINING_SYMBOLS * L, S)
    var_edges, _ = ldpc_ops._var_edge_table(ldpc.get_code(rate))
    return {
        "interleave_inv": inv, "interleave_perm": perm,
        "var_edges": var_edges,
        "synth_r": Ar, "synth_i": Ai, "pilot_wave": pilot_wave,
        "training": mod_mod.generate_training(config, TRAINING_SYMBOLS),
        "lts_w_r": Wr, "lts_w_i": Wi,
        "analysis_r": Mr, "analysis_i": Mi,
    }


class FramePipeline(nn.Module):
    """One (config, modulation, rate, codewords-per-frame) frame pipeline.

    ``tx(info_bits [B, ncw*k]) -> [B, T]`` passband and
    ``rx(samples [B, T]) -> (info [B, ncw*k] uint8, ok [B] bool,
    iters [B, ncw] int32)``.  Runs on the device its buffers were moved
    to with ``.to(device)``.  ``tables`` gives the constant tables as numpy
    arrays, keys as ``build_tables`` (for example from the JAX package's
    own numpy builders); by default the port builds its own."""

    def __init__(self, config: ModemConfig, mod: Modulation, rate: CodeRate,
                 n_codewords: int = 1, tables: dict | None = None):
        super().__init__()
        if tables is None:
            tables = build_tables(config, mod, rate, n_codewords)
        self.config, self.mod, self.rate = config, mod, rate
        self.n_codewords = n_codewords
        self.num_data_symbols = num_data_symbols(config, mod, n_codewords)
        self.code = ldpc_ops.LDPCGraph(ldpc.get_code(rate),
                                       var_edges=tables["var_edges"])
        self.modulator = mod_mod.Modulator(
            config, mod, self.num_data_symbols,
            synthesis=(tables["synth_r"], tables["synth_i"],
                       tables["pilot_wave"]))
        self.demodulator = demod_mod.Demodulator(
            config, mod, TRAINING_SYMBOLS, self.num_data_symbols,
            bins_w=(tables["lts_w_r"], tables["lts_w_i"]),
            analysis=(tables["analysis_r"], tables["analysis_i"]))
        self.register_buffer("training_wave", torch.from_numpy(
            np.asarray(tables["training"], np.float32)))
        self.register_buffer("interleave_inv", torch.from_numpy(
            np.asarray(tables["interleave_inv"], np.int64)))
        self.register_buffer("interleave_perm", torch.from_numpy(
            np.asarray(tables["interleave_perm"], np.int64)))

    def tx(self, info_bits: torch.Tensor) -> torch.Tensor:
        """[B, ncw*k] info bits -> [B, T] passband (training + data)."""
        B = info_bits.shape[0]
        k, n = self.code.k, self.code.n
        cw = ldpc_ops.encode_with(
            self.code, info_bits.reshape(B * self.n_codewords, k))
        interleaved = cw[:, self.interleave_inv]            # out[p[i]] = in[i]
        data = self.modulator(interleaved.reshape(B, self.n_codewords * n))
        training = self.training_wave.expand(B, self.training_wave.shape[0])
        return torch.cat([training, data], dim=-1)

    def deinterleaved_llrs(self, samples: torch.Tensor, cfo_hz=0.0,
                           initial_phase=0.0) -> torch.Tensor:
        """[B, T] aligned passband -> the [B*ncw, n] LDPC decoder input."""
        llrs, _ = self.demodulator(samples, cfo_hz, initial_phase)
        n = self.code.n
        blocks = llrs[:, :self.n_codewords * n].reshape(-1, n)
        return blocks[:, self.interleave_perm].contiguous()

    def rx(self, samples: torch.Tensor, cfo_hz=0.0, initial_phase=0.0):
        """[B, T] aligned passband -> (info_bits [B, k*ncw] uint8, ok [B]
        bool, iters [B, ncw] int32)."""
        B, ncw, k = samples.shape[0], self.n_codewords, self.code.k
        deint = self.deinterleaved_llrs(samples, cfo_hz, initial_phase)
        llr_total, ok, iters = ldpc_ops.decode_totals(self.code, deint)
        info = (llr_total[:, :k] < 0).to(torch.uint8).reshape(B, ncw * k)
        return info, ok.reshape(B, ncw).all(-1), iters.reshape(B, ncw)


@functools.lru_cache(maxsize=None)
def pipeline_for(config: ModemConfig, mod: Modulation, rate: CodeRate,
                 n_codewords: int, device: torch.device) -> FramePipeline:
    return FramePipeline(config, mod, rate, n_codewords).to(device)


def tx_frame(config: ModemConfig, mod: Modulation, rate: CodeRate,
             info_bits: torch.Tensor) -> torch.Tensor:
    """[B, k] info bits -> [B, T] passband samples (training + data)."""
    return pipeline_for(config, mod, rate, 1, info_bits.device).tx(info_bits)


def rx_frame(config: ModemConfig, mod: Modulation, rate: CodeRate,
             samples: torch.Tensor, cfo_hz=0.0, initial_phase=0.0,
             n_codewords: int = 1):
    """[B, T] aligned passband samples -> (info_bits [B, k*ncw], ok [B],
    iters [B, ncw])."""
    return pipeline_for(config, mod, rate, n_codewords,
                        samples.device).rx(samples, cfo_hz, initial_phase)
