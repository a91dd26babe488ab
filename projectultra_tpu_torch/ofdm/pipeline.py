"""End-to-end OFDM frame pipeline (port of projectultra_tpu/ofdm/pipeline.py).

LDPC encode -> channel interleave -> OFDM modulate -> (channel) ->
presynced demodulate -> deinterleave -> LDPC decode, batched over frames,
on no-pilot plans (the differential fast path) and pilot plans (the
pilot-tracking scan) alike.
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

from ..config import CodeRate, ModemConfig, Modulation, bits_per_symbol
from ..fec import ldpc
from . import carriers as carriers_mod
from ..fec.interleave import channel_interleaver
from ..ops import cuda_graphs
from ..ops import ldpc as ldpc_ops
from ..utils import metrics
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

    def deinterleave(self, llrs: torch.Tensor) -> torch.Tensor:
        """[B, nbits] demodulated LLRs -> the [B*ncw, n] LDPC decoder
        input (the exact index gather ``blocks[:, perm]``)."""
        n = self.code.n
        blocks = llrs[:, :self.n_codewords * n].reshape(-1, n)
        return blocks[:, self.interleave_perm].contiguous()

    def decode(self, llrs: torch.Tensor):
        """[B, nbits] demodulated LLRs -> (info_bits [B, k*ncw] uint8, ok [B]
        bool, iters [B, ncw] int32): deinterleave, then LDPC decode."""
        B, ncw, k = llrs.shape[0], self.n_codewords, self.code.k
        llr_total, ok, iters = ldpc_ops.decode_totals(self.code,
                                                      self.deinterleave(llrs))
        info = (llr_total[:, :k] < 0).to(torch.uint8).reshape(B, ncw * k)
        return info, ok.reshape(B, ncw).all(-1), iters.reshape(B, ncw)

    def deinterleaved_llrs(self, samples: torch.Tensor, cfo_hz=0.0,
                           initial_phase=0.0) -> torch.Tensor:
        """[B, T] aligned passband -> the [B*ncw, n] LDPC decoder input."""
        llrs, _ = self.demodulator(samples, cfo_hz, initial_phase)
        return self.deinterleave(llrs)

    def rx(self, samples: torch.Tensor, cfo_hz=0.0, initial_phase=0.0):
        """[B, T] aligned passband -> (info_bits [B, k*ncw] uint8, ok [B]
        bool, iters [B, ncw] int32)."""
        with metrics.span("ofdm.rx", samples):
            llrs, _ = self.demodulator(samples, cfo_hz, initial_phase)
            return self.decode(llrs)


@functools.lru_cache(maxsize=None)
def pipeline_for(config: ModemConfig, mod: Modulation, rate: CodeRate,
                 n_codewords: int, device: torch.device) -> FramePipeline:
    return FramePipeline(config, mod, rate, n_codewords).to(device)


def tx_frame(config: ModemConfig, mod: Modulation, rate: CodeRate,
             info_bits: torch.Tensor) -> torch.Tensor:
    """[B, k] info bits -> [B, T] passband samples (training + data)."""
    return pipeline_for(config, mod, rate, 1, info_bits.device).tx(info_bits)


@functools.lru_cache(maxsize=None)
def _preamble_on(config: ModemConfig, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(mod_mod.generate_preamble(config)).to(device)


#: Captures and replays of the Cox TX's CUDA graphs (``tx_cox_frame`` on
#: a card), counted as the scan's are.
tx_captures = 0
tx_replays = 0
#: TX graphs kept, the least recently used dropped first, and shapes seen
#: once, the oldest dropped first.
TX_GRAPHS, TX_SEEN = 8, 64
_tx_graphs = cuda_graphs.Cache(TX_GRAPHS, TX_SEEN)


def _cox_data(config: ModemConfig, mod: Modulation, rate: CodeRate,
              n_codewords: int, info_bits: torch.Tensor) -> torch.Tensor:
    """[B, ncw*k] info bits -> [B, S*symbol] data symbols of a Cox frame:
    encoded, interleaved, modulated from ``preamble_data_t_offset``."""
    B, dev = info_bits.shape[0], info_bits.device
    pipe = pipeline_for(config, mod, rate, n_codewords, dev)
    cw = ldpc_ops.encode_with(pipe.code, info_bits.reshape(
        B * n_codewords, pipe.code.k))[:, pipe.interleave_inv]
    return mod_mod.modulate(config, mod, cw.reshape(B, -1),
                            t_offset=mod_mod.preamble_data_t_offset(config))


def tx_cox_frame(config: ModemConfig, mod: Modulation, rate: CodeRate,
                 info_bits: torch.Tensor, lead: int = 0, tail: int = 0,
                 n_codewords: int = 1) -> torch.Tensor:
    """[B, ncw*k] info bits -> [B, lead + 7*(N+CP) + S*symbol + tail]
    float32 Schmidl-Cox frames as the JAX bench and tests build them
    (bench.py:304-321, tests/test_delay_fit.py:32-46): ``lead`` zeros, the
    preamble, the frame's interleaved codewords modulated from
    ``preamble_data_t_offset``, ``tail`` zeros.  On a card, from a shape's
    second call on, the encode, interleave and modulation (``_cox_data``,
    ~25 launches) run as one replay of a CUDA graph
    (``ops/cuda_graphs.py``): the same kernels in the same order, so the
    same samples, without a host launch each; the frame's concatenation
    copies them out of the graph."""
    global tx_replays
    with metrics.span("cox.tx", info_bits):
        B, dev = info_bits.shape[0], info_bits.device
        data = None
        if dev.type == "cuda":
            key = (config, mod, rate, n_codewords, tuple(info_bits.shape),
                   info_bits.dtype, dev)

            def capture():
                global tx_captures
                tx_captures += 1
                return cuda_graphs.Captured(
                    functools.partial(_cox_data, config, mod, rate,
                                      n_codewords), (info_bits,))

            graph = _tx_graphs.get(key, capture)
            if graph is not None:
                tx_replays += 1
                data = graph((info_bits,))
        if data is None:
            data = _cox_data(config, mod, rate, n_codewords, info_bits)
        pre = _preamble_on(config, dev)
        return torch.cat([torch.zeros((B, lead), device=dev),
                          pre.expand(B, pre.shape[0]), data,
                          torch.zeros((B, tail), device=dev)], dim=-1)


def rx_frame(config: ModemConfig, mod: Modulation, rate: CodeRate,
             samples: torch.Tensor, cfo_hz=0.0, initial_phase=0.0,
             n_codewords: int = 1):
    """[B, T] aligned passband samples -> (info_bits [B, k*ncw], ok [B],
    iters [B, ncw])."""
    return pipeline_for(config, mod, rate, n_codewords,
                        samples.device).rx(samples, cfo_hz, initial_phase)
