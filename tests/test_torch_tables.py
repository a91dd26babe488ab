"""The port's constant-table builders against the JAX package's.

Every numpy table the PyTorch port re-homes (interleaver permutations,
oscillators, synthesis/analysis tensors, the LDPC per-variable edge table,
the Schmidl-Cox preamble and LTS template, the pilot interpolation table)
must be array-equal to the builder it replaces, and the interleaver must
match the reference's golden dump.
"""

import os

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

from projectultra_tpu.config import CodeRate, ModemConfig, Modulation  # noqa: E402
from projectultra_tpu.fec import interleave as jax_interleave  # noqa: E402
from projectultra_tpu.fec import ldpc  # noqa: E402
from projectultra_tpu.ofdm import demodulator as JD  # noqa: E402
from projectultra_tpu.ofdm import modulator as JM  # noqa: E402
from projectultra_tpu.ofdm import pipeline as JP  # noqa: E402
from projectultra_tpu.ops import ldpc as jax_ldpc_ops  # noqa: E402
from projectultra_tpu.ops import mixer as jax_mixer  # noqa: E402
from projectultra_tpu.sync import schmidl_cox as jax_sc  # noqa: E402

from projectultra_tpu_torch.fec import interleave as T_interleave  # noqa: E402
from projectultra_tpu_torch.ofdm import demodulator as TD  # noqa: E402
from projectultra_tpu_torch.ofdm import modulator as TM  # noqa: E402
from projectultra_tpu_torch.ofdm import pipeline as TP  # noqa: E402
from projectultra_tpu_torch.ops import ldpc as T_ldpc  # noqa: E402
from projectultra_tpu_torch.ops import mixer as T_mixer  # noqa: E402
from projectultra_tpu_torch.sync import schmidl_cox as T_sc  # noqa: E402

CHIRP_CFG = JP.chirp_ofdm_config()
PILOT_CFG = ModemConfig()  # 512/30 with pilots
WIDE_CFG = ModemConfig(fft_size=1024, num_carriers=59, pilot_spacing=4)
RATES = [CodeRate.R1_4, CodeRate.R1_2, CodeRate.R2_3, CodeRate.R3_4,
         CodeRate.R5_6]


def jax_tables(config, mod, rate, n_codewords=1):
    """The tables of FramePipeline.from_numpy, from the JAX package's own
    numpy builders."""
    L = config.symbol_duration
    S = JP.num_data_symbols(config, mod, n_codewords)
    inv, perm = JP._interleave_perms(config, mod)
    Ar, Ai, pilot_wave = JM._synthesis_tensors(config, 2 * L, S)
    Wr, Wi = JD._used_bins_w(config, L, "rect")
    Mr, Mi = JD._analysis_tensor(config, 2 * L, S)
    var_edges, _ = jax_ldpc_ops._var_edge_table(ldpc.get_code(rate))
    return {"interleave_inv": inv, "interleave_perm": perm,
            "var_edges": var_edges, "synth_r": Ar, "synth_i": Ai,
            "pilot_wave": pilot_wave,
            "training": JM.generate_training(config, 2),
            "lts_w_r": Wr, "lts_w_i": Wi, "analysis_r": Mr, "analysis_i": Mi}


@pytest.mark.parametrize("bps", [15, 30, 60, 90, 120, 240])
def test_channel_interleaver_matches_jax(bps):
    a = T_interleave.ChannelInterleaver(bps, 648)
    b = jax_interleave.ChannelInterleaver(bps, 648)
    np.testing.assert_array_equal(a.perm, b.perm)
    np.testing.assert_array_equal(a.inv, b.inv)
    assert a.symbol_separation == b.symbol_separation


def test_channel_interleaver_matches_reference(golden_dir):
    lines = open(os.path.join(golden_dir, "golden_chinterleaver.txt")) \
        .read().strip().split("\n")
    for line in lines:
        toks = line.split()
        bps, sep = int(toks[1]), int(toks[3])
        inv = np.array([int(x) for x in toks[5:]])
        ci = T_interleave.ChannelInterleaver(bps, 648)
        assert ci.symbol_separation == sep
        np.testing.assert_array_equal(ci.inv, inv)


@pytest.mark.parametrize("freq,n,offset", [(1500, 564, 0), (1500, 6204, 1128),
                                           (1517.5, 1000, 37)])
def test_osc_fixed_matches_jax(freq, n, offset):
    np.testing.assert_array_equal(T_mixer.osc_fixed(freq, 48000, n, offset),
                                  jax_mixer.osc_fixed(freq, 48000, n, offset))


@pytest.mark.parametrize("config,S", [(CHIRP_CFG, 11), (CHIRP_CFG, 33),
                                      (PILOT_CFG, 5)])
def test_synthesis_tensors_match_jax(config, S):
    t_off = 2 * config.symbol_duration
    ours = TM._synthesis_tensors(config, t_off, S)
    ref = JM._synthesis_tensors(config, t_off, S)
    for a, b in zip(ours, ref):
        if b is None:
            assert a is None
        else:
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("config", [CHIRP_CFG, PILOT_CFG])
def test_training_matches_jax(config):
    np.testing.assert_array_equal(TM.generate_training(config, 2),
                                  JM.generate_training(config, 2))


@pytest.mark.parametrize("config", [CHIRP_CFG, PILOT_CFG])
def test_used_bins_w_matches_jax(config):
    L = config.symbol_duration
    for a, b in zip(TD._used_bins_w(config, L),
                    JD._used_bins_w(config, L, "rect")):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("S", [11, 33])
def test_analysis_tensor_matches_jax(S):
    t0 = 2 * CHIRP_CFG.symbol_duration
    for a, b in zip(TD._analysis_tensor(CHIRP_CFG, t0, S),
                    JD._analysis_tensor(CHIRP_CFG, t0, S)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("rate", RATES)
def test_var_edge_table_matches_jax(rate):
    code = ldpc.get_code(rate)
    tab, Dv = T_ldpc._var_edge_table(code)
    ref, ref_Dv = jax_ldpc_ops._var_edge_table(code)
    assert Dv == ref_Dv
    np.testing.assert_array_equal(tab, ref)


@pytest.mark.parametrize("n_codewords", [1, 3])
def test_build_tables_matches_jax_builders(n_codewords):
    ours = TP.build_tables(CHIRP_CFG, Modulation.DQPSK, CodeRate.R1_2,
                           n_codewords)
    ref = jax_tables(CHIRP_CFG, Modulation.DQPSK, CodeRate.R1_2, n_codewords)
    assert ours.keys() == ref.keys()
    for key in ref:
        if ref[key] is None:
            assert ours[key] is None, key
        else:
            np.testing.assert_array_equal(ours[key], ref[key], err_msg=key)


def test_pipeline_buffers_hold_the_tables():
    tables = TP.build_tables(CHIRP_CFG, Modulation.DQPSK, CodeRate.R1_2)
    pipe = TP.FramePipeline(CHIRP_CFG, Modulation.DQPSK, CodeRate.R1_2,
                            tables=tables)
    np.testing.assert_array_equal(pipe.interleave_perm.numpy(),
                                  tables["interleave_perm"])
    np.testing.assert_array_equal(pipe.modulator.synth_r.numpy(),
                                  tables["synth_r"])
    np.testing.assert_array_equal(pipe.demodulator.analysis_i.numpy(),
                                  tables["analysis_i"])
    np.testing.assert_array_equal(pipe.code.var_edges.numpy(),
                                  tables["var_edges"])
    names = {n for n, _ in pipe.named_buffers()}
    assert {"training_wave", "interleave_inv", "interleave_perm",
            "code.row_vars", "modulator.synth_i",
            "demodulator.lts_wr"} <= names


@pytest.mark.parametrize("config", [PILOT_CFG, CHIRP_CFG, WIDE_CFG,
                                    PILOT_CFG.replace(tx_cfo_hz=12.5)])
def test_preamble_matches_jax(config):
    ours = TM.generate_preamble(config)
    np.testing.assert_array_equal(ours, JM.generate_preamble(config))
    plen = config.fft_size + config.cyclic_prefix
    assert ours.dtype == np.float32 and ours.shape == (7 * plen,)
    assert TM.preamble_data_t_offset(config) \
        == JM.preamble_data_t_offset(config) == 2 * plen


@pytest.mark.parametrize("config", [PILOT_CFG, WIDE_CFG])
def test_lts_passband_template_matches_jax(config):
    np.testing.assert_array_equal(T_sc.lts_passband_template(config),
                                  jax_sc.lts_passband_template(config))


@pytest.mark.parametrize("config", [PILOT_CFG, WIDE_CFG,
                                    ModemConfig(num_carriers=31),
                                    ModemConfig(pilot_spacing=3)])
def test_interp_arrays_match_jax(config):
    for a, b in zip(TD._interp_arrays(config), JD._interp_arrays(config)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
