"""The port's own host modules against the JAX package's originals.

The port keeps copies of ``config``, ``fec.ldpc``, ``ofdm.carriers``,
``ofdm.constellations`` and ``utils.mt19937`` so that it imports nothing of
the JAX package.  Each copy is pinned here equal to its original: enums by
name and value, ``ModemConfig`` by field and derived property, the LDPC
code tables of every rate, the carrier tables, the constellations and the
MT19937 streams; the speed-profile presets and ``for_profile`` field for
field.
"""

import dataclasses
import enum

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

from projectultra_tpu import config as JC  # noqa: E402
from projectultra_tpu.fec import ldpc as JL  # noqa: E402
from projectultra_tpu.ofdm import carriers as JCar  # noqa: E402
from projectultra_tpu.ofdm import constellations as JCon  # noqa: E402
from projectultra_tpu.ofdm import pipeline as JP  # noqa: E402
from projectultra_tpu.utils import mt19937 as JMT  # noqa: E402

from projectultra_tpu_torch import config as TC  # noqa: E402
from projectultra_tpu_torch.fec import ldpc as TL  # noqa: E402
from projectultra_tpu_torch.ofdm import carriers as TCar  # noqa: E402
from projectultra_tpu_torch.ofdm import constellations as TCon  # noqa: E402
from projectultra_tpu_torch.ofdm import pipeline as TP  # noqa: E402
from projectultra_tpu_torch.utils import mt19937 as TMT  # noqa: E402

RATES = [JC.CodeRate.R1_4, JC.CodeRate.R1_2, JC.CodeRate.R2_3,
         JC.CodeRate.R3_4, JC.CodeRate.R5_6]
ENUMS = ["Modulation", "CodeRate", "CyclicPrefixMode", "SpeedProfile",
         "FrameType"]
PRESETS = ["conservative", "balanced", "turbo", "high_throughput",
           "nvis_mode"]
PROPERTIES = ["cyclic_prefix", "symbol_duration", "symbol_rate",
              "num_pilots", "data_carriers"]


def port_config(cfg):
    """The port's ModemConfig with the fields of a JAX ModemConfig (enum
    fields as the port's own enums)."""
    kw = {}
    for f in dataclasses.fields(TC.ModemConfig):
        v = getattr(cfg, f.name)
        kw[f.name] = type(f.default)(v) if isinstance(f.default, enum.Enum) \
            else v
    return TC.ModemConfig(**kw)


# (JAX config, the port's own construction of the same config)
CONFIGS = {
    "default": (JC.ModemConfig(), TC.ModemConfig()),
    "ofdm_chirp": (JP.chirp_ofdm_config(), TP.chirp_ofdm_config()),
    "qam16_pilots": (
        JC.ModemConfig(modulation=JC.Modulation.QAM16,
                       code_rate=JC.CodeRate.R2_3, pilot_spacing=3),
        TC.ModemConfig(modulation=TC.Modulation.QAM16,
                       code_rate=TC.CodeRate.R2_3, pilot_spacing=3)),
    "wide_no_pilots": (
        JC.ModemConfig(fft_size=1024, num_carriers=59, use_pilots=False),
        TC.ModemConfig(fft_size=1024, num_carriers=59, use_pilots=False)),
    "long_cp_no_guard": (
        JC.ModemConfig(cp_mode=JC.CyclicPrefixMode.LONG, symbol_guard=0,
                       pilot_spacing=4),
        TC.ModemConfig(cp_mode=TC.CyclicPrefixMode.LONG, symbol_guard=0,
                       pilot_spacing=4)),
}


def test_the_copies_are_the_ports_own():
    assert TC.ModemConfig is not JC.ModemConfig
    assert TL.LDPCCode is not JL.LDPCCode
    assert TL.MT19937 is TMT.MT19937 is not JMT.MT19937
    assert TCar.ModemConfig is TC.ModemConfig
    assert TCon.Modulation is TC.Modulation


@pytest.mark.parametrize("name", ENUMS)
def test_enums_match(name):
    ours, ref = getattr(TC, name), getattr(JC, name)
    assert [(m.name, m.value) for m in ours] == \
        [(m.name, m.value) for m in ref]
    for m in ref:
        assert ours[m.name] == m and hash(ours[m.name]) == hash(m)


@pytest.mark.parametrize("mod", list(JC.Modulation))
def test_modulation_helpers_match(mod):
    ours = TC.Modulation(int(mod))
    assert TC.bits_per_symbol(ours) == JC.bits_per_symbol(mod)
    assert TC.is_differential(ours) == JC.is_differential(mod)


@pytest.mark.parametrize("rate", list(JC.CodeRate))
def test_code_rate_value_matches(rate):
    assert TC.code_rate_value(TC.CodeRate(int(rate))) == \
        JC.code_rate_value(rate)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_modem_config_matches(name):
    ref, ours = CONFIGS[name]
    assert type(ours) is TC.ModemConfig
    assert dataclasses.asdict(ours) == dataclasses.asdict(ref)
    for f in dataclasses.fields(ours):
        v = getattr(ours, f.name)
        if isinstance(v, enum.Enum):
            assert type(v).__module__ == TC.__name__, f.name
    for prop in PROPERTIES:
        assert getattr(ours, prop) == getattr(ref, prop), prop
    assert ours.theoretical_throughput(TC.Modulation.QPSK, TC.CodeRate.R1_2) \
        == ref.theoretical_throughput(JC.Modulation.QPSK, JC.CodeRate.R1_2)
    assert port_config(ref) == ours
    assert ours.replace(fft_size=1024).cyclic_prefix \
        == ref.replace(fft_size=1024).cyclic_prefix


@pytest.mark.parametrize("name", PRESETS)
def test_preset_matches(name):
    ours, ref = getattr(TC, name)(), getattr(JC, name)()
    assert type(ours) is TC.ModemConfig
    assert dataclasses.asdict(ours) == dataclasses.asdict(ref)
    assert port_config(ref) == ours
    for prop in PROPERTIES:
        assert getattr(ours, prop) == getattr(ref, prop), prop


@pytest.mark.parametrize("profile", list(JC.SpeedProfile))
def test_for_profile_matches(profile):
    ours = TC.for_profile(TC.SpeedProfile(int(profile)))
    assert dataclasses.asdict(ours) == \
        dataclasses.asdict(JC.for_profile(profile))


@pytest.mark.parametrize("rate", RATES)
def test_ldpc_code_matches(rate):
    ours, ref = TL.get_code(TC.CodeRate(int(rate))), JL.get_code(rate)
    assert type(ours) is TL.LDPCCode
    assert (ours.k, ours.m, ours.n, ours.max_degree) == \
        (ref.k, ref.m, ref.n, ref.max_degree)
    for key in ("h_dense", "row_vars", "row_mask"):
        a, b = getattr(ours, key), getattr(ref, key)
        assert a.dtype == b.dtype, key
        np.testing.assert_array_equal(a, b, err_msg=key)
    assert TL.build_h_rows(rate) == JL.build_h_rows(rate)


def test_ldpc_constants_match():
    for key in ("BLOCK_LENGTH", "H_SEED_BASE", "MIN_SUM_SCALE", "V2C_CLAMP",
                "DEFAULT_MAX_ITERS"):
        assert getattr(TL, key) == getattr(JL, key), key
    assert {int(r): v for r, v in TL.CODE_PARAMS.items()} == \
        {int(r): v for r, v in JL.CODE_PARAMS.items()}


@pytest.mark.parametrize("name", list(CONFIGS))
def test_carrier_tables_match(name):
    ref_cfg, cfg = CONFIGS[name]
    ours, ref = TCar.carrier_map(cfg), JCar.carrier_map(ref_cfg)
    for f in dataclasses.fields(ref):
        a, b = getattr(ours, f.name), getattr(ref, f.name)
        if isinstance(b, np.ndarray):
            assert a.dtype == b.dtype, f.name
        np.testing.assert_array_equal(a, b, err_msg=f.name)
    np.testing.assert_array_equal(TCar.lts_freq_domain(cfg),
                                  JCar.lts_freq_domain(ref_cfg))
    np.testing.assert_array_equal(TCar.sts_freq_domain(cfg),
                                  JCar.sts_freq_domain(ref_cfg))
    # Either package's config gives the port the same tables.
    assert TCar.carrier_map(ref_cfg) == ours


@pytest.mark.parametrize("mod", list(JC.Modulation))
def test_constellation_tables_match(mod):
    a, b = TCon.table(TC.Modulation(int(mod))), JCon.table(mod)
    assert a.dtype == b.dtype
    np.testing.assert_array_equal(a, b)


def test_constellation_extras_match():
    for a, b in zip(TCon.qam32_points_and_bits(),
                    JCon.qam32_points_and_bits()):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(TCon.DQPSK_PHASES, JCon.DQPSK_PHASES)
    bits = np.arange(16)
    np.testing.assert_array_equal(TCon.d8psk_phase(bits),
                                  JCon.d8psk_phase(bits))
    for key in ("QPSK_SCALE", "QAM16_SCALE", "QAM32_SCALE", "QAM64_SCALE",
                "QAM256_SCALE"):
        assert getattr(TCon, key) == getattr(JCon, key), key


@pytest.mark.parametrize("seed", [0, 5489, 0x12345678 + 2, 0x50494C54,
                                  0xFFFFFFFF])
def test_mt19937_matches(seed):
    a, b = TMT.MT19937(seed), JMT.MT19937(seed)
    assert [a() for _ in range(700)] == [b() for _ in range(700)]
    np.testing.assert_array_equal(a.raw(2000), b.raw(2000))
    la, lb = list(range(100)), list(range(100))
    TMT.fisher_yates_inplace(a, la)
    JMT.fisher_yates_inplace(b, lb)
    assert la == lb
