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


# ---------------------------------------------------------------------------
# The engine's host modules: ModemStats, wideband SNR, exciser, blanker
# ---------------------------------------------------------------------------

from projectultra_tpu.modem import blanker as JBL  # noqa: E402
from projectultra_tpu.modem import excision as JEX  # noqa: E402
from projectultra_tpu.modem import wideband_snr as JWB  # noqa: E402
from projectultra_tpu.utils import metrics as JME  # noqa: E402

from projectultra_tpu_torch.modem import blanker as TBL  # noqa: E402
from projectultra_tpu_torch.modem import excision as TEX  # noqa: E402
from projectultra_tpu_torch.modem import wideband_snr as TWB  # noqa: E402
from projectultra_tpu_torch.utils import metrics as TME  # noqa: E402


def test_modem_stats_match():
    ours, ref = TME.ModemStats(), JME.ModemStats()
    assert [f.name for f in dataclasses.fields(ours)] == \
        [f.name for f in dataclasses.fields(ref)]
    for f in dataclasses.fields(ref):
        a, b = getattr(ours, f.name), getattr(ref, f.name)
        assert a == b and type(a).__name__ == type(b).__name__, f.name
    assert type(ours.current_modulation) is TC.Modulation


@pytest.mark.parametrize("kw", [
    {}, dict(frames=10, decoded=9, bit_errors=5, total_bits=6480),
    dict(frames=7, decoded=7, ldpc_iterations_mean=1.5, snr_estimate_db=3.2,
         cfo_error_hz=-0.25, pipelines_per_sec=1e4)])
def test_batch_metrics_match(kw):
    ours, ref = TME.BatchMetrics(**kw), JME.BatchMetrics(**kw)
    assert [(f.name, f.type, f.default) for f in dataclasses.fields(ours)] \
        == [(f.name, f.type, f.default) for f in dataclasses.fields(ref)]
    assert dataclasses.asdict(ours) == dataclasses.asdict(ref)
    assert (ours.fer, ours.ber) == (ref.fer, ref.ber)


@pytest.mark.parametrize("results", [None, {}, {"demod": 0.5, "sync": 1.0}])
def test_stage_timer_matches(results, monkeypatch):
    """Both timers add the block's perf_counter span to results[name] (and
    leave other stages alone); None results are ignored."""
    import time as _time
    ticks = iter([10.0, 10.25, 20.0, 20.25])
    monkeypatch.setattr(_time, "perf_counter", lambda: next(ticks))
    got = {}
    for name, mod in (("port", TME), ("jax", JME)):
        res = None if results is None else dict(results)
        with mod.stage_timer("demod", res):
            pass
        got[name] = res
    assert got["port"] == got["jax"]
    if results is not None:
        assert got["port"]["demod"] == results.get("demod", 0.0) + 0.25


def test_device_trace_writes_a_trace(tmp_path):
    import torch as _torch
    with TME.device_trace(str(tmp_path)) as prof:
        _torch.ones(4).sum()
    assert prof is not None and (tmp_path / "trace.json").stat().st_size > 0


# The program's spans (``utils/metrics.span``) on each path the benchmark
# drives: (name, parent's name) in the order they open, and the harness
# span each lies in.
SPAN_TREES = {
    "presynced": [("noise.awgn", None), ("ofdm.rx", None),
                  ("ofdm.demodulate", "ofdm.rx"), ("ldpc.decode", "ofdm.rx")],
    "acquired": [("mcdpsk.tx", None), ("noise.awgn", None),
                 ("mcdpsk.rx", None), ("chirp.detect", "mcdpsk.rx"),
                 ("chirp.decimate", "chirp.detect"),
                 ("mcdpsk.demodulate", "mcdpsk.rx"),
                 ("ldpc.decode", "mcdpsk.rx")],
}
HARNESS_SPAN = {"mcdpsk.tx": "tx", "noise.awgn": "channel"}
ENTRY_CELLS = {"presynced": ("ofdm_chirp-presynced-17db", 8),
               "acquired": ("mcdpsk_l10-chirp-acquire-5db-b2048", 2)}


def _entry_step(path):
    """A benchmark entry kind at a tiny batch and its first window step's
    inputs, on the CPU: (entry, info, noise)."""
    from benchmark import harness, traffic as BT
    name, batch = ENTRY_CELLS[path]
    cell = harness.load_cell(name)
    mix = dataclasses.replace(cell.traffic, batch=batch)
    entry = cell.entry.Entry(cell.config, mix, torch.device("cpu"))
    info, noise = BT.inputs(mix, entry.k, entry.T, 2**31 + 17, 0,
                            torch.device("cpu"))
    return entry, info, noise


def _step(entry, info, noise, mark=lambda _name: None):
    with entry.precision():
        return entry.step(info, noise, mark)


def _tree(spans):
    names = {s.id: s.name for s in spans}
    return [(s.name, names.get(s.parent)) for s in spans]


def test_span_records_nothing_outside_tracing(monkeypatch):
    def boom(*_a, **_k):
        raise AssertionError("made while tracing is off")
    monkeypatch.setattr(torch.cuda, "Event", boom)
    monkeypatch.setattr(torch.profiler, "record_function", boom)
    assert TME._recorder is None
    with TME.span("ldpc.decode", torch.ones(2)) as rec:
        assert rec is None
    for path in SPAN_TREES:
        _step(*_entry_step(path))
    assert TME._recorder is None


@pytest.mark.parametrize("path", sorted(SPAN_TREES))
def test_spans_change_no_output(path):
    entry, info, noise = _entry_step(path)
    off = _step(entry, info, noise)
    with TME.tracing():
        on = _step(entry, info, noise)
    for key in ("tx", "rx", "bits", "ok", "iters"):
        assert torch.equal(off[key], on[key]), key
    for key, value in off.get("det", {}).items():
        assert torch.equal(value, on["det"][key]), key


@pytest.mark.parametrize("path", sorted(SPAN_TREES))
def test_span_tree_of_a_step(path):
    """One step drains exactly its path's spans: names, parents, one batch
    id, each host interval inside its parent's; no CUDA events on the
    CPU."""
    entry, info, noise = _entry_step(path)
    with TME.tracing() as rec:
        batch = rec.next_batch()
        _step(entry, info, noise)
        spans = rec.drain()
        assert rec.drain() == []
    assert TME._recorder is None
    assert _tree(spans) == SPAN_TREES[path]
    assert {s.batch for s in spans} == {batch}
    by_id = {s.id: s for s in spans}
    for s in spans:
        assert s.host_start_ns <= s.host_end_ns
        assert s.start is None and s.end is None and s.device_ms() is None
        if s.parent is not None:
            p = by_id[s.parent]
            assert p.host_start_ns <= s.host_start_ns
            assert s.host_end_ns <= p.host_end_ns


def test_recorder_batches_nesting_and_errors():
    with TME.tracing() as rec:
        with TME.tracing() as inner:
            assert inner is rec
        with TME.span("a"):
            with TME.span("b"):
                pass
        rec.next_batch()
        with pytest.raises(ValueError):
            with TME.span("c"):
                raise ValueError("the stage failed")
        with TME.span("d"):
            pass
        spans = rec.drain()
    assert _tree(spans) == [("a", None), ("b", "a"), ("c", None),
                            ("d", None)]
    assert [s.batch for s in spans] == [0, 0, 1, 1]
    assert all(s.host_ms() >= 0 for s in spans)
    assert TME._recorder is None


@pytest.mark.parametrize("path", sorted(SPAN_TREES))
def test_spans_in_a_cpu_profile(path):
    """Under ``torch.profiler`` each program span is a user annotation,
    once, inside the harness span ("tx", "channel" or "rx") of the step
    that ran it."""
    from torch.autograd import DeviceType
    from benchmark import harness
    entry, info, noise = _entry_step(path)
    marks = harness.Marks(torch.device("cpu"))
    with TME.tracing(), torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        marks.begin()
        out = _step(entry, info, noise, marks)
        marks("tally")
        entry.tally(out, info)
        marks.end()
    ranges = [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
              for e in prof.profiler.kineto_results.events()
              if e.device_type() == DeviceType.CPU and e.is_user_annotation()]
    program = [r for r in ranges if r[0] in dict(SPAN_TREES[path])]
    assert sorted(r[0] for r in program) == sorted(
        n for n, _ in SPAN_TREES[path])
    harness_spans = [r for r in ranges if r[0] in marks.names]
    for name, a, b in program:
        around = [h for h, ha, hb in harness_spans if ha <= a and b <= hb]
        assert around == [HARNESS_SPAN.get(name, "rx")], name


def test_device_trace_holds_the_program_spans(tmp_path):
    import json
    from projectultra_tpu_torch.ops import ldpc as TLO
    code = TL.get_code(TC.CodeRate.R1_2)
    graph = TLO.graph_for(code, torch.device("cpu"))
    llrs = torch.full((2, code.n), 4.0)
    with TME.device_trace(str(tmp_path)):
        TLO.decode_totals(graph, llrs)
    assert TME._recorder is None
    events = json.loads((tmp_path / "trace.json").read_text())
    names = {e.get("name") for e in events["traceEvents"]}
    assert "ldpc.decode" in names


def _frame_buffer(rng, fade=False):
    """Noise, a 1.5 s 'frame' (a multi-tone burst, optionally with a slow
    fading envelope) and noise after it."""
    n_pre, n_frame, n_post = 30000, 72000, 20000
    t = np.arange(n_frame) / 48000.0
    sig = sum(np.sin(2 * np.pi * f * t + p) for f, p in
              ((700.0, 0.3), (1300.0, 1.1), (2100.0, 2.0))) * 0.1
    if fade:
        sig = sig * (0.55 + 0.45 * np.sin(2 * np.pi * 1.3 * t))
    x = rng.normal(0, 0.01, n_pre + n_frame + n_post)
    x[n_pre:n_pre + n_frame] += sig
    return x.astype(np.float32), n_pre, n_pre + n_frame


@pytest.mark.parametrize("case", ["plain", "fading", "segments",
                                  "starved_pre", "short"])
def test_wideband_snr_matches(case):
    rng = np.random.default_rng(11)
    buf, s, e = _frame_buffer(rng, fade=(case == "fading"))
    kw = {}
    if case == "segments":
        kw = dict(noise_before=s - 5000,
                  segments=[(s - 4000, s - 2000), (e + 100, e + 9000)])
    if case == "starved_pre":
        buf = buf[s - 600:]
        s, e = 600, e - s + 600
    if case == "short":
        e = s + 400
    ours = TWB.wideband_snr_db(buf, s, e, **kw)
    assert ours == JWB.wideband_snr_db(buf, s, e, **kw)
    assert TWB.NOISE_CHUNK == JWB.NOISE_CHUNK
    if case in ("plain", "fading"):
        # ~28 dB of signal; the fading envelope's dips are charged as
        # margin (outage-aware) and show as the fade spread.
        assert 5.0 < ours[0] < 40.0
        assert (ours[1] > 3.0) == (case == "fading")


def _interference_stream(seconds=9.0):
    """Noise with a persistent 1,234 Hz carrier (switched on after 1 s,
    drifting by 2 Hz/s) and a 30 ms broadband crash at 6 s."""
    rng = np.random.default_rng(21)
    n = int(seconds * 48000)
    t = np.arange(n) / 48000.0
    x = rng.normal(0, 0.01, n)
    on = t >= 1.0
    phase = 2 * np.pi * (1234.0 * t + 1.0 * t * t)
    x[on] += 0.03 * np.sin(phase[on])
    at = 6 * 48000 + 96
    x[at:at + 1440] += rng.normal(0, 0.2, 1440)
    return x.astype(np.float32)


def test_exciser_and_blanker_match_on_one_stream():
    """The engine's feed-side chain (exciser, then blanker) in 960-sample
    chunks, with the decoder's frame hints mid-stream: every output chunk,
    the learned tones and the blanked runs equal to JAX's."""
    x = _interference_stream()
    chains = [(JEX.ToneExciser(), JBL.ImpulseBlanker()),
              (TEX.ToneExciser(), TBL.ImpulseBlanker())]
    outs = [[], []]
    for i in range(0, len(x), 960):
        for k, (ex, bl) in enumerate(chains):
            if i == 7 * 48000:
                ex.suppress_activation(1.5)
                ex.frame_detected(i - 4800)
            outs[k].append(bl.process(ex.process(x[i:i + 960])))
    for a, b in zip(*outs):
        np.testing.assert_array_equal(b, a)
    (jex, jbl), (tex, tbl) = chains
    assert tex.active_tones == jex.active_tones
    assert len(tex.active_tones) == 1
    assert abs(tex.active_tones[0] - 1240.0) < 30.0
    assert (tex.updates, tex.quiet_updates) == (jex.updates, jex.quiet_updates)
    np.testing.assert_array_equal(tex._coef, jex._coef)
    np.testing.assert_array_equal(tex._state, jex._state)
    assert (tbl.blanked_runs, tbl.blanked_blocks, tbl.held_samples) == \
        (jbl.blanked_runs, jbl.blanked_blocks, jbl.held_samples)
    assert tbl.blanked_runs == 1


def test_excision_and_blanker_constants_match(monkeypatch):
    for name in ("FS", "FFT_N", "UPDATE_SAMPLES", "BAND_HZ", "THR_DB",
                 "THR_NEW_DB", "MAX_WIDTH_BINS", "MAX_TONES", "PERSIST_ON",
                 "CLEAN_ON", "PERSIST_OFF", "TRACK_HZ", "NOTCH_BW_HZ",
                 "QUIET_DB", "BLOCK_SAMPLES", "FLOOR_BLOCKS", "MIN_BLOCKS",
                 "FLOOR_STEP_BLOCKS", "FLOOR_STEP_MAX_DB",
                 "NEW_LINE_FLOOR_DB"):
        assert getattr(TEX, name) == getattr(JEX, name), name
    for name in ("BLOCK", "MEDIAN_WINDOW", "THRESHOLD", "MAX_RUN_BLOCKS",
                 "MIN_RUN_BLOCKS", "WARMUP_BLOCKS", "RELEASED_WINDOW",
                 "BRIDGE_BLOCKS", "BROADBAND_RATIO", "FLOOR"):
        assert getattr(TBL, name) == getattr(JBL, name), name
    for f0 in (300.0, 1500.0, 3300.0):
        np.testing.assert_array_equal(TEX.notch_coef(f0), JEX.notch_coef(f0))
    # The switches are read when the objects are built, in both packages.
    monkeypatch.setenv("ULTRA_EXCISION", "0")
    monkeypatch.setenv("ULTRA_BLANKER", "0")
    assert not TEX.ToneExciser().enabled and not JEX.ToneExciser().enabled
    assert not TBL.ImpulseBlanker().enabled and \
        not JBL.ImpulseBlanker().enabled
