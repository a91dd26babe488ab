"""``bench_torch.py``, the port's bench, against bench.py's workloads.

bench.py is not imported: at import it writes ``ULTRA_*_BF16`` into
``os.environ`` and switches JAX's PRNG to ``rbg`` for the whole process.
Its compositions are rebuilt here from JAX functions instead
(bench.py:178-223, 304-342).

* Inputs: the three info arrays are bit-equal to bench.py's numpy draws
  (seeds 0, 7, 11) at the full sizes; the chirp and Schmidl-Cox TX within
  2e-4 of JAX's (the golden-TX tolerance).
* Steps: each of the twin's three steps on JAX's noisy buffers (B = 8-16)
  gives JAX's info bits and ok flags lane for lane, in float32 and with
  both bf16 modes on in both packages (bench.py's default); the main
  path's TX inside the step within 2e-4 of JAX's ``tx_frame``.
* Gates: a wrong bit on any lane of the main path's warm-up zeroes its
  value, on an acquisition only a wrong bit on an ok lane does; an ok
  rate under 0.99 zeroes any of them.
* ``main(["--cpu"])`` at bench.py's sanity sizes prints one JSON line with
  bench.py's keys (``BENCH_r05.json``), values > 0, ok rates >= 0.99,
  leaves ``os.environ`` and both switches as it found them.
* The main path sharded over two gloo ranks on the CPU counts the ok
  lanes of one rank.

JAX reads ULTRA_CHIRP_BF16 and ULTRA_LDPC_BF16 at import, so both are
removed before it is imported; the bf16 fixture sets JAX's two module
switches and clears its compilation caches before and after (both are
read while tracing).
"""

import os

for _flag in ("ULTRA_CHIRP_BF16", "ULTRA_LDPC_BF16"):
    os.environ.pop(_flag, None)

import json  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from projectultra_tpu.config import CodeRate, ModemConfig, Modulation  # noqa: E402
from projectultra_tpu.fec import ldpc as JF  # noqa: E402
from projectultra_tpu.ofdm import demodulator as JD  # noqa: E402
from projectultra_tpu.ofdm import modulator as JM  # noqa: E402
from projectultra_tpu.ofdm import pipeline as JP  # noqa: E402
from projectultra_tpu.ops import ldpc as JL  # noqa: E402
from projectultra_tpu.psk import mc_dpsk as JMC  # noqa: E402
from projectultra_tpu.sim import watterson as JW  # noqa: E402
from projectultra_tpu.sync import chirp as JC  # noqa: E402
from projectultra_tpu.sync import schmidl_cox as JSC  # noqa: E402

import bench_torch as BT  # noqa: E402
from projectultra_tpu_torch.ops import ldpc as TL  # noqa: E402
from projectultra_tpu_torch.sync import chirp as TC  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
CPU = torch.device("cpu")
TX_TOL = 2e-4
J_CFG = JP.chirp_ofdm_config()
J10 = JMC.level10()
J_COX = ModemConfig()
MOD, R12, R14 = Modulation.DQPSK, CodeRate.R1_2, CodeRate.R1_4
MODES = {"f32": (False, False), "bf16": (True, True)}


def _t(x):
    return torch.from_numpy(np.array(x))


@pytest.fixture(params=sorted(MODES))
def modes(request):
    """Both packages in one fast mode: JAX's module switches set (its
    caches cleared around them), the port's given to the twin."""
    ldpc_bf16, chirp_bf16 = MODES[request.param]
    assert JL._DEFAULT_MSG_DTYPE == jnp.float32 and JC._BF16 is False
    jax.clear_caches()
    JL._DEFAULT_MSG_DTYPE = jnp.bfloat16 if ldpc_bf16 else jnp.float32
    JC._BF16 = chirp_bf16
    try:
        yield MODES[request.param]
    finally:
        JL._DEFAULT_MSG_DTYPE = jnp.float32
        JC._BF16 = False
        jax.clear_caches()
    assert TL._DEFAULT_MSG_DTYPE == torch.float32 and TC._BF16 is False


# ---------------------------------------------------------------------------
# bench.py's compositions, from JAX functions
# ---------------------------------------------------------------------------

def _draw(seed, B, rate):
    """bench.py's info draw (bench.py:180-181, 305-306, 393-394)."""
    rng = np.random.default_rng(seed)
    return rng.integers(0, 2, size=(B, JF.get_code(rate).k)).astype(np.float32)


def _jax_chirp_tx(info):
    """bench.py:178-192's frames."""
    B = info.shape[0]
    cw = JL.encode(JF.get_code(R14), jnp.asarray(info))
    pre = np.concatenate([JC.generate(J10.chirp_config()),
                          JMC.generate_training(J10),
                          JMC.generate_reference(J10)])
    return np.asarray(jnp.concatenate([
        jnp.zeros((B, 4800)), jnp.broadcast_to(jnp.asarray(pre),
                                               (B, len(pre))),
        JMC.modulate(J10, cw), jnp.zeros((B, 4000))], axis=-1)
        .astype(jnp.float32))


def _jax_chirp_step(rx):
    """bench.py:207-223: detect, the 128-aligned over-slice with
    intra_offset, demodulate, decode."""
    cc = J10.chirp_config()
    code = JF.get_code(R14)
    n_sym = JMC.num_symbols_for_bits(J10, code.n)
    span_len = J10.training_samples + J10.ref_samples \
        + n_sym * J10.samples_per_symbol
    align = 128
    span_pad = -(-(span_len + 2 * align) // align) * align
    rx = jnp.asarray(rx)
    B, T = rx.shape
    det = JC.detect_dual_chirp(cc, rx, threshold=J10.chirp_threshold)
    tr = JC.training_start(cc, det["down_chirp_start"])
    Tb = T // align
    rxb = rx[:, :Tb * align].reshape(B, Tb, align)
    s0 = jnp.clip((tr // align) * align, 0, Tb * align - span_pad)
    r = jnp.clip(tr - s0, 0, span_pad - span_len - 1)
    span = jax.vmap(lambda b, s: jax.lax.dynamic_slice(
        b, (s, 0), (span_pad // align, align)))(rxb, s0 // align) \
        .reshape(B, span_pad)
    llrs = JMC.demodulate_presynced(J10, span, det["cfo_hz"],
                                    tr.astype(jnp.float32), n_sym,
                                    intra_offset=r)
    out, ok, _ = JL.decode(code, llrs[:, :code.n])
    return np.asarray(out), np.asarray(ok & det["success"])


def _cox_perms():
    inv, perm = JP._interleave_perms(J_COX, MOD)
    return np.asarray(inv), np.asarray(perm)


def _jax_cox_tx(info):
    """bench.py:304-321's frames."""
    B = info.shape[0]
    cw = np.asarray(JL.encode(JF.get_code(R12), jnp.asarray(info)))
    inv, _ = _cox_perms()
    pre = JM.generate_preamble(J_COX)
    data = np.asarray(JM.modulate(
        J_COX, MOD, jnp.asarray(cw[:, inv]),
        t_offset=JM.preamble_data_t_offset(J_COX)))
    return np.concatenate([
        np.zeros((B, 1504), np.float32), np.broadcast_to(pre, (B, len(pre))),
        data, np.zeros((B, 1024), np.float32)], axis=-1).astype(np.float32)


def _jax_cox_step(rx):
    """bench.py:330-342: detect, clip, per-lane slice, demodulate_span,
    the one-hot deinterleave, decode."""
    S = JP.num_data_symbols(J_COX, MOD, 1)
    plen = J_COX.fft_size + J_COX.cyclic_prefix
    span_len = 2 * plen + S * J_COX.symbol_duration
    _, perm = _cox_perms()
    pmat = np.zeros((648, 648), np.float32)
    pmat[perm, np.arange(648)] = 1.0
    rx = jnp.asarray(rx)
    det = JSC.detect_preamble(J_COX, rx)
    starts = jnp.clip(det["lts_start"], 0, rx.shape[-1] - span_len)
    span = jax.vmap(lambda b, s: jax.lax.dynamic_slice(
        b, (s,), (span_len,)))(rx, starts)
    llrs, _ = JD.demodulate_span(J_COX, MOD, span, det["cfo_hz"], 0.0,
                                 n_lts=2, S=S, n_bits=648)
    deint = jnp.matmul(llrs[:, :648], jnp.asarray(pmat),
                       precision=jax.lax.Precision.HIGHEST)
    out, ok, _ = JL.decode(JF.get_code(R12), deint)
    return np.asarray(out), np.asarray(ok & det["found"])


# ---------------------------------------------------------------------------
# Inputs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fn,seed,B,rate", [
    (BT.main_info, 0, BT.FULL.batch, R12),
    (BT.chirp_info, 7, BT.FULL.acq_batch, R14),
    (BT.cox_info, 11, BT.FULL.cox_batch, R12)],
    ids=["main", "chirp", "cox"])
def test_info_is_bench_draw(fn, seed, B, rate):
    ours = fn(B)
    assert ours.dtype == np.float32
    np.testing.assert_array_equal(ours, _draw(seed, B, rate))


def test_chirp_tx_matches_bench_construction():
    info = BT.chirp_info(3)
    ours = BT.chirp_tx(_t(info)).numpy()
    ref = _jax_chirp_tx(info)
    assert ours.shape == ref.shape == (3, 83808)
    np.testing.assert_allclose(ours, ref, rtol=0, atol=TX_TOL)


def test_cox_tx_matches_bench_construction():
    info = BT.cox_info(3)
    ours = BT.cox_tx(_t(info)).numpy()
    ref = _jax_cox_tx(info)
    assert ours.shape == ref.shape == (3, 18856)
    np.testing.assert_allclose(ours, ref, rtol=0, atol=TX_TOL)


# ---------------------------------------------------------------------------
# Steps on JAX's noisy buffers, lane for lane
# ---------------------------------------------------------------------------

def test_main_step_on_jax_noise_matches_jax(modes, monkeypatch):
    """bench.py's ``_step`` (tx_frame -> add_noise_active -> rx_frame) in
    JAX at B = 16; the twin's step with its noise replaced by JAX's noisy
    frames, after checking the TX it was given."""
    info = BT.main_info(16)
    tx = JP.tx_frame(J_CFG, MOD, R12, jnp.asarray(info))
    rx = JW.add_noise_active(jax.random.PRNGKey(0), tx, BT.SNR_DB)
    out, ok, _ = JP.rx_frame(J_CFG, MOD, R12, rx)
    seen = []

    def jax_noise(tx_ours, g, rank=0, world=1):
        np.testing.assert_allclose(tx_ours.numpy(), np.asarray(tx), rtol=0,
                                   atol=TX_TOL)
        seen.append((rank, world))
        return _t(rx)

    monkeypatch.setattr(BT, "noisy", jax_noise)
    with BT.switched(modes):
        ours = BT.main_step(_t(info), BT.generator(CPU, 0))
    assert seen == [(0, 1)]
    np.testing.assert_array_equal(ours[0].numpy(), np.asarray(out))
    np.testing.assert_array_equal(ours[1].numpy(), np.asarray(ok))
    assert ours[1].all()
    np.testing.assert_array_equal(ours[0].numpy(), info.astype(np.uint8))


@pytest.mark.parametrize("workload", ["chirp", "cox"])
def test_acquisition_step_on_jax_buffers_matches_jax(workload, modes):
    """The twin's chirp (B = 8, 5 dB) and Schmidl-Cox (B = 8, 17 dB) steps
    on JAX's noisy buffers of bench.py's frames give bench.py's step's
    bits and ok flags on every lane."""
    info_fn, tx_fn, jax_step, step, snr = {
        "chirp": (BT.chirp_info, _jax_chirp_tx, _jax_chirp_step,
                  BT.chirp_step, BT.ACQ_SNR_DB),
        "cox": (BT.cox_info, _jax_cox_tx, _jax_cox_step, BT.cox_step,
                BT.COX_SNR_DB)}[workload]
    info = info_fn(8)
    rx = np.asarray(JW.add_noise_active(jax.random.PRNGKey(3),
                                        jnp.asarray(tx_fn(info)), snr))
    out, ok = jax_step(rx)
    with BT.switched(modes):
        ours = step(_t(rx))
    np.testing.assert_array_equal(ours[0].numpy(), out)
    np.testing.assert_array_equal(ours[1].numpy(), ok)
    assert ok.all()
    np.testing.assert_array_equal(out, info.astype(np.uint8))


# ---------------------------------------------------------------------------
# Gates
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("ok_rates,exact,want", [
    ([1.0, 1.0], True, 100.0), ([1.0, 0.99], True, 100.0),
    ([1.0, 0.98], True, 0.0), ([0.98, 1.0], True, 0.0),
    ([1.0, 1.0], False, 0.0)])
def test_gate(ok_rates, exact, want):
    assert BT.gate(100.0, ok_rates, exact) == (want, min(ok_rates))


def _corrupt(step, lanes, ok_too):
    """step with the bits of ``lanes`` flipped; their ok flags cleared
    too when ``ok_too``."""
    def wrapped(*args, **kw):
        out, ok = step(*args, **kw)
        out, ok = out.clone(), ok.clone()
        out[lanes, 0] ^= 1
        if ok_too:
            ok[lanes] = False
        return out, ok
    return wrapped


SMALL = BT.Sizes(batch=128, iters=2, acq_batch=128, acq_iters=1,
                 cox_batch=128, cox_iters=1, repeats=1)


@pytest.mark.parametrize("case", ["clean", "bits_of_failed_lane",
                                  "ok_rate_0.98"])
def test_main_gate_checks_every_lane(case, monkeypatch):
    """A wrong bit on a lane the decoder flags failed zeroes the main path
    (1 lane of 128 keeps the ok rate at 0.992); 3 failed lanes of 128
    (0.977) zero it too."""
    lanes = {"clean": [], "bits_of_failed_lane": [5],
             "ok_rate_0.98": [1, 2, 3]}[case]
    monkeypatch.setattr(BT, "main_step",
                        _corrupt(BT.main_step, lanes, ok_too=True))
    r = BT.bench_main(SMALL, CPU, MODES["bf16"])
    assert r.ok_rate == 1.0 - len(lanes) / 128
    assert (r.value > 0) == (case == "clean")


@pytest.mark.parametrize("case", ["bits_of_failed_lane", "bits_of_ok_lane",
                                  "ok_rate_0.98"])
def test_acquisition_gate_checks_ok_lanes(case):
    """On an acquisition only an ok lane's bits count: wrong bits on a
    lane flagged failed leave the value (rate 0.992), on an ok lane they
    zero it; 3 failed lanes of 128 (0.977) zero it.  The step is a stand-in
    that decodes every lane exactly, so only the corruption is counted."""
    lanes, ok_too = {"bits_of_failed_lane": ([5], True),
                     "bits_of_ok_lane": ([5], False),
                     "ok_rate_0.98": ([1, 2, 3], True)}[case]
    info = torch.from_numpy(BT.cox_info(128))

    def exact(rx):
        return info.to(torch.uint8), torch.ones(128, dtype=torch.bool)

    r = BT.time_acquisition(_corrupt(exact, lanes, ok_too), info,
                            torch.ones((128, 64)), 2, 2, BT.COX_SNR_DB, 13)
    assert r.ok_counts == ((128 - len(lanes) * ok_too),) \
        + (2 * (128 - len(lanes) * ok_too),) * 2
    assert r.ok_rate == (1.0 - len(lanes) / 128 if ok_too else 1.0)
    assert (r.value > 0) == (case == "bits_of_failed_lane")


# ---------------------------------------------------------------------------
# The entry point
# ---------------------------------------------------------------------------

def test_fast_modes_as_bench_setdefault():
    assert BT.fast_modes({}) == (True, True)
    assert BT.fast_modes({"ULTRA_LDPC_BF16": "0"}) == (False, True)
    assert BT.fast_modes({"ULTRA_CHIRP_BF16": "true",
                          "ULTRA_LDPC_BF16": "1"}) == (True, False)


def test_main_cpu_prints_bench_line(capsys):
    """bench.py's keys and metric names, /cpu-sanity units, every value
    > 0 and every ok rate >= 0.99; the switches and os.environ as they
    were (both modes ran on: neither variable is set here)."""
    environ = dict(os.environ)
    assert BT.main(["--cpu"]) == 0
    assert dict(os.environ) == environ
    assert TL._DEFAULT_MSG_DTYPE == torch.float32 and TC._BF16 is False
    lines = capsys.readouterr().out.strip().splitlines()
    assert "bf16 LDPC messages on, bf16 chirp acquisition on" in lines[1]
    assert sum(line.startswith("{") for line in lines) == 1
    got = json.loads(lines[-1])
    bench = json.loads((ROOT / "BENCH_r05.json").read_text())["parsed"]
    assert set(got) == set(bench)
    for key in ("metric", "acq_metric", "cox_metric"):
        assert got[key] == bench[key]
    assert got["unit"] == "pipelines/s/cpu-sanity"
    assert got["acq_unit"] == got["cox_unit"] == "frames/s/cpu-sanity"
    assert min(got["value"], got["acq_value"], got["cox_value"]) > 0
    assert got["vs_baseline"] == round(got["value"] / 10_000.0, 3)
    assert min(got["acq_decode_ok_rate"], got["cox_decode_ok_rate"]) >= 0.99


def test_import_leaves_environ_and_switches():
    code = ("import os, torch, bench_torch\n"
            "from projectultra_tpu_torch.ops import ldpc\n"
            "from projectultra_tpu_torch.sync import chirp\n"
            "print(sorted(k for k in os.environ if k.startswith('ULTRA_')),\n"
            "      ldpc._DEFAULT_MSG_DTYPE == torch.float32, chirp._BF16)\n")
    env = {k: v for k, v in os.environ.items() if not k.startswith("ULTRA_")}
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.stdout.strip() == "[] True False", out.stderr


def test_sharded_main_path_counts_as_one_rank(monkeypatch):
    """The main path over two gloo ranks (B = 16, each rank 8 frames)
    counts the ok lanes one process does, repeat for repeat."""
    monkeypatch.setenv("OMP_NUM_THREADS", "2")
    sizes = BT.Sizes(batch=16, iters=2, repeats=2)
    one = BT.bench_main(sizes, CPU, MODES["bf16"])
    two = BT.bench_main(sizes, CPU, MODES["bf16"], world=2)
    assert two.ok_counts == one.ok_counts == (16, 32, 32)
    assert len(two.seconds) == 2
    assert one.value > 0 and two.value > 0
    assert one.ok_rate == two.ok_rate == 1.0
